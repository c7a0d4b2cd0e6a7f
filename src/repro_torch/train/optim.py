"""Adam, as the JAX package's ``repro.train.optim`` computes it.

Only what SGNS training and the link-prediction fit need: ``scale_by_adam``,
``adam`` and ``apply_updates`` over dicts of tensors. The moments are fp32
whatever the parameter dtype, and updates are cast back to it. Every
parameter moves every step, those without gradient too (their moments
decay), as in ``optim.py:120-138``: no lazy or sparse row updates.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

__all__ = ["AdamState", "GradientTransform", "scale_by_adam", "adam",
           "apply_updates"]

Params = Dict[str, torch.Tensor]


class GradientTransform(NamedTuple):
    init: Callable[[Params], object]
    update: Callable  # (grads, state, params) -> (updates, state)


class AdamState(NamedTuple):
    count: int
    mu: Params
    nu: Params


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: (p + updates[k].to(p.dtype)).to(p.dtype)
            for k, p in params.items()}


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransform:
    """Bias-corrected ``m_hat / (sqrt(v_hat) + eps)``."""

    def init(params):
        zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for k, p in params.items()}
        return AdamState(0, zeros, {k: z.clone() for k, z in zeros.items()})

    def update(grads, state, params=None):
        count = state.count + 1
        g32 = {k: g.float() for k, g in grads.items()}
        mu = {k: b1 * state.mu[k] + (1 - b1) * g for k, g in g32.items()}
        nu = {k: b2 * state.nu[k] + (1 - b2) * g * g for k, g in g32.items()}
        # the bias corrections in float32, as the JAX package computes them:
        # 1 - b2 is a small difference, so its rounding shows in every update
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        updates = {k: (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
                   for k in mu}
        return updates, AdamState(count, mu, nu)

    return GradientTransform(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransform:
    """``scale_by_adam`` followed by a step of ``-lr`` (a constant rate: the
    JAX package's schedule and decay stages are identities here)."""
    inner = scale_by_adam(b1, b2, eps)

    def update(grads, state, params=None):
        updates, state = inner.update(grads, state, params)
        return {k: u * -lr for k, u in updates.items()}, state

    return GradientTransform(inner.init, update)
