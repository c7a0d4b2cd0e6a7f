"""SGNS embedding model: parameters and the batch loss.

The torch counterpart of ``repro.skipgram.model``. Two embedding tables
(input/"center" and output/"context"), as in word2vec; the final node
representation is ``emb_in`` (gensim convention, matching the paper's
DeepWalk setup). The row gathers are torch indexing outside the kernel, as
in the JAX package; the gradient of ``emb_out``, which is gathered twice
(contexts and negatives), is the sum of both scatter-adds that autograd of
the indexing gives.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.train.optim import AdamState

__all__ = ["init_params", "batch_loss", "from_jax_params", "Params"]

Params = Dict[str, torch.Tensor]


def init_params(n_nodes: int, dim: int, gen: torch.Generator,
                dtype=torch.float32, *, device="cuda") -> Params:
    """word2vec-style init: uniform(-0.5, 0.5)/dim for input, zeros for
    output; ``gen`` must live on ``device``."""
    device = resolve_device(device)
    u = torch.rand((n_nodes, dim), generator=gen, device=device)
    emb_in = (u - 0.5) / dim
    emb_out = torch.zeros((n_nodes, dim), device=device)
    return {"emb_in": emb_in.to(dtype), "emb_out": emb_out.to(dtype)}


def batch_loss(params: Params, centers, contexts, negatives,
               impl: str = "auto") -> torch.Tensor:
    """Mean SGNS loss over a batch of (center, context, K negatives) ids."""
    c = params["emb_in"][centers]  # (B, D)
    x = params["emb_out"][contexts]  # (B, D)
    n = params["emb_out"][negatives]  # (B, K, D)
    return ops.sgns_loss(c, x, n, impl=impl).mean()


def from_jax_params(params, opt_state=None, *, device="cuda"):
    """Carry the JAX package's SGNS parameters (and optionally its Adam
    state) across: ``params`` is ``{"emb_in", "emb_out"}`` of numpy arrays;
    ``opt_state`` is the state of ``repro.train.optim.adam`` with numpy
    leaves, i.e. ``(AdamState(count, mu, nu), (), count)``. Returns
    ``(params, AdamState or None)`` as torch tensors on ``device``."""
    device = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a), device=device)

    p = {k: t(params[k]) for k in ("emb_in", "emb_out")}
    state: Optional[AdamState] = None
    if opt_state is not None:
        count, mu, nu = opt_state[0]
        state = AdamState(int(np.asarray(count)),
                          {k: t(mu[k]) for k in p}, {k: t(nu[k]) for k in p})
    return p, state
