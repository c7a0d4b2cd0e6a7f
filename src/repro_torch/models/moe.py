"""Mixture-of-Experts layer: top-k routing with capacity, one-hot dispatch.

The torch counterpart of ``repro.models.moe`` (GShard/Switch style). Tokens
are cut into groups of ``Tg = min(group_size, T)`` (halved until it divides
T); in each group a token goes to its top-k experts, each expert taking at
most ``C = max(ceil(Tg / E * capacity_factor * k), k)`` tokens in token
order; an overflow token loses that expert's gate mass (the residual stream
carries it). The router runs in fp32 on an fp32 weight; top-k membership is
``probs >= k-th largest``, so a tie selects more than k experts, as in the
JAX package. The experts are gated tanh-GELU whatever ``cfg.mlp_type`` says,
as there. Aux losses: load balance (Switch eq. 4) and router z-loss.

Dispatch and combine are one-hot products, and the expert products batched
matmuls over all E experts on their C slots each (``torch.bmm``): outside
any kernel, as they are in the JAX package. At decode this reads every
expert's weights each step, as the JAX package does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import normal

__all__ = ["init_moe", "apply_moe", "group_shape"]


def init_moe(gen, cfg: ModelConfig, *, device, lead=()):
    m = cfg.moe
    dt = cfg.pdtype()
    d, f, E = cfg.d_model, m.d_ff_expert, m.n_experts
    s_in, s_out = 1.0 / np.sqrt(d), 1.0 / np.sqrt(f)
    return {
        "router": normal(gen, (*lead, d, E), s_in, torch.float32, device),
        "w_gate": normal(gen, (*lead, E, d, f), s_in, dt, device),
        "w_up": normal(gen, (*lead, E, d, f), s_in, dt, device),
        "w_down": normal(gen, (*lead, E, f, d), s_out, dt, device),
    }


def group_shape(cfg: ModelConfig, T: int):
    """(groups G, tokens per group Tg, capacity C) for T tokens."""
    m = cfg.moe
    Tg = min(m.group_size, T)
    while T % Tg:
        Tg //= 2
    C = int(np.ceil(Tg / m.n_experts * m.capacity_factor * m.top_k))
    return T // Tg, Tg, max(C, m.top_k)


def _top_k_gates(probs, k: int):
    """Normalised gates of the top-k experts (ties included) -> (G, Tg, E)."""
    thresh = torch.topk(probs, k, dim=-1).values[..., -1:]
    gates = torch.where(probs >= thresh, probs, 0.0)
    return gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)


def apply_moe(params, x, cfg: ModelConfig):
    """x: (B, S, d) -> (y (B, S, d), aux {load_balance_loss,
    router_z_loss})."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.n_experts, m.top_k
    G, Tg, C = group_shape(cfg, B * S)

    xt = x.reshape(G, Tg, d)
    logits = xt.float() @ params["router"]  # (G, Tg, E) fp32
    probs = torch.softmax(logits, dim=-1)
    gates = _top_k_gates(probs, k)
    routed = gates > 0

    me = probs.mean((0, 1))
    ce = routed.float().mean((0, 1)) * E / k
    aux = {"load_balance_loss": (me * ce).sum(),
           "router_z_loss": torch.logsumexp(logits, -1).square().mean()}

    # each token's slot in each expert's buffer: the running count of the
    # expert's tokens in token order (-1 where not routed)
    mask = routed.to(torch.int32)
    pos = torch.cumsum(mask, dim=1) * mask - 1
    keep = (pos >= 0) & (pos < C)
    gates = torch.where(keep, gates, 0.0)
    dispatch = F.one_hot(pos.clamp(0, C - 1).long(), C).to(x.dtype) \
        * keep[..., None].to(x.dtype)  # (G, Tg, E, C)
    combine = dispatch * gates[..., None].to(x.dtype)

    disp = dispatch.reshape(G, Tg, E * C)
    expert_in = (disp.transpose(1, 2) @ xt).reshape(G, E, C, d)
    rows = expert_in.transpose(0, 1).reshape(E, G * C, d)  # per expert
    h = torch.bmm(rows, params["w_up"])
    g = torch.bmm(rows, params["w_gate"])
    h = F.gelu(g, approximate="tanh") * h
    out = torch.bmm(h, params["w_down"])  # (E, G * C, d)
    out = out.reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)
    y = combine.reshape(G, Tg, E * C) @ out
    return y.reshape(B, S, d), aux

