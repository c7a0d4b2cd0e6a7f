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

Under a mesh every product runs on each rank's shards with explicit
placements (``shard_map``), never on a whole expert matrix. The expert
products (``_expert_bmm``), on each mesh axis: experts split (moonshot's
``experts: model``) keep their split on the rows and the weights; rows of
tokens split (the groups over "batch") keep it, and the weight is gathered
there, one layer's slice at a time (FSDP: grok-1's ``expert_embed: data``;
under full remat the gather is redone in backward, and its gradient is
reduce-scattered back); a weight's split of its output dim (grok-1's
``expert_mlp: model`` on ``w_up`` / ``w_gate``) stays, the rows' d gathered
there, so ``h`` stays split over f; a split of the contracted dim
(``w_down``'s f) makes the product a partial sum, which the next
``constrain`` to ``act_embed`` reduce-scatters.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (as_dtensor, constrain,
                                              is_dtensor, matmul, shard_map,
                                              spec_for)

from .config import ModelConfig
from .layers import normal

__all__ = ["init_moe", "spec_moe", "apply_moe", "group_shape"]


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


def spec_moe(cfg: ModelConfig):
    return {
        "router": ("embed", None),
        "w_gate": ("experts", "expert_embed", "expert_mlp"),
        "w_up": ("experts", "expert_embed", "expert_mlp"),
        "w_down": ("experts", "expert_mlp", "expert_embed"),
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


def _constrain_by_group(x, G: int, last: str):
    """``constrain`` an expert-major (E, G * C, n) buffer as the JAX
    package constrains its (G, E, C, n) twin: the groups' rows split as
    "batch" where the G groups divide it, else whole."""
    batch = "batch" if spec_for((G,), ("batch",)) not in ((), (None,)) \
        else None
    return constrain(x, "experts", batch, last)


def _group_bmm(a, b):
    """``a @ b`` over the groups: a (G, m, k), b (G, k, n). On DTensors
    each rank multiplies its own groups (split as b's are) and b's split
    of n (``shard_map``), so the backward's gradients keep those splits
    (DTensor's own batched product may split G over every axis, more ways
    than a batch of microbatched rows divides evenly)."""
    from torch.distributed.tensor import Replicate, Shard

    if not is_dtensor(b):
        return a @ b
    a_pl, b_pl = [], []
    for p in b.placements:
        if isinstance(p, Shard) and p.dim == 0:
            a_pl.append(p)
            b_pl.append(p)
        elif isinstance(p, Shard) and p.dim == 2:
            a_pl.append(Replicate())
            b_pl.append(p)
        else:
            a_pl.append(Replicate())
            b_pl.append(Replicate())
    return shard_map(lambda a, b: a @ b, b.device_mesh, (a_pl, b_pl),
                     b_pl)(a, b)


def _expert_bmm(rows, *ws):
    """``rows @ w`` per expert for each w of ``ws`` (laid out alike):
    rows (E, N, k), w (E, k, n). On DTensors each rank multiplies its own
    shards (``shard_map``; the rows redistributed once for all of ``ws``),
    on each mesh axis by the splits there: experts (dim 0 of either)
    split both and the products; the rows' N (tokens) kept split, w
    gathered; else w's output dim kept split (rows gathered), or its
    contracted dim (the rows split to match, the products partial sums);
    else all whole."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    if not (is_dtensor(rows) or is_dtensor(ws[0])):
        return tuple(torch.bmm(rows, w) for w in ws)
    mesh = (ws[0] if is_dtensor(ws[0]) else rows).device_mesh
    rows = as_dtensor(rows, mesh)
    ws = [as_dtensor(w, mesh) for w in ws]
    r_pl, w_pl, o_pl = [], [], []
    for pr, pw in zip(rows.placements, ws[0].placements):
        if Shard(0) in (pr, pw):
            r_pl.append(Shard(0))
            w_pl.append(Shard(0))
            o_pl.append(Shard(0))
        elif pr == Shard(1):
            r_pl.append(pr)
            w_pl.append(Replicate())
            o_pl.append(pr)
        elif pw == Shard(2):
            r_pl.append(Replicate())
            w_pl.append(pw)
            o_pl.append(pw)
        elif pw == Shard(1):
            r_pl.append(Shard(2))
            w_pl.append(pw)
            o_pl.append(Partial())
        else:
            r_pl.append(Replicate())
            w_pl.append(Replicate())
            o_pl.append(Replicate())
    return shard_map(lambda rows, *ws: tuple(torch.bmm(rows, w) for w in ws),
                     mesh, (r_pl,) + (w_pl,) * len(ws),
                     (o_pl,) * len(ws))(rows, *ws)


def apply_moe(params, x, cfg: ModelConfig):
    """x: (B, S, d) -> (y (B, S, d), aux {load_balance_loss,
    router_z_loss})."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.n_experts, m.top_k
    G, Tg, C = group_shape(cfg, B * S)

    xt = constrain(x.reshape(G, Tg, d), "batch", None, "act_embed")
    logits = matmul(xt.float(), params["router"])  # (G, Tg, E) fp32
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
    expert_in = _group_bmm(disp.transpose(1, 2), xt).reshape(G, E, C, d)
    expert_in = constrain(expert_in, "batch", "experts", None, "act_embed")
    rows = expert_in.transpose(0, 1).reshape(E, G * C, d)  # per expert
    h, g = _expert_bmm(rows, params["w_up"], params["w_gate"])
    h = F.gelu(g, approximate="tanh") * h
    h = _constrain_by_group(h, G, "expert_mlp")
    out, = _expert_bmm(h, params["w_down"])  # (E, G * C, d)
    out = _constrain_by_group(out, G, "act_embed")
    out = out.reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)
    y = _group_bmm(combine.reshape(G, Tg, E * C), out)
    return y.reshape(B, S, d), aux

