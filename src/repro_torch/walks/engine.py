"""Random-walk engine (paper §1.2.4) on the ELL adjacency, on its device.

The torch counterpart of ``repro.walks.engine``: a batch of walks is one
tensor program per step, with no per-node Python. Uniform (DeepWalk) and
(p, q)-biased (Node2Vec) transition rules. Dead ends (degree 0) hold
position; datasets exclude isolated nodes per the paper's 0-core == 1-core
assumption, so this only triggers on the sentinel row. Draws come from the
caller's ``torch.Generator`` (on the ELL's device), so a walk is
reproducible from its seed but not bit-equal to the JAX package's threefry
walks: the two agree in distribution.
"""
from __future__ import annotations

import math

import torch

from repro_torch.graph.csr import EllGraph

__all__ = ["random_walks", "node2vec_walks"]


def _uniform_step(neighbours, degrees, cur, gen):
    """One uniform step from every walk's current node. ``randint(0, deg)``
    has no per-element bound in torch: draw ``floor(u * deg)`` and clamp it
    to ``deg - 1`` (u < 1, but u * deg may round up to deg)."""
    deg = degrees[cur].long()
    u = torch.rand(cur.shape, generator=gen, device=cur.device)
    hi = deg.clamp_min(1)
    pick = torch.minimum((u * hi).long(), hi - 1)
    nxt = neighbours[cur.long(), pick]
    return torch.where(deg > 0, nxt, cur)


def random_walks(ell: EllGraph, roots: torch.Tensor, length: int,
                 gen: torch.Generator) -> torch.Tensor:
    """Uniform random walks. roots: (W,) int32 on the ELL's device ->
    (W, length) int32; column 0 is the roots."""
    cur = roots.to(torch.int32)
    out = torch.empty((cur.shape[0], length), dtype=torch.int32,
                      device=cur.device)
    for t in range(length):
        out[:, t] = cur
        if t + 1 < length:
            cur = _uniform_step(ell.neighbours, ell.degrees, cur, gen)
    return out


def node2vec_walks(ell: EllGraph, roots: torch.Tensor, length: int,
                   gen: torch.Generator, p: float = 1.0,
                   q: float = 1.0) -> torch.Tensor:
    """Node2Vec (p, q)-biased walks. p = q = 1 is DeepWalk's uniform walk.

    The first step is uniform; each later step weighs a candidate by 1/p if
    it is the previous node, 1 if it neighbours the previous node (a
    row-wise ``searchsorted`` in the sorted ELL row) and 1/q otherwise, and
    picks by Gumbel argmax over the valid slots.
    """
    nbr, deg = ell.neighbours, ell.degrees
    width = nbr.shape[1]
    cur = roots.to(torch.int32)
    out = torch.empty((cur.shape[0], length), dtype=torch.int32,
                      device=cur.device)
    out[:, 0] = cur
    if length == 1:
        return out
    prev, cur = cur, _uniform_step(nbr, deg, cur, gen)
    log_p, log_q = -math.log(p), -math.log(q)
    for t in range(1, length):
        out[:, t] = cur
        if t + 1 == length:
            break
        cand = nbr[cur.long()]  # (W, L) sorted, sentinel-padded
        valid = cand != ell.n_nodes
        prev_row = nbr[prev.long()]
        idx = torch.searchsorted(prev_row, cand).clamp_max(width - 1)
        in_prev = torch.gather(prev_row, 1, idx) == cand
        logw = torch.where(cand == prev[:, None], log_p,
                           torch.where(in_prev, 0.0, log_q))
        logits = torch.where(valid, logw, float("-inf"))
        u = torch.rand(cand.shape, generator=gen, device=cand.device)
        g = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        choice = torch.argmax(logits + g, dim=1, keepdim=True)
        nxt = torch.gather(cand, 1, choice)[:, 0]
        prev, cur = cur, torch.where(deg[cur.long()] > 0, nxt, cur)
    return out
