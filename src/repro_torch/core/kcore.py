"""K-core decomposition (paper §1.2.3) — the degeneracy primitive.

The torch counterpart of ``repro.core.kcore``:

* ``core_numbers_host`` (Matula–Beck bucket peeling), ``core_numbers_rounds``
  (vectorized layer peeling) and ``core_numbers_shell_peel`` (boundary-
  frozen peel of a sub-level set) are numpy, copied from the JAX package:
  the oracle, and the host re-peels of the online repair.
* ``core_numbers_torch`` takes the place of ``core_numbers_jax``: the fixed
  point of the neighbourhood h-index operator on the padded ELL adjacency
  (Lü et al., "The H-index of a network node", 2016), c⁰ = deg and
  c^{t+1}(v) = H({c^t(u) : u ∈ N(v)}), each sweep through
  ``kernels.ops.h_index_sweep`` (the CUDA kernel on the card). The loop runs
  on the tensors' device and reads one flag back per sweep.

Shell/core helpers used by propagation (§2.2) live here too: ``core_mask``
and ``shells``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.graph.csr import EllGraph, Graph
from repro_torch.kernels import ops as _kernel_ops

__all__ = [
    "core_numbers_host",
    "core_numbers_rounds",
    "core_numbers_shell_peel",
    "core_numbers_torch",
    "h_index_sweep",
    "degeneracy",
    "core_mask",
    "shells",
    "kcore_subgraph",
]


def core_numbers_host(g: Graph) -> np.ndarray:
    """Matula–Beck O(E) peeling. Returns (n_nodes,) int32 core numbers."""
    n = g.n_nodes
    deg = g.degrees().astype(np.int64)
    max_deg = int(deg.max()) if n else 0
    # bucket sort nodes by degree
    bin_start = np.zeros(max_deg + 2, dtype=np.int64)
    counts = np.bincount(deg, minlength=max_deg + 1)
    np.cumsum(counts, out=bin_start[1:])
    pos = np.empty(n, dtype=np.int64)
    vert = np.empty(n, dtype=np.int64)
    fill = bin_start[:-1].copy()
    for v in range(n):
        pos[v] = fill[deg[v]]
        vert[pos[v]] = v
        fill[deg[v]] += 1
    bin_ptr = bin_start[:-1].copy()
    core = deg.copy()
    for i in range(n):
        v = vert[i]
        for u in g.neighbours(v):
            u = int(u)
            if core[u] > core[v]:
                du = core[u]
                pu = pos[u]
                pw = bin_ptr[du]
                w = vert[pw]
                if u != w:
                    pos[u], pos[w] = pw, pu
                    vert[pu], vert[pw] = w, u
                bin_ptr[du] += 1
                core[u] -= 1
    return core.astype(np.int32)


def core_numbers_rounds(n_nodes: int, arc_src: np.ndarray,
                        arc_dst: np.ndarray) -> np.ndarray:
    """Vectorized Matula–Beck: peel whole degree-``<=k`` layers per round.

    ``arc_src``/``arc_dst`` hold every arc (both directions of each edge),
    unsorted. Same exact core numbers as ``core_numbers_host``, but each
    round strips *all* currently peelable nodes with numpy boolean masks and
    one grouped degree decrement, so the Python-level loop runs O(#rounds)
    times instead of O(n). The host fallback of the online block repair: it
    reads the streaming graph's arc arrays directly.
    """
    n = int(n_nodes)
    if n == 0:
        return np.zeros(0, np.int32)
    arc_src = np.asarray(arc_src, np.int64)
    arc_dst = np.asarray(arc_dst, np.int64)
    deg = np.bincount(arc_src, minlength=n).astype(np.int64)
    core = np.zeros(n, np.int32)
    active = deg > 0
    k = 0
    n_active = int(active.sum())
    while n_active:
        k = max(k, int(deg[active].min()))
        frontier = active & (deg <= k)
        while frontier.any():
            core[frontier] = k
            active &= ~frontier
            n_active -= int(frontier.sum())
            # arcs leaving the peeled layer into still-active nodes; arcs
            # between two peeled nodes need no decrement (both are gone)
            m = frontier[arc_src] & active[arc_dst]
            if m.any():
                deg -= np.bincount(arc_dst[m], minlength=n)
            frontier = active & (deg <= k)
        # every inner round scans the arc arrays: drop arcs whose endpoints
        # are peeled once a level finishes, so the scans shrink geometrically
        if len(arc_src) > 1024:
            keep = active[arc_src]
            keep &= active[arc_dst]
            if int(keep.sum()) * 2 < len(arc_src):
                arc_src, arc_dst = arc_src[keep], arc_dst[keep]
    return core


def core_numbers_shell_peel(
    n_nodes: int,
    arc_src: np.ndarray,
    arc_dst: np.ndarray,
    peel: np.ndarray,
    degrees: np.ndarray,
    hi: int,
) -> Tuple[np.ndarray, bool]:
    """Boundary-frozen rounds peel of the sub-level set ``peel``.

    Only the nodes in ``peel`` (the shells at level ``<= hi`` before the
    mutation block) are re-peeled; everything above stays frozen and acts as
    boundary support. ``degrees`` must be every node's **full** current
    degree, and ``arc_src``/``arc_dst`` only the arcs with both endpoints
    inside ``peel``.

    Returns ``(core, ok)``: ``core`` holds the recomputed levels of the
    ``peel`` nodes. Anchoring the frozen side over-estimates the peel side
    pointwise, so a wrong freeze shows as a survivor whose remaining degree
    exceeds ``hi``, returned as ``ok=False`` with the result discarded;
    ``ok=True`` certifies the freeze and makes the result exact.
    """
    n = int(n_nodes)
    core = np.zeros(n, np.int32)
    if n == 0:
        return core, True
    arc_src = np.asarray(arc_src, np.int64)
    arc_dst = np.asarray(arc_dst, np.int64)
    deg = np.asarray(degrees, np.int64).copy()
    active = np.asarray(peel, bool).copy()
    core[active] = 0  # isolated / degree-0 peel nodes resolve to level 0
    active &= deg > 0
    k = 0
    n_active = int(active.sum())
    while n_active:
        k = max(k, int(deg[active].min()))
        if k > hi:  # survivor past the ceiling: freeze assumption violated
            return core, False
        frontier = active & (deg <= k)
        while frontier.any():
            core[frontier] = k
            active &= ~frontier
            n_active -= int(frontier.sum())
            m = frontier[arc_src] & active[arc_dst]
            if m.any():
                deg -= np.bincount(arc_dst[m], minlength=n)
            frontier = active & (deg <= k)
        if len(arc_src) > 1024:  # same geometric arc-drop as the full peel
            keep = active[arc_src]
            keep &= active[arc_dst]
            if int(keep.sum()) * 2 < len(arc_src):
                arc_src, arc_dst = arc_src[keep], arc_dst[keep]
    return core, True


def h_index_sweep(values: torch.Tensor, valid: torch.Tensor,
                  est: torch.Tensor, *, impl: str = "ref") -> torch.Tensor:
    """One row-masked h-index repair sweep (the shared operator).

    ``values`` is the (R, W) matrix of neighbour core estimates for R
    candidate rows, ``valid`` masks the real entries, ``est`` is the (R,)
    current estimate of the rows themselves. Returns ``min(est, H(row))`` —
    monotone non-increasing, so iterating from any upper bound descends to
    the greatest fixed point below it. ``impl`` selects the backend of
    ``kernels.ops.h_index_sweep``: "ref", "count", "cuda" or "auto".
    """
    return _kernel_ops.h_index_sweep(values, valid, est, impl=impl)


def core_numbers_torch(ell: EllGraph, max_sweeps: int = 256,
                       impl: str = "auto") -> torch.Tensor:
    """Core numbers via the h-index fixed point. Returns (n_nodes,) int32 on
    the ELL table's device.

    Exact when the ELL table is not width-capped (uses true degrees); with a
    capped table the result is a lower bound. ``impl="auto"`` sweeps with
    the CUDA kernel on the card and the counting search on the CPU.
    """
    nbr = ell.neighbours
    valid = nbr != ell.n_nodes
    core = ell.degrees.to(torch.int32)
    for _ in range(max_sweeps):
        new = h_index_sweep(core[nbr.long()], valid, core, impl=impl)
        new[-1] = 0  # sentinel row
        done = bool(torch.equal(new, core))
        core = new
        if done:
            break
    return core[: ell.n_nodes]


def degeneracy(core: np.ndarray) -> int:
    return int(np.max(core)) if len(core) else 0


def core_mask(core: np.ndarray, k: int) -> np.ndarray:
    """Membership mask of the k-core (nodes with core number >= k)."""
    return np.asarray(core) >= k


def shells(core: np.ndarray) -> Dict[int, np.ndarray]:
    """core index -> node ids whose core number equals that index."""
    core = np.asarray(core)
    return {int(k): np.where(core == k)[0] for k in np.unique(core)}


def kcore_subgraph(g: Graph, core: np.ndarray, k: int) -> Graph:
    """Induced subgraph on the k-core (original node ids preserved)."""
    return g.subgraph(core_mask(core, k))
