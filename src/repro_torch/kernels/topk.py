"""Streaming score + top-k: the wrapper of the CUDA kernel ``csrc/topk.cu``.

The Hopper counterpart of the Pallas kernel in ``repro.kernels.topk``: per
query the k table rows with the highest ``q . t + bias`` under the total
order (score desc, index asc), the (Q, N) scores never written to memory,
fp32 FFMA throughout (no TF32). The TPU kernel carries one running
accumulator across a sequential grid; here ``topk_partial`` reduces each
(64 queries, contiguous range of table rows) block to a sorted partial per
query, through a threshold, a candidate buffer and batched bitonic flushes,
and ``topk_merge`` merges the partials, one block per query, so the result
comes back already ordered. One pass gives a round of up to 128 entries; a
larger k runs in rounds of 128, each admitting only rows after the previous
round's last entry. :func:`plan` sizes the grid from occupancy. The plain
version is ``ref.topk_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["topk_cuda", "plan", "launches", "partial_launches",
           "merge_launches", "ROUND_K", "TILE_ROWS", "QUERY_BLOCK"]

# kernel launches since the last reset: one topk_partial and one
# topk_merge per round; ``launches`` is their sum
launches = 0
partial_launches = 0
merge_launches = 0

ROUND_K = 128  # entries per round: one pass over the table
TILE_ROWS = 256  # table rows a block scores at once
QUERY_BLOCK = 64  # queries per block
_resident = {}  # (device index, kr) -> topk_partial blocks resident at once


def _lib():
    lib = build.library("topk")
    fn = lib.topk_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 8 + [p]
        fn.restype = ctypes.c_int
        lib.topk_resident.argtypes = [i, i, ctypes.POINTER(i)]
        lib.topk_resident.restype = i
    return lib


def plan(n_rows: int, n_queries: int, k: int, resident):
    """The rounds of a top-k: a list of ``(c0, kr, n_chunks,
    rows_per_chunk)``, round r filling output columns [c0, c0 + kr).

    ``resident(kr)`` is the number of ``topk_partial`` blocks the card holds
    at once for a round of kr (occupancy x SMs). A round's grid is that many
    blocks over the query blocks, at most one per 256-row tile; each block
    walks one contiguous range of whole tiles, the ranges as even as whole
    tiles allow and none empty.
    """
    q_blocks = -(-max(n_queries, 1) // QUERY_BLOCK)
    n_tiles = max(1, -(-n_rows // TILE_ROWS))
    rounds = []
    for c0 in range(0, k, ROUND_K):
        kr = min(ROUND_K, k - c0)
        want = max(1, min(n_tiles, resident(kr) // q_blocks))
        per = -(-n_tiles // want)
        rounds.append((c0, kr, -(-n_tiles // per), per * TILE_ROWS))
    return rounds


def topk_cuda(q: torch.Tensor, table: torch.Tensor, bias: torch.Tensor,
              k: int):
    """q: (Q, D), table: (N, D), bias: (N,) float32 (0 live, -inf dead), all
    contiguous on one CUDA device; k >= 1 (ceil(k / 128) rounds, each a
    pass over the table), any D >= 1. Returns ``(vals (Q, k) float32,
    idx (Q, k) int32)`` ordered by (score desc, index asc), -inf / -1
    where fewer than k rows are live."""
    global launches, partial_launches, merge_launches
    build.require(table, "table", (torch.float32,), 2)
    build.require(q, "q", (torch.float32,), 2, table.device)
    build.require(bias, "bias", (torch.float32,), 1, table.device)
    n, d = table.shape
    nq = q.shape[0]
    k = int(k)
    if q.shape[1] != d or bias.shape[0] != n:
        raise ValueError(
            f"shapes disagree: q {tuple(q.shape)}, table {tuple(table.shape)}"
            f", bias {tuple(bias.shape)}"
        )
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if d < 1:
        raise ValueError("embedding width must be >= 1")
    lib = _lib()
    dev = table.device

    def resident(kr):
        key = (dev.index, kr)
        if key not in _resident:
            out = ctypes.c_int(0)
            build.check(lib, lib.topk_resident(kr, dev.index,
                                               ctypes.byref(out)),
                        "top-k occupancy")
            _resident[key] = out.value
        return _resident[key]

    rounds = plan(n, nq, k, resident)
    scratch = max(ch * kr for _, kr, ch, _ in rounds)
    pv = torch.empty((nq, scratch), dtype=torch.float32, device=dev)
    pi = torch.empty((nq, scratch), dtype=torch.int32, device=dev)
    vals = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nq, k), dtype=torch.int32, device=dev)
    stream = build.stream_of(dev)
    for c0, kr, n_chunks, rows in rounds:
        # the floor of a later round is column c0 - 1, the previous round's
        # last entry (4-byte elements)
        floor_v = vals.data_ptr() + 4 * (c0 - 1) if c0 else None
        floor_i = idx.data_ptr() + 4 * (c0 - 1) if c0 else None
        code = lib.topk_launch(
            q.data_ptr(), table.data_ptr(), bias.data_ptr(), floor_v,
            floor_i, pv.data_ptr(), pi.data_ptr(), vals.data_ptr() + 4 * c0,
            idx.data_ptr() + 4 * c0, k, nq, n, d, kr, n_chunks, rows,
            dev.index, stream)
        build.check(lib, code, "top-k kernel")
        if nq:  # the C side launches nothing for no queries
            partial_launches += 1
            merge_launches += 1
            launches += 2
    return vals, idx
