"""Streaming score + top-k: the wrapper of the CUDA kernel ``csrc/topk.cu``.

The Hopper counterpart of the Pallas kernel in ``repro.kernels.topk``: per
query the k table rows with the highest ``q . t + bias`` under the total
order (score desc, index asc), the (Q, N) scores never written to memory,
fp32 FFMA throughout (no TF32). The TPU kernel carries one running
accumulator across a sequential grid; here pass 1 reduces each (64 queries,
table chunk) block to a sorted (64, k) partial and pass 2 merges the
partials per query, so the result comes back already ordered. A warp keeps
at most 32 entries, so a larger k runs in rounds of 32: each round admits
only rows after the previous round's last entry and writes the next slice
of the sorted result. The plain version is ``ref.topk_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["topk_cuda", "launches", "ROUND_K", "MAX_DIM"]

launches = 0  # kernel launches since the last reset: two per round

ROUND_K = 32  # entries per round: one warp lane each
MAX_DIM = 436  # (64 query + 64 table rows) x padded width in 227 KB of smem
_TARGET_BLOCKS = 4 * 132  # about four waves of blocks on the H100's SMs
_SMEM_LIMIT = 232448


def _fn():
    lib = build.library("topk")
    fn = lib.topk_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 9 + [p]
        fn.restype = ctypes.c_int
        lib.topk_rows_per_tile.restype = ctypes.c_int
        lib.topk_smem_bytes.argtypes = [ctypes.c_int]
        lib.topk_smem_bytes.restype = ctypes.c_longlong
    return lib, fn


def padded_width(d: int) -> int:
    """Shared-memory row width in floats: a multiple of 4 whose float4 count
    is 1 mod 8, so the 8 lanes of a float4 phase read distinct banks."""
    dp = -(-d // 4) * 4
    while (dp // 4) % 8 != 1:
        dp += 4
    return dp


def chunking(n_rows: int, n_queries: int, tile: int = 64):
    """(n_chunks, rows_per_chunk) of pass 1: about four waves of blocks,
    each chunk a whole number of tiles."""
    q_blocks = -(-max(n_queries, 1) // 64)
    want = max(1, min(-(-n_rows // tile), _TARGET_BLOCKS // q_blocks))
    rows = -(-max(n_rows, 1) // want)
    rows = -(-rows // tile) * tile
    return -(-max(n_rows, 1) // rows), rows


def topk_cuda(q: torch.Tensor, table: torch.Tensor, bias: torch.Tensor,
              k: int):
    """q: (Q, D), table: (N, D), bias: (N,) float32 (0 live, -inf dead), all
    contiguous on one CUDA device; k >= 1 (ceil(k / 32) rounds, each a
    pass over the table), D <= 436. Returns ``(vals (Q, k) float32,
    idx (Q, k) int32)`` ordered by (score desc, index asc), -inf / -1
    where fewer than k rows are live."""
    global launches
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
    if d > MAX_DIM:
        raise ValueError(f"embedding width {d} exceeds {MAX_DIM}")
    lib, fn = _fn()
    dp = padded_width(d)
    assert lib.topk_smem_bytes(dp) <= _SMEM_LIMIT
    n_chunks, rows = chunking(n, nq, lib.topk_rows_per_tile())
    dev = table.device
    kr = min(k, ROUND_K)
    pv = torch.empty((nq, n_chunks, kr), dtype=torch.float32, device=dev)
    pi = torch.empty((nq, n_chunks, kr), dtype=torch.int32, device=dev)
    vals = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nq, k), dtype=torch.int32, device=dev)
    stream = build.stream_of(dev)
    for c0 in range(0, k, ROUND_K):
        # round c0 // 32 fills columns [c0, c0 + kr); its floor is column
        # c0 - 1, the previous round's last entry (4-byte elements)
        kr = min(ROUND_K, k - c0)
        floor_v = vals.data_ptr() + 4 * (c0 - 1) if c0 else None
        floor_i = idx.data_ptr() + 4 * (c0 - 1) if c0 else None
        code = fn(q.data_ptr(), table.data_ptr(), bias.data_ptr(), floor_v,
                  floor_i, pv.data_ptr(), pi.data_ptr(),
                  vals.data_ptr() + 4 * c0, idx.data_ptr() + 4 * c0, k, nq,
                  n, d, dp, kr, n_chunks, rows, dev.index, stream)
        build.check(lib, code, "top-k kernel")
        if nq:
            launches += 2  # topk_partial + topk_merge
    return vals, idx
