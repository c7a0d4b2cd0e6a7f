"""Row-masked h-index sweep: the wrapper of the CUDA kernel ``csrc/hindex.cu``.

The Hopper counterpart of the Pallas kernel in ``repro.kernels.hindex``:
per row ``min(est, H(row))`` with H the largest h such that at least h valid
entries are >= h, found by a binary search over threshold counts (no sort),
exact in int32. The kernel takes the validity mask itself, so the caller
never writes a masked copy of the values. The plain versions are
``ref.h_index_ref`` (sort, the semantics of record) and ``ref.h_index_count``
(the same search in torch, the CPU default).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["h_index_cuda", "launches"]

launches = 0  # kernel launches since the last reset (a plain count)


def _fn():
    lib = build.library("hindex")
    fn = lib.h_index_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, ctypes.c_longlong, i, i, p]
        fn.restype = ctypes.c_int
    return lib, fn


def h_index_cuda(values: torch.Tensor, valid: torch.Tensor,
                 est: torch.Tensor) -> torch.Tensor:
    """values: (R, W) int32; valid: (R, W) bool; est: (R,) int32, all
    contiguous on one CUDA device -> (R,) int32 ``min(max(est, 0), H)``."""
    global launches
    build.require(values, "values", (torch.int32,), 2)
    build.require(valid, "valid", (torch.bool,), 2, values.device)
    build.require(est, "est", (torch.int32,), 1, values.device)
    r, w = values.shape
    if valid.shape != values.shape or est.shape[0] != r:
        raise ValueError(
            f"shapes disagree: values {tuple(values.shape)}, valid "
            f"{tuple(valid.shape)}, est {tuple(est.shape)}"
        )
    out = torch.empty(r, dtype=torch.int32, device=values.device)
    lib, fn = _fn()
    code = fn(values.data_ptr(), valid.data_ptr(), est.data_ptr(),
              out.data_ptr(), r, w, values.device.index,
              build.stream_of(values.device))
    build.check(lib, code, "h_index kernel")
    if r:  # the C side launches nothing for no rows
        launches += 1
    return out
