"""Row-masked h-index sweep: the wrapper of the CUDA kernel ``csrc/hindex.cu``.

The Hopper counterpart of the Pallas kernel in ``repro.kernels.hindex``:
per row ``min(est, H(row))`` with H the largest h such that at least h valid
entries are >= h, exact in int32, no sort. Each row is read once: rows of
up to 32 slots sit in a warp's lanes and are searched with ballots, wider
rows are counted into a histogram of ``min(est, W, valid count) + 1`` bins
in shared memory and scanned from the top. The kernel takes the validity
mask itself, so the caller never writes a masked copy of the values. The
plain versions are ``ref.h_index_ref`` (sort, the semantics of record) and
``ref.h_index_count`` (the binary search in torch, the CPU default).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["h_index_cuda", "max_width", "launches", "narrow_launches",
           "wide_launches", "NARROW_MAX"]

# kernel launches since the last reset: ``launches`` is the sum of the
# narrow kernel's (W <= 32) and the wide kernel's
launches = 0
narrow_launches = 0
wide_launches = 0

NARROW_MAX = 32  # the widest row the narrow (ballot) kernel takes


def _fn():
    lib = build.library("hindex")
    fn = lib.h_index_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, ctypes.c_longlong, i, i, p]
        fn.restype = ctypes.c_int
        lib.h_index_max_width.restype = i
    return lib, fn


def max_width() -> int:
    """The widest row the kernel takes: one warp's W + 1 histogram bins
    fill a block's shared memory."""
    return _fn()[0].h_index_max_width()


def h_index_cuda(values: torch.Tensor, valid: torch.Tensor,
                 est: torch.Tensor) -> torch.Tensor:
    """values: (R, W) int32; valid: (R, W) bool; est: (R,) int32, all
    contiguous on one CUDA device, W <= ``max_width()`` -> (R,) int32
    ``min(max(est, 0), H)``."""
    global launches, narrow_launches, wide_launches
    build.require(values, "values", (torch.int32,), 2)
    build.require(valid, "valid", (torch.bool,), 2, values.device)
    build.require(est, "est", (torch.int32,), 1, values.device)
    r, w = values.shape
    if valid.shape != values.shape or est.shape[0] != r:
        raise ValueError(
            f"shapes disagree: values {tuple(values.shape)}, valid "
            f"{tuple(valid.shape)}, est {tuple(est.shape)}"
        )
    lib, fn = _fn()
    if w > max_width():
        raise ValueError(f"row width {w} exceeds {max_width()}: its "
                         "histogram does not fit the shared memory")
    out = torch.empty(r, dtype=torch.int32, device=values.device)
    code = fn(values.data_ptr(), valid.data_ptr(), est.data_ptr(),
              out.data_ptr(), r, w, values.device.index,
              build.stream_of(values.device))
    build.check(lib, code, "h_index kernel")
    if r:  # the C side launches nothing for no rows
        launches += 1
        if w <= NARROW_MAX:
            narrow_launches += 1
        else:
            wide_launches += 1
    return out
