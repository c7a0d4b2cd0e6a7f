"""Row-masked h-index sweep: the wrapper of the CUDA kernel ``csrc/hindex.cu``.

The Hopper counterpart of the Pallas kernel in ``repro.kernels.hindex``:
per row ``min(est, H(row))`` with H the largest h such that at least h valid
entries are >= h, exact in int32, no sort, at any width W. Three kernels by
W: rows of up to 32 slots take a thread each (the valid values packed four
to a word, binary-searched in registers); wider rows up to ``max_width()``
take a warp each, counting into a histogram of ``min(est, W, valid count) +
1`` bins in shared memory scanned from the top; hub rows, wider than that,
take a cluster of 4 blocks each, whose histogram of 1,024 coarse bins
narrows the answer's range a level at a time (two levels below W = 2^20).
The kernels take the validity mask themselves, so the caller never writes a
masked copy of the values. The plain versions are ``ref.h_index_ref``
(sort, the semantics of record) and ``ref.h_index_count`` (the binary
search in torch, the CPU default).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["h_index_cuda", "max_width", "launches", "narrow_launches",
           "wide_launches", "hub_launches", "NARROW_MAX"]

# kernel launches since the last reset: ``launches`` is the sum of the
# narrow kernel's (W <= 32), the wide kernel's and the hub kernel's
# (W > ``max_width()``)
launches = 0
narrow_launches = 0
wide_launches = 0
hub_launches = 0

NARROW_MAX = 32  # the widest row the narrow (thread per row) kernel takes


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
    """The widest row of the wide kernel: one warp's W + 1 histogram bins
    fill a block's shared memory. Wider rows take the hub kernel."""
    return _fn()[0].h_index_max_width()


def h_index_cuda(values: torch.Tensor, valid: torch.Tensor,
                 est: torch.Tensor) -> torch.Tensor:
    """values: (R, W) int32; valid: (R, W) bool; est: (R,) int32, all
    contiguous on one CUDA device, any W -> (R,) int32
    ``min(max(est, 0), H)``."""
    global launches, narrow_launches, wide_launches, hub_launches
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
    out = torch.empty(r, dtype=torch.int32, device=values.device)
    code = fn(values.data_ptr(), valid.data_ptr(), est.data_ptr(),
              out.data_ptr(), r, w, values.device.index,
              build.stream_of(values.device))
    build.check(lib, code, "h_index kernel")
    if r:  # the C side launches nothing for no rows
        launches += 1
        if w <= NARROW_MAX:
            narrow_launches += 1
        elif w <= max_width():
            wide_launches += 1
        else:
            hub_launches += 1
    return out
