"""ELL neighbour mean: the wrapper of the CUDA kernel ``csrc/ellmean.cu``.

The Hopper counterpart of the Pallas kernel in ``repro.kernels.ellmean``:
``out[i] = mean(emb[idx[i, j]] for valid j)``, empty rows 0, fp32
accumulation, output in emb's dtype, the (N, L, D) gather never
materialised. The kernel reads ``idx``/``valid`` directly, so unlike the TPU
path there is no left-pack. Few long rows (fewer than 8 rows per SM, at
least 256 slots a row) take a block per row, the rest a warp per row
(the rule is in the source; :func:`row_split` reports it). The plain
version is ``ref.ell_mean_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, cost

__all__ = ["ell_mean_cuda", "row_split", "launches"]

launches = 0  # kernel launches since the last reset (a plain count)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fn():
    lib = build.library("ellmean")
    fn = lib.ell_mean_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, ctypes.c_longlong, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib, fn


def row_split(n: int, l: int, device) -> bool:
    """Whether an (N, L) launch on ``device`` (a CUDA device) takes the
    row-split kernel (a block per row) rather than a warp per row. Launches
    nothing."""
    lib = build.library("ellmean")
    fn = lib.ell_mean_path
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    path = ctypes.c_int(0)
    build.check(lib, fn(n, l, torch.device(device).index or 0,
                        ctypes.byref(path)), "ell_mean path")
    return bool(path.value)


def ell_mean_cuda(idx: torch.Tensor, valid: torch.Tensor,
                  emb: torch.Tensor) -> torch.Tensor:
    """idx: (N, L) int32; valid: (N, L) bool; emb: (M, D) float32/bfloat16,
    all contiguous on one CUDA device -> (N, D) in emb's dtype. Valid
    entries must index rows of ``emb``."""
    global launches
    build.require(emb, "emb", tuple(_DTYPES), 2)
    build.require(idx, "idx", (torch.int32,), 2, emb.device)
    build.require(valid, "valid", (torch.bool,), 2, emb.device)
    if valid.shape != idx.shape:
        raise ValueError(
            f"valid {tuple(valid.shape)} != idx {tuple(idx.shape)}"
        )
    n, l = idx.shape
    d = emb.shape[1]
    out = torch.empty((n, d), dtype=emb.dtype, device=emb.device)
    lib, fn = _fn()
    code = fn(idx.data_ptr(), valid.data_ptr(), emb.data_ptr(),
              out.data_ptr(), n, l, d, _DTYPES[emb.dtype],
              emb.device.index, build.stream_of(emb.device))
    build.check(lib, code, "ell_mean kernel")
    if n and d:  # the C side launches nothing for an empty output
        launches += 1
        cost.reckon(cost.ell_mean, idx, valid, emb)
    return out
