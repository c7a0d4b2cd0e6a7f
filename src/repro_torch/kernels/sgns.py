"""Fused SGNS loss forward and backward: wrappers of ``csrc/sgns.cu``.

The Hopper counterparts of the Pallas kernels in ``repro.kernels.sgns``
(the paper's compute hot spot): ``sgns_fwd_cuda`` gives the per-example
loss ``softplus(-<c, x>) + sum_k softplus(<n_k, c>)`` in fp32,
``sgns_bwd_cuda`` the analytic gradients of ``sum(loss * dout)``
recomputed from the inputs, each in its input's dtype, in one pass over
each example. Any batch size, width and number of negatives K: nothing is
padded, and no per-K state sits in shared memory. The plain versions are
``ref.sgns_loss_ref`` and ``ref.sgns_grads_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["sgns_fwd_cuda", "sgns_bwd_cuda", "fwd_launches", "bwd_launches"]

fwd_launches = 0  # forward kernel launches since the last reset
bwd_launches = 0  # backward kernel launches since the last reset

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fns():
    lib = build.library("sgns")
    fwd, bwd = lib.sgns_fwd_launch, lib.sgns_bwd_launch
    if fwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fwd.argtypes = [p, p, p, p, ll, i, i, i, i, p]
        fwd.restype = ctypes.c_int
        bwd.argtypes = [p, p, p, p, p, p, p, p, ll, i, i, i, i, p]
        bwd.restype = ctypes.c_int
        lib.sgns_bwd_max_reg_width.restype = i
    return lib, fwd, bwd


def _check(center, ctx, neg):
    build.require(center, "center", tuple(_DTYPES), 2)
    build.require(ctx, "ctx", (center.dtype,), 2, center.device)
    build.require(neg, "neg", (center.dtype,), 3, center.device)
    b, d = center.shape
    if ctx.shape != center.shape or neg.shape[0] != b or neg.shape[2] != d:
        raise ValueError(
            f"shapes center {tuple(center.shape)}, ctx {tuple(ctx.shape)}, "
            f"neg {tuple(neg.shape)}: expected (B, D), (B, D), (B, K, D)"
        )
    return b, d, neg.shape[1]


def sgns_fwd_cuda(center: torch.Tensor, ctx: torch.Tensor,
                  neg: torch.Tensor) -> torch.Tensor:
    """center, ctx: (B, D); neg: (B, K, D); one dtype (float32 or
    bfloat16), contiguous on one CUDA device -> loss (B,) float32."""
    global fwd_launches
    b, d, k = _check(center, ctx, neg)
    loss = torch.empty(b, dtype=torch.float32, device=center.device)
    lib, fn, _ = _fns()
    code = fn(center.data_ptr(), ctx.data_ptr(), neg.data_ptr(),
              loss.data_ptr(), b, d, k, _DTYPES[center.dtype],
              center.device.index, build.stream_of(center.device))
    build.check(lib, code, "sgns forward kernel")
    if b:  # the C side launches nothing for an empty batch
        fwd_launches += 1
    return loss


def sgns_bwd_cuda(center: torch.Tensor, ctx: torch.Tensor,
                  neg: torch.Tensor, dout: torch.Tensor):
    """The forward's inputs plus dout (B,) float32, contiguous (the
    gradient of a ``.mean()`` arrives with stride 0: make it contiguous
    first) -> (dcenter, dctx, dneg) in the inputs' dtype."""
    global bwd_launches
    b, d, k = _check(center, ctx, neg)
    build.require(dout, "dout", (torch.float32,), 1, center.device)
    if dout.shape[0] != b:
        raise ValueError(f"dout {tuple(dout.shape)} != ({b},)")
    dc, dx, dn = (torch.empty_like(t) for t in (center, ctx, neg))
    lib, _, fn = _fns()
    scratch = None  # rows wider than the registers hold: dneg through it
    if d > lib.sgns_bwd_max_reg_width():
        scratch = torch.empty(b * k, dtype=torch.float32,
                              device=center.device)
    code = fn(center.data_ptr(), ctx.data_ptr(), neg.data_ptr(),
              dout.data_ptr(), dc.data_ptr(), dx.data_ptr(), dn.data_ptr(),
              None if scratch is None else scratch.data_ptr(),
              b, d, k, _DTYPES[center.dtype], center.device.index,
              build.stream_of(center.device))
    build.check(lib, code, "sgns backward kernel")
    if b:
        bwd_launches += 1
    return dc, dx, dn
