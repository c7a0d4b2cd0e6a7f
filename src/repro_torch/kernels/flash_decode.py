"""GQA decode attention (flash-decode): the wrapper of ``csrc/flash_decode.cu``.

The Hopper counterpart of the Pallas kernel in ``repro.kernels.flash_decode``
(the LM serving hot spot): single-token attention of (B, H, Dh) queries over
a padded (B, S, Hkv, Dh) KV cache, GQA (H = G * Hkv), an optional logit
softcap, a per-row window lower bound passed as data, ragged per-row lengths
(clamped to S), an optional int8 cache with (B, S, Hkv) fp32 scales, and
any head dim Dh that is a multiple of 8 from 32 to 256 (``HEAD_DIMS``).
fp32 accumulation, output in q's dtype. The cache is read in its own layout,
with no copy: it must be contiguous, as a per-layer slice of a contiguous
(L, B, S, Hkv, Dh) cache is. One launch splits each row's visible range
over a cluster of up to 8 blocks and combines the splits in a fixed order
(the splitting rule is in the source; :func:`splits` reports it), so two
calls on the same inputs give the same bits. On request it also returns
each query row's log-sum-exp of its scaled, soft-capped logits over the
visible range, fp32 (B, H) (-inf for a row with none): the weights that
combine the partial outputs of a cache split along its sequence
(``ops.decode_attention`` on such a DTensor cache); the output's bits are
the same with and without it. The plain version is
``ref.decode_attention_ref``; ``ops.decode_attention`` computes the window
bound and dispatches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, cost

__all__ = ["decode_attention_cuda", "splits", "launches", "HEAD_DIMS"]

launches = 0  # kernel launches since the last reset (a plain count)

# The head dims the kernel takes: every multiple of 8 from 32 to 256. Each
# runs on the next of the widths it is built for (32, 64, 128, 256: 112 on
# 128), its columns above Dh zero in shared memory and never stored
HEAD_DIMS = tuple(range(32, 257, 8))
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT8 = 2


def _fn():
    lib = build.library("flash_decode")
    fn = lib.flash_decode_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                       ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return lib, fn


def splits(q: torch.Tensor, k: torch.Tensor) -> int:
    """The number of splits of S a launch on (q, k) uses (q: (B, H, Dh),
    k: (B, S, Hkv, Dh), both on one CUDA device). Launches nothing."""
    lib = build.library("flash_decode")
    fn = lib.flash_decode_splits
    if fn.argtypes is None:
        i = ctypes.c_int
        fn.argtypes = [i, i, i, i, i, i, i, i, ctypes.POINTER(i)]
        fn.restype = i
    b, h, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    kv = _INT8 if k.dtype == torch.int8 else _Q_DTYPES[q.dtype]
    n = ctypes.c_int(0)
    build.check(lib, fn(b, s, h, hkv, dh, _Q_DTYPES[q.dtype], kv,
                        q.device.index, ctypes.byref(n)),
                "flash_decode splits")
    return n.value


def _aligned(t: torch.Tensor, name: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cache_len: torch.Tensor, win_lo: torch.Tensor, *,
                          softcap: float = 0.0, k_scale=None,
                          v_scale=None, return_lse: bool = False):
    """q: (B, H, Dh) float32/bfloat16; k, v: (B, S, Hkv, Dh) in q's dtype,
    or int8 with k_scale, v_scale (B, S, Hkv) float32; cache_len, win_lo:
    (B,) int32. All contiguous on one CUDA device; Dh in ``HEAD_DIMS`` (a
    multiple of 8 from 32 to 256).
    Row b attends to positions ``win_lo[b] <= s < min(cache_len[b], S)``
    and must have at least one (a row with none gives 0). -> (B, H, Dh) in
    q's dtype; with ``return_lse`` also (B, H) float32, each query row's
    log-sum-exp over its visible positions (-inf for a row with none)."""
    global launches
    build.require(q, "q", tuple(_Q_DTYPES), 3)
    build.require(k, "k", (q.dtype, torch.int8), 4, q.device)
    build.require(v, "v", (k.dtype,), 4, q.device)
    build.require(cache_len, "cache_len", (torch.int32,), 1, q.device)
    build.require(win_lo, "win_lo", (torch.int32,), 1, q.device)
    b, h, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if k.shape != (b, s, hkv, dh) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: expected (B, H, Dh) and "
                         "(B, S, Hkv, Dh)")
    if hkv == 0 or h % hkv:
        raise ValueError(f"H = {h} is not a multiple of Hkv = {hkv}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} is not a multiple of 8 from 32 "
                         "to 256")
    if cache_len.shape != (b,) or win_lo.shape != (b,):
        raise ValueError("cache_len and win_lo must be (B,)")
    quant = k.dtype == torch.int8
    if quant != (k_scale is not None) or quant != (v_scale is not None):
        raise ValueError("an int8 cache needs k_scale and v_scale, and only "
                         "an int8 cache takes them")
    scales = (0, 0)
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            build.require(t, name, (torch.float32,), 3, q.device)
            if t.shape != (b, s, hkv):
                raise ValueError(f"{name} {tuple(t.shape)} != {(b, s, hkv)}")
        scales = (k_scale.data_ptr(), v_scale.data_ptr())
    for name, t in (("q", q), ("k", k), ("v", v)):
        _aligned(t, name)
    out = torch.empty_like(q)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device) \
        if return_lse else None
    lib, fn = _fn()
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *scales,
              cache_len.data_ptr(), win_lo.data_ptr(), out.data_ptr(),
              0 if lse is None else lse.data_ptr(), b, s,
              h, hkv, dh, _Q_DTYPES[q.dtype],
              _INT8 if quant else _Q_DTYPES[q.dtype], float(softcap),
              q.device.index, build.stream_of(q.device))
    build.check(lib, code, "flash_decode kernel")
    if b and h:  # the C side launches nothing for an empty output
        launches += 1
        cost.reckon(cost.decode_attention, q, k, cache_len, win_lo, quant,
                    lse is not None)
    return out if lse is None else (out, lse)
