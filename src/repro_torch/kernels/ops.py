"""Public entry points of the port's kernels, with the JAX package's contracts.

Dispatch: ``impl="auto"`` launches the hand-written CUDA kernel when the
tensors lie on a CUDA device and runs the plain PyTorch version when they lie
on the CPU; ``impl="cuda"`` always launches the kernel (and raises for CPU
tensors); ``impl="ref"`` (and ``"count"`` for the h-index) always runs the
plain version. There is no fallback from the kernel to the plain version.

The output contracts are those of ``repro.kernels.ops``: ``sgns_loss``
gives (B,) float32, differentiable through both SGNS kernels; ``ell_mean``
gives (N, D) in emb's dtype with empty rows 0; ``h_index_sweep`` gives (R,) int32;
``top_k_scores`` gives ``(vals, idx)`` ordered by (score desc, index asc)
with -inf / -1 padding; ``decode_attention`` gives (B, H, Dh) in q's dtype.
The TPU tiling work of the JAX wrappers (lane and row padding, the
left-pack argsort, the final sort, the decode block size that must divide
S) has no counterpart: the kernels take the shapes as they come and return
ordered results.
"""
from __future__ import annotations

import torch

from . import ellmean as _em
from . import flash_decode as _fd
from . import hindex as _hx
from . import ref as _ref
from . import sgns as _sg
from . import topk as _tk

__all__ = ["sgns_loss", "SGNSLoss", "ell_mean", "h_index_sweep",
           "top_k_scores", "normalize_rows", "decode_attention"]


def _resolve(impl: str, t: torch.Tensor, cpu_default: str, allowed) -> str:
    if impl == "auto":
        impl = "cuda" if t.is_cuda else cpu_default
    if impl not in allowed:
        raise ValueError(f"unknown impl {impl!r}; expected one of {allowed}")
    return impl


class SGNSLoss(torch.autograd.Function):
    """Per-example SGNS loss whose forward and backward are one fused
    function each: ``fwd(center, ctx, neg) -> loss`` and
    ``bwd(center, ctx, neg, dout) -> (dc, dx, dn)`` (the CUDA kernels, or
    on the CPU in tests their plain versions). Only the three inputs are
    saved: the backward recomputes the logits, as the JAX package's
    ``custom_vjp`` does."""

    @staticmethod
    def forward(fctx, center, ctx, neg, fwd, bwd):
        fctx.save_for_backward(center, ctx, neg)
        fctx.bwd = bwd
        return fwd(center, ctx, neg)

    @staticmethod
    def backward(fctx, dout):
        center, ctx, neg = fctx.saved_tensors
        # the gradient of a mean arrives expanded (stride 0)
        dc, dx, dn = fctx.bwd(center, ctx, neg, dout.float().contiguous())
        return dc, dx, dn, None, None


def sgns_loss(center, ctx, neg, *, impl: str = "auto"):
    """Per-example SGNS loss, differentiable with respect to all three
    inputs.

    center, ctx: (B, D); neg: (B, K, D), float32 or bfloat16 -> (B,)
    float32. ``impl``: "cuda" (the fused kernels), "ref" (the plain version,
    differentiated by autograd) or "auto" (by the tensors' device).
    """
    impl = _resolve(impl, center, "ref", ("ref", "cuda"))
    if impl == "ref":
        return _ref.sgns_loss_ref(center, ctx, neg)
    return SGNSLoss.apply(center.contiguous(), ctx.contiguous(),
                          neg.contiguous(), _sg.sgns_fwd_cuda,
                          _sg.sgns_bwd_cuda)


def ell_mean(idx, valid, emb, *, impl: str = "auto"):
    """Masked neighbour mean: out[i] = mean over valid j of emb[idx[i, j]].

    idx: (N, L) int; valid: (N, L) bool; emb: (M, D) -> (N, D).
    """
    impl = _resolve(impl, emb, "ref", ("ref", "cuda"))
    if impl == "ref":
        return _ref.ell_mean_ref(idx, valid, emb)
    return _em.ell_mean_cuda(
        idx.to(torch.int32).contiguous(), valid.to(torch.bool).contiguous(),
        emb.contiguous(),
    )


def h_index_sweep(values, valid, est, *, impl: str = "auto"):
    """One row-masked h-index repair sweep: ``min(est, H(row))``.

    values: (R, W) neighbour core estimates; valid: (R, W) bool; est: (R,)
    current row estimates (>= 0) -> (R,) int32. ``impl``: "ref" (sort),
    "count" (sort-free search, the CPU default) or "cuda" (the kernel).
    """
    impl = _resolve(impl, values, "count", ("ref", "count", "cuda"))
    if impl == "ref":
        return _ref.h_index_ref(values, valid, est)
    if impl == "count":
        return _ref.h_index_count(values, valid, est)
    return _hx.h_index_cuda(
        values.to(torch.int32).contiguous(),
        valid.to(torch.bool).contiguous(),
        est.to(torch.int32).contiguous(),
    )


def normalize_rows(x, *, eps: float = 1e-9):
    """L2-normalize rows in float32 (the cosine prep shared by
    ``link_scores`` and ``top_k_neighbors``, so both score alike)."""
    x = x.float()
    n = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / n.clamp_min(eps)


def top_k_scores(q, table, k, *, valid=None, impl: str = "auto"):
    """Per-query top-k candidate rows by dot-product score.

    q: (Q, D); table: (N, D); valid: optional (N,) bool row mask. Returns
    ``(vals (Q, k) float32, idx (Q, k) int32)`` ordered by (score desc,
    index asc); -inf / -1 pad when fewer than k valid candidates exist. The
    kernel runs ceil(k / 128) rounds (``topk.ROUND_K``), one pass over the
    table each.
    """
    impl = _resolve(impl, table, "ref", ("ref", "cuda"))
    if impl == "ref":
        return _ref.topk_ref(q, table, k, valid=valid)
    bias = torch.zeros(table.shape[0], dtype=torch.float32,
                       device=table.device)
    if valid is not None:  # dead rows can never enter a result
        bias.masked_fill_(~valid.to(torch.bool), float("-inf"))
    return _tk.topk_cuda(
        q.to(torch.float32).contiguous(), table.to(torch.float32).contiguous(),
        bias, int(k),
    )


def decode_attention(q, k, v, cache_len, *, softcap: float = 0.0, window=0,
                     k_scale=None, v_scale=None, impl: str = "auto"):
    """Single-token GQA decode attention over a padded KV cache.

    q: (B, H, Dh); k, v: (B, S, Hkv, Dh) (int8 with (B, S, Hkv) float32
    ``k_scale`` / ``v_scale``); cache_len: (B,) -> (B, H, Dh) in q's dtype.
    ``window`` > 0, a Python int or a 0-dim tensor (a per-layer window as
    data), keeps the positions ``max(len - window, 0) <= s < len`` of each
    row; a length above S sees the S cached positions. ``impl``: "cuda" (the
    kernel; the cache must be contiguous), "ref" (the plain version) or
    "auto" (by the tensors' device).
    """
    impl = _resolve(impl, q, "ref", ("ref", "cuda"))
    if impl == "ref":
        return _ref.decode_attention_ref(
            q, k, v, cache_len, softcap=softcap, window=window,
            k_scale=k_scale, v_scale=v_scale,
        )
    lens = cache_len.to(torch.int32).contiguous()
    if isinstance(window, torch.Tensor):
        win_lo = torch.where(window > 0, (lens - window).clamp_min(0), 0)
    elif window > 0:
        win_lo = (lens - window).clamp_min(0)
    else:
        win_lo = torch.zeros_like(lens)
    return _fd.decode_attention_cuda(
        q.contiguous(), k, v, lens, win_lo.to(torch.int32), softcap=softcap,
        k_scale=k_scale, v_scale=v_scale,
    )
