"""Public entry points of the port's kernels, with the JAX package's contracts.

Dispatch: ``impl="auto"`` launches the hand-written CUDA kernel when the
tensors lie on a CUDA device and runs the plain PyTorch version when they lie
on the CPU; ``impl="cuda"`` always launches the kernel (and raises for CPU
tensors); ``impl="ref"`` (and ``"count"`` for the h-index) always runs the
plain version. There is no fallback from the kernel to the plain version.

The output contracts are those of ``repro.kernels.ops``: ``ell_mean`` gives
(N, D) in emb's dtype with empty rows 0; ``h_index_sweep`` gives (R,) int32;
``top_k_scores`` gives ``(vals, idx)`` ordered by (score desc, index asc)
with -inf / -1 padding. The TPU tiling work of the JAX wrappers (lane and
row padding, the left-pack argsort, the final sort) has no counterpart: the
kernels take the shapes as they come and return ordered results.
"""
from __future__ import annotations

import torch

from . import ellmean as _em
from . import hindex as _hx
from . import ref as _ref
from . import topk as _tk

__all__ = ["ell_mean", "h_index_sweep", "top_k_scores", "normalize_rows"]


def _resolve(impl: str, t: torch.Tensor, cpu_default: str, allowed) -> str:
    if impl == "auto":
        impl = "cuda" if t.is_cuda else cpu_default
    if impl not in allowed:
        raise ValueError(f"unknown impl {impl!r}; expected one of {allowed}")
    return impl


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
    kernel runs ceil(k / 32) rounds (``topk.ROUND_K``), one pass over the
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
