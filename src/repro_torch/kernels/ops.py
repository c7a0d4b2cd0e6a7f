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

Under a mesh (``distributed.sharding``), ``sgns_loss`` and
``decode_attention`` take DTensors: each rank runs the kernel (or, on CPU
shards, its plain version) on its own local shards through
``torch.distributed.tensor.experimental.local_map``, the counterpart of a
``shard_map`` in JAX. The batch stays split as it comes; flash-decode's
heads stay split with the cache's KV heads. A cache split along its
sequence (``kv_seq``) stays split: each rank runs the kernel over its own
positions with every query head (q, small, is gathered), and the partial
outputs are combined by their log-sum-exps (flash-decoding across ranks,
the partial-softmax all-reduce that GSPMD inserts in the JAX package), so
no rank holds another's cache positions. Every other wrapper refuses a
DTensor: there is no silent fallback to a global plain version.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import (as_dtensor, is_dtensor,
                                              shard_map)

from . import ellmean as _em
from . import flash_decode as _fd
from . import hindex as _hx
from . import ref as _ref
from . import sgns as _sg
from . import topk as _tk

__all__ = ["sgns_loss", "SGNSLoss", "ell_mean", "h_index_sweep",
           "top_k_scores", "normalize_rows", "decode_attention",
           "combine_partials"]


def _is_dtensor(*ts) -> bool:
    return any(map(is_dtensor, ts))


def _resolve(impl: str, t: torch.Tensor, cpu_default: str, allowed) -> str:
    if _is_dtensor(t):
        raise TypeError("a DTensor reached a kernel wrapper that has no "
                        "sharded path: pass its local shard")
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
    DTensors: each rank's batch rows on its own (``local_map``).
    """
    if _is_dtensor(center, ctx, neg):
        return _sgns_loss_sharded(center, ctx, neg, impl)
    impl = _resolve(impl, center, "ref", ("ref", "cuda"))
    if impl == "ref":
        return _ref.sgns_loss_ref(center, ctx, neg)
    return SGNSLoss.apply(center.contiguous(), ctx.contiguous(),
                          neg.contiguous(), _sg.sgns_fwd_cuda,
                          _sg.sgns_bwd_cuda)


def _batch_layout(x):
    """Placements that keep x's batch (dim 0) split where it is and
    replicate everything else (a partial sum is reduced)."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in x.placements]


def _sgns_loss_sharded(center, ctx, neg, impl):
    mesh = next(t.device_mesh for t in (center, ctx, neg) if is_dtensor(t))
    center, ctx, neg = (as_dtensor(t, mesh) for t in (center, ctx, neg))
    pl = _batch_layout(center)
    return shard_map(lambda c, x, n: sgns_loss(c, x, n, impl=impl), mesh,
                     (pl, pl, pl), pl)(center, ctx, neg)


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
    "auto" (by the tensors' device). DTensors: each rank's rows and heads
    on its own (``local_map``); a cache split along its sequence stays
    split and the ranks' partial outputs are combined
    (``_decode_attention_sharded``).
    """
    if _is_dtensor(q, k, v, cache_len):
        return _decode_attention_sharded(q, k, v, cache_len, softcap, window,
                                         k_scale, v_scale, impl)
    impl = _resolve(impl, q, "ref", ("ref", "cuda"))
    if impl == "ref":
        return _ref.decode_attention_ref(
            q, k, v, cache_len, softcap=softcap, window=window,
            k_scale=k_scale, v_scale=v_scale,
        )
    lens = cache_len.to(torch.int32).contiguous()
    return _fd.decode_attention_cuda(
        q.contiguous(), k, v, lens, _window_lo(lens, window).to(torch.int32),
        softcap=softcap, k_scale=k_scale, v_scale=v_scale,
    )


def _window_lo(lens, window):
    """Each row's first visible position: ``max(len - window, 0)`` where
    the window (an int or a 0-dim tensor) is on, else 0."""
    if isinstance(window, torch.Tensor):
        return torch.where(window > 0, (lens - window).clamp_min(0), 0)
    if window > 0:
        return (lens - window).clamp_min(0)
    return torch.zeros_like(lens)


def _decode_seq_shard(q, k, v, lens, window, off, softcap, k_scale, v_scale,
                      impl):
    """One rank's share of decode attention over a cache split along its
    sequence: the local positions ``[off, off + S_loc)`` of the global
    ``lens`` / window range (both shifted by ``off`` and clamped to
    ``[0, S_loc]``) -> (out (B, H, Dh) in q's dtype, lse (B, H) float32;
    a row with no position here gives 0 and -inf)."""
    s_loc = k.shape[1]
    lens = lens.to(torch.int32)
    lo = (_window_lo(lens, window) - off).clamp(0, s_loc).to(torch.int32)
    hi = (lens - off).clamp(0, s_loc).to(torch.int32)
    impl = _resolve(impl, q, "ref", ("ref", "cuda"))
    if impl == "ref":
        return _ref.decode_attention_ref(q, k, v, hi, softcap=softcap,
                                         k_scale=k_scale, v_scale=v_scale,
                                         win_lo=lo, return_lse=True)
    return _fd.decode_attention_cuda(
        q.contiguous(), k, v, hi.contiguous(), lo.contiguous(),
        softcap=softcap, k_scale=k_scale, v_scale=v_scale, return_lse=True)


def combine_partials(out, lse, groups):
    """Flash-decoding's combine of partial attention outputs across ranks:
    ``out`` (..., Dh) and ``lse`` (...) over disjoint parts of one sequence
    on the ranks of ``groups`` (process groups, or (mesh, dim) pairs) ->
    ``sum_r w_r out_r / sum_r w_r`` with ``w_r = exp(lse_r - max_r lse_r)``,
    float32: a max all-reduce of lse, then one sum all-reduce of the
    weighted outputs and the weights together. A part with lse -inf weighs
    nothing; a row with no visible position anywhere comes out 0."""
    from torch.distributed._functional_collectives import all_reduce

    top = lse
    for g in groups:
        top = all_reduce(top, "max", g)
    w = torch.where(lse > float("-inf"), torch.exp(lse - top), 0.0)
    part = torch.cat([out.float() * w[..., None], w[..., None]], dim=-1)
    for g in groups:
        part = all_reduce(part, "sum", g)
    num, den = part[..., :-1], part[..., -1:]
    return torch.where(den > 0, num / den.clamp_min(1e-30), 0.0)


def _decode_attention_sharded(q, k, v, cache_len, softcap, window, k_scale,
                              v_scale, impl):
    """``decode_attention`` on DTensors. The cache (B, S, Hkv, Dh) keeps its
    splits: of the batch (q (B, H, Dh) and cache_len (B,) follow it), of
    the KV heads (q's heads follow them) and of the sequence. On an axis
    that splits S, q is gathered (every query head runs over the rank's own
    positions, cache_len and the window shifted to them) and the ranks'
    partial outputs are combined by their log-sum-exps
    (``combine_partials``); the int8 scales split with the cache. On an
    axis that splits q's heads but not the cache, q stays split where each
    rank's H/n heads use a contiguous run of KV heads (their groups whole,
    or one group shared): the cache is replicated there and each rank picks
    its own KV heads, as ``attention._attention_by_heads`` does; elsewhere
    q is gathered. The output is laid out as q: on an axis that splits S,
    each rank keeps its own heads of the combined output where q came split
    by heads."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh = next(t.device_mesh for t in (k, q, v, cache_len)
                if is_dtensor(t))
    q, k, v, cache_len = (as_dtensor(t, mesh) for t in (q, k, v, cache_len))
    H, Hkv = q.shape[1], k.shape[2]
    G = H // Hkv
    q_pl, kv_pl, len_pl, out_pl, pick, seq = [], [], [], [], [], []
    for m, (pq, pk) in enumerate(zip(q.placements, k.placements)):
        n = mesh.size(m)
        h = H // n
        if isinstance(pk, Shard) and pk.dim == 0:
            q_pl.append(pk)
            kv_pl.append(pk)
            len_pl.append(pk)
            out_pl.append(pk)
        elif isinstance(pk, Shard) and pk.dim == 2:
            q_pl.append(Shard(1))
            kv_pl.append(pk)
            len_pl.append(Replicate())
            out_pl.append(Shard(1))
        elif isinstance(pk, Shard) and pk.dim == 1:
            q_pl.append(Replicate())
            kv_pl.append(pk)
            len_pl.append(Replicate())
            heads = isinstance(pq, Shard) and pq.dim == 1 and H % n == 0
            out_pl.append(Shard(1) if heads else Replicate())
            seq.append((m, heads))
        elif (isinstance(pq, Shard) and pq.dim == 1 and not pick
              and H % n == 0 and (h % G == 0 or G % h == 0)):
            q_pl.append(pq)
            kv_pl.append(Replicate())
            len_pl.append(Replicate())
            out_pl.append(pq)
            lo = mesh.get_local_rank(m) * h // G
            pick.append(slice(lo, lo + max(h // G, 1)))
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
            len_pl.append(Replicate())
            out_pl.append(Replicate())
    quant = k_scale is not None
    sc_pl = kv_pl if quant else None
    if quant:
        k_scale, v_scale = (as_dtensor(t, mesh) for t in (k_scale, v_scale))
    off = compute_local_shape_and_global_offset(k.shape, mesh, kv_pl)[1][1]
    mine = [(mesh.get_local_rank(m), mesh.size(m)) for m, heads in seq
            if heads]

    def local(q, k, v, lens, ks, vs):
        if pick:  # the kernel takes a contiguous cache
            k, v = (t[:, :, pick[0]].contiguous() for t in (k, v))
            if quant:
                ks, vs = (t[:, :, pick[0]].contiguous() for t in (ks, vs))
        if not seq:
            return decode_attention(q, k, v, lens, softcap=softcap,
                                    window=window, k_scale=ks, v_scale=vs,
                                    impl=impl)
        out, lse = _decode_seq_shard(q, k, v, lens, window, off, softcap,
                                     ks, vs, impl)
        out = combine_partials(out, lse, [(mesh, m) for m, _ in seq])
        for r, n in mine:  # this rank's heads, axis by axis
            out = out.unflatten(1, (n, -1))[:, r]
        return out.to(q.dtype)

    return shard_map(local, mesh, (q_pl, kv_pl, kv_pl, len_pl, sc_pl, sc_pl),
                     out_pl)(q, k, v, cache_len, k_scale, v_scale)
