"""Plain PyTorch versions of the port's kernels — the semantics of record.

Torch counterparts of ``repro.kernels.ref`` (``sgns_loss_ref``,
``sgns_grads_ref``, ``ell_mean_ref``, ``h_index_ref``, ``topk_ref``,
``decode_attention_ref``) plus the sort-free ``h_index_count`` of
``repro.kernels.hindex``. They are what the CPU runs, and what every CUDA
kernel is held against on the card. Scores and means are fp32 whatever the
input type; on the card a caller that compares against them keeps TF32 off.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["sgns_loss_ref", "sgns_grads_ref", "ell_mean_ref", "h_index_ref",
           "h_index_count", "topk_ref", "decode_attention_ref"]


def _logits(center, ctx, neg):
    c, x, n = center.float(), ctx.float(), neg.float()
    pos = torch.sum(c * x, dim=-1)
    negl = torch.einsum("bkd,bd->bk", n, c)
    return c, x, n, pos, negl


def sgns_loss_ref(center: torch.Tensor, ctx: torch.Tensor,
                  neg: torch.Tensor) -> torch.Tensor:
    """SkipGram negative-sampling loss per example.

    center, ctx: (B, D); neg: (B, K, D). Returns (B,) float32; logits
    accumulate in float32 whatever the input dtype.
    """
    _, _, _, pos, negl = _logits(center, ctx, neg)
    return -(F.logsigmoid(pos) + F.logsigmoid(-negl).sum(dim=-1))


def sgns_grads_ref(center, ctx, neg, dout):
    """Analytic gradients of ``sum(sgns_loss * dout)`` with respect to
    (center, ctx, neg), each returned in its input's dtype."""
    c, x, n, pos, negl = _logits(center, ctx, neg)
    d = dout.float()
    dpos = (torch.sigmoid(pos) - 1.0) * d  # (B,)
    dneg = torch.sigmoid(negl) * d[:, None]  # (B, K)
    dcenter = dpos[:, None] * x + torch.einsum("bk,bkd->bd", dneg, n)
    dctx = dpos[:, None] * c
    dnegs = dneg[:, :, None] * c[:, None, :]
    return (dcenter.to(center.dtype), dctx.to(ctx.dtype),
            dnegs.to(neg.dtype))


def ell_mean_ref(idx: torch.Tensor, valid: torch.Tensor,
                 emb: torch.Tensor) -> torch.Tensor:
    """Masked neighbour mean over an ELL table.

    idx: (N, L) rows into emb; valid: (N, L) bool; emb: (M, D). Rows with
    no valid neighbour return zeros. Returns (N, D) in emb's dtype.
    """
    gathered = emb[idx.long()].float()  # (N, L, D)
    m = valid.float().unsqueeze(-1)
    s = (gathered * m).sum(dim=1)
    cnt = m.sum(dim=1)
    return (s / cnt.clamp_min(1.0)).to(emb.dtype)


def h_index_ref(values: torch.Tensor, valid: torch.Tensor,
                est: torch.Tensor) -> torch.Tensor:
    """Row-masked h-index repair sweep ``min(est, H(row))``, by sorting.

    values: (R, W) neighbour estimates; valid: (R, W) bool; est: (R,).
    H = max h such that at least h valid entries are >= h. Returns (R,)
    int32.
    """
    vals = torch.where(valid, values.to(torch.int32), -1)
    w = vals.shape[-1]
    if w == 0:
        h = torch.zeros(vals.shape[:-1], dtype=torch.int32,
                        device=vals.device)
    else:
        svals = torch.sort(vals, dim=-1, descending=True).values
        ranks = torch.arange(1, w + 1, dtype=torch.int32, device=vals.device)
        h = torch.where(svals >= ranks, ranks, 0).amax(dim=-1)
    return torch.minimum(est.to(torch.int32), h.to(torch.int32))


def h_index_count(values: torch.Tensor, valid: torch.Tensor,
                  est: torch.Tensor) -> torch.Tensor:
    """``min(est, H(row))`` by binary-searched threshold counts, no sort.

    The largest h <= max(est, 0) with count(row >= h) >= h; count is
    non-increasing in h, so ``W.bit_length()`` halvings of [0, min(est, W)]
    pin it exactly. Returns (R,) int32.
    """
    vals = torch.where(valid, values.to(torch.int32), -1)
    w = vals.shape[-1]
    est = est.to(torch.int32).clamp_min(0)
    lo = torch.zeros_like(est)
    hi = est.clamp_max(w)
    for _ in range(max(1, int(w).bit_length())):
        mid = (lo + hi + 1) // 2
        cnt = (vals >= mid.unsqueeze(-1)).sum(dim=-1, dtype=torch.int32)
        ok = cnt >= mid
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid - 1)
    return lo


def topk_ref(q: torch.Tensor, table: torch.Tensor, k: int,
             valid: torch.Tensor = None):
    """Dense top-k by dot-product score.

    q: (Q, D); table: (N, D); valid: optional (N,) bool row mask. Returns
    ``(vals (Q, k) float32, idx (Q, k) int32)`` ordered by (score desc,
    index asc); -inf / -1 pad when fewer than k valid candidates exist.
    Materialises the (Q, N) scores; a stable sort of the negated scores
    keeps ties in index order.
    """
    scores = q.float() @ table.float().T
    if valid is not None:
        scores = scores.masked_fill(~valid.bool().unsqueeze(0), float("-inf"))
    n_q, n = scores.shape
    kk = min(int(k), n)
    neg, order = torch.sort(-scores, dim=1, stable=True)
    vals = -neg[:, :kk]
    idx = torch.where(vals > float("-inf"), order[:, :kk].to(torch.int32), -1)
    if kk < k:
        vals = torch.cat([vals, vals.new_full((n_q, k - kk), float("-inf"))], 1)
        idx = torch.cat([idx, idx.new_full((n_q, k - kk), -1)], 1)
    return vals, idx


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         cache_len: torch.Tensor, *, softcap: float = 0.0,
                         window=0, k_scale=None, v_scale=None) -> torch.Tensor:
    """Single-token GQA decode attention over a padded KV cache.

    q: (B, H, Dh) for the new token; k, v: (B, S, Hkv, Dh) cache (padded to
    S; float32, bfloat16, or int8 with ``k_scale`` / ``v_scale`` (B, S, Hkv)
    float32 scales that dequantise it); cache_len: (B,) lengths, which may
    exceed S (only the S cached positions are visible then). H = G * Hkv,
    query head h reads cache head h // G. ``window`` > 0 (an int or a 0-dim
    tensor) keeps only the last ``window`` positions below each length.
    Logits accumulate in float32, are scaled by 1/sqrt(Dh), capped by
    ``softcap * tanh(. / softcap)`` when softcap > 0, and masked to -1e30
    after the cap. Returns (B, H, Dh) in q's dtype.

    Defined only for rows with at least one visible position (decode always
    has one: length >= 1 and the window's lower bound below it). For a row
    with none this softmax averages V uniformly where the CUDA kernel, like
    the Pallas one, returns 0.
    """
    b, h, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, hkv, h // hkv, dh)
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf = kf * k_scale[..., None].float()
    if v_scale is not None:
        vf = vf * v_scale[..., None].float()
    logits = torch.einsum("bhgd,bshd->bhgs", qf, kf) / float(np.sqrt(
        np.float32(dh)))
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    pos = torch.arange(s, device=q.device)[None, :]
    lens = cache_len.to(q.device)[:, None]
    if isinstance(window, torch.Tensor):
        window = window.to(q.device)
        win_lo = torch.where(window > 0, lens - window, 0)
    else:  # a Python int: nothing to copy to the device
        win_lo = lens - window if window > 0 else torch.zeros_like(lens)
    mask = (pos < lens) & (pos >= win_lo)
    logits = logits.masked_fill(~mask[:, None, None, :], -1e30)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, vf)
    return out.reshape(b, h, dh).to(q.dtype)
