"""Plain PyTorch versions of the port's kernels — the semantics of record.

Torch counterparts of ``repro.kernels.ref`` (``ell_mean_ref``,
``h_index_ref``, ``topk_ref``) plus the sort-free ``h_index_count`` of
``repro.kernels.hindex``. They are what the CPU runs, and what every CUDA
kernel is held against on the card. Scores and means are fp32 whatever the
input type; on the card a caller that compares against them keeps TF32 off.
"""
from __future__ import annotations

import torch

__all__ = ["ell_mean_ref", "h_index_ref", "h_index_count", "topk_ref"]


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
