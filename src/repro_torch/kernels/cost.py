"""Bytes and operations of the hand kernels' launches, reckoned while a tally
is open.

A kernel launched through ``ctypes`` is invisible to PyTorch's dispatcher, so
``obs.device.compiled_cost`` cannot see its work by watching aten ops. Each
wrapper reckons it instead: where it launches its kernel, it adds to every
open :class:`Tally` the bytes the kernel must move (each input read once,
each output written once) and the operations it does on these inputs, by the
formulas below, which ``chip_smoke.py`` bounds the kernels by. Most counts
depend on the data (the valid entries of an ELL row, the probes of an
h-index search, the visible positions of a decode row), so reckoning reads
the device back: it runs only while a tally is open, and a wrapper called
with none open pays one list check.
"""
from __future__ import annotations

import contextlib
from typing import List, Tuple

import torch

__all__ = ["Tally", "tally", "reckon", "reckoning", "ell_mean", "h_index",
           "top_k", "sgns_fwd", "sgns_bwd", "decode_attention"]


class Tally:
    """The bytes and operations reckoned since it was opened."""

    def __init__(self):
        self.bytes = 0.0
        self.operations = 0.0


_open: List[Tally] = []
_reckoning = False


@contextlib.contextmanager
def tally():
    """Open a :class:`Tally` for the enclosed block (tallies nest: each
    launch adds to every open one)."""
    t = Tally()
    _open.append(t)
    try:
        yield t
    finally:
        _open.remove(t)


def reckon(formula, *args) -> None:
    """Add ``formula(*args)``, one call's (bytes, operations), to every open
    tally; nothing runs when none is open."""
    global _reckoning
    if not _open:
        return
    _reckoning = True  # the formula's own ops are not the call's work
    try:
        nbytes, nops = formula(*args)
    finally:
        _reckoning = False
    for t in _open:
        t.bytes += nbytes
        t.operations += nops


def reckoning() -> bool:
    """Whether a formula is running now (a counter of aten ops skips its
    ops)."""
    return _reckoning


# ------------------------------------------------------------ formulas ----
# Each returns (bytes, operations) of one wrapper call on these inputs.


def ell_mean(idx: torch.Tensor, valid: torch.Tensor,
             emb: torch.Tensor) -> Tuple[float, float]:
    """The valid rows of ``emb`` read, idx and valid read (5 bytes a slot),
    the (N, D) output written; an add per valid element."""
    n, l = idx.shape
    d, es = emb.shape[1], emb.element_size()
    cnt = int(valid.sum())
    return cnt * d * es + n * l * 5 + n * d * es, cnt * d


def _probes(values, valid, est) -> int:
    """Σ over the probes of each row's search of the row's valid entries:
    the compares the sort-free search needs on these inputs (a row whose
    estimate is 0 needs none)."""
    vals = torch.where(valid, values, -1)
    deg = valid.sum(1)
    lo = torch.zeros_like(est)
    hi = est.clamp_min(0).clamp_max(vals.shape[1])
    total = 0
    while True:
        live = lo < hi
        if not bool(live.any()):
            return total
        total += int(deg[live].sum())
        mid = (lo + hi + 1) // 2
        ok = (vals >= mid[:, None]).sum(1) >= mid
        lo = torch.where(live & ok, mid, lo)
        hi = torch.where(live & ~ok, mid - 1, hi)


def h_index(values: torch.Tensor, valid: torch.Tensor,
            est: torch.Tensor) -> Tuple[float, float]:
    """The valid entries (int32 value + mask byte) of rows with est > 0, the
    only rows whose search reads anything, plus est and out of every row;
    the compares of the rows' searches."""
    nbytes = int(valid[est > 0].sum()) * 5 + values.shape[0] * 8
    return nbytes, _probes(values, valid, est)


def top_k(q: torch.Tensor, table: torch.Tensor, k: int) -> Tuple[float, float]:
    """The table, its bias and the queries read, (Q, k) values and ids
    written; a multiply-add per (query, row, column)."""
    n, d = table.shape
    nq = q.shape[0]
    return n * d * 4 + n * 4 + nq * d * 4 + nq * k * 8, 2.0 * nq * n * d


def _sgns_inputs(center: torch.Tensor, neg: torch.Tensor):
    """(input bytes, B x D x (K + 1) elements of the K + 1 dots)."""
    b, d = center.shape
    k = neg.shape[1]
    return (2 * b * d + b * k * d) * center.element_size(), b * d * (k + 1)


def sgns_fwd(center: torch.Tensor, neg: torch.Tensor) -> Tuple[float, float]:
    """The inputs read, the (B,) loss written; the K + 1 dots."""
    in_bytes, elems = _sgns_inputs(center, neg)
    return in_bytes + 4 * center.shape[0], 2.0 * elems


def sgns_bwd(center: torch.Tensor, neg: torch.Tensor) -> Tuple[float, float]:
    """The inputs and dout read, the gradients written; the dots recomputed,
    then 3 operations per element for the gradients."""
    in_bytes, elems = _sgns_inputs(center, neg)
    return 2 * in_bytes + 4 * center.shape[0], 2.0 * elems + 3.0 * elems


def decode_attention(q: torch.Tensor, k: torch.Tensor,
                     cache_len: torch.Tensor, win_lo: torch.Tensor,
                     quant: bool) -> Tuple[float, float]:
    """The visible K and V rows (and their int8 scales) read, q read and the
    output written, cache_len and win_lo read; QK and PV, 2 operations an
    element each."""
    b, h, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    vis = int((cache_len.clamp_max(s) - win_lo).clamp_min(0).sum())
    nbytes = (vis * hkv * dh * 2 * k.element_size()
              + (vis * hkv * 8 if quant else 0)
              + 2 * q.numel() * q.element_size() + 8 * b)
    return nbytes, 4.0 * vis * h * dh
