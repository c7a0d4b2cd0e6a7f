"""Models of the two redesigned kernels' algorithms, on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``). What
they compute is modelled here step for step in plain Python / torch on the
same fp32 inputs, so that the algorithm, apart from the hardware, is held
to the semantics of record exactly:

* the top-k (``csrc/topk.cu``): the planner ``kernels.topk.plan`` cuts the
  rows into the blocks' ranges; each block scores 256-row tiles, offers
  each score that beats its query's k-th entry to a candidate buffer, in an
  arbitrary order, and flushes buffer and list with the kernel's bitonic
  network (index for index) when a buffer overflows and at the end; the
  merge reads the partials rank by rank and stops early. Ids and values
  must equal ``ref.topk_ref`` exactly (the same scores, compared bit for
  bit);
* the h-index (``csrc/hindex.cu``): the narrow rows' search (a thread per
  row, a binary search over its packed values), the wide rows' histogram
  of ``hi + 1`` bins and the warp's suffix scan from ``hi`` down in steps
  of 32, and the hub rows' levels of coarse bins, each narrowing the
  answer's range, scanned a warp's range of bins at a time, against
  ``ref.h_index_ref`` and the JAX package's sort-free ``h_index_count``
  (exact integers).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref, topk

# the kernel's constants (csrc/topk.cu)
NONE = 0x7FFFFFFF  # index of an empty entry
NO_FLOOR = -2
BUFFER_SLOTS = 128  # candidate slots of a query in a partial block
MERGE_BUF = 256  # candidate slots of a merge block
EMPTY = (float("-inf"), NONE)


def list_width(kr):
    """Entries of a query's running list: a power of two >= kr."""
    return 1 << max(kr - 1, 0).bit_length()


def better(a, b):
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def admit(s, r, floor):
    fv, fi = floor
    return s > float("-inf") and (fi == NO_FLOOR
                                  or (fi >= 0 and better((fv, fi), (s, r))))


def pair_of(t, st):
    """The (i, j) a compare-exchange thread t handles at stride st."""
    i = ((t & ~(st - 1)) << 1) | (t & (st - 1))
    return i, i + st


def flush_one(lst, buf, c, cmax=0):
    """One query's part of ``flush_lists`` of csrc/topk.cu: bitonic-sort
    the buffer's first p entries (p = pow2 >= the largest count among the
    warp's queries, ``cmax``, at least this query's c), keep the better of
    lst[i] and buf[L - 1 - i], bitonic-merge lst; the buffer is left
    empty."""
    L = len(lst)
    p = 2
    while p < max(c, cmax):
        p <<= 1
    sz = 2
    while sz <= p:
        st = sz >> 1
        while st:
            for t in range(p >> 1):
                i, j = pair_of(t, st)
                if better(buf[j], buf[i]) == ((i & sz) == 0):
                    buf[i], buf[j] = buf[j], buf[i]
            st >>= 1
        sz <<= 1
    for i in range(L):
        j = L - 1 - i
        if j < p and better(buf[j], lst[i]):
            lst[i] = buf[j]
    st = L >> 1
    while st:
        for t in range(L >> 1):
            i, j = pair_of(t, st)
            if better(lst[j], lst[i]):
                lst[i], lst[j] = lst[j], lst[i]
        st >>= 1
    for i in range(p):
        buf[i] = EMPTY


def offer(lst, buf, cands, kr, rng):
    """Offer (score, row) candidates in a random order, as threads race for
    buffer slots: those that beat the k-th entry take a slot; when the
    buffer is full the rest wait for a flush and are offered again."""
    cb = len(buf)
    cnt = 0
    pending = [cands[i] for i in rng.permutation(len(cands))]
    while pending:
        thr = lst[kr - 1]
        waiting = []
        for cand in pending:
            if not better(cand, thr):
                continue
            if cnt < cb:
                buf[cnt] = cand
                cnt += 1
            else:
                waiting.append(cand)
        pending = waiting
        if pending:  # a buffer overflowed: the block flushes
            flush_one(lst, buf, cnt)
            cnt = 0
    return cnt


def partial_block(scores, bias, r_begin, r_end, kr, floor, rng):
    """One query's ``topk_partial`` over rows [r_begin, r_end): its sorted
    list of kr entries."""
    lst = [EMPTY] * list_width(kr)
    buf = [EMPTY] * BUFFER_SLOTS
    cnt = 0
    for r0 in range(r_begin, r_end, topk.TILE_ROWS):
        rows = range(r0, min(r0 + topk.TILE_ROWS, r_end))
        score = {r: float(np.float32(scores[r]) + np.float32(bias[r]))
                 for r in rows}
        seeded = set()
        if r0 == r_begin and kr <= 32:
            # each of the 32 threads (rows r0 + rg + 32 i) gives its best
            # admitted entry; a flush makes their k-th best the threshold
            for rg in range(32):
                own = [(score[r], r) for r in rows[rg::32]
                       if admit(score[r], r, floor)]
                buf[rg] = min(own, key=lambda e: (-e[0], e[1]),
                              default=EMPTY)
                seeded.add(buf[rg][1])
            flush_one(lst, buf, 32)
        thr = lst[kr - 1]  # read once per tile
        cands = []
        for r in rows:
            s = score[r]
            if r not in seeded and better((s, r), thr) and admit(s, r,
                                                                 floor):
                cands.append((s, r))
        # threads race for the slots; those left over wait for a flush,
        # which refreshes the threshold
        cands = [cands[i] for i in rng.permutation(len(cands))]
        fits = cands[:len(buf) - cnt]
        for cand in fits:
            buf[cnt] = cand
            cnt += 1
        rest = cands[len(fits):]
        if rest or 2 * cnt >= len(buf):  # overflowed or half full
            flush_one(lst, buf, cnt, int(rng.integers(0, len(buf) + 1)))
            cnt = offer(lst, buf, rest, kr, rng)
    flush_one(lst, buf, cnt)
    return lst[:kr]


def merge_block(partials, kr):
    """``topk_merge`` for one query: the partials (n_chunks lists of kr,
    sorted) read rank by rank, rank 0 alone and then ``max(1, 256 //
    n_chunks)`` whole ranks a read, in runs of 256 entries; a flush on overflow and, while the list is
    not full, after every run; a stop after the first read none of whose
    entries beats the threshold. Returns (entries, ranks read)."""
    nc = len(partials)
    flat = [partials[c][x] for x in range(kr) for c in range(nc)]
    lst = [EMPTY] * list_width(kr)
    buf = [EMPTY] * MERGE_BUF
    cnt = 0
    per = max(1, 256 // nc)
    ranks = 0
    starts = [0] + list(range(1, kr, per))  # rank 0 alone, then per ranks
    for x0 in starts:
        end = min(kr, x0 + per if x0 else 1) * nc
        ranks = end // nc
        beat = False
        for e0 in range(x0 * nc, end, 256):
            thr = lst[kr - 1]
            pending = []
            for e in flat[e0:min(end, e0 + 256)]:
                if e[0] > float("-inf") and better(e, thr):
                    beat = True
                    if cnt < MERGE_BUF:
                        buf[cnt] = e
                        cnt += 1
                    else:
                        pending.append(e)
            flush = bool(pending) or (cnt > 0 and lst[kr - 1][1] == NONE)
            while flush:
                flush_one(lst, buf, cnt)
                cnt = 0
                thr = lst[kr - 1]
                waiting = []
                for e in pending:
                    if not better(e, thr):
                        continue
                    if cnt < MERGE_BUF:
                        buf[cnt] = e
                        cnt += 1
                    else:
                        waiting.append(e)
                pending = waiting
                flush = bool(pending)
        if not beat:
            break
    flush_one(lst, buf, cnt)
    return lst[:kr], ranks


def model_topk(q, table, k, valid, resident, seed=0):
    """The kernel pair's result, round by round, as ``topk_cuda`` plans it.
    Returns (vals, idx, plan, ranks read per merge)."""
    scores = (q.float() @ table.float().T).numpy()
    n = table.shape[0]
    bias = np.where(valid.numpy(), 0.0, -np.inf).astype(np.float32)
    nq = q.shape[0]
    rounds = topk.plan(n, nq, k, resident)
    vals = np.full((nq, k), -np.inf, np.float32)
    idx = np.full((nq, k), -1, np.int32)
    rng = np.random.default_rng(seed)
    ranks = []
    for c0, kr, n_chunks, rows in rounds:
        for a in range(nq):
            floor = ((float(vals[a, c0 - 1]), int(idx[a, c0 - 1])) if c0
                     else (float("inf"), NO_FLOOR))
            parts = [partial_block(scores[a], bias, ch * rows,
                                   min(n, ch * rows + rows), kr, floor, rng)
                     for ch in range(n_chunks)]
            out, nr = merge_block(parts, kr)
            ranks.append(nr)
            for x, (v, i) in enumerate(out):
                filled = v > float("-inf")
                vals[a, c0 + x] = v if filled else -np.inf
                idx[a, c0 + x] = i if filled else -1
    return vals, idx, rounds, ranks


def _topk_case(nq, n, d, seed, dup=0, live=0.8):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    table = rng.normal(size=(n, d)).astype(np.float32)
    if dup:  # exact ties: repeated rows
        src = rng.integers(0, n, dup)
        dst = rng.integers(0, n, dup)
        table[dst] = table[src]
    valid = rng.random(n) < live
    return torch.from_numpy(q), torch.from_numpy(table), torch.from_numpy(
        valid)


@pytest.mark.parametrize("k", [1, 11, 32, 33, 100, 128, 129, 300])
def test_topk_selection_model_matches_ref(k):
    # rows not a multiple of the tile; 3 blocks resident: several tiles per
    # block, so thresholds carry over tiles and buffers overflow
    q, table, valid = _topk_case(3, 1500, 8, seed=k)
    vals, idx, rounds, _ = model_topk(q, table, k, valid, lambda kr: 3)
    assert len(rounds) == -(-k // topk.ROUND_K)
    assert all(ch > 1 for _, _, ch, _ in rounds)
    want_v, want_i = ref.topk_ref(q, table, k, valid=valid)
    np.testing.assert_array_equal(idx, want_i.numpy())
    np.testing.assert_array_equal(vals, want_v.numpy())


@pytest.mark.parametrize("k,resident", [(5, 8), (40, 2), (130, 5)])
def test_topk_selection_model_with_repeated_rows(k, resident):
    """Repeated rows score exactly alike: the lower index must come first,
    across tiles, blocks and rounds."""
    q, table, valid = _topk_case(2, 1100, 4, seed=k, dup=400)
    vals, idx, _, _ = model_topk(q, table, k, valid, lambda kr: resident,
                                 seed=k)
    want_v, want_i = ref.topk_ref(q, table, k, valid=valid)
    np.testing.assert_array_equal(idx, want_i.numpy())
    np.testing.assert_array_equal(vals, want_v.numpy())


@pytest.mark.parametrize("n,live,k", [(5, 0.6, 11), (1, 1.0, 3),
                                      (300, 0.05, 40), (200, 0.0, 7),
                                      (140, 0.9, 200)])
def test_topk_selection_model_pads_with_few_live_rows(n, live, k):
    """N < k, few live rows and none at all: -inf / -1 past the live rows,
    also in the rounds after the first."""
    q, table, valid = _topk_case(2, n, 6, seed=n, live=live)
    vals, idx, _, _ = model_topk(q, table, k, valid, lambda kr: 4)
    want_v, want_i = ref.topk_ref(q, table, k, valid=valid)
    np.testing.assert_array_equal(idx, want_i.numpy())
    np.testing.assert_array_equal(vals, want_v.numpy())


def test_topk_merge_stops_early():
    """The merge reads only the ranks it needs: with many partials, the
    top-k lies in their first few entries."""
    q, table, valid = _topk_case(2, 40000, 4, seed=9, live=1.0)
    _, idx, rounds, ranks = model_topk(q, table, 20, valid,
                                       lambda kr: 150)
    assert rounds[0][2] == 79 and max(ranks) < 20  # 1, then 3 ranks a read
    np.testing.assert_array_equal(
        idx, ref.topk_ref(q, table, 20, valid=valid)[1].numpy())


@pytest.mark.parametrize("c", [1, 2, 3, 17, 32, 33, 64, 128])
@pytest.mark.parametrize("L", [1, 2, 16, 128])
def test_bitonic_flush_keeps_the_best(L, c):
    """Whatever the sort width (set by the fullest buffer of the warp)."""
    rng = np.random.default_rng(L * 100 + c)
    cb = BUFFER_SLOTS
    vals = rng.integers(0, 6, L + c).astype(np.float32)  # many ties
    ids = rng.permutation(10 * (L + c))[:L + c]
    ent = [(float(v), int(i)) for v, i in zip(vals, ids)]
    n_list = int(rng.integers(0, L + 1))  # a list not yet full
    lst = sorted(ent[:n_list], key=lambda e: (-e[0], e[1])) + \
        [EMPTY] * (L - n_list)
    buf = ent[L:L + c] + [EMPTY] * (cb - c)
    flush_one(lst, buf, c, int(rng.integers(0, cb + 1)))
    want = sorted(ent[:n_list] + ent[L:L + c],
                  key=lambda e: (-e[0], e[1]))[:L]
    assert lst[:len(want)] == want
    assert all(e == EMPTY for e in lst[len(want):] + buf)


@pytest.mark.parametrize("n,nq,k,resident", [
    (1, 1, 1, 264), (37701, 64, 11, 264), (1 << 21, 64, 100, 132),
    (1 << 21, 64, 11, 264), (1 << 21, 64, 300, 132), (5000, 200, 129, 132),
    (0, 3, 5, 264), (300, 1, 70, 1),
])
def test_topk_plan_covers_the_table(n, nq, k, resident):
    rounds = topk.plan(n, nq, k, lambda kr: resident)
    assert [c0 for c0, *_ in rounds] == list(range(0, k, topk.ROUND_K))
    assert sum(kr for _, kr, _, _ in rounds) == k
    q_blocks = -(-nq // topk.QUERY_BLOCK)
    for _, kr, chunks, rows in rounds:
        assert 1 <= kr <= topk.ROUND_K and rows % topk.TILE_ROWS == 0
        assert chunks * rows >= n and (chunks - 1) * rows < max(n, 1)
        assert chunks * q_blocks <= max(resident, q_blocks)


# -------------------------------------------------------------- h-index ----


def h_index_hist(values, valid, est):
    """The kernel's formulation: per row hi = min(max(est, 0), W, valid
    count); a histogram of the valid values >= 1, each clamped to hi, in
    hi + 1 bins; then the warp's scan from hi down, 32 bins a step (lane l
    takes bin top - l; an inclusive prefix over lanes plus the carry of the
    steps above is count(>= h)), stopping at the first h with
    count(>= h) >= h."""
    r, w = values.shape
    out = torch.zeros(r, dtype=torch.int32)
    nvalid = valid.sum(1)
    for row in range(r):
        hi = min(max(int(est[row]), 0), w, int(nvalid[row]))
        if hi <= 0:
            continue
        v = values[row][valid[row]].long()
        v = v[v >= 1].clamp_max(hi)
        bins = torch.bincount(v, minlength=hi + 1)
        carry, top = 0, hi
        while top >= 1:
            h = top - torch.arange(32)
            b = torch.where(h >= 1, bins[h.clamp_min(0)], 0)
            cum = carry + torch.cumsum(b, 0)
            ok = (cum >= h) & (h >= 1)
            if bool(ok.any()):
                out[row] = int(h[int(ok.nonzero()[0])])
                break
            carry += int(b.sum())
            top -= 32
    return out


def h_index_ballot(values, valid, est):
    """The narrow rows' search (W <= 32, a thread per row): the row's
    valid values; hi = min(est, W, valid count); a binary search whose
    probe counts the values >= mid."""
    vals = torch.where(valid, values, -1)
    out = torch.zeros(values.shape[0], dtype=torch.int32)
    for row in range(values.shape[0]):
        lo = 0
        hi = min(max(int(est[row]), 0), values.shape[1],
                 int(valid[row].sum()))
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            if int((vals[row] >= mid).sum()) >= mid:
                lo = mid
            else:
                hi = mid - 1
        out[row] = lo
    return out


def _h_case(r, w, seed, packed):
    rng = np.random.default_rng(seed)
    vmax = max(4, min(w, 300))
    vals = rng.integers(0, vmax + 8, (r, w)).astype(np.int32)
    if packed:  # left-packed rows, as the ELL tiers give them
        deg = rng.integers(0, w + 1, r)
        valid = np.arange(w)[None, :] < deg[:, None]
    else:  # scattered slots
        valid = rng.random((r, w)) < rng.random((r, 1))
    est = rng.integers(0, vmax + 10, r).astype(np.int32)
    est[0] = 0  # est = 0 (a padded row)
    est[1 % r] = w + 50  # est above W
    valid[2 % r] = False  # no valid entry
    vals[3 % r] = vmax + 100  # values above est
    return vals, valid, est


@pytest.mark.parametrize("w", [1, 7, 32, 33, 2048, 2049])
@pytest.mark.parametrize("packed", [True, False])
def test_h_index_histogram_matches_ref_and_jax(w, packed):
    r = 40 if w > 64 else 200
    vals, valid, est = _h_case(r, w, seed=w * 2 + packed, packed=packed)
    tv, tm, te = (torch.from_numpy(a) for a in (vals, valid, est))
    want = ref.h_index_ref(tv, tm, te)
    jax_count = np.asarray(jops.h_index_sweep(
        jnp.asarray(vals), jnp.asarray(valid), jnp.asarray(est),
        impl="count"))
    np.testing.assert_array_equal(want.numpy(), jax_count)
    assert torch.equal(h_index_hist(tv, tm, te), want)
    if w <= 32:
        assert torch.equal(h_index_ballot(tv, tm, te), want)


HUB_BINS = 1024  # csrc/hindex.cu kHubBins
HUB_WARPS = 16  # kHubThreads / 32


def h_index_hub(values, valid, est, bins=HUB_BINS, warps=HUB_WARPS):
    """The hub rows' search (W > the wide kernel's width): per row hi =
    min(max(est, 0), W) and the range [lo, up] = [0, hi] with above =
    count(>= up + 1) = 0. A level counts the valid values, clamped to hi,
    that lie in [max(lo, 1), up] into ``bins`` bins of width the least
    power of two with bins x width >= up - lo + 1; each of ``warps`` warps
    scans its range of
    bins from the top, 32 a step (lane l on bin top - l, an inclusive
    prefix plus the carry of the warps and steps above is count(>= lo + b
    width)), and reports the first bin b with count >= lo + b width (bin 0
    always holds); the highest report j narrows the range to [lo + j width,
    min(up, lo + (j + 1) width - 1)], with above = the count past bin j. A
    level of width 1 ends it: the answer is lo + j."""
    r, w = values.shape
    out = torch.zeros(r, dtype=torch.int32)
    per_warp = bins // warps
    for row in range(r):
        hi = min(max(int(est[row]), 0), w)
        if hi <= 0:
            continue
        x = values[row][valid[row]].long().clamp_max(hi)
        lo, up, above = 0, hi, 0
        while True:
            width = 1
            while bins * width < up - lo + 1:
                width *= 2
            sel = x[(x >= max(lo, 1)) & (x <= up)]
            hist = torch.bincount((sel - lo) // width, minlength=bins)
            totals = hist.view(warps, per_warp).sum(1)
            reports = []
            for u in range(warps):
                carry = above + int(totals[u + 1:].sum())
                for top in range(u * per_warp + per_warp - 1, u * per_warp,
                                 -32):
                    b = top - torch.arange(32)
                    cum = carry + torch.cumsum(hist[b], 0)
                    h = lo + b * width
                    ok = (h <= up) & ((b == 0) | (cum >= h))
                    if bool(ok.any()):
                        l_ = int(ok.nonzero()[0])
                        reports.append((int(b[l_]),
                                        int(cum[l_] - hist[b[l_]])))
                        break
                    carry = int(cum[-1])
            j, past = max(reports)
            if width == 1:
                lo += j
                break
            up = min(up, lo + (j + 1) * width - 1)
            lo, above = lo + j * width, past
        out[row] = lo
    return out


@pytest.mark.parametrize("bins", [HUB_BINS, 64, 32])
def test_h_index_hub_search_matches_ref_and_jax(bins):
    """The hub search at W = 65,536 (the serving repair's width for a
    degree above 32,768), exact against ``h_index_ref`` and the JAX
    package's ``h_index_count``: two levels at the kernel's 1,024 bins,
    three at 64 and four at 32 (so a level's range and carried count are
    exercised past the first narrowing). Rows: est 0, est above W, no valid
    slot, values above est, a small est, and dense and sparse rows."""
    w, r = 65536, 8
    rng = np.random.default_rng(bins)
    vals = rng.integers(0, 40000, (r, w)).astype(np.int32)
    valid = rng.random((r, w)) < np.array([0.5, 0.9, 0.5, 0.5, 0.3, 0.02,
                                           0.7, 1.0])[:, None]
    est = rng.integers(w // 2, w + 100, r).astype(np.int32)
    est[0], est[1], est[4] = 0, w + 50, 9
    valid[2] = False
    vals[3] = w + 100
    tv, tm, te = (torch.from_numpy(a) for a in (vals, valid, est))
    want = ref.h_index_ref(tv, tm, te)
    jax_count = np.asarray(jops.h_index_sweep(
        jnp.asarray(vals), jnp.asarray(valid), jnp.asarray(est),
        impl="count"))
    np.testing.assert_array_equal(want.numpy(), jax_count)
    assert torch.equal(h_index_hub(tv, tm, te, bins=bins,
                                   warps=min(HUB_WARPS, bins // 32)), want)
    assert int(want[3]) > 30000 and int(want[4]) == 9
