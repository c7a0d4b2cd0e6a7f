#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and ``nvcc``; it imports nothing of JAX or of the
JAX package. Phases, each unguarded (any failure exits non-zero):

1. environment: the card's name and power limit, torch/CUDA versions, and
   the build of every kernel from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all started together) with its time;
2. the serving path: ``build_service`` on ``github-like`` at dim 128 on the
   card, ``stream_with_churn`` in blocks of 1024 with 10% churn, the
   incremental cores checked against the peeling oracle (0 mismatches),
   then embed, link-score and top-10 traffic. Every kernel's launch count
   is set to 0 just before and read just after; each must be > 0 (the
   top-k counts both of its kernels, ``topk_partial`` and ``topk_merge``:
   two launches per pass of up to 128 entries, each also counted on its
   own; the h-index counts its narrow and wide kernels on their own too).
   While this phase runs, a counting wrapper bound into
   ``ops.h_index_sweep`` tallies the (R, W) of every h-index launch; the
   5 most frequent shapes are printed with their counts and timed on the
   first call's inputs at each;
3. a small reference: the same path on a 300-node graph on the card and on
   the CPU (plain versions), cores equal after every block, embeddings and
   link scores within 1e-5, top-10 and top-40 ids (one pass of the top-k
   kernels each) equal off near-ties; then the serving repair with a hub
   (``generators.hub_with_cliques``: a node of degree 34,360, so its row of
   the descent is W = 65,536): 2,000 inner edges streamed in blocks of 250
   with 10% churn through ``DynamicGraph`` + ``IncrementalCore`` on the
   card, the repair pinned to the window descent, the counts set to 0
   before and read after (the fourth path, "hub"): 0 core mismatches
   against the peeling oracle after every block, hub-kernel launches > 0,
   no re-peel;
4. kernel parity and timing: each kernel against its plain PyTorch version
   on the same inputs, at the shapes the serving path gave it (taken from
   the live service; the h-index's two tiers also each on its own) and at
   one large shape (the top-k there at k = 11, 100 and 300: one pass, one
   and three, so the multi-pass path runs on the card; the h-index's hub
   kernel at R=64 W=65,536 and W = ``max_width()`` + 1, with est 0 rows and
   a row with no valid slot), with kernel,
   plain and library
   device times (``time_ms``: the calls queued behind a spin kernel, CUDA
   events around them, so the host's launch path is left out; the kernel
   timed through its own wrapper alone), the kernel's CUDA-event time over
   a loop of calls (``loop_ms``) and the bound (bytes over 3.35 TB/s or
   operations over 67 TFLOP/s, the H100 SXM's published peaks);
5. the offline path: the port's quick github table
   (``repro_torch.launch.tables``, seed 0: DeepWalk, the 13-core (Dw) row on
   the ``torch`` propagation backend, CoreWalk) at dim 150, batch 8192, with
   every count set to 0 before each row and read after it. Per row: no NaN,
   ``n_walks_run`` and ``n_sgns_steps`` equal to the JAX package's (CPU run,
   recorded in ``PERF.md``), F1 within 3 points of the JAX package's, one
   forward and one backward SGNS launch per step, and in the k-core row ELL
   mean launches and a torch propagation within 1e-4 of the scipy one
   (then the ELL mean at two of that row's propagation calls, see below);
6. the SGNS kernels against their plain versions at the training shape
   (B=8192 K=5 D=150 fp32, 1e-5), one large shape (B=65536 K=5 D=256
   bf16, 2e-2) and K = 2,048 negatives (B=64 D=150 fp32: 1e-5 against
   the same formulas in fp64, and 1e-5 x max(1, max|plain|) against the
   plain versions, whose fp32 sums of 2,048 terms drift), timed on inputs
   rotated through more than twice the L2;
7. where a training step's time goes: ``torch.profiler`` over 100 SGNS
   steps on the CoreWalk corpus at the table's settings, device time by
   kernel and the device's busy share of the window (reported, not held to
   a limit);
8. LM serving: ``repro_torch.launch.serve`` at qwen3-4b's full width (36
   layers, d_model 2560, 32/8 heads, vocabulary 151,936, bf16; weights from
   its ``init_model`` with a seeded generator on the card), 12 requests in 8
   slots, prompts of 1024, 64 new tokens each: 128 decode steps, four rows
   swapped in at step 64 while the other four run past their cache's end.
   Held: 1,024 tokens decoded, exactly 36 x 128 flash-decode launches, no
   NaN or inf in any logits, every token in [0, vocab), the swapped rows'
   cache holding their prefill. Printed: prefill and swap times, decode
   tokens/s and ms per step, peak memory;
9. decode parity at full width: one step from the live cache (ragged
   lengths, four rows past the end) with the kernel and with the plain
   version bound into ``models.attention`` for that call: caches equal bit
   for bit but for the rows written in layers 1 and up, which with the
   logits agree within 5e-2 x their largest magnitude; the greedy tokens'
   agreement over 8 teacher-forced steps (reported); ``torch.profiler``
   over 20 decode steps (device time by kernel class, launches per step, busy
   share; reported);
10. a small LM reference: reduced qwen3-4b (fp32, G = 4) served on the card
   and on the CPU with the same weights and schedule: token streams equal,
   logits within 1e-4;
11. flash-decode against its plain version (``TOL_DECODE``: 2e-5 with fp32
   queries; rtol 1e-2 + atol 1e-3 with bf16 queries, bf16 or int8 cache)
   at the live serving inputs (layers 0 and 35 of one step, timed rotating
   through six layers) and at a gemma2-2b shape (softcap 50, window 4096),
   a large ragged bf16 shape and the same with an int8 cache, with the
   library time (one SDPA call, softcap 0 and no int8 only), the bound from
   the visible rows and the number of splits of S the launch used.

Every kernel record also holds ``x_bound`` (kernel / bound) and
``x_library`` (kernel / library, where there is a library call). Every
kernel is also held to give the same bits on a second call (all are
deterministic by design); the ELL mean is timed as well at two of
the offline k-core row's propagation calls (one shell's rows against the
table: the largest shell, and the largest that takes the row-split path)
and records which of its two paths each shape takes.

The line before the last is the ``nvidia-smi`` name and power limit; before
it, one JSON object with a record per kernel (``launches`` summed over the
serving, the hub, the offline and the LM path, each path's count beside
it; the h-index's hub kernel also as a record of its own, ``h_index_hub``);
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_FP32 = 67e12  # H100 SXM fp32 outside the tensor cores, operations/s
TOL_ELL = 1e-5
TOL_TOPK = 1e-5
TIE = 1e-6
STREAM_FRAC = 0.15  # the launcher's default: 42,303 streamed edges
TOL_SGNS = {"float32": 1e-5, "bfloat16": 2e-2}
L2_BYTES = 50e6  # H100 L2 cache
SPIN_HZ = 2.0e9  # cycles a second to size the spin kernel by (above the
# H100's clock, so that the spin lasts at least as long as asked)
# The JAX package's quick github table on the CPU, seed 0
# (``benchmarks.table_github.run(quick=True)``; PERF.md): F1 (a quality
# figure), walks and SGNS steps. Walks and steps depend only on the split
# and the cores, so they must match exactly; F1 within F1_BAND points, the
# walks and samples being another generator's.
JAX_GITHUB_QUICK = {
    "DeepWalk": (80.5409, 565500, 2070),
    "13-core (Dw)": (55.7147, 89940, 329),
    "CoreWalk": (72.5893, 124018, 454),
}
F1_BAND = 3.0
# LM serving at qwen3-4b's full width: 12 requests in 8 slots, 64 new tokens
# each, so 64 steps, a swap of four rows, and 64 more steps while the other
# four rows run past their cache's end (1088 positions)
LM_FLAGS = ["--arch", "qwen3-4b", "--preset", "full", "--slots", "8",
            "--requests", "12", "--prompt-len", "1024", "--max-new", "64",
            "--seed", "0", "--device", "cuda"]
LM_SHAPE = (36, 2560, 32, 8, 128, 9728, 151936, "bfloat16")  # qwen3-4b
LM_DECODED = 8 * 128
LM_LAUNCHES = 36 * 128  # one flash-decode launch per layer per step
SNAP_STEP = 64  # the step after the swap: the cache the parity phases take
LM_LOGIT_TOL = 5e-2  # x max|logit|: bf16 rounding of the attention output
LM_LAYERS = (0, 7, 14, 21, 28, 35)  # 6 x 35.6 MB of K/V > twice the L2
# flash-decode against its plain version, (rtol, atol) by the queries' type.
# Both accumulate in fp32 and round once to q's type, so in bf16 they differ
# by at most one ulp (< 2**-7 x |out|, < 7.8e-4 below 0.1), well under 1e-2
# x |out| + 1e-3; outputs at the smoke's shapes are about 0.03-0.05 (mean of
# ~1,000-4,000 unit values), so a fixed 3e-2 would pass a wrong kernel
TOL_DECODE = {"float32": (2e-5, 2e-5), "bfloat16": (1e-2, 1e-3)}
TOL_SDPA = 3e-2  # SDPA against the plain version: it rounds P to bf16
# flash-decode at made-up shapes, bf16: (label, B, H, Hkv, Dh, S, softcap,
# window, int8 cache); the last is the one before it with an int8 cache
DECODE_SHAPES = [
    ("gemma2-2b shape", 8, 8, 4, 256, 8192, 50.0, 4096, False),
    ("large", 32, 32, 8, 128, 8192, 0.0, 0, False),
    ("large int8", 32, 32, 8, 128, 8192, 0.0, 0, True),
]

SOURCES = {
    "ell_mean": ("src/repro_torch/csrc/ellmean.cu",
                 "src/repro/kernels/ellmean.py:79"),
    "h_index": ("src/repro_torch/csrc/hindex.cu",
                "src/repro/kernels/hindex.py:88"),
    "h_index_hub": ("src/repro_torch/csrc/hindex.cu",
                    "src/repro/kernels/hindex.py:88"),
    "top_k": ("src/repro_torch/csrc/topk.cu",
              "src/repro/kernels/topk.py:117"),
    "sgns_fwd": ("src/repro_torch/csrc/sgns.cu",
                 "src/repro/kernels/sgns.py:66"),
    "sgns_bwd": ("src/repro_torch/csrc/sgns.cu",
                 "src/repro/kernels/sgns.py:86"),
    "decode_attention": ("src/repro_torch/csrc/flash_decode.cu",
                         "src/repro/kernels/flash_decode.py:134"),
}
SERVING = ("ell_mean", "h_index", "top_k")  # the kernels serving runs
# the serving repair with a hub: 34,000 leaves (and 2,000 random edges
# among them) and 12 cliques of 30, all joined to the hub; 2,000 of the
# inner edges streamed in blocks of 250 with 10% churn
HUB_GRAPH = (34000, 12, 30, 2000)
HUB_STREAM, HUB_BLOCK, HUB_CHURN = 2000, 250, 0.1


def log(msg: str) -> None:
    print(f"[chip-smoke] {msg}", flush=True)


class SmokeFailure(RuntimeError):
    pass


def expect(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


class Counters:
    """The wrappers' launch counts by kernel name: ``reset`` sets every one
    to 0, ``read`` returns them."""

    def __init__(self, table):
        self.table = table  # name -> (module, attribute)

    def reset(self) -> None:
        for mod, attr in self.table.values():
            setattr(mod, attr, 0)

    def read(self) -> dict:
        return {name: getattr(mod, attr)
                for name, (mod, attr) in self.table.items()}


class SweepTally:
    """While bound (``with``), counts the (R, W) of every h-index sweep
    through ``ops.h_index_sweep`` (the repair's and the k-core's entry) and
    keeps a copy of the first call's inputs at each shape; every call goes
    on to the kernel as before."""

    def __init__(self, ops):
        self.ops = ops
        self.counts = {}
        self.first = {}

    def __enter__(self):
        self.orig = self.ops.h_index_sweep
        self.ops.h_index_sweep = self
        return self

    def __exit__(self, *exc):
        self.ops.h_index_sweep = self.orig

    def __call__(self, values, valid, est, **kw):
        key = tuple(values.shape)
        if key[0]:  # the wrapper launches nothing for no rows
            self.counts[key] = self.counts.get(key, 0) + 1
            if key not in self.first:
                self.first[key] = (values.clone(), valid.clone(), est.clone())
        return self.orig(values, valid, est, **kw)

    def top(self, n):
        return sorted(self.counts.items(), key=lambda kv: -kv[1])[:n]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- timing ----


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device ms per call with the host's launch time left out: the
    ``iters`` calls are queued behind a spin kernel that outlasts the
    host's queueing, so CUDA events around them time the device alone (the
    calls' kernels and the gaps between them). A kernel of a few
    microseconds is then timed by itself and not by the Python that
    launches it. If the host still took longer than the spin (a call that
    waits on the device), the spin is lengthened and the timing repeated;
    after three tries the time is returned host time included, and the log
    says so."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    spin_s = max(2.0 * iters * (time.perf_counter() - t0), 1e-3)
    s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    for _ in range(3):
        s.record()
        torch.cuda._sleep(int(spin_s * SPIN_HZ))
        a.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        queued_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        b.synchronize()
        if queued_ms < s.elapsed_time(a):
            return a.elapsed_time(b) / iters
        spin_s *= 4
    log(f"time_ms: the host took {queued_ms:.3f} ms to queue {iters} calls, "
        "longer than the spin; this time includes host time")
    return a.elapsed_time(b) / iters


def loop_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call from CUDA events around ``iters`` calls: the device
    time where the device is the limit, the host's launch rate where the
    host is."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def bound(bytes_: float, ops: float):
    tb, to = bytes_ / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def ratios(rec: dict) -> dict:
    """Add kernel / bound and kernel / library (None without a library
    call) to a kernel record."""
    rec["x_bound"] = rec["ms"] / rec["bound_ms"]
    lib = rec.get("library_ms")
    rec["x_library"] = rec["ms"] / lib if lib else None
    return rec


# ------------------------------------------------------------ parity ----


def check_ell(torch, ops, ref, F, idx, valid, emb, label, iters=20):
    from repro_torch.kernels import ellmean

    got = ops.ell_mean(idx, valid, emb, impl="cuda")
    want = ref.ell_mean_ref(idx, valid, emb)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0
    expect(torch.allclose(got.float(), want.float(), rtol=TOL_ELL,
                          atol=TOL_ELL),
           f"ell_mean {label}: max abs err {err}")
    expect(torch.equal(ops.ell_mean(idx, valid, emb, impl="cuda"), got),
           f"ell_mean {label}: a second call gave other bits")
    flat = idx[valid].long()
    offsets = torch.zeros(idx.shape[0], dtype=torch.long, device=idx.device)
    offsets[1:] = torch.cumsum(valid.sum(1), 0)[:-1]
    lib_out = F.embedding_bag(flat, emb, offsets, mode="mean")
    expect(torch.allclose(lib_out, want.float(), rtol=1e-4, atol=1e-4),
           f"ell_mean {label}: embedding_bag disagrees with the plain version")
    n, l = idx.shape
    d = emb.shape[1]
    cnt = int(valid.sum())
    b_ms, b_by = bound(cnt * d * emb.element_size() + n * l * 5
                       + n * d * emb.element_size(), cnt * d)
    rec = {
        "shape": f"N={n} L={l} M={emb.shape[0]} D={d} valid={cnt}",
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: ops.ell_mean(idx, valid, emb,
                                                  impl="cuda"), iters),
        "loop_ms": loop_ms(torch, lambda: ops.ell_mean(idx, valid, emb,
                                                       impl="cuda"), iters),
        "plain_ms": time_ms(torch, lambda: ref.ell_mean_ref(idx, valid, emb),
                            max(iters // 4, 3)),
        "library_ms": time_ms(torch, lambda: F.embedding_bag(
            flat, emb, offsets, mode="mean"), iters),
        "bound_ms": b_ms, "bound_by": b_by,
        "path": "row-split" if ellmean.row_split(n, l, emb.device)
                else "warp-per-row",
    }
    ratios(rec)
    log(f"ell_mean {label}: {rec}")
    return rec


def probes_of(torch, values, valid, est):
    """Σ over the probes of each row's search of the row's valid entries:
    the compares the sort-free search needs on these inputs (a row whose
    estimate is 0 needs none)."""
    vals = torch.where(valid, values, -1)
    deg = valid.sum(1)
    w = vals.shape[1]
    lo = torch.zeros_like(est)
    hi = est.clamp_min(0).clamp_max(w)
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


def check_hindex(torch, ops, ref, tiers, label, iters=20):
    """``tiers``: list of (values, valid, est) swept together (one sweep of
    a two-tier descent is two launches); the record covers all of them,
    and with more than one tier holds each tier's own under "tiers"."""
    errs = 0
    for values, valid, est in tiers:
        got = ops.h_index_sweep(values, valid, est, impl="cuda")
        want = ref.h_index_ref(values, valid, est)
        cnt = ops.h_index_sweep(values, valid, est, impl="count")
        torch.cuda.synchronize()
        errs += int((got != want).sum())
        expect(torch.equal(cnt, want), f"h_index {label}: count != ref")
        expect(torch.equal(ops.h_index_sweep(values, valid, est,
                                             impl="cuda"), got),
               f"h_index {label}: a second call gave other bits")
    expect(errs == 0, f"h_index {label}: {errs} rows differ from the ref")

    def run(impl):
        def f():
            for values, valid, est in tiers:
                ops.h_index_sweep(values, valid, est, impl=impl)
        return f

    # the valid entries (int32 value + mask byte) of rows with est > 0, the
    # only rows whose search reads anything, plus est and out of every row:
    # the padded rows of the serving shapes (est 0) cost 8 bytes each
    nbytes = sum(int(m[e > 0].sum()) * 5 + v.shape[0] * 8
                 for v, m, e in tiers)
    nops = sum(probes_of(torch, v, m, e) for v, m, e in tiers)
    b_ms, b_by = bound(nbytes, nops)
    rec = {
        "shape": " + ".join(f"R={v.shape[0]} W={v.shape[1]}"
                            for v, _, _ in tiers),
        "max_abs_err": 0.0,
        "ms": time_ms(torch, run("cuda"), iters),
        "loop_ms": loop_ms(torch, run("cuda"), iters),
        "plain_ms": time_ms(torch, run("ref"), max(iters // 4, 3)),
        "count_ms": time_ms(torch, run("count"), max(iters // 4, 3)),
        "library_ms": None,
        "bound_ms": b_ms, "bound_by": b_by,
    }
    if len(tiers) > 1:
        rec["tiers"] = [check_hindex(torch, ops, ref, [t],
                                     f"{label}, tier {n}", iters)
                        for n, t in enumerate(tiers)]
    ratios(rec)
    log(f"h_index {label}: {rec}")
    return rec


def topk_agree(torch, ref, got_v, got_i, q, table, k, valid):
    """Scores within TOL_TOPK; ids equal except at near-ties (scores within
    TIE of a neighbour), which are compared as sets against the plain
    top-(k + 8)."""
    want_v, want_i = ref.topk_ref(q, table, k + 8, valid=valid)
    want_v, want_i = want_v.cpu(), want_i.cpu()
    got_v, got_i = got_v.cpu(), got_i.cpu()
    err = float((got_v - want_v[:, :k]).abs().nan_to_num(0.0).max())
    expect(torch.allclose(got_v, want_v[:, :k], rtol=TOL_TOPK,
                          atol=TOL_TOPK), f"top-k scores: max abs err {err}")
    n_tie = 0
    for r in range(got_i.shape[0]):
        diff = (got_i[r] != want_i[r, :k]).nonzero().flatten().tolist()
        if not diff:
            continue
        wv = want_v[r]
        for j in diff:
            near = any(abs(float(wv[j]) - float(wv[o])) <= TIE
                       for o in (j - 1, j + 1) if 0 <= o < len(wv))
            expect(near, f"top-k row {r} pos {j}: id {int(got_i[r, j])} vs "
                         f"{int(want_i[r, j])} without a near-tie")
        lo = min(float(wv[j]) for j in diff) - TIE
        hi = max(float(wv[j]) for j in diff) + TIE
        pool = set(want_i[r][(wv >= lo) & (wv <= hi)].tolist())
        expect(set(got_i[r, diff].tolist()) <= pool,
               f"top-k row {r}: near-tied ids outside the plain tie set")
        n_tie += len(diff)
    return err, n_tie


def check_topk(torch, ops, ref, q, table, valid, k, label, iters=20):
    from repro_torch.kernels import topk

    got_v, got_i = ops.top_k_scores(q, table, k, valid=valid, impl="cuda")
    err, n_tie = topk_agree(torch, ref, got_v, got_i, q, table, k, valid)
    again_v, again_i = ops.top_k_scores(q, table, k, valid=valid,
                                        impl="cuda")
    expect(torch.equal(again_v, got_v) and torch.equal(again_i, got_i),
           f"top_k {label}: a second call gave other bits")
    bias = torch.zeros(table.shape[0], device=table.device)
    bias.masked_fill_(~valid, float("-inf"))
    n, d = table.shape
    nq = q.shape[0]
    b_ms, b_by = bound(n * d * 4 + n * 4 + nq * d * 4 + nq * k * 8,
                       2.0 * nq * n * d)
    rec = {
        "shape": f"Q={nq} N={n} D={d} k={k}",
        "max_abs_err": err, "near_tie_positions": n_tie,
        "passes": -(-k // topk.ROUND_K),  # topk_partial + topk_merge each
        # the kernels alone, on the bias that ops.top_k_scores makes
        "ms": time_ms(torch, lambda: topk.topk_cuda(q, table, bias, k),
                      iters),
        "loop_ms": loop_ms(torch, lambda: topk.topk_cuda(q, table, bias, k),
                           iters),
        "plain_ms": time_ms(torch, lambda: ref.topk_ref(q, table, k,
                                                        valid=valid),
                            max(iters // 4, 3)),
        "library_ms": time_ms(torch, lambda: torch.topk(
            q @ table.T + bias, k, dim=1), iters),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    ratios(rec)
    log(f"top_k {label}: {rec}")
    return rec


def large_shapes(torch, ops, ref, F):
    """Large shapes (one per kernel, two for the h-index), from a seeded
    generator on the card; a list of records per kernel."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    table = torch.randn((1 << 21, 128), generator=gen, device=dev)
    table = ops.normalize_rows(table)
    live = torch.rand(1 << 21, generator=gen, device=dev) < 0.9
    q = ops.normalize_rows(torch.randn((64, 128), generator=gen, device=dev))
    out = {"top_k": [check_topk(torch, ops, ref, q, table, live, k,
                                f"large k={k}", iters=10)
                     for k in (11, 100, 300)]}  # one pass, one, three
    n, l = 1 << 18, 32
    idx = torch.randint(0, 1 << 21, (n, l), generator=gen, device=dev,
                        dtype=torch.int32)
    valid = torch.rand((n, l), generator=gen, device=dev) < 0.7
    out["ell_mean"] = [check_ell(torch, ops, ref, F, idx, valid, table,
                                 "large", iters=10)]
    del table, idx, valid
    tiers = []
    for r, w, vmax in ((1 << 20, 32, 64), (1 << 14, 2048, 400)):
        values = torch.randint(0, vmax, (r, w), generator=gen, device=dev,
                               dtype=torch.int32)
        deg = torch.randint(1, w + 1, (r,), generator=gen, device=dev)
        valid = torch.arange(w, device=dev)[None, :] < deg[:, None]
        est = torch.randint(0, vmax, (r,), generator=gen, device=dev,
                            dtype=torch.int32)
        tiers.append((values, valid, est))
    out["h_index"] = [
        check_hindex(torch, ops, ref, [t], f"large W={t[0].shape[1]}",
                     iters=10)
        for t in tiers
    ]
    return out


def hub_shapes(torch, ops, ref, live):
    """The h-index's hub kernel on ``live``, the hub tier of the hub
    serving phase's first sweep (R=64 W=65,536: the hub's row and 63 padded
    rows), and at R=64, W = 65,536 and W = ``max_width()`` + 1 (the
    narrowest hub row): values in [0, 40,000), left-packed rows of random
    degree, est random in [0, W + 10) but 0 on four rows, one row with no
    valid slot. Returns (the live record, the two others)."""
    from repro_torch.kernels import hindex

    gen = torch.Generator(device="cuda").manual_seed(5)
    recs = [check_hindex(torch, ops, ref, [live], "hub serving tier")]
    for w in (65536, hindex.max_width() + 1):
        r = 64
        values = torch.randint(0, 40000, (r, w), generator=gen,
                               device="cuda", dtype=torch.int32)
        deg = torch.randint(0, w + 1, (r,), generator=gen, device="cuda")
        valid = torch.arange(w, device="cuda")[None, :] < deg[:, None]
        est = torch.randint(0, w + 10, (r,), generator=gen, device="cuda",
                            dtype=torch.int32)
        est[:4] = 0
        valid[5] = False
        before = hindex.hub_launches
        recs.append(check_hindex(torch, ops, ref, [(values, valid, est)],
                                 f"hub R={r} W={w}", iters=10))
        expect(hindex.hub_launches > before,
               f"h_index W={w}: the hub kernel was not launched")
    return recs[0], recs[1:]


# ------------------------------------------------------------ serving ----


def serve_phase(torch, np, counters):
    """The serving path on the card; returns (service, launch counts)."""
    from repro_torch.graph import datasets
    from repro_torch.launch.serve_embed import build_service

    t0 = time.perf_counter()
    g = datasets.load("github-like", seed=0)
    log(f"github-like: {g.n_nodes} nodes, {g.n_edges} edges, max degree "
        f"{int(g.degrees().max())} ({time.perf_counter() - t0:.1f} s to "
        f"generate); stream_frac {STREAM_FRAC}")
    counters.reset()
    t0 = time.perf_counter()
    svc, stream, _, k0 = build_service(
        g, stream_frac=STREAM_FRAC, dim=128, batch=64, device="cuda",
    )
    log(f"build_service: {time.perf_counter() - t0:.1f} s, k0={k0}, store "
        f"{svc.store.resident}/{svc.store.capacity} rows, dim 128")
    t0 = time.perf_counter()
    n_in, n_out = svc.stream_with_churn(
        stream, block_size=1024, churn=0.1, rng=np.random.default_rng(2),
    )
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    mismatches = svc.cores.resync()
    pol = svc.cores.policy_report()
    log(f"ingest: {n_in} edges (+{n_out} retracted) in {t_ingest:.2f} s = "
        f"{(n_in + n_out) / t_ingest:.0f} edges/s, blocks of 1024, churn "
        f"0.1; {svc.stats.compactions} compactions; decisions "
        f"{pol['decisions']}; {svc.cores.descends} fused descents, "
        f"{svc.cores.sweeps} sweeps; core mismatches vs oracle: {mismatches}")
    log("repair phases: " + "  ".join(
        f"{k} {v['seconds']:.3f}s[{v['impl']}]"
        for k, v in svc.cores.phase_report().items()))
    expect(mismatches == 0, f"{mismatches} core mismatches vs the oracle")

    from repro_torch.serve import ServiceStats

    rng = np.random.default_rng(1)
    n_now = svc.graph.n_nodes
    for _ in range(2):  # untimed warmup batches
        svc.embed(rng.integers(0, n_now, size=64))
    svc.stats = ServiceStats()
    t0 = time.perf_counter()
    n_embed = 0
    for _ in range(4):
        out = svc.embed(rng.integers(0, n_now, size=64))
        expect(out.shape == (64, 128) and np.isfinite(out).all(),
               f"embed returned {out.shape} / non-finite rows")
        n_embed += 64
    pairs = rng.integers(0, n_now, size=(256, 2))
    scores = svc.link_scores(pairs)
    expect(scores.shape == (256,) and np.isfinite(scores).all()
           and np.abs(scores).max() <= 1 + 1e-5, "link scores out of range")
    t_query = time.perf_counter() - t0
    p50, p99 = svc.latency_percentiles()
    st = svc.stats
    log(f"queries: {st.queries} in {st.flushes} flushes of 64, "
        f"{st.queries / t_query:.0f} queries/s; flush p50 {p50 * 1e3:.2f} "
        f"ms p99 {p99 * 1e3:.2f} ms; cold starts {st.cold_starts}, "
        f"unresolved {st.unresolved}")
    svc.top_k_neighbors(rng.integers(0, n_now, size=64), 10)  # warmup
    svc.stats.topk_seconds.clear()
    for _ in range(4):
        nodes = rng.integers(0, n_now, size=64)
        ids, sc = svc.top_k_neighbors(nodes, 10)
        expect(ids.shape == (64, 10) and (ids >= -1).all()
               and (ids < n_now).all() and (ids != nodes[:, None]).all(),
               "top-k ids out of range or include the query")
        fin = np.where(np.isfinite(sc), sc, -2.0)
        expect((np.diff(fin, axis=1) <= 1e-6).all(), "top-k not ordered")
    t50, t99 = svc.topk_latency_percentiles()
    log(f"top-10: 256 queries over {svc.store.resident} resident rows, p50 "
        f"{t50 * 1e3:.2f} ms p99 {t99 * 1e3:.2f} ms per call of 64")
    counts = counters.read()
    log(f"kernel launches on the serving path: {counts}")
    for name in SERVING:
        expect(counts[name] > 0,
               f"kernel {name} was not launched on the serving path")
    return svc, counts


def sweep_tally(torch, ops, ref, tally, n=5):
    """The ``n`` most frequent (R, W) of the serving path's h-index
    launches, each timed on the first call's inputs at that shape; and the
    sum of launches x (time - bound) over them. Returns (tally record,
    timing records)."""
    total = sum(tally.counts.values())
    recs, weighted = [], 0.0
    for (r, w), count in tally.top(n):
        rec = check_hindex(torch, ops, ref, [tally.first[(r, w)]],
                           f"serving shape R={r} W={w} x {count}")
        rec["launches"] = count
        weighted += count * (rec["ms"] - rec["bound_ms"])
        recs.append(rec)
    covered = sum(rec["launches"] for rec in recs)
    out = {"launches": total, "shapes": len(tally.counts),
           "top": [{"R": r, "W": w, "launches": c}
                   for (r, w), c in tally.top(n)],
           "top_launches_x_excess_ms": weighted,
           "top_share_of_launches": covered / max(total, 1)}
    log(f"h_index shapes on the serving path: {out}")
    return out, recs


def lockstep(np, svcs, stream, block_size, churn, seed):
    """Drive services through the same blocks and churn, checking that
    their cores agree after every block."""
    rng = np.random.default_rng(seed)
    live = []
    for start in range(0, len(stream), block_size):
        block = stream[start:start + block_size]
        acc = [s.ingest_block(block) for s in svcs]
        expect(all(np.array_equal(acc[0], a) for a in acc),
               "accepted edges differ")
        live.extend(map(tuple, acc[0]))
        n_churn = min(int(round(churn * len(block))), len(live))
        if n_churn:
            pick = rng.choice(len(live), size=n_churn, replace=False)
            gone = set(pick.tolist())
            drop = np.array([live[i] for i in pick])
            for s in svcs:
                s.retract_block(drop)
            live = [e for i, e in enumerate(live) if i not in gone]
        cores = [s.cores.core for s in svcs]
        expect(all(np.array_equal(cores[0], c) for c in cores),
               f"cores differ after the block at {start}")


def reference_phase(torch, np):
    """The same small stream on the card and on the CPU (plain versions)."""
    from repro_torch.graph import generators
    from repro_torch.launch.serve_embed import build_service

    g = generators.barabasi_albert_varying(300, 4.0, seed=3)
    built = [build_service(g, stream_frac=0.3, dim=32, batch=16, device=d)
             for d in ("cuda", "cpu")]
    svcs = [b[0] for b in built]
    lockstep(np, svcs, built[0][1], 32, 0.1, 5)
    nodes = np.random.default_rng(7).integers(0, svcs[0].graph.n_nodes, 48)
    e_gpu, e_cpu = (s.embed(nodes) for s in svcs)
    err = float(np.abs(e_gpu - e_cpu).max())
    expect(np.allclose(e_gpu, e_cpu, rtol=1e-5, atol=1e-5),
           f"embeddings differ from the CPU path by {err}")
    pairs = np.stack([nodes, nodes[::-1]], 1)
    l_gpu, l_cpu = (s.link_scores(pairs) for s in svcs)
    expect(np.allclose(l_gpu, l_cpu, rtol=1e-5, atol=1e-5),
           "link scores differ from the CPU path")
    n_near = {}
    for k in (10, 40):  # one pass of the top-k kernels each
        # one more on the CPU, so a tie across the k-th position shows
        i_gpu, s_gpu = svcs[0].top_k_neighbors(nodes, k)
        i_cpu, s_cpu = svcs[1].top_k_neighbors(nodes, k + 1)
        expect(np.allclose(s_gpu, s_cpu[:, :k], rtol=1e-5, atol=1e-5),
               f"top-{k} scores differ from the CPU path")
        differ = i_gpu != i_cpu[:, :k]
        with np.errstate(invalid="ignore"):  # -inf padding
            gap = np.abs(np.diff(s_cpu, axis=1)) <= TIE
        near = np.zeros(s_cpu.shape, bool)
        near[:, 1:] |= gap
        near[:, :-1] |= gap
        near = near[:, :k]
        expect(not (differ & ~near).any(), f"top-{k} ids differ off near-ties")
        n_near[k] = int((differ & near).sum())
    log(f"reference: 300-node stream on cuda == cpu (cores every block, "
        f"embed max abs diff {err:.2e}, link scores, top-10 and top-40 ids; "
        f"near-tie positions that differ: {n_near})")


def hub_serve_phase(torch, np, counters):
    """The serving repair with a hub on the card (``DynamicGraph`` +
    ``IncrementalCore``, the layer ``EmbeddingService`` drives; the
    service's compaction would re-pack every row at 1.5x the hub's degree),
    pinned to the window descent: the region policy, never capped, so every
    repair sweeps the hub's row of W = 65,536. Returns (the launch counts,
    the first sweep's hub tier: values, valid, est)."""
    from repro_torch.core.kcore import core_numbers_host
    from repro_torch.graph import generators
    from repro_torch.kernels import hindex, ops
    from repro_torch.serve import DynamicGraph, IncrementalCore

    t0 = time.perf_counter()
    g, inner = generators.hub_with_cliques(*HUB_GRAPH, seed=0)
    stream = inner[:HUB_STREAM]
    streamed = set(map(tuple, stream.tolist()))
    edges = g.edge_list()
    base = edges[[tuple(e) not in streamed for e in edges.tolist()]]
    dyn = DynamicGraph(g.n_nodes, base, width=16, device="cuda")
    inc = IncrementalCore(dyn, repair_policy="region", repeel_frac=1.0,
                          descend_budget=1 << 62)
    hub_deg = int(dyn.degrees()[0])
    expect(hub_deg > 32768, f"hub degree {hub_deg}")
    t_build = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    live, mismatches, n_out = [], 0, 0
    counters.reset()
    t0 = time.perf_counter()
    with SweepTally(ops) as tally:
        for start in range(0, len(stream), HUB_BLOCK):
            acc = dyn.add_edges(stream[start:start + HUB_BLOCK])
            inc.on_edge_block(acc)
            live.extend(map(tuple, acc))
            pick = rng.choice(len(live), size=int(HUB_CHURN * HUB_BLOCK),
                              replace=False)
            gone = dyn.remove_edges(np.array([live[i] for i in pick]))
            inc.on_remove(gone)
            n_out += len(gone)
            drop = set(pick.tolist())
            live = [e for i, e in enumerate(live) if i not in drop]
            mismatches += int((inc.core != core_numbers_host(
                dyn.snapshot())).sum())
        torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    counts = counters.read()
    hub_keys = [k for k in tally.counts if k[1] > hindex.max_width()]
    log(f"hub serving: {g.n_nodes} nodes, hub degree {hub_deg} ({t_build:.1f}"
        f" s to build), {len(stream)} edges (+{n_out} retracted) in "
        f"{t_ingest:.2f} s, blocks of {HUB_BLOCK}; {inc.descends} descents, "
        f"{inc.sweeps} sweeps, {inc.repeels} re-peels; core mismatches vs "
        f"oracle: {mismatches}; launches {counts}; sweep shapes "
        f"{tally.top(4)}")
    expect(mismatches == 0, f"hub serving: {mismatches} core mismatches")
    expect(counts["h_index_hub"] > 0 and hub_keys,
           "hub serving: no hub-kernel launch")
    expect(inc.repeels == 0 and inc.phase_impl["descend"] == "fused[cuda]",
           "hub serving: the repair left the kernel's descent")
    return counts, tally.first[max(hub_keys, key=tally.counts.get)]


def serve_shapes(torch, np, ops, ref, F, svc):
    """Each kernel on the inputs the serving path gives it, from the live
    service: a flush batch's cold-start mean, the two tiers of an all-node
    descent sweep, and a top-11 over the resident table."""
    st = svc.store
    dev = svc.device
    rng = np.random.default_rng(11)
    nodes = torch.tensor(rng.integers(0, svc.graph.n_nodes, 64), device=dev)
    slot_of = st.slot_table_dev()
    idx = svc.graph.ell().neighbours[nodes]
    slots = slot_of[idx.long()]
    valid = (idx != svc.graph.node_cap) & (slots < st.capacity)
    out = {"ell_mean": check_ell(torch, ops, ref, F, slots.contiguous(),
                                 valid, st.table(), "serve")}
    out["h_index"] = check_hindex(torch, ops, ref,
                                  sweep_inputs(torch, np, svc), "serve")
    q, tn, live = topk_inputs(torch, ops, svc, nodes)
    out["top_k"] = check_topk(torch, ops, ref, q, tn, live, 11, "serve")
    return out


def sweep_inputs(torch, np, svc):
    """The two tiers (values, valid, est) of an all-node descent sweep of
    the live service, as its repair would launch them."""
    inc = svc.cores
    n = svc.graph.n_nodes
    cand = np.arange(n, dtype=np.int64)
    deg = svc.graph.degrees_of(cand)
    old = inc.core.astype(np.int64)
    seed = np.minimum(deg.astype(np.int64), old + 1024).astype(np.int32)
    pending = inc._descend_dispatch(cand, seed, old.astype(np.int32), 0,
                                    1 << 30, cand_deg=deg)
    a = pending["args"]
    est = a["est_full"].clone()
    est[a["cand"]] = a["seed"]
    parts = torch.split(a["seed"], [t[0].shape[0] for t in a["tiers"]])
    return [(est[i].contiguous(), v, p.contiguous())
            for (i, v), p in zip(a["tiers"], parts)]


def topk_inputs(torch, ops, svc, nodes):
    """(queries, table, live rows) of a top-k call of the live service:
    the embeddings of ``nodes`` against the resident table, normalised."""
    st = svc.store
    q = ops.normalize_rows(torch.tensor(svc.embed(nodes.cpu().numpy()),
                                        device=svc.device))
    tn = ops.normalize_rows(st.table())
    live = torch.tensor(st.row_valid(), device=svc.device)
    return q, tn, live


# ------------------------------------------------------------ offline ----


def offline_phase(torch, np, counters):
    """The port's quick github table on the card, row by row (the counts set
    to 0 before each row and read after it); returns (rows, counts summed
    over the rows, the split)."""
    from repro_torch.core import kcore
    from repro_torch.core.propagation import propagate
    from repro_torch.graph import datasets, splits
    from repro_torch.launch import tables

    t_phase = time.perf_counter()
    s, models = tables.table("github", quick=True)
    g = datasets.load(s.dataset)
    core = kcore.core_numbers_host(g)
    sp = splits.make_link_split(g, s.frac_removed, seed=0)
    log(f"offline: {s.dataset} split of {len(sp.pos_edges)} held-out edges, "
        f"degeneracy {kcore.degeneracy(core)}, dim {s.dim}, batch {s.batch}, "
        f"epochs {s.epochs} ({time.perf_counter() - t_phase:.1f} s to "
        f"generate and split)")
    rows, total = [], dict.fromkeys(counters.table, 0)
    for label, method, k0f in models:
        k0 = tables.k0_of(core, k0f)
        name = label if k0 is None else f"{k0}-core ({label})"
        counters.reset()
        out = tables.run_model(sp, method, k0, s, 0, "cuda")
        counts = counters.read()
        for key, n in counts.items():
            total[key] += n
        res = out["result"]
        steps = out["n_sgns_steps"]
        row = {"model": name, "f1": out["f1"], "f1_std": 0.0,
               "total": out["total"], "n_walks_run": out["n_walks_run"],
               "sgns_steps": steps, "final_loss": out["final_loss"],
               "sgns_steps_per_s": steps / out["times"]["embedding"],
               "launches": counts,
               **{k: v for k, v in out["times"].items() if k != "total"}}
        base = rows[0] if rows else row
        row["speedup"] = base["total"] / row["total"]
        row["drop"] = row["f1"] - base["f1"]
        log(tables.ROW_FMT.format(**row))
        log(f"  {name}: F1 {row['f1']:.4f}, n_walks_run {row['n_walks_run']}"
            f", n_sgns_steps {steps} ({row['sgns_steps_per_s']:.0f} steps/s)"
            f", final loss {row['final_loss']:.5f}, launches {counts}")
        want_f1, want_walks, want_steps = JAX_GITHUB_QUICK[name]
        expect(np.isfinite(res.embeddings).all()
               and math.isfinite(out["final_loss"]), f"{name}: NaN")
        expect((out["n_walks_run"], steps) == (want_walks, want_steps),
               f"{name}: walks/steps {out['n_walks_run']}/{steps} != the "
               f"JAX package's {want_walks}/{want_steps}")
        expect(abs(out["f1"] - want_f1) <= F1_BAND,
               f"{name}: F1 {out['f1']:.2f} is more than {F1_BAND} points "
               f"from the JAX package's {want_f1:.2f}")
        expect(counts["sgns_fwd"] == counts["sgns_bwd"] == steps,
               f"{name}: SGNS launches {counts['sgns_fwd']}/"
               f"{counts['sgns_bwd']} != {steps} steps")
        if k0 is not None:
            expect(counts["ell_mean"] > 0,
                   f"{name}: the ELL mean was not launched")
            host = propagate(sp.train_graph, res.core,
                             min(k0, res.degeneracy), res.embeddings,
                             n_iters=s.prop_iters, backend="scipy")
            err = float(np.abs(host - res.embeddings).max())
            row["prop_vs_scipy_max_abs"] = err
            log(f"  {name}: torch propagation vs scipy max abs diff {err:.2e}")
            expect(np.allclose(res.embeddings, host, rtol=1e-4, atol=1e-4),
                   f"{name}: torch propagation off scipy by {err}")
        rows.append(row)
    by = {r["model"]: r for r in rows}
    expect(by["CoreWalk"]["n_walks_run"] < by["DeepWalk"]["n_walks_run"]
           and by["CoreWalk"]["sgns_steps"] < by["DeepWalk"]["sgns_steps"],
           "CoreWalk did not shrink the corpus")
    n_steps = sum(r["sgns_steps"] for r in rows)
    expect(total["sgns_fwd"] + total["sgns_bwd"] == 2 * n_steps,
           f"SGNS launches {total} != 2 x {n_steps} steps")
    log(f"offline phase: {time.perf_counter() - t_phase:.1f} s, {n_steps} "
        f"SGNS steps; launches {total}")
    log("offline rows: " + json.dumps(rows))
    return rows, total, sp


def propagation_shapes(torch, np, ops, ref, F, sp):
    """The ELL mean at two of the k-core row's propagation calls on the
    split ``sp`` (``core/propagation.py``: one shell's ELL rows of the train
    graph against the (n + 1, dim) table; each call's shape is one shell's):
    the largest shell, and the largest shell that takes the row-split path.
    The table is seeded noise at the table's width."""
    from repro_torch.core import kcore
    from repro_torch.core.propagation import propagation_schedule
    from repro_torch.graph import datasets
    from repro_torch.kernels import ellmean
    from repro_torch.launch import tables

    s, models = tables.table("github", quick=True)
    k0f = next(f for _, _, f in models if f is not None)
    k0 = tables.k0_of(kcore.core_numbers_host(datasets.load(s.dataset)), k0f)
    g = sp.train_graph
    core = kcore.core_numbers_host(g)
    k0 = min(k0, kcore.degeneracy(core))
    nbr, _ = g.ell_arrays()
    core_ext = np.concatenate([core, [-1]])
    shells = [(int((core == k).sum()), k)
              for k in propagation_schedule(core, k0)]
    width = nbr.shape[1]
    paths = {k: ellmean.row_split(n, width, "cuda") for n, k in shells}
    log(f"propagation (k0 {k0}, L {width}, dim {s.dim}): shells (N, k) "
        f"{shells}; row-split path for k in "
        f"{sorted(k for k, r in paths.items() if r)}")
    picks = [max(shells)]
    split_shells = [x for x in shells if paths[x[1]]]
    if split_shells:
        picks.append(max(split_shells))
    gen = torch.Generator(device="cuda").manual_seed(17)
    table = torch.randn((g.n_nodes + 1, s.dim), generator=gen, device="cuda")
    recs = []
    for _, k in picks:
        rows = np.where(core == k)[0]
        idx = torch.tensor(nbr[rows], device="cuda")
        valid = torch.tensor((nbr[rows] != g.n_nodes)
                             & (core_ext[nbr[rows]] >= k), device="cuda")
        recs.append(check_ell(torch, ops, ref, F, idx, valid, table,
                              f"propagation shell {k}"))
    return recs


def step_profile(torch, sp):
    """Device time by kernel and the busy share of 100 SGNS steps (after 120
    unprofiled), on the CoreWalk corpus of the quick github table's split
    ``sp``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import kcore
    from repro_torch.core.corewalk import corewalk_plan
    from repro_torch.launch import tables
    from repro_torch.skipgram.corpus import build_corpus
    from repro_torch.skipgram.trainer import SGNSConfig, train_sgns

    s, _ = tables.table("github", quick=True)
    core = kcore.core_numbers_host(sp.train_graph)
    gen = torch.Generator(device="cuda").manual_seed(0)
    corpus = build_corpus(sp.train_graph.to_ell(device="cuda"),
                          corewalk_plan(core, s.n_walks), s.walk_length, gen)
    cfg = SGNSConfig(dim=s.dim, window=s.window, n_neg=s.n_neg,
                     batch=s.batch, seed=0)
    plain = train_sgns(corpus, cfg, steps=120)
    steps = 100
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = train_sgns(corpus, cfg, steps=steps)
    dev = {}
    for e in prof.events():
        if e.device_type.name != "CUDA":
            continue
        n, us = dev.get(e.name, (0, 0.0))
        dev[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_ms = sum(us for _, us in dev.values()) / 1e3
    wall_ms = res.train_seconds * 1e3
    top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:12]
    out = {
        "steps": steps,
        "unprofiled_ms_per_step": plain.train_seconds * 1e3 / 120,
        "profiled_ms_per_step": wall_ms / steps,
        "device_ms_per_step": busy_ms / steps,
        "device_busy_share": busy_ms / wall_ms if wall_ms else None,
        "launches_per_step": sum(n for n, _ in dev.values()) / steps,
        "top_kernels": [{"name": k[:90], "calls": n,
                         "ms_per_step": us / 1e3 / steps}
                        for k, (n, us) in top],
    }
    if not dev:
        log("step profile: the profiler saw no device time (not measured)")
    log("step profile: " + json.dumps(out))
    return out


def rotation(torch, make, nbytes):
    """Enough independent input sets (from ``make``) that cycling through
    them streams more than twice the L2 per pass: every launch reads its
    inputs from device memory, as a training step finds them."""
    return [make() for _ in range(max(1, math.ceil(2 * L2_BYTES / nbytes)))]


def time_rotating(torch, fn, sets, iters, timer=None, **kw):
    state = {"i": 0}

    def step():
        fn(*sets[state["i"] % len(sets)])
        state["i"] += 1
    return (timer or time_ms)(torch, step, iters, **kw)


def sgns_fp64(torch, c, x, n, dout):
    """The SGNS loss and gradients in float64, the formulas of the plain
    versions: the yardstick where fp32 sums of many negatives drift."""
    import torch.nn.functional as F

    c, x, n, g = (t.double() for t in (c, x, n, dout))
    pos = (c * x).sum(-1)
    negl = torch.einsum("bkd,bd->bk", n, c)
    loss = F.softplus(-pos) + F.softplus(negl).sum(-1)
    dpos = (torch.sigmoid(pos) - 1.0) * g
    dneg = torch.sigmoid(negl) * g[:, None]
    return loss, (dpos[:, None] * x + torch.einsum("bk,bkd->bd", dneg, n),
                  dpos[:, None] * c, dneg[:, :, None] * c[:, None, :])


def check_sgns(torch, ref, sgns, b, k, d, dtype, label, iters=20,
               fp64=False):
    """Both SGNS kernels against their plain versions at one shape; returns
    ``{"sgns_fwd": record, "sgns_bwd": record}``. With ``fp64`` (many
    negatives) the kernels are held to ``sgns_fp64`` within the tolerance,
    and to the plain versions within the tolerance x max(1, max|plain|):
    the plain version's fp32 sums over K terms drift by about 1e-6 x their
    magnitude (|dcenter| reaches about 80 at K = 2,048), the kernel's dc
    sum is compensated."""
    tol = TOL_SGNS[str(dtype).split(".")[-1]]
    gen = torch.Generator(device="cuda").manual_seed(b + 31 * k + d)
    dt = getattr(torch, str(dtype).split(".")[-1])
    esize = torch.tensor([], dtype=dt).element_size()
    in_bytes = (2 * b * d + b * k * d) * esize

    def make():
        c, x = (torch.randn((b, d), generator=gen, device="cuda").mul_(0.3)
                .to(dt) for _ in range(2))
        n = torch.randn((b, k, d), generator=gen, device="cuda").mul_(0.3)
        return c, x, n.to(dt), torch.randn(b, generator=gen, device="cuda")

    sets = rotation(torch, make, in_bytes)
    c, x, n, dout = sets[0]
    loss = sgns.sgns_fwd_cuda(c, x, n)
    want = ref.sgns_loss_ref(c, x, n)
    grads = sgns.sgns_bwd_cuda(c, x, n, dout)
    want_g = ref.sgns_grads_ref(c, x, n, dout)
    torch.cuda.synchronize()
    what = ("loss", "dcenter", "dctx", "dneg")

    def atol(w):
        return tol * max(1.0, float(w.abs().max())) if fp64 else tol

    if fp64:
        exact = sgns_fp64(torch, c, x, n, dout)
        for got, w, name in zip((loss, *grads), (exact[0], *exact[1]),
                                what):
            e = float((got.double() - w).abs().max())
            expect(torch.allclose(got.double(), w, rtol=tol, atol=tol),
                   f"sgns {label}: {name} off the fp64 value by {e}")
    err_f = float((loss - want).abs().max())
    expect(torch.allclose(loss, want, rtol=tol, atol=atol(want)),
           f"sgns_fwd {label}: max abs err {err_f}")
    err_b = 0.0
    for got, w, name in zip(grads, want_g, what[1:]):
        expect(got.dtype == dt, f"sgns_bwd {label}: {name} is {got.dtype}")
        e = float((got.float() - w.float()).abs().max())
        err_b = max(err_b, e)
        expect(torch.allclose(got.float(), w.float(), rtol=tol,
                              atol=atol(w.float())),
               f"sgns_bwd {label}: {name} max abs err {e}")
    expect(torch.equal(sgns.sgns_fwd_cuda(c, x, n), loss),
           f"sgns_fwd {label}: a second call gave other bits")
    expect(all(torch.equal(a, g) for a, g in
               zip(sgns.sgns_bwd_cuda(c, x, n, dout), grads)),
           f"sgns_bwd {label}: a second call gave other bits")
    shape = f"B={b} K={k} D={d} {str(dt).split('.')[-1]}"
    flops = 2.0 * b * d * (k + 1)  # the K + 1 dots
    # forward: read the inputs, write the loss; backward: read the inputs and
    # dout, recompute the dots, then 3 FLOP per element for the gradients
    fb_ms, fb_by = bound(in_bytes + 4 * b, flops)
    bb_ms, bb_by = bound(2 * in_bytes + 4 * b, flops + 3.0 * b * d * (k + 1))
    recs = {
        "sgns_fwd": {
            "shape": shape, "max_abs_err": err_f,
            "ms": time_rotating(torch, lambda c, x, n, _: sgns.sgns_fwd_cuda(
                c, x, n), sets, iters),
            "loop_ms": time_rotating(torch, lambda c, x, n, _:
                                     sgns.sgns_fwd_cuda(c, x, n), sets,
                                     iters, loop_ms),
            "plain_ms": time_rotating(torch, lambda c, x, n, _:
                                      ref.sgns_loss_ref(c, x, n), sets,
                                      max(iters // 4, 3)),
            "library_ms": None, "bound_ms": fb_ms, "bound_by": fb_by,
        },
        "sgns_bwd": {
            "shape": shape, "max_abs_err": err_b,
            "ms": time_rotating(torch, sgns.sgns_bwd_cuda, sets, iters),
            "loop_ms": time_rotating(torch, sgns.sgns_bwd_cuda, sets, iters,
                                     loop_ms),
            "plain_ms": time_rotating(torch, ref.sgns_grads_ref, sets,
                                      max(iters // 4, 3)),
            "library_ms": None, "bound_ms": bb_ms, "bound_by": bb_by,
        },
    }
    for name, rec in recs.items():
        ratios(rec)
        log(f"{name} {label}: {rec}")
    return recs


# ------------------------------------------------------------- LM side ----


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def lm_serve_phase(torch, np, counters):
    """The LM serving path at qwen3-4b's full width on the card, through
    ``repro_torch.launch.serve`` (its flag parsing, its ``init_model`` from
    a seeded generator on the card, its continuous-batching loop). Returns
    (cfg, params, launch counts, the cache and next tokens right after the
    first swap)."""
    from repro_torch.launch import serve as lm
    from repro_torch.models.steps import make_prefill_step

    args, cfg, params, requests = lm.setup(LM_FLAGS)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    expect((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.param_dtype)
           == LM_SHAPE, f"not qwen3-4b at full width: {cfg}")
    log(f"lm: {cfg.name} full width, {n_params / 1e9:.3f} B parameters "
        f"({n_bytes / 1e9:.2f} GB), {args.slots} slots, {args.requests} requests, prompt "
        f"{args.prompt_len}, max_new {args.max_new}")
    state = {"bad": torch.zeros((), dtype=torch.bool, device=args.device)}

    def on_step(step, cache, logits):  # its time is not in decode_seconds
        state["bad"] |= ~torch.isfinite(logits).all()
        if step == SNAP_STEP:  # the first step after the swap: ragged
            state["snap"] = (_clone(cache), logits[:, -1].argmax(-1)[
                :, None].to(torch.int32))

    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    res = lm.serve(cfg, params, requests, slots=args.slots,
                   max_new=args.max_new, device=args.device, on_step=on_step)
    counts = counters.read()
    peak = torch.cuda.max_memory_allocated()
    steps = res.step_tokens.shape[0]
    log(f"lm serve: {res.served} requests, {res.n_decoded} tokens in {steps} "
        f"decode steps; launches {counts}")
    expect(res.n_decoded == LM_DECODED, f"n_decoded {res.n_decoded} != "
           f"{LM_DECODED}")
    want = cfg.n_layers * steps
    expect(counts["decode_attention"] == want == LM_LAUNCHES,
           f"flash_decode launches {counts['decode_attention']} != "
           f"{cfg.n_layers} x {steps} = {LM_LAUNCHES}")
    for name, n in counts.items():
        expect(name == "decode_attention" or n == 0,
               f"{name} launched {n} times on the LM path")
    expect(not bool(state["bad"]), "NaN or inf in the decode logits")
    expect(0 <= int(res.step_tokens.min())
           and int(res.step_tokens.max()) < cfg.vocab_size,
           "a token outside [0, vocab)")
    # all rows start together, so rows 0-3 finish first and take requests
    # 8-11 in order: their cache rows hold those prompts' B = 1 prefill
    # (recomputed here), which no later decode write reaches
    expect(res.served == args.requests, f"served {res.served}")
    prefill = make_prefill_step(cfg, max_len=args.prompt_len + args.max_new)
    for b in range(args.requests - args.slots):
        _, row = prefill(params, {"tokens": torch.from_numpy(
            requests[args.slots + b][None]).to(args.device)})
        expect(all(torch.equal(res.cache[key][:, b, :args.prompt_len],
                               row[key][:, 0, :args.prompt_len])
                   for key in ("k", "v")), f"row {b}'s cache lost its prefill")
        del row
    lens = res.cache["len"].tolist()
    s_max = args.prompt_len + args.max_new
    expect(max(lens) > s_max, f"no row ran past the cache's end: {lens}")
    swap_s = sum(res.swap_seconds)
    rec = {
        "n_decoded": res.n_decoded, "decode_steps": steps,
        "prefill_ms": res.prefill_seconds * 1e3,
        "prefill_tokens": args.slots * args.prompt_len,
        "swap_prefill_ms": [t * 1e3 for t in res.swap_seconds],
        "decode_s": res.decode_seconds,
        "decode_tokens_per_s": res.n_decoded / res.decode_seconds,
        "ms_per_step_with_swaps": res.decode_seconds * 1e3 / steps,
        "ms_per_step": (res.decode_seconds - swap_s) * 1e3 / steps,
        "peak_memory_gb": peak / 1e9, "final_lengths": lens,
        "flash_decode_launches": counts["decode_attention"],
    }
    log("lm serve phase: " + json.dumps(rec))
    return cfg, params, counts, state["snap"]


def lm_decode_parity(torch, cfg, params, snap):
    """One decode step from the live cache ``snap`` (ragged lengths, four
    rows past the cache's end), with the kernel and with the plain version
    bound into ``models.attention`` for that call only. The caches are
    equal bit for bit except in the rows this step writes in layers 1 and
    up: those hold k, v projected from a hidden state that already carries
    the layers below's attention output, which the two versions round
    differently in bf16; they, and the logits, must agree within 5e-2 x
    their largest magnitude. Then the greedy tokens' agreement over 8
    teacher-forced steps (reported). Returns the kernel's inputs at layers
    ``LM_LAYERS`` of the first step."""
    import functools

    from repro_torch.kernels import ops
    from repro_torch.models import attention as lm_attn
    from repro_torch.models.steps import make_decode_step

    decode = make_decode_step(cfg)
    cache0, tok = snap
    kernel = lm_attn.decode_attention
    plain = functools.partial(ops.decode_attention, impl="ref")
    seen = {"layer": 0, "inputs": {}}

    def record(q, k, v, lens, **kw):
        if seen["layer"] in LM_LAYERS:
            seen["inputs"][seen["layer"]] = (q.clone(), k.clone(), v.clone(),
                                             lens.clone(), kw)
        seen["layer"] += 1
        return kernel(q, k, v, lens, **kw)

    def step(cache, tokens, attn):
        lm_attn.decode_attention = attn
        try:
            return decode(params, cache, tokens)
        finally:
            lm_attn.decode_attention = kernel

    ca, cb = _clone(cache0), _clone(cache0)
    la, ca = step(ca, tok, record)
    lb, cb = step(cb, tok, plain)
    torch.cuda.synchronize()
    s_len = cache0["k"].shape[2]
    lens = cache0["len"].long()
    rows = (lens < s_len).nonzero().flatten()  # rows whose write lands
    at = lens[rows]
    kept = torch.ones(lens.shape[0], s_len, dtype=torch.bool,
                      device=lens.device)
    kept[rows, at] = False
    expect(torch.equal(ca["len"], cb["len"]), "lengths differ")
    row_err = row_max = 0.0
    for key in ("k", "v"):
        expect(torch.equal(ca[key][:, kept], cb[key][:, kept])
               and torch.equal(ca[key][0], cb[key][0]),
               f"cache {key}: the kernel's and the plain step's differ "
               "outside the rows written in layers 1 and up")
        new_a, new_b = ca[key][1:, rows, at].float(), cb[key][1:, rows,
                                                               at].float()
        row_err = max(row_err, float((new_a - new_b).abs().max()))
        row_max = max(row_max, float(new_b.abs().max()))
    expect(row_err <= LM_LOGIT_TOL * row_max,
           f"new cache rows differ by {row_err}")
    err = float((la - lb).abs().max())
    scale = float(lb.abs().max())
    log(f"lm decode parity (full width, lengths {cache0['len'].tolist()}): "
        f"caches equal bit for bit but for the {len(rows)} rows written in "
        f"layers 1-{cfg.n_layers - 1} (max abs diff {row_err:.4g} against "
        f"max {row_max:.4g}); logits max abs err {err:.4g} against "
        f"max|logit| {scale:.4g} (limit {LM_LOGIT_TOL} x)")
    expect(err <= LM_LOGIT_TOL * scale, f"logits differ by {err}")
    ca, cb = _clone(cache0), _clone(cache0)
    agree = 0
    for _ in range(8):
        la, ca = step(ca, tok, kernel)
        lb, cb = step(cb, tok, plain)
        ta, tb = la[:, -1].argmax(-1), lb[:, -1].argmax(-1)
        agree += int((ta == tb).sum())
        tok = ta[:, None].to(torch.int32)
    share = agree / (8 * tok.shape[0])
    log(f"lm greedy agreement kernel vs plain over 8 teacher-forced steps: "
        f"{share:.4f}")
    return seen["inputs"]


def lm_reference_phase(torch, np):
    """Reduced qwen3-4b (fp32, n_heads=8, n_kv_heads=2) served on the card
    and on the CPU with the same weights and schedule: token streams equal,
    logits within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as lm
    from repro_torch.models.transformer import init_model

    cfg = get_config("qwen3-4b").reduced(n_heads=8, n_kv_heads=2)
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    requests = lm.make_requests(cfg.vocab_size, 5, 8, 0)
    out = {}
    for dev in ("cuda", "cpu"):
        logs = []
        res = lm.serve(cfg, _tree_to(params, dev), requests, slots=2,
                       max_new=4, device=dev,
                       on_step=lambda s, c, lg: logs.append(lg.cpu()))
        out[dev] = (res, torch.stack(logs))
    (rg, lg), (rc, lc) = out["cuda"], out["cpu"]
    err = float((lg - lc).abs().max())
    expect(rg.n_decoded == rc.n_decoded == 24, "n_decoded differs")
    expect(np.array_equal(rg.step_tokens, rc.step_tokens)
           and rg.streams == rc.streams, "token streams differ")
    expect(err <= 1e-4, f"logits differ from the CPU's by {err}")
    log(f"lm reference: reduced qwen3-4b (G=4) served on cuda == cpu: "
        f"{rg.step_tokens.shape[0]} steps, token streams equal, logits max "
        f"abs diff {err:.2e}")


def lm_profile(torch, cfg, params, snap, steps=20):
    """Device time by kernel class over ``steps`` decode steps from the live
    cache (after as many unprofiled ones), launches per step and the busy
    share (reported, not held)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.steps import make_decode_step

    decode = make_decode_step(cfg)
    cache, tok = _clone(snap[0]), snap[1]

    def run():
        nonlocal cache
        for _ in range(steps):
            _, cache = decode(params, cache, tok)
        torch.cuda.synchronize()

    run()  # warm
    t0 = time.perf_counter()
    run()
    plain_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev, classes = {}, {}
    for e in prof.events():
        if e.device_type.name != "CUDA":
            continue
        n, us = dev.get(e.name, (0, 0.0))
        dev[e.name] = (n + 1, us + e.time_range.elapsed_us())
    for name, (n, us) in dev.items():
        low = name.lower()
        if "flash_decode" in low:
            cls = "flash_decode"
        elif any(w in low for w in ("gemm", "gemv", "cutlass", "xmma",
                                    "cublas", "splitk", "nvjet")):
            cls = "gemm/gemv"
        elif "memcpy" in low or "memset" in low:
            cls = "copies"
        else:
            cls = "elementwise/other"
        cn, cus = classes.get(cls, (0, 0.0))
        classes[cls] = (cn + n, cus + us)
    busy_ms = sum(us for _, us in dev.values()) / 1e3
    top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:12]
    out = {
        "steps": steps, "unprofiled_ms_per_step": plain_ms,
        "profiled_ms_per_step": wall_ms / steps,
        "device_ms_per_step": busy_ms / steps,
        "device_busy_share": busy_ms / wall_ms if wall_ms else None,
        "launches_per_step": sum(n for n, _ in dev.values()) / steps,
        "by_class_ms_per_step": {c: us / 1e3 / steps
                                 for c, (_, us) in classes.items()},
        "launches_by_class_per_step": {c: n / steps
                                       for c, (n, _) in classes.items()},
        "top_kernels": [{"name": k[:90], "calls": n,
                         "ms_per_step": us / 1e3 / steps}
                        for k, (n, us) in top],
    }
    if not dev:
        log("lm profile: the profiler saw no device time (not measured)")
    log("lm profile: " + json.dumps(out))
    return out


def check_decode(torch, F, ops, ref, sets, label, softcap=0.0, window=0,
                 iters=20):
    """flash_decode against its plain version on ``sets`` (tuples q, k, v,
    lens[, k_scale, v_scale]; parity on the first, timing rotated through
    all), with the library time (one SDPA call, softcap 0 and no int8
    only) and the bound from the visible rows."""
    def split(t):
        q, k, v, lens = t[:4]
        kw = {"softcap": softcap, "window": window}
        if len(t) > 4:
            kw.update(k_scale=t[4], v_scale=t[5])
        return q, k, v, lens, kw

    from repro_torch.kernels import flash_decode

    q, k, v, lens, kw = split(sets[0])
    got = ops.decode_attention(q, k, v, lens, impl="cuda", **kw)
    want = ref.decode_attention_ref(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    rtol, atol = TOL_DECODE[str(q.dtype).split(".")[-1]]
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    expect(torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol),
           f"flash_decode {label}: max abs err {err} against max|out| "
           f"{scale} (rtol {rtol}, atol {atol})")
    expect(torch.equal(ops.decode_attention(q, k, v, lens, impl="cuda",
                                            **kw), got),
           f"flash_decode {label}: a second call gave other bits")
    b, h, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    end = lens.clamp_max(s)
    lo = (lens - window).clamp_min(0) if window > 0 else torch.zeros_like(
        lens)
    vis = int((end - lo).clamp_min(0).sum())
    nbytes = vis * hkv * dh * 2 * k.element_size() \
        + (vis * hkv * 8 if "k_scale" in kw else 0) \
        + 2 * q.numel() * q.element_size() + 8 * b
    b_ms, b_by = bound(nbytes, 4.0 * vis * h * dh)

    expect(all(torch.equal(t[3], lens) for t in sets),
           f"flash_decode {label}: the timed sets' lengths differ")

    def kern(*t):  # the kernel alone, on the window bound ops computes
        q, k, v, lens, kw = split(t)
        flash_decode.decode_attention_cuda(
            q, k, v, lens, lo, softcap=softcap, k_scale=kw.get("k_scale"),
            v_scale=kw.get("v_scale"))

    def plain(*t):
        q, k, v, lens, kw = split(t)
        ref.decode_attention_ref(q, k, v, lens, **kw)

    lib_ms = None
    if softcap == 0 and "k_scale" not in kw:
        pos = torch.arange(s, device=q.device)[None]

        def lib(*t):  # one SDPA call over the visible positions' mask
            q, k, v, lens, _ = split(t)
            lo = (lens - window).clamp_min(0) if window > 0 else \
                torch.zeros_like(lens)
            mask = (pos < lens[:, None]) & (pos >= lo[:, None])
            return F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask[:, None, None, :], enable_gqa=True)[:, :, 0]

        lib_out = lib(*sets[0])
        expect(torch.allclose(lib_out.float(), want.float(), rtol=TOL_SDPA,
                              atol=TOL_SDPA),
               f"flash_decode {label}: SDPA disagrees with the plain version")
        lib_ms = time_rotating(torch, lib, sets, iters)
    rec = {
        "shape": f"B={b} H={h} Hkv={hkv} Dh={dh} S={s} "
                 f"{str(k.dtype).split('.')[-1]} softcap={softcap} "
                 f"window={window} visible={vis}",
        "max_abs_err": err, "max_abs_out": scale, "rtol": rtol, "atol": atol,
        "ms": time_rotating(torch, kern, sets, iters),
        "loop_ms": time_rotating(torch, kern, sets, iters, loop_ms),
        "plain_ms": time_rotating(torch, plain, sets, max(iters // 4, 3)),
        "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
        "splits": flash_decode.splits(q, k),
    }
    ratios(rec)
    log(f"flash_decode {label}: {rec}")
    return rec


def decode_shapes(torch, F, ops, ref, live, dev="cuda"):
    """flash_decode at the live serving inputs (layers ``LM_LAYERS`` of one
    step: parity at the first and last, timing rotated through all) and at
    three made-up shapes: gemma2-2b's (softcap 50, window 4096), a large
    ragged bf16 one and the same with an int8 cache, each timed rotating
    through two caches (the second the first rolled by one batch row)."""
    from repro_torch.models.attention import quantize_kv_rows

    recs = []
    layers = sorted(live)
    for lay in (layers[0], layers[-1]):
        kw = live[lay][4]
        expect(kw["softcap"] == 0.0 and not kw["window"]
               and kw["k_scale"] is None, f"layer {lay}: {kw}")
        recs.append(check_decode(
            torch, F, ops, ref, [live[lay][:4]] + [live[x][:4] for x in layers
                                                  if x != lay],
            f"serve layer {lay}"))
    gen = torch.Generator(device=dev).manual_seed(13)
    for label, b, h, hkv, dh, s, softcap, window, int8 in DECODE_SHAPES:
        if not int8:
            q = torch.randn((b, h, dh), generator=gen, device=dev).bfloat16()
            k, v = (torch.randn((b, s, hkv, dh), generator=gen, device=dev)
                    .bfloat16() for _ in range(2))
            lens = torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                                 dtype=torch.int32)
            lens[-1] = s + 7  # a finished row past the cache's end
            # a second cache to time against, so that no call finds the
            # previous one's rows in the L2
            k2, v2 = torch.roll(k, 1, 0), torch.roll(v, 1, 0)
            sets = [(q, k, v, lens), (q, k2, v2, lens)]
        else:  # the previous shape's inputs with an int8 cache
            sets = []
            for kk, vv in ((k, v), (k2, v2)):
                kq, ks = quantize_kv_rows(kk)
                vq, vs = quantize_kv_rows(vv)
                sets.append((q, kq, vq, lens, ks, vs))
            del k, v, k2, v2, kq, vq
        recs.append(check_decode(torch, F, ops, ref, sets, label,
                                 softcap=softcap, window=window, iters=10))
        del sets
    return recs[0], recs[1:]


# -------------------------------------------------------------- main ----


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false; this smoke test "
            "needs an NVIDIA GPU")
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        log(f"FAIL: {src / 'repro_torch'} not found; run from a checkout")
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels import (build, ellmean, flash_decode, hindex,
                                     ops, ref, sgns, topk)

    smi = nvidia_smi()
    log(f"card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    logs = build.build()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({len(logs)} compiled: {', '.join(sorted(logs)) or 'cached'})")

    counters = Counters({
        "ell_mean": (ellmean, "launches"), "h_index": (hindex, "launches"),
        "top_k": (topk, "launches"), "sgns_fwd": (sgns, "fwd_launches"),
        "sgns_bwd": (sgns, "bwd_launches"),
        "decode_attention": (flash_decode, "launches"),
        # each kernel of the top-k's pass, and the h-index's two kernels
        "top_k.partial": (topk, "partial_launches"),
        "top_k.merge": (topk, "merge_launches"),
        "h_index.narrow": (hindex, "narrow_launches"),
        "h_index.wide": (hindex, "wide_launches"),
        "h_index.hub": (hindex, "hub_launches"),
        "h_index_hub": (hindex, "hub_launches"),  # its own record too
    })
    with SweepTally(ops) as tally:  # the serving phase only
        svc, serve_counts = serve_phase(torch, np, counters)
    shape_tally, tally_recs = sweep_tally(torch, ops, ref, tally)
    reference_phase(torch, np)
    hub_counts, hub_tier = hub_serve_phase(torch, np, counters)
    serve_rec = serve_shapes(torch, np, ops, ref, F, svc)
    large_rec = large_shapes(torch, ops, ref, F)
    large_rec["h_index"] += tally_recs
    serve_rec["h_index_hub"], large_rec["h_index_hub"] = hub_shapes(
        torch, ops, ref, hub_tier)
    _, offline_counts, split = offline_phase(torch, np, counters)
    large_rec["ell_mean"] += propagation_shapes(torch, np, ops, ref, F,
                                                split)
    train = check_sgns(torch, ref, sgns, 8192, 5, 150, torch.float32,
                       "train")
    large = check_sgns(torch, ref, sgns, 65536, 5, 256, torch.bfloat16,
                       "large", iters=10)
    many = check_sgns(torch, ref, sgns, 64, 2048, 150, torch.float32,
                      "K=2048", iters=10, fp64=True)
    for name in ("sgns_fwd", "sgns_bwd"):
        serve_rec[name] = train[name]
        large_rec[name] = [large[name], many[name]]
    step_profile(torch, split)
    cfg, params, lm_counts, snap = lm_serve_phase(torch, np, counters)
    live = lm_decode_parity(torch, cfg, params, snap)
    lm_profile(torch, cfg, params, snap)
    del params, snap
    lm_reference_phase(torch, np)
    serve_rec["decode_attention"], large_rec["decode_attention"] = \
        decode_shapes(torch, F, ops, ref, live)

    keys = ("max_abs_err", "ms", "loop_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "x_bound", "x_library", "shape")
    kernels = []
    paths = (serve_counts, hub_counts, offline_counts, lm_counts)
    for name, (src_path, replaces) in SOURCES.items():
        by_path = {"serve": serve_counts[name], "hub": hub_counts[name],
                   "offline": offline_counts[name], "lm": lm_counts[name]}
        expect(sum(by_path.values()) > 0, f"kernel {name} never launched")
        rec = {
            "name": name, "route": "cuda", "source": src_path,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            **{k: serve_rec[name][k] for k in keys},
            "large": [{k: b[k] for k in keys} for b in large_rec[name]],
        }
        parts = [key for key in counters.table
                 if key.startswith(name + ".")]
        if parts:  # the kernels of one wrapper, each counted
            rec["launches_by_kernel"] = {
                key.split(".")[1]: sum(c[key] for c in paths)
                for key in parts}
            expect(sum(rec["launches_by_kernel"].values()) == rec["launches"],
                   f"{name}: its kernels' launches do not sum to its count")
        if name == "h_index":
            rec["tiers"] = [{k: t[k] for k in keys}
                            for t in serve_rec[name]["tiers"]]
            rec["serving_shapes"] = shape_tally
        kernels.append(rec)
    log(f"smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        sys.exit(1)
