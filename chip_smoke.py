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
   top-k counts both of its kernels, two launches per round of 32);
3. a small reference: the same path on a 300-node graph on the card and on
   the CPU (plain versions), cores equal after every block, embeddings and
   link scores within 1e-5, top-10 and top-40 ids (one and two rounds of
   the top-k kernel) equal off near-ties;
4. kernel parity and timing: each kernel against its plain PyTorch version
   on the same inputs, at the shapes the serving path gave it (taken from
   the live service) and at one large shape (the top-k there at k = 11
   and k = 100, one round and four), with kernel, plain and library
   times from CUDA events and the bound (bytes over 3.35 TB/s or operations
   over 67 TFLOP/s, the H100 SXM's published peaks).

The line before the last is the ``nvidia-smi`` name and power limit; before
it, one JSON object with a record per kernel; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
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

SOURCES = {
    "ell_mean": ("src/repro_torch/csrc/ellmean.cu",
                 "src/repro/kernels/ellmean.py:79"),
    "h_index": ("src/repro_torch/csrc/hindex.cu",
                "src/repro/kernels/hindex.py:88"),
    "top_k": ("src/repro_torch/csrc/topk.cu",
              "src/repro/kernels/topk.py:117"),
}


def log(msg: str) -> None:
    print(f"[chip-smoke] {msg}", flush=True)


class SmokeFailure(RuntimeError):
    pass


def expect(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- timing ----


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call from CUDA events around ``iters`` calls."""
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


# ------------------------------------------------------------ parity ----


def check_ell(torch, ops, ref, F, idx, valid, emb, label, iters=20):
    got = ops.ell_mean(idx, valid, emb, impl="cuda")
    want = ref.ell_mean_ref(idx, valid, emb)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0
    expect(torch.allclose(got.float(), want.float(), rtol=TOL_ELL,
                          atol=TOL_ELL),
           f"ell_mean {label}: max abs err {err}")
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
        "plain_ms": time_ms(torch, lambda: ref.ell_mean_ref(idx, valid, emb),
                            max(iters // 4, 3)),
        "library_ms": time_ms(torch, lambda: F.embedding_bag(
            flat, emb, offsets, mode="mean"), iters),
        "bound_ms": b_ms, "bound_by": b_by,
    }
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
    a two-tier descent is two launches); the record covers all of them."""
    errs = 0
    for values, valid, est in tiers:
        got = ops.h_index_sweep(values, valid, est, impl="cuda")
        want = ref.h_index_ref(values, valid, est)
        cnt = ops.h_index_sweep(values, valid, est, impl="count")
        torch.cuda.synchronize()
        errs += int((got != want).sum())
        expect(torch.equal(cnt, want), f"h_index {label}: count != ref")
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
        "plain_ms": time_ms(torch, run("ref"), max(iters // 4, 3)),
        "count_ms": time_ms(torch, run("count"), max(iters // 4, 3)),
        "library_ms": None,
        "bound_ms": b_ms, "bound_by": b_by,
    }
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
    got_v, got_i = ops.top_k_scores(q, table, k, valid=valid, impl="cuda")
    err, n_tie = topk_agree(torch, ref, got_v, got_i, q, table, k, valid)
    bias = torch.zeros(table.shape[0], device=table.device)
    bias.masked_fill_(~valid, float("-inf"))
    n, d = table.shape
    nq = q.shape[0]
    b_ms, b_by = bound(n * d * 4 + n * 4 + nq * d * 4 + nq * k * 8,
                       2.0 * nq * n * d)
    rec = {
        "shape": f"Q={nq} N={n} D={d} k={k}",
        "max_abs_err": err, "near_tie_positions": n_tie,
        "ms": time_ms(torch, lambda: ops.top_k_scores(
            q, table, k, valid=valid, impl="cuda"), iters),
        "plain_ms": time_ms(torch, lambda: ref.topk_ref(q, table, k,
                                                        valid=valid),
                            max(iters // 4, 3)),
        "library_ms": time_ms(torch, lambda: torch.topk(
            q @ table.T + bias, k, dim=1), iters),
        "bound_ms": b_ms, "bound_by": b_by,
    }
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
                     for k in (11, 100)]}  # one round, then four
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


# ------------------------------------------------------------ serving ----


def serve_phase(torch, np, kernels):
    """The port's main path on the card; returns (service, launch counts)."""
    from repro_torch.graph import datasets
    from repro_torch.launch.serve_embed import build_service

    t0 = time.perf_counter()
    g = datasets.load("github-like", seed=0)
    log(f"github-like: {g.n_nodes} nodes, {g.n_edges} edges, max degree "
        f"{int(g.degrees().max())} ({time.perf_counter() - t0:.1f} s to "
        f"generate); stream_frac {STREAM_FRAC}")
    for mod in kernels.values():
        mod.launches = 0
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
    counts = {name: mod.launches for name, mod in kernels.items()}
    log(f"kernel launches on the serving path: {counts}")
    for name, n in counts.items():
        expect(n > 0, f"kernel {name} was not launched on the serving path")
    return svc, counts


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
    for k in (10, 40):  # one round of the top-k kernel, then two
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
    tiers = [(est[i].contiguous(), v, p.contiguous())
             for (i, v), p in zip(a["tiers"], parts)]
    out["h_index"] = check_hindex(torch, ops, ref, tiers, "serve")
    q = ops.normalize_rows(torch.tensor(svc.embed(nodes.cpu().numpy()),
                                        device=dev))
    tn = ops.normalize_rows(st.table())
    live = torch.tensor(st.row_valid(), device=dev)
    out["top_k"] = check_topk(torch, ops, ref, q, tn, live, 11, "serve")
    return out


# -------------------------------------------------------------- main ----


def main() -> int:
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
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels import build, ellmean, hindex, ops, ref, topk

    smi = nvidia_smi()
    log(f"card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    logs = build.build()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({len(logs)} compiled: {', '.join(sorted(logs)) or 'cached'})")

    mods = {"ell_mean": ellmean, "h_index": hindex, "top_k": topk}
    svc, counts = serve_phase(torch, np, mods)
    reference_phase(torch, np)
    serve_rec = serve_shapes(torch, np, ops, ref, F, svc)
    large_rec = large_shapes(torch, ops, ref, F)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape")
    kernels = []
    for name, (src_path, replaces) in SOURCES.items():
        kernels.append({
            "name": name, "route": "cuda", "source": src_path,
            "replaces": replaces, "launches": counts[name],
            **{k: serve_rec[name][k] for k in keys},
            "large": [{k: b[k] for k in keys} for b in large_rec[name]],
        })
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
