#!/usr/bin/env python3
"""Time the port's ELL mean, flash-decode, top-k, h-index and SGNS kernels of
one source tree on one GPU.

    python3 chip_ab.py --src SRC_DIR [--tag NAME]

``SRC_DIR`` is the ``src`` directory of a checkout (this one, or an older
commit unpacked with ``git archive``); its ``repro_torch`` kernels are built
from that checkout's sources and timed at fixed shapes: the ELL mean at the
serving flush (64 ELL rows of ``github-like``), a large random shape and
the offline k-core row's propagation calls (each shell's rows of the train
split against a (n + 1, 150) table, and one call per shell summed), and
flash-decode at the serving shape (B=8 H=32 Hkv=8 Dh=128 S=1088 bf16,
8,456 visible positions, rotated through six caches), gemma2-2b's
(softcap 50, window 4096), a large ragged one and the same with an int8
cache; the top-k at the serving shape (64 queries of ``github-like``'s
service, built as the smoke builds it but before any ingest, against its
resident table, k = 11) and at the large one (Q=64 N=2^21 D=128, 90% of
the rows live, k = 11, 100 and 300), through the kernels' own wrapper;
the h-index at the serving shape (the two tiers of an all-node descent
sweep of that service, each tier and both) and at two large ones
(R=2^20 W=32, R=2^14 W=2048, left-packed rows); the SGNS forward and
backward at the smoke's two shapes (B=8192 K=5 D=150 fp32, B=65536 K=5
D=256 bf16), rotated through input sets that stream more than twice the
L2, with a hash of the forward's losses (and of the backward's gradients)
on the first set of each shape, so that two trees' bits can be compared.
Inputs come from fixed seeds, so two trees see the same data. Each
time is the device time per call with the host's launch time left out
(``chip_smoke.time_ms``: the calls queued behind a spin kernel, CUDA
events around them) beside the CUDA-event time of a loop of calls
(``chip_smoke.loop_ms``, which the host sets for small kernels). To
compare two trees, run each in its own process within one machine, in
turns (old, new, new, old). Prints the card's name and power limit, then
one JSON object; needs a CUDA device (exits 2 without one). Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def top_k_and_h_index(torch, sm, ops, topk, out, timed, serve_topk,
                      serve_tiers):
    """The top-k and h-index timings into ``out``."""
    dev = "cuda"

    def tk(label, q, table, live, k, iters):
        bias = torch.zeros(table.shape[0], device=dev)
        bias.masked_fill_(~live, float("-inf"))
        out["top_k"][label] = timed(
            lambda: topk.topk_cuda(q, table, bias, k), iters)

    def hx(label, tiers, iters=20):
        def sweep():
            for values, valid, est in tiers:
                ops.h_index_sweep(values, valid, est, impl="cuda")
        out["h_index"][label] = timed(sweep, iters)

    q, table, live = serve_topk
    tk(f"serve Q=64 N={table.shape[0]} D=128 k=11", q, table, live, 11, 20)
    shapes = [f"R={v.shape[0]} W={v.shape[1]}" for v, _, _ in serve_tiers]
    hx("serve " + " + ".join(shapes), serve_tiers)
    for label, tier in zip(shapes, serve_tiers):
        hx(f"serve tier {label}", [tier])
    gen = torch.Generator(device=dev).manual_seed(0)
    table = ops.normalize_rows(torch.randn((1 << 21, 128), generator=gen,
                                           device=dev))
    live = torch.rand(1 << 21, generator=gen, device=dev) < 0.9
    q = ops.normalize_rows(torch.randn((64, 128), generator=gen, device=dev))
    for k in (11, 100, 300):
        tk(f"large Q=64 N=2^21 D=128 k={k}", q, table, live, k, 10)
    del table
    for r, w, vmax in ((1 << 20, 32, 64), (1 << 14, 2048, 400)):
        values = torch.randint(0, vmax, (r, w), generator=gen, device=dev,
                               dtype=torch.int32)
        deg = torch.randint(1, w + 1, (r,), generator=gen, device=dev)
        valid = torch.arange(w, device=dev)[None, :] < deg[:, None]
        est = torch.randint(0, vmax, (r,), generator=gen, device=dev,
                            dtype=torch.int32)
        hx(f"large R={r} W={w}", [(values, valid, est)], 10)


def sgns_kernels(torch, sm, sgns, out, timed):
    """The SGNS timings and bit hashes into ``out``."""
    import hashlib

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.float().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    for label, b, k, d, dt, iters in (
            ("train B=8192 K=5 D=150 fp32", 8192, 5, 150, torch.float32, 20),
            ("large B=65536 K=5 D=256 bf16", 65536, 5, 256, torch.bfloat16,
             10)):
        gen = torch.Generator(device="cuda").manual_seed(b + 31 * k + d)

        def make():
            c, x = (torch.randn((b, d), generator=gen, device="cuda")
                    .mul_(0.3).to(dt) for _ in range(2))
            n = torch.randn((b, k, d), generator=gen, device="cuda").mul_(0.3)
            return c, x, n.to(dt), torch.randn(b, generator=gen, device="cuda")

        sets = sm.rotation(torch, make, (2 * b * d + b * k * d)
                           * torch.tensor([], dtype=dt).element_size())
        first = sets[0]
        out["sgns"][label] = {
            "fwd": timed(lambda c, x, n, _: sgns.sgns_fwd_cuda(c, x, n),
                         iters, sets),
            "bwd": timed(sgns.sgns_bwd_cuda, iters, sets),
            "loss_sha256": digest(sgns.sgns_fwd_cuda(*first[:3])),
            "grads_sha256": digest(*sgns.sgns_bwd_cuda(*first)),
        }
        del sets, first


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True, help="a checkout's src directory")
    ap.add_argument("--tag", default="", help="a label for the output")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as sm
    from repro_torch.core import kcore
    from repro_torch.core.propagation import propagation_schedule
    from repro_torch.graph import datasets, splits
    from repro_torch.kernels import build, flash_decode, ops, sgns, topk
    from repro_torch.launch.serve_embed import build_service
    from repro_torch.models.attention import quantize_kv_rows

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build(("ellmean", "flash_decode", "hindex", "sgns", "topk"))
    dev = "cuda"
    out = {"tag": args.tag, "src": str(Path(args.src).resolve()),
           "card": sm.nvidia_smi(), "ell_mean": {}, "flash_decode": {},
           "top_k": {}, "h_index": {}, "sgns": {}}

    def timed(fn, iters, sets=None):
        """{"ms": device ms a call, "loop_ms": CUDA events around a loop of
        calls}; ``sets`` rotates the inputs."""
        if sets is None:
            return {"ms": sm.time_ms(torch, fn, iters),
                    "loop_ms": sm.loop_ms(torch, fn, iters)}
        return {"ms": sm.time_rotating(torch, fn, sets, iters),
                "loop_ms": sm.time_rotating(torch, fn, sets, iters,
                                            sm.loop_ms)}

    def ell(label, idx, valid, emb, iters=50):
        out["ell_mean"][label] = timed(
            lambda: ops.ell_mean(idx, valid, emb, impl="cuda"), iters)

    g = datasets.load("github-like", seed=0)
    svc = build_service(g, stream_frac=sm.STREAM_FRAC, dim=128, batch=64,
                        device=dev)[0]
    nodes = torch.tensor(np.random.default_rng(11).integers(
        0, svc.graph.n_nodes, 64), device=dev)
    top_k_and_h_index(torch, sm, ops, topk, out, timed,
                      sm.topk_inputs(torch, ops, svc, nodes),
                      sm.sweep_inputs(torch, np, svc))
    del svc
    sgns_kernels(torch, sm, sgns, out, timed)
    gen = torch.Generator(device=dev).manual_seed(0)
    nbr, _ = g.ell_arrays()
    rows = np.random.default_rng(11).integers(0, g.n_nodes, 64)
    table = torch.randn((g.n_nodes + 1, 128), generator=gen, device=dev)
    idx = torch.tensor(nbr[rows], device=dev)
    ell("flush N=64 L=%d D=128" % nbr.shape[1], idx, idx != g.n_nodes,
        table)
    big = torch.randn((1 << 21, 128), generator=gen, device=dev)
    idx = torch.randint(0, 1 << 21, (1 << 18, 32), generator=gen, device=dev,
                        dtype=torch.int32)
    ell("large N=2^18 L=32 D=128", idx,
        torch.rand((1 << 18, 32), generator=gen, device=dev) < 0.7, big, 10)
    del big, idx
    sp = splits.make_link_split(g, 0.1, seed=0)
    tg = sp.train_graph
    core = kcore.core_numbers_host(tg)
    nbr, _ = tg.ell_arrays()
    core_ext = np.concatenate([core, [-1]])
    xt = torch.randn((tg.n_nodes + 1, 150), generator=gen, device=dev)
    shells = []
    for k in propagation_schedule(core, 13):
        sel = np.where(core == k)[0]
        shells.append((k, torch.tensor(nbr[sel], device=dev), torch.tensor(
            (nbr[sel] != tg.n_nodes) & (core_ext[nbr[sel]] >= k),
            device=dev)))
        ell(f"propagation shell {k} N={len(sel)} L={nbr.shape[1]} D=150",
            shells[-1][1], shells[-1][2], xt)

    def sweep():
        for _, i, v in shells:
            ops.ell_mean(i, v, xt, impl="cuda")
    out["ell_mean"]["propagation sweep, 12 shells"] = timed(sweep, 20)
    del shells, xt

    def dec(label, sets, softcap=0.0, window=0, iters=20):
        lo = (sets[0][3] - window).clamp_min(0) if window > 0 else \
            torch.zeros_like(sets[0][3])

        def kern(q, k, v, lens, *sc):  # every set has the same lengths
            kw = dict(k_scale=sc[0], v_scale=sc[1]) if sc else {}
            flash_decode.decode_attention_cuda(q, k, v, lens, lo,
                                               softcap=softcap, **kw)
        out["flash_decode"][label] = timed(kern, iters, sets)

    gen = torch.Generator(device=dev).manual_seed(13)
    lens = torch.tensor([1088] * 4 + [1026] * 4, dtype=torch.int32,
                        device=dev)
    sets = []
    for _ in range(6):  # 6 x 35.6 MB of K/V: more than twice the L2
        q = torch.randn((8, 32, 128), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((8, 1088, 8, 128), generator=gen, device=dev)
                .bfloat16() for _ in range(2))
        sets.append((q, k, v, lens))
    dec("serve B=8 S=1088", sets)
    del sets
    for label, b, h, hkv, dh, s, softcap, window in (
            ("gemma2-2b B=8 S=8192 Dh=256", 8, 8, 4, 256, 8192, 50.0, 4096),
            ("large B=32 S=8192", 32, 32, 8, 128, 8192, 0.0, 0)):
        q = torch.randn((b, h, dh), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((b, s, hkv, dh), generator=gen, device=dev)
                .bfloat16() for _ in range(2))
        lens = torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                             dtype=torch.int32)
        lens[-1] = s + 7
        # two caches, so that no call finds the previous one's rows in L2
        sets = [(q, k, v, lens), (q, torch.roll(k, 1, 0),
                                  torch.roll(v, 1, 0), lens)]
        dec(label, sets, softcap, window, 10)
    int8 = []
    for q, k, v, lens in sets:
        kq, ks = quantize_kv_rows(k)
        vq, vs = quantize_kv_rows(v)
        int8.append((q, kq, vq, lens, ks, vs))
    del sets, k, v
    dec("large int8 B=32 S=8192", int8, iters=10)
    print(out["card"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
