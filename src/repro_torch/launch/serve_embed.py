"""Online embedding service launcher of the port — synthetic-traffic demo.

``python -m repro_torch.launch.serve_embed --device cuda --dataset synthetic``

The torch counterpart of ``repro.launch.serve_embed``, with the same flags
plus ``--device`` (default ``cuda``; ``cpu`` runs the plain versions). Flow:
build a base graph, hold out a fraction of edges (plus the nodes that only
appear in them — the "future users") as an ingestion stream; embed the base
graph's k0-core with a seeded random table and mean-propagate it offline
(paper §2.2) to fill the store; then stream the held-out edges in **blocks**
(``--block-size``), retracting a ``--churn`` fraction of previously streamed
edges after each block, with incremental cores verified against the
Matula–Beck oracle at the end; finally replay microbatched query traffic
over both existing and brand-new nodes. Every input is drawn from numpy's
``default_rng``, so the JAX package and the port can be driven on identical
inputs. ``--train`` replaces the seeded k0-core table by real CoreWalk +
SGNS embeddings of the base graph (``core.pipeline.embed_graph``; the fused
SGNS kernels on the card).

Not in this port yet, and refused with an error: ``--retrain`` (it needs
``serve/retrain.py``), ``--wal-dir`` / ``--fault-plan`` (crash safety),
``--jax-profile``, and ``--shards`` > 1. ``--no-pipeline`` is accepted and
changes nothing: the port ingests every block serially.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core.kcore import core_numbers_host, degeneracy
from repro_torch.core.pipeline import EmbedConfig, embed_graph
from repro_torch.core.propagation import propagate
from repro_torch.device import resolve_device
from repro_torch.graph import datasets, generators
from repro_torch.obs import metrics
from repro_torch.obs import trace as obs
from repro_torch.serve import (
    DynamicGraph,
    EmbeddingService,
    EmbeddingStore,
    IncrementalCore,
    ServiceStats,
)
from repro_torch.skipgram.trainer import SGNSConfig

__all__ = ["main", "build_service"]


def _load_graph(name: str, seed: int):
    if name == "synthetic":
        return generators.barabasi_albert_varying(2000, 6.0, seed=seed)
    if name not in datasets.DATASETS:
        raise SystemExit(
            f"unknown dataset {name!r}; options: "
            f"{['synthetic'] + sorted(datasets.DATASETS)}"
        )
    return datasets.load(name, seed=seed)


def _split_stream(g, stream_frac: float, seed: int):
    """Split edges into (base, stream); stream arrives later, in order."""
    edges = g.edge_list()
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(edges))
    n_stream = int(round(stream_frac * len(edges)))
    stream = edges[perm[:n_stream]]
    base = edges[perm[n_stream:]]
    return base, stream


def build_service(
    g,
    *,
    stream_frac: float = 0.15,
    k0_frac: float = 0.5,
    dim: int = 64,
    batch: int = 64,
    capacity: int = 0,
    compact_every: int = 512,
    prop_iters: int = 20,
    seed: int = 0,
    train: bool = False,
    retrain_threshold: float = 0.1,
    repair_policy: str = "adaptive",
    crossover_margin: float = 1.0,
    cold_cells_per_arc: float = 32.0,
    device="cuda",
):
    """Returns (service, stream_edges, base_core, k0), on ``device``.

    The same split, k0-core table and propagation as the JAX package's
    ``build_service``. Without ``train`` the k0-core rows are drawn from
    ``default_rng(seed)`` and the lower shells filled by the host (scipy)
    propagation, so both packages start from the same store; with ``train``
    CoreWalk + SGNS embed the base graph's k0-core on ``device`` (walks and
    SGNS draw from torch generators, so the table matches the JAX package's
    in quality, not in bits).
    ``repair_policy`` selects the block-repair decision rule (``adaptive``
    measured crossover / ``region`` legacy static trigger / ``fallback``
    always re-peel). Ingest is serial: there is no pipelined variant.
    """
    device = resolve_device(device)
    base_edges, stream_edges = _split_stream(g, stream_frac, seed)
    # nodes that only appear in the stream are the future cold-start users
    base = DynamicGraph(g.n_nodes, base_edges, width=16, device=device)
    base_graph = base.snapshot()
    core = core_numbers_host(base_graph)
    k0 = max(2, int(round(degeneracy(core) * k0_frac)))
    k0 = min(k0, degeneracy(core))

    in_core = core >= k0
    if train:
        emb = embed_graph(
            base_graph,
            EmbedConfig(
                method="corewalk",
                k0=k0,
                sgns=SGNSConfig(dim=dim, impl="auto", seed=seed),
                prop_iters=prop_iters,
                seed=seed,
                device=str(device),
            ),
        ).embeddings
    else:
        rng = np.random.default_rng(seed)
        emb = np.zeros((g.n_nodes, dim), np.float32)
        emb[in_core] = rng.normal(size=(int(in_core.sum()), dim)).astype(
            np.float32
        ) / np.sqrt(dim)
        emb = propagate(base_graph, core, k0, emb, n_iters=prop_iters)

    # store every base node the offline pass embedded (the paper's batch
    # output); capacity < n exercises LRU eviction + host spillover
    served = np.where(base_graph.degrees() > 0)[0]
    cap = capacity if capacity > 0 else g.n_nodes
    store = EmbeddingStore(
        capacity=cap, dim=dim, node_cap=base.node_cap, device=device
    )
    store.put_many(served, emb[served], core[served])

    inc = IncrementalCore(
        base, core, repair_policy=repair_policy,
        crossover_margin=crossover_margin,
        cold_cells_per_arc=cold_cells_per_arc,
    )
    inc.mark_refresh()
    svc = EmbeddingService(
        base, inc, store, batch=batch, compact_every=compact_every, k0=k0,
        retrain_threshold=retrain_threshold,
    )
    return svc, stream_edges, core, k0


def _refuse(ap, args) -> None:
    """Flags of the JAX launcher that this port does not implement yet."""
    for flag, on in (
        ("--retrain", args.retrain),
        ("--wal-dir", args.wal_dir), ("--fault-plan", args.fault_plan),
        ("--jax-profile", args.jax_profile), ("--shards", args.shards != 1),
    ):
        if on:
            ap.error(f"{flag} is not implemented in the PyTorch port yet "
                     "(retraining, crash safety, profiling and sharding "
                     "come in later slices)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="synthetic",
                    help="synthetic | " + " | ".join(sorted(datasets.DATASETS)))
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--stream-frac", type=float, default=0.15)
    ap.add_argument("--k0-frac", type=float, default=0.5)
    ap.add_argument("--capacity", type=int, default=0,
                    help="store capacity (0 = all nodes)")
    ap.add_argument("--compact-every", type=int, default=512)
    ap.add_argument("--block-size", type=int, default=256,
                    help="edges per ingest block (1 = per-edge baseline)")
    ap.add_argument("--churn", type=float, default=0.0,
                    help="fraction of each block re-drawn as deletions of "
                         "previously streamed edges")
    not_yet = "not in the PyTorch port yet (refused)"
    ap.add_argument("--shards", type=int, default=1,
                    help=f"row-shard across N devices: {not_yet} above 1")
    ap.add_argument("--train", action="store_true",
                    help="real CoreWalk+SGNS base embeddings (slower)")
    ap.add_argument("--retrain", action="store_true",
                    help=f"drift-triggered retraining loop: {not_yet}")
    ap.add_argument("--retrain-threshold", type=float, default=0.1,
                    help="k0-core membership drift fraction reported as "
                         "retrain pressure")
    ap.add_argument("--repair-policy", default="adaptive",
                    choices=["adaptive", "region", "fallback"],
                    help="block core-repair decision rule: adaptive = "
                         "measured descend-vs-repeel crossover (default), "
                         "region = legacy static candidate-region trigger, "
                         "fallback = always re-peel")
    ap.add_argument("--crossover-margin", type=float, default=1.0,
                    help="adaptive policy prefers the fused descent while "
                         "predicted descend cost <= margin * repeel cost")
    ap.add_argument("--cold-cells-per-arc", type=float, default=32.0,
                    help="cold-start shape heuristic: descend while padded "
                         "cells <= this many per affected-shell arc")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="serial block ingest: accepted for the JAX "
                         "launcher's sake, the port's only ingest path")
    ap.add_argument("--verify", action="store_true",
                    help="assert incremental cores match the oracle at the end")
    ap.add_argument("--score-frac", type=float, default=0.3,
                    help="fraction of requests that are link-score pairs")
    ap.add_argument("--topk", type=int, default=0, metavar="K",
                    help="also replay top_k_neighbors retrieval traffic "
                         "with this k (0 = off): per-call "
                         "p50/p99 through the streaming top-k kernel")
    ap.add_argument("--warmup", type=int, default=2,
                    help="untimed warmup batches")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="record nested spans for the whole run and write a "
                         "Chrome trace_event JSON loadable in "
                         "chrome://tracing / Perfetto")
    ap.add_argument("--metrics-out", metavar="PATH", default=None,
                    help="write the metrics registry as a JSON snapshot, "
                         "plus a Prometheus text sibling (.prom)")
    ap.add_argument("--jax-profile", metavar="DIR", default=None,
                    help=f"device trace of the ingest phase: {not_yet}")
    ap.add_argument("--wal-dir", metavar="DIR", default=None,
                    help=f"write-ahead log + snapshots: {not_yet}")
    ap.add_argument("--fault-plan", metavar="SPEC", default=None,
                    help=f"deterministic fault injection: {not_yet}")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the hand-written kernels) or "
                         "cpu (their plain versions)")
    args = ap.parse_args(argv)
    _refuse(ap, args)

    if args.trace:
        obs.enable()

    g = _load_graph(args.dataset, args.seed)
    print(f"[serve-embed] {args.dataset}: {g.n_nodes} nodes, {g.n_edges} edges")
    svc, stream_edges, core0, k0 = build_service(
        g,
        stream_frac=args.stream_frac,
        k0_frac=args.k0_frac,
        dim=args.dim,
        batch=args.batch,
        capacity=args.capacity,
        compact_every=args.compact_every,
        seed=args.seed,
        train=args.train,
        retrain_threshold=args.retrain_threshold,
        repair_policy=args.repair_policy,
        crossover_margin=args.crossover_margin,
        cold_cells_per_arc=args.cold_cells_per_arc,
        device=args.device,
    )
    print(f"[serve-embed] base: {svc.graph.n_edges} edges, k0={k0}, "
          f"store {svc.store.resident}/{svc.store.capacity} resident")

    # --- ingest the stream in blocks, with churn (deletions of streamed
    # edges) interleaved, periodic compaction + oracle verification
    t0 = time.perf_counter()
    n_in, n_out = svc.stream_with_churn(
        stream_edges,
        block_size=args.block_size,
        churn=args.churn,
        rng=np.random.default_rng(args.seed + 2),
    )
    t_ingest = time.perf_counter() - t0
    mismatches = svc.cores.resync()  # oracle check (exactness expected)
    eps = (n_in + n_out) / max(t_ingest, 1e-9)
    print(f"[serve-embed] ingested {n_in} edges (+{n_out} retracted) in "
          f"{t_ingest:.2f}s ({eps:.0f} edges/s, blocks of "
          f"{args.block_size}), {svc.stats.compactions} compactions, "
          f"{svc.cores.repeels} re-peels, core mismatches vs oracle: "
          f"{mismatches}")
    phases = "  ".join(
        f"{k} {v['seconds'] * 1e3:.0f}ms[{v['impl']}]"
        for k, v in svc.cores.phase_report().items()
    )
    if phases:
        print(f"[serve-embed] repair phases: {phases} "
              f"({svc.cores.descends} fused descents, "
              f"{svc.cores.sweeps} sweeps)")
    pol = svc.cores.policy_report()
    print(f"[serve-embed] repair policy[{pol['mode']}]: "
          f"decisions {pol['decisions']} (cold {pol['cold_decisions']}), "
          f"shell re-peels {pol['shell_repeel']['count']} "
          f"(widened {pol['shell_repeel']['widens']}, mean frac peeled "
          f"{pol['shell_repeel']['mean_frac_peeled']})")
    if args.verify and mismatches:
        raise SystemExit(f"incremental core drifted from oracle: {mismatches}")
    # --- synthetic traffic: embeds over old+new nodes, plus link scores
    rng = np.random.default_rng(args.seed + 1)
    n_now = svc.graph.n_nodes

    for _ in range(args.warmup):  # untimed warmup batches
        svc.embed(rng.integers(0, n_now, size=args.batch))
    st0 = svc.stats
    svc.stats = ServiceStats(
        edges_ingested=st0.edges_ingested, compactions=st0.compactions,
    )

    n_scores = int(round(args.requests * args.score_frac))
    n_embeds = args.requests - n_scores
    t0 = time.perf_counter()
    for start in range(0, n_embeds, args.batch):
        n = min(args.batch, n_embeds - start)
        svc.embed(rng.integers(0, n_now, size=n))
    if n_scores:
        pairs = rng.integers(0, n_now, size=(n_scores, 2))
        svc.link_scores(pairs)
    t_query = time.perf_counter() - t0

    p50, p99 = svc.latency_percentiles()
    st = svc.stats
    qps = st.queries / max(t_query, 1e-9)
    print(f"[serve-embed] served {st.queries} queries in {st.flushes} "
          f"static batches of {args.batch}")
    print(f"[serve-embed] p50 {p50 * 1e3:.2f} ms  p99 {p99 * 1e3:.2f} ms  "
          f"per flush; {qps:.0f} queries/s")
    print(f"[serve-embed] cold-start {st.cold_fraction * 100:.1f}%  "
          f"unresolved {st.unresolved}  store hits {st.store_hits}  "
          f"evictions {svc.store.evictions}  spilled {svc.store.spilled}")

    # --- top-k retrieval traffic (the device-resident query engine's
    # second endpoint: blockwise score+reduce over the resident table)
    if args.topk > 0:
        svc.top_k_neighbors(rng.integers(0, n_now, size=args.batch),
                            args.topk)  # untimed warmup
        svc.stats.topk_seconds.clear()
        t0 = time.perf_counter()
        n_topk = 0
        for start in range(0, args.requests, args.batch):
            n = min(args.batch, args.requests - start)
            ids, _ = svc.top_k_neighbors(
                rng.integers(0, n_now, size=n), args.topk
            )
            n_topk += n
        t_topk = time.perf_counter() - t0
        tp50, tp99 = svc.topk_latency_percentiles()
        print(f"[serve-embed] top-{args.topk}: {n_topk} queries, "
              f"p50 {tp50 * 1e3:.2f} ms  p99 {tp99 * 1e3:.2f} ms per call; "
              f"{n_topk / max(t_topk, 1e-9):.0f} queries/s over "
              f"{svc.store.resident} resident rows")
    print(f"[serve-embed] staleness {svc.store.staleness(svc.cores.core):.3f}  "
          f"retrain pressure {svc.retrain_pressure():.3f} "
          f"(threshold {svc.retrain_threshold}, "
          f"retrain={'yes' if svc.should_retrain() else 'no'})")

    if args.metrics_out:
        svc.publish_metrics()
        reg = metrics()
        reg.export_json(args.metrics_out)
        prom = args.metrics_out.rsplit(".", 1)[0] + ".prom"
        reg.export_prometheus(prom)
        print(f"[serve-embed] metrics snapshot: {args.metrics_out} "
              f"(+ {prom})")
    if args.trace:
        t = obs.tracer()
        t.export_chrome(args.trace)
        names = sorted(t.span_names())
        print(f"[serve-embed] trace: {len(t.events)} spans "
              f"({len(names)} kinds: {', '.join(names)}) -> {args.trace}"
              + (f" [{t.dropped} dropped]" if t.dropped else ""))
    return st.queries


if __name__ == "__main__":
    main()
