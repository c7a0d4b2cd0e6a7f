"""The port's serving stack against the JAX package's, on identical inputs.

Both packages build the service from the same graph and seed (the stream
split, the k0-core table and the churn are all numpy ``default_rng``), are
driven through the same blocks, and must agree: core numbers exactly after
every block, embeddings and link scores within 1e-5 (fp32 means summed in
another order), top-k ids equal except at near-tied scores. The same holds
after the JAX package's state is carried over with ``from_jax_state``. The
single-edge and reporting helpers (``IncrementalCore.drift`` /
``reset_phases`` / ``on_edge``, the store's ``put`` / ``in`` /
``slot_table`` / ``candidate_bias``, the graph's ``add_edge`` /
``remove_edge`` / ``has_edge`` / ``degree`` / ``needs_compact``) give the
JAX package's answers on the same streams.
"""
import json

import numpy as np
import pytest
import torch

import repro.serve as jserve
from repro.core.kcore import core_numbers_host as j_core_numbers_host
from repro.launch import serve_embed as jlaunch
from repro_torch.core.kcore import core_numbers_host
from repro_torch.graph import datasets, generators
from repro_torch.launch import serve_embed
from repro_torch.serve import (
    DynamicGraph,
    EmbeddingService,
    EmbeddingStore,
    IncrementalCore,
    from_jax_state,
)

TIE = 1e-6


def lockstep(svcs, stream, block_size, churn, seed):
    """Drive services through the same blocks and churn (the loop of
    ``stream_with_churn``), asserting equal cores after every block."""
    rng = np.random.default_rng(seed)
    live = []
    for start in range(0, len(stream), block_size):
        block = stream[start:start + block_size]
        acc = [s.ingest_block(block) for s in svcs]
        for a in acc[1:]:
            np.testing.assert_array_equal(a, acc[0])
        live.extend(map(tuple, acc[0]))
        n_churn = min(int(round(churn * len(block))), len(live))
        if n_churn:
            pick = rng.choice(len(live), size=n_churn, replace=False)
            gone = set(pick.tolist())
            drop = np.array([live[i] for i in pick])
            removed = [s.retract_block(drop) for s in svcs]
            assert len(set(removed)) == 1
            live = [e for i, e in enumerate(live) if i not in gone]
        cores = [np.asarray(s.cores.core) for s in svcs]
        for c in cores[1:]:
            np.testing.assert_array_equal(c, cores[0])
    for s in svcs:
        if isinstance(s, jserve.EmbeddingService):
            s.sync()  # the JAX service lands its pipelined per-block tail


def assert_ids_agree_off_near_ties(ids, want_ids, want_scores):
    """``ids`` (Q, k) equal ``want_ids[:, :k]`` except where the wanted
    score is within TIE of a neighbour's (``want_*`` may be longer than k,
    so ties across the k-th position count)."""
    k = ids.shape[1]
    with np.errstate(invalid="ignore"):  # -inf padding
        gap = np.abs(np.diff(want_scores, axis=1)) <= TIE
    near = np.zeros(want_scores.shape, bool)
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    assert not ((ids != want_ids[:, :k]) & ~near[:, :k]).any()


def _counts(svc):
    return svc.stats.queries, svc.stats.cold_starts, svc.stats.unresolved


def assert_queries_agree(svc, jsvc, seed):
    before = np.subtract(_counts(svc), _counts(jsvc))
    rng = np.random.default_rng(seed)
    nodes = rng.integers(0, svc.graph.n_nodes, 40)
    np.testing.assert_allclose(svc.embed(nodes), jsvc.embed(nodes),
                               rtol=1e-5, atol=1e-5)
    pairs = rng.integers(0, svc.graph.n_nodes, (30, 2))
    np.testing.assert_allclose(svc.link_scores(pairs),
                               jsvc.link_scores(pairs), rtol=1e-5, atol=1e-5)
    ids, scores = svc.top_k_neighbors(nodes, 8)
    # one more from the reference, so a tie between the 8th and the 9th
    # (which either side may break its own way) shows as a near-tie
    jids, jscores = jsvc.top_k_neighbors(nodes, 9)
    np.testing.assert_allclose(scores, jscores[:, :8], rtol=1e-5, atol=1e-5)
    assert_ids_agree_off_near_ties(ids, jids, jscores)
    # the same queries, cold starts and unresolved rows on both sides
    np.testing.assert_array_equal(
        np.subtract(_counts(svc), _counts(jsvc)), before)


@pytest.mark.parametrize("seed,jax_pipeline,pipeline", [
    pytest.param(0, True, False, id="0-True"),
    pytest.param(1, False, False, id="1-False"),
    pytest.param(0, True, True, id="0-True-pipelined"),
    pytest.param(1, False, True, id="1-False-pipelined"),
])
def test_service_matches_jax_package(seed, jax_pipeline, pipeline):
    """The port's serial and pipelined ingest against the JAX package's
    pipelined and serial ingest (all bit-identical to each other)."""
    g = generators.barabasi_albert_varying(300, 4.0, seed=seed)
    kw = dict(stream_frac=0.3, dim=16, batch=16, seed=seed)
    svc, stream, core, k0 = serve_embed.build_service(
        g, pipeline=pipeline, device="cpu", **kw)
    assert svc.pipeline == pipeline
    jsvc, jstream, jcore, jk0 = jlaunch.build_service(
        g, pipeline=jax_pipeline, **kw)
    np.testing.assert_array_equal(stream, jstream)
    np.testing.assert_array_equal(core, jcore)
    assert k0 == jk0
    np.testing.assert_array_equal(svc.store.table().numpy(),
                                  np.asarray(jsvc.store.table()))
    lockstep([svc, jsvc], stream, 24, 0.1, seed + 2)
    assert svc.cores.resync() == 0
    assert svc.graph.n_edges == jsvc.graph.n_edges
    assert_queries_agree(svc, jsvc, seed + 3)
    assert svc.retrain_pressure() == pytest.approx(jsvc.retrain_pressure())


def test_from_jax_state_serves_like_the_jax_package():
    g = generators.barabasi_albert_varying(300, 4.0, seed=3)
    jsvc, stream, _, k0 = jlaunch.build_service(g, stream_frac=0.3, dim=16,
                                                batch=16, seed=3)
    half = len(stream) // 2
    lockstep([jsvc], stream[:half], 24, 0.1, 4)
    jsvc.embed(np.arange(0, 300, 7))  # cold-start write-backs into the store
    graph, store, cores = from_jax_state(
        jsvc.graph.state_dict(), jsvc.store.state_dict(), jsvc.cores.core,
        device="cpu",
    )
    svc = EmbeddingService(graph, cores, store, batch=16, compact_every=512,
                           k0=k0)
    for key, val in jsvc.graph.state_dict().items():
        np.testing.assert_array_equal(graph.state_dict()[key], val)
    for key, val in jsvc.store.state_dict().items():
        np.testing.assert_array_equal(store.state_dict()[key], val)
    np.testing.assert_array_equal(graph.ell().neighbours.numpy(),
                                  np.asarray(jsvc.graph.ell().neighbours))
    assert_queries_agree(svc, jsvc, 5)
    lockstep([svc, jsvc], stream[half:], 24, 0.1, 6)
    assert_queries_agree(svc, jsvc, 7)


MODES = [
    dict(),  # the CPU choices: np regions, count sweeps, shell re-peels
    dict(region_impl="jit", repeel_impl="descend"),  # the CUDA choices
    dict(region_impl="jit", repeel_impl="descend", kernel_impl="ref"),
    dict(repair_policy="fallback", repeel_impl="rounds"),
    dict(repair_policy="region", descend_budget=1 << 12),
    dict(impl="ref"),
]


@pytest.mark.parametrize("mode", range(len(MODES)))
def test_incremental_cores_stay_exact_in_every_mode(mode):
    """Each repair path, including the ones the card takes, keeps the
    cores equal to the peeling oracle under inserts, deletes and churn."""
    g = generators.barabasi_albert_varying(400, 5.0, seed=mode)
    edges = g.edge_list()
    edges = edges[np.random.default_rng(mode).permutation(len(edges))]
    base = len(edges) // 2
    dyn = DynamicGraph(g.n_nodes, edges[:base], width=4, device="cpu")
    inc = IncrementalCore(dyn, **MODES[mode])
    rng = np.random.default_rng(mode + 10)
    for start in range(base, len(edges), 40):
        acc = dyn.add_edges(edges[start:start + 40])
        inc.on_edge_block(acc)
        live = dyn.arc_arrays()
        pick = rng.choice(len(live[0]), size=6, replace=False)
        gone = dyn.remove_edges(np.stack([live[0][pick], live[1][pick]], 1))
        inc.on_remove(gone)
        np.testing.assert_array_equal(
            inc.core, core_numbers_host(dyn.snapshot()))
    if mode in (1, 2):
        assert inc.phase_impl["region"] == "jit"
    assert inc.resync() == 0


def test_dynamic_graph_and_mirror_match_jax():
    rng = np.random.default_rng(0)
    dyn = DynamicGraph(50, width=3, device="cpu")
    jdyn = jserve.DynamicGraph(50, width=3)
    for step in range(12):
        block = rng.integers(0, 70, (25, 2))
        np.testing.assert_array_equal(dyn.add_edges(block),
                                      jdyn.add_edges(block))
        dyn.ell()
        drop = rng.integers(0, 70, (10, 2))
        np.testing.assert_array_equal(dyn.remove_edges(drop),
                                      jdyn.remove_edges(drop))
        if step % 4 == 3:
            dyn.compact()
            jdyn.compact()
        ell, jell = dyn.ell(), jdyn.ell()
        np.testing.assert_array_equal(ell.neighbours.numpy(),
                                      np.asarray(jell.neighbours))
        np.testing.assert_array_equal(ell.degrees.numpy(),
                                      np.asarray(jell.degrees))
    for key, val in jdyn.state_dict().items():
        np.testing.assert_array_equal(dyn.state_dict()[key], val)
    back = DynamicGraph.from_state(dyn.state_dict(), device="cpu")
    np.testing.assert_array_equal(back.ell().neighbours.numpy(),
                                  dyn.ell().neighbours.numpy())
    np.testing.assert_array_equal(
        j_core_numbers_host(jdyn.snapshot()),
        core_numbers_host(back.snapshot()),
    )


def test_store_eviction_spill_and_state_match_jax():
    rng = np.random.default_rng(1)
    st = EmbeddingStore(8, 4, 30, device="cpu")
    jst = jserve.EmbeddingStore(8, 4, 30)
    for _ in range(6):
        nodes = rng.choice(30, 5, replace=False)
        vecs = rng.normal(size=(5, 4)).astype(np.float32)
        cores = rng.integers(0, 5, 5)
        st.put_many(nodes, vecs, cores)
        jst.put_many(nodes, vecs, cores)
        ask = rng.integers(0, 32, 6)
        v, f = st.gather(ask)
        jv, jf = jst.gather(ask)
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(np.asarray(v), np.asarray(jv))
    assert st.evictions == jst.evictions > 0
    for key, val in jst.state_dict().items():
        np.testing.assert_array_equal(st.state_dict()[key], val)
    back = EmbeddingStore.from_state(st.state_dict(), device="cpu")
    np.testing.assert_array_equal(back.table().numpy(), st.table().numpy())
    assert back.staleness(np.zeros(30, np.int32)) == pytest.approx(
        jst.staleness(np.zeros(30, np.int32)))


def test_launcher_runs_on_cpu_and_refuses_unported_flags(capsys, tmp_path):
    """The plain run, serial (``--no-pipeline``) and pipelined (the
    default); ``--retrain`` (drift-triggered retrains, cores still exact);
    ``--wal-dir`` with an injected crash (a recovery report, 0
    mismatches); and ``--jax-profile`` refused, as is a shard count that
    is not a power of two (``--shards`` itself is ported)."""
    plain = ["--device", "cpu", "--dataset", "tiny", "--requests", "32",
             "--block-size", "16", "--churn", "0.1", "--topk", "4",
             "--verify", "--batch", "16"]
    n = serve_embed.main([*plain, "--no-pipeline"])
    assert n > 0
    out = capsys.readouterr().out
    assert "core mismatches vs oracle: 0" in out and "top-4" in out
    assert "ingest serial" in out
    assert serve_embed.main(plain) == n
    out = capsys.readouterr().out
    assert "core mismatches vs oracle: 0" in out and "top-4" in out
    assert "ingest pipelined" in out
    stream = ["--device", "cpu", "--dataset", "tiny", "--requests", "32",
              "--block-size", "8", "--stream-frac", "0.5", "--churn", "0.25",
              "--batch", "16", "--dim", "16", "--verify"]
    assert serve_embed.main([*stream, "--retrain", "--retrain-threshold",
                             "0.05", "--retrain-budget", "2"]) > 0
    out = capsys.readouterr().out
    assert "core mismatches vs oracle: 0" in out
    retrains = int(out.split("retraining loop: ")[1].split()[0])
    assert 0 < retrains <= 2
    wal = str(tmp_path / "wal")
    assert serve_embed.main([*stream, "--wal-dir", wal, "--snapshot-every",
                             "4", "--fault-plan", "ingest_apply:6:crash"]) > 0
    out = capsys.readouterr().out
    assert "CRASH injected" in out and "recovered: snapshot@wal_seq 4 + 2 " \
        "replayed records" in out
    assert "core mismatches vs oracle: 0" in out
    assert "recovered after injected crash" in out
    for flags, says in ((["--jax-profile", "x"], "profiles with --profile"),
                        (["--shards", "3"], "power of two")):
        with pytest.raises(SystemExit):
            serve_embed.main(["--device", "cpu", "--dataset", "tiny", *flags])
        assert says in capsys.readouterr().err


def test_launcher_profiles_the_ingest_and_exports_metrics(capsys, tmp_path):
    """``--profile DIR`` writes a ``torch.profiler`` Chrome trace of the
    ingest window (the repair's spans in it) and prints where;
    ``--metrics-out`` writes the registry (with no card, ``record_memory``
    adds no device gauge)."""
    prof, out_json = tmp_path / "prof", tmp_path / "m.json"
    assert serve_embed.main(["--device", "cpu", "--dataset", "tiny",
                             "--requests", "32", "--block-size", "16",
                             "--churn", "0.1", "--batch", "16", "--verify",
                             "--profile", str(prof),
                             "--metrics-out", str(out_json)]) > 0
    out = capsys.readouterr().out
    traces = list(prof.iterdir())
    assert len(traces) == 1
    assert f"profile: captured to {traces[0]}" in out
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::index" for e in events)
    snap = json.loads(out_json.read_text())
    assert snap["serve_queries"]["series"][0]["value"] > 0
    assert ("device_bytes_in_use" in snap) == torch.cuda.is_available()


def _cores_without(dyn_cls, inc_cls, g, stream, **kw):
    """A DynamicGraph (``dyn_cls``) + IncrementalCore (``inc_cls``) on g's
    edges less ``stream``."""
    streamed = set(map(tuple, stream.tolist()))
    edges = g.edge_list()
    base = edges[[tuple(e) not in streamed for e in edges.tolist()]]
    dyn = dyn_cls(g.n_nodes, base, width=6, **kw)
    return dyn, inc_cls(dyn)


def test_repair_helpers_match_jax():
    """One churned stream through both packages' repair layer: ``drift()``
    after ``mark_refresh`` and more blocks, ``reset_phases()`` emptying
    ``phase_report()``, and the per-edge ``on_edge`` repair, cores equal to
    the JAX package's after each edge."""
    g = generators.barabasi_albert_varying(300, 4.0, seed=8)
    edges = g.edge_list()
    stream = edges[np.random.default_rng(8).permutation(len(edges))[:400]]
    dyn, inc = _cores_without(DynamicGraph, IncrementalCore, g, stream,
                              device="cpu")
    jdyn, jinc = _cores_without(jserve.DynamicGraph, jserve.IncrementalCore,
                                g, stream)
    rng = np.random.default_rng(9)
    for start in range(0, 160, 20):
        if start == 80:
            inc.mark_refresh()
            jinc.mark_refresh()
            assert inc.drift() == jinc.drift() == 0
        acc = dyn.add_edges(stream[start:start + 20])
        np.testing.assert_array_equal(acc, jdyn.add_edges(
            stream[start:start + 20]))
        inc.on_edge_block(acc)
        jinc.on_edge_block(acc)
        live = dyn.arc_arrays()
        pick = rng.choice(len(live[0]), size=4, replace=False)
        drop = np.stack([live[0][pick], live[1][pick]], 1)
        gone = dyn.remove_edges(drop)
        np.testing.assert_array_equal(gone, jdyn.remove_edges(drop))
        inc.on_remove(gone)
        jinc.on_remove(gone)
        assert inc.drift() == jinc.drift()
    assert inc.drift() > 0
    assert set(inc.phase_report()) and set(jinc.phase_report())
    inc.reset_phases()
    jinc.reset_phases()
    assert inc.phase_report() == jinc.phase_report() == {}
    promoted = 0
    for u, v in stream[160:]:
        added = dyn.add_edge(int(u), int(v))
        assert added == jdyn.add_edge(int(u), int(v))
        if added:
            got = inc.on_edge(int(u), int(v))
            assert got == jinc.on_edge(int(u), int(v))
            promoted += got
        np.testing.assert_array_equal(inc.core, np.asarray(jinc.core))
    np.testing.assert_array_equal(inc.core, core_numbers_host(dyn.snapshot()))
    assert promoted > 0 and set(inc.phase_report())


def test_store_helpers_match_jax():
    """``put`` (with evictions), ``in``, ``slot_table`` and
    ``candidate_bias`` of the two packages' stores, driven alike."""
    rng = np.random.default_rng(2)
    st = EmbeddingStore(6, 4, 20, device="cpu")
    jst = jserve.EmbeddingStore(6, 4, 20)
    for i in range(14):
        node = int(rng.integers(0, 20))
        vec = rng.normal(size=4).astype(np.float32)
        st.put(node, vec, i % 3)
        jst.put(node, vec, i % 3)
        for n in range(21):
            assert (n in st) == (n in jst)
        np.testing.assert_array_equal(st.slot_table(), jst.slot_table())
        np.testing.assert_array_equal(st.candidate_bias(),
                                      jst.candidate_bias())
    assert st.evictions == jst.evictions > 0 and st.spilled > 0
    assert st.candidate_bias().dtype == np.float32
    assert np.isneginf(st.candidate_bias()[-1])  # the zero sentinel row
    np.testing.assert_array_equal(st.table().numpy(), np.asarray(jst.table()))


def test_stream_helpers_match_jax():
    """``add_edge`` / ``remove_edge`` / ``has_edge`` / ``degree`` /
    ``needs_compact`` of both packages' graphs, through overflow (width 2)
    and a compaction."""
    rng = np.random.default_rng(3)
    dyn = DynamicGraph(20, width=2, device="cpu")
    jdyn = jserve.DynamicGraph(20, width=2)
    for step in range(120):
        u, v = (int(x) for x in rng.integers(0, 24, 2))
        if step % 3 == 2:
            assert dyn.remove_edge(u, v) == jdyn.remove_edge(u, v)
        else:
            assert dyn.add_edge(u, v) == jdyn.add_edge(u, v)
        assert dyn.needs_compact == jdyn.needs_compact
        if step == 80:
            assert dyn.needs_compact
            dyn.compact()
            jdyn.compact()
            assert not dyn.needs_compact
    assert dyn.node_cap == jdyn.node_cap
    for a in range(dyn.node_cap + 3):  # ids past node_cap have no edges
        if a < dyn.node_cap:
            assert dyn.degree(a) == jdyn.degree(a)
        for b in range(26):
            assert dyn.has_edge(a, b) == jdyn.has_edge(a, b)
    assert dyn.n_edges == jdyn.n_edges


def test_launcher_trains_the_base_on_cpu(capsys):
    """``--train``: CoreWalk + SGNS embed the base graph's k0-core (the JAX
    launcher's path), then the stream and the queries run as without it."""
    n = serve_embed.main(["--device", "cpu", "--dataset", "tiny", "--train",
                          "--requests", "32", "--block-size", "16",
                          "--verify", "--batch", "16", "--dim", "16"])
    assert n > 0
    assert "core mismatches vs oracle: 0" in capsys.readouterr().out
    g = datasets.load("tiny")
    svc, _, core, k0 = serve_embed.build_service(
        g, dim=16, batch=16, train=True, device="cpu")
    rows = np.where(core >= k0)[0]
    emb = svc.embed(rows)
    assert np.isfinite(emb).all() and (np.linalg.norm(emb, axis=1) > 0).all()


def test_entry_points_raise_when_cuda_is_absent():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: nothing to refuse")
    g = generators.barabasi_albert_varying(100, 3.0, seed=0)
    for make in (
        lambda: serve_embed.build_service(g),
        lambda: DynamicGraph(10),
        lambda: EmbeddingStore(4, 4, 10),
        lambda: serve_embed.main(["--dataset", "tiny"]),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_hub_row_of_width_65536_goes_through_the_descent(monkeypatch):
    """A hub of degree 33,048 (``generators.hub_with_cliques``: 33,000
    leaves and two 24-cliques) pads its row of the descent to W = 65,536,
    above the card's wide h-index kernel (the hub kernel's width). Inner
    edges are streamed in blocks with churn; the repair, pinned to the
    window descent (the region policy uncapped, no re-peel), keeps the
    cores equal to the peeling oracle and to the JAX package's after every
    block. The service's compaction would re-pack every row at 1.5x the
    hub's degree, so the repair layer is driven directly, in the loop of
    ``EmbeddingService.stream_with_churn``."""
    from repro_torch.serve import kcore_inc

    g, inner = generators.hub_with_cliques(33000, 2, 24, 500, seed=0)
    stream = inner[:120]
    streamed = set(map(tuple, stream.tolist()))
    edges = g.edge_list()
    base = edges[[tuple(e) not in streamed for e in edges.tolist()]]
    pin = dict(repair_policy="region", repeel_frac=1.0,
               descend_budget=1 << 62)
    dyn = DynamicGraph(g.n_nodes, base, width=16, device="cpu")
    jdyn = jserve.DynamicGraph(g.n_nodes, base, width=16)
    inc = IncrementalCore(dyn, **pin)
    jinc = jserve.IncrementalCore(jdyn, **pin)
    widths = []
    sweep = kcore_inc.kops.h_index_sweep

    def spy(values, valid, est, **kw):
        widths.append(values.shape[1])
        return sweep(values, valid, est, **kw)

    monkeypatch.setattr(kcore_inc.kops, "h_index_sweep", spy)
    rng = np.random.default_rng(1)
    live = []
    for start in range(0, len(stream), 30):
        block = stream[start:start + 30]
        acc = dyn.add_edges(block)
        np.testing.assert_array_equal(acc, jdyn.add_edges(block))
        inc.on_edge_block(acc)
        jinc.on_edge_block(acc)
        live.extend(map(tuple, acc))
        pick = rng.choice(len(live), size=3, replace=False)
        drop = np.array([live[i] for i in pick])
        gone = dyn.remove_edges(drop)
        np.testing.assert_array_equal(gone, jdyn.remove_edges(drop))
        inc.on_remove(gone)
        jinc.on_remove(gone)
        live = [e for i, e in enumerate(live) if i not in set(pick.tolist())]
        oracle = core_numbers_host(dyn.snapshot())
        np.testing.assert_array_equal(inc.core, oracle)
        np.testing.assert_array_equal(np.asarray(jinc.core), oracle)
    assert max(widths) == 65536 and int(dyn.degrees()[0]) > 32768
    assert inc.descends >= 8 and inc.repeels == 0
