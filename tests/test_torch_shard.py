"""Row-sharded serving of the port: ``--shards 8`` == ``--shards 1``.

The port's ``ShardPlan`` keeps one chunk of every node-indexed device array
per shard; here the 8 shards all lie on the CPU (``device="cpu"``), as the
JAX package's parity suite (``tests/multidevice/``) runs its 8 shards on
forced host devices. Sharding is placement only, so everything is held
**bit for bit** against the unsharded port: store tables and metadata, ELL
mirrors, cores, embeddings, link scores, top-k ids and scores, retrain
swaps, snapshots and recoveries. Against the JAX package at 8 shards: the
plan's arithmetic and ``merge_topk`` exactly, cores exactly, embeddings and
link scores within 1e-5 (fp32 means summed in another order), snapshot
payloads crossing between the packages byte for byte.

``tests/multidevice/test_pipeline_parity.py`` has its twin in
``tests/test_torch_pipelined_ingest.py``. The JAX package's top-k
shard-invariance test fails there (its sharded leg scores with an einsum + sort, its unsharded
one with the Pallas path); the port scores every leg with the one kernel,
and its invariance test below holds the scores bit-equal.
"""
import numpy as np
import pytest
import torch

import repro.serve as jserve
from repro.launch import serve_embed as jlaunch
from repro.serve import faults as jfaults
from repro.serve.recovery import capture_state as j_capture_state
from repro.serve.recovery import restore_service as j_restore_service
from repro_torch.core.kcore import core_numbers_host, degeneracy
from repro_torch.graph import generators
from repro_torch.kernels import ops
from repro_torch.launch import serve_embed
from repro_torch.obs import MetricsRegistry, set_metrics
from repro_torch.obs import metrics as get_metrics
from repro_torch.serve import (
    DynamicGraph,
    EmbeddingService,
    EmbeddingStore,
    IncrementalCore,
    RecoveryManager,
    RetrainConfig,
    Retrainer,
    ShardPlan,
    faults,
)
from repro_torch.serve.faults import FaultPlan, InjectedCrash
from repro_torch.serve.recovery import capture_state, restore_service
from repro_torch.serve.shard import (RowSharded, merge_topk, partial_topk,
                                    to_host)
from repro_torch.skipgram.trainer import SGNSConfig

N_SHARDS = 8
DIM = 8


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Several test workers share the cores: two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_leaked_fault_plan():
    faults.install(None)
    jfaults.install(None)
    yield
    faults.install(None)
    jfaults.install(None)


@pytest.fixture(scope="module")
def plan8():
    return ShardPlan.build(N_SHARDS, device="cpu")


@pytest.fixture(scope="module")
def jplan8():
    return jserve.ShardPlan.build(N_SHARDS)


def _diff(a, b):
    return [k for k in sorted(set(a) | set(b))
            if k not in a or k not in b or not np.array_equal(a[k], b[k])]


# ------------------------------------------------------------------ plan


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_plan_arithmetic_matches_jax(n_shards):
    plan = ShardPlan.build(n_shards, device="cpu")
    jplan = jserve.ShardPlan.build(n_shards)
    assert plan.enabled == jplan.enabled == (n_shards > 1)
    rng = np.random.default_rng(n_shards)
    for n_rows in (1, 5, 8, 37, 301, 1024):
        assert plan.pad_rows(n_rows) == jplan.pad_rows(n_rows)
        rows = rng.integers(0, n_rows, size=50)
        np.testing.assert_array_equal(plan.shard_of_rows(rows, n_rows),
                                      jplan.shard_of_rows(rows, n_rows))
        np.testing.assert_array_equal(plan.balance_of(rows, n_rows),
                                      jplan.balance_of(rows, n_rows))


def test_merge_topk_matches_jax_with_ties_and_padding():
    rng = np.random.default_rng(0)
    S, Q, kl = 4, 6, 5
    # few distinct scores (ties across shards), and dead tails
    vals = rng.integers(0, 4, size=(S, Q, kl)).astype(np.float32) / 4
    idx = rng.permutation(S * Q * kl).reshape(S, Q, kl).astype(np.int64)
    vals[:, :, 3:] = -np.inf
    idx[:, :, 3:] = -1
    vals[:, 0, :] = -np.inf  # a query with no live candidate at all
    idx[:, 0, :] = -1
    for k in (1, 7, S * kl + 3):
        got = merge_topk(vals, idx, k)
        want = jserve.ShardPlan.merge_topk(vals, idx, k)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_build_refuses_what_jax_refuses(monkeypatch):
    for bad in (3, 6):
        with pytest.raises(ValueError, match="power of two"):
            ShardPlan.build(bad, device="cpu")
        with pytest.raises(ValueError, match="power of two"):
            jserve.ShardPlan.build(bad)
    assert not ShardPlan.build(1, device="cpu").enabled
    assert ShardPlan.build(8, device="cpu") is ShardPlan.build(
        8, device="cpu")
    # more shards than visible cards: refused, naming the cards seen
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "Card X")
    with pytest.raises(ValueError, match=r"only 1 are visible.*Card X"):
        ShardPlan.build(2, device="cuda")
    # an explicit list may repeat a device
    plan = ShardPlan.build(4, devices=["cpu"] * 4)
    assert plan.devices == (torch.device("cpu"),) * 4


def test_place_rows_shards_or_refuses(plan8):
    reg = set_metrics(MetricsRegistry())
    try:
        x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
        sh = plan8.place_rows(x)
        assert isinstance(sh, RowSharded) and sh.chunk == 2
        assert sh.shape == (16, 3) and len(sh.chunks) == N_SHARDS
        np.testing.assert_array_equal(sh.to_host(), x)
        with pytest.raises(ValueError, match="not divisible.*pad_rows"):
            plan8.place_rows(x[:5])
        assert reg.sum_series("shard_row_placements_total") == 1
    finally:
        set_metrics(MetricsRegistry())


def test_traffic_counts_the_bytes_that_leave_a_shard(plan8):
    """Copies between a shard past the primary and the primary or the
    host count, per operation; shard 0's never do."""
    plan8.traffic.clear()
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    sh = plan8.place_rows(x)
    assert plan8.traffic == {"place": 14 * 3 * 4}
    plan8.traffic.clear()
    rows = torch.as_tensor([0, 1, 5, 5, 15])  # 2 rows on shard 0, 3 past
    np.testing.assert_array_equal(sh.gather(rows).numpy(), x[rows.numpy()])
    assert plan8.traffic == {"gather": 3 * (3 * 4 + 8)}  # row + its index
    sh.set_rows(torch.as_tensor([1, 9]), torch.zeros(2, 3))
    assert plan8.traffic["scatter"] == 3 * 4 + 8
    sh.set_cells(torch.as_tensor([0, 2]), torch.as_tensor([1, 1]),
                 torch.ones(2))
    assert plan8.traffic["scatter"] == 3 * 4 + 8 + 8 + 8 + 4
    plan8.replicate(np.zeros(10, np.int32))
    assert plan8.traffic["place"] == 7 * 10 * 4
    q = torch.ones(2, 3)
    partial_topk(q, sh, np.ones(16, bool), 1)
    # each past-primary shard: the queries out, (2, 1) f32 + i64 back
    assert plan8.traffic["topk"] == 7 * (2 * 3 * 4 + 2 * 4 + 2 * 8)
    plan8.traffic.clear()
    partial_topk(q, torch.as_tensor(x), np.ones(16, bool), 1)
    assert plan8.traffic == {}  # one chunk, no plan: nothing leaves


def test_row_sharded_reads_and_writes_match_numpy(plan8):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(24, 5)).astype(np.float32)
    y = rng.integers(0, 9, size=(24, 4)).astype(np.int32)
    z = rng.integers(0, 9, size=24).astype(np.int32)
    sx, sy, sz = (plan8.place_rows(a.copy()) for a in (x, y, z))
    rows = torch.as_tensor(rng.integers(0, 24, size=40))
    np.testing.assert_array_equal(sx.gather(rows).numpy(), x[rows.numpy()])
    np.testing.assert_array_equal(sx.gather(rows[:0]).numpy(), x[:0])
    w = torch.as_tensor(rng.permutation(24)[:10])
    vals = rng.normal(size=(10, 5)).astype(np.float32)
    sx.set_rows(w, torch.as_tensor(vals))
    x[w.numpy()] = vals
    np.testing.assert_array_equal(to_host(sx), x)
    cols = rng.integers(0, 4, size=10)
    cv = rng.integers(0, 9, size=10).astype(np.int32)
    sy.set_cells(w, torch.as_tensor(cols), torch.as_tensor(cv))
    y[w.numpy(), cols] = cv
    np.testing.assert_array_equal(sy.to_host(), y)
    sz.set_rows(w, torch.as_tensor(cv))  # rank 1
    z[w.numpy()] = cv
    np.testing.assert_array_equal(sz.to_host(), z)


# ----------------------------------------------------------------- store


def _store_pair(capacity, node_cap, plan):
    return (EmbeddingStore(capacity, DIM, node_cap, device="cpu"),
            EmbeddingStore(capacity, DIM, node_cap, plan=plan))


def _assert_store_equal(a, b):
    assert a.evictions == b.evictions
    assert a.spilled == b.spilled
    assert a.resident == b.resident
    assert a.version_counts() == b.version_counts()
    assert _diff(a.state_dict(), b.state_dict()) == []
    # the sharded table's padding rows never hold data
    ta, tb = (np.asarray(t) if isinstance(s, jserve.EmbeddingStore)
              else to_host(t) for s, t in ((a, a.table()), (b, b.table())))
    np.testing.assert_array_equal(ta, tb[: len(ta)])
    assert not tb[len(ta):].any()


def _store_stream(stores, seed, n_ops=120):
    """A seeded put / gather / promote / grow stream on every store,
    answers held equal."""
    rng = np.random.default_rng(seed)
    a = stores[0]
    for _ in range(n_ops):
        kind = int(rng.integers(0, 4))
        hi = a.node_cap + int(rng.integers(0, 5))
        if kind == 0:
            nodes = np.unique(rng.integers(0, hi, size=rng.integers(1, 5)))
            vecs = rng.normal(size=(len(nodes), DIM)).astype(np.float32)
            cores = rng.integers(0, 5, size=len(nodes)).astype(np.int32)
            for s in stores:
                s.put_many(nodes, vecs, cores)
        elif kind == 1:
            q = rng.integers(0, hi, size=rng.integers(1, 6))
            got = [s.gather(q) for s in stores]
            for v, f in got[1:]:
                np.testing.assert_array_equal(f, got[0][1])
                np.testing.assert_array_equal(np.asarray(v),
                                              np.asarray(got[0][0]))
        elif kind == 2:
            q = rng.integers(0, hi, size=rng.integers(1, 4))
            assert len({s.promote(q) for s in stores}) == 1
        else:
            grow = int(rng.integers(0, 2 * hi))
            for s in stores:
                s.ensure_nodes(grow)
        for s in stores[1:]:
            _assert_store_equal(a, s)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_store_stream_is_byte_equal_across_shard_counts(n_shards):
    """Capacity 6 (7 rows: padding at every count) under a random stream
    with evictions, spills and promotions."""
    plan = ShardPlan.build(n_shards, device="cpu")
    a, b = _store_pair(6, 8, plan)
    _store_stream([a, b], seed=n_shards)
    assert a.evictions > 0


def test_store_eviction_and_staleness_under_pressure(plan8):
    rng = np.random.default_rng(1)
    a, b = _store_pair(4, 16, plan8)
    cores = rng.integers(0, 6, size=64).astype(np.int32)
    for _ in range(40):
        nodes = rng.integers(0, 64, size=3)
        vecs = rng.normal(size=(3, DIM)).astype(np.float32)
        a.put_many(nodes, vecs, cores[nodes])
        b.put_many(nodes, vecs, cores[nodes])
        q = rng.integers(0, 64, size=4)
        (va, fa), (vb, fb) = a.gather(q), b.gather(q)
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))
        drift = cores + rng.integers(0, 2, size=64).astype(np.int32)
        assert a.staleness(drift) == b.staleness(drift)
    _assert_store_equal(a, b)
    assert a.evictions > 0 and a.spilled > 0


def test_store_shard_report_matches_jax(plan8, jplan8):
    """The same stream through the port's and the JAX package's 8-shard
    stores: equal state and equal shard reports."""
    port = EmbeddingStore(16, DIM, 32, plan=plan8)
    jax_store = jserve.EmbeddingStore(capacity=16, dim=DIM, node_cap=32,
                                      plan=jplan8)
    assert port.shard_report()["imbalance"] == 0.0
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(16, DIM)).astype(np.float32)
    for s in (port, jax_store):
        s.put_many(np.arange(16), vecs, np.ones(16, np.int32))
    def jax_fields(rep):  # the port adds its own bytes moved
        assert set(rep.pop("moved_bytes")) >= {"total"}
        return rep

    assert jax_fields(port.shard_report()) == jax_store.shard_report()
    _store_stream([port, jax_store], seed=4, n_ops=60)
    assert jax_fields(port.shard_report()) == jax_store.shard_report()
    rep = port.shard_report()
    assert rep["n_shards"] == 8 and sum(rep["gather_rows_per_shard"]) > 0
    assert rep["cross_shard_row_copies"] == 7 * sum(
        rep["gather_rows_per_shard"])
    moved = rep["moved_bytes"]
    assert moved["gather"] > 0 and moved["scatter"] > 0
    assert moved["total"] == sum(v for k, v in moved.items()
                                 if k != "total")
    port.reset_shard_traffic()
    rep = port.shard_report()
    assert rep["cross_shard_row_copies"] == 0
    assert rep["moved_bytes"] == {"total": 0}
    assert EmbeddingStore(4, DIM, 8, device="cpu").shard_report() == {
        "n_shards": 1, "resident_per_shard": [0], "imbalance": 0.0}


# ------------------------------------------------------- mirror, repair


def _mirror_equal(d1, d8):
    e1, e8 = d1.ell(), d8.ell()
    n1 = d1.node_cap + 1
    nbr8, deg8 = to_host(e8.neighbours), to_host(e8.degrees)
    np.testing.assert_array_equal(e1.neighbours.numpy(), nbr8[:n1])
    np.testing.assert_array_equal(e1.degrees.numpy(), deg8[:n1])
    # shard-padding rows are pure sentinel
    assert (nbr8[n1:] == d8.node_cap).all()
    assert not deg8[n1:].any()


def _shuffled(n, m, seed):
    g = generators.barabasi_albert_varying(n, m, seed=seed)
    edges = g.edge_list()
    return g, edges[np.random.default_rng(seed + 1).permutation(len(edges))]


def test_mirror_parity_under_mixed_blocks_and_compaction(plan8):
    g, edges = _shuffled(120, 4.0, 3)
    d1 = DynamicGraph(g.n_nodes, width=3, device="cpu")
    d8 = DynamicGraph(g.n_nodes, width=3, plan=plan8)
    rng = np.random.default_rng(4)
    live = []
    for step, start in enumerate(range(0, len(edges), 24)):
        block = edges[start:start + 24]
        a1, a8 = d1.add_edges(block), d8.add_edges(block)
        np.testing.assert_array_equal(a1, a8)
        live.extend(map(tuple, a1))
        if step % 2 and len(live) > 8:
            pick = rng.choice(len(live), size=6, replace=False)
            rm = np.array([live[i] for i in pick])
            np.testing.assert_array_equal(d1.remove_edges(rm),
                                          d8.remove_edges(rm))
            gone = {tuple(e) for e in rm}
            live = [e for e in live if e not in gone]
        if step % 3 == 2:
            d1.compact()
            d8.compact()
        _mirror_equal(d1, d8)
        assert _diff(d1.state_dict(), d8.state_dict()) == []
    assert d8.compactions >= 2


@pytest.mark.parametrize("region_impl", ["np", "jit"])
def test_block_repair_parity_insert_delete_churn(plan8, jplan8, region_impl):
    """The sharded repair (host regions, and the device regions expanded
    per shard; the descent swept per shard) equals the unsharded port, the
    JAX package's 8-shard stack and the peeling oracle after every block."""
    g, edges = _shuffled(130, 4.0, 5)
    d1 = DynamicGraph(g.n_nodes, width=3, device="cpu")
    d8 = DynamicGraph(g.n_nodes, width=3, plan=plan8)
    j8 = jserve.DynamicGraph(g.n_nodes, width=3, plan=jplan8)
    i1 = IncrementalCore(d1)
    i8 = IncrementalCore(d8, region_impl=region_impl)
    ij = jserve.IncrementalCore(j8, region_impl=region_impl)
    rng = np.random.default_rng(6)
    live = []
    for step, start in enumerate(range(0, len(edges), 32)):
        block = edges[start:start + 32]
        acc = [d.add_edges(block) for d in (d1, d8, j8)]
        for inc, a in zip((i1, i8, ij), acc):
            inc.on_edge_block(a)
        live.extend(map(tuple, acc[0]))
        if step % 2 and len(live) > 8:
            pick = rng.choice(len(live), size=6, replace=False)
            rm = np.array([live[i] for i in pick])
            for d, inc in ((d1, i1), (d8, i8), (j8, ij)):
                inc.on_remove(d.remove_edges(rm))
            gone = {tuple(e) for e in rm}
            live = [e for e in live if e not in gone]
        if step % 3 == 2:
            for d in (d1, d8, j8):
                d.compact()
        np.testing.assert_array_equal(i1.core, i8.core)
        np.testing.assert_array_equal(i8.core, np.asarray(ij.core))
        np.testing.assert_array_equal(
            i8.core, core_numbers_host(d8.snapshot()))
    assert i8.promoted > 0 and i8.demoted > 0
    assert i8.descends > 0  # the sharded descent ran
    assert i8.resync() == 0


def test_sharded_fallback_repeel_stays_exact(plan8):
    g = generators.barabasi_albert_varying(400, 5.0, seed=7)
    d8 = DynamicGraph(g.n_nodes, width=4, plan=plan8)
    i8 = IncrementalCore(d8, repeel_frac=0.05, repair_policy="region")
    i8.on_edge_block(d8.add_edges(g.edge_list()))
    assert i8.repeels >= 1
    np.testing.assert_array_equal(i8.core, core_numbers_host(d8.snapshot()))


def test_descent_sweeps_every_shard_and_matches_one_shard(plan8):
    """The full-graph descent (the card's re-peel) at 8 shards: every
    h-index call at a chunk's rows, the cores equal to one shard's."""
    g = generators.barabasi_albert_varying(300, 4.0, seed=8)
    n = g.n_nodes
    got, shapes = [], []
    sweep = ops.h_index_sweep

    def tally(values, valid, est, **kw):
        shapes.append(tuple(values.shape))
        return sweep(values, valid, est, **kw)

    for plan in (None, plan8):
        d = DynamicGraph(n, g.edge_list(), width=8, plan=plan, device="cpu")
        inc = IncrementalCore(d, np.zeros(n, np.int32))
        deg = d.degrees_of(np.arange(n))
        shapes.clear()
        ops.h_index_sweep = tally
        try:
            pending = inc._descend_dispatch(
                np.arange(n, dtype=np.int64), deg, np.zeros(n, np.int32),
                0, 1 << 30, cand_deg=deg)
            res = inc._descend_read(pending)
        finally:
            ops.h_index_sweep = sweep
        out = np.zeros(n, np.int32)
        out[pending["cand"]] = res[0]
        got.append((out, list(shapes)))
    (c1, s1), (c8, s8) = got
    np.testing.assert_array_equal(c1, c8)
    np.testing.assert_array_equal(c1, core_numbers_host(g))
    # each unsharded call splits into 8 calls of an eighth of its rows
    assert len(s8) == 8 * len(s1)
    for i, (r, w) in enumerate(s1):
        assert s8[8 * i:8 * i + 8] == [(r // 8, w)] * 8


# --------------------------------------------------------------- service


def _service_pair(capacity=0, seed=0, n=400, jax=False):
    g = generators.barabasi_albert_varying(n, 5.0, seed=seed)
    kw = dict(seed=seed, batch=32, capacity=capacity, compact_every=128)
    s1, st1, c1, k1 = serve_embed.build_service(g, device="cpu", **kw)
    s8, st8, c8, k8 = serve_embed.build_service(g, device="cpu", shards=8,
                                                **kw)
    np.testing.assert_array_equal(st1, st8)
    np.testing.assert_array_equal(c1, c8)
    assert k1 == k8
    assert _diff(s1.store.state_dict(), s8.store.state_dict()) == []
    out = [s1, s8, st1]
    if jax:
        js, jst, _, _ = jlaunch.build_service(g, shards=8, pipeline=False,
                                              **kw)
        np.testing.assert_array_equal(st1, jst)
        out.append(js)
    return out


def _assert_services_equal(s1, s8):
    for k in ("queries", "store_hits", "cold_starts", "unresolved",
              "flushes", "edges_ingested", "edges_removed", "compactions"):
        assert getattr(s1.stats, k) == getattr(s8.stats, k), k
    np.testing.assert_array_equal(s1.cores.core, s8.cores.core)
    assert _diff(s1.store.state_dict(), s8.store.state_dict()) == []
    assert _diff(s1.graph.state_dict(), s8.graph.state_dict()) == []
    assert s1.store.staleness(s1.cores.core) == s8.store.staleness(
        s8.cores.core)
    assert s1.retrain_pressure() == s8.retrain_pressure()


def test_stream_then_query_matches_one_shard_and_jax():
    """Bit-equal to one shard; against the JAX package's 8-shard service:
    cores exact, embeddings and link scores within 1e-5."""
    s1, s8, stream, js = _service_pair(jax=True)
    runs = [s.stream_with_churn(stream, block_size=64, churn=0.2,
                                rng=np.random.default_rng(11))
            for s in (s1, s8, js)]
    assert runs[0] == runs[1] == runs[2]
    assert s8.cores.resync() == 0
    np.testing.assert_array_equal(s8.cores.core, np.asarray(js.cores.core))
    rng = np.random.default_rng(12)
    n_now = s1.graph.n_nodes
    for _ in range(6):
        q = rng.integers(0, n_now, size=24)
        o1, o8, oj = s1.embed(q), s8.embed(q), js.embed(q)
        np.testing.assert_array_equal(o1, o8)
        np.testing.assert_allclose(o8, oj, rtol=1e-5, atol=1e-5)
    pairs = rng.integers(0, n_now, size=(24, 2))
    l8 = s8.link_scores(pairs)
    np.testing.assert_array_equal(s1.link_scores(pairs), l8)
    np.testing.assert_allclose(l8, js.link_scores(pairs), rtol=1e-5,
                               atol=1e-5)
    _assert_services_equal(s1, s8)
    assert s8.stats.cold_starts == js.stats.cold_starts
    assert s8.store.evictions == js.store.evictions


def test_parity_under_capacity_pressure():
    s1, s8, stream = _service_pair(capacity=48, seed=1)
    assert s1.ingest_edges(stream, block_size=64) == s8.ingest_edges(
        stream, block_size=64)
    rng = np.random.default_rng(13)
    n_now = s1.graph.n_nodes
    for _ in range(8):
        q = rng.integers(0, n_now, size=32)
        np.testing.assert_array_equal(s1.embed(q), s8.embed(q))
    _assert_services_equal(s1, s8)
    assert s8.store.evictions > 0 and s8.store.spilled > 0


def test_link_scores_parity():
    s1, s8, stream = _service_pair(seed=2, n=200)
    s1.ingest_edges(stream, block_size=64)
    s8.ingest_edges(stream, block_size=64)
    pairs = np.random.default_rng(14).integers(0, s1.graph.n_nodes,
                                               size=(24, 2))
    np.testing.assert_array_equal(s1.link_scores(pairs),
                                  s8.link_scores(pairs))


# ----------------------------------------------------------------- top-k

K = 7


def _topk_service(shards, seed=0, n=300):
    g = generators.barabasi_albert_varying(n, 5.0, seed=seed)
    svc, stream, _, _ = serve_embed.build_service(
        g, seed=seed, batch=32, compact_every=128, shards=shards,
        device="cpu")
    svc.ingest_edges(stream, block_size=64)
    return svc


def _oracle(svc, q, k):
    """All-pairs cosine over resident rows in numpy, self-excluded,
    ordered by (score desc, slot asc)."""
    st = svc.store
    tab = to_host(st.table())[: st.capacity].astype(np.float64)
    valid = st.row_valid()[: st.capacity]
    tn = tab / np.maximum(np.linalg.norm(tab, axis=1, keepdims=True), 1e-9)
    qv = svc.embed(q).astype(np.float64)
    qn = qv / np.maximum(np.linalg.norm(qv, axis=1, keepdims=True), 1e-9)
    sim = qn @ tn.T
    sim[:, ~valid] = -np.inf
    own = st.slots_of(np.asarray(q, np.int64))
    ids = np.full((len(q), k), -1, np.int64)
    scores = np.full((len(q), k), -np.inf)
    for i in range(len(q)):
        s = sim[i].copy()
        if own[i] < st.capacity:
            s[own[i]] = -np.inf
        order = np.lexsort((np.arange(len(s)), -s))[:k]
        order = order[s[order] > -np.inf]
        ids[i, :len(order)] = st.node_of_slots(order)
        scores[i, :len(order)] = s[order]
    return ids, scores


def test_topk_shard_count_invariance():
    """Ids equal at 1, 2 and 8 shards, and the scores bit-equal: every
    shard scores its rows through the same kernel (the plain version
    here) as the unsharded table."""
    svcs = [_topk_service(s) for s in (1, 2, 8)]
    q = np.random.default_rng(21).integers(0, svcs[0].graph.n_nodes, 24)
    (i1, v1), *rest = [s.top_k_neighbors(q, K) for s in svcs]
    for ids, vals in rest:
        np.testing.assert_array_equal(i1, ids)
        np.testing.assert_array_equal(v1, vals)


@pytest.mark.parametrize("shards", [1, 8])
def test_topk_recall_is_exact_against_a_numpy_oracle(shards):
    svc = _topk_service(shards, seed=3)
    q = np.random.default_rng(22).integers(0, svc.graph.n_nodes, size=16)
    ids, scores = svc.top_k_neighbors(q, K)
    want_ids, want_scores = _oracle(svc, q, K)
    assert int((ids != want_ids).sum()) == 0
    np.testing.assert_allclose(scores, want_scores, rtol=1e-5, atol=1e-6)
    for i in range(len(q)):
        assert set(ids[i]) == set(want_ids[i])


def test_partial_topk_pads_dead_shards(plan8):
    """kl = min(k, chunk); a shard with no live row answers -inf / -1."""
    rng = np.random.default_rng(5)
    table = rng.normal(size=(16, 4)).astype(np.float32)
    valid = np.ones(16, bool)
    valid[4:6] = False  # shard 2 dead
    valid[7] = False
    q = torch.as_tensor(rng.normal(size=(3, 4)).astype(np.float32))
    v, i = partial_topk(q, plan8.place_rows(table), valid, 5)
    assert v.shape == i.shape == (8, 3, 2)
    assert (i[2] == -1).all() and np.isneginf(v[2]).all()
    assert (i[3, :, 1] == -1).all() and (i[3, :, 0] == 6).all()
    vals, idx = merge_topk(v, i, 5)
    want_v, want_i = ops.top_k_scores(q, torch.as_tensor(table), 5,
                                      valid=torch.as_tensor(valid))
    np.testing.assert_array_equal(idx, want_i.numpy())
    # the CPU's matmul rounds a (3, 2) product and a (3, 16) one apart
    np.testing.assert_allclose(vals, want_v.numpy(), rtol=1e-6)
    # one chunk (the unsharded table): the kernel's own list, padded to k
    v1, i1 = partial_topk(q, torch.as_tensor(table), valid, 20)
    assert v1.shape == (1, 3, 16)
    vals, idx = merge_topk(v1, i1, 20)
    want_v, want_i = ops.top_k_scores(q, torch.as_tensor(table), 20,
                                      valid=torch.as_tensor(valid))
    np.testing.assert_array_equal(vals, want_v.numpy())
    np.testing.assert_array_equal(idx, want_i.numpy())


# --------------------------------------------------------------- retrain


def _run_retrain(plan, *, capacity=None, seed=0, n=150):
    g = generators.barabasi_albert_varying(n, 4.0, seed=seed)
    edges = g.edge_list()
    perm = np.random.default_rng(seed).permutation(len(edges))
    base, stream = (edges[perm[len(edges) // 4:]],
                    edges[perm[: len(edges) // 4]])
    dyn = DynamicGraph(g.n_nodes, base, width=8, plan=plan, device="cpu")
    inc = IncrementalCore(dyn)
    store = EmbeddingStore(capacity or dyn.node_cap, DIM, dyn.node_cap,
                           plan=plan, device="cpu")
    emb = np.random.default_rng(seed + 1).normal(
        size=(g.n_nodes, DIM)).astype(np.float32)
    served = np.where(dyn.degrees() > 0)[0]
    store.put_many(served, emb[served], inc.core[served])
    k0 = max(2, degeneracy(inc.core) // 2)
    svc = EmbeddingService(dyn, inc, store, batch=16, k0=k0)
    inc.mark_refresh()
    svc.ingest_edges(stream, block_size=64)  # drives membership drift
    cfg = RetrainConfig(
        n_walks=3, walk_length=8, min_sgns_steps=5, prop_iters=4,
        swap_chunk=64, sgns=SGNSConfig(dim=DIM, epochs=0.05, impl="ref"),
    )
    svc.set_retrainer(Retrainer(svc, cfg))
    report = svc.maybe_retrain(force=True)
    assert report is not None
    return svc, report


@pytest.mark.parametrize("capacity,seed", [(None, 0), (48, 3)])
def test_retrain_swap_matches_unsharded(plan8, capacity, seed):
    """The swap writes through the store's shard-local scatter and reads
    previous vectors through ``peek_many``: the same report, store and
    served embeddings at 1 and 8 shards (capacity pressure included)."""
    svc1, rep1 = _run_retrain(None, capacity=capacity, seed=seed)
    svc8, rep8 = _run_retrain(plan8, capacity=capacity, seed=seed)
    for k in ("k0", "core_size", "anchors", "aligned", "version",
              "rows_swapped", "warm_rows", "sgns_steps", "n_walks"):
        assert getattr(rep1, k) == getattr(rep8, k), k
    assert rep1.align_residual == rep8.align_residual
    _assert_services_equal(svc1, svc8)
    if capacity:
        assert svc8.store.spilled > 0
    nodes = np.arange(svc1.graph.n_nodes)
    np.testing.assert_array_equal(svc1.embed(nodes), svc8.embed(nodes))


# -------------------------------------------------------------- recovery

REC_N, REC_SEED = 300, 5


def _rec_service(shards=1):
    g = generators.barabasi_albert_varying(REC_N, 4.0, seed=REC_SEED)
    svc, stream, _, _ = serve_embed.build_service(
        g, seed=REC_SEED, batch=16, stream_frac=0.4, compact_every=128,
        shards=shards, device="cpu")
    return svc, stream


def _rec_ops(stream, block=24):
    ops_, blocks = [], [np.asarray(stream[s:s + block], np.int64)
                        for s in range(0, len(stream), block)]
    for i, blk in enumerate(blocks):
        ops_.append(("ingest", blk))
        if i % 3 == 2:
            prev = blocks[i - 2]
            ops_.append(("retract", prev[: len(prev) // 2]))
    return ops_


def _apply(svc, ops_, start=0):
    for kind, blk in ops_[start:]:
        (svc.ingest_block if kind == "ingest" else svc.retract_block)(blk)
    svc.sync()


def _arrays(svc, capture=capture_state):
    return capture(svc, 0)[0]


def test_snapshot_restores_across_shard_counts(plan8):
    """8 -> 1 and 1 -> 8 byte-equal: the payload is placement-free; the
    restored services serve alike."""
    svc8, stream = _rec_service(shards=8)
    _apply(svc8, _rec_ops(stream))
    arrays8, manifest8 = capture_state(svc8, 0)
    svc1 = restore_service(arrays8, manifest8, device="cpu")
    assert svc1.store.plan is None
    assert _diff(arrays8, _arrays(svc1)) == []
    arrays1, manifest1 = capture_state(svc1, 0)
    svc8b = restore_service(arrays1, manifest1, plan=plan8)
    assert svc8b.store.plan is plan8 and svc8b.graph.plan is plan8
    assert _diff(arrays8, _arrays(svc8b)) == []
    q = np.arange(16)
    np.testing.assert_array_equal(svc1.embed(q), svc8b.embed(q))
    np.testing.assert_array_equal(svc1.embed(q), svc8.embed(q))


def test_sharded_crash_recovers_on_any_shard_count(tmp_path, plan8):
    """Crash at 8 shards; recover at 8 and at 1 from the same directory,
    resume; both equal the uninterrupted single-shard twin."""
    svc0, stream = _rec_service()
    ops_ = _rec_ops(stream)
    _apply(svc0, ops_)
    truth = _arrays(svc0)
    svc8, _ = _rec_service(shards=8)
    mgr = RecoveryManager(svc8, str(tmp_path), snapshot_every=3, fsync=False)
    faults.install(FaultPlan.parse("ingest_apply:6:crash"))
    with pytest.raises(InjectedCrash):
        _apply(svc8, ops_)
    faults.install(None)
    try:
        mgr.wait()
    except BaseException:
        pass
    mgr.wal.close()
    reports = []
    for plan in (plan8, None):
        r, m, report = RecoveryManager.recover(
            str(tmp_path), plan=plan, device="cpu", snapshot_every=1000,
            fsync=False)
        assert r.store.plan is plan
        reports.append(report["snapshot_wal_seq"])
        _apply(r, ops_, start=report["wal_seq"])
        assert _diff(truth, _arrays(r)) == []
        m.wal.close()
    assert reports[0] == reports[1]


def test_snapshot_payloads_cross_between_the_packages(plan8, jplan8):
    """A port payload taken at 8 shards restores in the JAX package with
    its 8-shard plan, and a JAX one taken at 8 shards restores in the port
    at 8 and at 1, each byte-equal."""
    svc8, stream = _rec_service(shards=8)
    g = generators.barabasi_albert_varying(REC_N, 4.0, seed=REC_SEED)
    js, jstream, _, _ = jlaunch.build_service(
        g, seed=REC_SEED, batch=16, stream_frac=0.4, compact_every=128,
        shards=8, pipeline=False)
    ops_ = _rec_ops(stream)
    _apply(svc8, ops_)
    _apply(js, ops_)
    arrays, manifest = capture_state(svc8, 0)
    jarrays, jmanifest = j_capture_state(js, 0)
    np.testing.assert_array_equal(arrays["core"], jarrays["core"])
    jr = j_restore_service(arrays, manifest, plan=jplan8)
    assert _diff(arrays, _arrays(jr, j_capture_state)) == []
    for plan in (plan8, None):
        pr = restore_service(jarrays, jmanifest, plan=plan, device="cpu")
        assert _diff(jarrays, _arrays(pr)) == []


# ------------------------------------------------------------------- obs

SEMANTIC_COUNTERS = [
    "serve_edges_ingested_total", "serve_edges_removed_total",
    "serve_queries_total", "serve_store_hits_total",
    "serve_cold_starts_total", "serve_unresolved_total",
    "graph_edges_added_total", "graph_edges_removed_total",
    "store_gather_requests_total", "store_gather_found_total",
    "store_rows_written_total", "store_evictions_total",
]


def _obs_run(shards, seed=0):
    reg = set_metrics(MetricsRegistry())
    g = generators.barabasi_albert_varying(400, 5.0, seed=seed)
    svc, stream, _, _ = serve_embed.build_service(
        g, seed=seed, batch=32, compact_every=128, shards=shards,
        device="cpu")
    svc.stream_with_churn(stream, block_size=64, churn=0.2,
                          rng=np.random.default_rng(11))
    rng = np.random.default_rng(12)
    for _ in range(6):
        svc.embed(rng.integers(0, svc.graph.n_nodes, size=24))
    totals = {name: reg.sum_series(name) for name in SEMANTIC_COUNTERS}
    svc.publish_metrics(reg)
    return svc, reg, totals


def test_semantic_counters_shard_invariant_and_gauges_consistent():
    prev = get_metrics()
    try:
        _, _, t1 = _obs_run(1)
        svc, reg, t8 = _obs_run(8)
    finally:
        set_metrics(prev)
    assert t1 == t8 and t1["store_gather_requests_total"] > 0
    store = svc.store
    per_shard = [reg.get("store_gather_rows", shard=s).value
                 for s in range(8)]
    np.testing.assert_array_equal(per_shard, store.shard_gather_rows)
    found = reg.sum_series("store_gather_found_total")
    spill = reg.sum_series("store_spill_serves_total")
    assert sum(per_shard) == found - spill > 0
    copies = reg.get("store_cross_shard_row_copies").value
    assert copies == store.cross_shard_row_copies == (found - spill) * 7
    moved = {op: reg.get("shard_moved_bytes", op=op).value
             for op in store.plan.traffic}
    assert moved == store.plan.traffic
    assert {"place", "gather", "scatter", "descent"} <= set(moved)


# -------------------------------------------------------------- launcher


def test_launcher_serves_at_8_shards_and_refuses_3(capsys):
    argv = ["--device", "cpu", "--dataset", "tiny", "--requests", "32",
            "--block-size", "16", "--churn", "0.1", "--topk", "5",
            "--verify"]
    assert serve_embed.main(argv + ["--shards", "8"]) > 0
    out = capsys.readouterr().out
    assert "[serve-embed] shards 8: resident/shard [" in out
    assert "bytes moved between shards {" in out
    assert "core mismatches vs oracle: 0" in out
    for bad in ("3", "12"):
        with pytest.raises(SystemExit) as e:
            serve_embed.main(argv + ["--shards", bad])
        assert e.value.code == 2
    assert "power of two" in capsys.readouterr().err
