"""Pipelined ingest of the port against its serial ingest and the JAX package.

``EmbeddingService(pipeline=True)`` (the default in both packages) stages
block N+1 while block N's descent runs and lands the repair and the block's
deferred tail at the next sync point; ``IncrementalCore.begin_update``
enqueues the descent's first chunk of sweeps and reads nothing back,
``finish_update`` reads each chunk once. Here, on the CPU and on numpy-seeded
inputs: pipelined == serial bit for bit (cores, accepted edges, stats, store
versions, staleness) at 1 and 8 shards and under the churn replay, both equal
to the JAX package's pipelined service (cores and graph exactly, queries at
``test_torch_serve``'s tolerances); the begin/finish split against the
peeling oracle on random graphs (hypothesis, overflow side arcs included);
spans nested under pipelined ingest; snapshots carrying ``pipeline`` between
the packages; and the descent's chunking, which changes neither the cores nor
``sweeps`` nor truncation.
"""
import json
import math

import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.serve as jserve  # noqa: E402
from repro.launch import serve_embed as jlaunch  # noqa: E402
from repro.serve import recovery as jrecovery  # noqa: E402
from repro_torch.core.kcore import core_numbers_host  # noqa: E402
from repro_torch.graph import generators  # noqa: E402
from repro_torch.graph.csr import Graph  # noqa: E402
from repro_torch.launch import serve_embed  # noqa: E402
from repro_torch.obs import trace as obs  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.serve import DynamicGraph, IncrementalCore  # noqa: E402
from repro_torch.serve.recovery import (capture_state,  # noqa: E402
                                        restore_service)
from test_torch_serve import assert_queries_agree, lockstep  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Several test workers share the cores: two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _diff(a, b):
    return [k for k in sorted(set(a) | set(b))
            if k not in a or k not in b or not np.array_equal(a[k], b[k])]


def _trio(shards, *, seed=21, n=300):
    """The port pipelined and serial, and the JAX package pipelined, from
    one graph and seed."""
    g = generators.barabasi_albert_varying(n, 5.0, seed=seed)
    kw = dict(seed=seed, batch=32, compact_every=128, shards=shards)
    p, stream, core_p, _ = serve_embed.build_service(
        g, pipeline=True, device="cpu", **kw)
    s, stream_s, core_s, _ = serve_embed.build_service(
        g, pipeline=False, device="cpu", **kw)
    j, stream_j, core_j, _ = jlaunch.build_service(g, pipeline=True, **kw)
    for other in (stream_s, stream_j):
        np.testing.assert_array_equal(stream, other)
    np.testing.assert_array_equal(core_p, core_s)
    np.testing.assert_array_equal(core_p, core_j)
    assert p.pipeline and not s.pipeline and j.pipeline
    return p, s, j, stream


def _assert_same_service(a, b):
    np.testing.assert_array_equal(a.cores.core, b.cores.core)
    for k in ("edges_ingested", "edges_removed", "ingest_blocks",
              "compactions", "queries", "cold_starts", "unresolved"):
        assert getattr(a.stats, k) == getattr(b.stats, k), k
    assert a.store.evictions == b.store.evictions
    assert a.store.version_counts() == b.store.version_counts()
    assert a.store.staleness(a.cores.core) == b.store.staleness(b.cores.core)
    assert _diff(a.graph.state_dict(), b.graph.state_dict()) == []


@pytest.mark.parametrize("shards", [1, 8])
def test_pipelined_ingest_matches_serial_and_jax(shards):
    """Twin of ``tests/multidevice/test_pipeline_parity.py``'s first test:
    ingest blocks, retractions and queries (which settle a repair in
    flight) through the three services."""
    p, s, j, stream = _trio(shards)
    rng_q = np.random.default_rng(22)
    n_now = p.graph.n_nodes
    for start in range(0, len(stream), 48):
        block = stream[start:start + 48]
        a_p, a_s, a_j = (x.ingest_block(block) for x in (p, s, j))
        np.testing.assert_array_equal(a_p, a_s)
        np.testing.assert_array_equal(a_p, a_j)
        if (start // 48) % 2:
            rm = block[: len(block) // 3]
            assert p.retract_block(rm) == s.retract_block(rm) == \
                j.retract_block(rm)
        if (start // 48) % 3 == 2:
            q = rng_q.integers(0, n_now, size=16)
            e_p = p.embed(q)
            np.testing.assert_array_equal(e_p, s.embed(q))
            np.testing.assert_allclose(e_p, j.embed(q), rtol=1e-5,
                                       atol=1e-5)
    for x in (p, s, j):
        x.sync()
    _assert_same_service(p, s)
    np.testing.assert_array_equal(p.cores.core, np.asarray(j.cores.core))
    assert _diff(p.graph.state_dict(), j.graph.state_dict()) == []
    assert p.store.version_counts() == j.store.version_counts()
    assert p.cores.resync() == 0 and s.cores.resync() == 0
    assert p.cores._inflight is None


def test_pipelined_churn_replay_matches_serial_at_8_shards():
    """Twin of the churn replay: ``stream_with_churn`` on the three
    services at 8 shards gives equal counts, cores and state."""
    p, s, j, stream = _trio(8, seed=23)
    r = [x.stream_with_churn(stream, block_size=64, churn=0.2,
                             rng=np.random.default_rng(24))
         for x in (p, s, j)]
    assert r[0] == r[1] == r[2]
    _assert_same_service(p, s)
    np.testing.assert_array_equal(p.cores.core, np.asarray(j.cores.core))
    assert p.cores.resync() == 0 and s.cores.resync() == 0


@pytest.mark.parametrize("shards", [1, 8])
def test_pipelined_service_in_lockstep_with_the_jax_package(shards):
    """The port's pipelined service beside the JAX package's: cores after
    every block (reading them settles both), the graph's arrays, then
    embeddings, link scores and top-k ids at ``test_torch_serve``'s
    tolerances."""
    g = generators.barabasi_albert_varying(300, 4.0, seed=4)
    kw = dict(stream_frac=0.3, dim=16, batch=16, seed=4, shards=shards)
    svc, stream, _, _ = serve_embed.build_service(g, device="cpu", **kw)
    jsvc, _, _, _ = jlaunch.build_service(g, **kw)
    assert svc.pipeline and jsvc.pipeline
    lockstep([svc, jsvc], stream, 24, 0.1, 6)
    svc.sync()
    assert _diff(svc.graph.state_dict(), jsvc.graph.state_dict()) == []
    assert svc.cores.resync() == 0
    assert_queries_agree(svc, jsvc, 7)


# ------------------------------------------------ begin/finish vs oracle --


@st.composite
def graphs(draw, max_nodes=35):
    n = draw(st.integers(5, max_nodes))
    n_edges = draw(st.integers(n - 1, min(3 * n, n * (n - 1) // 2)))
    rng = np.random.default_rng(draw(st.integers(0, 2**31 - 1)))
    edges = set()
    perm = rng.permutation(n)  # a spanning chain: no isolated node
    for a, b in zip(perm[:-1], perm[1:]):
        edges.add((min(a, b), max(a, b)))
    while len(edges) < n_edges:
        u, v = rng.integers(0, n, size=2)
        if u != v:
            edges.add((min(u, v), max(u, v)))
    return Graph.from_edges(n, np.array(sorted(edges)))


@given(
    graphs(),
    st.sampled_from(["adaptive", "region", "fallback"]),
    st.integers(1, 40),  # insert block size
    st.integers(0, 2**31 - 1),
)
@settings(max_examples=15, deadline=None)
def test_begin_finish_split_matches_the_oracle_and_jax(g, mode, block_size,
                                                       seed):
    """Twin of the begin/finish branch of
    ``tests/props/test_invariants.py::test_repair_policy_is_cost_only``:
    every other insert block goes through ``finish_update(begin_update())``
    (a read of ``core`` settles one of them in flight first); cores equal
    the peeling oracle and the JAX package's after every block, on a table
    of width 2 (overflow side arcs)."""
    rng = np.random.default_rng(seed)
    edges = g.edge_list()
    edges = edges[rng.permutation(len(edges))]
    dyn = DynamicGraph(g.n_nodes, width=2, device="cpu")
    jdyn = jserve.DynamicGraph(g.n_nodes, width=2)
    inc = IncrementalCore(dyn, repair_policy=mode)
    jinc = jserve.IncrementalCore(jdyn, repair_policy=mode)
    live: list = []
    for step, start in enumerate(range(0, len(edges), block_size), 1):
        accepted = dyn.add_edges(edges[start:start + block_size])
        np.testing.assert_array_equal(
            accepted, jdyn.add_edges(edges[start:start + block_size]))
        if step % 2:
            inc.on_edge_block(accepted)
            jinc.on_edge_block(accepted)
        else:
            ticket = inc.begin_update(added=accepted)
            if step % 4 == 0:
                inc.core  # settles the ticket in flight
            inc.finish_update(ticket)
            jinc.finish_update(jinc.begin_update(added=accepted))
        live.extend(map(tuple, accepted))
        if step % 2 == 0 and len(live) > 4:
            k = int(rng.integers(1, max(len(live) // 3, 2)))
            pick = rng.choice(len(live), size=k, replace=False)
            drop = np.array([live[i] for i in pick])
            removed = dyn.remove_edges(drop)
            np.testing.assert_array_equal(removed, jdyn.remove_edges(drop))
            inc.on_remove(removed)
            jinc.on_remove(removed)
            gone = {tuple(e) for e in removed}
            live = [e for e in live if e not in gone]
        oracle = core_numbers_host(dyn.snapshot())
        np.testing.assert_array_equal(inc.core, oracle)
        np.testing.assert_array_equal(np.asarray(jinc.core), oracle)
    assert inc.resync() == 0


# --------------------------------------------------------------- tracing --


def test_chrome_export_nests_under_pipelined_ingest(tmp_path):
    """Twin of ``tests/unit/test_obs_trace.py``'s pipelined-ingest test:
    within each thread lane the exported Chrome trace stays strictly
    containment-nested (spans disjoint or nested, never half-overlapping)."""
    g = generators.barabasi_albert_varying(240, 4.0, seed=5)
    svc, stream, _, _ = serve_embed.build_service(
        g, pipeline=True, seed=5, batch=32, compact_every=64, device="cpu")
    prev = obs.tracer()
    obs.set_tracer(Tracer(enabled=True))
    try:
        rng = np.random.default_rng(7)
        for start in range(0, len(stream), 48):
            svc.ingest_block(stream[start:start + 48])
            if (start // 48) % 2:  # queries settle the block mid-stream
                svc.embed(rng.integers(0, svc.graph.n_nodes, size=8))
        svc.sync()
        path = tmp_path / "pipeline_trace.json"
        assert obs.tracer().export_chrome(str(path)) > 0
    finally:
        obs.set_tracer(prev)
    events = json.loads(path.read_text())["traceEvents"]
    assert {e["ph"] for e in events} == {"X"}
    names = {e["name"] for e in events}
    assert {"serve.ingest", "repair.descend", "serve.flush"} <= names
    lanes = {}
    for e in events:
        lanes.setdefault(e["tid"], []).append(e)
    assert any(len(v) > 1 for v in lanes.values())
    for lane in lanes.values():
        lane.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []  # open end-times
        for e in lane:
            t0, t1 = e["ts"], e["ts"] + e["dur"]
            while stack and stack[-1] <= t0:
                stack.pop()
            assert not stack or t1 <= stack[-1], (
                f"span {e['name']} [{t0}, {t1}] half-overlaps an "
                f"enclosing span ending at {stack[-1]}")
            stack.append(t1)


# ------------------------------------------------------------- snapshots --


def test_pipelined_snapshots_cross_between_the_packages():
    """A JAX snapshot taken with ``pipeline=True`` restores into a
    pipelined port service with the JAX arrays, and the port's snapshot of
    it restores into a pipelined JAX service; all three then take the rest
    of the stream and stay equal. A serial port service's snapshot restores
    serial in both packages."""
    g = generators.barabasi_albert_varying(250, 4.0, seed=9)
    kw = dict(seed=9, batch=16, dim=16, stream_frac=0.3)
    jsvc, stream, _, _ = jlaunch.build_service(g, pipeline=True, **kw)
    half = len(stream) // 2
    for start in range(0, half, 24):  # ends with a repair in flight
        jsvc.ingest_block(stream[start:start + 24])
    jarrays, jman = jrecovery.capture_state(jsvc, 3)
    assert jman["service"]["pipeline"] is True
    svc = restore_service(jarrays, jman, device="cpu")
    assert svc.pipeline
    arrays, man = capture_state(svc, 3)
    assert man["service"]["pipeline"] is True
    assert _diff(arrays, jarrays) == []
    jsvc2 = jrecovery.restore_service(arrays, man)
    assert jsvc2.pipeline
    for x in (jsvc, svc, jsvc2):
        x.ingest_edges(stream[half:], block_size=24)
    want = jrecovery.capture_state(jsvc, 0)[0]
    assert _diff(capture_state(svc, 0)[0], want) == []
    assert _diff(jrecovery.capture_state(jsvc2, 0)[0], want) == []

    serial, _, _, _ = serve_embed.build_service(g, pipeline=False,
                                                device="cpu", **kw)
    arrays, man = capture_state(serial, 0)
    assert man["service"]["pipeline"] is False
    assert not restore_service(arrays, man, device="cpu").pipeline
    assert not jrecovery.restore_service(arrays, man).pipeline


# -------------------------------------------------------------- chunking --

PIN = dict(repair_policy="region", repeel_frac=1.0, descend_budget=1 << 62)


def _drive(inc, dyn, edges, base, *, pipelined):
    """Blocks of 40 inserts, each followed by 6 deletions of live edges
    (seeded), through ``begin_update`` / ``finish_update`` or
    ``on_update``; the cores after every block."""
    rng = np.random.default_rng(13)
    out = []
    for start in range(base, len(edges), 40):
        acc = dyn.add_edges(edges[start:start + 40])
        if pipelined:
            inc.finish_update(inc.begin_update(added=acc))
        else:
            inc.on_update(added=acc)
        src, dst = dyn.arc_arrays()
        pick = rng.choice(len(src), size=6, replace=False)
        gone = dyn.remove_edges(np.stack([src[pick], dst[pick]], 1))
        inc.on_update(removed=gone)
        out.append(np.asarray(inc.core).copy())
    return out


def _stream(seed=2):
    g = generators.barabasi_albert_varying(400, 5.0, seed=seed)
    edges = g.edge_list()
    edges = edges[np.random.default_rng(seed).permutation(len(edges))]
    return g, edges, len(edges) // 2


def _jax_run(max_sweeps):
    g, edges, base = _stream()
    dyn = jserve.DynamicGraph(g.n_nodes, edges[:base], width=4)
    inc = jserve.IncrementalCore(dyn, max_sweeps=max_sweeps, **PIN)
    return _drive(inc, dyn, edges, base, pipelined=True), inc


def _port_run(max_sweeps, first_chunk, pipelined=True):
    g, edges, base = _stream()
    dyn = DynamicGraph(g.n_nodes, edges[:base], width=4, device="cpu")
    inc = IncrementalCore(dyn, max_sweeps=max_sweeps, **PIN)
    inc._first_chunk = first_chunk
    return _drive(inc, dyn, edges, base, pipelined=pipelined), inc


@pytest.mark.parametrize("first_chunk", [1, 2, 3, 512, None])
def test_chunking_does_not_change_cores_sweeps_or_truncation(first_chunk):
    """First chunks of 1, 2, 3 and 512 sweeps (and the history rule) give
    the JAX package's cores, ``sweeps``, descents and re-peels, with at
    most 1 + ceil(log2(max_sweeps)) host reads a descent and never fewer
    sweeps enqueued than the count."""
    want, jinc = _jax_run(512)
    got, inc = _port_run(512, first_chunk)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (inc.sweeps, inc.descends, inc.repeels) == \
        (jinc.sweeps, jinc.descends, jinc.repeels)
    assert inc.descends > 10 and inc.repeels == 0
    assert inc.sweeps_enqueued >= inc.sweeps
    assert inc.descent_reads <= inc.descends * (1 + math.ceil(math.log2(512)))
    if first_chunk == 512:  # every descent ends inside its first chunk
        assert inc.descent_reads == inc.descends
    if first_chunk == 1:  # doubling from 1: one read a power of two
        assert inc.descent_reads > inc.descends
        assert inc.sweeps_enqueued < 2 * inc.sweeps


@pytest.mark.parametrize("max_sweeps,first_chunk",
                         [(2, None), (3, 1), (3, 2), (4, 512)])
def test_a_small_max_sweeps_truncates_and_falls_back_as_jax_does(
        max_sweeps, first_chunk):
    """A cap below the descents' depth truncates them (the sweep at
    ``max_sweeps`` still changed) and re-peels the block: the cores,
    ``sweeps`` and re-peels equal the JAX package's, serial and pipelined,
    and no descent enqueues more than ``max_sweeps`` sweeps."""
    want, jinc = _jax_run(max_sweeps)
    assert jinc.repeels > 0
    for pipelined in (True, False):
        got, inc = _port_run(max_sweeps, first_chunk, pipelined)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert (inc.sweeps, inc.descends, inc.repeels) == \
            (jinc.sweeps, jinc.descends, jinc.repeels)
        assert inc.sweeps_enqueued <= max_sweeps * inc.descends
        assert inc.resync() == 0


def test_begin_update_leaves_the_descent_unread_until_finish_update():
    """``begin_update`` enqueues the first chunk and reads nothing back;
    the service's next block, query or ``sync()`` is the first read. The
    first chunk follows the last descent of the same kind of block."""
    g, edges, base = _stream()
    dyn = DynamicGraph(g.n_nodes, edges[:base], width=4, device="cpu")
    inc = IncrementalCore(dyn, **PIN)
    acc = dyn.add_edges(edges[base:base + 40])
    ticket = inc.begin_update(added=acc)
    assert not ticket.done and inc._inflight is ticket
    descent = ticket.pending["descent"]
    assert (descent.reads, descent.enqueued) == (0, 4)
    inc.finish_update(ticket)
    assert inc._inflight is None and descent.reads >= 1
    last = inc._last_sweeps["insert"]  # a widening may have descended again
    acc = dyn.add_edges(edges[base + 40:base + 80])
    ticket = inc.begin_update(added=acc)
    assert ticket.pending["descent"].enqueued == max(4, 1 << (last - 1)
                                                     .bit_length())
    inc.core  # settles
    assert inc._inflight is None and ticket.pending["descent"].reads >= 1

    p, _, _, stream = _trio(1)
    p.ingest_block(stream[:48])
    live = p.cores._inflight  # the first block's repair descends
    assert live is not None and live.pending["descent"].reads == 0
    p.sync()
    assert p.cores._inflight is None
