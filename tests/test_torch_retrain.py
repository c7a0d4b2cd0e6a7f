"""The port's retraining loop against the JAX package's, on the CPU.

Both packages build the service from the same graph and seed and take the
same blocks, so their cores, baselines and stores agree; then:

* ``RetrainPlanner.plan()`` gives the same nodes, k0, drift count and
  subgraph CSR (exact);
* ``procrustes_rotation`` is within 1e-6 of the JAX package's on the same
  inputs, orthogonal (1e-5) for any number of anchors, and recovers a
  planted rotation (1e-5) once the anchors span the space (n >= d) — the
  property the JAX package's hypothesis test checks for every n;
* ``VersionRollout.commit`` of the same staged rows leaves the store's
  table, versions and ``version_counts`` bit-identical;
* ``Retrainer.run()`` matches the JAX package's walk count, SGNS steps,
  warm rows, anchors, swapped rows and version exactly (walks and the
  initial table come from torch generators, so the vectors differ), and the
  held-out link AUC over the k0-core of a six-block SBM comes within
  ``AUC_TOL`` of the JAX package's, while the same retrain with its SGNS
  updates skipped does not;
* a retrain repeats its bits from the same state (a WAL replay rebuilds
  the table it rebuilt before);
* the transactional rollback under an injected fault leaves the store
  bit-identical, while an ``InjectedCrash`` passes through;
* a hang watchdog set through ``build_service(hang_timeout=)`` is armed
  around the flush and the retrain's stages, and counts the same hangs as
  the JAX package's service given the same watchdog;
* the single-edge and single-query conveniences act as the JAX package's.
"""
import numpy as np
import pytest
import torch

import repro.serve as jserve
from repro.distributed.watchdog import HangWatchdog as JHangWatchdog
from repro.launch import serve_embed as jlaunch
from repro.serve import faults as jfaults
from repro.skipgram.trainer import SGNSConfig as JSGNSConfig
import repro_torch.serve.retrain as retrain_mod
from repro_torch.distributed import watchdog
from repro_torch.eval.linkpred import auc_score
from repro_torch.graph import generators
from repro_torch.launch import serve_embed
from repro_torch.serve import (
    EmbeddingAligner,
    EmbeddingStore,
    RetrainConfig,
    Retrainer,
    RetrainPlanner,
    VersionRollout,
    faults,
    procrustes_rotation,
)
from repro_torch.serve.faults import FaultPlan, InjectedCrash
from repro_torch.skipgram.trainer import SGNSConfig, SGNSResult

# Held-out link AUC, port vs JAX package (different walks). Over seeds 0-7
# the gap is at most 0.015, and the control (the port's retrain with its
# SGNS updates skipped) lies 0.2 or more from the JAX package's:
# ``python tests/test_torch_retrain.py`` prints both per seed.
AUC_TOL = 0.05


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The suite runs in several worker processes at once: torch's default
    of a thread per core in each would oversubscribe the cores many times
    over. Two threads keep the CPU's multi-threaded paths (the gradient
    sums the determinism checks are about) in play."""
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


def _cfgs(dim, batch=512, **kw):
    """The same retrain settings for both packages (the JAX package's on
    its plain SGNS path)."""
    from repro.serve.retrain import RetrainConfig as JCfg

    base = dict(n_walks=6, walk_length=12, min_sgns_steps=60, prop_iters=6,
                swap_chunk=64, seed=3)
    base.update(kw)
    sgns = dict(dim=dim, epochs=0.1, batch=batch, seed=3)
    return (RetrainConfig(sgns=SGNSConfig(**sgns), **base),
            JCfg(sgns=JSGNSConfig(impl="ref", **sgns), **base))


def _pair(n=300, seed=3, dim=16, capacity=0, hold=0, g=None,
          hang_timeout=None):
    """The port's and the JAX package's service after the same stream
    (blocks of 24, a quarter of each block retracted) over ``g`` (default a
    Barabasi-Albert graph of ``n`` nodes). The last ``hold`` stream edges
    are held out, never ingested. ``hang_timeout`` arms both services' hang
    watchdogs (the JAX launcher has no such option: its service is handed
    the same watchdog directly)."""
    if g is None:
        g = generators.barabasi_albert_varying(n, 4.0, seed=seed)
    kw = dict(seed=seed, batch=16, dim=dim, stream_frac=0.3,
              compact_every=256, capacity=capacity)
    svc, stream, _, _ = serve_embed.build_service(
        g, device="cpu", hang_timeout=hang_timeout, **kw)
    jsvc, jstream, _, _ = jlaunch.build_service(g, pipeline=False, **kw)
    if hang_timeout is not None:
        jsvc._watchdog = JHangWatchdog(hang_timeout, jsvc._on_hang)
    np.testing.assert_array_equal(stream, jstream)
    held = stream[len(stream) - hold:] if hold else stream[:0]
    for s in (svc, jsvc):
        s.stream_with_churn(stream[: len(stream) - hold], block_size=24,
                            churn=0.25, rng=np.random.default_rng(seed + 2))
    np.testing.assert_array_equal(svc.cores.core, np.asarray(jsvc.cores.core))
    return svc, jsvc, held


def _force_drift(svcs, n_wire=8):
    """Wire low-core nodes into a dense pocket to flip k0-core membership."""
    core = svcs[0].cores.core
    low = np.argsort(core, kind="stable")[:n_wire]
    edges = np.asarray([(int(low[i]), int(low[j]))
                        for i in range(n_wire) for j in range(i + 1, n_wire)],
                       np.int64)
    for s in svcs:
        s.ingest_block(edges)
        s.sync()


# ---------------------------------------------------------------- planner


def test_planner_matches_jax_after_the_same_stream():
    svc, jsvc, _ = _pair()
    _force_drift([svc, jsvc])
    plan = RetrainPlanner(svc.graph, svc.cores, svc.k0).plan()
    jplan = jserve.RetrainPlanner(jsvc.graph, jsvc.cores, jsvc.k0).plan()
    assert (plan.k0, plan.drifted) == (jplan.k0, jplan.drifted)
    assert plan.drifted > 0
    for name in ("nodes", "core", "baseline"):
        np.testing.assert_array_equal(getattr(plan, name),
                                      np.asarray(getattr(jplan, name)))
    for g, jg in ((plan.sub, jplan.sub), (plan.snapshot, jplan.snapshot)):
        assert g.n_nodes == jg.n_nodes
        np.testing.assert_array_equal(g.indptr, jg.indptr)
        np.testing.assert_array_equal(g.indices, jg.indices)


def test_planner_clamps_k0_to_current_degeneracy():
    svc, _, _ = _pair()
    big = RetrainPlanner(svc.graph, svc.cores, 10 ** 6).plan()
    assert big.k0 == int(svc.cores.core.max()) and len(big.nodes) > 0
    with pytest.raises(ValueError):
        RetrainPlanner(svc.graph, svc.cores, 0)


# ------------------------------------------------------------- procrustes


def _rotation(d, rng):
    q, r = np.linalg.qr(rng.normal(size=(d, d)))
    return (q * np.sign(np.diag(r))).astype(np.float32)


@pytest.mark.parametrize("n", [1, 3, 8, 11, 12, 13, 40])
def test_procrustes_matches_jax_and_is_orthogonal_for_any_n(n):
    """d = 12: fewer anchors than dimensions (n < d) leave ``XᵀY`` rank-
    deficient; the rotation is still orthogonal, and it recovers a planted
    rotation only when n >= d (the JAX package's property test asserts
    recovery for every n and fails at its saved example n = 8, d = 9)."""
    from repro.serve.retrain import procrustes_rotation as jprocrustes

    d = 12
    rng = np.random.default_rng(n)
    X = rng.normal(size=(n, d)).astype(np.float32)
    R0 = _rotation(d, rng)
    Y = X @ R0
    R = procrustes_rotation(X, Y)
    np.testing.assert_allclose(R, np.asarray(jprocrustes(X, Y)), atol=1e-6)
    np.testing.assert_allclose(R.T @ R, np.eye(d), atol=1e-5)
    U = rng.normal(size=(n, d))  # unrelated clouds: still orthogonal
    Ru = procrustes_rotation(U, rng.normal(size=(n, d)))
    np.testing.assert_allclose(Ru.T @ Ru, np.eye(d), atol=1e-5)
    if n >= d:
        np.testing.assert_allclose(R, R0, atol=1e-5)
        np.testing.assert_allclose(X @ R, Y, atol=1e-4)
    with pytest.raises(ValueError):
        procrustes_rotation(X, Y[:, :-1])


def test_aligner_identity_below_min_anchors_and_maps_back():
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(50, 8)).astype(np.float32)
    out, rep = EmbeddingAligner(min_anchors=8).align(
        emb, emb[:3], np.arange(3))
    assert not rep["aligned"] and out is not None
    np.testing.assert_array_equal(out, emb)
    R0 = _rotation(8, rng)
    anchors = np.arange(20)
    aligned, rep = EmbeddingAligner().align(emb @ R0.T, emb[anchors], anchors)
    assert rep["aligned"] and rep["residual"] < 1e-5
    np.testing.assert_allclose(aligned, emb, atol=1e-4)


# ---------------------------------------------------------------- rollout


def test_rollout_commit_matches_jax_bit_for_bit():
    """The same staged rows committed in chunks (through evictions into the
    spill tier: capacity 64 of 300 nodes) leave both stores' table, tags
    and version counts equal, with ``between`` called after every chunk."""
    rng = np.random.default_rng(4)
    jst = jserve.EmbeddingStore(capacity=64, dim=8, node_cap=300)
    first = rng.choice(300, 90, replace=False)
    jst.put_many(first, rng.normal(size=(90, 8)).astype(np.float32),
                 rng.integers(0, 5, 90))
    st = EmbeddingStore.from_state(jst.state_dict(), device="cpu")
    nodes = rng.choice(300, 150, replace=False)
    vecs = rng.normal(size=(150, 8)).astype(np.float32)
    cores = rng.integers(0, 5, 150)
    calls = []
    roll, jroll = VersionRollout(st, chunk=32), \
        jserve.VersionRollout(jst, chunk=32)
    roll.stage(nodes, vecs, cores)
    jroll.stage(nodes, vecs, cores)
    rep = roll.commit(lambda: calls.append(1))
    jrep = jroll.commit()
    for k in ("version", "rows", "chunks", "version_counts"):
        assert rep[k] == jrep[k], k
    assert len(calls) == rep["chunks"] == 5 and st.spilled > 0
    got, want = st.state_dict(), jst.state_dict()
    assert [k for k in want if not np.array_equal(got[k], want[k])] == []
    with pytest.raises(RuntimeError):
        roll.commit()  # nothing staged


# -------------------------------------------------------------- retrainer


def _auc(svc, pos, neg):
    pairs = np.concatenate([pos, neg])
    return auc_score(np.r_[np.ones(len(pos)), np.zeros(len(neg))],
                     svc.link_scores(pairs))


def _skip_sgns(corpus, cfg, *, params=None, steps=None):
    """``train_sgns`` with no update: the warm-started table as it came."""
    return SGNSResult(params["emb_in"].detach().cpu().numpy(), int(steps),
                      0.0, 0.0)


def _retrain_aucs(seed):
    """Both packages retrain after the same stream over a six-block SBM
    (600 nodes), then score held-out (never ingested) edges inside the
    k0-core against random non-edges of the core, cosine through the
    served tables. The control retrains a third service, the port's, with
    its SGNS updates skipped (warm start, alignment and propagation alone).

    -> (port report, JAX report, port service, JAX service,
        #positives, port AUC, JAX AUC, control AUC).
    """
    from repro.serve.retrain import Retrainer as JRetrainer

    g = generators.stochastic_block_model([100] * 6, 0.08, 0.004, seed=seed)
    cfg, jcfg = _cfgs(32, batch=4096, min_sgns_steps=200)
    svc, jsvc, held = _pair(seed=seed, dim=32, hold=150, g=g)
    _force_drift([svc, jsvc])
    rep = Retrainer(svc, cfg).run()
    jrep = JRetrainer(jsvc, jcfg).run()
    csvc, _, _ = _pair(seed=seed, dim=32, hold=150, g=g)
    _force_drift([csvc])
    train = retrain_mod.train_sgns
    retrain_mod.train_sgns = _skip_sgns
    try:
        Retrainer(csvc, cfg).run()
    finally:
        retrain_mod.train_sgns = train
    in_core = svc.cores.core >= rep.k0
    pos = held[in_core[held[:, 0]] & in_core[held[:, 1]]]
    rng = np.random.default_rng(9)
    pool = np.where(in_core)[0]
    snap = svc.graph.snapshot()
    neg = []
    while len(neg) < len(pos):
        u, v = rng.choice(pool, 2)
        if u != v and not snap.has_edge(int(u), int(v)):
            neg.append((u, v))
    neg = np.asarray(neg, np.int64)
    return (rep, jrep, svc, jsvc, len(pos), _auc(svc, pos, neg),
            _auc(jsvc, pos, neg), _auc(csvc, pos, neg))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_retrainer_matches_jax_counts_and_auc(seed):
    rep, jrep, svc, jsvc, n_pos, auc, jauc, control = _retrain_aucs(seed)
    for k in ("k0", "core_size", "drifted", "n_walks", "sgns_steps",
              "warm_rows", "anchors", "aligned", "rows_swapped",
              "swap_chunks", "version", "staleness_before",
              "staleness_after", "pressure_before", "pressure_after"):
        assert getattr(rep, k) == getattr(jrep, k), k
    assert rep.warm_rows > 0 and rep.aligned and rep.anchors >= 8
    assert svc.store.version_counts() == jsvc.store.version_counts()
    assert n_pos >= 100
    assert abs(auc - jauc) <= AUC_TOL, (auc, jauc)
    assert abs(control - jauc) > AUC_TOL, (control, jauc)  # the bound bites


def test_retrain_repeats_its_bits_from_the_same_state():
    """Two services in the same state retrain to the same table, bit for
    bit: the walks, the initial table and every SGNS step are
    deterministic on the device (the gradient rows of repeated ids are
    summed in sorted order on the CPU)."""
    runs = []
    for _ in range(2):
        svc, _, _ = _pair(capacity=200)
        _force_drift([svc])
        rep = Retrainer(svc, _cfgs(16, batch=4096)[0]).run()
        runs.append((svc.store.state_dict(), rep.sgns_steps))
    (a, steps), (b, _) = runs
    assert steps >= 60
    assert [k for k in a if not np.array_equal(a[k], b[k])] == []


def test_retrain_without_alignment_or_propagation():
    svc, _, _ = _pair()
    _force_drift([svc])
    rep = Retrainer(svc, _cfgs(16, align=False, propagate=False)[0]).run()
    assert rep is not None and not rep.aligned
    assert rep.rows_swapped == rep.core_size  # only the subcore was written


# ------------------------------------------------------ the service's gate


def test_maybe_retrain_gates_on_threshold_and_budget():
    svc, _, _ = _pair()
    assert svc.maybe_retrain() is None  # no retrainer attached
    svc.set_retrainer(Retrainer(svc, _cfgs(16)[0]), budget=1)
    svc.retrain_threshold = 1.01  # unreachable
    assert svc.maybe_retrain() is None and svc.stats.retrains == 0
    assert svc.maybe_retrain(force=True) is not None
    assert svc.stats.retrains == 1
    assert svc.maybe_retrain(force=True) is None  # budget spent
    assert svc.stats.last_swap_version == svc.store.version == 1
    assert len(svc.stats.retrain_seconds) == 1


def test_drift_triggered_retrain_hot_swap_end_to_end():
    svc, _, _ = _pair()
    svc.retrain_threshold = 0.02
    svc.set_retrainer(Retrainer(svc, _cfgs(16)[0]), auto=True, budget=1)
    v0 = svc.store.version
    _force_drift([svc])  # auto mode retrains inside ingest_block
    assert svc.stats.retrains == 1
    assert svc.stats.last_swap_version == svc.store.version == v0 + 1
    assert svc.retrain_pressure() < svc.retrain_threshold  # baseline reset
    assert svc.store.staleness(svc.cores.core) == 0.0
    assert svc.cores.resync() == 0
    out = svc.embed(list(range(20)))
    assert np.isfinite(out).all()
    assert svc.store.version_counts().get(v0 + 1, 0) > 0


@pytest.mark.parametrize("point", ["retrain_swap_chunk:2", "retrain_train:1"])
def test_failed_retrain_rolls_back_store(point):
    """A retrain that dies mid-cycle — even mid-rollout, inside the mixed-
    version window — leaves the store bit-identical to before, with no row
    on the aborted version; without the fault the same retrain runs."""
    svc, _, _ = _pair(capacity=200)
    svc.set_retrainer(Retrainer(svc, _cfgs(16)[0]))
    pre = svc.store.state_dict()
    pre_counts = svc.store.version_counts()
    faults.install(FaultPlan.parse(f"{point}:fault"))
    assert svc.maybe_retrain(force=True) is None
    faults.install(None)
    assert svc.stats.retrain_failures == 1 and svc.stats.retrains == 0
    assert svc.store.version_counts() == pre_counts
    post = svc.store.state_dict()
    assert [k for k in pre if not np.array_equal(pre[k], post[k])] == []
    assert svc.maybe_retrain(force=True) is not None
    assert svc.stats.retrains == 1


def test_retrain_crash_passes_through_transaction():
    svc, _, _ = _pair()
    svc.set_retrainer(Retrainer(svc, _cfgs(16)[0]))
    faults.install(FaultPlan.parse("retrain_plan:1:crash"))
    with pytest.raises(InjectedCrash):
        svc.maybe_retrain(force=True)
    assert svc.stats.retrain_failures == 0



@pytest.mark.parametrize("hang", [False, True])
def test_hang_watchdog_through_the_service(monkeypatch, hang):
    """A service built with ``hang_timeout`` arms its watchdog around the
    flush's blocking read, and around a retrain, which re-arms it at each
    of its six stages; the end of each section disarms it. With ``hang``
    every timer runs out as it starts: each counts a hang, the service
    enters degraded mode and the retrain still lands. The JAX package's
    service makes the same timers and counts the same hangs."""
    from repro.serve.retrain import Retrainer as JRetrainer

    made = []

    class Timer:  # stands in for threading.Timer; fires only on ``hang``
        def __init__(self, timeout, fn):
            self.timeout, self.fn, self.cancelled = timeout, fn, False
            made.append(self)

        def start(self):
            if hang:
                self.fn()

        def cancel(self):
            self.cancelled = True

    monkeypatch.setattr(watchdog.threading, "Timer", Timer)
    svc, jsvc, _ = _pair(hang_timeout=7.5)
    _force_drift([svc, jsvc])
    cfg, jcfg = _cfgs(16)
    seen = []
    for s, retrainer in ((svc, Retrainer(svc, cfg)),
                         (jsvc, JRetrainer(jsvc, jcfg))):
        n0 = len(made)
        s.embed(np.arange(10))
        n_flush = len(made) - n0
        s.set_retrainer(retrainer)
        assert s.maybe_retrain(force=True) is not None
        seen.append((n_flush, len(made) - n0 - n_flush, s.stats.hangs,
                     s.stats.retrains, s.degraded, s._watchdog.armed))
    assert seen[0] == seen[1]
    assert seen[0] == (1, 7, 8 if hang else 0, 1, hang, False)
    assert {t.timeout for t in made} == {7.5}
    assert all(t.cancelled for t in made)


def test_single_edge_and_single_query_conveniences_match_jax():
    """``ingest`` / ``retract`` report whether the edge changed the graph,
    ``submit`` returns the query's slot in the next flush, as in the JAX
    package, and both services end with the same cores and answers."""
    svc, jsvc, _ = _pair()
    low = [int(v) for v in np.argsort(svc.cores.core, kind="stable")[:6]]
    seen = []
    for s in (svc, jsvc):
        got = [s.ingest(low[0], v) for v in low[1:]]
        got.append(s.ingest(low[0], low[1]))  # a duplicate
        got += [s.retract(low[0], low[1]), s.retract(low[0], low[1])]
        got += [s.submit(v) for v in low[:3]]
        s.sync()
        seen.append((got, np.asarray(s.cores.core), np.asarray(s.flush())))
    (got, core, out), (jgot, jcore, jout) = seen
    assert got == jgot == [True] * 5 + [False, True, False, 0, 1, 2]
    np.testing.assert_array_equal(core, jcore)
    np.testing.assert_allclose(out, jout, rtol=1e-6, atol=1e-6)


if __name__ == "__main__":
    # The readings behind AUC_TOL: run from the repo root with
    # PYTHONPATH=src and JAX_PLATFORMS=cpu.
    torch.set_num_threads(2)
    print("seed  n_pos  port    jax     |gap|   control |control-jax|")
    for seed in range(8):
        *_, n_pos, auc, jauc, control = _retrain_aucs(seed)
        print(f"{seed:4d}  {n_pos:5d}  {auc:.4f}  {jauc:.4f}  "
              f"{abs(auc - jauc):.4f}  {control:.4f}  "
              f"{abs(control - jauc):.4f}")
