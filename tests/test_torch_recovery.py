"""The port's crash safety against the JAX package's, on the CPU.

Fault plans: the same injection points, and the same spec strings fire on
the same hits in both packages. The write-ahead log: the same blocks give
byte-identical files, torn tails truncate at the same offsets, and each
package reads the other's log. A snapshot directory the JAX package's
``RecoveryManager`` committed is restored by the port to the JAX package's
recovered state (graph and store arrays equal, cores, baseline and counters
equal). The crash-point sweep: a crash at every injection point, on a
stream that reaches all of them (store capacity below the node count,
drift-triggered retraining on, a query phase after the stream), recovers to
a state bit-identical to an uninterrupted twin, with cores equal to the
peeling oracle. The degradation paths (flush retry and stale-row fallback,
dispatch retry and host re-peel) absorb the harness's ``InjectedFault``
only: any other error raised in the flush dispatch, the repair dispatch or
a retrain stage propagates out of the port, where the JAX package absorbs
it. Every tolerance here is exact equality.
"""
import os
import shutil
import struct
import zlib

import numpy as np
import pytest
import torch

import repro.serve as jserve
from repro.launch import serve_embed as jlaunch
from repro.serve import faults as jfaults
from repro.serve import recovery as jrecovery
from repro.skipgram.trainer import SGNSConfig as JSGNSConfig
from repro_torch.core.kcore import core_numbers_host
from repro_torch.distributed import watchdog
from repro_torch.graph import generators
from repro_torch.launch import serve_embed
from repro_torch.serve import recovery as precovery
from repro_torch.serve import (
    RecoveryManager,
    RetrainConfig,
    Retrainer,
    SnapshotStore,
    WriteAheadLog,
    faults,
)
from repro_torch.serve.faults import FaultPlan, InjectedCrash, InjectedFault
from repro_torch.serve.recovery import (
    _HEADER,
    _MAGIC,
    KIND_INGEST,
    KIND_RETRACT,
    capture_state,
)
from repro_torch.skipgram.trainer import SGNSConfig


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


def _edges(*pairs):
    return np.asarray(pairs, np.int64)


# ------------------------------------------------------------ fault plans --


def _fire_pattern(mod, spec, points, n_hits):
    """Which (point, hit) fire under ``spec`` in package ``mod``, and how."""
    mod.install(mod.FaultPlan.parse(spec))
    out = []
    for hit in range(1, n_hits + 1):
        for p in points:
            try:
                mod.check(p)
            except mod.InjectedCrash:
                out.append((p, hit, "crash"))
            except mod.InjectedFault:
                out.append((p, hit, "fault"))
    plan = mod.active()
    mod.install(None)
    return out, dict(plan.counts), dict(plan.fired)


@pytest.mark.parametrize("spec", [
    "wal_append:1:crash",
    "repair:2,device_dispatch:3+:crash",
    "retrain_swap_chunk:2:fault, spill_io:4+",
    ",".join(f"{p}:{i % 3 + 1}" for i, p in enumerate(jfaults.POINTS)),
])
def test_fault_plans_fire_on_the_same_hits_as_jax(spec):
    assert faults.POINTS == jfaults.POINTS
    assert len(faults.POINTS) == 16
    got = _fire_pattern(faults, spec, faults.POINTS, 5)
    want = _fire_pattern(jfaults, spec, jfaults.POINTS, 5)
    assert got == want and got[0]


@pytest.mark.parametrize("bad", ["not_a_point:1", "wal_append",
                                 "wal_append:1:explode", "wal_append:0"])
def test_fault_plan_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError) as got:
        FaultPlan.parse(bad)
    with pytest.raises(ValueError) as want:
        jfaults.FaultPlan.parse(bad)
    assert str(got.value) == str(want.value)


def test_injected_crash_is_not_an_exception():
    assert not issubclass(InjectedCrash, Exception)
    assert issubclass(InjectedFault, RuntimeError)
    faults.install(FaultPlan.parse("repair:1:crash"))
    with pytest.raises(InjectedCrash):
        try:
            faults.check("repair")
        except Exception:  # noqa: BLE001 - the point of the test
            pytest.fail("InjectedCrash was swallowed by `except Exception`")


# -------------------------------------------------------------- watchdog --


class _FakeTimer:
    """Stands in for ``threading.Timer``: fires only when the test says."""

    made = []

    def __init__(self, timeout, fn):
        self.timeout, self.fn = timeout, fn
        self.cancelled = self.started = False
        _FakeTimer.made.append(self)

    def start(self):
        self.started = True

    def cancel(self):
        self.cancelled = True


def test_hang_watchdog_with_a_fake_clock(monkeypatch):
    """The service arms its watchdog around the flush's blocking read and
    disarms it after; a timer that fires counts a hang and enters degraded
    mode; ``pet_watchdog`` re-arms an armed watchdog and leaves a disarmed
    one alone. The straggler monitor flags the same steps as the JAX
    package's on the same fake clock."""
    monkeypatch.setattr(watchdog.threading, "Timer", _FakeTimer)
    _FakeTimer.made = []
    g = generators.barabasi_albert_varying(120, 4.0, seed=0)
    svc, _, _, _ = serve_embed.build_service(g, seed=0, batch=16,
                                             hang_timeout=7.5, device="cpu")
    svc.embed(np.arange(10))
    assert [t.timeout for t in _FakeTimer.made] == [7.5]
    assert _FakeTimer.made[0].started and _FakeTimer.made[0].cancelled
    assert not svc._watchdog.armed and svc.stats.hangs == 0

    svc._watchdog.arm()
    svc.pet_watchdog()  # armed: re-armed with a fresh timer
    assert len(_FakeTimer.made) == 3 and _FakeTimer.made[1].cancelled
    _FakeTimer.made[-1].fn()  # the clock runs out
    assert svc._watchdog.fired and svc.stats.hangs == 1 and svc.degraded
    svc._watchdog.disarm()
    svc.pet_watchdog()  # disarmed: a no-op
    assert not svc._watchdog.armed and len(_FakeTimer.made) == 3
    svc.embed(np.arange(4))  # a healthy flush clears degraded mode
    assert not svc.degraded

    from repro.distributed.watchdog import StragglerMonitor as JMonitor

    steps = [1.0, 1.1, 0.9, 3.5, 1.0, 2.5, 0.8, 9.0]
    flagged = []
    for cls in (watchdog.StragglerMonitor, JMonitor):
        now = [0.0]
        mon = cls(threshold=2.0, clock=lambda: now[0])
        for dt in steps:
            mon.start_step()
            now[0] += dt
            mon.end_step()
        flagged.append((mon.slow_steps, mon.ewma, mon.straggler_fraction))
    assert flagged[0] == flagged[1] and flagged[0][0] == [3, 5, 7]


# ------------------------------------------------------------------- WAL --

BLOCKS = [(KIND_INGEST, _edges((0, 1), (1, 2), (5, 9))),
          (KIND_RETRACT, _edges((1, 2))),
          (KIND_INGEST, np.zeros((0, 2), np.int64)),
          (KIND_INGEST, _edges((70000, 3)))]


def _write_wal(mod, path):
    wal = mod.WriteAheadLog(path, fsync=False)
    seqs = [wal.append(kind, edges) for kind, edges in BLOCKS]
    wal.close()
    return seqs


def test_wal_files_are_byte_identical_and_cross_read(tmp_path):
    p, j = str(tmp_path / "port.log"), str(tmp_path / "jax.log")
    assert _write_wal(precovery, p) == _write_wal(jrecovery, j) == [1, 2, 3, 4]
    with open(p, "rb") as f, open(j, "rb") as g:
        assert f.read() == g.read()
    # each package reads the other's log, record for record
    for mine, theirs in ((WriteAheadLog(j, fsync=False),
                          jrecovery.WriteAheadLog(j, fsync=False)),
                         (jrecovery.WriteAheadLog(p, fsync=False),
                          WriteAheadLog(p, fsync=False))):
        got, want = list(mine.records()), list(theirs.records())
        assert [(s, k) for s, k, _ in got] == [(s, k) for s, k, _ in want]
        for (_, _, a), (_, _, b), (_, e) in zip(got, want, BLOCKS):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, e.reshape(-1, 2))
        assert mine.seq == theirs.seq == 4
        mine.close()
        theirs.close()


def _torn(kind):
    """Bytes that tear a WAL's tail in one of four ways."""
    if kind == "garbage":
        return b"\x00garbage-that-is-not-a-record"
    if kind == "partial":  # header promises 4 edges, payload cut short
        return _HEADER.pack(_MAGIC, KIND_INGEST, 5, 4) + b"\x01" * 24
    payload = _edges((7, 8)).tobytes()
    if kind == "crc":
        head = _HEADER.pack(_MAGIC, KIND_INGEST, 5, 1)
        return head + payload + struct.pack(
            "<I", zlib.crc32(head + payload) ^ 0xFFFF)
    head = _HEADER.pack(_MAGIC, KIND_INGEST, 9, 1)  # seq jumps: 4 -> 9
    return head + payload + struct.pack("<I", zlib.crc32(head + payload))


@pytest.mark.parametrize("kind", ["garbage", "partial", "crc", "seq"])
def test_torn_tails_truncate_at_the_same_offset(tmp_path, kind):
    sizes = {}
    for name, mod in (("port", precovery), ("jax", jrecovery)):
        path = str(tmp_path / f"{name}.log")
        _write_wal(mod, path)
        good = os.path.getsize(path)
        with open(path, "ab") as f:
            f.write(_torn(kind))
        wal = mod.WriteAheadLog(path, fsync=False)
        sizes[name] = (wal.seq, wal.torn_truncated, os.path.getsize(path))
        assert os.path.getsize(path) == good
        assert wal.append(KIND_RETRACT, _edges((0, 1))) == 5
        wal.close()
    assert sizes["port"] == sizes["jax"] and sizes["port"][1] > 0


def test_wal_crash_mid_append_and_fsync_fault_match_jax(tmp_path):
    """``wal_append`` crashes with half the record on disk (a torn tail the
    next open truncates); ``wal_fsync`` loses the record cleanly. Both
    packages leave the same bytes."""
    files = {}
    for name, mod, fmod in (("port", precovery, faults),
                            ("jax", jrecovery, jfaults)):
        path = str(tmp_path / f"{name}.log")
        wal = mod.WriteAheadLog(path, fsync=False)
        wal.append(KIND_INGEST, _edges((0, 1)))
        fmod.install(fmod.FaultPlan.parse("wal_fsync:1"))
        with pytest.raises(fmod.InjectedFault):
            wal.append(KIND_INGEST, _edges((2, 3)))
        fmod.install(fmod.FaultPlan.parse("wal_append:1:crash"))
        with pytest.raises(fmod.InjectedCrash):
            wal.append(KIND_INGEST, _edges((2, 3), (3, 4)))
        fmod.install(None)
        wal.close()
        with open(path, "rb") as f:
            torn = f.read()
        wal = mod.WriteAheadLog(path, fsync=False)
        files[name] = (torn, wal.seq, wal.torn_truncated)
        wal.close()
    assert files["port"] == files["jax"]
    assert files["port"][1] == 1 and files["port"][2] > 0


# ------------------------------------------------------------- snapshots --


def test_snapshot_store_skips_torn_dirs(tmp_path):
    store = SnapshotStore(str(tmp_path), keep=5)
    arrays = {"a": np.arange(6, dtype=np.float32).reshape(2, 3)}
    store.write(arrays, {"wal_seq": 5})
    faults.install(FaultPlan.parse("snapshot_write:1:crash"))
    with pytest.raises(InjectedCrash):
        store.write(arrays, {"wal_seq": 9})
    faults.install(FaultPlan.parse("snapshot_commit:1:crash"))
    with pytest.raises(InjectedCrash):
        store.write(arrays, {"wal_seq": 11})
    faults.install(None)
    torn = tmp_path / "snap_000000000012"  # committed, payload corrupted
    shutil.copytree(tmp_path / "snap_000000000005", torn)
    raw = bytearray((torn / "state.npz").read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    (torn / "state.npz").write_bytes(bytes(raw))
    got, manifest, skipped = store.load_latest()
    assert manifest["wal_seq"] == 5 and skipped == 1
    np.testing.assert_array_equal(got["a"], arrays["a"])
    # the JAX package's reader agrees
    _, jman, jskipped = jrecovery.SnapshotStore(str(tmp_path)).load_latest()
    assert (jman["wal_seq"], jskipped) == (5, 1)


def test_recover_requires_a_committed_snapshot(tmp_path):
    with pytest.raises(FileNotFoundError):
        RecoveryManager.recover(str(tmp_path), device="cpu")


def test_validation_happens_before_wal_logging(tmp_path):
    g = generators.barabasi_albert_varying(150, 4.0, seed=0)
    svc, _, _, _ = serve_embed.build_service(g, seed=0, batch=16,
                                             device="cpu")
    mgr = RecoveryManager(svc, str(tmp_path), snapshot_every=1000,
                          fsync=False)
    with pytest.raises(ValueError):
        svc.ingest_block(_edges((0, 0)))
    assert mgr.wal.seq == 0
    mgr.close()


# ------------------------------------- a JAX snapshot restored by the port --


def _plan_ops(stream, *, block, churn, seed):
    """The deterministic ingest/retract op list (churn drawn from submitted
    edges), so ops map 1:1 onto WAL records and the durable sequence number
    is the resume index."""
    rng = np.random.default_rng(seed)
    live, ops = [], []
    for s in range(0, len(stream), block):
        blk = np.asarray(stream[s:s + block], np.int64)
        ops.append(("ingest", blk))
        live.extend(map(tuple, blk))
        n_churn = min(int(round(churn * len(blk))), len(live))
        if n_churn:
            pick = rng.choice(len(live), size=n_churn, replace=False)
            ops.append(("retract",
                        np.asarray([live[i] for i in pick], np.int64)))
            gone = set(pick.tolist())
            live = [e for i, e in enumerate(live) if i not in gone]
    return ops


def _apply(svc, ops, start=0):
    for kind, blk in ops[start:]:
        (svc.ingest_block if kind == "ingest" else svc.retract_block)(blk)
    svc.sync()


def _state(svc):
    """Graph and store arrays, cores and baseline, and the counters."""
    arrays, manifest = capture_state(svc, 0)
    return arrays, manifest["stats"]


def _diff(a, b):
    return [k for k in sorted(set(a) | set(b))
            if k not in a or k not in b or not np.array_equal(a[k], b[k])]


def _quiesce(mgr):
    """Join a dead run's snapshot writer and drop its WAL handle."""
    try:
        mgr.wait()
    except (InjectedCrash, InjectedFault):
        pass  # the crash may surface here
    mgr.wal.close()


def test_jax_snapshot_and_wal_restore_to_the_jax_recovered_state(tmp_path):
    """The JAX package runs a stream under WAL + snapshots (store capacity
    below the node count, so the spill tier is in the snapshot) and
    crashes; the port (on the CPU) and the JAX package each recover from a
    copy of that directory and must hold equal state: the snapshot carried
    across bit for bit, the WAL tail replayed through each package's own
    repair. Both then resume the stream and stay equal."""
    g = generators.barabasi_albert_varying(250, 4.0, seed=3)
    jsvc, stream, _, _ = jlaunch.build_service(g, seed=3, batch=16, dim=16,
                                               stream_frac=0.3, capacity=180)
    ops = _plan_ops(stream, block=24, churn=0.25, seed=8)
    waldir = str(tmp_path / "jax")
    mgr = jserve.RecoveryManager(jsvc, waldir, snapshot_every=3, fsync=False)
    jfaults.install(jfaults.FaultPlan.parse("ingest_apply:11:crash"))
    with pytest.raises(jfaults.InjectedCrash):
        _apply(jsvc, ops)
    jfaults.install(None)
    _quiesce(mgr)
    shutil.copytree(waldir, tmp_path / "port")

    jsvc2, jmgr, jrep = jserve.RecoveryManager.recover(waldir, fsync=False)
    svc, pmgr, rep = RecoveryManager.recover(
        str(tmp_path / "port"), device="cpu", fsync=False)
    assert {k: v for k, v in rep.items() if k != "recovery_seconds"} == \
        {k: v for k, v in jrep.items() if k != "recovery_seconds"}
    assert rep["replayed_records"] >= 1 and rep["snapshot_wal_seq"] == 9
    want_arrays, jman = jrecovery.capture_state(jsvc2, 0)
    got_arrays, got_stats = _state(svc)
    assert _diff(got_arrays, want_arrays) == []
    assert got_stats == jman["stats"] and got_stats["edges_ingested"] > 0
    assert svc.store.spilled > 0 and svc.store.device.type == "cpu"
    np.testing.assert_array_equal(svc.cores.baseline,
                                  np.asarray(jsvc2.cores.baseline))
    # both resume the stream and stay equal
    _apply(svc, ops, start=rep["wal_seq"])
    _apply(jsvc2, ops, start=jrep["wal_seq"])
    assert _diff(_state(svc)[0], jrecovery.capture_state(jsvc2, 0)[0]) == []
    pmgr.close()
    jmgr.close()


# ------------------------------------------------------ crash-point sweep --

SWEEP_GRAPH = (300, 4.0, 3)  # barabasi_albert_varying(n, m, seed)
SWEEP_CAPACITY = 200  # below the node count: evictions and the spill tier
SNAPSHOT_EVERY = 4
# the hit each point crashes on: mid-stream, inside both retrains, and in
# the query phase after the stream (flush_dispatch, spill_io promotions)
CRASH_AT = {
    "wal_append": 7,
    "wal_fsync": 9,
    "snapshot_write": 2,
    "snapshot_commit": 1,
    "ingest_apply": 5,
    "device_dispatch": 1,
    "repair": 6,
    "spill_io": 300,
    "flush_dispatch": 2,
    "retrain_plan": 2,
    "retrain_walks": 1,
    "retrain_train": 2,
    "retrain_align": 1,
    "retrain_propagate": 2,
    "retrain_swap": 1,
    "retrain_swap_chunk": 7,
}


def _sweep_attach(svc):
    """The retraining loop of the sweep: attached at build and again by the
    recovery's ``configure`` hook, so replayed retrains re-fire alike."""
    cfg = RetrainConfig(
        n_walks=6, walk_length=12, min_sgns_steps=60,
        sgns=SGNSConfig(dim=svc.store.dim, epochs=0.1, batch=512, seed=3),
        prop_iters=6, swap_chunk=64, seed=3,
    )
    svc.retrain_threshold = 0.02
    svc.set_retrainer(Retrainer(svc, cfg), auto=True, budget=2)


def _sweep_service():
    n, m, seed = SWEEP_GRAPH
    g = generators.barabasi_albert_varying(n, m, seed=seed)
    svc, stream, _, _ = serve_embed.build_service(
        g, seed=seed, batch=16, dim=16, stream_frac=0.3, compact_every=256,
        capacity=SWEEP_CAPACITY, device="cpu")
    _sweep_attach(svc)
    return svc, stream


def _queries(svc):
    """The query phase after the stream: flushes with cold starts and
    promotions from the spill tier."""
    for start in (0, 3):
        svc.embed(np.arange(start, SWEEP_GRAPH[0], 7))


@pytest.fixture(scope="module")
def sweep_twin():
    faults.install(None)
    plan = FaultPlan()  # no rules: counts every point's hits
    svc, stream = _sweep_service()
    ops = _plan_ops(stream, block=24, churn=0.25, seed=21)
    faults.install(plan)
    _apply(svc, ops)
    _queries(svc)
    faults.install(None)
    return ops, _state(svc), dict(plan.counts), svc.stats.retrains


def test_sweep_twin_reaches_every_point(sweep_twin):
    """The uninterrupted twin (no WAL: the log and snapshot points are
    reached in the sweep's own runs) retrains twice and passes every other
    point at least as often as its crash hit."""
    _, _, counts, retrains = sweep_twin
    assert retrains == 2
    for point, hit in CRASH_AT.items():
        if not point.startswith(("wal_", "snapshot_")):
            assert counts.get(point, 0) >= hit, (point, counts.get(point))


@pytest.mark.parametrize("point", faults.POINTS)
def test_crash_at_every_point_recovers_bit_identical(tmp_path, point,
                                                     sweep_twin):
    ops, (truth, truth_stats), _, _ = sweep_twin
    svc, _ = _sweep_service()
    mgr = RecoveryManager(svc, str(tmp_path), snapshot_every=SNAPSHOT_EVERY,
                          fsync=False)
    faults.install(FaultPlan.parse(f"{point}:{CRASH_AT[point]}:crash"))
    with pytest.raises(InjectedCrash):
        _apply(svc, ops)
        _queries(svc)
        mgr.wait()  # a crash in the snapshot writer surfaces here at last
    faults.install(None)
    _quiesce(mgr)

    svc, mgr, report = RecoveryManager.recover(
        str(tmp_path), device="cpu", snapshot_every=SNAPSHOT_EVERY,
        fsync=False, configure=_sweep_attach)
    # ops map 1:1 onto WAL records: resume right after the durable tail;
    # the query phase is not logged, so it runs again whole
    _apply(svc, ops, start=report["wal_seq"])
    _queries(svc)
    got, stats = _state(svc)
    assert _diff(got, truth) == [], f"crash at {point} diverged"
    assert stats == truth_stats
    oracle = core_numbers_host(svc.graph.snapshot())
    assert (svc.cores.core[: len(oracle)] != oracle).sum() == 0
    mgr.close()


# ------------------------------------------------------ graceful degradation


def _svc(n=200, seed=1, dim=16, **kw):
    g = generators.barabasi_albert_varying(n, 4.0, seed=seed)
    svc, stream, _, _ = serve_embed.build_service(
        g, seed=seed, batch=16, dim=dim, stream_frac=0.3, device="cpu", **kw)
    return svc, stream


def test_flush_falls_back_to_stale_rows_then_recovers():
    svc, stream = _svc()
    svc.ingest_edges(stream, block_size=64)
    svc.flush_retries = 0  # no retry sleeps in tests
    known = np.arange(8)
    healthy = svc.embed(known)
    assert not svc.degraded

    faults.install(FaultPlan.parse("flush_dispatch:1+"))  # sticky fault
    degraded = svc.embed(known)
    assert svc.degraded and svc.stats.degraded_queries == len(known)
    np.testing.assert_array_equal(degraded, healthy)

    faults.install(None)  # the device comes back
    after = svc.embed(known)
    assert not svc.degraded
    np.testing.assert_array_equal(after, healthy)


def test_flush_retry_absorbs_transient_fault():
    """A one-shot dispatch fault is retried; the failed attempt's slot
    reservation is undone exactly, so the rows, slots and free list end as
    a fault-free twin's do (the failed attempt's gather ticked the LRU
    clock, as in the JAX package)."""
    (svc, stream), (twin, _) = _svc(capacity=150), _svc(capacity=150)
    for s in (svc, twin):
        s.ingest_edges(stream, block_size=64)
    svc.flush_retries, svc.retry_backoff = 2, 0.0
    nodes = np.arange(svc.graph.n_nodes)[::5]
    faults.install(FaultPlan.parse("flush_dispatch:1"))  # one-shot fault
    out = svc.embed(nodes)
    faults.install(None)
    assert not svc.degraded and svc.stats.degraded_queries == 0
    want = twin.embed(nodes)
    np.testing.assert_array_equal(out, want)
    assert twin.stats.cold_starts > 0
    assert _diff(svc.store.state_dict(), twin.store.state_dict()) == [
        "clock", "last_used"]


def test_dispatch_faults_fall_back_to_the_host_peel():
    """Sticky injected dispatch faults exhaust the retries; every block is
    repaired by the exact host peel instead and the cores stay exact."""
    svc, stream = _svc(n=250, seed=3)
    svc.cores.retry_backoff = 0.0
    faults.install(FaultPlan.parse("device_dispatch:1+:fault"))
    svc.ingest_edges(stream, block_size=24)
    faults.install(None)
    cores = svc.cores
    assert cores.dispatch_recoveries > 0
    assert cores.dispatch_failures == 3 * cores.dispatch_recoveries
    assert cores.resync() == 0


def _raise_runtime(*args, **kwargs):
    raise RuntimeError("kernel launch failed")


def _retrain_cfgs(dim):
    from repro.serve.retrain import RetrainConfig as JCfg

    kw = dict(n_walks=3, walk_length=8, min_sgns_steps=5, prop_iters=3)
    return (RetrainConfig(sgns=SGNSConfig(dim=dim, epochs=0.05, batch=512),
                          **kw),
            JCfg(sgns=JSGNSConfig(dim=dim, epochs=0.05, batch=512,
                                  impl="ref"), **kw))


@pytest.mark.parametrize("where", ["flush", "repair", "retrain"])
def test_a_real_error_propagates_where_jax_absorbs_it(monkeypatch, where):
    """A ``RuntimeError`` that is not an ``InjectedFault`` (a kernel that
    fails to build or launch) raised in the flush dispatch, the repair
    dispatch or a retrain stage propagates out of the port. The JAX package
    catches every ``Exception`` there and degrades instead: stale rows, the
    host re-peel, a rolled-back retrain."""
    from repro.serve.retrain import Retrainer as JRetrainer

    g = generators.barabasi_albert_varying(200, 4.0, seed=1)
    svc, stream, _, _ = serve_embed.build_service(
        g, seed=1, batch=16, dim=16, stream_frac=0.3, device="cpu")
    jsvc, jstream, _, _ = jlaunch.build_service(
        g, seed=1, batch=16, dim=16, stream_frac=0.3, pipeline=False)
    np.testing.assert_array_equal(stream, jstream)
    half = len(stream) // 2
    svc.ingest_edges(stream[:half], block_size=64)
    jsvc.ingest_edges(stream[:half], block_size=64)
    svc.retry_backoff = jsvc.retry_backoff = 0.0
    svc.cores.retry_backoff = jsvc.cores.retry_backoff = 0.0
    cfg, jcfg = _retrain_cfgs(16)
    svc.set_retrainer(Retrainer(svc, cfg))
    jsvc.set_retrainer(JRetrainer(jsvc, jcfg))
    if where == "flush":
        monkeypatch.setattr(type(svc), "_fused_flush", _raise_runtime)
        monkeypatch.setattr(jsvc, "_fused_ro_fn", _raise_runtime)
        monkeypatch.setattr(jsvc, "_fused_wb_fn", _raise_runtime)
        nodes = np.arange(12)
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            svc.embed(nodes)
        jsvc.embed(nodes)
        assert jsvc.degraded and jsvc.stats.degraded_queries == len(nodes)
    elif where == "repair":
        monkeypatch.setattr(type(svc.cores), "_descend_dispatch",
                            _raise_runtime)
        monkeypatch.setattr(type(jsvc.cores), "_descend_dispatch",
                            _raise_runtime)
        svc.cores.policy.mode = jsvc.cores.policy.mode = "region"
        svc.cores.repeel_frac = jsvc.cores.repeel_frac = 1.0
        block = stream[half:half + 24]
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            svc.ingest_block(block)
        assert svc.cores.dispatch_failures == 0
        jsvc.ingest_block(block)
        jsvc.sync()
        assert jsvc.cores.dispatch_recoveries == 1
        assert jsvc.cores.resync() == 0
    else:
        import repro.serve.retrain as jretrain
        import repro_torch.serve.retrain as retrain

        monkeypatch.setattr(retrain, "train_sgns", _raise_runtime)
        monkeypatch.setattr(jretrain, "train_sgns", _raise_runtime)
        pre = svc.store.state_dict()
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            svc.maybe_retrain(force=True)
        assert svc.stats.retrain_failures == 0
        assert jsvc.maybe_retrain(force=True) is None
        assert jsvc.stats.retrain_failures == 1
        assert _diff(svc.store.state_dict(), pre) == []
