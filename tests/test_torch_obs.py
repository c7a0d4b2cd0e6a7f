"""The port's ``obs`` layer and the service's SLO and cost hooks against the
JAX package's, on the CPU.

``obs.slo``, ``obs.history`` and ``obs.schema`` are copies: the same event
sequences under an injected clock give the same ``health()`` snapshots and
published gauges, the same validation errors, the same history lines byte
for byte (fixed ``sha`` and ``timestamp``) and the same trend series,
Theil-Sen fits and slope-gate failures. ``obs.device`` is a rewrite: its
``compiled_cost`` of a matmul gives the JAX package's five numbers, and
adds what a hand kernel reckons (``kernels.cost``) without counting the
formula's own ops,
``record_memory`` returns ``{}`` on the CPU in both, ``device_profile("")``
is inactive in both and a CPU profile writes a Chrome trace. Two services
built from one graph and driven through the same blocks and queries, with
the stock SLO engine attached under a frozen clock, report equal health
(event and bad-event counts per objective, status, the sampled staleness)
at loose and at impossible thresholds. ``dispatch_cost_report`` has the JAX
report's keys and leaves the table, slot map and stats as they were.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.obs as jobs
import repro_torch.obs as tobs
from repro.launch import serve_embed as jlaunch
from repro.obs import history as jhistory
from repro_torch.graph import generators
from repro_torch.launch import serve_embed
from repro_torch.obs import history as thistory
from test_torch_serve import lockstep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": jobs, "torch": tobs}


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _flush_engine(obs):
    clk = Clock()
    eng = obs.SLOEngine(clock=clk)
    eng.add(obs.Objective("flush", 0.050, "<=", objective=0.9,
                          long_window=60.0, short_window=5.0,
                          alert_burn_rate=2.0))
    return eng, clk


# Each scenario drives one package's engine with a fake clock and returns
# what it saw; the two packages must see the same.

def _burn_rate_alerts(obs):
    eng, clk = _flush_engine(obs)
    seen = []
    for i, bad in enumerate([True] * 20 + [False] * 10 + [True] * 10):
        clk.t = float(i)
        eng.observe("flush", 0.100 if bad else 0.010)
        seen.append(eng.evaluate("flush"))
    clk.t = 200.0  # everything ages out; the alert clears
    seen.append(eng.evaluate("flush"))
    for i in range(10):  # a fresh onset
        clk.t = 200.0 + i
        eng.observe("flush", 0.100)
    seen.append(eng.health())
    return seen


def _one_spike(obs):
    eng, clk = _flush_engine(obs)
    for i in range(50):
        clk.t = float(i)
        eng.observe("flush", 0.010)
    clk.t = 50.0
    eng.observe("flush", 5.0)
    return [eng.evaluate("flush"), eng.health()]


def _no_data(obs):
    eng, clk = _flush_engine(obs)
    seen = [eng.health(), eng.evaluate("flush")]
    eng.observe("flush", 0.010)
    seen.append(eng.health())
    return seen


def _sampled_provider(obs):
    readings = [0.9, 0.2, 0.9, 0.1]
    eng = obs.SLOEngine(clock=Clock())
    eng.add(obs.Objective("stale", 0.5, "<=", objective=0.9),
            provider=lambda: readings.pop(0))
    seen = [eng.health()]
    eng.sample()
    seen.append(eng.evaluate("stale"))
    seen.append(eng.health())
    return seen


def _published(obs):
    eng, clk = _flush_engine(obs)
    for i in range(10):
        clk.t = float(i)
        eng.observe("flush", 0.100)
    reg = obs.MetricsRegistry()
    eng.publish(reg)
    eng.publish(reg)  # still alerting: the onset counter must not re-count
    return [reg.snapshot()]


def _default_slos(obs):
    clk = Clock()
    eng = obs.default_slos(clock=clk, staleness_provider=lambda: 0.7)
    seen = [eng.names(), eng.health()]
    for i in range(40):
        clk.t = float(i)
        eng.observe("flush_latency", 0.3 if i % 3 == 0 else 0.01)
        eng.observe("ingest_rate", 500.0 + 100.0 * i)
        eng.observe("degraded_serving", float(i == 7))
    seen.append(eng.health())
    return seen


@pytest.mark.parametrize("scenario", [
    _burn_rate_alerts, _one_spike, _no_data, _sampled_provider, _published,
    _default_slos,
], ids=lambda f: f.__name__.strip("_"))
def test_slo_engine_matches_jax(scenario):
    assert scenario(tobs) == scenario(jobs)


def _schema_cases():
    schema = jobs.load_schema(os.path.join(ROOT, "results",
                                           "serve_latency.schema.json"))
    with open(os.path.join(ROOT, "results", "serve_latency.json")) as f:
        good = json.load(f)
    bad = json.loads(json.dumps(good))
    bad["schema_version"] = "two"
    for key in list(bad)[:3]:
        bad.pop(key)
    small = {"type": "object", "required": ["a", "b"],
             "properties": {"a": {"type": ["integer", "null"], "minimum": 1},
                            "b": {"type": "array",
                                  "items": {"enum": ["x", "y"]}},
                            "c": {"type": "number", "maximum": 2.0}}}
    return [(good, schema), (bad, schema),
            ({"a": 0, "b": ["x", "z", 3], "c": True}, small),
            ({"a": None, "b": [], "c": 2.5}, small), ([], small)]


def test_schema_validate_matches_jax():
    from repro_torch.obs import schema as tschema

    for instance, schema in _schema_cases():
        want = jobs.validate(instance, schema)
        assert tobs.validate(instance, schema) == want
        if want:
            with pytest.raises(tobs.SchemaError) as got:
                tobs.validate_or_raise(instance, schema, "artifact")
            with pytest.raises(jobs.SchemaError) as ref:
                jobs.validate_or_raise(instance, schema, "artifact")
            assert str(got.value) == str(ref.value)
    assert tschema.load_schema(os.path.join(
        ROOT, "results", "serve_latency.schema.json")) == _schema_cases()[0][1]


def _payload(seed):
    rng = np.random.default_rng(seed)
    return {
        "schema_version": jhistory.SCHEMA_VERSION,
        "ingest_sweep": [{"phases": {"region": {"seconds": rng.random()},
                                     "descend": {"seconds": rng.random()}}}
                         for _ in range(3)],
        "churn": {"phases": {"region": {"seconds": rng.random()}}},
        "query_p50_s": rng.random() * 1e-2, "query_p99_s": rng.random(),
        "ingest_edges_per_s": 1e4 * rng.random(), "qps": 900.0,
        "cold_start_fraction": 0.02,
        "topk": {"recall_at_k": 1.0, "query_p99_s": 0.03},
        "retrain": {"auc_after": 0.8, "auc_all_after": 0.6,
                    "staleness_after": 0.1},
        "slo": {"status": "ok",
                "objectives": {"flush_latency": {"compliance": 0.99}}},
    }


def test_history_records_match_jax_byte_for_byte(tmp_path):
    for name, hist in (("jax", jhistory), ("torch", thistory)):
        path = str(tmp_path / name / "h.jsonl")
        for i in range(6):
            hist.append_record(path, _payload(i), sha=f"{i:040x}",
                               timestamp=1.5e9 + i,
                               quick=None if i % 2 else True)
    with open(tmp_path / "jax" / "h.jsonl", "rb") as f:
        want = f.read()
    with open(tmp_path / "torch" / "h.jsonl", "rb") as f:
        assert f.read() == want
    path = str(tmp_path / "torch" / "h.jsonl")
    assert thistory.load_history(path, last=3) == jhistory.load_history(
        path, last=3)
    with open(path, "a") as f:
        f.write('{"torn": ')
    with pytest.raises(ValueError) as got:
        thistory.load_history(path)
    with pytest.raises(ValueError) as ref:
        jhistory.load_history(path)
    assert str(got.value) == str(ref.value)


def test_trend_theil_sen_and_slope_gate_match_jax():
    with open(os.path.join(ROOT, "results", "serve_latency.json")) as f:
        artifact = json.load(f)
    for raw in (artifact, _payload(0), _payload(1)):
        assert tobs.trend_series(raw) == jobs.trend_series(raw)
        assert thistory.phase_aggregates(raw) == jhistory.phase_aggregates(
            raw)
    rng = np.random.default_rng(3)
    creep = 0.010 + 0.001 * np.arange(12) + 1e-4 * rng.random(12)
    series = {"query_p99_s": creep,
              "retrain.auc_after": 0.9 - 0.01 * np.arange(12),
              "region": 0.001 + 0.0001 * np.arange(12),
              "qps": 900.0 + 50.0 * rng.standard_normal(12)}
    for ys in series.values():
        assert tobs.theil_sen(ys) == jobs.theil_sen(ys)
    records = [{"schema_version": jhistory.SCHEMA_VERSION,
                "git_sha": f"{i:040x}", "timestamp": float(i),
                "metrics": {k: float(v[i]) for k, v in series.items()}}
               for i in range(12)]
    for kw in ({"pct": 25.0}, {"pct": 5.0}, {"pct": 1.0, "min_ms": 0.0},
               {"pct": 25.0, "min_runs": 20}):
        assert tobs.slope_failures(records, **kw) == jobs.slope_failures(
            records, **kw)
    assert tobs.slope_failures(records, pct=5.0)  # the gate fires here


def test_compiled_cost_of_a_matmul_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((8, 16)).astype(np.float32)
    b = rng.standard_normal((16, 4)).astype(np.float32)
    want = jobs.compiled_cost(jax.jit(lambda x, y: x @ y), jnp.asarray(a),
                              jnp.asarray(b))
    got = tobs.compiled_cost(lambda x, y: x @ y, torch.from_numpy(a),
                             torch.from_numpy(b))
    assert got == want


def test_compiled_cost_adds_the_kernels_reckoned_work():
    """What a hand kernel reckons (here by hand, as a wrapper does after its
    launch) enters ``flops`` and ``bytes_accessed`` of every open tally, and
    the formula's own aten ops are not counted as the call's."""
    from repro_torch.kernels import cost

    rng = np.random.default_rng(1)
    idx = torch.from_numpy(rng.integers(0, 50, (6, 9)).astype(np.int32))
    valid = torch.from_numpy(rng.random((6, 9)) < 0.5)
    emb = torch.from_numpy(rng.standard_normal((50, 8)).astype(np.float32))
    cnt = int(valid.sum())
    nbytes, nops = cnt * 8 * 4 + 6 * 9 * 5 + 6 * 8 * 4, cnt * 8

    with cost.tally() as outer:
        rep = tobs.compiled_cost(
            lambda: cost.reckon(cost.ell_mean, idx, valid, emb))
    assert (rep["flops"], rep["bytes_accessed"]) == (nops, nbytes)
    assert (outer.operations, outer.bytes) == (nops, nbytes)
    cost.reckon(cost.ell_mean, idx, valid, emb)  # no tally open: a no-op
    assert not cost.reckoning()


def test_record_memory_is_empty_on_the_cpu():
    reg = tobs.MetricsRegistry()
    assert tobs.record_memory(reg) == {} == jobs.record_memory(
        jobs.MetricsRegistry())
    assert "device_bytes_in_use" not in json.dumps(reg.snapshot())


def test_device_profile_inactive_without_a_logdir():
    for obs in PACKAGES.values():
        for logdir in ("", None):
            with obs.device_profile(logdir) as status:
                pass
            assert status == {"active": False, "logdir": logdir}


def test_device_profile_writes_a_cpu_trace(tmp_path):
    logdir = str(tmp_path / "prof")
    with tobs.device_profile(logdir) as status:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert status["active"] and "error" not in status
    assert os.path.dirname(status["trace"]) == logdir
    with open(status["trace"]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    # an exception from the block is never caught; the trace still lands
    with pytest.raises(ZeroDivisionError):
        with tobs.device_profile(logdir) as status:
            1 / 0
    assert status["active"] and os.path.exists(status["trace"])


def _services(seed):
    g = generators.barabasi_albert_varying(300, 4.0, seed=seed)
    kw = dict(stream_frac=0.3, dim=16, batch=16, seed=seed)
    svc = serve_embed.build_service(g, device="cpu", **kw)
    jsvc = jlaunch.build_service(g, pipeline=False, **kw)
    return svc, jsvc


@pytest.mark.parametrize("thresholds", [
    dict(flush_p99_s=1e9, ingest_edges_per_s=0.0),
    dict(flush_p99_s=0.0, ingest_edges_per_s=float("inf")),
], ids=["loose", "impossible"])
def test_service_slos_match_jax(thresholds):
    """The same blocks (with churn) and queries through both services, the
    stock engine attached with a frozen clock, so nothing ages out and
    every event's verdict depends on the data and the thresholds only."""
    (svc, stream, _, _), (jsvc, *_) = _services(4)
    engines = [s.attach_slo(clock=lambda: 0.0, **thresholds)
               for s in (svc, jsvc)]
    assert engines[0].names() == engines[1].names()
    assert svc.slo_health() == jsvc.slo_health()
    for rnd in range(2):
        part = stream[rnd * len(stream) // 2:(rnd + 1) * len(stream) // 2]
        lockstep([svc, jsvc], part, 24, 0.1, 5 + rnd)
        nodes = np.random.default_rng(rnd).integers(0, svc.graph.n_nodes, 50)
        np.testing.assert_allclose(svc.embed(nodes), jsvc.embed(nodes),
                                   rtol=1e-5, atol=1e-5)
        health = svc.slo_health()
        assert health == jsvc.slo_health()
        assert svc.store.staleness(svc.cores.core) == jsvc.store.staleness(
            jsvc.cores.core)
    obj = health["objectives"]
    assert obj["ingest_rate"]["events"] == svc.stats.ingest_blocks > 0
    assert obj["flush_latency"]["events"] == svc.stats.flushes > 0
    assert obj["degraded_serving"]["bad_events"] == 0
    assert obj["staleness"]["events"] == 3  # one reading a health()
    impossible = thresholds["flush_p99_s"] == 0.0
    assert obj["flush_latency"]["bad_events"] == (
        svc.stats.flushes if impossible else 0)
    assert health["status"] == ("alert" if impossible else "ok")
    regs = [tobs.MetricsRegistry(), jobs.MetricsRegistry()]
    svc.publish_metrics(regs[0])
    jsvc.publish_metrics(regs[1])
    snaps = [{k: v for k, v in r.snapshot().items() if k.startswith("slo_")}
             for r in regs]
    assert snaps[0] == snaps[1] and snaps[0]


def _stats_fields(stats):
    return {f.name: (list(getattr(stats, f.name))
                     if f.name.endswith("_seconds")
                     else getattr(stats, f.name))
            for f in dataclasses.fields(stats)}


def test_dispatch_cost_report_keeps_the_service_state():
    (svc, stream, _, _), (jsvc, *_) = _services(6)
    lockstep([svc, jsvc], stream[:96], 24, 0.1, 7)
    svc.embed(np.arange(0, 300, 5))
    st = svc.store
    table = st.table().clone()
    slots = st.slot_table().copy()
    slots_dev = st.slot_table_dev().clone()
    stats = _stats_fields(svc.stats)
    rep = svc.dispatch_cost_report()
    want = jsvc.dispatch_cost_report()
    assert set(rep) == set(want)
    b = svc.batch
    assert rep["argument_bytes"] == b * 8 + b * 1 + b * 4  # ids, found, slots
    assert rep["output_bytes"] == b * st.dim * 4 + b  # out, resolved
    assert rep["bytes_accessed"] > 0 and rep["temp_bytes"] == 0
    assert torch.equal(st.table(), table)
    np.testing.assert_array_equal(st.slot_table(), slots)
    assert torch.equal(st.slot_table_dev(), slots_dev)
    assert _stats_fields(svc.stats) == stats
