"""Benchmark history series: append-only run records + robust trend slopes.

A copy of the JAX package's ``obs/history.py`` (pure Python): the same
record schema and format, so a series can mix records of both packages.

The pairwise trend gate compares exactly **two** artifacts (previous main vs this
run), so a regression split into many small steps — each under the pairwise
threshold — is invisible. This module keeps a *series* instead: every
``benchmarks/serve_latency.py`` run appends one schema-validated JSON-lines
record to ``results/history/serve_latency.jsonl`` (git SHA, wall-clock
timestamp, artifact ``schema_version``, and the flattened trend metrics —
per-phase repair seconds, query/topk latencies, ingest edges/s, and the
quality series recall@k / link-pred AUC, which drift just as silently as
latency), and ``scripts/trend_serve_latency.py --gate-slope`` fits a robust
**Theil–Sen** trend over the last N records per series, failing CI on
sustained creep that no single-step diff can see.

Theil–Sen (median of all pairwise slopes) rather than least squares: a CI
runner's occasional 3x outlier run drags an OLS line hard but moves the
median-of-slopes barely at all, so a flat-but-noisy series stays flat and a
genuine monotone creep keeps its slope. The gate condition projects the
fitted slope across the fitted window — ``slope * (n-1)`` is the drift the
trend implies over the window — and fails only when that projected drift
exceeds *both* the relative threshold (vs the series median) and the
absolute noise floor, mirroring the pairwise gate's two-threshold shape.

The flatten / per-phase aggregation helpers the pairwise differ has always
used live here now (one definition of "the trend series"), re-exported by
``scripts/trend_serve_latency.py`` for its existing consumers.
"""
from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Any, Dict, List, Optional, Tuple

from .schema import validate_or_raise

__all__ = [
    "SCHEMA_VERSION",
    "HISTORY_SCHEMA",
    "flatten",
    "phase_aggregates",
    "trend_series",
    "direction",
    "git_sha",
    "append_record",
    "load_history",
    "theil_sen",
    "slope_failures",
]

# version of the results/serve_latency.json artifact layout. Bump when a
# section is renamed or its units change; the trend differ refuses to
# compare artifacts across versions (a near-empty diff would read as "all
# flat"), and the history store stamps every record with the version it
# was written under so slope fits never mix units.
SCHEMA_VERSION = 2

# one history record per benchmark run; validated on write AND on read so a
# hand-edited or truncated line fails loudly instead of skewing the slope
HISTORY_SCHEMA = {
    "type": "object",
    "required": ["schema_version", "git_sha", "timestamp", "metrics"],
    "properties": {
        "schema_version": {"type": "integer", "minimum": 1},
        "git_sha": {"type": "string"},
        "timestamp": {"type": "number", "minimum": 0},
        "quick": {"type": "boolean"},
        "metrics": {"type": "object"},
    },
}


def flatten(obj, prefix=""):
    """dict/list tree -> {dotted.key: leaf} (numbers and bools only)."""
    out = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.update(flatten(v, f"{prefix}{k}."))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            out.update(flatten(v, f"{prefix}{i}."))
    elif isinstance(obj, bool):
        out[prefix[:-1]] = int(obj)
    elif isinstance(obj, (int, float)):
        out[prefix[:-1]] = float(obj)
    return out


def phase_aggregates(raw: dict) -> dict:
    """Artifact -> {name: seconds} totals the gates compare.

    Repair phase seconds are summed across every ingest-sweep row plus the
    churn run, keyed by phase name (region / candidates / descend /
    fallback), so the gate tracks where repair time goes overall rather
    than per block size — a single noisy row can't trip it, a systematic
    slowdown in one phase can. Query p50/p99 (the flush-visible latencies)
    ride along as their own rows.
    """
    agg: dict = {}
    sections = list(raw.get("ingest_sweep") or [])
    if raw.get("churn"):
        sections.append(raw["churn"])
    for sec in sections:
        for phase, info in (sec.get("phases") or {}).items():
            agg[phase] = agg.get(phase, 0.0) + float(info.get("seconds", 0))
    for key in ("query_p50_s", "query_p99_s"):
        if key in raw:
            agg[key] = float(raw[key])
    # retrieval latencies (the --topk leg) ride along under their own keys,
    # on both the single-device payload and the sharded section
    for prefix, sec in (("topk", raw.get("topk")),
                        ("sharding.topk", (raw.get("sharding") or {}).get(
                            "topk"))):
        for key in ("query_p50_s", "query_p99_s"):
            if sec and key in sec:
                agg[f"{prefix}.{key}"] = float(sec[key])
    return agg


# metrics where an increase is an improvement; everything else (latencies,
# mismatches, staleness) improves downward. Substring match on the key.
HIGHER_IS_BETTER = (
    "edges_per_s", "qps", "speedup", "auc", "queries", "retrains",
    "recall", "compliance",
)


def direction(key: str) -> int:
    return 1 if any(tok in key for tok in HIGHER_IS_BETTER) else -1


def trend_series(raw: dict) -> Dict[str, float]:
    """Artifact -> the flat series the history store tracks run over run.

    The per-phase seconds + latency aggregates the pairwise gate already
    uses, plus throughput and the **quality** series — recall@k from the
    retrieval oracle harness and held-out link-pred AUC from the retrain
    section — so embedding quality rides the same slope machinery as flush
    p99 (quality drifts just as silently as latency).
    """
    series = dict(phase_aggregates(raw))
    for key in ("ingest_edges_per_s", "qps", "cold_start_fraction"):
        if key in raw:
            series[key] = float(raw[key])
    topk = raw.get("topk") or {}
    if "recall_at_k" in topk:
        series["topk.recall_at_k"] = float(topk["recall_at_k"])
    retrain = raw.get("retrain") or {}
    for key in ("auc_after", "auc_all_after", "staleness_after"):
        if key in retrain:
            series[f"retrain.{key}"] = float(retrain[key])
    slo = raw.get("slo") or {}
    for name, obj in (slo.get("objectives") or {}).items():
        if isinstance(obj, dict) and "compliance" in obj:
            series[f"slo.{name}.compliance"] = float(obj["compliance"])
    return series


def git_sha(cwd: Optional[str] = None) -> str:
    """Current commit SHA, or "unknown" outside a repo / without git."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=cwd, capture_output=True,
            text=True, timeout=10,
        )
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def append_record(
    path: str,
    payload: dict,
    *,
    sha: Optional[str] = None,
    timestamp: Optional[float] = None,
    quick: Optional[bool] = None,
) -> dict:
    """Append one validated history record for ``payload`` to ``path``.

    The record is validated against :data:`HISTORY_SCHEMA` before the write
    (a malformed record must fail at the writer, not skew a later slope
    fit). Returns the record. The parent directory is created on demand so
    a fresh checkout's first benchmark run starts the series.
    """
    record = {
        "schema_version": int(payload.get("schema_version", 1)),
        "git_sha": git_sha() if sha is None else sha,
        "timestamp": float(time.time() if timestamp is None else timestamp),
        "metrics": trend_series(payload),
    }
    if quick is not None:
        record["quick"] = bool(quick)
    validate_or_raise(record, HISTORY_SCHEMA, "history record")
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(record, sort_keys=True) + "\n")
    return record


def load_history(
    path: str, *, last: int = 0, schema_version: Optional[int] = None
) -> List[dict]:
    """Read the JSON-lines history; oldest record first.

    Every line is schema-validated (a truncated tail line — the file is
    append-only, a crashed run can tear it — raises with the line number).
    ``last=N`` keeps only the newest N records; ``schema_version`` filters
    to records written under one artifact version so a slope never spans a
    unit change.
    """
    records: List[dict] = []
    if not os.path.exists(path):
        return records
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"{path}:{lineno}: unreadable history record ({e}) — "
                    f"the history file is append-only JSON-lines; remove "
                    f"the torn line to continue the series"
                ) from e
            validate_or_raise(rec, HISTORY_SCHEMA, f"{path}:{lineno}")
            records.append(rec)
    if schema_version is not None:
        records = [
            r for r in records if r["schema_version"] == schema_version
        ]
    if last > 0:
        records = records[-last:]
    return records


def theil_sen(ys) -> Tuple[float, float]:
    """Robust (slope, intercept) of ``ys`` against x = 0..n-1.

    Theil–Sen: the slope is the **median of all pairwise slopes**, the
    intercept the median of ``y - slope*x``. Up to ~29% of points can be
    arbitrary outliers without moving the estimate — exactly the shared-CI
    -runner failure mode (one run on a loaded machine) that makes a least-
    squares fit useless as a gate. O(n^2) pairs; history windows are tens
    of runs, not thousands.
    """
    ys = [float(y) for y in ys]
    n = len(ys)
    if n < 2:
        return 0.0, ys[0] if ys else 0.0
    slopes = [
        (ys[j] - ys[i]) / (j - i)
        for i in range(n) for j in range(i + 1, n)
    ]
    slope = _median(slopes)
    intercept = _median([y - slope * x for x, y in enumerate(ys)])
    return slope, intercept


def _median(xs: List[float]) -> float:
    xs = sorted(xs)
    n = len(xs)
    if not n:
        return 0.0
    mid = n // 2
    return xs[mid] if n % 2 else 0.5 * (xs[mid - 1] + xs[mid])


def slope_failures(
    records: List[dict],
    *,
    pct: float,
    min_ms: float = 3.0,
    min_abs: float = 0.01,
    min_runs: int = 4,
) -> List[Tuple[str, float, float, float]]:
    """Series whose fitted trend projects past both gate thresholds.

    For every metric present in **all** of the given records (a series a
    run is missing has no comparable trend — e.g. a leg that only some
    invocations enable), fit Theil–Sen over run index and project the
    drift across the window: ``drift = slope * (n - 1)``, signed so that
    positive means *worse* (latencies grow / quality falls, via
    :func:`direction`). A series fails when

    * relative projected drift exceeds ``pct`` percent of the series
      median (scale-free: a 1 ms and a 1 s phase gate identically), and
    * absolute projected drift exceeds the noise floor — ``min_ms``
      milliseconds for seconds-valued series, ``min_abs`` for unitless
      ones (AUC, recall, fractions),

    mirroring the pairwise gate's two-threshold shape so runner jitter on
    tiny phases cannot trip it. Returns
    ``(name, median, projected_drift, rel_pct)`` rows; empty when fewer
    than ``min_runs`` records exist (a two-point "trend" is just the
    pairwise diff the single-step gate already covers).
    """
    if len(records) < max(min_runs, 2):
        return []
    common = set(records[0]["metrics"])
    for rec in records[1:]:
        common &= set(rec["metrics"])
    n = len(records)
    bad = []
    for name in sorted(common):
        ys = [float(r["metrics"][name]) for r in records]
        slope, _ = theil_sen(ys)
        # signed so positive drift == regression for every series
        drift = -direction(name) * slope * (n - 1)
        if drift <= 0:
            continue
        med = abs(_median(ys))
        floor = min_ms * 1e-3 if _is_seconds(name) else min_abs
        if drift <= floor:
            continue
        rel = drift / max(med, 1e-12) * 100.0
        if rel > pct:
            bad.append((name, med, drift, rel))
    return bad


def _is_seconds(name: str) -> bool:
    """Seconds-valued series get the millisecond noise floor; unitless
    series (AUC / recall / fractions / edges-per-s) get the absolute one."""
    if name.endswith("_s") or name.endswith("seconds"):
        return True
    # bare repair phase names (region / candidates / descend / fallback and
    # any future phase) are second aggregates from phase_aggregates
    return not any(
        tok in name
        for tok in ("auc", "recall", "fraction", "per_s", "qps",
                    "compliance", "staleness")
    )
