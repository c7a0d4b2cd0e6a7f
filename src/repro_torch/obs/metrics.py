"""Counters, gauges, and fixed-bucket histograms for the serving stack.

The :class:`MetricsRegistry` is the one place serving numbers accumulate:
ingest edge counts, store hit/cold/spill rates, per-shard gather traffic,
repair-phase and retrain-stage wall time, flush latency. Exports are a JSON
snapshot (what ``benchmarks/serve_latency.py`` derives its artifact sections
from) and Prometheus text exposition format for scraping.

:class:`Histogram` is the bounded replacement for the old append-only
latency lists: it keeps

* **fixed-bucket counts** over the metric's full lifetime (geometric bucket
  upper bounds, Prometheus-style cumulative export), and
* a **bounded ring window** of the most recent ``window`` raw observations
  (default 4096), over which :meth:`percentile` is *exact* — so steady-state
  p50/p99 never pay unbounded memory and never smear over a cold warm-up
  from hours ago. The retained window is the documented semantics: with
  more than ``window`` observations, percentiles describe the latest
  ``window`` samples; bucket counts and count/sum/min/max cover everything.

Like the tracer, a module-level default registry serves the instrumented
stack (:func:`metrics`); tests isolate themselves with :func:`set_metrics`.
"""
from __future__ import annotations

import json
import math
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "metrics",
    "set_metrics",
    "default_latency_buckets",
]


def default_latency_buckets() -> np.ndarray:
    """Geometric upper bounds 1 µs → ~69 s (x2 per bucket), 27 buckets.

    Wide enough for everything the stack times (sub-ms flushes to multi-
    second re-peels) at ~2x resolution; observations past the last edge land
    in the +Inf bucket.
    """
    return 1e-6 * np.power(2.0, np.arange(27))


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Point-in-time value (resident rows, device bytes in use, ...)."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed-bucket histogram + bounded exact-percentile window (see module
    docstring for the retained-window semantics)."""

    kind = "histogram"

    def __init__(
        self,
        buckets: Optional[np.ndarray] = None,
        *,
        window: int = 4096,
    ):
        b = np.asarray(
            default_latency_buckets() if buckets is None else buckets,
            np.float64,
        )
        if b.ndim != 1 or len(b) < 1 or np.any(np.diff(b) <= 0):
            raise ValueError("buckets must be a 1-D increasing array")
        self.buckets = b
        self.counts = np.zeros(len(b) + 1, np.int64)  # last = +Inf bucket
        self.window = int(window)
        if self.window < 1:
            raise ValueError("window must be >= 1")
        self._ring = np.zeros(self.window, np.float64)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # ------------------------------------------------------------- observe

    def observe(self, x: float) -> None:
        x = float(x)
        self.counts[int(np.searchsorted(self.buckets, x, side="left"))] += 1
        self._ring[self.count % self.window] = x
        self.count += 1
        self.sum += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x

    # drop-in for the deques ``ServiceStats`` used to hold
    append = observe

    def clear(self) -> None:
        self.counts[:] = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # ------------------------------------------------------------- windows

    def __len__(self) -> int:
        """#observations retained in the exact-percentile window."""
        return min(self.count, self.window)

    def values(self) -> np.ndarray:
        """Retained window, oldest observation first."""
        if self.count <= self.window:
            return self._ring[: self.count].copy()
        split = self.count % self.window
        return np.concatenate([self._ring[split:], self._ring[:split]])

    def __iter__(self):
        return iter(self.values())

    def __array__(self, dtype=None):
        v = self.values()
        return v if dtype is None else v.astype(dtype)

    def percentile(self, q) -> Any:
        """Exact ``np.percentile`` over the retained window (0 when empty)."""
        v = self.values()
        if not len(v):
            return (
                0.0 if np.isscalar(q) else np.zeros(len(np.atleast_1d(q)))
            )
        return np.percentile(v, q)

    def bucket_percentile(self, q: float) -> float:
        """Percentile estimated from bucket counts alone (lifetime data).

        Linear interpolation inside the winning bucket — accurate to bucket
        resolution; the cross-check that window-exact percentiles and the
        exported bucket counts tell the same story.
        """
        if self.count == 0:
            return 0.0
        cum = np.cumsum(self.counts)
        rank = q / 100.0 * self.count
        i = int(np.searchsorted(cum, rank, side="left"))
        if i >= len(self.buckets):  # ran off into the +Inf bucket
            return float(max(self.max, self.buckets[-1]))
        lo = 0.0 if i == 0 else self.buckets[i - 1]
        hi = self.buckets[i]
        prev = 0 if i == 0 else cum[i - 1]
        in_bucket = max(int(self.counts[i]), 1)
        frac = min(max((rank - prev) / in_bucket, 0.0), 1.0)
        return float(lo + frac * (hi - lo))

    # ------------------------------------------------------------ snapshot

    def snapshot(self) -> Dict[str, Any]:
        p50, p99 = (
            (float(self.percentile(50)), float(self.percentile(99)))
            if self.count
            else (0.0, 0.0)
        )
        return {
            "count": int(self.count),
            "sum": float(self.sum),
            "min": float(self.min) if self.count else 0.0,
            "max": float(self.max) if self.count else 0.0,
            "window": int(self.window),
            "window_len": len(self),
            "p50": p50,
            "p99": p99,
            "buckets": [
                [float(le), int(c)]
                for le, c in zip(
                    list(self.buckets) + [math.inf],
                    np.cumsum(self.counts),
                )
            ],
        }


_METRIC_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


def _label_key(labels: Dict[str, Any]) -> Tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


class MetricsRegistry:
    def __init__(self):
        # name -> (kind, {label_key: metric})
        self._metrics: Dict[str, Tuple[str, Dict[Tuple, Any]]] = {}
        self._help: Dict[str, str] = {}

    def describe(self, name: str, text: str) -> None:
        """Attach the ``# HELP`` text exported for ``name``.

        Metrics never described export their own name as help — the
        exposition format wants a HELP line per family either way."""
        self._help[name] = str(text)

    # ------------------------------------------------------------- creation

    def _get(self, kind: str, name: str, labels: Dict[str, Any], factory):
        entry = self._metrics.get(name)
        if entry is None:
            entry = (kind, {})
            self._metrics[name] = entry
        elif entry[0] != kind:
            raise ValueError(
                f"metric {name!r} is a {entry[0]}, requested {kind}"
            )
        key = _label_key(labels)
        m = entry[1].get(key)
        if m is None:
            m = entry[1][key] = factory()
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(
        self,
        name: str,
        buckets: Optional[np.ndarray] = None,
        window: int = 4096,
        **labels,
    ) -> Histogram:
        return self._get(
            "histogram",
            name,
            labels,
            lambda: Histogram(buckets, window=window),
        )

    def register(self, name: str, metric, *, replace: bool = False, **labels):
        """Adopt an externally owned metric object (e.g. the service's flush
        histogram) so exports read the same instance the owner mutates —
        one source of truth, no copies to drift."""
        kind = metric.kind
        entry = self._metrics.get(name)
        if entry is None:
            entry = (kind, {})
            self._metrics[name] = entry
        elif entry[0] != kind:
            raise ValueError(
                f"metric {name!r} is a {entry[0]}, registering {kind}"
            )
        key = _label_key(labels)
        if key in entry[1] and not replace and entry[1][key] is not metric:
            raise ValueError(f"metric {name!r}{dict(labels)!r} already exists")
        entry[1][key] = metric
        return metric

    # -------------------------------------------------------------- queries

    def get(self, name: str, **labels):
        entry = self._metrics.get(name)
        if entry is None:
            return None
        return entry[1].get(_label_key(labels))

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def series(self, name: str) -> Dict[Tuple, Any]:
        """All labeled instances of ``name`` ({label_key: metric})."""
        entry = self._metrics.get(name)
        return dict(entry[1]) if entry else {}

    def sum_series(self, name: str) -> float:
        """Sum of a counter/gauge across all its label sets (0 if absent)."""
        return float(
            sum(m.value for m in self.series(name).values())
        )

    def reset(self) -> None:
        self._metrics = {}
        self._help = {}

    # -------------------------------------------------------------- exports

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready tree: {name: {kind, series: [{labels, value}]}}."""
        out = {}
        for name in self.names():
            kind, series = self._metrics[name]
            out[name] = {
                "kind": kind,
                "series": [
                    {"labels": dict(key), "value": m.snapshot()}
                    for key, m in sorted(series.items())
                ],
            }
        return out

    def export_json(self, path: str) -> int:
        snap = self.snapshot()
        with open(path, "w") as f:
            json.dump(snap, f, indent=2)
        return len(snap)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (v0.0.4).

        Every family gets a ``# HELP`` line (the :meth:`describe` text, or
        the family name when never described) and label values are escaped
        per the spec — backslash, newline, and double-quote — so a label
        carrying a path or an error message cannot corrupt the exposition.
        """
        lines = []
        for name in self.names():
            kind, series = self._metrics[name]
            pname = _NAME_RE.sub("_", name)
            lines.append(
                f"# HELP {pname} {_escape_help(self._help.get(name, pname))}"
            )
            lines.append(f"# TYPE {pname} {kind}")
            for key, m in sorted(series.items()):
                labels = dict(key)
                if kind in ("counter", "gauge"):
                    lines.append(f"{pname}{_fmt_labels(labels)} {m.value:g}")
                    continue
                cum = np.cumsum(m.counts)
                edges = [f"{le:g}" for le in m.buckets] + ["+Inf"]
                for le, c in zip(edges, cum):
                    lab = dict(labels, le=le)
                    lines.append(f"{pname}_bucket{_fmt_labels(lab)} {int(c)}")
                lines.append(f"{pname}_sum{_fmt_labels(labels)} {m.sum:g}")
                lines.append(
                    f"{pname}_count{_fmt_labels(labels)} {int(m.count)}"
                )
        return "\n".join(lines) + ("\n" if lines else "")

    def export_prometheus(self, path: str) -> int:
        text = self.to_prometheus()
        with open(path, "w") as f:
            f.write(text)
        return len(self._metrics)


def _escape_label(v: Any) -> str:
    """Escape one label value per the exposition format: backslash first
    (so the escapes it introduces are not re-escaped), then newline and
    double-quote."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _escape_help(text: str) -> str:
    """HELP text escapes backslash and newline only (quotes are legal)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(labels: Dict[str, Any]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


# ------------------------------------------------------------ module default

_registry = MetricsRegistry()


def metrics() -> MetricsRegistry:
    """The process-default registry the serve stack records into."""
    return _registry


def set_metrics(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the default registry (tests isolate runs with fresh instances)."""
    global _registry
    _registry = reg
    return reg
