"""Structured span tracing for the serving stack.

A :class:`Tracer` records **nested spans** — named wall-time intervals with
attached attributes (block size, region size, shard id, which backend a
repair phase ran on, ...) — on a monotonic clock. Spans come from three
entry points:

* context manager: ``with tracer.span("serve.flush", batch=64) as sp:
  ... sp.set(cold=3)``;
* decorator: ``@tracer.wrap("retrain.train")``;
* pre-timed: ``tracer.record(name, t0, t1, **attrs)`` for code that already
  measures itself (the incremental-core phase timers hand their intervals
  straight in, so their numbers and the trace are the same measurement).

Disabled tracing is a **zero-work no-op**: ``span()`` returns one shared
:data:`NULL_SPAN` singleton, never touches the clock, and records nothing —
the overhead-guard test asserts this with a counting fake clock, and the
serving benchmark asserts the enabled path stays within a few percent of
ingest throughput.

Exports: JSON-lines (one span per line, machine-diffable) and Chrome
``trace_event`` format (``ph: "X"`` complete events), loadable in
chrome://tracing or https://ui.perfetto.dev. Nesting is reconstructed by the
viewers from containment on the per-thread timeline; ``depth``/``parent``
ride along in ``args`` for programmatic consumers.

**Tail-sampled exemplars.** A latency histogram's p99 tells you a slow
flush happened; it cannot tell you *which* dispatch was slow or what ran
inside it. For a small watch set of span names (``serve.flush``,
``serve.topk``, and every ``repair.*`` phase by default) the tracer keeps a
bounded ring of recent durations per name and, when a closing span exceeds
the ring's tail quantile (adaptive: the threshold tracks the workload, no
hand-tuned cutoff), it retains the span's **full subtree** — every same-
thread span contained in its interval — as an exemplar. Each exemplar is
keyed by the histogram bucket its root duration falls in (the same
geometric bounds :func:`repro_torch.obs.metrics.default_latency_buckets` gives
the serving histograms), so a tail bucket in the metrics snapshot links to
the exact span tree that put it there. Export via
:meth:`Tracer.export_exemplars`; capture costs one sorted-ring quantile per
watched span close and nothing at all for unwatched names.

A module-level default tracer (disabled until :func:`enable` / a launcher's
``--trace`` flag) is what the serve stack instruments against; tests swap in
their own instance via :func:`set_tracer`.
"""
from __future__ import annotations

import functools
import json
import math
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "NULL_SPAN",
    "Span",
    "Tracer",
    "tracer",
    "set_tracer",
    "enable",
    "disable",
    "span",
    "record",
    "DEFAULT_EXEMPLAR_WATCH",
]

# span names the tracer tail-samples exemplars for; a trailing "." matches
# the whole namespace (every repair phase, present and future)
DEFAULT_EXEMPLAR_WATCH = ("serve.flush", "serve.topk", "repair.")


class _NullSpan:
    """Shared do-nothing span returned while tracing is disabled.

    One module-level instance (:data:`NULL_SPAN`) serves every disabled
    ``span()`` call — no allocation, no clock read, no bookkeeping.
    """

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One live interval; created by :meth:`Tracer.span`, closed on exit."""

    __slots__ = ("_tracer", "name", "attrs", "t0", "t1", "depth")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0
        self.t1 = 0.0
        self.depth = 0

    def set(self, **attrs) -> "Span":
        """Attach/overwrite attributes mid-span (e.g. sizes known late)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        t = self._tracer
        stack = t._stack()
        self.depth = len(stack)
        stack.append(self.name)
        self.t0 = t._clock()
        return self

    def __exit__(self, *exc) -> bool:
        t = self._tracer
        self.t1 = t._clock()
        stack = t._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        t._emit(self.name, self.t0, self.t1, self.depth, self.attrs)
        return False


class Tracer:
    def __init__(
        self,
        enabled: bool = False,
        *,
        clock: Callable[[], float] = time.perf_counter,
        max_events: int = 1_000_000,
        exemplar_watch: Tuple[str, ...] = DEFAULT_EXEMPLAR_WATCH,
        exemplar_quantile: float = 99.0,
        exemplar_min_samples: int = 16,
        exemplar_ring: int = 512,
        max_exemplars: int = 64,
    ):
        self.enabled = bool(enabled)
        self._clock = clock
        self.max_events = int(max_events)
        self.events: List[Dict[str, Any]] = []
        self.dropped = 0  # events past max_events (never silently truncated)
        self._local = threading.local()
        # tail-sampled exemplars: per watched name, a bounded duration ring
        # drives the adaptive threshold; exemplars are keyed by (name,
        # histogram-bucket index) and keep the slowest capture per bucket
        self.exemplar_watch = tuple(exemplar_watch or ())
        self.exemplar_quantile = float(exemplar_quantile)
        self.exemplar_min_samples = int(exemplar_min_samples)
        self._exemplar_ring = int(exemplar_ring)
        self.max_exemplars = int(max_exemplars)
        self.exemplars: Dict[Tuple[str, int], Dict[str, Any]] = {}
        self.exemplars_dropped = 0
        self._tail_durs: Dict[str, deque] = {}
        self._bucket_bounds: Optional[List[float]] = None

    # ------------------------------------------------------------- recording

    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _emit(self, name, t0, t1, depth, attrs) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        tid = threading.get_ident() & 0xFFFF
        self.events.append(
            {
                "name": name,
                "ts": t0,
                "dur": t1 - t0,
                "depth": depth,
                "tid": tid,
                "attrs": attrs,
            }
        )
        if self.exemplar_watch and self._watched(name):
            self._note_tail(name, t0, t1, depth, tid)

    # ------------------------------------------------------------ exemplars

    def _watched(self, name: str) -> bool:
        for pat in self.exemplar_watch:
            if name == pat or (pat.endswith(".") and name.startswith(pat)):
                return True
        return False

    def _note_tail(self, name, t0, t1, depth, tid) -> None:
        """Adaptive tail check for one closed watched span.

        The threshold is the ring's ``exemplar_quantile`` over the most
        recent durations of this *name* — the workload defines its own
        tail, a cold-start outlier ages out of the ring. The closing span
        is compared before it joins the ring, so a new all-time-slowest
        dispatch is always eligible.
        """
        ring = self._tail_durs.get(name)
        if ring is None:
            ring = self._tail_durs[name] = deque(maxlen=self._exemplar_ring)
        dur = t1 - t0
        if len(ring) >= self.exemplar_min_samples:
            ordered = sorted(ring)
            rank = max(
                int(math.ceil(self.exemplar_quantile / 100.0 * len(ordered)))
                - 1,
                0,
            )
            threshold = ordered[rank]
            if dur > threshold:
                self._capture_exemplar(name, t0, t1, depth, tid, threshold)
        ring.append(dur)

    def _bucket_of(self, dur: float) -> Tuple[int, float, float]:
        """(index, lower, upper) of the latency-histogram bucket holding
        ``dur`` — the same geometric bounds the serving histograms use, so
        an exemplar's key matches the exported bucket it explains."""
        if self._bucket_bounds is None:
            from .metrics import default_latency_buckets

            self._bucket_bounds = [float(b) for b in
                                   default_latency_buckets()]
        b = self._bucket_bounds
        lo_idx, hi_idx = 0, len(b)
        while lo_idx < hi_idx:  # searchsorted(b, dur, side="left")
            mid = (lo_idx + hi_idx) // 2
            if b[mid] < dur:
                lo_idx = mid + 1
            else:
                hi_idx = mid
        lower = 0.0 if lo_idx == 0 else b[lo_idx - 1]
        upper = b[lo_idx] if lo_idx < len(b) else math.inf
        return lo_idx, lower, upper

    def _capture_exemplar(self, name, t0, t1, depth, tid, threshold) -> None:
        dur = t1 - t0
        idx, lower, upper = self._bucket_of(dur)
        key = (name, idx)
        prev = self.exemplars.get(key)
        if prev is not None and prev["dur"] >= dur:
            return  # keep the slowest representative per (name, bucket)
        if prev is None and len(self.exemplars) >= self.max_exemplars:
            self.exemplars_dropped += 1
            return
        # subtree = every same-thread span contained in the root interval.
        # Same-thread events land in close order (monotone end time), so
        # the scan stops at the first same-thread span ending before t0;
        # other threads' events interleave and are skipped.
        spans = []
        for e in reversed(self.events):
            if e["tid"] != tid:
                continue
            if e["ts"] + e["dur"] < t0:
                break
            if e["ts"] >= t0 and e["ts"] + e["dur"] <= t1 \
                    and e["depth"] >= depth:
                spans.append(dict(e))
        spans.reverse()
        self.exemplars[key] = {
            "name": name,
            "ts": t0,
            "dur": dur,
            "threshold": float(threshold),
            "bucket_index": idx,
            "bucket_lower_s": lower,
            "bucket_le_s": upper if math.isfinite(upper) else None,
            "tid": tid,
            "spans": spans,
        }

    def span(self, name: str, **attrs) -> Any:
        """Open a nested span; returns :data:`NULL_SPAN` when disabled."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, attrs)

    def record(self, name: str, t0: float, t1: float, **attrs) -> None:
        """Log an already-measured ``[t0, t1]`` interval as a complete span.

        ``t0``/``t1`` must come from this tracer's clock (the default is
        ``time.perf_counter``, which the serve stack's own timers use) so
        pre-timed spans land on the same timeline as context-manager ones.
        """
        if not self.enabled:
            return
        self._emit(name, t0, t1, len(self._stack()), attrs)

    def wrap(self, name: Optional[str] = None) -> Callable:
        """Decorator form: the wrapped call body becomes one span."""

        def deco(fn):
            span_name = name or fn.__qualname__

            @functools.wraps(fn)
            def inner(*args, **kwargs):
                if not self.enabled:
                    return fn(*args, **kwargs)
                with Span(self, span_name, {}):
                    return fn(*args, **kwargs)

            return inner

        return deco

    def reset(self) -> None:
        self.events = []
        self.dropped = 0
        self._local = threading.local()
        self.exemplars = {}
        self.exemplars_dropped = 0
        self._tail_durs = {}

    # --------------------------------------------------------------- exports

    def span_names(self) -> set:
        return {e["name"] for e in self.events}

    def export_jsonl(self, path: str) -> int:
        """One JSON object per line per span; returns #spans written."""
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps(e) + "\n")
        return len(self.events)

    def chrome_events(self) -> List[Dict[str, Any]]:
        """Spans as Chrome ``trace_event`` complete ("X") events.

        Timestamps/durations are microseconds since the first recorded span;
        ``pid`` is constant, ``tid`` the recording thread, so nesting renders
        from interval containment on each thread's track.
        """
        t_base = min((e["ts"] for e in self.events), default=0.0)
        out = []
        for e in self.events:
            args = dict(e["attrs"])
            args["depth"] = e["depth"]
            out.append(
                {
                    "name": e["name"],
                    "ph": "X",
                    "ts": (e["ts"] - t_base) * 1e6,
                    "dur": e["dur"] * 1e6,
                    "pid": 0,
                    "tid": e["tid"],
                    "args": args,
                }
            )
        return out

    def export_chrome(self, path: str) -> int:
        """Write the Chrome/Perfetto ``trace_event`` JSON; returns #spans."""
        payload = {
            "traceEvents": self.chrome_events(),
            "displayTimeUnit": "ms",
        }
        if self.dropped:
            payload["metadata"] = {"dropped_events": self.dropped}
        with open(path, "w") as f:
            json.dump(payload, f)
        return len(self.events)

    def exemplar_records(self) -> List[Dict[str, Any]]:
        """Exemplars ordered by (name, bucket index), JSON-ready."""
        return [self.exemplars[k] for k in sorted(self.exemplars)]

    def export_exemplars(self, path: str) -> int:
        """Write retained tail exemplars as JSON; returns #exemplars.

        Each record links a histogram bucket (``bucket_lower_s`` <
        ``dur`` <= ``bucket_le_s``) to the full span subtree of the slow
        dispatch that landed in it.
        """
        payload = {
            "exemplars": self.exemplar_records(),
            "dropped": self.exemplars_dropped,
            "quantile": self.exemplar_quantile,
            "watch": list(self.exemplar_watch),
        }
        with open(path, "w") as f:
            json.dump(payload, f)
        return len(self.exemplars)


# ------------------------------------------------------------ module default

_tracer = Tracer(enabled=False)


def tracer() -> Tracer:
    """The process-default tracer the serve stack is instrumented against."""
    return _tracer


def set_tracer(t: Tracer) -> Tracer:
    """Swap the default tracer (tests install fake-clock instances)."""
    global _tracer
    _tracer = t
    return t


def enable(**kwargs) -> Tracer:
    """Install a fresh enabled default tracer and return it."""
    return set_tracer(Tracer(enabled=True, **kwargs))


def disable() -> Tracer:
    """Disable default tracing (spans become the shared no-op singleton)."""
    _tracer.enabled = False
    return _tracer


def span(name: str, **attrs) -> Any:
    """``tracer().span(...)`` — the form instrumented code calls."""
    t = _tracer
    if not t.enabled:
        return NULL_SPAN
    return Span(t, name, attrs)


def record(name: str, t0: float, t1: float, **attrs) -> None:
    """``tracer().record(...)`` for pre-timed intervals."""
    t = _tracer
    if t.enabled:
        t._emit(name, t0, t1, len(t._stack()), attrs)
