"""Live SLO engine: declarative objectives, burn-rate alerts, health().

A copy of the JAX package's ``obs/slo.py`` (pure Python): the same
objectives, defaults, windows and ``health()`` snapshot, so the two
services' SLO views compare number for number.

The metrics registry answers "what are the numbers"; this layer answers
"are we keeping the promises". An :class:`Objective` is a declarative
statement over one observed quantity — *flush latency ≤ 50 ms for 99% of
flushes*, *ingest throughput ≥ 10k edges/s*, *stale-row fraction ≤ 5%*,
*degraded-serving fraction ≤ 1%* — and the :class:`SLOEngine` evaluates
every objective continuously over **rolling time windows** of the events
the serving stack feeds it.

Alerting follows the multi-window burn-rate recipe: with error budget
``1 - objective`` (the fraction of bad events the SLO tolerates), the
**burn rate** of a window is ``bad_fraction / budget`` — 1.0 means the
budget is being spent exactly as fast as the SLO allows, N means N× too
fast. An alert fires only when the burn rate exceeds the objective's
threshold over the **long** window (the regression is sustained, not one
spike) *and* over the **short** window (it is still happening — a
long-window alert alone would keep paging for an hour after the incident
ended). Both windows prune by the engine's clock, injectable for tests.

Two observation styles:

* **event objectives** — the hot path calls ``engine.observe(name, value)``
  per event (each flush's seconds, each block's edges/s). Cost per call is
  one comparison + one deque append; the serving benchmark's
  ``--assert-overhead`` guard runs with the engine attached, so the budget
  covers it.
* **sampled objectives** — quantities that are expensive to compute per
  event (store staleness walks every resident row) register a ``provider``
  callable instead; :meth:`SLOEngine.sample` / :meth:`health` pull a
  reading on demand.

``health()`` returns the full snapshot (per-objective compliance, burn
rates, alert state, and an overall status), and :meth:`publish` exports the
same numbers through the metrics registry (``slo_compliance{slo=}``,
``slo_burn_rate{slo=,window=}``, ``slo_alert{slo=}``,
``slo_alerts_total{slo=}``) so the SLO view ships in every metrics
snapshot next to the raw histograms.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Optional, Tuple

__all__ = ["Objective", "SLOEngine", "default_slos"]


@dataclasses.dataclass(frozen=True)
class Objective:
    """One service-level objective over a single observed quantity.

    ``op`` compares each observation against ``target`` ("<=" for
    latencies/fractions, ">=" for throughputs); an observation that fails
    the comparison is a *bad event*. ``objective`` is the promised good
    fraction (0.99 = 1% error budget). ``long_window`` / ``short_window``
    are the burn-rate windows in engine-clock seconds;
    ``alert_burn_rate`` is the multiple of budget-spend speed that pages.
    """

    name: str
    target: float
    op: str = "<="  # "<=" or ">="
    objective: float = 0.99
    long_window: float = 60.0
    short_window: float = 5.0
    alert_burn_rate: float = 4.0
    description: str = ""

    def __post_init__(self):
        if self.op not in ("<=", ">="):
            raise ValueError(f"op must be '<=' or '>=', got {self.op!r}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError("objective must be in (0, 1)")
        if self.short_window > self.long_window:
            raise ValueError("short_window must not exceed long_window")

    def good(self, value: float) -> bool:
        return (value <= self.target) if self.op == "<=" \
            else (value >= self.target)


class _Window:
    """Rolling (t, good) events over the long window; prunes lazily."""

    __slots__ = ("events",)

    def __init__(self):
        self.events: Deque[Tuple[float, bool]] = deque()

    def add(self, t: float, good: bool, horizon: float) -> None:
        self.events.append((t, good))
        self.prune(t - horizon)

    def prune(self, cutoff: float) -> None:
        ev = self.events
        while ev and ev[0][0] < cutoff:
            ev.popleft()

    def stats(self, now: float, window: float) -> Tuple[int, int]:
        """(bad, total) among events within ``window`` seconds of ``now``."""
        cutoff = now - window
        bad = total = 0
        for t, good in reversed(self.events):
            if t < cutoff:
                break
            total += 1
            bad += not good
        return bad, total


class SLOEngine:
    def __init__(self, *, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._objectives: Dict[str, Objective] = {}
        self._providers: Dict[str, Callable[[], float]] = {}
        self._windows: Dict[str, _Window] = {}
        self._alerting: Dict[str, bool] = {}
        self._alerts_total: Dict[str, int] = {}

    # ---------------------------------------------------------- definition

    def add(
        self,
        objective: Objective,
        *,
        provider: Optional[Callable[[], float]] = None,
    ) -> Objective:
        """Register an objective; ``provider`` makes it sampled-style."""
        if objective.name in self._objectives:
            raise ValueError(f"objective {objective.name!r} already defined")
        self._objectives[objective.name] = objective
        self._windows[objective.name] = _Window()
        self._alerting[objective.name] = False
        self._alerts_total[objective.name] = 0
        if provider is not None:
            self._providers[objective.name] = provider
        return objective

    def names(self):
        return sorted(self._objectives)

    def objective(self, name: str) -> Objective:
        return self._objectives[name]

    # --------------------------------------------------------- observation

    def observe(self, name: str, value: float) -> bool:
        """Record one event; returns whether it was good.

        Hot-path cost: one comparison, one deque append, one amortised
        prune. Unknown names raise — a typo'd observation would otherwise
        silently evaluate no objective at all.
        """
        obj = self._objectives[name]
        good = obj.good(float(value))
        self._windows[name].add(self._clock(), good, obj.long_window)
        return good

    def sample(self, name: Optional[str] = None) -> None:
        """Pull one reading from each (or one) provider-backed objective."""
        names = [name] if name is not None else list(self._providers)
        for n in names:
            provider = self._providers.get(n)
            if provider is not None:
                self.observe(n, float(provider()))

    # ---------------------------------------------------------- evaluation

    def evaluate(self, name: str) -> Dict[str, Any]:
        """Compliance + burn rates + alert state for one objective.

        The alert flag latches through :meth:`_update_alert` so
        ``slo_alerts_total`` counts alert *onsets*, not every evaluation
        while the condition persists.
        """
        obj = self._objectives[name]
        now = self._clock()
        win = self._windows[name]
        win.prune(now - obj.long_window)
        bad_l, n_l = win.stats(now, obj.long_window)
        bad_s, n_s = win.stats(now, obj.short_window)
        budget = 1.0 - obj.objective
        compliance = 1.0 - (bad_l / n_l) if n_l else 1.0
        burn_long = (bad_l / n_l) / budget if n_l else 0.0
        burn_short = (bad_s / n_s) / budget if n_s else 0.0
        alerting = (
            n_l > 0
            and burn_long >= obj.alert_burn_rate
            and burn_short >= obj.alert_burn_rate
        )
        self._update_alert(name, alerting)
        return {
            "target": obj.target,
            "op": obj.op,
            "objective": obj.objective,
            "events": int(n_l),
            "bad_events": int(bad_l),
            "compliance": float(compliance),
            "burn_rate_long": float(burn_long),
            "burn_rate_short": float(burn_short),
            "alert_burn_rate": obj.alert_burn_rate,
            "alerting": bool(alerting),
            "alerts_total": int(self._alerts_total[name]),
        }

    def _update_alert(self, name: str, alerting: bool) -> None:
        if alerting and not self._alerting[name]:
            self._alerts_total[name] += 1
        self._alerting[name] = alerting

    def health(self) -> Dict[str, Any]:
        """Whole-service snapshot: every objective + an overall status.

        ``status`` is ``"alert"`` if any objective's multi-window burn
        condition holds, ``"ok"`` when all objectives have data and none
        alert, ``"no_data"`` when nothing has been observed yet. Sampled
        objectives are pulled first so the snapshot is never staler than
        its own call.
        """
        self.sample()
        objectives = {name: self.evaluate(name) for name in self.names()}
        if not objectives or all(o["events"] == 0
                                 for o in objectives.values()):
            status = "no_data"
        elif any(o["alerting"] for o in objectives.values()):
            status = "alert"
        else:
            status = "ok"
        return {"status": status, "objectives": objectives}

    # ------------------------------------------------------------- exports

    def publish(self, registry) -> None:
        """Export the current health through a metrics registry."""
        health = self.health()
        for name, o in health["objectives"].items():
            registry.gauge("slo_compliance", slo=name).set(o["compliance"])
            registry.gauge(
                "slo_burn_rate", slo=name, window="long"
            ).set(o["burn_rate_long"])
            registry.gauge(
                "slo_burn_rate", slo=name, window="short"
            ).set(o["burn_rate_short"])
            registry.gauge("slo_alert", slo=name).set(int(o["alerting"]))
            c = registry.counter("slo_alerts_total", slo=name)
            c.inc(max(o["alerts_total"] - c.value, 0))
        registry.gauge("slo_healthy").set(
            int(health["status"] != "alert")
        )


def default_slos(
    *,
    flush_p99_s: float = 0.25,
    ingest_edges_per_s: float = 1000.0,
    staleness_fraction: float = 0.5,
    degraded_fraction: float = 0.01,
    clock: Callable[[], float] = time.perf_counter,
    staleness_provider: Optional[Callable[[], float]] = None,
) -> SLOEngine:
    """The serving stack's stock objectives, thresholds overridable.

    Defaults are deliberately loose for CI (shared-runner latency is
    noisy); production deployments tighten them per traffic class. The
    ``degraded`` objective's target is 0 with a tiny budget: any degraded
    flush is a bad event, and the budget/burn windows decide when enough
    of them page.
    """
    eng = SLOEngine(clock=clock)
    eng.add(Objective(
        "flush_latency", flush_p99_s, "<=", objective=0.99,
        description="per-flush wall seconds within target",
    ))
    eng.add(Objective(
        "ingest_rate", ingest_edges_per_s, ">=", objective=0.95,
        description="per-block ingest edges/s at or above target",
    ))
    eng.add(Objective(
        "degraded_serving", 0.0, "<=", objective=1.0 - degraded_fraction,
        description="flushes answered from stale rows (degraded fallback)",
    ))
    eng.add(
        Objective(
            "staleness", staleness_fraction, "<=", objective=0.9,
            description="fraction of store rows with a stale core tag",
        ),
        provider=staleness_provider,
    )
    return eng
