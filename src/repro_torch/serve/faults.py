"""Deterministic fault injection for the serving stack.

A copy of the JAX package's ``serve/faults.py`` (pure Python): the same
injection points and spec grammar, so one plan string drives both packages.

A :class:`FaultPlan` names *injection points* — fixed call sites threaded
through the serve stack (``faults.check("wal_append")`` etc.) — and for
each point says on which hit to fire and what to raise. Plans are parsed
from a compact spec string so the launcher and benchmark can drive
crash-point sweeps from the command line::

    wal_append:1:crash          # crash on the 1st wal_append hit
    device_dispatch:3+          # fault on every hit from the 3rd on
    retrain_swap_chunk:2:fault  # fault on the 2nd swap chunk only

Two distinct failure semantics:

* :class:`InjectedFault` (a ``RuntimeError``) models a *recoverable*
  failure — a device dispatch error, a flaky IO call. Degradation paths
  (retry loops, ref fallback, transactional retrain) are expected to
  catch it.
* :class:`InjectedCrash` (a ``BaseException``) models *process death*.
  No ``except Exception`` handler may swallow it; the harness catches it
  at top level and recovers from durable state (snapshot + WAL), exactly
  as a restarted process would.

When no plan is installed, :func:`check` is a near-no-op (one global
load + ``is None`` test), so production paths pay nothing.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


class InjectedFault(RuntimeError):
    """Recoverable injected failure (device error, IO error, ...)."""


class InjectedCrash(BaseException):
    """Simulated process death. Deliberately NOT an ``Exception`` so no
    recovery/degradation handler can swallow it — only the top-level
    harness (standing in for a process restart) catches it."""


#: every injection point threaded through the stack, for --help text and
#: sweep enumeration. Keep in sync with the ``check()`` call sites.
POINTS = (
    "wal_append",        # mid-WAL-append: half the record hits disk
    "wal_fsync",         # after write, before fsync: record lost cleanly
    "snapshot_write",    # after state.npz, before manifest/_COMMITTED
    "snapshot_commit",   # after _COMMITTED, before tmp-dir rename
    "ingest_apply",      # after the WAL append, before graph mutation
    "device_dispatch",   # inside the fused descent dispatch
    "repair",            # top of IncrementalCore.begin_update
    "spill_io",          # store spill tier IO (evict / promote)
    "flush_dispatch",    # the cold-start gather dispatch in _flush_batch
    "retrain_plan",
    "retrain_walks",
    "retrain_train",
    "retrain_align",
    "retrain_propagate",
    "retrain_swap",
    "retrain_swap_chunk",  # mid-commit: the mixed-version window
)


@dataclass
class _Rule:
    hit: int            # fire on the Nth hit (1-based)
    sticky: bool        # "N+": keep firing on every hit >= N
    crash: bool         # raise InjectedCrash instead of InjectedFault


@dataclass
class FaultPlan:
    """Seeded, deterministic fault schedule over named injection points."""

    rules: Dict[str, _Rule] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    fired: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """``"point:hit[:mode],..."`` -> plan. hit = ``N`` or ``N+``;
        mode in {fault, crash} (default fault)."""
        plan = cls()
        for part in filter(None, (p.strip() for p in spec.split(","))):
            bits = part.split(":")
            if len(bits) not in (2, 3):
                raise ValueError(
                    f"bad fault spec {part!r}: want point:hit[:mode]"
                )
            point, hit = bits[0], bits[1]
            mode = bits[2] if len(bits) == 3 else "fault"
            if point not in POINTS:
                raise ValueError(
                    f"unknown fault point {point!r}; known: {', '.join(POINTS)}"
                )
            if mode not in ("fault", "crash"):
                raise ValueError(f"bad fault mode {mode!r} in {part!r}")
            sticky = hit.endswith("+")
            n = int(hit[:-1] if sticky else hit)
            if n < 1:
                raise ValueError(f"hit index must be >= 1 in {part!r}")
            plan.rules[point] = _Rule(hit=n, sticky=sticky,
                                      crash=(mode == "crash"))
        return plan

    def check(self, point: str) -> None:
        """Count a hit at ``point``; raise if a rule says so."""
        self.counts[point] = self.counts.get(point, 0) + 1
        rule = self.rules.get(point)
        if rule is None:
            return
        n = self.counts[point]
        if n == rule.hit or (rule.sticky and n > rule.hit):
            self.fired[point] = self.fired.get(point, 0) + 1
            _count_fired(point)
            if rule.crash:
                raise InjectedCrash(f"injected crash at {point} (hit {n})")
            raise InjectedFault(f"injected fault at {point} (hit {n})")

    @property
    def total_fired(self) -> int:
        return sum(self.fired.values())


_PLAN: Optional[FaultPlan] = None


def install(plan: Optional[FaultPlan]) -> None:
    """Install (or clear, with ``None``) the process-wide fault plan."""
    global _PLAN
    _PLAN = plan


def active() -> Optional[FaultPlan]:
    return _PLAN


def check(point: str) -> None:
    if _PLAN is None:
        return
    _PLAN.check(point)


def _count_fired(point: str) -> None:
    try:
        from repro_torch.obs import metrics
        metrics().counter("faults_injected_total", point=point).inc()
    except Exception:
        pass
