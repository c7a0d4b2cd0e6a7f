"""Incremental core-number maintenance under edge insertion *and* deletion.

The torch counterpart of ``repro.serve.kcore_inc``; the repair itself is the
same exact algorithm.

The offline path peels the whole graph (``core_numbers_host``, O(E)); doing
that per streamed edge would make ingestion quadratic. Streams admit exact
local repair instead (Sarıyüce et al., "Streaming algorithms for k-core
decomposition", VLDB 2013), and this module batches that repair over whole
**edge blocks**: one region discovery + one h-index descent per block,
instead of one per edge.

Block repair (``on_edge_block`` / ``on_remove`` / ``on_update``):

* All mutations of the block are first applied to the graph. The nodes whose
  core number can change lie in a **union subcore**: nodes reachable from any
  block endpoint through nodes whose old core number falls in a level window
  around the block's endpoint levels (purecore-style traversal; for a single
  insertion the window degenerates to the classical "core == K" subcore).
* Candidates are seeded at an upper bound of their new core number
  (``min(new_degree, old_core + #inserted)``, one vectorized gather from the
  graph's maintained degree array) and swept with the *same* row-masked
  h-index operator the offline device fixpoint uses
  (``repro_torch.kernels.ops.h_index_sweep``, the CUDA kernel on the card), with
  non-candidate neighbours frozen at their true (unchanged) core numbers.
  The operator is monotone, so the sweep descends to the exact new core
  numbers (Lü et al. 2016).
* A block can cascade promotions/demotions across several levels, so the
  window half-width is **adaptive**: the repair re-runs with a wider window
  whenever the computed level changes touch the window boundary. Single-edge
  repairs never widen.
* **Measured repair policy** (``repair_policy="adaptive"``, the default):
  instead of the old static trigger (abort region discovery past
  ``repeel_frac * n`` and re-peel the whole graph — which on real block sizes
  meant the fused descent *never* ran), the maintainer predicts both paths'
  cost from per-regime EMAs of its own measured phase seconds (the same
  intervals exported as ``repair_phase_seconds{phase=}`` through the metrics
  registry, which also warm-starts the priors across maintainer instances in
  one process) and runs whichever is cheaper. Cold start — before either
  path has been measured — falls back to a shape heuristic: descend unless
  the padded candidate matrix dwarfs the affected-shell arc mass
  (``cold_cells_per_arc``) or busts ``descend_budget``. ``"region"``
  restores the legacy static trigger for A/B runs; ``"fallback"`` always
  re-peels.
* **Shell-incremental re-peel**: when re-peeling *is* chosen (or forced by a
  truncated descent), only the shells at level ``<= hi`` (the repair
  window's top) are re-peeled — upper shells are frozen and enter as
  boundary degrees (``core.kcore.core_numbers_shell_peel``), so fallback
  cost scales with the affected sub-level set, not the graph. A survivor
  past ``hi`` disproves the freeze (possible only under insertions) and
  widens ``hi`` until certified; deletions-only blocks can never hit the
  ceiling. Exactness argument in ``core_numbers_shell_peel``'s docstring.

* **Pipelined handoff**: ``begin_update`` runs region discovery + the policy
  decision and *enqueues* the descent's first chunk of sweeps on the device
  without reading anything back; ``finish_update`` reads the chunk's
  result once (enqueuing longer chunks until the fixed point, see below),
  runs any window widenings, and commits. ``on_update`` is simply the two
  back-to-back; the serving layer calls them split so block N+1's host-side
  dedup/WAL append overlaps block N's descent on the device. Every other
  public entry point settles an in-flight ticket first, so results are
  bit-identical to the serial path.

A descent dispatch that raises the fault harness's ``InjectedFault`` is
retried ``dispatch_retries`` times with backoff, then the block is repaired
by the exact host peel (``dispatch_failures`` / ``dispatch_recoveries``
count both); any other error — a kernel that fails to build or launch —
propagates to the caller.

Device-resident path (``impl="device"``, the ``"auto"`` default) — the
choices follow where the graph lives. On CUDA the maintainer makes the
choices the JAX package makes on TPU: region growing on the device
(``"jit"``), the CUDA h-index kernel for every sweep (``"cuda"``), and the
re-peel as a fused descent over every node (``"descend"``). On the CPU it
makes the JAX package's CPU choices (``"np"`` / ``"count"`` /
``"shell"``). Every mode stays selectable.

* **Region growing** is a frontier-masked traversal: boolean frontier /
  visited masks expanded one level per step with the ``[lo, hi]`` core-window
  filter applied in bulk, plus a **side table** of extra arcs (the removed
  block edges, so deletions keep their discovery path, and the overflow arcs
  the device mirror cannot see between compactions). On CUDA it runs as a
  torch loop over the ``DynamicGraph`` device ELL mirror
  (``_region_fixpoint``, one host read of the frontier flag per level);
  elsewhere the same traversal runs as vectorized numpy over the host table.
* **Candidate matrices** come from one vectorized gather
  (``DynamicGraph.gather_rows``), trimmed to the candidates' true max degree
  and split into a narrow and a hub tier.
* **The h-index descent** (``_Descent``) seeds, sweeps to the fixed point
  and computes the adaptive-window boundary statistics on the device; each
  sweep applies ``kernels.ops.h_index_sweep`` per tier (the CUDA kernel on
  the card, the sort-free counting search on the CPU). Sweeps are enqueued
  in **chunks** with no host read between them; a device counter adds up
  the sweeps that changed an estimate, and one host read per chunk brings
  back that count, the last sweep's flag, the boundary statistics and the
  estimates. Chunks double until a sweep changes nothing or ``max_sweeps``
  have run; the first chunk is the sweep count of the last descent of the
  same kind (a block with insertions, a deletions-only block, an all-node
  re-peel) rounded up to a power of two, at least 4: an insert block's descent takes several times the sweeps of
  the deletions that follow it, so one history for both overshoots. The
  operator is monotone, so a sweep that changes nothing is a fixed point
  and the sweeps after it change nothing either: the result, ``sweeps``
  (``min(max_sweeps, changed sweeps + 1)``, the JAX package's count) and
  truncation (the sweep at ``max_sweeps`` still changed) do not depend on
  the chunking. ``sweeps_enqueued`` and ``descent_reads`` count the sweeps
  the device ran and the host reads, beside ``sweeps``.
* **The re-peel** is the same descent seeded over *all* nodes on CUDA; on
  the CPU it is the shell-incremental or vectorized rounds peel fed straight
  from the graph's arc arrays.

The original host path survives as ``impl="ref"`` — the dict/set BFS, the
per-iteration sort-based sweep, and the snapshot re-peel — and doubles as the
correctness oracle for the device path. ``phase_report()`` exposes per-phase
wall time (region / candidates / descend / fallback) and which backend each
phase ran on.

Core-number **drift** (how many nodes changed level since the embedding table
was last refreshed) is the staleness signal the store/service use to gate
retraining: the paper's §2.2 propagation stays valid while the k0-core is
stable, and drift in deep shells — in either direction, now that edges can
be retracted — is what invalidates it.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core.kcore import (
    core_numbers_host,
    core_numbers_rounds,
    core_numbers_shell_peel,
    h_index_sweep,
)
from repro_torch.kernels import ops as kops
from repro_torch.obs import metrics
from repro_torch.obs import trace as obs

from . import faults
from .shard import replicas, row_chunks, ship
from .stream import DynamicGraph
from .util import pow2

__all__ = ["IncrementalCore", "RepairPolicy"]

_EMPTY = np.zeros((0, 2), np.int64)

# two-tier descent split: rows with degree <= this go in the narrow matrix
_W_SMALL = 32

# size-distribution buckets (region node counts): powers of 4 up to ~4M
_COUNT_BUCKETS = 4.0 ** np.arange(12)


class _Descent:
    """One h-index descent on the candidates' device, enqueued in chunks.

    ``tiers``: list of ``(idx, valid)`` candidate neighbour matrices (global
    node ids, padding = sentinel) whose rows, concatenated, line up with
    ``cand`` (R,) candidate ids (padded rows point at the sentinel, whose
    estimate stays 0); ``seed``: (R,) upper bound on the new cores;
    ``old``: (R,) old cores (0 on padded rows); ``est_full``:
    (node_cap + 1,) frozen boundary = current cores, left as it is (the
    descent sweeps a copy). One tier is the plain ELL matrix; two are the
    narrow + hub split, each sweep applying the same row operator to both
    against the shared estimate, so the fixpoint trajectory is the same.

    :meth:`sweep` enqueues sweeps and reads nothing back: the ``changed``
    flag of each stays on the device, where ``n_changed`` adds them up.
    :meth:`read` is the one host read of a chunk: the changed-sweep count,
    the last sweep's flag, the adaptive-window boundary statistics of the
    current estimates, and the estimates themselves.

    Under a ``ShardPlan`` each tier's matrices are ``RowSharded`` and
    ``est_full`` is ``Replicated``: every sweep launches the sweep once per
    tier per shard, on that shard's device against its copy of the
    estimate; the new estimates are gathered and written to every copy (the
    all-gather), and ``changed`` is taken over all shards' rows. The
    operator is per row, so the integers are the unsharded ones. The copies
    count in ``plan.traffic["descent"]``, the sweeps past the fixed point
    included.
    """

    def __init__(self, tiers, cand, seed, old, est_full, lo, hi, *,
                 impl: str):
        self.plan = plan = getattr(est_full, "plan", None)
        self.tiers, self.impl = tiers, impl
        self.old, self.lo, self.hi = old, lo, hi
        cand = cand.long()
        self.est = {d: e.clone() for d, e in replicas(est_full).items()}
        self.cands = {d: cand.to(d) for d in self.est}
        for d, e in self.est.items():
            e[self.cands[d]] = seed.to(d)
        if plan is not None:
            plan.note_fanout("descent", cand, seed)
        self.cur = seed
        self.n_changed = torch.zeros((), dtype=torch.int32,
                                     device=seed.device)
        self.last = torch.ones((), dtype=torch.bool, device=seed.device)
        self.enqueued = 0  # sweeps enqueued
        self.reads = 0  # host reads

    def sweep(self, n: int) -> None:
        """Enqueue ``n`` more sweeps."""
        plan, est, cur = self.plan, self.est, self.cur
        for _ in range(n):
            new = torch.cat([
                ship(kops.h_index_sweep(
                    est[ci.device][ci], cv,
                    ship(part[a:a + len(ci)], ci.device, plan, s, "descent"),
                    impl=self.impl,
                ), cur.device, plan, s, "descent")
                for (idx, valid), part in zip(
                    self.tiers,
                    torch.split(cur, [t[0].shape[0] for t in self.tiers]))
                for s, ((a, ci), (_, cv)) in enumerate(
                    zip(row_chunks(idx), row_chunks(valid)))
            ])
            for d, e in est.items():
                e[self.cands[d]] = new.to(d)
            if plan is not None:
                plan.note_fanout("descent", new)
            self.last = (new != cur).any()
            self.n_changed += self.last
            cur = new
        self.cur = cur
        self.enqueued += n

    def read(self):
        """The one host read of a chunk: ``((n_changed, last_changed,
        max_gain, max_loss, ceiling_hit, floor_hit), estimates)`` as host
        integers and an int32 array."""
        cur, old = self.cur, self.old
        head = torch.stack([
            self.n_changed, self.last.to(torch.int32),
            (cur - old).clamp_min(0).amax(),
            (old - cur).clamp_min(0).amax(),
            # only *changed* nodes at/past the boundary suggest a truncated
            # cascade; an unchanged high-core endpoint legitimately sits
            # above the window
            ((cur > self.hi) & (cur > old)).any().to(torch.int32),
            ((cur < self.lo) & (cur < old)).any().to(torch.int32),
        ])
        host = torch.cat([head, cur]).cpu().numpy()
        self.reads += 1
        return tuple(int(x) for x in host[:6]), host[6:]


def _region_fixpoint(nbr, deg, core, ends, side_src, side_dst, lo, hi, cap,
                     sentinel):
    """Frontier-masked union-subcore traversal on the mirror's device.

    ``nbr``/``deg`` are the device ELL mirror; ``side_*`` the side table of
    extra arcs (removed block edges + overflow arcs the mirror cannot see).
    Expands boolean frontier/visited masks one level per iteration, reading
    only the frontier's rows, filtering discovered nodes by old core in
    ``[lo, hi]``; endpoints are pre-seeded regardless of their level.
    Stops early once the visited count exceeds ``cap`` (the caller then
    falls back to a full recompute, so a partial region is never used).
    Returns ``(visited, count)``.

    Under a ``ShardPlan`` the mirror is ``RowSharded``: each shard expands
    the frontier over its own rows on its device, and the discovered sets
    are OR-ed into one mask on the primary device; the masks and the side
    table stay there (replicated state, one copy). The copies count in
    ``plan.traffic["region"]``.
    """
    eligible = (core >= lo) & (core <= hi)
    eligible[sentinel] = False  # padding never joins a region
    visited = ends.clone()
    frontier = ends
    plan = getattr(nbr, "plan", None)
    shards = [(s, a, c, d, torch.arange(c.shape[1], device=c.device))
              for s, ((a, c), (_, d)) in enumerate(zip(row_chunks(nbr),
                                                       row_chunks(deg)))]
    count = int(visited.sum())
    while count <= cap:
        rows = [ship(frontier[a:a + len(nb)], nb.device, plan, s,
                     "region").nonzero().flatten()
                for s, a, nb, _, _ in shards]
        if not any(len(r) for r in rows):
            break
        nxt = torch.zeros_like(visited)
        for (s, _, nb, dg, iota), r in zip(shards, rows):
            live = iota[None, :] < dg[r][:, None]
            hit = torch.where(live, nb[r], sentinel).flatten().long()
            nxt[ship(hit, nxt.device, plan, s, "region")] = True
        if len(side_src):
            hit = frontier[side_src]
            nxt[torch.where(hit, side_dst, sentinel)] = True
        frontier = nxt & eligible & ~visited
        visited |= frontier
        count = int(visited.sum())
    return visited, count


def _fit_width(idx: np.ndarray, valid: np.ndarray, w_pad: int,
               sentinel: int):
    """Trim/pad the gathered candidate matrix to a static ``w_pad`` columns.

    Safe to trim: ``w_pad >= max candidate degree``, and a row only owns
    overflow columns when its degree exceeds the table width, which forces
    ``w_pad`` past them.
    """
    w = idx.shape[1]
    if w > w_pad:
        return np.ascontiguousarray(idx[:, :w_pad]), np.ascontiguousarray(
            valid[:, :w_pad]
        )
    if w < w_pad:
        rows = idx.shape[0]
        idx = np.concatenate(
            [idx, np.full((rows, w_pad - w), sentinel, np.int32)], axis=1
        )
        valid = np.concatenate(
            [valid, np.zeros((rows, w_pad - w), bool)], axis=1
        )
    return idx, valid


def _pad_rows(idx: np.ndarray, valid: np.ndarray, r_pad: int, sentinel: int):
    """Pad the candidate matrix to a static ``r_pad`` rows (sentinel rows)."""
    rows, w = idx.shape
    if rows == r_pad:
        return idx, valid
    pad = r_pad - rows
    idx = np.concatenate([idx, np.full((pad, w), sentinel, np.int32)])
    valid = np.concatenate([valid, np.zeros((pad, w), bool)])
    return idx, valid


class RepairPolicy:
    """Measured-crossover choice of which *exact* repair path runs.

    Both paths (window-validated fused descent, shell-incremental re-peel)
    are exact, so the policy only affects cost, never results. Per decision
    it predicts each path's wall time at the block's work scale — descend
    work = padded candidate-matrix cells, re-peel work = affected-shell arc
    mass — from an EMA kept per ``(path, regime)`` where a regime is a
    power-of-4 work bucket (nearest-regime predictions extrapolate linearly
    in work). Observations come from the maintainer's own phase timers, the
    very intervals exported as ``repair_phase_seconds{phase=}``; the
    registry feeds back in two ways: :meth:`refresh_from_metrics`
    warm-starts absolute priors from the live histograms (so a fresh
    maintainer in a warmed process doesn't start cold), and every
    observation lands back in the registry via the phase histograms.

    Modes: ``adaptive`` (measured crossover, the default), ``region`` (the
    legacy static trigger: region capped at ``repeel_frac * n``,
    ``descend_budget`` bound, full-graph re-peel), ``fallback`` (always
    re-peel; with the shell-incremental path when a window is available).
    """

    MODES = ("adaptive", "region", "fallback")

    def __init__(
        self,
        mode: str = "adaptive",
        *,
        alpha: float = 0.25,
        crossover_margin: float = 1.0,
        cold_cells_per_arc: float = 32.0,
        probe_every: int = 6,
        history: int = 512,
    ):
        if mode not in self.MODES:
            raise ValueError(
                f"unknown repair policy {mode!r}; expected one of {self.MODES}"
            )
        self.mode = mode
        self.alpha = float(alpha)
        self.crossover_margin = float(crossover_margin)
        self.cold_cells_per_arc = float(cold_cells_per_arc)
        self.probe_every = int(probe_every)
        self._ema: dict = {}  # (path, regime) -> [ema_seconds, ema_work]
        self._prior: dict = {}  # path -> absolute prior seconds (registry)
        self._stale = {"descend": 0, "repeel": 0}  # decisions since measured
        self.decisions = {"descend": 0, "repeel": 0}
        self.cold_decisions = 0
        self.probes = 0
        self._history: deque = deque(maxlen=int(history))
        self._pending: dict = {}  # path -> (work, predicted) awaiting actual
        self.refresh_from_metrics()

    @staticmethod
    def _regime(work: float) -> int:
        return max(int(work).bit_length() // 2, 1)

    def refresh_from_metrics(self, registry=None) -> None:
        """Warm-start absolute cost priors from the live phase histograms."""
        reg = metrics() if registry is None else registry
        for path, phase in (("descend", "descend"), ("repeel", "fallback")):
            h = reg.get("repair_phase_seconds", phase=phase)
            if h is not None and len(h):
                self._prior[path] = float(np.mean(h.values()))

    def _measured(self, path: str, work: float) -> Optional[float]:
        """EMA-predicted seconds from this policy's own observations only."""
        b = self._regime(work)
        cell = self._ema.get((path, b))
        if cell is not None:
            return cell[0]
        near = [r for (p, r) in self._ema if p == path]
        if near:
            r = min(near, key=lambda r: abs(r - b))
            sec, w = self._ema[(path, r)]
            return sec * (float(work) / max(w, 1.0))
        return None

    def predict(self, path: str, work: float) -> Optional[float]:
        """Predicted seconds for ``path`` at ``work`` units; None = no data.

        Own measurements first; the registry-fed absolute prior stands in
        until then (work-blind, so only a coarse magnitude).
        """
        m = self._measured(path, work)
        return m if m is not None else self._prior.get(path)

    def observe(self, path: str, work: float, seconds: float) -> None:
        """Feed one measured phase interval back into the regime EMAs."""
        self._stale[path] = 0
        cell = self._ema.get((path, self._regime(work)))
        if cell is None:
            self._ema[(path, self._regime(work))] = [
                float(seconds), float(work)
            ]
        else:
            cell[0] += self.alpha * (float(seconds) - cell[0])
            cell[1] += self.alpha * (float(work) - cell[1])
        pend = self._pending.pop(path, None)
        if pend is not None:
            self._history.append(
                (path, int(work), float(pend[1]), float(seconds))
            )

    def choose(self, *, cells: int, repeel_work: int, budget: int) -> str:
        """``"descend"`` or ``"repeel"`` for one block repair.

        ``cells``: padded candidate-matrix area the fused descent would
        sweep; ``repeel_work``: arc mass of the shells a re-peel would
        touch; ``budget``: hard cold-start cap on ``cells``.
        """
        pd = self._measured("descend", cells)
        pred = None
        if pd is None:
            # the descent has not been *measured* yet — a work-blind prior
            # (possibly from some other maintainer's regime) must not starve
            # it, or the crossover never gets data. Run it unless the shape
            # heuristic says the padded matrix dwarfs the affected-shell
            # arc mass (block size x shell span) or busts the budget.
            self.cold_decisions += 1
            cold_ok = cells <= self.cold_cells_per_arc * max(repeel_work, 64)
            choice = "descend" if (cold_ok and cells <= budget) else "repeel"
        else:
            pr = self._measured("repeel", repeel_work)
            if pr is None:
                # descend is measured but the re-peel side never has been —
                # explore it once (it is exact too, and cheap at shell
                # granularity) so the crossover gets data for both paths
                # instead of riding the first measurement forever
                choice = "repeel"
                pred = self._prior.get("repeel")
            else:
                choice = (
                    "descend" if pd <= self.crossover_margin * pr
                    else "repeel"
                )
                pred = pd if choice == "descend" else pr
                # EMA freshness: the losing path stops getting measured the
                # moment it loses, so its estimate would never track drift
                # (bigger graph, warmer caches, changed shapes). Probe it
                # after ``probe_every`` consecutive unmeasured decisions —
                # bounded overhead, and the crossover stays live both ways.
                loser = "repeel" if choice == "descend" else "descend"
                if self.probe_every and \
                        self._stale[loser] >= self.probe_every:
                    choice, pred = loser, (pd if loser == "descend" else pr)
                    self.probes += 1
        self.decisions[choice] += 1
        self._stale["descend"] += 1
        self._stale["repeel"] += 1
        if pred is not None:
            self._pending[choice] = (
                cells if choice == "descend" else repeel_work, pred
            )
        return choice

    def report(self) -> dict:
        """Decision counts, predicted-vs-actual error, learned regimes."""
        by: dict = {}
        for path, _work, pred, act in self._history:
            d = by.setdefault(path, {"n": 0, "_err": 0.0})
            d["n"] += 1
            d["_err"] += abs(pred - act) / max(act, 1e-9)
        for d in by.values():
            d["mean_abs_rel_err"] = round(d.pop("_err") / d["n"], 3)
        return {
            "mode": self.mode,
            "decisions": dict(self.decisions),
            "cold_decisions": int(self.cold_decisions),
            "probes": int(self.probes),
            "predicted_vs_actual": by,
            "regimes": {
                f"{p}/{r}": [round(s, 6), round(w, 1)]
                for (p, r), (s, w) in sorted(self._ema.items())
            },
        }


class _RepairTicket:
    """Handle for one block repair started by ``begin_update``.

    ``done`` tickets already committed (synchronous paths); live tickets
    hold the in-flight descent plus everything ``finish_update`` needs to
    validate the window and commit.
    """

    __slots__ = ("done", "changed", "pending", "ctx", "margin", "lo", "hi",
                 "cand")

    def __init__(self, *, changed=None, pending=None, ctx=None, margin=0,
                 lo=0, hi=0, cand=None):
        self.done = changed is not None
        self.changed = int(changed or 0)
        self.pending = pending
        self.ctx = ctx
        self.margin = margin
        self.lo = lo
        self.hi = hi
        self.cand = cand


class IncrementalCore:
    def __init__(
        self,
        g: DynamicGraph,
        core: Optional[np.ndarray] = None,
        *,
        repeel_frac: float = 0.6,
        margin0: int = 8,
        impl: str = "auto",
        region_impl: Optional[str] = None,
        kernel_impl: Optional[str] = None,
        repeel_impl: Optional[str] = None,
        descend_budget: int = 1 << 20,
        max_sweeps: int = 512,
        repair_policy: str = "adaptive",
        policy: Optional[RepairPolicy] = None,
        crossover_margin: float = 1.0,
        cold_cells_per_arc: float = 32.0,
    ):
        self.g = g
        if core is None:
            core = (
                core_numbers_host(g.snapshot())
                if g.n_nodes
                else np.zeros(0, np.int32)
            )
        self._core = np.asarray(core, np.int32).copy()
        self._baseline = self._core.copy()  # levels at last embedding refresh
        self.repeel_frac = float(repeel_frac)
        self.margin0 = int(margin0)
        if impl not in ("auto", "ref", "device"):
            raise ValueError(f"unknown impl {impl!r}")
        self.impl = impl
        self.region_impl = region_impl  # None=auto | "jit" | "np"
        self.kernel_impl = kernel_impl  # None=auto | ops.h_index_sweep impl
        # None=auto | "shell"|"descend"|"rounds"|"peel"
        self.repeel_impl = repeel_impl
        self.descend_budget = int(descend_budget)
        self.max_sweeps = int(max_sweeps)
        self.policy = policy if policy is not None else RepairPolicy(
            repair_policy,
            crossover_margin=crossover_margin,
            cold_cells_per_arc=cold_cells_per_arc,
        )
        self.repairs = 0
        self.sweeps = 0  # the JAX package's count: sweeps to the fixed point
        self.sweeps_enqueued = 0  # sweeps the device ran (chunks in full)
        self.descent_reads = 0  # host reads of the device descents
        self.descends = 0
        # test seam: a fixed length for every descent's first chunk of
        # sweeps in place of the history rule (_descend_dispatch)
        self._first_chunk: Optional[int] = None
        self._last_sweeps: dict = {}  # descent kind -> its last sweep count
        # bounded retry around the descent dispatch; exhaustion falls back
        # to the exact host peel (never an inexact answer). Only the fault
        # harness's InjectedFault is retried: a kernel that fails to build
        # or launch raises to the caller
        self.dispatch_retries = 2
        self.retry_backoff = 0.05
        self.dispatch_failures = 0
        self.dispatch_recoveries = 0
        self.promoted = 0
        self.demoted = 0
        self.repeels = 0
        self.shell_repeels = 0  # re-peels that stayed shell-incremental
        self.shell_widens = 0  # ceiling hits that widened the peel window
        self._shell_depths: list = []  # (hi, peeled_nodes, n) per shell peel
        self._inflight: Optional[_RepairTicket] = None
        self.phase_seconds: dict = {}
        self.phase_impl: dict = {}

    # ---------------------------------------------------------- dispatch

    def _device(self) -> bool:
        return self.impl != "ref"

    def _on_cuda(self) -> bool:
        """The graph's device mirror lives on CUDA: make the accelerator's
        choices (device regions, the CUDA kernel, descend re-peels)."""
        return self.g.device.type == "cuda"

    def _region_mode(self) -> str:
        if not self._device():
            return "ref"
        if self.region_impl:
            return self.region_impl
        return "jit" if self._on_cuda() else "np"

    def _kernel_mode(self) -> str:
        if self.kernel_impl:
            return self.kernel_impl
        return "cuda" if self._on_cuda() else "count"

    def _repeel_mode(self) -> str:
        if not self._device():
            return "peel"
        if self.repeel_impl:
            return self.repeel_impl
        if self._on_cuda():
            return "descend"
        # legacy "region" policy keeps the full-graph rounds peel so
        # A/B runs against the old trigger measure the old fallback too
        return "rounds" if self.policy.mode == "region" else "shell"

    def _tick(self, phase: str, mode: str, t0: float,
              t1: Optional[float] = None) -> None:
        if t1 is None:
            t1 = time.perf_counter()
        self.phase_seconds[phase] = (
            self.phase_seconds.get(phase, 0.0) + t1 - t0
        )
        self.phase_impl[phase] = mode
        # the same interval feeds the trace (one span per phase occurrence,
        # nested under the enclosing serve.ingest/retract span) and the
        # metrics registry — phase_report(), the trace, and the exporter all
        # describe one measurement
        obs.record(f"repair.{phase}", t0, t1, impl=mode)
        metrics().histogram("repair_phase_seconds", phase=phase).observe(
            t1 - t0
        )

    def phase_report(self) -> dict:
        """Per-phase repair wall time + which backend each phase ran on."""
        return {
            k: {"seconds": round(v, 6), "impl": self.phase_impl.get(k, "")}
            for k, v in sorted(self.phase_seconds.items())
        }

    def policy_report(self) -> dict:
        """Repair-policy decisions + shell re-peel depth for one maintainer.

        Extends :meth:`RepairPolicy.report` with the shell-incremental
        re-peel telemetry: how many re-peels stayed incremental, how often
        a ceiling hit widened the peel window, and a histogram of the peel
        depth (``hi``) and peeled-node fraction.
        """
        rep = self.policy.report()
        depth_hist: dict = {}
        frac_sum = 0.0
        for hi, peeled, n in self._shell_depths:
            depth_hist[str(hi)] = depth_hist.get(str(hi), 0) + 1
            frac_sum += peeled / max(n, 1)
        rep["shell_repeel"] = {
            "count": int(self.shell_repeels),
            "widens": int(self.shell_widens),
            "depth_hist": depth_hist,
            "mean_frac_peeled": round(
                frac_sum / max(len(self._shell_depths), 1), 4
            ),
        }
        rep["repeels"] = int(self.repeels)
        rep["descends"] = int(self.descends)
        return rep

    def reset_phases(self) -> None:
        """Zero the per-phase timers (benchmarks call this after warmup)."""
        self.phase_seconds = {}

    # ------------------------------------------------------------- views

    @property
    def core(self) -> np.ndarray:
        """(n_nodes,) int32 current core numbers (live view, do not mutate).

        Settles any in-flight pipelined repair first — readers always see
        committed levels.
        """
        self._settle()
        return self._core[: self.g.n_nodes]

    @property
    def baseline(self) -> np.ndarray:
        """(n_nodes,) int32 core numbers at the last ``mark_refresh``.

        The retraining subsystem reads this to pick alignment anchors
        (nodes whose level has not moved since the serving table was built).
        """
        self._ensure_size()
        return self._baseline[: self.g.n_nodes]

    def _ensure_size(self) -> None:
        n = self.g.n_nodes
        if len(self._core) < n:
            pad = np.zeros(n - len(self._core), np.int32)
            self._core = np.concatenate([self._core, pad])
            self._baseline = np.concatenate([self._baseline, pad])

    # ------------------------------------------------------------ regions

    def _region(self, ends: np.ndarray, lo: int, hi: int, removed) -> list:
        """Union subcore, host reference: nodes reachable from the block
        endpoints through nodes with old core in [lo, hi], over the
        post-block adjacency plus the removed block edges (a deletion must
        not sever its own discovery path). Endpoints are always included.

        Must cover every node whose core changes — truncating it would seed
        only part of the repair region and silently break exactness; the
        caller guards that with the adaptive window + boundary check.
        """
        extra = {}
        for u, v in removed:
            extra.setdefault(int(u), set()).add(int(v))
            extra.setdefault(int(v), set()).add(int(u))
        seen = {int(r) for r in ends}
        stack = list(seen)
        while stack:
            w = stack.pop()
            nbrs = self.g.neighbours(w)
            ex = extra.get(w)
            if ex:
                nbrs = np.concatenate(
                    [nbrs, np.fromiter(ex, np.int64, len(ex))]
                )
            for x in nbrs:
                x = int(x)
                if x not in seen and lo <= self._core[x] <= hi:
                    seen.add(x)
                    stack.append(x)
        return sorted(seen)

    def _region_np(self, ends, lo, hi, side_src, side_dst, cap):
        """Vectorized host frontier traversal (same masks as the device
        loop). Returns None once past ``cap``."""
        g = self.g
        n, n1 = g.n_nodes, g.node_cap + 1
        eligible = np.zeros(n1, bool)
        eligible[:n] = (self._core[:n] >= lo) & (self._core[:n] <= hi)
        visited = np.zeros(n1, bool)
        visited[ends] = True
        frontier = visited.copy()
        width_iota = np.arange(g.width)
        while frontier.any():
            rows = np.where(frontier)[0]
            live = width_iota[None, :] < g._deg[rows][:, None]
            nxt = np.zeros(n1, bool)
            nxt[g._nbr[rows][live]] = True
            if len(side_src):
                sm = frontier[side_src]
                if sm.any():
                    nxt[side_dst[sm]] = True
            frontier = nxt & eligible & ~visited
            visited |= frontier
            if int(visited.sum()) > cap:
                return None
        return np.where(visited[:n])[0].astype(np.int64)

    def _region_device(self, ends, lo, hi, side_src, side_dst, cap):
        """Frontier traversal over the device ELL mirror + side table
        (``_region_fixpoint``). Returns None once past ``cap``."""
        g = self.g
        n = g.n_nodes
        ell = g.ell()
        dev = ell.device
        n1 = ell.neighbours.shape[0]  # node_cap + 1, plus any shard padding
        core = torch.zeros(n1, dtype=torch.int32, device=dev)
        core[:n] = torch.tensor(self._core[:n], device=dev)
        ends_mask = torch.zeros(n1, dtype=torch.bool, device=dev)
        ends_mask[torch.tensor(ends, device=dev)] = True
        visited, count = _region_fixpoint(
            ell.neighbours, ell.degrees, core, ends_mask,
            torch.tensor(side_src, device=dev),
            torch.tensor(side_dst, device=dev), lo, hi, cap, g.node_cap,
        )
        if count > cap:
            return None
        return visited[:n].nonzero().flatten().cpu().numpy().astype(np.int64)

    # ------------------------------------------------------------ repairs

    def _repeel_shell(self, old: np.ndarray, hi: Optional[int]):
        """Shell-incremental re-peel: recompute only levels ``<= hi``.

        Upper shells are frozen and enter the peel as boundary degrees
        (``core_numbers_shell_peel``); a ceiling hit disproves the freeze
        and widens ``hi`` geometrically until certified (reaching the top
        level degenerates to the full rounds peel — still exact, just no
        longer incremental). Returns ``(cores, impl_tag, work)`` where
        ``work`` is the arc/node mass actually peeled (the policy's re-peel
        cost unit).
        """
        n = self.g.n_nodes
        src, dst = self.g.arc_arrays()
        max_core = int(old.max(initial=0))
        widen = max(self.margin0, 1)
        hi = max_core if hi is None else int(hi)
        deg = None
        while hi < max_core:
            if deg is None:
                deg = np.bincount(src, minlength=n)
            peel = old <= hi
            inner = peel[src] & peel[dst]
            core_s, ok = core_numbers_shell_peel(
                n, src[inner], dst[inner], peel, deg, hi
            )
            if ok:
                new = old.copy()
                new[peel] = core_s[peel]
                self.shell_repeels += 1
                self._shell_depths.append((int(hi), int(peel.sum()), n))
                metrics().counter("repair_shell_repeels_total").inc()
                return new, "shell", int(inner.sum()) + int(peel.sum())
            self.shell_widens += 1
            hi += widen
            widen *= 2
        # the window reached the top level: nothing left to freeze
        return core_numbers_rounds(n, src, dst), "rounds", len(src)

    def _repeel(self, old: np.ndarray, m_ins: int,
                hi: Optional[int] = None) -> int:
        """Exact re-peel fallback: fused descent over all nodes on CUDA,
        shell-incremental from the repair window's top on the CPU (full
        rounds peel when the window covers every level), the legacy
        snapshot peel for ``impl="ref"``."""
        n = self.g.n_nodes
        mode = self._repeel_mode()
        t0 = time.perf_counter()
        work = 2 * self.g.n_edges
        if mode == "shell":
            oracle, mode, work = self._repeel_shell(old, hi)
        elif mode == "descend":
            deg = self.g.degrees_of(np.arange(n))
            seed = np.maximum(
                np.minimum(deg.astype(np.int64), old.astype(np.int64) + m_ins),
                0,
            ).astype(np.int32)
            # the inner gather/descent ticks belong to the fallback bucket:
            # roll them back so the phase report stays non-overlapping
            before = {
                k: self.phase_seconds.get(k)
                for k in ("candidates", "descend")
            }
            pending = self._descend_dispatch(
                np.arange(n, dtype=np.int64), seed, old, 0, 1 << 30,
                cand_deg=deg, kind="repeel",
            )
            res = self._descend_read(pending)
            for k, b in before.items():
                if b is None:
                    self.phase_seconds.pop(k, None)
                    self.phase_impl.pop(k, None)
                else:
                    self.phase_seconds[k] = b
            if res is None:
                # the sweep cap truncated the full descent (pathological
                # cascade depth) — recover with the uncapped exact peel
                src, dst = self.g.arc_arrays()
                oracle = core_numbers_rounds(n, src, dst)
                mode = "rounds"
            else:
                # the dispatch may tier-reorder rows: scatter back by id
                oracle = np.zeros(n, np.int32)
                oracle[pending["cand"]] = res[0]
        elif mode == "rounds":
            src, dst = self.g.arc_arrays()
            oracle = core_numbers_rounds(n, src, dst)
            work = len(src)
        else:
            oracle = core_numbers_host(self.g.snapshot())
        t1 = time.perf_counter()
        self._tick("fallback", mode, t0, t1)
        self.policy.observe("repeel", max(work, 1), t1 - t0)
        changed = oracle != self._core[:n]
        self.promoted += int((oracle > self._core[:n]).sum())
        self.demoted += int((oracle < self._core[:n]).sum())
        self._core[:n] = oracle
        self.repeels += 1
        metrics().counter("repair_repeels_total").inc()
        return int(changed.sum())

    @staticmethod
    def _pad_shape(n_cand: int, cand_deg: np.ndarray):
        """Static (r_pad, w_pad) of the fused-descent candidate matrix.

        Floored at 64x64 and rounded to powers of two as in the JAX
        package, so the tier split and the adaptive policy (which costs
        the descent on exactly this padded area) decide alike in both.
        """
        w_pad = max(pow2(max(int(cand_deg.max(initial=1)), 1)), 64)
        r_pad = max(pow2(n_cand), 64)
        return r_pad, w_pad

    @classmethod
    def _tier_plan(cls, n_cand: int, cand_deg: np.ndarray):
        """Static tier shapes of the descent matrix, plus padded cell count.

        A single ELL matrix pays the hub tax: a few high-degree rows force
        ``w_pad`` to 4-8x the typical degree and the sweep is mostly
        padding. When splitting the rows at ``_W_SMALL`` into a narrow
        matrix plus a small hub matrix strictly shrinks the swept area, do
        it — the per-row operator is unchanged, so the fixpoint (and the
        policy's cells-proportional cost model) is the same computation
        over fewer cells. Returns ``(r_small, r_big, w_big, n_big, cells)``
        with ``r_big == 0`` meaning single-tier.
        """
        r_pad, w_pad = cls._pad_shape(n_cand, cand_deg)
        cells = r_pad * w_pad
        if w_pad <= 2 * _W_SMALL:
            return r_pad, 0, w_pad, 0, cells
        n_big = int((cand_deg > _W_SMALL).sum())
        if not 0 < n_big < n_cand:
            return r_pad, 0, w_pad, 0, cells
        r_small = max(pow2(n_cand - n_big), 64)
        r_big = max(pow2(n_big), 64)
        split_cells = r_small * _W_SMALL + r_big * w_pad
        if split_cells >= cells:
            return r_pad, 0, w_pad, 0, cells
        return r_small, r_big, w_pad, n_big, split_cells

    def _descend_upload(self, cand, seed, old_cand, lo, hi, *, cand_deg):
        """Gather/pad the candidate matrix and upload it to the device.

        Returns the pending descent's inputs (device tensors, ``args``)
        plus readback bookkeeping, with nothing enqueued yet. The split
        lets the kernel check of ``chip_smoke.py`` take the sweep's inputs
        at the serving path's shapes without running the descent.
        """
        g = self.g
        node_cap = g.node_cap
        t0 = time.perf_counter()
        n_rows = len(cand)
        r_small, r_big, w_big, n_big, cells = self._tier_plan(
            n_rows, cand_deg
        )
        plan = g.plan
        if plan is not None:  # each tier splits evenly over the shards
            r_small, r_big = plan.pad_rows(r_small), plan.pad_rows(r_big)
        keep = None
        if r_big:
            # hubs last; the stable partition keeps each tier's rows in
            # input order, and ``keep`` maps the padded concat back to them
            order = np.argsort(cand_deg > _W_SMALL, kind="stable")
            cand, seed = cand[order], seed[order]
            old_cand = old_cand[order]
            keep = np.concatenate(
                [np.arange(n_rows - n_big), r_small + np.arange(n_big)]
            )
        cand_out = cand  # unpadded (tier-ordered) rows the result maps to
        idx, valid = g.gather_rows(cand)
        est_full = np.zeros(node_cap + 1, np.int32)
        est_full[: g.n_nodes] = self._core[: g.n_nodes]

        def vec(x, fill, dtype):
            out = np.full(r_small + r_big, fill, dtype)
            out[: n_rows - n_big] = x[: n_rows - n_big]
            out[r_small : r_small + n_big] = x[n_rows - n_big :]
            return out

        if r_big:
            n_small = n_rows - n_big
            idx_s, valid_s = _fit_width(
                idx[:n_small], valid[:n_small], _W_SMALL, node_cap
            )
            idx_b, valid_b = _fit_width(
                idx[n_small:], valid[n_small:], w_big, node_cap
            )
            tiers = [_pad_rows(idx_s, valid_s, r_small, node_cap),
                     _pad_rows(idx_b, valid_b, r_big, node_cap)]
        else:
            idx, valid = _fit_width(idx, valid, w_big, node_cap)
            tiers = [_pad_rows(idx, valid, r_small, node_cap)]
        dev = g.device
        if plan is None:
            row = rep = lambda x: torch.tensor(x, device=dev)
        else:  # candidate rows split over the shards, estimate replicated
            row, rep = plan.place_rows, plan.replicate
        args = {
            "tiers": [(row(i.astype(np.int64)), row(v)) for i, v in tiers],
            "cand": torch.tensor(vec(cand, node_cap, np.int64), device=dev),
            "seed": torch.tensor(vec(seed, 0, np.int32), device=dev),
            "old": torch.tensor(vec(old_cand, 0, np.int32), device=dev),
            "est_full": rep(est_full),
            "lo": int(lo), "hi": int(hi),
        }
        self._tick("candidates", "gather", t0)
        return {"args": args, "n_rows": n_rows, "cells": cells,
                "cand": cand_out, "keep": keep}

    def _descend_dispatch(self, cand, seed, old_cand, lo, hi, *, cand_deg,
                          kind=None):
        """Upload the candidate matrix and *enqueue* the descent's first
        chunk of sweeps (``_descend_upload``, ``_Descent``).

        Returns the pending descent without reading anything back: the host
        is free until ``_descend_read`` — the pipelined ingest stages the
        next block's dedup/WAL append in that gap. The first chunk has the
        sweep count of the last descent of the same ``kind`` ("insert",
        "delete", "repeel") rounded up to a power of two, at least 4 (at most
        ``max_sweeps``).
        """
        faults.check("device_dispatch")
        pending = self._descend_upload(cand, seed, old_cand, lo, hi,
                                       cand_deg=cand_deg)
        pending["t0"] = time.perf_counter()
        descent = _Descent(**pending["args"], impl=self._kernel_mode())
        first = self._first_chunk
        if first is None:
            first = max(pow2(self._last_sweeps.get(kind, 0)), 4)
        pending["kind"] = kind
        pending["chunk"] = min(max(int(first), 1), self.max_sweeps)
        descent.sweep(max(pending["chunk"], 0))
        pending["descent"] = descent
        pending["t_sent"] = time.perf_counter()
        return pending

    def _descend_read(self, pending, *, full_interval: bool = True):
        """Read a pending descent back, enqueuing more sweeps until it ends.

        One host read per chunk: while the last sweep still changed an
        estimate and fewer than ``max_sweeps`` sweeps have run, the next
        chunk (twice the last one, clipped at ``max_sweeps``) is enqueued
        and read. ``full_interval=True`` charges the descend phase from the
        dispatch (the serial semantics); ``False`` charges the host's own
        time on the descent only: the first chunk's enqueueing and the time
        spent here, as two spans — in pipelined mode the descent's
        *non-overlapped* cost, which is both what the phase report should
        show and the right quantity for the policy's crossover (overlapped
        device time is free wall-clock). Returns ``(new, max_gain,
        max_loss, ceiling_hit, floor_hit)`` or None when the sweep cap
        truncated the descent.
        """
        t_read = time.perf_counter()
        descent, chunk = pending["descent"], pending["chunk"]
        while True:
            (n_changed, last, gain, loss, ceiling, floor), new = \
                descent.read()
            if not last or descent.enqueued >= self.max_sweeps:
                break
            chunk = min(2 * chunk, self.max_sweeps - descent.enqueued)
            descent.sweep(chunk)
        keep = pending["keep"]
        new = new[: pending["n_rows"]] if keep is None else new[keep]
        # the changed sweeps are a prefix (a sweep that changes nothing is a
        # fixed point), so the sweeps a stopping loop runs are the changed
        # ones + the one that found the fixed point, capped at max_sweeps
        sweeps = min(self.max_sweeps, n_changed + 1)
        self._last_sweeps[pending["kind"]] = sweeps
        self.sweeps += sweeps
        self.sweeps_enqueued += descent.enqueued
        self.descent_reads += descent.reads
        self.descends += 1
        metrics().counter("repair_descends_total").inc()
        mode = f"fused[{self._kernel_mode()}]"
        t0, t1 = pending["t0"], time.perf_counter()
        if full_interval:
            self._tick("descend", mode, t0, t1)
            cost = t1 - t0
        else:
            self._tick("descend", mode, t0, pending["t_sent"])
            self._tick("descend", mode, t_read, t1)
            cost = pending["t_sent"] - t0 + t1 - t_read
        self.policy.observe("descend", pending["cells"], cost)
        if last:  # max_sweeps cap hit before the fixed point
            return None
        return new, gain, loss, bool(ceiling), bool(floor)

    def _descend(self, cand: np.ndarray, seed: np.ndarray) -> np.ndarray:
        """Reference host descent: per-iteration sort-based sweeps over a
        host-maintained estimate (the original path, kept as the oracle)."""
        g = self.g
        idx, valid = g.gather_rows(cand)
        w_pad = pow2(max(int(valid.sum(axis=1).max(initial=1)), 1))
        idx, valid = _fit_width(idx, valid, w_pad, g.node_cap)
        n_rows = pow2(len(cand))
        if n_rows != len(cand):
            pad = n_rows - len(cand)
            idx = np.concatenate(
                [idx, np.full((pad, w_pad), g.node_cap, np.int32)]
            )
            valid = np.concatenate([valid, np.zeros((pad, w_pad), bool)])

        est = np.zeros(g.node_cap + 1, np.int32)
        est[: len(self._core)] = self._core
        est[cand] = seed
        est_p = np.zeros(n_rows, np.int32)  # padded rows descend from 0 to 0
        while True:
            self.sweeps += 1
            vals = est[idx].astype(np.int32)
            est_p[: len(cand)] = est[cand]
            new = h_index_sweep(
                torch.from_numpy(vals), torch.from_numpy(valid),
                torch.from_numpy(est_p), impl="ref",
            ).numpy()[: len(cand)]
            if np.array_equal(new, est[cand]):
                return new
            est[cand] = new

    def _finish_repeel(self, ctx: dict, hi: int) -> _RepairTicket:
        changed = self._repeel(ctx["old"], ctx["m_ins"], hi=hi)
        self.repairs += 1
        return _RepairTicket(changed=changed)

    def _dispatch_with_retry(self, cand, seed, old_cand, lo, hi, *,
                             cand_deg, kind=None):
        """Bounded retry-with-backoff around the descent dispatch.

        Retries an ``InjectedFault`` only, and re-raises the last one after
        ``dispatch_retries`` retries; the caller then falls back to
        :meth:`_recover_ref`. Any other error propagates at once.
        """
        for attempt in range(self.dispatch_retries + 1):
            try:
                return self._descend_dispatch(
                    cand, seed, old_cand, lo, hi, cand_deg=cand_deg,
                    kind=kind,
                )
            except faults.InjectedFault:
                self.dispatch_failures += 1
                metrics().counter("repair_dispatch_failures_total").inc()
                if attempt >= self.dispatch_retries:
                    raise
                time.sleep(self.retry_backoff * (2 ** attempt))

    def _recover_ref(self, ctx: dict, hi: int) -> _RepairTicket:
        """The dispatch kept failing: force the exact host ``"peel"`` path
        for this block so cores stay exact while the device path recovers.

        InjectedCrash is a BaseException and never lands here — a simulated
        process death must not be absorbed into a host fallback."""
        self.dispatch_recoveries += 1
        metrics().counter("repair_dispatch_recoveries_total").inc()
        saved = self.repeel_impl
        self.repeel_impl = "peel"
        try:
            return self._finish_repeel(ctx, hi)
        finally:
            self.repeel_impl = saved

    def _commit(self, ctx: dict, cand, new) -> _RepairTicket:
        old = ctx["old"]
        self.repairs += 1
        self._core[cand] = new
        self.promoted += int((new > old[cand]).sum())
        self.demoted += int((new < old[cand]).sum())
        return _RepairTicket(changed=int((new != old[cand]).sum()))

    def _resolve(self, ctx: dict, margin: int, lo: int, hi: int, cand,
                 res) -> _RepairTicket:
        """Validate one descent result against the window; commit or widen."""
        if res is None:  # sweep cap hit: recover via exact recompute
            return self._finish_repeel(ctx, hi)
        new, max_gain, max_loss, ceil_hit, floor_hit = res
        ceiling_hit = bool(ctx["m_ins"]) and ceil_hit
        floor_hit = bool(ctx["m_del"] and lo > 0) and floor_hit
        if ctx["m"] == 1 or (
            max_gain < margin
            and max_loss < margin
            and not ceiling_hit
            and not floor_hit
        ):
            return self._commit(ctx, cand, new)
        # a change at the boundary may be a truncated cascade: re-run wider
        # (synchronously — widenings are rare and already mid-repair)
        return self._land(
            self._advance(ctx, 2 * margin + max_gain + max_loss + 1)
        )

    def _land(self, ticket: _RepairTicket, *,
              full_interval: bool = True) -> _RepairTicket:
        """Read a live ticket's descent back, then validate and commit or
        widen (``_resolve``); a done ticket is returned as it is."""
        if ticket.done:
            return ticket
        res = self._descend_read(ticket.pending, full_interval=full_interval)
        return self._resolve(ticket.ctx, ticket.margin, ticket.lo, ticket.hi,
                             ticket.cand, res)

    def _advance(self, ctx: dict, margin: int) -> _RepairTicket:
        """One window attempt: region discovery, policy decision, repair.

        Adaptive window: the half-width grows until the computed level
        changes sit strictly inside it (a change at the boundary may be a
        truncated cascade). A single mutation cannot cascade, so it never
        widens. A device descent is returned in flight (a live ticket for
        ``_land``), not read back here.
        """
        m_ins, m_del, m = ctx["m_ins"], ctx["m_del"], ctx["m"]
        old, n = ctx["old"], ctx["n"]
        mode = self.policy.mode
        adaptive = self._device() and mode == "adaptive"
        # legacy static trigger caps discovery at repeel_frac * n; the
        # adaptive policy never aborts on size — it decides *after* seeing
        # the region, from measured cost, so eager-trigger full re-peels
        # can't starve the fused descent. The ref impl (the oracle) keeps
        # the legacy cap.
        cap = n if adaptive else int(max(256, self.repeel_frac * n))
        region_mode = self._region_mode()
        lo = max(0, ctx["k_min"] - (margin if m_del else 0))
        hi = ctx["k_max"] + (margin if m_ins else 0)
        if mode == "fallback":
            return self._finish_repeel(ctx, hi)

        t0 = time.perf_counter()
        if region_mode == "ref":
            cand = np.asarray(
                self._region(ctx["ends"], lo, hi, ctx["removed"]), np.int64
            )
            if len(cand) > cap:
                cand = None
        elif region_mode == "jit":
            cand = self._region_device(
                ctx["ends"], lo, hi, ctx["side_src"], ctx["side_dst"], cap
            )
        else:
            cand = self._region_np(
                ctx["ends"], lo, hi, ctx["side_src"], ctx["side_dst"], cap
            )
        self._tick("region", region_mode, t0)
        if cand is not None:
            metrics().histogram(
                "repair_region_nodes", buckets=_COUNT_BUCKETS
            ).observe(len(cand))

        if cand is None:  # legacy trigger fired (region/ref modes only)
            return self._finish_repeel(ctx, hi)

        t0 = time.perf_counter()
        cand_deg = self.g.degrees_of(cand)
        seed = np.minimum(
            cand_deg.astype(np.int64), old[cand].astype(np.int64) + m_ins
        )
        seed = np.maximum(seed, 0).astype(np.int32)
        self._tick("candidates", "gather", t0)

        if self._device():
            cells = self._tier_plan(len(cand), cand_deg)[4]
            budget = self.descend_budget if not self._on_cuda() else 1 << 62
            if adaptive:
                deg = self.g.degrees()
                repeel_work = int(deg[old[:n] <= hi].sum()) + n
                if self.policy.choose(
                    cells=cells, repeel_work=repeel_work, budget=budget
                ) == "repeel":
                    return self._finish_repeel(ctx, hi)
            elif cells > budget:
                # legacy static trigger: a huge candidate matrix costs
                # more to sweep than one exact vectorized re-peel
                return self._finish_repeel(ctx, hi)
            try:
                pending = self._dispatch_with_retry(
                    cand, seed, old[cand], lo, hi, cand_deg=cand_deg,
                    kind="insert" if m_ins else "delete",
                )
            except faults.InjectedFault:
                return self._recover_ref(ctx, hi)
            # the dispatch may tier-reorder the rows: resolve/commit against
            # the ordering the result actually maps to
            return _RepairTicket(pending=pending, ctx=ctx, margin=margin,
                                 lo=lo, hi=hi, cand=pending["cand"])

        t0 = time.perf_counter()
        new = self._descend(cand, seed)
        # a changed node's old level sits within the *deepest per-node
        # cascade* of the block's endpoint levels, so the window is
        # sufficient as long as the margin exceeds the largest single-node
        # level change
        max_gain = int(np.maximum(new - old[cand], 0).max(initial=0))
        max_loss = int(np.maximum(old[cand] - new, 0).max(initial=0))
        ceil_hit = bool(((new > hi) & (new > old[cand])).any())
        floor_hit = bool(((new < lo) & (new < old[cand])).any())
        self._tick("descend", "host", t0)
        return self._resolve(
            ctx, margin, lo, hi, cand,
            (new, max_gain, max_loss, ceil_hit, floor_hit),
        )

    def begin_update(self, added=None, removed=None) -> _RepairTicket:
        """Start a block repair; ``finish_update`` completes it.

        The returned ticket is either already committed (fallback re-peel,
        host impl, empty block) or holds an *in-flight* descent: its first
        chunk of sweeps is enqueued on the device and nothing has been read
        back. In the latter case the caller may overlap host work (the
        pipelined ingest stages the next block's dedup here) before
        ``finish_update`` reads the result back — but must not mutate the
        graph until then.
        """
        self._settle()
        faults.check("repair")
        added = (
            np.asarray(added, np.int64).reshape(-1, 2)
            if added is not None else _EMPTY
        )
        removed = (
            np.asarray(removed, np.int64).reshape(-1, 2)
            if removed is not None else _EMPTY
        )
        m_ins, m_del = len(added), len(removed)
        m = m_ins + m_del
        if m == 0:
            return _RepairTicket(changed=0)
        self._ensure_size()
        n = self.g.n_nodes
        old = self._core[:n].copy()

        touched = np.concatenate([added, removed]) if m_del and m_ins else (
            added if m_ins else removed
        )
        k_edge = np.minimum(
            self._core[touched[:, 0]], self._core[touched[:, 1]]
        )
        ctx = {
            "added": added, "removed": removed, "m_ins": m_ins,
            "m_del": m_del, "m": m, "n": n, "old": old,
            "ends": np.unique(touched.reshape(-1)),
            "k_min": int(k_edge.min()), "k_max": int(k_edge.max()),
        }
        if self._region_mode() != "ref":
            # side table: removed block edges (both arcs) + overflow arcs the
            # table/mirror cannot carry — built once, reused across widenings
            ov_src, ov_dst = self.g.overflow_arc_arrays()
            ctx["side_src"] = np.concatenate(
                [ov_src, removed[:, 0], removed[:, 1]]
            )
            ctx["side_dst"] = np.concatenate(
                [ov_dst, removed[:, 1], removed[:, 0]]
            )
        ticket = self._advance(ctx, 0 if m == 1 else self.margin0)
        if not ticket.done:
            self._inflight = ticket
        return ticket

    def finish_update(self, ticket: Optional[_RepairTicket] = None) -> int:
        """Complete a repair started by ``begin_update``.

        Reads the in-flight descent back (charging only the non-overlapped
        wait to the descend phase), validates the window, widens/commits.
        Returns the number of nodes whose core number changed. Faults are
        handled at the dispatch (``_dispatch_with_retry``): the read has no
        fault point, since the port's launches raise when they are made.
        """
        if ticket is None:
            ticket = self._inflight
        if ticket is None:
            return 0
        if ticket is self._inflight:
            self._inflight = None
        return self._land(ticket, full_interval=False).changed

    def _settle(self) -> None:
        """Finish any in-flight ticket (public entry points call this so an
        overlapped repair is never observable)."""
        if self._inflight is not None:
            self.finish_update(self._inflight)

    def on_update(self, added=None, removed=None) -> int:
        """Repair after a mixed block of graph mutations has been applied.

        ``added``/``removed`` are the (m, 2) edge arrays the graph actually
        accepted (the return values of ``add_edges``/``remove_edges``).
        Returns the number of nodes whose core number changed. Synchronous:
        ``begin_update`` + ``finish_update`` back to back.
        """
        return self.finish_update(self.begin_update(added, removed))

    def on_edge_block(self, edges) -> int:
        """Repair after ``g.add_edges(edges)`` accepted ``edges`` (one union
        subcore sweep for the whole block). Returns #nodes promoted."""
        before = self.promoted
        self.on_update(added=edges)
        return self.promoted - before

    def on_remove(self, edges) -> int:
        """Repair after ``g.remove_edges(edges)`` removed ``edges``.
        Returns #nodes demoted."""
        before = self.demoted
        self.on_update(removed=edges)
        return self.demoted - before

    def on_edge(self, u: int, v: int) -> int:
        """Repair after ``g.add_edge(u, v)`` returned True.

        Single-edge compatibility wrapper over ``on_edge_block``; returns the
        number of nodes whose core number was promoted.
        """
        return self.on_edge_block(np.array([[u, v]], np.int64))

    # ------------------------------------------------------------- oracle

    def resync(self) -> int:
        """Recompute from the oracle; returns #mismatches found (0 expected).

        Called after compaction as a safety net — block maintenance is exact,
        so a nonzero return indicates a bug upstream.
        """
        self._settle()
        self._ensure_size()
        oracle = core_numbers_host(self.g.snapshot())
        n = self.g.n_nodes
        mismatches = int(np.sum(oracle != self._core[:n]))
        self._core[:n] = oracle
        return mismatches

    # ------------------------------------------------------------- drift

    def drift(self) -> int:
        """#nodes whose core number changed since the last ``mark_refresh``.

        Newly appeared nodes count (their baseline level is 0); so do nodes
        demoted by deletions — drift is direction-agnostic.
        """
        self._settle()
        self._ensure_size()
        n = self.g.n_nodes
        return int(np.sum(self._core[:n] != self._baseline[:n]))

    def membership_drift(self, k0: int) -> tuple:
        """k0-core membership churn since the last ``mark_refresh``.

        Returns (#nodes whose (core >= k0) flag flipped, current k0-core
        size). Counts departures (deletion-driven demotion out of the core)
        as well as arrivals.
        """
        self._settle()
        self._ensure_size()
        n = self.g.n_nodes
        now = self._core[:n] >= k0
        was = self._baseline[:n] >= k0
        return int(np.sum(now != was)), int(now.sum())

    def mark_refresh(self) -> None:
        """Record current levels as the embedding-table baseline."""
        self._settle()
        self._ensure_size()
        self._baseline = self._core.copy()
