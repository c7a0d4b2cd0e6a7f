"""Online retraining subsystem: drift-triggered CoreWalk+SGNS refresh.

The torch counterpart of ``repro.serve.retrain``, on the service's device.
``EmbeddingService.should_retrain()`` detects k0-core membership drift; this
module closes the loop that acts on it. The paper's whole economy (walks and
SGNS restricted to the k0-core, §2.1/§2.2 propagation for everyone else)
makes the refresh cheap enough to run *online*: the drifted subcore is a
small fraction of the graph, and the previous run's vectors warm-start the
new one, so a refresh is a few SGNS epochs on a subgraph — not a cold
offline rebuild.

Four stages, each its own component so tests can drive them separately:

* :class:`RetrainPlanner` — snapshots the **drifted k0-core** from the live
  ``DynamicGraph`` (one vectorized ``snapshot()`` CSR conversion) using the
  maintainer's *exact* incremental core numbers — no re-peel needed — and
  clamps k0 to the current degeneracy (deletion churn can lower it).
* :class:`Retrainer` — re-runs CoreWalk walks + SGNS on the subcore (the
  components ``core/pipeline.embed_graph`` composes: ``corewalk_plan`` ->
  ``build_corpus`` -> ``train_sgns``, whose steps run the fused SGNS
  forward and backward kernels on the card), **warm-starting** ``emb_in``
  rows from the previous vectors of nodes that persist in the store. Walks
  and the initial table draw from ``torch.Generator``\\ s seeded from the
  config, so a retrain repeats its bits from the same state (a WAL replay
  rebuilds the same table) and matches the JAX package's in its counts,
  not in its bits.
* :class:`EmbeddingAligner` — SGNS is rotation-invariant, so a fresh run
  lands in an arbitrarily rotated copy of the old space. Orthogonal
  Procrustes on **stable anchor nodes** (in-core, core number unchanged
  since the last refresh, previous vector held) maps the new table back
  into the old space, so mixed-version gathers and §2.2 cold-start
  propagation stay mutually comparable during rollout.
* :class:`VersionRollout` — stages the aligned table off to the side and
  hot-swaps it: ``bump_version`` then **chunked** ``put_many`` scatters,
  optionally yielding to the serving loop between chunks. Rows not
  refreshed keep their old version (the store's per-row version tags
  reconcile the mixture).

``Retrainer.run()`` chains the four stages and finishes with
``IncrementalCore.mark_refresh()``, resetting the drift baseline the next
trigger measures against.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.corewalk import WalkPlan, corewalk_plan, deepwalk_plan
from repro_torch.core.kcore import degeneracy, kcore_subgraph
from repro_torch.core.propagation import propagate
from repro_torch.device import synchronize
from repro_torch.graph.csr import Graph
from repro_torch.obs import metrics
from repro_torch.obs import trace as obs
from repro_torch.skipgram.corpus import build_corpus
from repro_torch.skipgram.model import init_params
from repro_torch.skipgram.trainer import SGNSConfig, train_sgns

from . import faults
from .kcore_inc import IncrementalCore
from .store import EmbeddingStore
from .stream import DynamicGraph

__all__ = [
    "RetrainConfig",
    "RetrainPlan",
    "RetrainPlanner",
    "RetrainReport",
    "Retrainer",
    "EmbeddingAligner",
    "VersionRollout",
    "procrustes_rotation",
]


def _mark_stage(stage: str, t0: float) -> float:
    """Close one retrain stage: emit its span + latency histogram sample.

    Returns the stage duration so call sites can keep the ``times`` dict
    (the report API) without re-reading the clock.
    """
    t1 = time.perf_counter()
    obs.record(f"retrain.{stage}", t0, t1)
    metrics().histogram("retrain_stage_seconds", stage=stage).observe(t1 - t0)
    return t1 - t0


# --------------------------------------------------------------- planning


@dataclasses.dataclass
class RetrainConfig:
    """Knobs for one drift-triggered refresh (defaults sized for serving).

    ``sgns.impl`` is ``"auto"``: the fused SGNS kernels on the card, their
    plain versions on the CPU.
    """

    method: str = "corewalk"  # corewalk | deepwalk (budget plan on the core)
    n_walks: int = 10
    walk_length: int = 20
    sgns: SGNSConfig = dataclasses.field(
        default_factory=lambda: SGNSConfig(dim=64, epochs=0.5)
    )
    warm_start: bool = True  # seed emb_in from the previous vectors
    # epoch accounting scales steps with the (small) subcore corpus; the
    # floor matters because emb_out restarts at zero on every refresh, so
    # the first step's emb_in gradient is exactly zero — a 1-step "refresh"
    # would be a no-op on the served table
    min_sgns_steps: int = 50
    align: bool = True  # Procrustes back into the old space
    min_anchors: int = 8  # below this, alignment is skipped (identity)
    propagate: bool = True  # refill every shell below k0 (§2.2) in the swap
    prop_iters: int = 10
    swap_chunk: int = 1024  # put_many rows per rollout chunk
    seed: int = 0


@dataclasses.dataclass
class RetrainPlan:
    """A snapshot of the drifted k0-core, ready to walk and train."""

    snapshot: Graph  # immutable CSR of the whole live graph
    sub: Graph  # induced k0-core subgraph (original node ids)
    core: np.ndarray  # (n,) exact current core numbers (copied)
    baseline: np.ndarray  # (n,) core numbers at the last refresh
    k0: int  # effective k0 (clamped to current degeneracy)
    nodes: np.ndarray  # (m,) k0-core node ids
    drifted: int  # nodes whose (core >= k0) flag flipped since refresh


class RetrainPlanner:
    """Turns the live ``DynamicGraph`` + ``IncrementalCore`` into a plan.

    The maintainer's core numbers are exact (oracle-checked elsewhere), so
    planning costs one vectorized snapshot + one induced-subgraph build —
    no re-peel of the full graph.
    """

    def __init__(self, graph: DynamicGraph, cores: IncrementalCore, k0: int):
        if k0 is None or k0 < 1:
            raise ValueError(f"k0 must be a positive int, got {k0!r}")
        self.graph = graph
        self.cores = cores
        self.k0 = int(k0)

    def plan(self) -> RetrainPlan:
        snap = self.graph.snapshot()
        core = self.cores.core.copy()
        base = self.cores.baseline.copy()
        # deletions can drop the degeneracy below the configured k0; an empty
        # subcore would leave nothing to train on
        k0 = max(1, min(self.k0, degeneracy(core)))
        nodes = np.where(core >= k0)[0]
        drifted = int(np.sum((core >= k0) != (base >= k0)))
        return RetrainPlan(
            snapshot=snap,
            sub=kcore_subgraph(snap, core, k0),
            core=core,
            baseline=base,
            k0=k0,
            nodes=nodes,
            drifted=drifted,
        )


# -------------------------------------------------------------- alignment


def procrustes_rotation(X: np.ndarray, Y: np.ndarray) -> np.ndarray:
    """Orthogonal Procrustes: R = argmin_{R orthogonal} ||X R - Y||_F.

    Closed form (Schönemann 1966): with M = Xᵀ Y = U S Vᵀ, R = U Vᵀ,
    computed in float64 on the host (numpy's SVD, as the JAX package).
    ``U`` and ``V`` are full d x d orthogonal factors even when ``M`` is
    rank-deficient (fewer anchors than dimensions), so R is orthogonal for
    any number of anchors; it recovers a planted rotation only when the
    anchors span the space (n >= d, full rank).
    """
    X = np.asarray(X, np.float64)
    Y = np.asarray(Y, np.float64)
    if X.shape != Y.shape or X.ndim != 2:
        raise ValueError(f"anchor shapes must match, got {X.shape} vs {Y.shape}")
    U, _, Vt = np.linalg.svd(X.T @ Y)
    return (U @ Vt).astype(np.float32)


class EmbeddingAligner:
    """Maps a freshly trained table back into the serving embedding space.

    Anchors should be nodes whose representation has no reason to have
    moved: still in the k0-core, core number unchanged since the last
    refresh, previous vector available. With enough of them the rotation is
    well-conditioned; with fewer than ``min_anchors`` the aligner returns
    the input unchanged (identity), which the report flags.
    """

    def __init__(self, min_anchors: int = 8):
        self.min_anchors = int(min_anchors)

    def align(
        self, new_emb: np.ndarray, old_vecs: np.ndarray, anchors: np.ndarray
    ) -> tuple:
        """-> (aligned (n, d) float32, report dict).

        ``old_vecs`` is (len(anchors), d): the previous vector of each
        anchor node; ``anchors`` indexes rows of ``new_emb``.
        """
        anchors = np.asarray(anchors, np.int64)
        if len(anchors) < self.min_anchors:
            return np.asarray(new_emb, np.float32), {
                "aligned": False,
                "anchors": int(len(anchors)),
                "residual": 0.0,
            }
        X = new_emb[anchors]
        R = procrustes_rotation(X, old_vecs)
        aligned = np.asarray(new_emb, np.float32) @ R
        resid = float(
            np.linalg.norm(aligned[anchors] - old_vecs)
            / max(np.linalg.norm(old_vecs), 1e-12)
        )
        return aligned, {
            "aligned": True,
            "anchors": int(len(anchors)),
            "residual": resid,
        }


# ---------------------------------------------------------------- rollout


class VersionRollout:
    """Double-buffered hot swap of a refreshed table into the store.

    ``stage()`` keeps the new rows host-side (the store's live device table
    is untouched — that is the double buffer); ``commit()`` bumps the store
    version once, then scatters the staged rows in bounded ``chunk``-row
    ``put_many`` batches (one in-place device scatter each), invoking
    ``between()`` after each so the caller can interleave query flushes.
    Rows the refresh did not cover keep their previous version tag; the
    store's per-row versions (and ``version_counts()``) reconcile the
    mixture, and promotion from spill preserves old tags.
    """

    def __init__(self, store: EmbeddingStore, *, chunk: int = 1024):
        self.store = store
        self.chunk = max(int(chunk), 1)
        self._staged: Optional[tuple] = None

    def stage(self, nodes: np.ndarray, vecs: np.ndarray, cores: np.ndarray):
        nodes = np.asarray(nodes, np.int64)
        vecs = np.asarray(vecs, np.float32)
        cores = np.broadcast_to(np.asarray(cores, np.int32), nodes.shape)
        if len(nodes) != len(vecs):
            raise ValueError("nodes/vecs row counts differ")
        self._staged = (nodes, vecs, cores)

    def commit(self, between: Optional[Callable[[], None]] = None) -> dict:
        if self._staged is None:
            raise RuntimeError("nothing staged; call stage() first")
        nodes, vecs, cores = self._staged
        self._staged = None
        version = self.store.bump_version()
        chunk_seconds = []
        for s in range(0, len(nodes), self.chunk):
            faults.check("retrain_swap_chunk")
            t0 = time.perf_counter()
            self.store.put_many(
                nodes[s : s + self.chunk],
                vecs[s : s + self.chunk],
                cores[s : s + self.chunk],
            )
            t1 = time.perf_counter()
            chunk_seconds.append(t1 - t0)
            obs.record(
                "retrain.swap_chunk", t0, t1,
                rows=int(min(self.chunk, len(nodes) - s)),
            )
            if between is not None:
                between()
        return {
            "version": int(version),
            "rows": int(len(nodes)),
            "chunks": len(chunk_seconds),
            "swap_seconds": float(sum(chunk_seconds)),
            "max_chunk_seconds": float(max(chunk_seconds, default=0.0)),
            "version_counts": self.store.version_counts(),
        }


# -------------------------------------------------------------- retrainer


@dataclasses.dataclass
class RetrainReport:
    k0: int
    core_size: int  # nodes in the retrained subcore
    drifted: int  # membership flips that triggered the refresh
    n_walks: int
    sgns_steps: int
    warm_rows: int  # emb_in rows seeded from previous vectors
    anchors: int
    aligned: bool
    align_residual: float
    version: int  # store version the swap installed
    rows_swapped: int
    swap_chunks: int
    staleness_before: float
    staleness_after: float
    pressure_before: float
    pressure_after: float
    times: dict  # plan / walks / train / align / propagate / swap / total


class Retrainer:
    """Drives one full detect→snapshot→retrain→align→swap cycle.

    Holds the service only by reference; ``run()`` reads the live graph /
    cores / store through it, walks and trains on the service's device, and
    the optional ``between`` callback is forwarded to the rollout so callers
    can keep serving mid-swap.
    """

    def __init__(self, service, cfg: Optional[RetrainConfig] = None):
        if service.k0 is None:
            raise ValueError("service.k0 must be set to retrain (drift gate)")
        self.service = service
        self.cfg = cfg or RetrainConfig()
        self.planner = RetrainPlanner(service.graph, service.cores, service.k0)
        self.aligner = EmbeddingAligner(self.cfg.min_anchors)

    # one stage per method so components stay independently testable

    def _train(self, plan: RetrainPlan) -> tuple:
        """CoreWalk walks + warm-started SGNS on the subcore.

        Returns (emb (n, d) float32, meta dict, times dict).
        """
        cfg = self.cfg
        dev = self.service.device
        times = {}
        n = plan.snapshot.n_nodes
        if cfg.method == "corewalk":
            budgets = corewalk_plan(plan.core, cfg.n_walks).per_node
        elif cfg.method == "deepwalk":
            budgets = deepwalk_plan(n, cfg.n_walks).per_node
        else:
            raise ValueError(cfg.method)
        budgets = np.where(plan.core >= plan.k0, budgets, 0).astype(np.int32)
        roots = np.repeat(np.arange(n, dtype=np.int32), budgets)
        wplan = WalkPlan(roots=roots, n_real=len(roots), per_node=budgets)

        self.service.pet_watchdog()
        faults.check("retrain_walks")
        t0 = time.perf_counter()
        corpus = build_corpus(
            plan.sub.to_ell(device=dev),
            wplan,
            cfg.walk_length,
            torch.Generator(device=dev).manual_seed(cfg.seed),
        )
        synchronize(dev)
        times["walks"] = _mark_stage("walks", t0)

        self.service.pet_watchdog()
        faults.check("retrain_train")
        t0 = time.perf_counter()
        params = init_params(
            n, cfg.sgns.dim,
            torch.Generator(device=dev).manual_seed(cfg.sgns.seed),
            device=dev,
        )
        warm_rows = 0
        if cfg.warm_start:
            old, found, _, _ = self.service.store.peek_many(plan.nodes)
            keep = found & (np.linalg.norm(old, axis=1) > 1e-12)
            warm_rows = int(keep.sum())
            if warm_rows:
                rows = torch.tensor(plan.nodes[keep], dtype=torch.long,
                                    device=dev)
                params["emb_in"].index_copy_(
                    0, rows,
                    torch.tensor(old[keep], device=dev).to(
                        params["emb_in"].dtype),
                )
        steps = max(
            cfg.min_sgns_steps,
            int(cfg.sgns.epochs * corpus.pairs_per_epoch(cfg.sgns.window)
                // cfg.sgns.batch),
        )
        res = train_sgns(corpus, cfg.sgns, params=params, steps=steps)
        times["train"] = _mark_stage("train", t0)
        meta = {
            "n_walks": int(wplan.n_real),
            "sgns_steps": int(res.n_steps),
            "warm_rows": warm_rows,
        }
        return res.embeddings, meta, times

    def _anchors(self, plan: RetrainPlan) -> tuple:
        """Stable anchors + their previous vectors (store peek, no LRU churn)."""
        stable = plan.nodes[
            plan.core[plan.nodes] == plan.baseline[plan.nodes]
        ]
        old, found, _, _ = self.service.store.peek_many(stable)
        keep = found & (np.linalg.norm(old, axis=1) > 1e-12)
        if int(keep.sum()) < self.aligner.min_anchors:
            # heavy churn can leave too few level-stable survivors; fall back
            # to every in-core node whose previous vector is still held
            old, found, _, _ = self.service.store.peek_many(plan.nodes)
            keep = found & (np.linalg.norm(old, axis=1) > 1e-12)
            return plan.nodes[keep], old[keep]
        return stable[keep], old[keep]

    def run(
        self, between: Optional[Callable[[], None]] = None
    ) -> Optional[RetrainReport]:
        svc = self.service
        cfg = self.cfg
        times = {}
        t_total = time.perf_counter()
        pressure_before = svc.retrain_pressure()
        staleness_before = svc.store.staleness(svc.cores.core)

        svc.pet_watchdog()
        faults.check("retrain_plan")
        t0 = time.perf_counter()
        plan = self.planner.plan()
        times["plan"] = _mark_stage("plan", t0)
        if len(plan.nodes) == 0:
            return None  # nothing alive at any k0 — nothing to refresh

        emb, meta, t_train = self._train(plan)
        times.update(t_train)

        svc.pet_watchdog()
        faults.check("retrain_align")
        t0 = time.perf_counter()
        if cfg.align:
            anchors, old_vecs = self._anchors(plan)
            emb, align_rep = self.aligner.align(emb, old_vecs, anchors)
        else:
            align_rep = {"aligned": False, "anchors": 0, "residual": 0.0}
        times["align"] = _mark_stage("align", t0)

        svc.pet_watchdog()
        faults.check("retrain_propagate")
        t0 = time.perf_counter()
        if cfg.propagate:
            # §2.2: refill every shell below k0 from the aligned subcore, so
            # the swap covers the whole served id space, not just the core
            # (the host scipy backend, as the JAX package's retrainer)
            emb = propagate(
                plan.snapshot, plan.core, plan.k0, emb,
                n_iters=cfg.prop_iters,
            )
            served = np.where(
                (plan.snapshot.degrees() > 0) | (plan.core >= plan.k0)
            )[0]
        else:
            served = plan.nodes
        times["propagate"] = _mark_stage("propagate", t0)

        svc.pet_watchdog()
        faults.check("retrain_swap")
        t0 = time.perf_counter()
        rollout = VersionRollout(svc.store, chunk=cfg.swap_chunk)
        rollout.stage(served, emb[served], plan.core[served])
        roll = rollout.commit(between)
        svc.cores.mark_refresh()
        synchronize(svc.device)
        times["swap"] = _mark_stage("swap", t0)
        times["total"] = time.perf_counter() - t_total

        return RetrainReport(
            k0=plan.k0,
            core_size=int(len(plan.nodes)),
            drifted=plan.drifted,
            n_walks=meta["n_walks"],
            sgns_steps=meta["sgns_steps"],
            warm_rows=meta["warm_rows"],
            anchors=align_rep["anchors"],
            aligned=align_rep["aligned"],
            align_residual=align_rep["residual"],
            version=roll["version"],
            rows_swapped=roll["rows"],
            swap_chunks=roll["chunks"],
            staleness_before=float(staleness_before),
            staleness_after=float(svc.store.staleness(svc.cores.core)),
            pressure_before=float(pressure_before),
            pressure_after=float(svc.retrain_pressure()),
            times={k: round(v, 6) for k, v in times.items()},
        )
