"""Microbatching query front end of the online embedding service.

The torch counterpart of ``repro.serve.service``. Queries (embedding lookups,
link scores and top-k retrieval) are coalesced into fixed-size batches padded
with -1, so every flush does the same work whatever the traffic.

Per flush (``_flush_batch``), eagerly on the store's device:

1. slot gather of the known nodes from the store's device table;
2. unknown ("cold-start") nodes get the paper's §2.2 rule, one shot: the
   masked mean of their *already-embedded* neighbours, computed by
   ``kernels.ops.ell_mean`` (the CUDA kernel on the card) over the ELL rows
   remapped node->slot into the store table;
3. found/cold select;
4. resolved cold starts are written back into the device table in place
   (with the node's current core number, so staleness tracking covers them),
   turning one-shot propagation into a cascade as traffic touches
   successive shells.

The service also owns ingestion policy: streamed edges arrive in **blocks**
through ``ingest_block`` (``DynamicGraph.add_edges`` + one
``IncrementalCore`` repair for the whole block) and are retracted through
``retract_block`` (``remove_edges`` + repair), with periodic compaction.
Ingest is **pipelined** by default (``pipeline=True``, as in the JAX
package): a block's repair is started (``IncrementalCore.begin_update``:
its descent's first chunk of sweeps enqueued on the device, nothing read
back) and landed at the next sync point (``_sync_ingest``: the next
block's start, a flush, ``sync()``), together with the block's deferred
tail (compaction check, auto retrain). Meanwhile the host validates,
WAL-logs and stages (``DynamicGraph.stage_block``) the next block. Serial
ingest (``pipeline=False``) runs the same steps and lands each block before
returning, so the results are bit-identical.
``retrain_pressure`` (k0-core membership drift since the last refresh)
gates when retraining is due, and ``maybe_retrain`` acts on it: with a
:class:`~repro_torch.serve.retrain.Retrainer` attached (``set_retrainer``),
the drifted k0-core is re-embedded (CoreWalk + SGNS, warm start; the fused
SGNS kernels on the card), Procrustes-aligned into the serving space, and
hot-swapped into the store in chunks.

Fault tolerance, as in the JAX package: an attached
:class:`~repro_torch.serve.recovery.RecoveryManager` logs every block to the
write-ahead log before anything mutates and snapshots on its cadence; a
flush retries a failed dispatch and then answers from the rows the store
already holds (degraded mode); a failed retrain rolls the store back; a
:class:`~repro_torch.distributed.watchdog.HangWatchdog` (``hang_timeout``)
is armed around the blocking device reads. Each of those handlers catches
``faults.InjectedFault``, the fault harness's own error, and nothing else:
a kernel that fails to build or launch, or any other device error,
propagates to the caller. ``faults.InjectedCrash`` (simulated process
death) is a ``BaseException`` and passes every handler.

Under a :class:`~repro_torch.serve.shard.ShardPlan` (the store's and the
graph's) the flush gathers the rows it reads from the owning shards into one
compact table, and ``top_k_neighbors`` reduces a partial top-k on every
shard's rows and stitches the lists on the host; both give the unsharded
bits.

A live SLO engine (``attach_slo``, ``obs.slo``) is fed at the JAX
package's points: each ingested block's edges/s, each flush's seconds and
whether it was degraded; the store's staleness is sampled when the health
is read. ``dispatch_cost_report`` measures one fused flush with
``obs.compiled_cost``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import synchronize
from repro_torch.kernels import ops
from repro_torch.obs import Histogram, compiled_cost, metrics
from repro_torch.obs import trace as obs

from . import faults
from .kcore_inc import IncrementalCore
from .recovery import KIND_INGEST, KIND_RETRACT
from .shard import (RowSharded, map_rows, merge_topk, partial_topk,
                    put_rows, take_rows)
from .store import EmbeddingStore
from .stream import DynamicGraph

__all__ = ["EmbeddingService", "ServiceStats"]

# exact-percentile retention: latency percentiles describe the most recent
# FLUSH_WINDOW flushes / RETRAIN_WINDOW retrains (steady state, bounded
# memory); the histograms' bucket counts still cover the whole lifetime
FLUSH_WINDOW = 4096
RETRAIN_WINDOW = 64


@dataclasses.dataclass
class ServiceStats:
    queries: int = 0
    store_hits: int = 0
    cold_starts: int = 0
    unresolved: int = 0
    flushes: int = 0
    edges_ingested: int = 0
    edges_removed: int = 0
    ingest_blocks: int = 0
    compactions: int = 0
    retrains: int = 0
    last_swap_version: int = -1  # -1 = no retrain swap has happened yet
    degraded_queries: int = 0  # answered from stale rows (flush fallback)
    retrain_failures: int = 0  # retrains rolled back transactionally
    hangs: int = 0  # HangWatchdog firings around blocking device reads
    # bounded fixed-bucket histograms (obs.metrics.Histogram): percentiles
    # are exact over the retained window (FLUSH_WINDOW / RETRAIN_WINDOW most
    # recent samples), lifetime bucket counts feed the metrics exporters
    topk_queries: int = 0  # nodes served through top_k_neighbors
    flush_seconds: Histogram = dataclasses.field(
        default_factory=lambda: Histogram(window=FLUSH_WINDOW)
    )
    retrain_seconds: Histogram = dataclasses.field(
        default_factory=lambda: Histogram(window=RETRAIN_WINDOW)
    )
    topk_seconds: Histogram = dataclasses.field(
        default_factory=lambda: Histogram(window=FLUSH_WINDOW)
    )

    @property
    def cold_fraction(self) -> float:
        return self.cold_starts / max(self.queries, 1)


class EmbeddingService:
    def __init__(
        self,
        graph: DynamicGraph,
        cores: IncrementalCore,
        store: EmbeddingStore,
        *,
        batch: int = 64,
        compact_every: int = 1024,
        k0: Optional[int] = None,
        retrain_threshold: float = 0.1,
        pipeline: bool = True,
        hang_timeout: Optional[float] = None,
        flush_retries: int = 1,
        retry_backoff: float = 0.05,
    ):
        if store.device != graph.device:
            raise ValueError(
                f"store on {store.device} but graph on {graph.device}"
            )
        self.graph = graph
        self.cores = cores
        self.store = store
        self.device = store.device
        self.batch = int(batch)
        self.compact_every = int(compact_every)
        self.k0 = k0
        self.retrain_threshold = float(retrain_threshold)
        # pipelined ingest: stage block N+1 (host dedup/canonicalise) while
        # block N's descent is enqueued on the device and unread, then land
        # the repair + deferred per-block tail at the next sync point;
        # pipeline=False lands every block before ingest_block returns.
        self.pipeline = bool(pipeline)
        self._tail_due = False
        self.stats = ServiceStats()
        # retraining loop: a Retrainer (serve.retrain) attached via
        # set_retrainer; auto mode re-checks drift after every block
        self.retrainer = None
        self.auto_retrain = False
        self.retrain_budget = 0  # max retrains per service life (0 = no cap)
        self._pending: List[np.ndarray] = []
        self._n_pending = 0
        # fault tolerance: optional recovery manager (WAL + snapshots),
        # bounded flush retries with a stale-row degraded fallback, a
        # transactional retrain (store rolled back on an injected fault),
        # and an optional hang watchdog around blocking device reads
        self._recovery = None
        # live SLO engine (obs.slo): attach_slo() wires the stock
        # objectives; hot paths feed it only when attached (None check)
        self._slo = None
        self.flush_retries = max(int(flush_retries), 0)
        self.retry_backoff = float(retry_backoff)
        self.degraded = False
        self._watchdog = None
        if hang_timeout is not None and hang_timeout > 0:
            from repro_torch.distributed.watchdog import HangWatchdog

            self._watchdog = HangWatchdog(float(hang_timeout), self._on_hang)

    # ------------------------------------------------------------ ingestion

    def attach_recovery(self, manager) -> None:
        """Attach a :class:`~repro_torch.serve.recovery.RecoveryManager`:
        every block is WAL-logged before mutation, snapshots run on its
        cadence."""
        self._recovery = manager

    def attach_slo(self, engine=None, **thresholds):
        """Attach a live :class:`~repro_torch.obs.slo.SLOEngine` (or build
        the stock one, ``thresholds`` forwarded to
        :func:`~repro_torch.obs.slo.default_slos`).

        Event objectives (flush latency, per-block ingest rate, degraded
        fraction) are fed from the hot paths at one comparison + one deque
        append per event; the staleness objective is provider-backed (the
        stale-row walk is O(resident rows)) and sampled only when
        ``slo_health()`` / ``publish_metrics`` pull it. Returns the engine.
        """
        if engine is None:
            from repro_torch.obs.slo import default_slos

            thresholds.setdefault(
                "staleness_provider",
                lambda: self.store.staleness(self.cores.core),
            )
            engine = default_slos(**thresholds)
        self._slo = engine
        return engine

    def slo_health(self):
        """Current SLO snapshot (``None`` when no engine is attached)."""
        return None if self._slo is None else self._slo.health()

    def _on_hang(self) -> None:
        """HangWatchdog callback: count the hang, enter degraded mode."""
        self.stats.hangs += 1
        self.degraded = True
        metrics().counter("serve_hangs_total").inc()
        metrics().gauge("serve_degraded").set(1)

    def pet_watchdog(self) -> None:
        """Reset the hang timer from inside a long multi-stage section
        (the retrainer pets between stages)."""
        if self._watchdog is not None and self._watchdog.armed:
            self._watchdog.pet()

    @staticmethod
    def _validate_block(edges) -> np.ndarray:
        """Strict block validation: the graph layer silently drops
        self-loops/duplicates, but at the service boundary malformed input
        is an error — a negative id or a float block would otherwise wrap
        into the sentinel row and corrupt the grouped scatter silently."""
        arr = np.asarray(edges)
        if arr.dtype == object or not np.issubdtype(arr.dtype, np.integer):
            raise ValueError(
                f"edge block must have an integer dtype, got {arr.dtype}"
            )
        try:
            arr = arr.reshape(-1, 2)
        except ValueError:
            raise ValueError(
                f"edge block must be (m, 2)-shaped, got shape {arr.shape}"
            )
        arr = arr.astype(np.int64, copy=False)
        if arr.size:
            if int(arr.min()) < 0:
                bad = arr[(arr < 0).any(axis=1)][0]
                raise ValueError(
                    f"node ids must be non-negative, got edge {tuple(bad)}"
                )
            loops = arr[:, 0] == arr[:, 1]
            if loops.any():
                v = int(arr[loops][0, 0])
                raise ValueError(f"self-loops are not allowed, got ({v}, {v})")
        return arr

    def _maybe_compact(self) -> None:
        if self.graph.edges_since_compact >= self.compact_every or (
            self.graph.overflow_arcs > max(16, self.graph.n_edges // 20)
        ):
            self.graph.compact()
            self.stats.compactions += 1
            metrics().counter("serve_compactions_total").inc()

    def _sync_ingest(self) -> None:
        """Land the in-flight repair and run the deferred per-block tail.

        Pipelined ingest defers the post-repair tail (compaction check, auto
        retrain) to the next sync point. Running it here — after the repair
        landed and *before* any new mutation — keeps the graph state at tail
        time identical to the serial path, which is what makes pipelining
        bit-exact. The flag flips before the tail runs so a retrain-triggered
        flush re-entering this method is a no-op.
        """
        self.cores.finish_update()
        if self._tail_due:
            self._tail_due = False
            self._maybe_compact()
            if self.auto_retrain:
                self.maybe_retrain()

    def sync(self) -> None:
        """Explicit flush boundary: land pipelined ingest fully, then wait
        for the device's queued work."""
        self._sync_ingest()
        synchronize(self.device)

    def ingest_block(self, edges: np.ndarray) -> np.ndarray:
        """Stream an edge block: one staged insert + one block core repair.

        Returns the (m', 2) edges accepted (self-loops, duplicates, and
        edges already present are dropped by the graph). With a recovery
        manager attached the block is logged durably first; with auto
        retraining on, drift is re-checked after the repair. With
        ``pipeline`` on, this block's staging overlaps the previous block's
        descent on the device, and the repair readback + per-block tail are
        deferred to the next ingest/retract/flush/``sync()``; without it they
        run before this call returns.
        """
        edges = self._validate_block(edges)
        t_slo = time.perf_counter() if self._slo is not None else 0.0
        with obs.span("serve.ingest", block=len(edges)) as sp:
            if self._recovery is not None:  # durable *before* any mutation
                self._recovery.log_block(KIND_INGEST, edges)
            faults.check("ingest_apply")
            # host-only staging while block N-1's descent is unread
            staged = self.graph.stage_block(edges)
            self._sync_ingest()
            accepted = self.graph.add_edges(staged, staged=True)
            if len(accepted):
                self.cores.begin_update(added=accepted)
            self._tail_due = True
            sp.set(accepted=len(accepted))
            self.stats.edges_ingested += len(accepted)
            self.stats.ingest_blocks += 1
            metrics().counter("serve_edges_ingested_total").inc(len(accepted))
            if not self.pipeline:
                self._sync_ingest()
        if self._slo is not None and len(accepted):
            # the block's edges/s from before its WAL append to after its
            # repair (and any compaction or retrain it triggered); pipelined
            # blocks measure staging + the previous block's landing — the
            # rate traffic actually experiences at this boundary
            self._slo.observe(
                "ingest_rate",
                len(accepted) / max(time.perf_counter() - t_slo, 1e-9),
            )
        if self._recovery is not None:
            self._recovery.after_block()
        return accepted

    def retract_block(self, edges: np.ndarray) -> int:
        """Retract an edge block: one block delete + one block core repair.

        Unknown edges are skipped; returns the number actually removed.
        Demotions feed the same drift/staleness signals as promotions.
        Logged, pipelined and followed by the auto-retrain check like
        ``ingest_block``.
        """
        edges = self._validate_block(edges)
        with obs.span("serve.retract", block=len(edges)) as sp:
            if self._recovery is not None:  # durable *before* any mutation
                self._recovery.log_block(KIND_RETRACT, edges)
            faults.check("ingest_apply")
            staged = self.graph.stage_block(edges)
            self._sync_ingest()
            removed = self.graph.remove_edges(staged, staged=True)
            if len(removed):
                self.cores.begin_update(removed=removed)
            self._tail_due = True
            sp.set(removed=len(removed))
            self.stats.edges_removed += len(removed)
            metrics().counter("serve_edges_removed_total").inc(len(removed))
            if not self.pipeline:
                self._sync_ingest()
        if self._recovery is not None:
            self._recovery.after_block()
        return len(removed)

    def ingest(self, u: int, v: int) -> bool:
        """Stream one edge (single-edge convenience over ``ingest_block``)."""
        return bool(len(self.ingest_block(np.array([[u, v]], np.int64))))

    def retract(self, u: int, v: int) -> bool:
        """Retract one edge (single-edge convenience over ``retract_block``)."""
        return bool(self.retract_block(np.array([[u, v]], np.int64)))

    def ingest_edges(self, edges: np.ndarray, block_size: int = 256) -> int:
        """Stream an edge array in ``block_size`` chunks; returns #accepted."""
        edges = np.asarray(edges)
        block_size = max(int(block_size), 1)
        n = sum(
            len(self.ingest_block(edges[s : s + block_size]))
            for s in range(0, len(edges), block_size)
        )
        self.sync()  # land the last block's in-flight repair + deferred tail
        return n

    def stream_with_churn(
        self,
        edges: np.ndarray,
        *,
        block_size: int = 256,
        churn: float = 0.0,
        rng: Optional[np.random.Generator] = None,
    ) -> Tuple[int, int]:
        """Stream ``edges`` in blocks, retracting a ``churn`` fraction of the
        previously streamed (and not yet retracted) edges after each block.

        The replay loop the launcher and the serving benchmark share; returns
        (#edges accepted, #edges retracted).
        """
        edges = np.asarray(edges)
        block_size = max(int(block_size), 1)
        rng = np.random.default_rng() if rng is None else rng
        live: List[Tuple[int, int]] = []  # accepted and not yet retracted
        n_in = n_out = 0
        for start in range(0, len(edges), block_size):
            block = edges[start : start + block_size]
            accepted = self.ingest_block(block)
            n_in += len(accepted)
            live.extend(map(tuple, accepted))
            n_churn = min(int(round(churn * len(block))), len(live))
            if n_churn:
                pick = rng.choice(len(live), size=n_churn, replace=False)
                gone = set(pick.tolist())
                n_out += self.retract_block(np.array([live[i] for i in pick]))
                live = [e for i, e in enumerate(live) if i not in gone]
        self.sync()  # land the last block's in-flight repair + deferred tail
        return n_in, n_out

    # ------------------------------------------------------------- queries

    def submit(self, node: int) -> int:
        """Queue an embedding query; returns its index in the next flush."""
        return int(self.submit_many(np.asarray([node], np.int64))[0])

    def submit_many(self, nodes: Sequence[int]) -> np.ndarray:
        """Queue a whole batch of queries in one vectorized append.

        Returns the (len(nodes),) indices the queries will occupy in the
        next ``flush()`` output. The pending queue holds arrays, not Python
        ints, so submitting N nodes costs O(1) list work — the per-node
        Python loop the old ``embed`` path paid is gone.
        """
        nodes = np.asarray(nodes, np.int64).reshape(-1)
        if nodes.size and int(nodes.min()) < 0:
            bad = int(nodes[nodes < 0][0])
            raise ValueError(f"node id must be non-negative, got {bad}")
        start = self._n_pending
        if nodes.size:
            self._pending.append(nodes)
            self._n_pending += len(nodes)
        return np.arange(start, start + len(nodes))

    @property
    def pending(self) -> int:
        return self._n_pending

    def _wb_cores(self, wb_nodes: np.ndarray) -> np.ndarray:
        """Current core numbers for write-back staleness tagging."""
        core = self.cores.core
        return np.where(
            wb_nodes < len(core),
            core[np.minimum(wb_nodes, max(len(core) - 1, 0))], 0
        )

    def _fused_flush(self, nodes_c, found, wb_slots):
        """Slot gather -> §2.2 cold-start mean -> select -> write-back, on
        the store's device. ``wb_slots[i]`` is the pre-reserved target slot
        of a cold row (``capacity`` = no write-back), or None when nothing
        is written back; each input is a numpy array or a tensor. Returns
        ``(out (B, dim), resolved (B,))`` tensors.

        Under a plan the sentinel id and the slot bound are data (the
        mirror and the table carry shard-padding rows): the batch's mirror
        rows and the table rows they name come from their owning shards
        into one compact table on the primary device, the slots are
        remapped into it, and the write-back goes to the owners. The ELL
        mean's path depends on (N, L) alone, so the compact table gives the
        bits of the whole one.
        """
        st = self.store
        dev, cap, sentinel = self.device, st.capacity, self.graph.node_cap
        table = st.table()
        slot_of = st.slot_table_dev()
        nodes_t = torch.as_tensor(nodes_c, device=dev)
        found_t = torch.as_tensor(found, device=dev)
        # (B, W) neighbour ids
        idx = take_rows(self.graph.ell().neighbours, nodes_t)
        slots = slot_of[idx.long()]  # (B, W) store slots (sentinel = cap)
        valid = (idx != sentinel) & (slots < cap)
        # spill-tier rows carry found=True with a sentinel slot (zero row)
        # and are overlaid host-side after the readback
        own = torch.where(found_t, slot_of[nodes_t], cap)
        rows, src, src_own = table, slots, own
        if isinstance(table, RowSharded):
            used, inv = torch.unique(torch.cat([slots.flatten(), own]),
                                     return_inverse=True)
            rows = table.gather(used)
            src = inv[: slots.numel()].reshape(slots.shape)
            src_own = inv[slots.numel():]
        cold = ops.ell_mean(src, valid, rows)
        resolved = valid.any(dim=1)
        out = torch.where(found_t[:, None], rows[src_own.long()], cold)
        if wb_slots is not None:
            # unresolved rows redirect to the zero sentinel row and write
            # zeros, so the sentinel stays zero; the write lands in the
            # device table in place (index_copy_), where the JAX package's
            # jitted program returned a new table
            wb = torch.as_tensor(wb_slots, device=dev)
            do_wb = ~found_t & resolved & (wb < cap)
            wslots = torch.where(do_wb, wb, cap).long()
            put_rows(table, wslots, torch.where(do_wb[:, None], out, 0.0))
        return out, resolved

    def _flush_batch(self, nodes: np.ndarray) -> np.ndarray:
        """One static-shaped batch (len == self.batch, padded with -1).

        The host reserves write-back slots, the device runs the fused flush
        (``_fused_flush``), and the host commits the metadata of the rows
        written back after the one readback. An injected dispatch fault is
        retried ``flush_retries`` times with backoff; then the batch is
        answered from the rows both store tiers already hold (``peek_many``:
        no promotion, no dispatch), cold starts unresolved, and the service
        is flagged degraded until a flush succeeds again.
        """
        t0 = time.perf_counter()
        with obs.span("serve.flush", batch=self.batch) as sp:
            st = self.store
            sentinel = self.graph.node_cap
            # align the slot map with the graph's id space up front. Padding
            # travels as -1 and is masked here — a sentinel snapshotted at
            # enqueue time could alias a node id minted by later growth
            st.ensure_nodes(sentinel)
            real = (nodes >= 0) & (nodes < sentinel)
            nodes_c = np.where(real, nodes, sentinel)
            degraded_batch = False
            wb_slots_u = None
            for attempt in range(self.flush_retries + 1):
                try:
                    # spill-tier rows must answer queries directly (capacity
                    # < working set must never thrash real embeddings into
                    # cold-start means): restore what fits, overlay the rest
                    st.promote(nodes_c)
                    slots = st.slots_of(nodes_c)
                    resident = slots < st.capacity
                    bounced = {}  # row -> spilled vec served host-side
                    if st.spilled:
                        for i in np.where(real & ~resident)[0]:
                            hit = st.peek_spill(int(nodes_c[i]))
                            if hit is not None:
                                bounced[int(i)] = hit
                    st.note_fused_gather(slots, resident, len(bounced))
                    found = resident.copy()
                    if bounced:
                        found[list(bounced)] = True
                    cold = real & ~found
                    # cold-start means must see every *embedded* neighbour,
                    # including rows currently spilled to host
                    if cold.any() and st.spilled:
                        nbrs = np.concatenate(
                            [self.graph.neighbours(int(v))
                             for v in nodes_c[cold]]
                        )
                        st.promote(nbrs)
                    # dedup within the batch: duplicate cold ids share one
                    # reserved slot (and later count as one cold start)
                    uniq_cold, first_pos = np.unique(nodes_c[cold],
                                                     return_index=True)
                    if len(uniq_cold):
                        wb_slots_u = st.reserve_slots(len(uniq_cold))
                    wb_slots = None
                    if wb_slots_u is not None:
                        wb_slots = np.full(len(nodes), st.capacity, np.int32)
                        slot_of_cold = dict(
                            zip(uniq_cold.tolist(), wb_slots_u.tolist())
                        )
                        for i in np.where(cold)[0]:
                            wb_slots[i] = slot_of_cold[int(nodes_c[i])]

                    faults.check("flush_dispatch")
                    out, resolved = self._fused_flush(nodes_c, found,
                                                      wb_slots)
                    wd = self._watchdog
                    if wd is not None:
                        wd.arm()
                    try:
                        out = out.cpu().numpy()  # the blocking device sync
                    finally:
                        if wd is not None:
                            wd.disarm()
                    resolved = resolved.cpu().numpy()
                    # commit the written rows: tag versions/cores, return
                    # unresolved slots to the pool
                    cold_rows = np.where(cold)[0][first_pos]
                    if wb_slots_u is not None:
                        ok = resolved[cold_rows]
                        st.adopt_fused(
                            uniq_cold[ok], wb_slots_u[ok],
                            self._wb_cores(uniq_cold[ok]),
                        )
                        if (~ok).any():
                            st.release_slots(wb_slots_u[~ok])
                    elif len(uniq_cold):
                        # free list could not cover the batch: evicting
                        # write-back through put_many (host readback path)
                        ok = resolved[cold_rows]
                        if ok.any():
                            st.put_many(
                                uniq_cold[ok], out[cold_rows[ok]],
                                self._wb_cores(uniq_cold[ok]),
                            )
                    for i, vec in bounced.items():  # spill-tier overlay
                        out[i] = vec
                    if self.degraded:  # a healthy flush clears degraded mode
                        self.degraded = False
                        metrics().gauge("serve_degraded").set(0)
                    break
                except faults.InjectedFault:
                    metrics().counter("serve_flush_failures_total").inc()
                    if wb_slots_u is not None:  # undo the reservation exactly
                        st.release_slots(wb_slots_u)
                        wb_slots_u = None
                    if attempt < self.flush_retries:
                        time.sleep(self.retry_backoff * (2 ** attempt))
                        continue
                    # degraded serving: answer from whatever rows both store
                    # tiers already hold, cold starts stay unresolved
                    vecs, found, _, _ = st.peek_many(nodes_c)
                    cold = real & ~found
                    uniq_cold, first_pos = np.unique(nodes_c[cold],
                                                     return_index=True)
                    cold_rows = np.where(cold)[0][first_pos]
                    out = vecs
                    resolved = np.zeros(len(nodes), bool)
                    degraded_batch = True
                    if not self.degraded:
                        self.degraded = True
                        metrics().gauge("serve_degraded").set(1)

            n_real = int(real.sum())
            n_hits = int((real & found).sum())
            # duplicates within one batch are one cold start, not several
            n_cold = int(len(uniq_cold))
            n_unresolved = int((~resolved[cold_rows]).sum()) if n_cold else 0
            self.stats.queries += n_real
            self.stats.store_hits += n_hits
            self.stats.cold_starts += n_cold
            self.stats.unresolved += n_unresolved
            reg = metrics()
            if degraded_batch:
                self.stats.degraded_queries += n_real
                reg.counter("serve_degraded_queries_total").inc(n_real)
            reg.counter("serve_queries_total").inc(n_real)
            reg.counter("serve_store_hits_total").inc(n_hits)
            reg.counter("serve_cold_starts_total").inc(n_cold)
            reg.counter("serve_unresolved_total").inc(n_unresolved)
            self.stats.flushes += 1
            dt = time.perf_counter() - t0
            self.stats.flush_seconds.observe(dt)
            if self._slo is not None:
                self._slo.observe("flush_latency", dt)
                self._slo.observe(
                    "degraded_serving", 1.0 if degraded_batch else 0.0
                )
            sp.set(hits=n_hits, cold=n_cold, unresolved=n_unresolved)
        return out

    def flush(self) -> np.ndarray:
        """Drain the pending queue in static batches; returns (Q, dim)."""
        self._sync_ingest()  # queries must see fully-landed cores/compaction
        queue = (
            np.concatenate(self._pending)
            if self._pending
            else np.zeros(0, np.int64)
        )
        self._pending = []
        self._n_pending = 0
        outs = []
        for start in range(0, len(queue), self.batch):
            chunk = queue[start : start + self.batch]
            # pad with -1, not the current graph sentinel: node_cap grows
            # under ensure_nodes/compaction, so a sentinel snapshotted here
            # could alias a node id that is valid by the time the batch
            # dispatches — -1 can never collide with a real id
            padded = np.full(self.batch, -1, np.int64)
            padded[: len(chunk)] = chunk
            outs.append(self._flush_batch(padded)[: len(chunk)])
        if not outs:
            return np.zeros((0, self.store.dim), np.float32)
        return np.concatenate(outs, axis=0)

    def embed(self, nodes: Sequence[int]) -> np.ndarray:
        """Convenience: submit_many + flush. Returns (len(nodes), dim)."""
        self.submit_many(nodes)
        return self.flush()

    def link_scores(self, pairs: np.ndarray) -> np.ndarray:
        """Cosine link scores for (P, 2) node pairs (cold-starts both ends).

        Cosine, matching the retrain-eval AUC ranking (propagation shrinks
        norms shell by shell, so raw dot products rank by depth as much as
        affinity); normalisation goes through the same
        :func:`~repro_torch.kernels.ops.normalize_rows` scoring tile the top-k
        retrieval kernel uses, so link scores and ``top_k_neighbors``
        scores are the same numbers. Repeated endpoints are deduplicated
        into a single flush slot — a pair list touching few distinct nodes
        no longer triggers redundant cold-start dispatches.
        """
        pairs = np.asarray(pairs, np.int64)
        flat = pairs.reshape(-1)
        uniq, inv = np.unique(flat, return_inverse=True)
        emb = ops.normalize_rows(
            torch.tensor(self.embed(uniq), device=self.device)
        ).cpu().numpy()
        e = emb[inv]
        return np.sum(e[0::2] * e[1::2], axis=1)

    def top_k_neighbors(
        self, nodes: Sequence[int], k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """k nearest resident embeddings by cosine, per query node.

        Queries resolve through the normal flush path first (cold starts
        get their §2.2 propagation mean and are written back), then score
        against every *live* device-table row through
        ``kernels.ops.top_k_scores`` (the streaming CUDA kernel on the card,
        which never materialises the (Q, N) scores). Each query node is
        excluded from its own result, so the kernel is asked for k + 1.

        Returns ``(node_ids (Q, k) int64, scores (Q, k) float32)`` ordered
        by (score desc, node-slot asc); -1 / -inf pad when fewer than k
        candidates are resident. Every shard (the whole table unsharded)
        normalises its own rows and reduces a partial top-k over them
        through the one kernel (``shard.partial_topk``), and the host
        stitches the lists (``shard.merge_topk``; one list is only padded).
        """
        nodes = np.asarray(nodes, np.int64).reshape(-1)
        k = int(k)
        if k < 1 or not len(nodes):
            return (np.zeros((len(nodes), max(k, 0)), np.int64),
                    np.zeros((len(nodes), max(k, 0)), np.float32))
        t0 = time.perf_counter()
        with obs.span("serve.topk", batch=len(nodes), k=k) as sp:
            qv = self.embed(nodes)  # resolves cold starts + write-back
            st = self.store
            qn = ops.normalize_rows(torch.tensor(qv, device=self.device))
            # ask for k+1 candidates: the query's own row (when resident)
            # is dropped host-side, leaving a full k for everyone
            kk = k + 1
            vals, idx = merge_topk(*partial_topk(
                qn, map_rows(st.table(), ops.normalize_rows),
                st.row_valid(), kk), kk)
            own = st.slots_of(nodes).astype(np.int64)  # capacity = absent
            keep = (idx >= 0) & (idx != own[:, None])
            order = np.argsort(~keep, axis=1, kind="stable")
            sel = np.take_along_axis(idx, order, 1)[:, :k]
            sval = np.take_along_axis(vals, order, 1)[:, :k]
            kept = np.take_along_axis(keep, order, 1)[:, :k]
            ids = np.where(
                kept, st.node_of_slots(np.maximum(sel, 0)), -1
            )
            scores = np.where(kept, sval, -np.inf).astype(np.float32)
            self.stats.topk_queries += len(nodes)
            self.stats.topk_seconds.observe(time.perf_counter() - t0)
            metrics().counter("serve_topk_queries_total").inc(len(nodes))
            sp.set(candidates=int(st.resident))
        return ids, scores

    # ----------------------------------------------------------- retraining

    def retrain_pressure(self) -> float:
        """Fraction of the k0-core whose membership flipped since refresh."""
        if self.k0 is None:
            return 0.0
        changed, size = self.cores.membership_drift(self.k0)
        return changed / max(size, 1)

    def should_retrain(self) -> bool:
        return self.retrain_pressure() >= self.retrain_threshold

    def set_retrainer(self, retrainer, *, auto: bool = False,
                      budget: int = 0) -> None:
        """Attach a :class:`~repro_torch.serve.retrain.Retrainer` to close
        the loop.

        ``auto=True`` re-checks drift after every ingested/retracted block
        and refreshes in place; ``budget`` caps how many refreshes this
        service will run (0 = uncapped).
        """
        self.retrainer = retrainer
        self.auto_retrain = bool(auto)
        self.retrain_budget = int(budget)

    def maybe_retrain(self, force: bool = False, between=None):
        """Run one drift-triggered retrain + hot-swap cycle when due.

        Returns the :class:`~repro_torch.serve.retrain.RetrainReport` (or
        None if no retrainer is attached, pressure is below threshold and
        ``force`` is unset, the budget is spent, the planner found nothing
        to refresh, or an injected fault rolled the retrain back).
        ``between`` is forwarded to the rollout so query flushes can
        interleave with the swap's chunked scatters.
        """
        if self.retrainer is None:
            return None
        if self.retrain_budget and self.stats.retrains >= self.retrain_budget:
            return None
        if not force and not self.should_retrain():
            return None
        t0 = time.perf_counter()
        # transactional: capture the store (host copy) before any stage
        # runs, restore it wholesale on an injected fault — a retrain that
        # dies mid-VersionRollout must not leave mixed-version rows. The
        # core baseline needs no rollback: mark_refresh only runs after a
        # successful swap. Any other error (a kernel that fails to build or
        # launch) propagates, and InjectedCrash (simulated process death)
        # is a BaseException and passes through too.
        pre = self.store.state_dict()
        wd = self._watchdog
        if wd is not None:
            wd.arm()
        try:
            with obs.span("serve.retrain") as sp:
                report = self.retrainer.run(between=between)
                if report is not None:
                    sp.set(version=report.version, rows=report.rows_swapped)
        except faults.InjectedFault:
            self.stats.retrain_failures += 1
            metrics().counter("serve_retrain_failures_total").inc()
            self.store.load_state_dict(pre)
            return None
        finally:
            if wd is not None:
                wd.disarm()
        if report is None:
            return None
        self.stats.retrains += 1
        self.stats.last_swap_version = report.version
        self.stats.retrain_seconds.observe(time.perf_counter() - t0)
        metrics().counter("serve_retrains_total").inc()
        return report

    def mark_refreshed(self) -> None:
        """Call after reloading the store from an offline retrain."""
        self.cores.mark_refresh()
        self.store.bump_version()

    # ------------------------------------------------------------- reports

    def latency_percentiles(self) -> Tuple[float, float]:
        """(p50, p99) per-flush seconds (each flush serves ``batch`` slots).

        Exact percentiles over the histogram's retained window — the most
        recent ``FLUSH_WINDOW`` (4096) flushes; earlier flushes still count
        in the histogram's bucket totals but no longer move the percentiles.
        """
        h = self.stats.flush_seconds
        if not len(h):
            return 0.0, 0.0
        p50, p99 = h.percentile([50, 99])
        return float(p50), float(p99)

    def topk_latency_percentiles(self) -> Tuple[float, float]:
        """(p50, p99) per-call ``top_k_neighbors`` seconds (same retained
        window semantics as :meth:`latency_percentiles`)."""
        h = self.stats.topk_seconds
        if not len(h):
            return 0.0, 0.0
        p50, p99 = h.percentile([50, 99])
        return float(p50), float(p99)

    def publish_metrics(self, registry=None) -> None:
        """Register this service's live stats into a metrics registry.

        The flush/retrain/top-k histograms are adopted by reference (the
        exporter reads the very objects the service observes into),
        counters/gauges are set to the current totals.
        """
        reg = metrics() if registry is None else registry
        st = self.stats
        reg.register("serve_flush_seconds", st.flush_seconds, replace=True)
        reg.register("serve_retrain_seconds", st.retrain_seconds,
                     replace=True)
        reg.register("serve_topk_seconds", st.topk_seconds, replace=True)
        for name, value in (
            ("serve_queries", st.queries),
            ("serve_store_hits", st.store_hits),
            ("serve_cold_starts", st.cold_starts),
            ("serve_unresolved", st.unresolved),
            ("serve_flushes", st.flushes),
            ("serve_ingest_blocks", st.ingest_blocks),
            ("serve_edges_ingested", st.edges_ingested),
            ("serve_edges_removed", st.edges_removed),
            ("serve_compactions", st.compactions),
            ("serve_retrains", st.retrains),
            ("serve_topk_queries", st.topk_queries),
            ("serve_degraded_queries", st.degraded_queries),
            ("serve_retrain_failures", st.retrain_failures),
            ("serve_hangs", st.hangs),
            ("serve_pending_queries", self.pending),
            ("store_resident_rows", self.store.resident),
            ("store_spilled_rows", self.store.spilled),
            ("store_evictions", self.store.evictions),
            ("graph_nodes", self.graph.n_nodes),
            ("graph_edges", self.graph.n_edges),
            ("graph_overflow_arcs", self.graph.overflow_arcs),
        ):
            reg.gauge(name).set(value)
        reg.gauge("serve_degraded").set(int(self.degraded))
        reg.gauge("serve_retrain_pressure").set(self.retrain_pressure())
        reg.gauge("store_staleness").set(
            self.store.staleness(self.cores.core)
        )
        if self.store.plan is not None:
            for s, rows in enumerate(self.store.shard_gather_rows):
                reg.gauge("store_gather_rows", shard=s).set(int(rows))
            reg.gauge("store_cross_shard_row_copies").set(
                int(self.store.cross_shard_row_copies)
            )
            for op, nbytes in self.store.plan.traffic.items():
                reg.gauge("shard_moved_bytes", op=op).set(int(nbytes))
        if self._slo is not None:
            self._slo.publish(reg)

    def dispatch_cost_report(self) -> dict:
        """Measured cost of one fused flush (``_fused_flush``: gather ->
        cold-start mean -> select -> write-back) at the batch the serving
        path dispatches, from :func:`~repro_torch.obs.compiled_cost`: flops,
        bytes accessed, argument / output / temp bytes.

        The inputs are the JAX package's: node 0 in every row, none found,
        every write-back slot ``capacity``, so the only write is zeros into
        the zero sentinel row and the table, slot map and stats stay as they
        were. The call runs on the device like any flush (on the card, one
        ELL-mean launch); call it at export time, not on the hot path.
        """
        self.store.ensure_nodes(self.graph.node_cap)
        dev, b = self.device, self.batch
        return compiled_cost(
            self._fused_flush,
            torch.zeros(b, dtype=torch.int64, device=dev),
            torch.zeros(b, dtype=torch.bool, device=dev),
            torch.full((b,), self.store.capacity, dtype=torch.int32,
                       device=dev),
        )
