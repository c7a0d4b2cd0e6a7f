"""Versioned fixed-capacity embedding store for online serving.

The torch counterpart of ``repro.serve.store``. Two tiers:

* **device-resident table** ``(capacity + 1, dim)`` float32 on ``device`` —
  the hot set, gathered on the query path (row ``capacity`` is an all-zero
  sentinel so misses/padding gather zeros);
* **host spillover** — rows evicted from the device table are kept in a host
  dict and transparently promoted back on access (an LRU cache over the
  device table, not data loss).

Writes land in the device table **in place** (``index_copy_``), where the
JAX package's ``.at[].set`` built a new table per write.

Every row remembers the store ``version`` and the node's core number at write
time. Core-number **drift** between write time and now is the staleness
signal (paper §2.2: propagation-filled embeddings are valid while the node's
shell is stable); ``staleness()`` reports the stale fraction and the service
uses it to gate retraining.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs import metrics
from repro_torch.obs import trace as obs

from . import faults

__all__ = ["EmbeddingStore"]


class EmbeddingStore:
    def __init__(
        self,
        capacity: int,
        dim: int,
        node_cap: int,
        *,
        device="cuda",
    ):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.dim = int(dim)
        self.node_cap = int(node_cap)
        self.device = resolve_device(device)
        self._rows = self.capacity + 1
        self._table = torch.zeros((self._rows, self.dim), dtype=torch.float32,
                                  device=self.device)
        # node id -> slot; sentinel value ``capacity`` means absent. The extra
        # entry (index node_cap) lets ELL sentinel ids flow through gathers.
        self._slot_of = np.full(self.node_cap + 1, self.capacity, np.int32)
        self._node_at = np.full(self.capacity, -1, np.int64)
        self._version_at = np.zeros(self.capacity, np.int64)
        self._core_at = np.zeros(self.capacity, np.int32)
        self._last_used = np.zeros(self.capacity, np.int64)
        self._spill: Dict[int, Tuple[np.ndarray, int, int]] = {}
        self.version = 0
        self.evictions = 0
        self._clock = 0
        self._free = list(range(self.capacity - 1, -1, -1))
        self._slot_dev: Optional[torch.Tensor] = None
        self._slot_dirty = True

    # ------------------------------------------------------------- queries

    def __len__(self) -> int:
        return self.capacity - len(self._free)

    def __contains__(self, node: int) -> bool:
        return self._slot_of[node] < self.capacity or node in self._spill

    @property
    def resident(self) -> int:
        return len(self)

    @property
    def spilled(self) -> int:
        return len(self._spill)

    def slots_of(self, nodes: np.ndarray) -> np.ndarray:
        """(B,) int32 device-table slots; absent/spilled -> ``capacity``."""
        return self._slot_of[np.asarray(nodes)]

    def slot_table(self) -> np.ndarray:
        """(node_cap + 1,) node->slot map (sentinel = capacity). Live view."""
        return self._slot_of

    def slot_table_dev(self) -> torch.Tensor:
        """Device copy of the node->slot map, re-uploaded only after writes."""
        if self._slot_dirty or self._slot_dev is None:
            self._slot_dev = torch.tensor(self._slot_of, device=self.device)
            self._slot_dirty = False
        return self._slot_dev

    def table(self) -> torch.Tensor:
        """(capacity + 1, dim) device table; row ``capacity`` is the zero
        sentinel. Live: later writes land in this very tensor."""
        return self._table

    def node_of_slots(self, slots: np.ndarray) -> np.ndarray:
        """(B,) device-table slots -> node ids (-1 for dead/sentinel rows)."""
        slots = np.asarray(slots)
        out = np.full(slots.shape, -1, np.int64)
        live = (slots >= 0) & (slots < self.capacity)
        out[live] = self._node_at[slots[live]]
        return out

    def row_valid(self) -> np.ndarray:
        """(capacity + 1,) bool: table rows holding a live embedding right
        now (the zero-sentinel row is always False)."""
        valid = np.zeros(self._rows, bool)
        valid[: self.capacity] = self._node_at >= 0
        return valid

    def candidate_bias(self) -> np.ndarray:
        """(capacity + 1,) float32 additive retrieval mask: 0 on live rows,
        -inf on dead and sentinel rows — the top-k kernel adds it to scores
        so dead rows can never enter a result."""
        return np.where(self.row_valid(), 0.0, -np.inf).astype(np.float32)

    # ------------------------------------------------------------- writes

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _evict_lru(self, staged) -> int:
        faults.check("spill_io")
        used = np.where(self._node_at >= 0, self._last_used, np.iinfo(np.int64).max)
        slot = int(np.argmin(used))
        node = int(self._node_at[slot])
        # the victim's value may still be staged (written earlier in the same
        # batch, device scatter pending) — spill the staged copy, not the row
        vec = staged.get(slot)
        if vec is None:
            # a copy: on the CPU .numpy() would alias the live table row
            vec = self._table[slot].cpu().numpy().copy()
        self._spill[node] = (
            np.asarray(vec),
            int(self._version_at[slot]),
            int(self._core_at[slot]),
        )
        self._slot_of[node] = self.capacity
        self._node_at[slot] = -1
        self.evictions += 1
        metrics().counter("store_evictions_total").inc()
        self._slot_dirty = True
        return slot

    def ensure_nodes(self, node_cap: int) -> None:
        """Grow the node->slot map to cover ids below ``node_cap``.

        Growth is geometric so the map's shape changes O(log n) times, not
        once per new id.
        """
        if node_cap <= self.node_cap:
            return
        node_cap = max(int(node_cap), self.node_cap * 3 // 2)
        extra = np.full(node_cap - self.node_cap, self.capacity, np.int32)
        self._slot_of = np.concatenate([self._slot_of[:-1], extra,
                                        self._slot_of[-1:]])
        self.node_cap = node_cap
        self._slot_dirty = True

    def put_many(
        self,
        nodes: np.ndarray,
        vecs: np.ndarray,
        cores: np.ndarray,
        version: Optional[np.ndarray] = None,
    ) -> None:
        """Insert/overwrite rows (batched device scatter; evicts LRU as needed).

        ``version`` may be a scalar or per-row array (promotion restores each
        row's original write version); defaults to the store version.
        """
        nodes = np.asarray(nodes, np.int64)
        vecs = np.asarray(vecs, np.float32)
        cores = np.broadcast_to(np.asarray(cores, np.int32), nodes.shape)
        vers = np.broadcast_to(
            np.asarray(
                self.version if version is None else version, np.int64
            ),
            nodes.shape,
        )
        if nodes.size == 0:
            return
        self.ensure_nodes(int(nodes.max()) + 1)
        staged = {}  # slot -> pending vector; also resolves same-slot reuse
        for i, node in enumerate(nodes):
            node = int(node)
            s = int(self._slot_of[node])
            if s >= self.capacity:
                s = self._free.pop() if self._free else self._evict_lru(staged)
            self._spill.pop(node, None)
            self._slot_of[node] = s
            self._node_at[s] = node
            self._version_at[s] = vers[i]
            self._core_at[s] = cores[i]
            self._last_used[s] = self._tick()
            staged[s] = vecs[i]
        # one in-place row scatter of the surviving slot->vector writes
        # (``staged`` holds each slot once)
        dev = self.device
        slots = torch.tensor(list(staged), dtype=torch.long, device=dev)
        rows = torch.tensor(np.stack(list(staged.values())), device=dev)
        self._table.index_copy_(0, slots, rows)
        self._slot_dirty = True
        metrics().counter("store_rows_written_total").inc(len(staged))

    def put(self, node: int, vec: np.ndarray, core: int) -> None:
        self.put_many(np.asarray([node]), np.asarray(vec)[None],
                      np.asarray([core]))

    # ------------------------------------------------- fused-flush support
    # The fused flush (service._flush_batch) gathers, cold-starts, and
    # scatters resolved rows back into the device table in place. The
    # store's part of the contract: hand out target slots up front
    # (reserve), commit the host metadata of the written rows afterwards
    # (adopt_fused), and keep the gather-path bookkeeping (LRU, traffic
    # counters) identical to :meth:`gather` (note_fused_gather).

    def reserve_slots(self, n: int) -> Optional[np.ndarray]:
        """Pop ``n`` free device slots for a fused write-back scatter.

        Returns None when the free list cannot cover the request — eviction
        needs a host readback of the victim rows, so the caller falls back
        to the evicting :meth:`put_many` path for that batch. Pop order
        mirrors put_many's assignment order; :meth:`release_slots` undoes
        an unused reservation exactly.
        """
        if n > len(self._free):
            return None
        return np.asarray([self._free.pop() for _ in range(n)], np.int32)

    def release_slots(self, slots: np.ndarray) -> None:
        """Return reserved-but-unwritten slots (reverse pop order restores
        the free list bit-exactly, as if the reservation never happened)."""
        self._free.extend(int(s) for s in reversed(np.asarray(slots).tolist()))

    def adopt_fused(self, nodes: np.ndarray, slots: np.ndarray,
                    cores: np.ndarray) -> None:
        """Commit the host metadata for the fused flush's write-back rows.

        ``nodes[i]`` was written into reserved slot ``slots[i]`` of the
        device table in place; here the slot map, reverse map, LRU stamp,
        and the version/core staleness tags catch up — rows are tagged at
        the current store version exactly as a :meth:`put_many` write would
        be.
        """
        nodes = np.asarray(nodes, np.int64)
        slots = np.asarray(slots, np.int32)
        cores = np.broadcast_to(np.asarray(cores, np.int32), nodes.shape)
        for node, s, c in zip(nodes.tolist(), slots.tolist(), cores.tolist()):
            self._spill.pop(node, None)
            self._slot_of[node] = s
            self._node_at[s] = node
            self._version_at[s] = self.version
            self._core_at[s] = c
            self._last_used[s] = self._tick()
        if len(nodes):
            self._slot_dirty = True
            metrics().counter("store_rows_written_total").inc(len(nodes))

    def note_fused_gather(self, slots: np.ndarray, resident: np.ndarray,
                          spill_served: int = 0) -> None:
        """Bookkeeping for a device-side gather the fused flush performed:
        LRU ticks for the resident hits plus the exact traffic accounting
        :meth:`gather` would have recorded for the same request."""
        slots = np.asarray(slots)
        resident = np.asarray(resident, bool)
        # the row movement itself happened inside the fused device program;
        # this span marks the gather in the trace (fused=1) so pipeline-
        # coverage checks keep seeing the stage, with the same attributes
        # the host-side gather() recorded
        with obs.span("store.gather", batch=len(slots), fused=1) as sp:
            if resident.any():
                self._last_used[slots[resident]] = self._tick()
            reg = metrics()
            reg.counter("store_gather_requests_total").inc(len(slots))
            reg.counter("store_gather_found_total").inc(
                int(resident.sum()) + int(spill_served)
            )
            if spill_served:
                reg.counter("store_spill_serves_total").inc(int(spill_served))
            sp.set(found=int(resident.sum()) + int(spill_served))

    def peek_spill(self, node: int) -> Optional[np.ndarray]:
        """Spill-tier vector for ``node`` (None if not spilled); no side
        effects — the fused flush overlays these rows host-side."""
        hit = self._spill.get(int(node))
        return None if hit is None else hit[0]

    # ------------------------------------------------------------- lookups

    def promote(self, nodes: np.ndarray) -> int:
        """Bring spilled rows among ``nodes`` back into the device table.

        Requested rows that are already resident are LRU-pinned first, so a
        promotion's eviction never lands on another node of the same request.
        """
        nodes_u = np.unique(np.clip(np.asarray(nodes, np.int64), 0, self.node_cap))
        slots = self._slot_of[nodes_u]
        res = slots < self.capacity
        if res.any():
            self._last_used[slots[res]] = self._tick()
        hits = [int(n) for n in nodes_u if int(n) in self._spill]
        if not hits:
            return 0
        faults.check("spill_io")
        # one batched put, preserving each row's original version/core
        rows = [self._spill[n] for n in hits]
        with obs.span("store.promote", rows=len(hits)):
            self.put_many(
                np.asarray(hits),
                np.stack([r[0] for r in rows]),
                np.asarray([r[2] for r in rows]),
                version=np.asarray([r[1] for r in rows]),
            )
        metrics().counter("store_promotions_total").inc(len(hits))
        return len(hits)

    def peek_many(
        self, nodes: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Side-effect-free batched lookup across both tiers.

        Returns ``(vecs (B, dim) float32, found (B,) bool, versions (B,)
        int64, cores (B,) int32)`` on the host. Unlike :meth:`gather`,
        nothing is promoted, no LRU clock ticks, and no traffic counters
        move — the retraining subsystem reads previous vectors (warm start,
        Procrustes anchors) and the degraded flush answers from stale rows
        through this without disturbing serving state.
        """
        nodes = np.asarray(nodes, np.int64)
        vecs = np.zeros((len(nodes), self.dim), np.float32)
        vers = np.zeros(len(nodes), np.int64)
        cores = np.zeros(len(nodes), np.int32)
        in_map = (nodes >= 0) & (nodes <= self.node_cap)
        slots = np.full(len(nodes), self.capacity, np.int32)
        slots[in_map] = self._slot_of[nodes[in_map]]
        found = slots < self.capacity
        if found.any():
            # one device gather and one host copy for the batch
            rows = torch.tensor(slots[found], dtype=torch.long,
                                device=self.device)
            vecs[found] = self._table[rows].cpu().numpy()
            vers[found] = self._version_at[slots[found]]
            cores[found] = self._core_at[slots[found]]
        if self._spill and not found.all():
            for i in np.where(~found)[0]:
                hit = self._spill.get(int(nodes[i]))
                if hit is not None:
                    vecs[i], vers[i], cores[i] = hit[0], hit[1], hit[2]
                    found[i] = True
        return vecs, found, vers, cores

    def gather(
        self, nodes: np.ndarray
    ) -> Tuple[Union[torch.Tensor, np.ndarray], np.ndarray]:
        """(B,) node ids -> ((B, dim) vectors, (B,) found mask).

        Spilled rows are promoted first; misses gather the zero sentinel.
        Touches LRU timestamps for resident hits.

        Rows the promotion pass could not keep resident — when the request's
        spill hits outnumber the evictable slots, a row promoted earlier in
        this same call can be bounced straight back to spill (its slot-map
        entry left at the sentinel) — are served from the host spill tier
        instead of being misreported as misses: ``found`` is true for every
        node the store holds in either tier.
        """
        nodes = np.asarray(nodes, np.int64)
        with obs.span("store.gather", batch=len(nodes)) as sp:
            nodes_c = np.clip(nodes, 0, self.node_cap)
            self.promote(nodes_c)  # pins resident hits, restores spills
            slots = self._slot_of[nodes_c]
            found = slots < self.capacity
            if found.any():
                self._last_used[slots[found]] = self._tick()
            vecs = self._table[torch.tensor(slots, dtype=torch.long,
                                            device=self.device)]
            spill_served = 0
            if self._spill and not found.all():
                over = {}
                for i in np.where(~found)[0]:
                    hit = self._spill.get(int(nodes_c[i]))
                    if hit is not None:
                        over[int(i)] = hit[0]
                        found[i] = True
                if over:  # spill-tier overlay (host copy; rows stay spilled)
                    out = vecs.cpu().numpy()
                    for i, vec in over.items():
                        out[i] = vec
                    vecs = out
                    spill_served = len(over)
            reg = metrics()
            reg.counter("store_gather_requests_total").inc(len(nodes))
            reg.counter("store_gather_found_total").inc(int(found.sum()))
            if spill_served:
                reg.counter("store_spill_serves_total").inc(spill_served)
            sp.set(found=int(found.sum()), spill=spill_served)
        return vecs, found

    # ------------------------------------------------------------ staleness

    def bump_version(self) -> int:
        self.version += 1
        return self.version

    def staleness(self, core_now: np.ndarray) -> float:
        """Fraction of resident rows whose core number drifted since write."""
        core_now = np.asarray(core_now)
        live = self._node_at >= 0
        if not live.any():
            return 0.0
        nodes = self._node_at[live]
        in_range = nodes < len(core_now)
        now = np.where(in_range, core_now[np.minimum(nodes, len(core_now) - 1)], 0)
        return float(np.mean(now != self._core_at[live]))

    def version_counts(self) -> Dict[int, int]:
        """Resident rows per store version (spilled rows not counted)."""
        live = self._node_at >= 0
        vers, counts = np.unique(self._version_at[live], return_counts=True)
        return {int(v): int(c) for v, c in zip(vers, counts)}

    # ------------------------------------------------------------- snapshots

    def state_dict(self) -> Dict[str, np.ndarray]:
        """Both tiers plus all host metadata as host arrays.

        The same numpy layout as the JAX package's: the device table is
        pulled down whole, the spill dict is flattened to parallel arrays,
        and the free-slot stack keeps its order so slot assignment after a
        restore is bit-identical.
        """
        table = self._table[: self.capacity + 1].cpu().numpy().copy()
        spill_nodes = np.asarray(sorted(self._spill), np.int64)
        if len(spill_nodes):
            spill_vecs = np.stack(
                [self._spill[int(n)][0] for n in spill_nodes]
            ).astype(np.float32)
            spill_vers = np.asarray(
                [self._spill[int(n)][1] for n in spill_nodes], np.int64
            )
            spill_cores = np.asarray(
                [self._spill[int(n)][2] for n in spill_nodes], np.int32
            )
        else:
            spill_vecs = np.zeros((0, self.dim), np.float32)
            spill_vers = np.zeros(0, np.int64)
            spill_cores = np.zeros(0, np.int32)
        return {
            "table": table,
            "slot_of": self._slot_of.copy(),
            "node_at": self._node_at.copy(),
            "version_at": self._version_at.copy(),
            "core_at": self._core_at.copy(),
            "last_used": self._last_used.copy(),
            "spill_nodes": spill_nodes,
            "spill_vecs": spill_vecs,
            "spill_vers": spill_vers,
            "spill_cores": spill_cores,
            "free": np.asarray(self._free, np.int64),
            "capacity": np.int64(self.capacity),
            "dim": np.int64(self.dim),
            "node_cap": np.int64(self.node_cap),
            "version": np.int64(self.version),
            "evictions": np.int64(self.evictions),
            "clock": np.int64(self._clock),
        }

    def load_state_dict(self, state) -> None:
        """Overwrite this store with ``state`` (either package's layout)."""
        self.capacity = int(state["capacity"])
        self.dim = int(state["dim"])
        self.node_cap = int(state["node_cap"])
        self._rows = self.capacity + 1
        self._table = torch.tensor(
            np.asarray(state["table"], np.float32)[: self._rows],
            device=self.device,
        )
        self._slot_of = np.array(state["slot_of"], np.int32)
        self._node_at = np.array(state["node_at"], np.int64)
        self._version_at = np.array(state["version_at"], np.int64)
        self._core_at = np.array(state["core_at"], np.int32)
        self._last_used = np.array(state["last_used"], np.int64)
        self._spill = {
            int(n): (np.array(v, np.float32), int(ver), int(c))
            for n, v, ver, c in zip(
                np.asarray(state["spill_nodes"], np.int64),
                np.asarray(state["spill_vecs"], np.float32),
                np.asarray(state["spill_vers"], np.int64),
                np.asarray(state["spill_cores"], np.int32),
            )
        }
        self._free = [int(s) for s in np.asarray(state["free"], np.int64)]
        self.version = int(state["version"])
        self.evictions = int(state["evictions"])
        self._clock = int(state["clock"])
        self._slot_dev = None
        self._slot_dirty = True

    @classmethod
    def from_state(cls, state, *, device="cuda") -> "EmbeddingStore":
        store = cls(
            int(state["capacity"]), int(state["dim"]),
            int(state["node_cap"]), device=device,
        )
        store.load_state_dict(state)
        return store
