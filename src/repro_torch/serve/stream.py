"""Streaming graph container for the online embedding service.

The torch counterpart of ``repro.serve.stream``. ``DynamicGraph`` keeps a
mutable adjacency in a host-side ELL table with degree-growth slack,
mirrored lazily onto a torch device as an ``EllGraph`` view. Mutations are
**block-oriented**: ``add_edges`` / ``remove_edges`` stage a whole edge
block, dedup it vectorized (within the block and against the current
adjacency), and apply it with one grouped scatter. Deletions use
swap-with-last slot removal (backfilling from the overflow list when one
exists), so rows stay dense and the device mirror needs at most two slot
writes per removed arc.

Layout:

* Host table ``(node_cap + 1, width)`` int32, padding/sentinel = ``node_cap``.
  ``width`` carries slack beyond the current max degree so most insertions are
  a single slot write. Rows that outgrow the width spill into a per-node
  overflow list — those arcs are invisible to the *device* view until the next
  ``compact()`` but always visible to the host-side adjacency that
  incremental k-core reads, so core maintenance stays exact.
* Device mirror: torch tensors on ``device``. Pending slot writes (inserts
  *and* removals) are applied **in place** with one row/slot scatter per
  ``ell()`` call, where the JAX package built new immutable arrays; an
  ``EllGraph`` handed out earlier therefore sees later writes, and every
  consumer asks ``ell()`` afresh before reading.

``compact()`` builds the re-packed table off to the side (host arrays +
device upload) and swaps it in, so the first ``ell()`` after the swap
returns the uploaded buffers without a full re-upload on the query path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph.csr import EllGraph, Graph
from repro_torch.obs import metrics
from repro_torch.obs import trace as obs

__all__ = ["DynamicGraph"]

_EMPTY_EDGES = np.zeros((0, 2), np.int64)


class DynamicGraph:
    def __init__(
        self,
        n_nodes: int = 0,
        edges: Optional[np.ndarray] = None,
        *,
        width: int = 8,
        slack: float = 1.5,
        node_slack: float = 1.25,
        device="cuda",
    ):
        if slack < 1.0 or node_slack < 1.0:
            raise ValueError("slack factors must be >= 1")
        self.slack = float(slack)
        self.node_slack = float(node_slack)
        self.device = resolve_device(device)
        self.n_nodes = int(n_nodes)
        self.node_cap = max(int(np.ceil(self.n_nodes * self.node_slack)), 16)
        self.width = max(int(width), 1)
        self._nbr = np.full((self.node_cap + 1, self.width), self.node_cap, np.int32)
        self._deg = np.zeros(self.node_cap + 1, np.int32)  # in-table entries
        self._overflow: Dict[int, List[int]] = {}
        self.n_edges = 0
        self.compactions = 0
        self.edges_since_compact = 0
        # device mirror state
        self._dev_nbr: Optional[torch.Tensor] = None
        self._dev_deg: Optional[torch.Tensor] = None
        self._pending: List[Tuple[int, int, int]] = []  # (row, slot, value)
        self._dirty_full = True
        if edges is not None and len(edges):
            self.add_edges(np.asarray(edges))

    # ------------------------------------------------------------- host side

    def degree(self, v: int) -> int:
        return int(self._deg[v]) + len(self._overflow.get(v, ()))

    def degrees(self) -> np.ndarray:
        deg = self._deg[: self.n_nodes].astype(np.int64).copy()
        for v, extra in self._overflow.items():
            deg[v] += len(extra)
        return deg.astype(np.int32)

    def degrees_of(self, nodes) -> np.ndarray:
        """True degrees of ``nodes`` (table + overflow), one vectorized gather.

        The block repair seeds every candidate from this instead of one
        ``degree()`` call per candidate.
        """
        nodes = np.asarray(nodes, np.int64)
        deg = self._deg[nodes].astype(np.int64)
        if self._overflow:  # cost stays O(queried), not O(node_cap)
            ov = self._overflow
            deg += np.fromiter(
                (len(ov.get(v, ())) for v in nodes.tolist()),
                np.int64, len(nodes),
            )
        return deg.astype(np.int32)

    def neighbours(self, v: int) -> np.ndarray:
        """True neighbour list (table + overflow), unsorted."""
        row = self._nbr[v, : self._deg[v]]
        extra = self._overflow.get(v)
        if extra:
            return np.concatenate([row, np.asarray(extra, np.int32)])
        return row.copy()

    def has_edge(self, u: int, v: int) -> bool:
        if u >= self.node_cap:
            return False
        if np.any(self._nbr[u, : self._deg[u]] == v):
            return True
        return v in self._overflow.get(u, ())

    def arc_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """All current arcs as (src, dst) int64 arrays (table + overflow).

        One vectorized mask-flatten of the ELL table plus the overflow lists —
        no per-node Python loop. Unsorted; both directions of every edge.
        """
        n = self.n_nodes
        slot_live = np.arange(self.width)[None, :] < self._deg[:n, None]
        rows = np.repeat(np.arange(n, dtype=np.int64), self._deg[:n])
        dsts = self._nbr[:n][slot_live].astype(np.int64)
        if self._overflow:
            ov_rows, ov_dsts = self.overflow_arc_arrays()
            rows = np.concatenate([rows, ov_rows])
            dsts = np.concatenate([dsts, ov_dsts])
        return rows, dsts

    def overflow_arc_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """Overflow arcs as (src, dst) int64 arrays (empty when none spilled).

        These arcs are invisible to the device ELL mirror until the next
        ``compact()``; device-side traversals append them as a side table.
        """
        if not self._overflow:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        rows = np.concatenate(
            [np.full(len(x), v, np.int64) for v, x in self._overflow.items()]
        )
        dsts = np.concatenate(
            [np.asarray(x, np.int64) for x in self._overflow.values()]
        )
        return rows, dsts

    def gather_rows(self, nodes) -> Tuple[np.ndarray, np.ndarray]:
        """Neighbour matrix of ``nodes``: (idx, valid) with overflow merged.

        ``idx`` is (len(nodes), W') int32 of neighbour ids (padding =
        ``node_cap``, the sentinel row), ``valid`` the matching bool mask.
        The table part is one vectorized gather; only rows that currently
        hold overflow arcs (rare between compactions) widen the matrix and
        are patched individually.
        """
        nodes = np.asarray(nodes, np.int64)
        idx = self._nbr[nodes]  # fancy indexing: already a fresh copy
        valid = np.arange(self.width)[None, :] < self._deg[nodes][:, None]
        if self._overflow:
            pos = {int(v): i for i, v in enumerate(nodes)}
            hits = [
                (pos[v], lst)
                for v, lst in self._overflow.items()
                if v in pos
            ]
            if hits:
                extra_w = max(len(lst) for _, lst in hits)
                idx = np.concatenate(
                    [idx, np.full((len(nodes), extra_w), self.node_cap,
                                  np.int32)], axis=1
                )
                valid = np.concatenate(
                    [valid, np.zeros((len(nodes), extra_w), bool)], axis=1
                )
                for i, lst in hits:
                    idx[i, self.width : self.width + len(lst)] = lst
                    valid[i, self.width : self.width + len(lst)] = True
        return idx, valid

    # ------------------------------------------------------------- staging

    def _canonical_block(self, edges) -> np.ndarray:
        """(m, 2) block -> deduped canonical (lo, hi) rows, self-loops gone."""
        edges = np.asarray(edges, np.int64).reshape(-1, 2)
        if edges.size == 0:
            return _EMPTY_EDGES
        if (edges < 0).any():
            # negative ids would wrap into the sentinel row and corrupt the
            # padding semantics every batched consumer relies on
            raise ValueError("node ids must be non-negative")
        edges = edges[edges[:, 0] != edges[:, 1]]
        if not len(edges):
            return _EMPTY_EDGES
        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        return np.unique(np.stack([lo, hi], axis=1), axis=0)

    def _present_mask(self, edges: np.ndarray) -> np.ndarray:
        """Vectorized membership of canonical ``edges`` in the current graph."""
        u = np.minimum(edges[:, 0], self.node_cap)
        present = (self._nbr[u] == edges[:, 1][:, None]).any(axis=1)
        # ids at/past node_cap are absent by definition (and the clipped row
        # gather above could only have matched padding sentinels for them)
        present &= (edges[:, 0] < self.node_cap) & (edges[:, 1] < self.node_cap)
        if self._overflow:  # rare: only rows past the table width
            for i in np.where(~present)[0]:
                ov = self._overflow.get(int(edges[i, 0]))
                if ov and int(edges[i, 1]) in ov:
                    present[i] = True
        return present

    # ------------------------------------------------------------- mutation

    def _grow_nodes(self, need: int) -> None:
        new_cap = max(int(np.ceil(need * self.node_slack)), self.node_cap * 2)
        nbr = np.full((new_cap + 1, self.width), new_cap, np.int32)
        valid = self._nbr[:-1] != self.node_cap
        nbr[: self.node_cap][valid] = self._nbr[:-1][valid]
        deg = np.zeros(new_cap + 1, np.int32)
        deg[: self.node_cap] = self._deg[:-1]
        self._nbr, self._deg, self.node_cap = nbr, deg, new_cap
        self._dirty_full = True
        self._pending.clear()

    def add_edges(self, edges) -> np.ndarray:
        """Vectorized block insert; returns the (m', 2) accepted edges.

        The block is canonicalised and deduped (within itself and against the
        existing adjacency) in one vectorized pass, then both arc directions
        are applied with a single grouped scatter: slots are assigned per row
        by intra-block rank, arcs that do not fit the table width go to the
        overflow lists. Self-loops and duplicates are dropped (not errors);
        negative ids raise.
        """
        with obs.span("graph.add_edges") as sp:
            edges = self._canonical_block(edges)
            if not len(edges):
                return _EMPTY_EDGES
            hi_max = int(edges[:, 1].max())
            if hi_max >= self.node_cap:
                self._grow_nodes(hi_max + 1)
            edges = edges[~self._present_mask(edges)]
            if not len(edges):
                return _EMPTY_EDGES
            sp.set(accepted=len(edges))
            self.n_nodes = max(self.n_nodes, hi_max + 1)

            # stage both arc directions, grouped by source row
            src = np.concatenate([edges[:, 0], edges[:, 1]])
            dst = np.concatenate([edges[:, 1], edges[:, 0]])
            order = np.argsort(src, kind="stable")
            src, dst = src[order], dst[order]
            rows, start, counts = np.unique(
                src, return_index=True, return_counts=True
            )
            rank = np.arange(len(src)) - np.repeat(start, counts)
            slot = self._deg[src] + rank
            in_table = slot < self.width
            ts, tslot, td = src[in_table], slot[in_table], dst[in_table]
            self._nbr[ts, tslot] = td  # (row, slot) unique: one scatter
            for s, d in zip(src[~in_table], dst[~in_table]):
                self._overflow.setdefault(int(s), []).append(int(d))
            self._deg[rows] = np.minimum(self._deg[rows] + counts, self.width)
            if not self._dirty_full:
                self._pending.extend(
                    zip(ts.tolist(), tslot.tolist(), td.tolist())
                )
            self.n_edges += len(edges)
            self.edges_since_compact += len(edges)
            metrics().counter("graph_edges_added_total").inc(len(edges))
        return edges

    def add_edge(self, u: int, v: int) -> bool:
        """Insert one undirected edge. Returns False for self-loops/duplicates."""
        return bool(len(self.add_edges(np.array([[u, v]], np.int64))))

    def _remove_arc(self, a: int, b: int) -> None:
        """Drop arc a->b: swap-with-last in the table, backfill from overflow."""
        d = int(self._deg[a])
        j = np.where(self._nbr[a, :d] == b)[0]
        if len(j) == 0:  # the arc lives in the overflow list
            ov = self._overflow[a]
            ov.remove(b)
            if not ov:
                del self._overflow[a]
            return
        j, last = int(j[0]), d - 1
        writes = []
        if j != last:
            self._nbr[a, j] = self._nbr[a, last]
            writes.append((a, j, int(self._nbr[a, j])))
        ov = self._overflow.get(a)
        if ov:  # backfill the freed slot; in-table degree is unchanged
            fill = ov.pop()
            if not ov:
                del self._overflow[a]
            self._nbr[a, last] = fill
            writes.append((a, last, int(fill)))
        else:
            self._nbr[a, last] = self.node_cap
            self._deg[a] = last
            writes.append((a, last, self.node_cap))
        if not self._dirty_full:
            self._pending.extend(writes)

    def remove_edges(self, edges) -> np.ndarray:
        """Vectorized block delete; returns the (m', 2) edges actually removed.

        The block is canonicalised/deduped and filtered to edges that exist
        (one vectorized membership pass); each surviving edge drops both arcs
        via swap-with-last, and the touched slots join the same pending-write
        scatter the insert path uses. Unknown edges are skipped, not errors.
        """
        with obs.span("graph.remove_edges") as sp:
            edges = self._canonical_block(edges)
            if not len(edges):
                return _EMPTY_EDGES
            edges = edges[self._present_mask(edges)]
            sp.set(removed=len(edges))
            for u, v in edges:
                self._remove_arc(int(u), int(v))
                self._remove_arc(int(v), int(u))
            self.n_edges -= len(edges)
            # churn counts toward compaction
            self.edges_since_compact += len(edges)
            metrics().counter("graph_edges_removed_total").inc(len(edges))
        return edges

    def remove_edge(self, u: int, v: int) -> bool:
        """Delete one undirected edge. Returns False if it was not present."""
        return bool(len(self.remove_edges(np.array([[u, v]], np.int64))))

    @property
    def overflow_arcs(self) -> int:
        return sum(len(x) for x in self._overflow.values())

    @property
    def needs_compact(self) -> bool:
        return bool(self._overflow)

    def compact(self, min_width: int = 4) -> None:
        """Pause-free re-pack at a fresh slacked width (merges overflow).

        Double-buffered: the new table is built off to the side (vectorized
        gather of every arc -> lexsort -> one scatter), its device upload is
        dispatched, and only then is the live state swapped. ``ell()`` views
        handed out earlier keep the old buffers; the next ``ell()`` call
        returns the new ones without a full re-upload on the query path.
        """
        with obs.span(
            "graph.compact", overflow_arcs=self.overflow_arcs
        ) as sp:
            deg = self.degrees()
            max_deg = int(deg.max()) if deg.size else 0
            width = max(int(np.ceil(max_deg * self.slack)), min_width, 1)
            nbr = np.full(
                (self.node_cap + 1, width), self.node_cap, np.int32
            )
            n = self.n_nodes
            # gather all arcs: in-table rows (row-major mask flatten) +
            # overflow
            rows, dsts = self.arc_arrays()
            order = np.lexsort((dsts, rows))  # sorted rows, like Graph CSR
            rows, dsts = rows[order], dsts[order]
            uniq, start, counts = np.unique(
                rows, return_index=True, return_counts=True
            )
            slot = np.arange(len(rows)) - np.repeat(start, counts)
            nbr[rows, slot] = dsts
            new_deg = np.zeros(self.node_cap + 1, np.int32)
            new_deg[:n] = deg
            # dispatch the device upload of the side buffer *before* the swap
            dev_nbr, dev_deg = self._upload_mirror(nbr, new_deg)
            self._nbr, self._deg, self.width = nbr, new_deg, width
            self._dev_nbr, self._dev_deg = dev_nbr, dev_deg
            self._overflow.clear()
            self._pending.clear()
            self._dirty_full = False
            self.compactions += 1
            self.edges_since_compact = 0
            sp.set(width=width)
            metrics().counter("graph_compactions_total").inc()

    # --------------------------------------------------------- device mirror

    def _upload_mirror(
        self, nbr: np.ndarray, deg: np.ndarray
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Copy a full host mirror onto the device."""
        return (torch.tensor(nbr, device=self.device),
                torch.tensor(deg, device=self.device))

    # ------------------------------------------------------------ snapshots

    def snapshot(self) -> Graph:
        """Immutable host CSR of the current graph (sorted rows, both arcs).

        One vectorized arc gather — the oracle/re-peel paths call this, so a
        per-node Python loop here would dominate their cost.
        """
        rows, dsts = self.arc_arrays()
        edges = np.stack([rows, dsts], axis=1)
        return Graph.from_edges(self.n_nodes, edges, undirected=False)

    def state_dict(self) -> Dict[str, np.ndarray]:
        """Full mutable state as host arrays (for snapshots / rollback).

        Overflow lists are flattened to ``(keys, counts, values)`` so the
        whole dict round-trips through ``np.savez`` losslessly; the device
        mirror is deliberately excluded (it is derived state and rebuilt
        lazily on the first ``ell()`` after :meth:`from_state`).
        """
        ov_keys = np.asarray(sorted(self._overflow), np.int64)
        ov_counts = np.asarray(
            [len(self._overflow[int(k)]) for k in ov_keys], np.int64
        )
        ov_vals = (
            np.concatenate(
                [np.asarray(self._overflow[int(k)], np.int64) for k in ov_keys]
            )
            if len(ov_keys) else np.zeros(0, np.int64)
        )
        return {
            "nbr": self._nbr.copy(),
            "deg": self._deg.copy(),
            "ov_keys": ov_keys,
            "ov_counts": ov_counts,
            "ov_vals": ov_vals,
            "n_nodes": np.int64(self.n_nodes),
            "node_cap": np.int64(self.node_cap),
            "width": np.int64(self.width),
            "n_edges": np.int64(self.n_edges),
            "compactions": np.int64(self.compactions),
            "edges_since_compact": np.int64(self.edges_since_compact),
            "slack": np.float64(self.slack),
            "node_slack": np.float64(self.node_slack),
        }

    @classmethod
    def from_state(cls, state, *, device="cuda") -> "DynamicGraph":
        """Rebuild a graph bit-identical to the one that produced ``state``
        (the layout of either package's ``state_dict``), mirrored on
        ``device``."""
        g = cls(
            0,
            width=int(state["width"]),
            slack=float(state["slack"]),
            node_slack=float(state["node_slack"]),
            device=device,
        )
        g.n_nodes = int(state["n_nodes"])
        g.node_cap = int(state["node_cap"])
        g._nbr = np.array(state["nbr"], np.int32)
        g._deg = np.array(state["deg"], np.int32)
        g._overflow = {}
        off = 0
        vals = np.asarray(state["ov_vals"], np.int64)
        for k, c in zip(np.asarray(state["ov_keys"], np.int64),
                        np.asarray(state["ov_counts"], np.int64)):
            g._overflow[int(k)] = [int(x) for x in vals[off : off + int(c)]]
            off += int(c)
        g.n_edges = int(state["n_edges"])
        g.compactions = int(state["compactions"])
        g.edges_since_compact = int(state["edges_since_compact"])
        g._dev_nbr = g._dev_deg = None
        g._pending = []
        g._dirty_full = True
        return g

    def ell(self) -> EllGraph:
        """Device ELL view (overflow arcs excluded until the next compact).

        Pending slot writes since the last call are applied in place as one
        batched row/slot scatter; node growth triggers a full re-upload,
        compaction never does (the compactor pre-uploads its buffer).
        """
        if self._dirty_full or self._dev_nbr is None:
            self._dev_nbr, self._dev_deg = self._upload_mirror(
                self._nbr, self._deg
            )
            self._dirty_full = False
            self._pending.clear()
        elif self._pending:
            upd = np.asarray(self._pending, np.int64)
            # a slot can be written more than once between ell() calls
            # (removal swap then re-insert); a scatter with duplicate
            # indices is order-unspecified, so keep only the last write per
            # (row, slot)
            key = upd[:, 0] * (self.width + 1) + upd[:, 1]
            _, last_idx = np.unique(key[::-1], return_index=True)
            upd = upd[::-1][last_idx]
            rows = torch.tensor(upd[:, 0], device=self.device)
            slots = torch.tensor(upd[:, 1], device=self.device)
            vals = torch.tensor(upd[:, 2].astype(np.int32), device=self.device)
            self._dev_nbr[rows, slots] = vals
            # degrees: only the touched rows, each with its final degree
            self._dev_deg[rows] = torch.tensor(
                self._deg[upd[:, 0]], device=self.device
            )
            self._pending.clear()
        return EllGraph(
            n_nodes=self.node_cap, neighbours=self._dev_nbr, degrees=self._dev_deg
        )
