"""Graph containers used across the port.

Two representations, as in ``repro.graph.csr``:

* ``Graph`` — host-side CSR (numpy), a copy of the JAX package's. Used for
  dataset preparation, k-core peeling, and edge splits. Undirected graphs
  store both arc directions.
* ``EllGraph`` — padded ELL neighbour table as torch tensors on a given
  device. Padding slots point at row ``n_nodes`` (a sentinel row) and are
  masked.

The ELL width is the max degree by default; callers can cap it (neighbours
are then subsampled deterministically with numpy's ``default_rng``, so the
table is byte-identical to the JAX package's for the same seed).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["Graph", "EllGraph", "edges_to_csr"]


def edges_to_csr(n_nodes: int, edges: np.ndarray, undirected: bool = True):
    """Build CSR (indptr, indices) from an (E, 2) int array of edges.

    Self-loops and duplicate edges are removed. Neighbour lists are sorted,
    which downstream code relies on (membership tests via searchsorted).
    """
    edges = np.asarray(edges, dtype=np.int64)
    if edges.size == 0:
        edges = edges.reshape(0, 2)
    if undirected:
        edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
    # drop self loops
    edges = edges[edges[:, 0] != edges[:, 1]]
    # dedupe
    key = edges[:, 0] * n_nodes + edges[:, 1]
    order = np.argsort(key, kind="stable")
    key = key[order]
    keep = np.ones(len(key), dtype=bool)
    keep[1:] = key[1:] != key[:-1]
    edges = edges[order][keep]
    counts = np.bincount(edges[:, 0], minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = edges[:, 1].astype(np.int32)
    return indptr, indices


@dataclasses.dataclass
class Graph:
    """Host-side CSR graph (undirected unless stated otherwise)."""

    n_nodes: int
    indptr: np.ndarray  # (n_nodes + 1,) int64
    indices: np.ndarray  # (n_arcs,) int32, sorted within each row

    @staticmethod
    def from_edges(n_nodes: int, edges: np.ndarray, undirected: bool = True) -> "Graph":
        indptr, indices = edges_to_csr(n_nodes, edges, undirected=undirected)
        return Graph(n_nodes=n_nodes, indptr=indptr, indices=indices)

    @property
    def n_arcs(self) -> int:
        return int(self.indices.shape[0])

    @property
    def n_edges(self) -> int:
        """Number of undirected edges (arcs / 2)."""
        return self.n_arcs // 2

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    def neighbours(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def has_edge(self, u: int, v: int) -> bool:
        row = self.neighbours(u)
        i = np.searchsorted(row, v)
        return bool(i < len(row) and row[i] == v)

    def edge_list(self) -> np.ndarray:
        """(E, 2) array with u < v, each undirected edge once."""
        src = np.repeat(np.arange(self.n_nodes), np.diff(self.indptr))
        dst = self.indices
        keep = src < dst
        return np.stack([src[keep], dst[keep]], axis=1).astype(np.int32)

    def subgraph(self, node_mask: np.ndarray) -> "Graph":
        """Induced subgraph on ``node_mask`` (keeps original node ids)."""
        node_mask = np.asarray(node_mask, dtype=bool)
        src = np.repeat(np.arange(self.n_nodes), np.diff(self.indptr))
        dst = self.indices
        keep = node_mask[src] & node_mask[dst]
        edges = np.stack([src[keep], dst[keep]], axis=1)
        indptr, indices = edges_to_csr(self.n_nodes, edges, undirected=False)
        return Graph(n_nodes=self.n_nodes, indptr=indptr, indices=indices)

    def largest_connected_component(self) -> np.ndarray:
        """Boolean mask of the largest connected component (BFS, host)."""
        n = self.n_nodes
        comp = np.full(n, -1, dtype=np.int64)
        cur = 0
        for seed in range(n):
            if comp[seed] >= 0:
                continue
            stack = [seed]
            comp[seed] = cur
            while stack:
                u = stack.pop()
                for w in self.neighbours(u):
                    if comp[w] < 0:
                        comp[w] = cur
                        stack.append(int(w))
            cur += 1
        sizes = np.bincount(comp, minlength=cur)
        return comp == np.argmax(sizes)

    def ell_arrays(self, max_width: Optional[int] = None, seed: int = 0):
        """Host ``(neighbours (n+1, width) int32, degrees (n+1,) int32)`` of
        the padded ELL table (sentinel row ``n``)."""
        deg = self.degrees()
        width = int(deg.max()) if deg.size else 0
        if max_width is not None:
            width = min(width, int(max_width))
        width = max(width, 1)
        n = self.n_nodes
        nbr = np.full((n + 1, width), n, dtype=np.int32)  # sentinel row n
        eff_deg = np.minimum(deg, width).astype(np.int32)
        rng = np.random.default_rng(seed)
        for v in range(n):
            row = self.indices[self.indptr[v] : self.indptr[v + 1]]
            if len(row) > width:
                row = rng.choice(row, size=width, replace=False)
                row = np.sort(row)
            nbr[v, : len(row)] = row
        return nbr, np.concatenate([eff_deg, np.zeros(1, np.int32)])

    def to_ell(self, max_width: Optional[int] = None, seed: int = 0, *,
               device="cuda") -> "EllGraph":
        nbr, deg = self.ell_arrays(max_width, seed)
        dev = resolve_device(device)
        return EllGraph(
            n_nodes=self.n_nodes,
            neighbours=torch.tensor(nbr, device=dev),
            degrees=torch.tensor(deg, device=dev),
        )


@dataclasses.dataclass
class EllGraph:
    """Padded neighbour table on a torch device.

    ``neighbours``: (n_nodes + 1, width) int32; row ``n_nodes`` is a sentinel
    whose entries all point at itself. Padding entries equal ``n_nodes``.
    ``degrees``: (n_nodes + 1,) int32 effective (possibly capped) degree.
    """

    n_nodes: int
    neighbours: torch.Tensor
    degrees: torch.Tensor

    @property
    def width(self) -> int:
        return int(self.neighbours.shape[1])

    @property
    def device(self) -> torch.device:
        return self.neighbours.device

    def mask(self) -> torch.Tensor:
        """(n_nodes + 1, width) bool validity mask."""
        return self.neighbours != self.n_nodes
