"""Link-prediction edge splits (paper §3.1.2).

A copy of the JAX package's ``repro.graph.splits`` (numpy only, so the same
seed gives byte-identical splits). Remove a fraction of edges (10/30/50%) as
positive test samples, sample the same number of non-edges as negatives,
train embeddings on the residual graph. Removal avoids creating isolated
nodes (the paper only embeds nodes with non-empty context: 0-core == 1-core
assumption, §2).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .csr import Graph

__all__ = ["LinkSplit", "make_link_split"]


@dataclasses.dataclass
class LinkSplit:
    train_graph: Graph
    pos_edges: np.ndarray  # (P, 2) removed (held-out) edges
    neg_edges: np.ndarray  # (P, 2) sampled non-edges
    frac_removed: float

    def eval_arrays(self):
        """(pairs, labels) for the downstream classifier."""
        pairs = np.concatenate([self.pos_edges, self.neg_edges], axis=0)
        labels = np.concatenate(
            [np.ones(len(self.pos_edges)), np.zeros(len(self.neg_edges))]
        ).astype(np.float32)
        return pairs, labels


def make_link_split(g: Graph, frac: float, seed: int = 0) -> LinkSplit:
    rng = np.random.default_rng(seed)
    edges = g.edge_list()
    n_remove = int(round(frac * len(edges)))
    order = rng.permutation(len(edges))
    deg = g.degrees().astype(np.int64)
    removed = []
    for idx in order:
        if len(removed) >= n_remove:
            break
        u, v = edges[idx]
        if deg[u] > 1 and deg[v] > 1:
            removed.append(idx)
            deg[u] -= 1
            deg[v] -= 1
    removed = np.array(removed, dtype=np.int64)
    keep_mask = np.ones(len(edges), dtype=bool)
    keep_mask[removed] = False
    train_graph = Graph.from_edges(g.n_nodes, edges[keep_mask])
    pos = edges[~keep_mask]

    # negatives: distinct non-edges of the *original* graph
    neg = []
    seen = set()
    while len(neg) < len(pos):
        u = int(rng.integers(g.n_nodes))
        v = int(rng.integers(g.n_nodes))
        if u == v:
            continue
        key = (min(u, v), max(u, v))
        if key in seen:
            continue
        seen.add(key)
        if not g.has_edge(u, v):
            neg.append(key)
    neg = np.array(neg, dtype=np.int32).reshape(-1, 2)
    return LinkSplit(
        train_graph=train_graph,
        pos_edges=pos.astype(np.int32),
        neg_edges=neg,
        frac_removed=frac,
    )
