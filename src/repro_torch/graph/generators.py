"""Deterministic synthetic graph generators (numpy, no networkx dependency).

The container has no network access, so the paper's three datasets (Cora,
SNAP-Facebook, SNAP-Github) are replaced by synthetic graphs calibrated to the
same node/edge counts and a similarly bottom-heavy core profile (preferential
attachment yields the power-law degree + core distributions the paper's §3.1.1
plots show for Github/Facebook).
"""
from __future__ import annotations

import numpy as np

from .csr import Graph

__all__ = [
    "barabasi_albert",
    "barabasi_albert_varying",
    "erdos_renyi",
    "powerlaw_cluster",
    "stochastic_block_model",
]


def barabasi_albert(n: int, m: int, seed: int = 0) -> Graph:
    """Barabási–Albert preferential attachment (repeated-nodes implementation)."""
    if n <= m:
        raise ValueError("n must exceed m")
    rng = np.random.default_rng(seed)
    # Start from a star on m+1 nodes so every node has degree >= 1.
    edges = [(i, m) for i in range(m)]
    repeated = [x for e in edges for x in e]
    for v in range(m + 1, n):
        targets = set()
        while len(targets) < m:
            targets.add(int(repeated[rng.integers(len(repeated))]))
        for t in targets:
            edges.append((v, t))
            repeated.append(v)
            repeated.append(t)
    return Graph.from_edges(n, np.array(edges, dtype=np.int64))


def barabasi_albert_varying(
    n: int, m_mean: float, alpha: float = 1.6, m_max: int = 120, seed: int = 0
) -> Graph:
    """Preferential attachment with per-node attachment count m_v ~ zipf(alpha).

    Plain BA puts EVERY node in the m-core (a single shell) — useless for
    studying degeneracy. Drawing m_v from a heavy-tailed distribution yields
    the bottom-heavy multi-shell core profile the paper's §3.1.1 plots show
    for Facebook/Github (many nodes in low cores, few in the deepest cores).
    """
    rng = np.random.default_rng(seed)
    raw = np.minimum(rng.zipf(alpha, size=n).astype(float), m_max)
    m_v = np.maximum(1, np.round(raw * (m_mean / raw.mean())).astype(int))
    m_v = np.minimum(m_v, m_max)
    m0 = int(m_v.max()) + 1
    if n <= m0:
        raise ValueError("n too small for the drawn attachment counts")
    edges = [(i, m0) for i in range(m0)]
    repeated = [x for e in edges for x in e]
    for v in range(m0 + 1, n):
        m = min(int(m_v[v]), v - 1)
        targets = set()
        while len(targets) < m:
            targets.add(int(repeated[rng.integers(len(repeated))]))
        for t in targets:
            edges.append((v, t))
            repeated.append(v)
            repeated.append(t)
    return Graph.from_edges(n, np.array(edges, dtype=np.int64))


def powerlaw_cluster(n: int, m: int, p: float, seed: int = 0) -> Graph:
    """Holme–Kim powerlaw-cluster graph: BA + triad closure with prob ``p``."""
    if n <= m:
        raise ValueError("n must exceed m")
    rng = np.random.default_rng(seed)
    edges = [(i, m) for i in range(m)]
    adj = {i: {m} for i in range(m)}
    adj[m] = set(range(m))
    repeated = [x for e in edges for x in e]

    def add_edge(u, v):
        if u == v or v in adj.setdefault(u, set()):
            return False
        adj[u].add(v)
        adj.setdefault(v, set()).add(u)
        edges.append((u, v))
        repeated.append(u)
        repeated.append(v)
        return True

    for v in range(m + 1, n):
        count = 0
        target = int(repeated[rng.integers(len(repeated))])
        while count < m:
            if add_edge(v, target):
                count += 1
                # triad closure: connect to a neighbour of the last target
                if count < m and rng.random() < p:
                    nbrs = list(adj[target] - adj.get(v, set()) - {v})
                    if nbrs:
                        w = int(nbrs[rng.integers(len(nbrs))])
                        if add_edge(v, w):
                            count += 1
            target = int(repeated[rng.integers(len(repeated))])
    return Graph.from_edges(n, np.array(edges, dtype=np.int64))


def erdos_renyi(n: int, n_edges: int, seed: int = 0) -> Graph:
    """G(n, M): exactly ``n_edges`` distinct undirected edges."""
    rng = np.random.default_rng(seed)
    seen = set()
    out = []
    while len(out) < n_edges:
        u = int(rng.integers(n))
        v = int(rng.integers(n))
        if u == v:
            continue
        key = (min(u, v), max(u, v))
        if key in seen:
            continue
        seen.add(key)
        out.append(key)
    return Graph.from_edges(n, np.array(out, dtype=np.int64))


def stochastic_block_model(
    sizes: list[int], p_in: float, p_out: float, seed: int = 0
) -> Graph:
    """SBM with dense diagonal blocks — used to build *disconnected-core* cases
    (paper §4 discusses k₀-cores that split into distant clusters)."""
    rng = np.random.default_rng(seed)
    n = sum(sizes)
    bounds = np.cumsum([0] + list(sizes))
    block = np.zeros(n, dtype=np.int64)
    for b in range(len(sizes)):
        block[bounds[b] : bounds[b + 1]] = b
    edges = []
    for u in range(n):
        for v in range(u + 1, n):
            p = p_in if block[u] == block[v] else p_out
            if rng.random() < p:
                edges.append((u, v))
    return Graph.from_edges(n, np.array(edges, dtype=np.int64))
