"""Dataset presets mirroring the paper's three graphs (§3.1.1) plus loaders.

Sizes match the paper: Cora 2,708 / 5,429; Facebook 4,039 / 88,234;
Github 37,700 / 289,003. Graphs are synthetic (see generators.py) but
calibrated to the same scale and a bottom-heavy core profile. Every preset
returns the largest connected component restricted graph, matching the
paper's "we always consider the largest connected subgraph".
"""
from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np

from .csr import Graph
from .generators import (
    barabasi_albert_varying,
    erdos_renyi,
)

__all__ = ["load", "DATASETS", "load_edge_list"]


def _lcc(g: Graph) -> Graph:
    mask = g.largest_connected_component()
    if mask.all():
        return g
    # compact node ids
    new_id = np.cumsum(mask) - 1
    edges = g.edge_list()
    keep = mask[edges[:, 0]] & mask[edges[:, 1]]
    edges = new_id[edges[keep]]
    return Graph.from_edges(int(mask.sum()), edges)


def _cora_like(seed: int = 0) -> Graph:
    # Cora is sparse (avg deg ~4) and rather irregular: ER at the same density.
    return _lcc(erdos_renyi(2708, 5429, seed=seed))


def _facebook_like(seed: int = 0) -> Graph:
    # SNAP ego-Facebook: 4,039 nodes / 88,234 edges, degeneracy ~115.
    # Varying-m preferential attachment -> deep bottom-heavy core hierarchy.
    return _lcc(barabasi_albert_varying(4039, 30.0, alpha=1.6, m_max=150, seed=seed))


def _github_like(seed: int = 0) -> Graph:
    # SNAP musae-github: 37,700 nodes / 289,003 edges, "regular" core profile.
    return _lcc(barabasi_albert_varying(37700, 8.6, alpha=1.8, m_max=60, seed=seed))


def _karate_like(seed: int = 0) -> Graph:
    return _lcc(barabasi_albert_varying(64, 4.0, alpha=1.6, m_max=12, seed=seed))


DATASETS: Dict[str, Callable[..., Graph]] = {
    "cora-like": _cora_like,
    "facebook-like": _facebook_like,
    "github-like": _github_like,
    "tiny": _karate_like,
}


def load(name: str, seed: int = 0) -> Graph:
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; options: {sorted(DATASETS)}")
    return DATASETS[name](seed=seed)


def load_edge_list(path: str, comments: str = "#") -> Graph:
    """Load a whitespace-separated edge list file (SNAP format)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(comments):
                continue
            u, v = line.split()[:2]
            rows.append((int(u), int(v)))
    edges = np.array(rows, dtype=np.int64)
    # compact ids
    ids = np.unique(edges)
    remap = {int(x): i for i, x in enumerate(ids)}
    edges = np.vectorize(remap.get)(edges)
    return _lcc(Graph.from_edges(len(ids), edges))
