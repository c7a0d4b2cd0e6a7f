"""CoreWalk — core-adaptive random-walk budgets (paper §2.1, Eq. 13).

A copy of the JAX package's ``repro.core.corewalk`` (numpy only).

``n_v = max(floor(n * k_v / k_degeneracy), 1)`` walks are rooted at node v.
Because core populations are bottom-heavy, the total walk count (and hence
the SGNS training corpus) shrinks drastically versus the fixed-n DeepWalk
plan, which is exactly the paper's speedup mechanism.

The planner emits a flat ``roots`` array (one entry per walk). Shapes are
static per graph: Eq. 13 changes *how many* slots exist, not the per-walk
program, so the walk engine runs the same steps for every plan. ``pad_to``
rounds the slot count up (padding walks root at node 0 and are masked out of
the corpus statistics) so distributed shards stay equal-sized.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["WalkPlan", "deepwalk_plan", "corewalk_plan"]


@dataclasses.dataclass
class WalkPlan:
    roots: np.ndarray  # (W,) int32 walk roots (padding slots included)
    n_real: int  # number of non-padding walks
    per_node: np.ndarray  # (n_nodes,) int32 walks rooted at each node

    @property
    def n_slots(self) -> int:
        return int(self.roots.shape[0])

    def reduction_vs(self, other: "WalkPlan") -> float:
        """Corpus-size ratio vs another plan (hardware-independent speedup)."""
        return other.n_real / max(self.n_real, 1)


def _plan_from_counts(per_node: np.ndarray, pad_to: int | None) -> WalkPlan:
    roots = np.repeat(np.arange(len(per_node), dtype=np.int32), per_node)
    n_real = len(roots)
    if pad_to is not None and n_real % pad_to:
        pad = pad_to - n_real % pad_to
        roots = np.concatenate([roots, np.zeros(pad, dtype=np.int32)])
    return WalkPlan(roots=roots, n_real=n_real, per_node=per_node.astype(np.int32))


def deepwalk_plan(n_nodes: int, n_walks: int, pad_to: int | None = None) -> WalkPlan:
    """Fixed budget: n walks per node (DeepWalk / Node2Vec baseline)."""
    return _plan_from_counts(np.full(n_nodes, n_walks, dtype=np.int64), pad_to)


def corewalk_plan(
    core: np.ndarray, n_walks: int, pad_to: int | None = None
) -> WalkPlan:
    """Eq. 13 budget: n_v = max(floor(n * k_v / degeneracy), 1)."""
    core = np.asarray(core, dtype=np.int64)
    kdeg = max(int(core.max()), 1)
    per_node = np.maximum((n_walks * core) // kdeg, 1)
    return _plan_from_counts(per_node, pad_to)
