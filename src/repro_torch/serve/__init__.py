"""Online embedding service, ported to PyTorch: block-oriented streaming
ingestion (inserts and deletions) into a ``DynamicGraph`` mirrored on the
device, exact incremental k-core maintenance (``IncrementalCore``: region
growing, a fused h-index descent through the CUDA kernel, measured repair
policy), the versioned ``EmbeddingStore`` with host spill, and the
``EmbeddingService`` front end (§2.2 cold starts, link scores, streaming
top-k). ``serve.retrain`` closes the drift loop (snapshot the drifted
k0-core, CoreWalk + SGNS warm-started from the previous vectors on the
card's SGNS kernels, Procrustes alignment, chunked hot swap);
``serve.recovery`` makes the stack crash-safe (a checksummed write-ahead edge
log and atomic snapshots in the JAX package's formats, replay that
reproduces an uninterrupted run bit for bit); ``serve.faults`` is the fault
injection harness that proves it. ``ShardPlan`` (``serve.shard``)
row-shards the node-indexed device state over several devices, bit-identical
to one. ``from_jax_state`` rebuilds the JAX package's serving state here, so
both packages serve the same graph, table and cores."""
from __future__ import annotations

import numpy as np

from .faults import FaultPlan, InjectedCrash, InjectedFault
from .kcore_inc import IncrementalCore, RepairPolicy
from .recovery import RecoveryManager, SnapshotStore, WriteAheadLog
from .retrain import (
    EmbeddingAligner,
    RetrainConfig,
    Retrainer,
    RetrainPlanner,
    RetrainReport,
    VersionRollout,
    procrustes_rotation,
)
from .service import EmbeddingService, ServiceStats
from .shard import ShardPlan
from .store import EmbeddingStore
from .stream import DynamicGraph

__all__ = [
    "DynamicGraph",
    "IncrementalCore",
    "RepairPolicy",
    "EmbeddingStore",
    "EmbeddingService",
    "ServiceStats",
    "RetrainConfig",
    "RetrainPlanner",
    "Retrainer",
    "RetrainReport",
    "EmbeddingAligner",
    "VersionRollout",
    "procrustes_rotation",
    "FaultPlan",
    "InjectedFault",
    "InjectedCrash",
    "RecoveryManager",
    "SnapshotStore",
    "WriteAheadLog",
    "ShardPlan",
    "from_jax_state",
]


def from_jax_state(graph_state, store_state, core, *, device="cuda", **inc_kw):
    """Build the port's ``(DynamicGraph, EmbeddingStore, IncrementalCore)``
    on ``device`` from the JAX package's serving state.

    ``graph_state`` and ``store_state`` are the numpy dicts of
    ``repro.serve.DynamicGraph.state_dict()`` and
    ``repro.serve.EmbeddingStore.state_dict()``; ``core`` is
    ``IncrementalCore.core`` (also the drift baseline here). ``inc_kw``
    goes to ``IncrementalCore``.
    """
    graph = DynamicGraph.from_state(graph_state, device=device)
    store = EmbeddingStore.from_state(store_state, device=device)
    cores = IncrementalCore(graph, np.asarray(core, np.int32), **inc_kw)
    return graph, store, cores
