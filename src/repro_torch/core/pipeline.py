"""End-to-end embedding pipelines — the paper's four model rows.

The torch counterpart of ``repro.core.pipeline``:

  * DeepWalk            : fixed walk budget on the full graph (baseline)
  * CoreWalk            : Eq. 13 budgets on the full graph (§2.1)
  * k-core(Dw)/k-core(Cw): embed only the k₀-core, then mean-propagate (§2.2)

Walks, SGNS training and the ``torch`` propagation backend run on
``EmbedConfig.device``; the decomposition, the plan and the ``scipy``
backend run on the host. Every run returns the paper's time breakdown
(decomposition / walks / embedding / propagation / total), each read after
the device has finished its work.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device, synchronize
from repro_torch.graph.csr import Graph
from repro_torch.skipgram.corpus import build_corpus
from repro_torch.skipgram.trainer import SGNSConfig, train_sgns

from .corewalk import WalkPlan, corewalk_plan, deepwalk_plan
from .kcore import core_numbers_host, degeneracy, kcore_subgraph
from .propagation import propagate

__all__ = ["EmbedConfig", "EmbedResult", "embed_graph"]


@dataclasses.dataclass
class EmbedConfig:
    method: str = "deepwalk"  # deepwalk | corewalk
    k0: Optional[int] = None  # embed only the k0-core, then propagate
    n_walks: int = 15  # paper defaults (§3.1.2)
    walk_length: int = 30
    sgns: SGNSConfig = dataclasses.field(default_factory=SGNSConfig)
    prop_iters: int = 30
    prop_backend: str = "scipy"  # scipy (host) | torch (ELL-mean kernel)
    seed: int = 0
    device: str = "cuda"


@dataclasses.dataclass
class EmbedResult:
    embeddings: np.ndarray
    core: np.ndarray
    degeneracy: int
    n_walks_run: int
    n_sgns_steps: int
    final_loss: float
    times: dict  # decomposition / walks / embedding / propagation / total


def embed_graph(g: Graph, cfg: EmbedConfig) -> EmbedResult:
    dev = resolve_device(cfg.device)

    def now() -> float:
        synchronize(dev)
        return time.perf_counter()

    times = {}
    t_total = now()

    # --- k-core decomposition (cheap; always computed: CoreWalk and k-core
    # pipelines need it, and reporting matches the paper's breakdown) ---
    t0 = now()
    core = core_numbers_host(g)
    kdeg = degeneracy(core)
    times["decomposition"] = now() - t0

    # --- choose the graph to embed and the walk budget plan ---
    if cfg.k0 is not None:
        # edge-removal can lower the degeneracy below a k0 chosen on the full
        # graph (cora + 30% removal does): clamp to the deepest alive core
        k0 = min(cfg.k0, kdeg)
        sub = kcore_subgraph(g, core, k0)
        in_core = core >= k0
    else:
        sub = g
        in_core = np.ones(g.n_nodes, dtype=bool)

    if cfg.method == "corewalk":
        budgets = corewalk_plan(core, cfg.n_walks).per_node
    elif cfg.method == "deepwalk":
        budgets = deepwalk_plan(g.n_nodes, cfg.n_walks).per_node
    else:
        raise ValueError(cfg.method)
    budgets = np.where(in_core, budgets, 0)
    roots = np.repeat(np.arange(g.n_nodes, dtype=np.int32), budgets)
    plan = WalkPlan(roots=roots, n_real=len(roots),
                    per_node=budgets.astype(np.int32))

    # --- walks + SGNS on the (sub)graph ---
    t0 = now()
    ell = sub.to_ell(device=dev)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    corpus = build_corpus(ell, plan, cfg.walk_length, gen)
    times["walks"] = now() - t0

    t0 = now()
    sg = train_sgns(corpus, cfg.sgns)
    times["embedding"] = now() - t0
    del corpus, ell

    emb = sg.embeddings

    # --- mean-embedding propagation to the full graph ---
    t0 = now()
    if cfg.k0 is not None:
        emb = propagate(
            g,
            core,
            k0,
            emb,
            n_iters=cfg.prop_iters,
            backend=cfg.prop_backend,
            device=dev,
        )
    times["propagation"] = now() - t0
    times["total"] = now() - t_total

    return EmbedResult(
        embeddings=emb,
        core=core,
        degeneracy=kdeg,
        n_walks_run=plan.n_real,
        n_sgns_steps=sg.n_steps,
        final_loss=sg.final_loss,
        times=times,
    )
