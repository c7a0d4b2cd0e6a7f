"""SGNS trainer: one step per batch, epoch accounting proportional to the
corpus size.

The torch counterpart of ``repro.skipgram.trainer``. The paper's speedups
come from corpus reduction, and this trainer makes that explicit:
``steps = pairs_per_epoch(window) * epochs / batch``. Each step samples a
batch on the corpus's device, runs the fused SGNS loss (the CUDA kernels on
the card) forward and backward, and applies Adam to both full tables. The
loss is read back once, after the last step, so the host never waits on the
card inside the loop.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.device import synchronize
from repro_torch.train import optim

from .corpus import WalkCorpus, sample_batch
from .model import Params, batch_loss, init_params

__all__ = ["SGNSConfig", "SGNSResult", "train_sgns", "loss_and_grads"]


@dataclasses.dataclass
class SGNSConfig:
    dim: int = 150  # paper §3.1.2
    window: int = 4
    n_neg: int = 5
    batch: int = 4096
    epochs: float = 1.0
    lr: float = 0.025
    seed: int = 0
    impl: str = "auto"  # kernel dispatch: auto | ref | cuda


@dataclasses.dataclass
class SGNSResult:
    embeddings: np.ndarray  # (V, dim) float32 — emb_in
    n_steps: int
    train_seconds: float
    final_loss: float


def loss_and_grads(params: Params, centers, contexts, negatives,
                   impl: str = "auto"):
    """-> (mean loss, {name: gradient}) of one batch, as
    ``jax.value_and_grad(batch_loss)``."""
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    with torch.enable_grad():
        loss = batch_loss(leaves, centers, contexts, negatives, impl)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def train_sgns(corpus: WalkCorpus, cfg: SGNSConfig, *,
               params: Optional[Params] = None,
               steps: Optional[int] = None) -> SGNSResult:
    """Train on ``corpus`` on its device; ``params`` warm-starts."""
    dev = corpus.walks.device
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    if params is None:
        params = init_params(corpus.n_nodes, cfg.dim, gen, device=dev)
    opt = optim.adam(cfg.lr)
    opt_state = opt.init(params)
    if steps is None:
        steps = max(1, int(cfg.epochs * corpus.pairs_per_epoch(cfg.window)
                           // cfg.batch))

    loss = torch.zeros(())
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        ids = sample_batch(corpus, gen, batch=cfg.batch, window=cfg.window,
                           n_neg=cfg.n_neg)
        loss, grads = loss_and_grads(params, *ids, impl=cfg.impl)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optim.apply_updates(params, updates)
    loss = float(loss)
    synchronize(dev)
    dt = time.perf_counter() - t0
    return SGNSResult(
        embeddings=params["emb_in"].float().cpu().numpy(),
        n_steps=steps,
        train_seconds=dt,
        final_loss=loss,
    )
