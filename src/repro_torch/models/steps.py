"""Train and serve step factories: the functions the launchers call.

The torch counterpart of ``repro.models.steps``. The JAX launchers jit
them; here they run eagerly. ``make_train_step``: loss, gradients through
``torch.autograd`` and the optimizer's update, with optional microbatch
accumulation; it updates the params and the optimizer state in place
(``GradientTransform.step``), where the JAX launcher donates both. The
decode step updates the cache in place (``forward_decode``), where the JAX
launcher donates it.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.distributed.sharding import is_dtensor, local_narrow
from repro_torch.train import optim as optim_lib
from repro_torch.train.tree import leaves, tree_map, unflatten

from .config import ModelConfig
from .transformer import (embed_tokens, forward_decode, forward_full,
                          forward_prefill, lm_loss, logits_from_hidden)

__all__ = ["loss_fn", "make_train_step", "make_prefill_step",
           "make_decode_step", "MOE_LB_WEIGHT", "MOE_Z_WEIGHT"]


MOE_LB_WEIGHT = 0.01  # the JAX package's weights of the MoE aux losses
MOE_Z_WEIGHT = 1e-3


def _model_inputs(params, batch: Dict, cfg: ModelConfig) -> Dict:
    """The keyword arguments of ``forward_full`` / ``forward_prefill`` for
    a batch, read as the JAX package's steps read it: ``tokens`` (B, S);
    ``positions`` ((B, S), or (3, B, S) for M-RoPE; default 0..S-1);
    ``src_embeds`` (B, T, d), the encoder-decoder's frame embeddings; and,
    for a vision frontend, ``vision_embeds`` (B, P, d), which take the
    place of the first P token slots after the embedding."""
    kw = {}
    if cfg.family == "encdec":
        kw["enc_embeds"] = batch["src_embeds"]
    if "positions" in batch:
        kw["positions"] = batch["positions"]
    if cfg.frontend == "vision" and "vision_embeds" in batch:
        h = embed_tokens(params, batch["tokens"], cfg)
        vis = batch["vision_embeds"]
        kw["embeds"] = torch.cat([vis.to(h.dtype), h[:, vis.shape[1]:]], 1)
    else:
        kw["tokens"] = batch["tokens"]
    return kw


def loss_fn(params, batch: Dict, cfg: ModelConfig):
    """Scalar training loss for one (micro)batch of ``tokens``, ``targets``
    (B, S), optional ``mask`` (B, S) fp32 and the inputs
    ``_model_inputs`` reads -> (loss, metrics). The MoE family adds
    ``MOE_LB_WEIGHT`` x its load-balance loss and ``MOE_Z_WEIGHT`` x its
    router z-loss, and reports both."""
    hidden, aux = forward_full(params, cfg,
                               **_model_inputs(params, batch, cfg))
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(batch["targets"].shape, device=hidden.device)
    loss = lm_loss(params, hidden, batch["targets"], mask, cfg)
    metrics = {"xent": loss}
    if aux:
        loss = (loss + MOE_LB_WEIGHT * aux["load_balance_loss"]
                + MOE_Z_WEIGHT * aux["router_z_loss"])
        metrics.update(aux)
    metrics["loss"] = loss
    return loss, metrics


def _microbatch(key: str, x: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """The k-th of n equal slices of a batch entry along its batch axis:
    axis 1 of M-RoPE's (3, B, S) ``positions``, axis 0 of the rest. A
    DTensor gives the k-th of each rank's rows (the microbatches hold other
    rows than the unsharded run's; their mean gradient is the same)."""
    axis = 1 if key == "positions" and x.dim() == 3 else 0
    if is_dtensor(x):  # each rank's own rows, in n pieces
        return local_narrow(x, axis, k, n)
    size = x.shape[axis] // n
    if size * n != x.shape[axis]:
        raise ValueError(f"batch entry {key!r} has {x.shape[axis]} rows: "
                         f"not {n} equal microbatches")
    return x.narrow(axis, k * size, size)


def make_train_step(cfg: ModelConfig, optimizer: optim_lib.GradientTransform,
                    accum_steps: int = 1,
                    grad_transform: Optional[Callable] = None) -> Callable:
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics); ``params`` (the same tree) and ``opt_state`` are updated in
    place. With ``accum_steps`` > 1 the batch splits into that many
    microbatches along its batch axis (axis 1 of M-RoPE's (3, B, S)
    ``positions``, axis 0 of every other entry); their gradients add up in
    fp32 and are divided by ``accum_steps``, and the metrics are the last
    microbatch's. ``grad_transform`` (e.g. int8 compression) runs on the
    gradients before the optimizer; ``grad_norm`` is the norm of what the
    optimizer receives."""

    def single_grads(params, batch):
        ws = [p.detach().requires_grad_() for p in leaves(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(unflatten(params, ws), batch, cfg)
            grads = torch.autograd.grad(loss, ws)
        return (unflatten(params, list(grads)),
                {k: v.detach() for k, v in metrics.items()})

    def step(params, opt_state, batch):
        if accum_steps == 1:
            grads, metrics = single_grads(params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            for k in range(accum_steps):
                micro = {key: _microbatch(key, x, accum_steps, k)
                         for key, x in batch.items()}
                g, metrics = single_grads(params, micro)
                for acc, gi in zip(leaves(grads), leaves(g)):
                    acc.add_(gi)
                del g
            for acc in leaves(grads):
                acc.div_(accum_steps)
        if grad_transform is not None:
            grads = grad_transform(grads)
        metrics["grad_norm"] = optim_lib.global_norm(grads)
        opt_state = optimizer.step(grads, opt_state, params)
        return params, opt_state, metrics

    return step


def make_prefill_step(cfg: ModelConfig,
                      max_len: Optional[int] = None) -> Callable:
    """step(params, batch {"tokens": (B, S), and what ``_model_inputs``
    reads}) -> (last-token logits (B, 1, V), cache)."""

    def step(params, batch):
        hidden, cache = forward_prefill(params, cfg, max_len=max_len,
                                        **_model_inputs(params, batch, cfg))
        return logits_from_hidden(params, hidden[:, -1:], cfg), cache

    return step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """step(params, cache, tokens (B, 1)) -> (logits (B, 1, V), cache),
    the cache updated in place."""

    def step(params, cache, tokens):
        return forward_decode(params, cache, tokens, cfg)

    return step
