"""Serve step factories: the prefill and decode functions the launcher calls.

The torch counterpart of ``make_prefill_step`` / ``make_decode_step`` in
``repro.models.steps``. The JAX launcher jits them; here they run eagerly.
The decode step updates the cache in place (``forward_decode``), where the
JAX launcher donates it. The training step (``make_train_step``,
``loss_fn``) waits for LM training (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Callable, Optional

from .config import ModelConfig
from .transformer import forward_decode, forward_prefill, logits_from_hidden

__all__ = ["make_prefill_step", "make_decode_step"]


def make_prefill_step(cfg: ModelConfig,
                      max_len: Optional[int] = None) -> Callable:
    """step(params, batch {"tokens": (B, S)}) -> (last-token logits
    (B, 1, V), cache)."""

    def step(params, batch):
        hidden, cache = forward_prefill(params, cfg, tokens=batch["tokens"],
                                        max_len=max_len)
        return logits_from_hidden(params, hidden[:, -1:], cfg), cache

    return step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """step(params, cache, tokens (B, 1)) -> (logits (B, 1, V), cache),
    the cache updated in place."""

    def step(params, cache, tokens):
        return forward_decode(params, cache, tokens, cfg)

    return step
