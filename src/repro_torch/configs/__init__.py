"""Architecture registry of the port: ``--arch <id>`` resolves here.

The configs ported so far, each a copy of the JAX package's
(``repro.configs``), all of the dense family: qwen3-4b (the launchers'
default), gemma2-2b (softcaps, alternating sliding window, post-norms,
GeGLU), starcoder2-7b (layernorm, GELU) and nemotron-4-15b (layernorm,
squared ReLU, partial RoPE, an untied unembedding). The rest wait for their
families (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.models.config import ModelConfig

from . import gemma2_2b, nemotron4_15b, qwen3_4b, starcoder2_7b

__all__ = ["REGISTRY", "get_config", "list_archs"]

REGISTRY: Dict[str, ModelConfig] = {
    c.CONFIG.name: c.CONFIG
    for c in (gemma2_2b, nemotron4_15b, qwen3_4b, starcoder2_7b)
}


def list_archs():
    return sorted(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; options: {list_archs()}")
    return REGISTRY[name]
