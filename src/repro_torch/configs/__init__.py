"""Architecture registry of the port: ``--arch <id>`` resolves here.

The configs ported so far, each a copy of the JAX package's
(``repro.configs``): the dense qwen3-4b (the serving launcher's default)
and gemma2-2b (softcaps, alternating sliding window, post-norms, GeGLU).
The rest wait for their families (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.models.config import ModelConfig

from . import gemma2_2b, qwen3_4b

__all__ = ["REGISTRY", "get_config", "list_archs"]

REGISTRY: Dict[str, ModelConfig] = {
    c.CONFIG.name: c.CONFIG for c in (gemma2_2b, qwen3_4b)
}


def list_archs():
    return sorted(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; options: {list_archs()}")
    return REGISTRY[name]
