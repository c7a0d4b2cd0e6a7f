"""Architecture registry of the port: ``--arch <id>`` resolves here.

The JAX package's LM configs, each a copy of its own
(``repro.configs``). Dense: qwen3-4b (the launchers' default), gemma2-2b
(softcaps, alternating sliding window, post-norms, GeGLU), starcoder2-7b
(layernorm, GELU) and nemotron-4-15b (layernorm, squared ReLU, partial
RoPE, an untied unembedding). MoE: moonshot-v1-16b-a3b (64 experts top-6,
MHA) and grok-1-314b (8 experts top-2, softcaps; reduced preset only: it
does not fit one card). SSM: mamba2-2.7b. Hybrid: zamba2-7b (mamba2 blocks
and a shared attention block with per-invocation LoRA, head dim 112).
Encoder-decoder: seamless-m4t-large-v2 (24 + 24 layers, MHA of head dim
64, cross-attention over precomputed audio frames). Vision: qwen2-vl-7b
(M-RoPE over (t, h, w) position streams, 28 heads on 4 KV heads,
precomputed patch embeddings in the first token slots).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.models.config import ModelConfig

from . import (gemma2_2b, grok1_314b, mamba2_2p7b, moonshot_v1_16b_a3b,
               nemotron4_15b, qwen2_vl_7b, qwen3_4b, seamless_m4t_large_v2,
               starcoder2_7b, zamba2_7b)

__all__ = ["REGISTRY", "get_config", "list_archs"]

REGISTRY: Dict[str, ModelConfig] = {
    c.CONFIG.name: c.CONFIG
    for c in (gemma2_2b, nemotron4_15b, qwen3_4b, starcoder2_7b, zamba2_7b,
              mamba2_2p7b, seamless_m4t_large_v2, qwen2_vl_7b, grok1_314b,
              moonshot_v1_16b_a3b)
}


def list_archs():
    return sorted(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; options: {list_archs()}")
    return REGISTRY[name]
