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

``GRAPH_REGISTRY`` holds the paper's own workload, ``deepwalk-web1b``, and
``sharding_overrides(id)`` the per-arch logical-rule overrides
(``distributed.sharding``), copies of the JAX package's.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.models.config import ModelConfig

from . import (deepwalk_web, gemma2_2b, grok1_314b, mamba2_2p7b, moonshot_v1_16b_a3b,
               nemotron4_15b, qwen2_vl_7b, qwen3_4b, seamless_m4t_large_v2,
               starcoder2_7b, zamba2_7b)

__all__ = ["REGISTRY", "GRAPH_REGISTRY", "SHARDING_OVERRIDES", "get_config",
           "list_archs", "sharding_overrides"]

REGISTRY: Dict[str, ModelConfig] = {
    c.CONFIG.name: c.CONFIG
    for c in (gemma2_2b, nemotron4_15b, qwen3_4b, starcoder2_7b, zamba2_7b,
              mamba2_2p7b, seamless_m4t_large_v2, qwen2_vl_7b, grok1_314b,
              moonshot_v1_16b_a3b)
}


GRAPH_REGISTRY = {deepwalk_web.CONFIG.name: deepwalk_web.CONFIG}

# Per-arch logical-axis rule overrides (merged over distributed.sharding
# defaults). grok-1's experts are too few (8) to shard on the 16-way model
# axis, and its weights are too big for TP alone: shard every expert matrix
# 2D over data x model (FSDP+TP).
SHARDING_OVERRIDES = {
    # heads (8/36/28) don't divide the 16-way model axis: weights fall back
    # to head_dim TP (rule default) and attention goes Ulysses: q split by
    # sequence (an all-to-all from the head-dim split), the small GQA K/V
    # replicated, each rank attending its own S/16 query rows at their
    # absolute positions against every key
    # (models.attention._attention_by_heads).
    "gemma2-2b": {"attn_seq": ("model",)},
    "starcoder2-7b": {"attn_seq": ("model",)},
    "qwen2-vl-7b": {"attn_seq": ("model",)},
    "grok-1-314b": {
        # FSDP over the d_model dim of all weight matrices (scoping FSDP to
        # the expert weights alone was tried in the JAX package and
        # refuted: the data-axis gathers are expert-weight traffic either
        # way, and un-sharding attention cost more memory)
        "embed": ("data",),
        "expert_embed": ("data",),
        "expert_mlp": ("model",),
        "experts": (),  # 8 experts: replicated grouping, matrices 2D-sharded
        # d_model of activations sharded over model: bounds the (G, E, C, d)
        # expert dispatch buffers that dominate MoE live memory
        "act_embed": ("model",),
    },
    "moonshot-v1-16b-a3b": {
        "experts": ("model",),  # 64 experts: true expert parallelism
        "expert_mlp": (),
    },
    # SSM archs: shard the wide inner dim and the ssd heads over model
    "mamba2-2.7b": {"mlp": ("model",), "ssm_heads": ("model",)},
    "zamba2-7b": {"mlp": ("model",), "ssm_heads": ("model",)},
    # the paper's workload: 2D row-sharding of the embedding tables over
    # data x model (the axis that fits a 10^9-node graph on a pod) and the
    # pair batch sharded over both axes (B/256 ids per device)
    "deepwalk-web1b": {"vocab": ("data", "model"), "batch": ("data", "model")},
}


def list_archs():
    return sorted(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; options: {list_archs()}")
    return REGISTRY[name]


def sharding_overrides(name: str) -> dict:
    return dict(SHARDING_OVERRIDES.get(name, {}))
