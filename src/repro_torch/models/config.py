"""Model configuration schema: the torch counterpart of ``repro.models.config``.

One dataclass, explicit feature flags — a config IS the architecture
(gemma2's softcaps + alternating local/global, qwen3's qk-norm, grok's MoE,
mamba2's SSD, zamba2's shared block, seamless' enc-dec, qwen2-vl's M-RoPE).
``reduced()`` produces the CPU-test variant of any config. The fields and
their defaults are the JAX package's, so a config means the same model in
both; ``pdtype()`` / ``cdtype()`` return torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["MoEConfig", "SSMConfig", "ModelConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    group_size: int = 1024


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 8
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # families: "dense" | "moe" | "ssm" | "hybrid" | "encdec"
    family: str = "dense"

    # attention features
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    sliding_window: int = 0  # 0 = full attention
    local_global_pattern: bool = False  # gemma2: alternate local/global layers
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0  # nemotron: partial rope
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl

    # mlp
    mlp_type: str = "swiglu"  # swiglu | geglu | gelu | relu2
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    post_norm: bool = False  # gemma2: extra norms after attn/mlp
    # gemma: token embeddings times sqrt(d_model). The port's own field; the
    # JAX package decides this from the name (``name.startswith("gemma")``)
    embed_scale: bool = False

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    shared_every: int = 0
    shared_lora_rank: int = 0
    n_encoder_layers: int = 0
    frontend: Optional[str] = None  # None | "audio" | "vision"
    n_vision_patches: int = 0

    tie_embeddings: bool = True
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # layout fields of the JAX package (scan and rematerialisation, loss
    # chunking, the optimizer): carried so configs compare equal; the port's
    # serving path loops over layers and reads none of them
    scan_layers: bool = True
    remat: str = "full"
    # prefill attention chunking (online softmax over KV chunks)
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    loss_chunk: int = 512
    optimizer: str = "adamw"
    # int8 KV cache (decode): symmetric per-(position, kv-head) scales
    kv_quant: bool = False

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def is_attention_layer(self, i: int) -> bool:
        """hybrid (zamba2): which block indices are the shared attn block."""
        if self.family != "hybrid" or self.shared_every <= 0:
            return False
        return (i + 1) % (self.shared_every + 1) == 0

    def layer_is_local(self, i: int) -> bool:
        """gemma2 alternation: even layers local (sliding window), odd global."""
        return self.local_global_pattern and i % 2 == 0

    def reduced(self, **over) -> "ModelConfig":
        """Small same-family variant for CPU tests (the JAX package's)."""
        changes = dict(
            n_layers=min(self.n_layers, 4 if self.family != "hybrid" else 7),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            attn_chunk_q=64,
            attn_chunk_kv=64,
            loss_chunk=64,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            n_vision_patches=min(self.n_vision_patches, 16),
            param_dtype="float32",
            compute_dtype="float32",
        )
        if self.moe is not None:
            changes["moe"] = MoEConfig(
                n_experts=min(self.moe.n_experts, 8),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=128,
                capacity_factor=self.moe.capacity_factor,
            )
        if self.ssm is not None:
            changes["ssm"] = SSMConfig(
                d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=2, chunk=32
            )
        if self.shared_every:
            changes["shared_every"] = 2
            changes["shared_lora_rank"] = 8
        if self.mrope_sections is not None:
            half = changes["head_dim"] // 2  # sections must sum to rot/2
            q = half // 4
            changes["mrope_sections"] = (half - 2 * q, q, q)
        changes.update(over)
        return dataclasses.replace(self, **changes)
