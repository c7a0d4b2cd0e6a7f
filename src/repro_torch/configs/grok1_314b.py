"""grok-1-314b [moe] — 8 experts top-2, logit softcaps.

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072
[hf:xai-org/grok-1; unverified]

The JAX package's copy; the port serves it at the reduced preset only: its
314 B parameters (628 GB in bf16) do not fit one 80 GB card, and the port
has no sharded placement (``ROADMAP.md``). One layer of it (its 8 experts
of 32,768 at full width, 5.73 B parameters) trains on one card with its
adafactor (``chip_smoke.py``'s "train-adafactor" path).
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    mlp_type="geglu",             # experts are gated-GELU
    norm_type="rmsnorm",
    attn_softcap=30.0,
    final_softcap=30.0,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32768, capacity_factor=1.25),
    rope_theta=10000.0,
    tie_embeddings=True,
    optimizer="adafactor",
)
