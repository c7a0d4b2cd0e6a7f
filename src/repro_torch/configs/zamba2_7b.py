"""zamba2-7b [hybrid] — Mamba2 blocks + one shared attention block (LoRA'd).

81L d_model=3584 32H (kv=32, MHA) d_ff=14336 vocab=32000 ssm_state=64
[arXiv:2411.15242; unverified]

Layout: 13 groups of (6 mamba + shared-attn invocation) + 3 trailing mamba.
The shared block's attention is bounded by a 4096 sliding window so the
long-context decode stays sub-quadratic in cache traffic.
n_groups=8 on B/C projections for TP shardability (upstream uses 2).
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,                  # mamba blocks; shared attn every 6
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    sliding_window=4096,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=8, chunk=256),
    shared_every=6,
    shared_lora_rank=128,
    rope_theta=10000.0,
    tie_embeddings=True,
)
