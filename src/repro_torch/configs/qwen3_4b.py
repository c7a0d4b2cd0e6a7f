"""qwen3-4b [dense] — per-head qk RMSNorm, GQA, SwiGLU.

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936
[hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
)
