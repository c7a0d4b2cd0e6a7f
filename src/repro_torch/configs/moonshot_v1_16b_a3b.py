"""moonshot-v1-16b-a3b (Moonlight-16B-A3B) [moe] — 64 experts top-6.

48L d_model=2048 16H (MHA kv=16) expert d_ff=1408 vocab=163840
[hf:moonshotai/Moonlight-16B-A3B; hf]
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, capacity_factor=1.25),
    rope_theta=10000.0,
    tie_embeddings=True,
)
