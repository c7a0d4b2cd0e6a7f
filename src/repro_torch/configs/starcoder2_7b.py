"""starcoder2-7b [dense] — GQA, RoPE (assignment config: full attention).

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152
[arXiv:2402.19173; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    mlp_type="gelu",
    norm_type="layernorm",
    rope_theta=100000.0,
    tie_embeddings=True,
)
