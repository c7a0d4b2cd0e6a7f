"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution; vision frontend stubbed.

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064
[arXiv:2409.12191; hf]

The vision frontend is a STUB: the batch's ``vision_embeds`` are
precomputed patch embeddings that replace the first n_vision_patches token
slots, and its ``positions`` the (3, B, S) t/h/w streams M-RoPE consumes.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    mrope_sections=(16, 24, 24),
    rope_theta=1000000.0,
    frontend="vision",
    n_vision_patches=1024,
    tie_embeddings=False,
)
