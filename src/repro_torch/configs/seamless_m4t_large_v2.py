"""seamless-m4t-large-v2 [audio] — encoder-decoder backbone, frontend stubbed.

24L (enc) + 24L (dec) d_model=1024 16H (MHA) d_ff=8192 vocab=256206
(padded to 256208) [arXiv:2308.11596; hf]

The audio frontend is a STUB: the batch's ``src_embeds`` are precomputed
frame embeddings (B, T/4, d), the encoder's input.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256208,            # 256206 padded to a 16-multiple
    mlp_type="gelu",
    norm_type="layernorm",
    frontend="audio",
    rope_theta=10000.0,
    tie_embeddings=True,
)
