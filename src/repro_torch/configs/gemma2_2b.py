"""gemma2-2b [dense] — local+global alternating attention, logit softcaps.

26L d_model=2304 8H (GQA kv=4, head_dim 256) d_ff=9216 vocab=256000
[arXiv:2408.00118; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    mlp_type="geglu",
    norm_type="rmsnorm",
    post_norm=True,               # gemma2 post-attn/post-mlp norms
    embed_scale=True,             # embeddings times sqrt(d_model)
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    local_global_pattern=True,    # even layers local (4096), odd global
    rope_theta=10000.0,
    tie_embeddings=True,
)
