"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free.

64L d_model=2560 vocab=50280 (padded to 50304 for sharding) ssm_state=128
[arXiv:2405.21060; unverified]

n_groups=8 on B/C (upstream uses 1) for TP shardability, as the JAX
package chose.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=1,                    # unused (attention-free)
    n_kv_heads=1,
    head_dim=1,
    d_ff=0,
    vocab_size=50304,             # 50280 padded to a 64-multiple
    norm_type="rmsnorm",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=8, chunk=256),
    tie_embeddings=True,
)
