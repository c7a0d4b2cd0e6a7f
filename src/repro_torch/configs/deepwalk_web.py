"""deepwalk-web1b — the paper's own workload at production scale.

SGNS embedding training for a web-scale graph: 2^27 (~134M) nodes, dim 128,
5 negatives. The two embedding tables are row-sharded (vocab rule; 2D over
data x model by ``SHARDING_OVERRIDES``): the memory-scaling axis that lets a
billion-node graph fit a pod; the (center, context, negatives) id batches
are data-parallel. CoreWalk/k-core enter as *data pipeline* operators (they
shape the walk corpus, not the step), so this one train step serves every
pipeline. A copy of ``repro.configs.deepwalk_web``.
"""
import dataclasses

__all__ = ["GraphEmbedConfig", "CONFIG"]


@dataclasses.dataclass(frozen=True)
class GraphEmbedConfig:
    name: str = "deepwalk-web1b"
    n_nodes: int = 1 << 27
    dim: int = 128
    n_neg: int = 5
    global_batch: int = 1 << 20  # (center, context) pairs per step
    param_dtype: str = "float32"


CONFIG = GraphEmbedConfig()
