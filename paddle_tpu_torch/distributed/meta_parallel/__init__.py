"""Hybrid-parallel building blocks (reference
python/paddle/distributed/fleet/meta_parallel/): the tensor-parallel
layers, the model-parallel RNG tracker and the pipeline layers."""

from paddle_tpu_torch.distributed.meta_parallel.mp_layers import (  # noqa: F401
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from paddle_tpu_torch.distributed.meta_parallel.parallel_layers import (  # noqa: F401
    LayerDesc,
    PipelineLayer,
    SharedLayerDesc,
)
from paddle_tpu_torch.distributed.meta_parallel.random import (  # noqa: F401
    RNGStatesTracker,
    get_rng_state_tracker,
    model_parallel_random_seed,
)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "LayerDesc", "PipelineLayer",
           "SharedLayerDesc"]
