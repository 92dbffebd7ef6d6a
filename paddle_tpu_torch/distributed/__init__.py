"""``paddle_tpu_torch.distributed`` — training over a mesh of ranks.

The port of ``paddle_tpu/distributed/``: the process environment and the
mesh (``env``), the collectives, the hybrid topology, the launcher,
``fleet``, ``DataParallel``, the tensor-parallel and pipeline layers
(``meta_parallel``), the pipelines over ``pp`` (``PipelineParallel``
and ``gpipe_spmd``, ``Pipeline1F1B``), ring and Ulysses attention over
``sep``, ``ShardedTrainer`` over ``[dp, pp, sharding, mp(, sep)]``,
sharded checkpoints and the step-level resilience. Not here, ROADMAP.md
Queue 1 item 6: ``auto_parallel`` (``ProcessMesh``, ``shard_tensor``,
``shard_op``), the parameter server and its dataset facades.
"""

from paddle_tpu_torch.distributed import checkpoint, env, fleet, launch
from paddle_tpu_torch.distributed.collective import (Group, ReduceOp,
                                                     all_gather,
                                                     all_gather_object,
                                                     all_reduce, all_to_all,
                                                     alltoall, barrier,
                                                     broadcast, get_group,
                                                     new_group, ppermute,
                                                     recv, reduce,
                                                     reduce_scatter, scatter,
                                                     send, split, wait)
from paddle_tpu_torch.distributed.compat import (ParallelMode, gloo_barrier,
                                                 gloo_init_parallel_env,
                                                 gloo_release, spawn)
from paddle_tpu_torch.distributed.env import (ParallelEnv, build_mesh,
                                              get_mesh, get_rank,
                                              get_world_size,
                                              init_parallel_env,
                                              is_initialized, set_mesh)
from paddle_tpu_torch.distributed.parallel import DataParallel
from paddle_tpu_torch.distributed.pipeline import (PipelineParallel,
                                                   gpipe_spmd)
from paddle_tpu_torch.distributed.pipeline_1f1b import Pipeline1F1B
from paddle_tpu_torch.distributed.resilience import (AnomalyConfig,
                                                     CheckpointManager,
                                                     RetentionPolicy,
                                                     TransientFailureWarning,
                                                     retry_call)
from paddle_tpu_torch.distributed.ring_attention import (ring_attention,
                                                         ring_self_attention)
from paddle_tpu_torch.distributed.strategy import DistributedStrategy
from paddle_tpu_torch.distributed.topology import (CommunicateTopology,
                                                   HybridCommunicateGroup)
from paddle_tpu_torch.distributed.trainer import ShardedTrainer
from paddle_tpu_torch.distributed.ulysses import (get_sequence_parallel_mode,
                                                  sequence_parallel_mode,
                                                  ulysses_attention,
                                                  ulysses_self_attention)

__all__ = ["ShardedTrainer", "DistributedStrategy", "fleet", "checkpoint",
           "env", "launch", "AnomalyConfig", "CheckpointManager",
           "RetentionPolicy", "TransientFailureWarning", "retry_call",
           "Group", "ReduceOp", "all_gather", "all_gather_object",
           "all_reduce", "all_to_all", "alltoall", "barrier", "broadcast",
           "get_group", "new_group", "ppermute", "recv", "reduce",
           "reduce_scatter", "scatter", "send", "split", "wait",
           "ParallelMode", "gloo_barrier", "gloo_init_parallel_env",
           "gloo_release", "spawn", "ParallelEnv", "build_mesh", "get_mesh",
           "get_rank", "get_world_size", "init_parallel_env",
           "is_initialized", "set_mesh", "DataParallel",
           "CommunicateTopology", "HybridCommunicateGroup",
           "PipelineParallel", "gpipe_spmd", "Pipeline1F1B",
           "ring_attention", "ring_self_attention",
           "get_sequence_parallel_mode", "sequence_parallel_mode",
           "ulysses_attention", "ulysses_self_attention"]
