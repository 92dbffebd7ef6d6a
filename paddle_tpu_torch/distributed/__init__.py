from paddle_tpu_torch.distributed import checkpoint, fleet
from paddle_tpu_torch.distributed.resilience import (AnomalyConfig,
                                                     CheckpointManager,
                                                     RetentionPolicy,
                                                     TransientFailureWarning,
                                                     retry_call)
from paddle_tpu_torch.distributed.strategy import DistributedStrategy
from paddle_tpu_torch.distributed.trainer import ShardedTrainer

__all__ = ["ShardedTrainer", "DistributedStrategy", "fleet", "checkpoint",
           "AnomalyConfig", "CheckpointManager", "RetentionPolicy",
           "TransientFailureWarning", "retry_call"]
