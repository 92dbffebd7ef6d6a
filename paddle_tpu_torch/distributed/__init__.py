from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.trainer import ShardedTrainer

__all__ = ["ShardedTrainer", "fleet"]
