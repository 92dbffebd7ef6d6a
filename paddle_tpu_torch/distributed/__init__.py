from paddle_tpu_torch.distributed.trainer import ShardedTrainer

__all__ = ["ShardedTrainer"]
