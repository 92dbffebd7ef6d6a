from paddle_tpu_torch.optimizer.optimizer import Optimizer
from paddle_tpu_torch.optimizer.optimizers import Adam, AdamW

__all__ = ["Optimizer", "Adam", "AdamW"]
