from paddle_tpu_torch.optimizer import lr
from paddle_tpu_torch.optimizer.optimizer import Optimizer
from paddle_tpu_torch.optimizer.optimizers import (SGD, Adam, AdamW,
                                                   Momentum)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW"]
