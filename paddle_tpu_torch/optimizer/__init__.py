from paddle_tpu_torch.optimizer import lr
from paddle_tpu_torch.optimizer.optimizer import Optimizer
from paddle_tpu_torch.optimizer.optimizers import (SGD, Adadelta, Adagrad,
                                                   Adam, Adamax, AdamW, Lamb,
                                                   Lars, LarsMomentum,
                                                   Momentum, RMSProp)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adagrad", "Adadelta",
           "Adam", "AdamW", "Adamax", "RMSProp", "Lamb", "Lars",
           "LarsMomentum"]
