from paddle_tpu_torch.inference.frontend.scheduler import (FifoScheduler,
                                                          Scheduler)

__all__ = ["Scheduler", "FifoScheduler"]
