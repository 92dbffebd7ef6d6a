from paddle_tpu_torch.inference.block_pool import BlockAllocator
from paddle_tpu_torch.inference.frontend.scheduler import (FifoScheduler,
                                                          Scheduler)
from paddle_tpu_torch.inference.serving import (DecodeEngine, Request,
                                                ServingEngine, ServingMetrics,
                                                apply_topk_topp)

__all__ = ["BlockAllocator", "Scheduler", "FifoScheduler", "DecodeEngine",
           "Request", "ServingEngine", "ServingMetrics", "apply_topk_topp"]
