from paddle_tpu_torch.inference import adaptive
from paddle_tpu_torch.inference.adaptive import (AdaptiveController,
                                                 AdaptiveSuite,
                                                 ChunkBudgetController,
                                                 DraftLenController,
                                                 SwapMinController)
from paddle_tpu_torch.inference.block_pool import BlockAllocator
from paddle_tpu_torch.inference.frontend.scheduler import (FairScheduler,
                                                          FifoScheduler,
                                                          Scheduler, Tenant)
from paddle_tpu_torch.inference.prefix_cache import PrefixCache
from paddle_tpu_torch.inference.serving import (DecodeEngine, Request,
                                                ServingEngine, ServingMetrics,
                                                apply_topk_topp)
from paddle_tpu_torch.inference.speculative import (DraftModelDrafter,
                                                    NgramDrafter,
                                                    SpeculativeEngine)
from paddle_tpu_torch.inference.frontend import (  # noqa: E402
    AdmissionRejected, FrontDoor, SamplingParams)

__all__ = ["BlockAllocator", "Scheduler", "FifoScheduler", "PrefixCache",
           "DecodeEngine", "Request", "ServingEngine", "ServingMetrics",
           "apply_topk_topp", "NgramDrafter", "DraftModelDrafter",
           "SpeculativeEngine", "FrontDoor", "SamplingParams", "Tenant",
           "FairScheduler", "AdmissionRejected", "adaptive",
           "AdaptiveController", "AdaptiveSuite", "ChunkBudgetController",
           "SwapMinController", "DraftLenController"]
