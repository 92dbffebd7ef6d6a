from paddle_tpu_torch.core.place import get_device, resolve_device
from paddle_tpu_torch.core.random import (generator, request_generator,
                                          request_seed, seed)

__all__ = ["resolve_device", "get_device", "seed", "generator",
           "request_seed", "request_generator"]
