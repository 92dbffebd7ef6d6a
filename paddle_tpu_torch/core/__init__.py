from paddle_tpu_torch.core.place import module_device, resolve_device
from paddle_tpu_torch.core.random import (generator, position_uniforms,
                                          request_keydata, request_seed, seed)

__all__ = ["resolve_device", "module_device", "seed", "generator",
           "request_seed", "request_keydata", "position_uniforms"]
