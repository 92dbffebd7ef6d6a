from paddle_tpu_torch.nn import functional, initializer  # noqa: F401
from paddle_tpu_torch.nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                                      ClipGradByValue, clip_grad_norm_)
from paddle_tpu_torch.nn.layer import Layer, ParamAttr
from paddle_tpu_torch.nn.layers import *  # noqa: F401,F403
from paddle_tpu_torch.nn.layers import __all__ as _layers

__all__ = (["functional", "initializer", "Layer", "ParamAttr",
            "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
            "clip_grad_norm_"] + _layers)
