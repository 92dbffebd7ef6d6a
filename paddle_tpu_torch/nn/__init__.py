from paddle_tpu_torch.nn import functional
from paddle_tpu_torch.nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                                      ClipGradByValue, clip_grad_norm_)
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.layers import (Dropout, Embedding, LayerList,
                                        LayerNorm, Linear)

__all__ = ["functional", "Layer", "Linear", "Embedding", "Dropout",
           "LayerNorm", "LayerList", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_"]
