from paddle_tpu_torch.nn.layers.activation import *  # noqa: F401,F403
from paddle_tpu_torch.nn.layers.common import Dropout, Embedding, Linear
from paddle_tpu_torch.nn.layers.container import (LayerDict, LayerList,
                                                  ParameterList, Sequential)
from paddle_tpu_torch.nn.layers.loss import *  # noqa: F401,F403
from paddle_tpu_torch.nn.layers.norm import LayerNorm
from paddle_tpu_torch.nn.layers.transformer import *  # noqa: F401,F403
from paddle_tpu_torch.nn.layers import activation, loss, transformer

__all__ = (["Linear", "Embedding", "Dropout", "LayerNorm", "LayerList",
            "Sequential", "LayerDict", "ParameterList"]
           + activation.__all__ + loss.__all__ + transformer.__all__)
