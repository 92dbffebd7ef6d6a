from paddle_tpu_torch.nn.layers.common import Dropout, Embedding, Linear
from paddle_tpu_torch.nn.layers.container import LayerList
from paddle_tpu_torch.nn.layers.norm import LayerNorm

__all__ = ["Linear", "Embedding", "Dropout", "LayerNorm", "LayerList"]
