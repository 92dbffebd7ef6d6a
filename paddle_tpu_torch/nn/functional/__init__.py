from paddle_tpu_torch.nn.functional.activation import gelu
from paddle_tpu_torch.nn.functional.attention import \
    scaled_dot_product_attention
from paddle_tpu_torch.nn.functional.common import dropout, embedding, linear
from paddle_tpu_torch.nn.functional.norm import layer_norm

__all__ = ["gelu", "scaled_dot_product_attention", "dropout", "embedding",
           "linear", "layer_norm"]
