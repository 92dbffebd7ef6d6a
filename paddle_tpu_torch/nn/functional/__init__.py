from paddle_tpu_torch.nn.functional import (activation, attention,  # noqa: F401
                                            common, loss, norm)
from paddle_tpu_torch.nn.functional.activation import *  # noqa: F401,F403
from paddle_tpu_torch.nn.functional.attention import (
    flash_attention, scaled_dot_product_attention)
from paddle_tpu_torch.nn.functional.common import dropout, embedding, linear
from paddle_tpu_torch.nn.functional.loss import *  # noqa: F401,F403
from paddle_tpu_torch.nn.functional.norm import layer_norm

__all__ = (activation.__all__ + loss.__all__
           + ["scaled_dot_product_attention", "flash_attention", "dropout",
              "embedding", "linear", "layer_norm"])
