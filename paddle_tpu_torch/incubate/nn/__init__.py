"""``paddle_tpu_torch.incubate.nn`` — the fused transformer layers (the
port of ``paddle_tpu/incubate/nn/``)."""

from paddle_tpu_torch.incubate.nn.fused_transformer import (  # noqa: F401
    FusedFeedForward,
    FusedMultiHeadAttention,
    FusedTransformerEncoderLayer,
)

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer"]
