"""``paddle_tpu_torch.incubate``: the experimental APIs of
``paddle_tpu/incubate/`` — ``asp`` (n:m structured sparsity), MoE under
``distributed/``, the fused transformer layers under ``nn/``, and the
extras (LookAhead, ModelAverage, fused softmax-mask, segment and graph
ops)."""

from paddle_tpu_torch.incubate import asp  # noqa: F401
from paddle_tpu_torch.incubate import distributed  # noqa: F401
from paddle_tpu_torch.incubate import nn  # noqa: F401
from paddle_tpu_torch.incubate.extras import *  # noqa: F401,F403
from paddle_tpu_torch.incubate.extras import __all__ as _extras_all

__all__ = ["asp", "distributed", "nn"] + list(_extras_all)
