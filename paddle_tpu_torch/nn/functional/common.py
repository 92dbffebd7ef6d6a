"""Common functionals of the port (``nn/functional/common.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from paddle_tpu_torch.amp.auto_cast import maybe_cast_inputs
from paddle_tpu_torch.core.unported import refuse_unported

__all__ = ["linear", "embedding", "dropout"]


def linear(x, weight, bias=None, op_name: str = "linear"):
    """y = x @ W + b with paddle's (in, out) weight layout — NOT torch's
    (out, in) ``F.linear``. Under AMP the inputs are cast as the op
    ``op_name`` dictates: the tensor-parallel layers dispatch as
    ``column_parallel_linear`` / ``row_parallel_linear``, as in the JAX
    package."""
    x, weight, bias = maybe_cast_inputs(op_name, (x, weight, bias))
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


def embedding(x, weight):
    """Gather rows of ``weight`` by id."""
    return TF.embedding(x, weight)


def dropout(x, p: float = 0.5, axis=None, training: bool = True,
            mode: str = "upscale_in_train", name=None):
    """upscale_in_train dropout over every element (identity in eval or
    at p = 0); the reference's ``axis``, ``mode`` and ``name`` are
    accepted at their defaults only."""
    refuse_unported("dropout", axis=(axis, None),
                    mode=(mode, "upscale_in_train"), name=(name, None))
    if not training or p == 0.0:
        return x
    return TF.dropout(x, p=p, training=True)
