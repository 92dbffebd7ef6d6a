"""Common functionals of the port (``nn/functional/common.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from paddle_tpu_torch.amp.auto_cast import maybe_cast_inputs
from paddle_tpu_torch.core.unported import refuse_unported

__all__ = ["linear", "embedding", "dropout"]


def linear(x, weight, bias=None, *, op_name: str = "linear"):
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


def embedding(x, weight, padding_idx=None, sparse: bool = False):
    """Gather rows of ``weight`` by id. Ids equal to ``padding_idx``
    (negative counts from the end) give zero rows, so those rows of
    ``weight`` get a zero gradient — the reference masks the output the
    same way (``nn/functional/common.py:96``). ``sparse`` is accepted and,
    as in the reference, the gradient is dense."""
    out = TF.embedding(x, weight)
    if padding_idx is not None:
        if padding_idx < 0:
            padding_idx += weight.shape[0]
        out = torch.where((x != padding_idx).unsqueeze(-1), out,
                          out.new_zeros(()))
    return out


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
