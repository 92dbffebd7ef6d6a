"""Common functionals of the port (``nn/functional/common.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as TF

__all__ = ["linear", "embedding", "dropout"]


def linear(x, weight, bias=None):
    """y = x @ W + b with paddle's (in, out) weight layout — NOT torch's
    (out, in) ``F.linear``."""
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


def embedding(x, weight):
    """Gather rows of ``weight`` by id."""
    return TF.embedding(x, weight)


def dropout(x, p: float = 0.5, training: bool = True):
    """upscale_in_train dropout (identity in eval or at p = 0)."""
    if not training or p == 0.0:
        return x
    return TF.dropout(x, p=p, training=True)
