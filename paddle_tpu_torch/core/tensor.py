"""``to_tensor`` of the port (counterpart of ``core/tensor.py:318``).

The port's tensors are torch tensors, so of the reference's module only
its constructor function has a counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.place import resolve_device

__all__ = ["to_tensor"]


def to_tensor(data, dtype=None, place=None, stop_gradient: bool = True):
    """``paddle.to_tensor``: float64 data becomes float32 unless
    ``dtype`` says otherwise; ``place`` is a device (or its name),
    ``"cuda"`` unless given (it raises on a host without a card, naming
    ``device="cpu"``); ``stop_gradient=False`` makes a leaf that
    requires grad."""
    if isinstance(data, torch.Tensor):
        out = data.detach().clone()
    else:
        arr = np.asarray(data)
        if dtype is None and arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        out = torch.as_tensor(arr)
    if dtype is not None:
        from paddle_tpu_torch.ops.creation import _dtype

        out = out.to(_dtype(dtype))
    out = out.to(resolve_device(
        place if place is None or isinstance(place, (str, torch.device))
        else str(place)))
    return out.requires_grad_(not stop_gradient)
