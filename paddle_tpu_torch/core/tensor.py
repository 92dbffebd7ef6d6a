"""The tensor API of the port (counterpart of ``core/tensor.py``).

The port's tensors are torch tensors: ``Tensor`` is ``torch.Tensor``,
``Parameter`` ``torch.nn.Parameter``, and ``no_grad`` / ``enable_grad``
/ ``is_grad_enabled`` torch's own. Of the reference's module only its
constructor function, ``to_tensor``, is code of the port's.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.place import resolve_device

__all__ = ["Tensor", "Parameter", "to_tensor", "is_grad_enabled", "no_grad",
           "enable_grad"]

Tensor = torch.Tensor
Parameter = torch.nn.Parameter
no_grad = torch.no_grad
enable_grad = torch.enable_grad


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def to_tensor(data, dtype=None, place=None, stop_gradient: bool = True):
    """``paddle.to_tensor``: float64 data becomes float32 unless
    ``dtype`` says otherwise; ``place`` is a device, its name or a
    ``Place``, the default place (``gpu:0`` unless ``set_device`` named
    another) unless given (a card's place raises on a host without one,
    naming ``device="cpu"``); ``stop_gradient=False`` makes a leaf that
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
    out = out.to(resolve_device(place))
    return out.requires_grad_(not stop_gradient)
