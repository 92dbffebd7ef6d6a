"""``Layer``: the port's module base (counterpart of ``nn/layer.py:71``).

A ``torch.nn.Module`` whose parameter names follow paddle's, so a
``paddle_tpu`` model's ``state_dict()`` maps onto the port 1:1 by name.
:meth:`Layer.set_state_dict` is that weight bridge: it copies arrays by
name with no transposes, because the port's ``Linear`` keeps paddle's
(in, out) weight layout.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["Layer"]


class Layer(nn.Module):
    """Base class of the port's layers."""

    def set_state_dict(self, state: Mapping[str, np.ndarray]) -> None:
        """Copy ``state`` (name -> array) into this layer's parameters
        and persistent buffers, on their device and dtype. Raises on a
        missing name, an unexpected name or a shape mismatch; nothing is
        copied unless every entry checks out."""
        own: Dict[str, torch.Tensor] = dict(self.named_parameters())
        own.update(self.named_buffers())
        missing = sorted(set(own) - set(state))
        unexpected = sorted(set(state) - set(own))
        if missing or unexpected:
            raise KeyError(f"set_state_dict: missing {missing}, "
                           f"unexpected {unexpected}")
        arrays = {}
        for name, tensor in own.items():
            arr = np.asarray(state[name])
            if tuple(arr.shape) != tuple(tensor.shape):
                raise ValueError(
                    f"set_state_dict: {name} has shape {tuple(arr.shape)}, "
                    f"the layer expects {tuple(tensor.shape)}")
            arrays[name] = arr
        with torch.no_grad():
            for name, tensor in own.items():
                tensor.copy_(torch.tensor(arrays[name], dtype=tensor.dtype))
