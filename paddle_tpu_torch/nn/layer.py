"""``Layer`` and ``ParamAttr``: the port's module base and parameter
attributes (counterpart of ``nn/layer.py:30`` and ``:71``).

A ``torch.nn.Module`` whose parameter names follow paddle's, so a
``paddle_tpu`` model's ``state_dict()`` maps onto the port 1:1 by name.
:meth:`Layer.set_state_dict` is that weight bridge: it copies arrays by
name with no transposes, because the port's ``Linear`` keeps paddle's
(in, out) weight layout.

:meth:`Layer.create_parameter` makes an ``nn.Parameter`` from a
``ParamAttr`` as the reference does: its initializer (else the
layer's default; XavierUniform for a weight, zeros for a bias), and on
the parameter ``trainable`` as ``requires_grad``, ``optimize_attr
["learning_rate"]`` (the multiplier the optimizer applies to this
parameter's rate), ``need_clip`` (read by the gradient clippers) and
``regularizer`` (an ``L1Decay``/``L2Decay`` the optimizer folds into
this parameter's gradient ahead of its ``weight_decay``). ``ParamAttr.name``
is kept on the attribute only: a torch tensor's ``name`` is read-only,
and the port names parameters by their structured names.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.core.unported import refuse_unported

__all__ = ["Layer", "ParamAttr"]


class ParamAttr:
    """Parameter attribute bundle (reference ``nn/layer.py:30``)."""

    def __init__(self, name=None, initializer=None, learning_rate: float = 1.0,
                 regularizer=None, trainable: bool = True,
                 need_clip: bool = True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if attr is False:
            return False
        from paddle_tpu_torch.nn import initializer as I

        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        raise TypeError(f"cannot interpret {attr!r} as ParamAttr")


class Layer(nn.Module):
    """Base class of the port's layers."""

    def create_parameter(self, shape, attr=None, dtype=None,
                         is_bias: bool = False, default_initializer=None, *,
                         device=None):
        """A parameter of ``shape`` on ``device`` (torch's default device
        when None) per ``attr`` (a ``ParamAttr``, an initializer, a name,
        None, or False for no parameter: then None comes back)."""
        from paddle_tpu_torch.nn import initializer as I
        from paddle_tpu_torch.ops.creation import _dtype

        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        init = attr.initializer or default_initializer
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierUniform()
        with torch.no_grad():
            value = init(tuple(shape), _dtype(dtype), device=device)
        p = nn.Parameter(value, requires_grad=bool(attr.trainable))
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def set_state_dict(self, state_dict: Mapping[str, np.ndarray],
                       use_structured_name: bool = True) -> None:
        """Copy ``state_dict`` (structured name -> array) into this
        layer's parameters and persistent buffers, on their device and
        dtype. Raises on a missing name, an unexpected name or a shape
        mismatch; nothing is copied unless every entry checks out.
        ``use_structured_name=False`` (keys by parameter name) is not
        ported."""
        refuse_unported("set_state_dict",
                        use_structured_name=(use_structured_name, True))
        own: Dict[str, torch.Tensor] = dict(self.named_parameters())
        own.update(self.named_buffers())
        missing = sorted(set(own) - set(state_dict))
        unexpected = sorted(set(state_dict) - set(own))
        if missing or unexpected:
            raise KeyError(f"set_state_dict: missing {missing}, "
                           f"unexpected {unexpected}")
        arrays = {}
        for name, tensor in own.items():
            arr = np.asarray(state_dict[name])
            if tuple(arr.shape) != tuple(tensor.shape):
                raise ValueError(
                    f"set_state_dict: {name} has shape {tuple(arr.shape)}, "
                    f"the layer expects {tuple(tensor.shape)}")
            arrays[name] = arr
        with torch.no_grad():
            for name, tensor in own.items():
                tensor.copy_(torch.tensor(arrays[name], dtype=tensor.dtype))
