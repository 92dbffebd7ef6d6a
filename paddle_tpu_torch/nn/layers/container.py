"""Containers of the port (counterpart of ``nn/layers/container.py``).

Children are named as the reference names them (``0``, ``1``, ... or
the given keys), so parameter names read ``layers.0.self_attn...`` as
in the JAX package. ``LayerList``, ``LayerDict`` and ``ParameterList``
are torch's containers under paddle's method names.
"""

from __future__ import annotations

from collections import OrderedDict

from torch import nn

from paddle_tpu_torch.nn.layer import Layer

__all__ = ["Sequential", "LayerList", "LayerDict", "ParameterList"]


class Sequential(Layer):
    """Layers applied in order; built from layers (named ``0``, ``1``,
    ...), ``(name, layer)`` pairs, or one ``OrderedDict``."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            for name, l in layers[0].items():
                self.add_module(name, l)
        else:
            for i, l in enumerate(layers):
                if isinstance(l, tuple):
                    self.add_module(l[0], l[1])
                else:
                    self.add_module(str(i), l)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class LayerList(nn.ModuleList):
    """paddle's ``LayerList``: children named ``0``, ``1``, ..."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)

    def append(self, layer):
        return super().append(layer)

    def insert(self, index, layer):
        super().insert(index, layer)

    def extend(self, layers):
        return super().extend(layers)


class LayerDict(nn.ModuleDict):
    """paddle's ``LayerDict``: children named by their keys, in order."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)

    def clear(self):
        super().clear()

    def pop(self, key):
        return super().pop(key)

    def keys(self):
        return super().keys()

    def values(self):
        return super().values()

    def items(self):
        return super().items()

    def update(self, sublayers):
        super().update(sublayers)


class ParameterList(nn.ParameterList):
    """paddle's ``ParameterList``: parameters named ``0``, ``1``, ..."""

    def __init__(self, parameters=None):
        super().__init__(parameters)

    def append(self, parameter):
        return super().append(parameter)
