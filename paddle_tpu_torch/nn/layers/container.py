"""Containers of the port (counterpart of ``nn/layers/container.py``)."""

from __future__ import annotations

from torch import nn

__all__ = ["LayerList"]


class LayerList(nn.ModuleList):
    """paddle's ``LayerList``: children named ``0``, ``1``, ... so
    parameter names read ``h.0.attn...`` as in the JAX package."""
