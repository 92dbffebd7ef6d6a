"""Activation functionals of the port (``nn/functional/activation.py``)."""

from __future__ import annotations

import torch.nn.functional as TF

__all__ = ["gelu"]


def gelu(x, approximate: bool = False):
    """``jax.nn.gelu``: ``approximate=True`` is the tanh form GPT uses
    (``models/gpt.py:455``), torch's ``approximate="tanh"``."""
    return TF.gelu(x, approximate="tanh" if approximate else "none")
