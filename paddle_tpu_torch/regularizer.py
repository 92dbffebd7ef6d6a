"""Regularizers of the port (``paddle_tpu/regularizer.py``).

Each folds its penalty's gradient into the parameter's gradient before
the optimizer's rule. A parameter's own regularizer
(``ParamAttr(regularizer=)``) takes priority over the optimizer's
``weight_decay``, as in the reference's ``_apply_decay_to_grad``.
"""

from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def apply_to_grad(self, param, grad):
        raise NotImplementedError


class L1Decay(WeightDecayRegularizer):
    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)

    def apply_to_grad(self, param, grad):
        return grad + self.coeff * torch.sign(param)

    def __repr__(self):
        return f"L1Decay({self.coeff})"


class L2Decay(WeightDecayRegularizer):
    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)

    def apply_to_grad(self, param, grad):
        return grad + self.coeff * param

    def __repr__(self):
        return f"L2Decay({self.coeff})"
