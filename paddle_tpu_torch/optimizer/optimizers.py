"""Adam and AdamW — the port of ``paddle_tpu/optimizer/optimizers.py``
(:87-187).

The rule is JAX ``Adam._update`` in the same order of operations, per
parameter with its own fp32 0-dim ``beta1_pow``/``beta2_pow`` slots:

    b1p *= beta1; b2p *= beta2
    m1 = beta1*m1 + (1-beta1)*g;  m2 = beta2*m2 + (1-beta2)*g^2
    param -= lr * (m1/(1-b1p)) / (sqrt(m2/(1-b2p)) + eps)

AdamW first multiplies the parameter by (1 - lr*coeff) (decoupled decay,
not folded into the gradient); ``apply_decay_param_fun(name)`` false
sets coeff to 0 for that parameter.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from paddle_tpu_torch.optimizer.optimizer import Optimizer, _Named

__all__ = ["Adam", "AdamW"]


class Adam(Optimizer):
    _state_slots = ("moment1", "moment2", "beta1_pow", "beta2_pow")

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8, parameters=None,
                 weight_decay=None, grad_clip=None, lazy_mode: bool = False,
                 multi_precision: bool = False, name=None):
        if lazy_mode:
            raise NotImplementedError("lazy_mode is not ported yet")
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _init_state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        one = torch.ones((), dtype=torch.float32, device=p.device)
        return {"moment1": torch.zeros_like(p),
                "moment2": torch.zeros_like(p),
                "beta1_pow": one, "beta2_pow": one.clone()}

    def _adam(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              lr: float):
        b1, b2 = self._beta1, self._beta2
        st = self._states(params)
        m1 = [s["moment1"] for s in st]
        m2 = [s["moment2"] for s in st]
        b1p = [s["beta1_pow"] for s in st]
        b2p = [s["beta2_pow"] for s in st]
        torch._foreach_mul_(b1p, b1)
        torch._foreach_mul_(b2p, b2)
        torch._foreach_mul_(m1, b1)
        torch._foreach_add_(m1, grads, alpha=1 - b1)
        torch._foreach_mul_(m2, b2)
        torch._foreach_addcmul_(m2, grads, grads, value=1 - b2)
        bc1 = torch._foreach_add(torch._foreach_neg(b1p), 1.0)  # 1 - b1p
        bc2 = torch._foreach_add(torch._foreach_neg(b2p), 1.0)
        step = torch._foreach_div(m1, bc1)                     # m1_hat
        torch._foreach_mul_(step, lr)
        den = torch._foreach_sqrt(torch._foreach_div(m2, bc2))
        torch._foreach_add_(den, self._epsilon)
        torch._foreach_div_(step, den)
        torch._foreach_sub_(params, step)

    def _update(self, group: Dict[str, Any], named: _Named,
                grads: List[torch.Tensor], lr: float):
        self._adam([p for _, p in named], grads, lr)


class AdamW(Adam):
    """Decoupled weight decay (reference python/paddle/optimizer/adamw.py)."""

    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8, parameters=None,
                 weight_decay: float = 0.01, lr_ratio=None,
                 apply_decay_param_fun=None, grad_clip=None, lazy_mode=False,
                 multi_precision=False, name=None):
        if lr_ratio is not None:
            raise NotImplementedError("lr_ratio is not ported yet")
        self._coeff = float(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)

    def _coeff_of(self, group: Dict[str, Any], name) -> float:
        fn = self._apply_decay_param_fun
        if fn is not None:
            if name is None:
                raise ValueError(
                    "apply_decay_param_fun needs parameter names: pass "
                    "parameters=model.named_parameters()")
            if not fn(name):
                return 0.0
        return float(group.get("weight_decay", self._coeff))

    def _update(self, group: Dict[str, Any], named: _Named,
                grads: List[torch.Tensor], lr: float):
        # one foreach pass per distinct decay coefficient
        by_coeff: Dict[float, List[int]] = {}
        for i, (name, _) in enumerate(named):
            by_coeff.setdefault(self._coeff_of(group, name), []).append(i)
        for coeff, idx in by_coeff.items():
            params = [named[i][1] for i in idx]
            if coeff:
                torch._foreach_mul_(params, 1.0 - lr * coeff)
            self._adam(params, [grads[i] for i in idx], lr)
