"""The ten optimizers of ``paddle_tpu/optimizer/optimizers.py``: SGD,
Momentum, Adagrad, Adam, AdamW, Adamax, RMSProp, Lars (``LarsMomentum``),
Lamb and Adadelta.

SGD is ``param - lr * grad``; Momentum keeps a ``velocity`` slot,
``v = momentum * v + grad``, and steps ``param - lr * v`` (Nesterov:
``param - lr * (grad + momentum * v)``). Each product is rounded to the
parameter's dtype before the subtraction, as the JAX rules compute it.

The rule is JAX ``Adam._update`` in the same order of operations, per
parameter with its own fp32 0-dim ``beta1_pow``/``beta2_pow`` slots:

    b1p *= beta1; b2p *= beta2
    m1 = beta1*m1 + (1-beta1)*g;  m2 = beta2*m2 + (1-beta2)*g^2
    param -= lr * (m1/(1-b1p)) / (sqrt(m2/(1-b2p)) + eps)

AdamW first multiplies the parameter by (1 - lr*coeff) (decoupled decay,
not folded into the gradient); ``apply_decay_param_fun(name)`` false
sets coeff to 0 for that parameter. Under ``multi_precision`` the
"parameter" of the rule is the fp32 master (``Optimizer.step``).

``lazy_mode`` (Adam, AdamW) and ``lr_ratio`` (AdamW) are accepted and
not acted on, as the reference accepts them (optimizers.py:93-143): with
dense gradients a lazy update is the dense one.

Adagrad, Adamax, RMSProp, Lamb and Adadelta take ``multi_precision``
keyword-only (the reference's lack it): a bf16 or fp16 parameter is then
updated through an fp32 master with fp32 state, as under Adam.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from paddle_tpu_torch.optimizer.optimizer import Optimizer, _Named

__all__ = ["SGD", "Momentum", "Adagrad", "Adadelta", "Adam", "AdamW",
           "Adamax", "RMSProp", "Lamb", "Lars", "LarsMomentum"]


class SGD(Optimizer):
    _state_slots = ()

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _update(self, group: Dict[str, Any], named: _Named,
                grads: List[torch.Tensor],
                states: List[Dict[str, torch.Tensor]], lr: float):
        torch._foreach_sub_([p for _, p in named],
                            torch._foreach_mul(grads, lr))


class Momentum(Optimizer):
    _state_slots = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum: float = 0.9,
                 parameters=None, use_nesterov: bool = False,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        self._momentum = float(momentum)
        self._nesterov = bool(use_nesterov)
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _update(self, group: Dict[str, Any], named: _Named,
                grads: List[torch.Tensor],
                states: List[Dict[str, torch.Tensor]], lr: float):
        v = [s["velocity"] for s in states]
        torch._foreach_mul_(v, self._momentum)
        torch._foreach_add_(v, grads)
        if self._nesterov:
            step = torch._foreach_mul(v, self._momentum)
            torch._foreach_add_(step, grads)
            torch._foreach_mul_(step, lr)
        else:
            step = torch._foreach_mul(v, lr)
        torch._foreach_sub_([p for _, p in named], step)


class Adam(Optimizer):
    _state_slots = ("moment1", "moment2", "beta1_pow", "beta2_pow")

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8, parameters=None,
                 weight_decay=None, grad_clip=None, lazy_mode: bool = False,
                 multi_precision: bool = False, name=None):
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _init_state_from_value(self, raw: torch.Tensor
                               ) -> Dict[str, torch.Tensor]:
        one = torch.ones((), dtype=torch.float32, device=raw.device)
        return {"moment1": torch.zeros_like(raw),
                "moment2": torch.zeros_like(raw),
                "beta1_pow": one, "beta2_pow": one.clone()}

    def _adam(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              st: List[Dict[str, torch.Tensor]], lr: float):
        b1, b2 = self._beta1, self._beta2
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
                grads: List[torch.Tensor],
                states: List[Dict[str, torch.Tensor]], lr: float):
        self._adam([p for _, p in named], grads, states, lr)


class AdamW(Adam):
    """Decoupled weight decay (reference python/paddle/optimizer/adamw.py)."""

    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8, parameters=None,
                 weight_decay: float = 0.01, lr_ratio=None,
                 apply_decay_param_fun=None, grad_clip=None, lazy_mode=False,
                 multi_precision=False, name=None):
        self._coeff = float(getattr(weight_decay, "coeff", weight_decay))
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
                grads: List[torch.Tensor],
                states: List[Dict[str, torch.Tensor]], lr: float):
        # one foreach pass per distinct decay coefficient
        by_coeff: Dict[float, List[int]] = {}
        for i, (name, _) in enumerate(named):
            by_coeff.setdefault(self._coeff_of(group, name), []).append(i)
        for coeff, idx in by_coeff.items():
            params = [named[i][1] for i in idx]
            if coeff:
                torch._foreach_mul_(params, 1.0 - lr * coeff)
            self._adam(params, [grads[i] for i in idx],
                       [states[i] for i in idx], lr)


# -- the per-parameter rules of the other six optimizers ----------------------
#
# Each keeps the reference's state slot names (checkpoints in its format
# carry them) and its order of operations, over ``torch._foreach_*`` on
# every parameter of a group at once. ``lr`` is the group's Python float;
# a 0-dim fp32 slot (``beta1_pow``) stays a tensor on the device, so a
# step reads nothing back. Lars and Lamb need one fp32 norm a parameter:
# ``torch._foreach_norm`` gives them all in one launch, stacked into one
# vector for the trust-ratio arithmetic.


class _NamedParam:
    """What Lamb's ``exclude_from_weight_decay_fn`` is called with: the
    parameter's tensor (its compute value) under the name the optimizer
    knows it by. A torch tensor's own ``name`` is read-only and None, and
    the reference hands the function a parameter with a ``name``."""

    __slots__ = ("name", "_t")

    def __init__(self, name, tensor):
        self.name = name if name is not None else ""
        self._t = tensor

    def __getattr__(self, attr):
        return getattr(self._t, attr)


def _scalars(values: torch.Tensor) -> List[torch.Tensor]:
    """A vector of per-parameter factors as 0-dim tensors for foreach."""
    return list(values.unbind())


def _fp32(ts: List[torch.Tensor]) -> List[torch.Tensor]:
    """fp32 views of ``ts`` (the tensors themselves when fp32)."""
    return [t if t.dtype == torch.float32 else t.float() for t in ts]


def _write_back(dst: List[torch.Tensor], src: List[torch.Tensor]):
    """Round ``src`` into ``dst`` where the rule ran on fp32 copies."""
    pairs = [(d, s) for d, s in zip(dst, src) if d is not s]
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


class Adagrad(Optimizer):
    """``m += g^2; param -= lr * g / (sqrt(m) + epsilon)``; ``moment``
    starts at ``initial_accumulator_value``."""

    _state_slots = ("moment",)

    def __init__(self, learning_rate, epsilon: float = 1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value: float = 0.0, *,
                 multi_precision: bool = False):
        self._epsilon = float(epsilon)
        self._init_acc = float(initial_accumulator_value)
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _init_state_from_value(self, raw: torch.Tensor
                               ) -> Dict[str, torch.Tensor]:
        return {"moment": torch.full_like(raw, self._init_acc)}

    def _update(self, group: Dict[str, Any], named: _Named,
                grads: List[torch.Tensor],
                states: List[Dict[str, torch.Tensor]], lr: float):
        m = [s["moment"] for s in states]
        torch._foreach_addcmul_(m, grads, grads)
        step = torch._foreach_mul(grads, lr)
        den = torch._foreach_sqrt(m)
        torch._foreach_add_(den, self._epsilon)
        torch._foreach_div_(step, den)
        torch._foreach_sub_([p for _, p in named], step)


class Adamax(Optimizer):
    """``b1p *= beta1; m = beta1 m + (1 - beta1) g; inf = max(beta2 inf,
    |g|); param -= lr / (1 - b1p) * m / (inf + epsilon)``."""

    _state_slots = ("moment", "inf_norm", "beta1_pow")

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, *,
                 multi_precision: bool = False):
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _init_state_from_value(self, raw: torch.Tensor
                               ) -> Dict[str, torch.Tensor]:
        return {"moment": torch.zeros_like(raw),
                "inf_norm": torch.zeros_like(raw),
                "beta1_pow": torch.ones((), dtype=torch.float32,
                                        device=raw.device)}

    def _update(self, group: Dict[str, Any], named: _Named,
                grads: List[torch.Tensor],
                states: List[Dict[str, torch.Tensor]], lr: float):
        b1, b2 = self._beta1, self._beta2
        m = [s["moment"] for s in states]
        inf = [s["inf_norm"] for s in states]
        b1p = [s["beta1_pow"] for s in states]
        torch._foreach_mul_(b1p, b1)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(inf, b2)
        torch._foreach_maximum_(inf, torch._foreach_abs(grads))
        # lr / (1 - b1p), one fp32 factor a parameter
        coef = torch._foreach_reciprocal(
            torch._foreach_add(torch._foreach_neg(b1p), 1.0))
        torch._foreach_mul_(coef, lr)
        step = torch._foreach_mul(m, coef)
        den = torch._foreach_add(inf, self._epsilon)
        torch._foreach_div_(step, den)
        torch._foreach_sub_([p for _, p in named], step)


class RMSProp(Optimizer):
    """``ms = rho ms + (1 - rho) g^2``; centered: ``mg = rho mg + (1 -
    rho) g`` and ``denom = sqrt(ms - mg^2 + epsilon)``, else ``sqrt(ms +
    epsilon)``; ``mom = momentum mom + lr g / denom; param -= mom``."""

    _state_slots = ("mean_square", "mean_grad", "momentum")

    def __init__(self, learning_rate, rho: float = 0.95, epsilon: float = 1e-6,
                 momentum: float = 0.0, centered: bool = False,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, *, multi_precision: bool = False):
        self._rho = float(rho)
        self._epsilon = float(epsilon)
        self._momentum = float(momentum)
        self._centered = bool(centered)
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _update(self, group: Dict[str, Any], named: _Named,
                grads: List[torch.Tensor],
                states: List[Dict[str, torch.Tensor]], lr: float):
        rho = self._rho
        ms = [s["mean_square"] for s in states]
        mom = [s["momentum"] for s in states]
        torch._foreach_mul_(ms, rho)
        torch._foreach_addcmul_(ms, grads, grads, value=1 - rho)
        if self._centered:
            mg = [s["mean_grad"] for s in states]
            torch._foreach_mul_(mg, rho)
            torch._foreach_add_(mg, grads, alpha=1 - rho)
            den = torch._foreach_sub(ms, torch._foreach_mul(mg, mg))
        else:
            den = torch._foreach_add(ms, 0.0)
        torch._foreach_add_(den, self._epsilon)
        torch._foreach_sqrt_(den)
        step = torch._foreach_mul(grads, lr)
        torch._foreach_div_(step, den)
        torch._foreach_mul_(mom, self._momentum)
        torch._foreach_add_(mom, step)
        torch._foreach_sub_([p for _, p in named], mom)


class Lars(Optimizer):
    """LARS momentum, layer-wise adaptive rate scaling for large-batch
    SGD, in fp32 whatever the parameter's dtype:

        local_lr = lr * coeff * ||w|| / (||g|| + decay * ||w|| + eps)
                   (lr where either norm is 0)
        v        = mu * v + local_lr * (g + decay * w)
        w        = w - v

    ``exclude_from_weight_decay`` lists substrings of parameter names
    (the names of ``parameters=model.named_parameters()``) whose decay is
    0; an unnamed parameter matches nothing."""

    _state_slots = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum: float = 0.9,
                 lars_coeff: float = 0.001, lars_weight_decay: float = 0.0005,
                 parameters=None, exclude_from_weight_decay=None,
                 epsilon: float = 1e-9, grad_clip=None, name=None,
                 multi_precision=False):
        self._momentum = float(momentum)
        self._lars_coeff = float(lars_coeff)
        self._lars_decay = float(lars_weight_decay)
        self._lars_eps = float(epsilon)
        self._exclude = list(exclude_from_weight_decay or [])
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)

    def _decay_of(self, group: Dict[str, Any], name) -> float:
        if any(tag in (name or "") for tag in self._exclude):
            return 0.0
        return float(group.get("lars_weight_decay", self._lars_decay))

    def _update(self, group: Dict[str, Any], named: _Named,
                grads: List[torch.Tensor],
                states: List[Dict[str, torch.Tensor]], lr: float):
        params = [p for _, p in named]
        vel = [s["velocity"] for s in states]
        pf, gf, vf = _fp32(params), _fp32(grads), _fp32(vel)
        decay = [self._decay_of(group, name) for name, _ in named]
        pn = torch.stack(torch._foreach_norm(pf, 2))
        gn = torch.stack(torch._foreach_norm(gf, 2))
        dec = torch.tensor(decay, dtype=torch.float32, device=pn.device)
        local = torch.where((pn > 0) & (gn > 0),
                            lr * self._lars_coeff * pn
                            / (gn + dec * pn + self._lars_eps),
                            torch.full_like(pn, lr))
        upd = torch._foreach_add(gf, torch._foreach_mul(pf, decay))
        torch._foreach_mul_(upd, _scalars(local))
        torch._foreach_mul_(vf, self._momentum)
        torch._foreach_add_(vf, upd)
        torch._foreach_sub_(pf, vf)
        _write_back(params, pf)
        _write_back(vel, vf)


LarsMomentum = Lars


class Lamb(Optimizer):
    """Layer-wise adaptive moments: Adam's moments with a decay term,
    scaled by the trust ratio ``||w|| / ||update||`` (1 where either norm
    is 0):

        update = m1_hat / (sqrt(m2_hat) + epsilon) + decay * w
        w     -= ratio * lr * update

    ``exclude_from_weight_decay_fn(param)`` true zeroes the decay; the
    function is given the parameter under its name (``param.name``)."""

    _state_slots = ("moment1", "moment2", "beta1_pow", "beta2_pow")

    def __init__(self, learning_rate=0.001, lamb_weight_decay: float = 0.01,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, name=None, *,
                 multi_precision: bool = False):
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._lamb_decay = float(lamb_weight_decay)
        self._exclude_fn = exclude_from_weight_decay_fn
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)

    def _init_state_from_value(self, raw: torch.Tensor
                               ) -> Dict[str, torch.Tensor]:
        one = torch.ones((), dtype=torch.float32, device=raw.device)
        return {"moment1": torch.zeros_like(raw),
                "moment2": torch.zeros_like(raw),
                "beta1_pow": one, "beta2_pow": one.clone()}

    def _update(self, group: Dict[str, Any], named: _Named,
                grads: List[torch.Tensor],
                states: List[Dict[str, torch.Tensor]], lr: float):
        b1, b2 = self._beta1, self._beta2
        params = [p for _, p in named]
        fn = self._exclude_fn
        base = float(group.get("lamb_decay", self._lamb_decay))
        decay = [0.0 if fn is not None and fn(_NamedParam(name, p))
                 else base for name, p in named]
        m1 = [s["moment1"] for s in states]
        m2 = [s["moment2"] for s in states]
        b1p = [s["beta1_pow"] for s in states]
        b2p = [s["beta2_pow"] for s in states]
        torch._foreach_mul_(b1p, b1)
        torch._foreach_mul_(b2p, b2)
        torch._foreach_mul_(m1, b1)
        torch._foreach_add_(m1, grads, alpha=1 - b1)
        torch._foreach_mul_(m2, b2)
        torch._foreach_addcmul_(m2, grads, grads, value=1 - b2)
        bc1 = torch._foreach_add(torch._foreach_neg(b1p), 1.0)
        bc2 = torch._foreach_add(torch._foreach_neg(b2p), 1.0)
        upd = torch._foreach_div(m1, bc1)                      # m1_hat
        den = torch._foreach_sqrt(torch._foreach_div(m2, bc2))
        torch._foreach_add_(den, self._epsilon)
        torch._foreach_div_(upd, den)
        torch._foreach_add_(upd, torch._foreach_mul(params, decay))
        wn = torch.stack(torch._foreach_norm(_fp32(params), 2))
        un = torch.stack(torch._foreach_norm(_fp32(upd), 2))
        ratio = torch.where((wn > 0) & (un > 0), wn / un,
                            torch.ones_like(wn)) * lr
        torch._foreach_mul_(upd, _scalars(ratio.to(params[0].dtype)))
        torch._foreach_sub_(params, upd)


class Adadelta(Optimizer):
    """``g2 = rho g2 + (1 - rho) g^2; upd = sqrt(u2 + epsilon) / sqrt(g2
    + epsilon) * g; u2 = rho u2 + (1 - rho) upd^2; param -= lr * upd``."""

    _state_slots = ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate=0.001, epsilon: float = 1e-6,
                 rho: float = 0.95, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, *, multi_precision: bool = False):
        self._epsilon = float(epsilon)
        self._rho = float(rho)
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _update(self, group: Dict[str, Any], named: _Named,
                grads: List[torch.Tensor],
                states: List[Dict[str, torch.Tensor]], lr: float):
        rho, eps = self._rho, self._epsilon
        g2 = [s["avg_squared_grad"] for s in states]
        u2 = [s["avg_squared_update"] for s in states]
        torch._foreach_mul_(g2, rho)
        torch._foreach_addcmul_(g2, grads, grads, value=1 - rho)
        upd = torch._foreach_sqrt(torch._foreach_add(u2, eps))
        torch._foreach_div_(upd, torch._foreach_sqrt(
            torch._foreach_add(g2, eps)))
        torch._foreach_mul_(upd, grads)
        torch._foreach_mul_(u2, rho)
        torch._foreach_addcmul_(u2, upd, upd, value=1 - rho)
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_([p for _, p in named], upd)
