"""MoE gates — the port of
``paddle_tpu/incubate/distributed/models/moe/gate.py``: naive top-k,
GShard top-2, Switch top-1 and expert choice.

Each gate routes the flattened tokens ``x (S, d)`` of one MoE layer. The
token-choice gates give the reference's two fixed-capacity forms of the
same decision:

- :meth:`NaiveGate.dispatch_plan`: the compact plan ``loc (S, K)`` (each
  assignment's flat slot ``e * C + pos`` in the ``(E, C)`` expert
  buffer, ``E * C`` for a dropped one) and ``w (S, K)`` (the routing
  weight, zero where dropped);
- :meth:`NaiveGate.dispatch_info`: the combine tensor ``(S, E, C)``
  (GShard's formulation), for gates that only implement it.

The slot order is the reference's (``gate.py:43-98``): choice-major, so
every first choice claims capacity before any second choice, and within
an expert the slot is the running count over token order. The capacity
of an expert is ``max(4, ceil(cap_rate * top_k * S / E))`` with the
(train, eval) factors chosen by ``self.training``.

Top-k picks use a stable descending sort, so among equal scores the
lower index comes first, as ``lax.top_k`` returns it (``torch.topk``
promises no order). Softmaxes of the GShard, Switch and expert-choice
gates run in fp32 and their weights come back in the logits' dtype
(bf16 under AMP: the gate's ``Linear`` is white-listed), as in the
reference. The draws of random routing (GShard's second choice, kept
with probability ``2 * p2`` in training) and of Switch's input jitter
come from the device's default generator, the stream dropout draws
from, so a recompute (``fleet.utils.recompute``, which saves and
restores it) replays the same routing; JAX's threefry bits are not
reproduced, only their distribution.
"""

from __future__ import annotations

import math

import torch

from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.layers.common import Linear

__all__ = ["BaseGate", "NaiveGate", "GShardGate", "SwitchGate",
           "ExpertChoiceGate"]


def _capacity(cap_rate: float, num_tokens: int, num_experts: int,
              top_k: int) -> int:
    return max(4, int(math.ceil(cap_rate * top_k * num_tokens / num_experts)))


def _top_k(x, k: int):
    """(values, indices) of the ``k`` largest along the last axis, the
    lower index first among equals (``lax.top_k``'s order)."""
    val, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def _one_hot(idx, n: int):
    """Boolean one-hot over a new last axis; a negative id (dropped)
    gives an all-false row, as ``jax.nn.one_hot`` does. A comparison, not
    ``F.one_hot``, which reads the ids' range back to the host on the
    card."""
    return idx.unsqueeze(-1) == torch.arange(n, device=idx.device,
                                             dtype=idx.dtype)


def _slots(idx, num_experts: int):
    """Every assignment's expert and slot: ``(e, pos, valid)``, each (S,
    K), for top-k assignments ``idx (S, K)`` (-1 = dropped). ``pos`` is
    the count of assignments to the same expert before it in
    choice-major order (all first choices, then all second ones, each in
    token order; ``gate.py:84-92``), so first choices claim capacity
    first. One running count over the (E, K * S) one-hot, along its
    contiguous axis."""
    S, K = idx.shape
    flat = idx.t().reshape(-1)                          # choice-major
    hot = (flat[None, :] == torch.arange(
        num_experts, device=idx.device,
        dtype=flat.dtype)[:, None]).int()               # (E, K * S)
    before = torch.cumsum(hot, dim=1, dtype=torch.int32) - hot
    e = flat.long().clamp(0, num_experts - 1)
    pos = torch.gather(before, 0, e[None, :])[0]
    return e.view(K, S).t(), pos.view(K, S).t(), idx >= 0


def _build_combine(idx, val, num_experts: int, capacity: int):
    """Fixed-capacity combine tensor ``(S, E, C)`` from top-k assignments
    ``idx (S, K)`` (-1 = dropped) and weights ``val (S, K)``
    (``gate.py:43``): ``val`` at each kept assignment's (token, expert,
    slot), zero elsewhere. Kept assignments own distinct cells, so the
    accumulating write adds each weight to zero (dropped ones add 0)."""
    S, K = idx.shape
    e, pos, valid = _slots(idx, num_experts)
    kept = valid & (pos < capacity)
    rows = torch.arange(S, device=idx.device)[:, None].expand(S, K)
    return torch.index_put(
        val.new_zeros((S, num_experts, capacity)),
        (rows.reshape(-1), e.reshape(-1),
         pos.clamp(max=capacity - 1).reshape(-1)),
        (val * kept.to(val.dtype)).reshape(-1), accumulate=True)


def _build_plan(idx, val, num_experts: int, capacity: int):
    """The compact dispatch plan ``(loc (S, K) int32, w (S, K))`` of the
    same assignments as :func:`_build_combine` (``gate.py:68``): each
    assignment's flat slot ``e * C + pos``, ``E * C`` when dropped, and
    its weight, zero when dropped."""
    e, pos, valid = _slots(idx, num_experts)
    kept = valid & (pos < capacity)
    loc = torch.where(kept, e * capacity + pos, num_experts * capacity)
    return loc.to(torch.int32), val * kept.to(val.dtype)


def _refuse_group(owner: str, group) -> None:
    if group is not None and getattr(group, "nranks", 1) > 1:
        raise NotImplementedError(
            f"{owner}: a group of {group.nranks} ranks needs expert "
            "parallelism over torch.distributed, ROADMAP Queue 1 item 6; "
            "the port routes on one device")


class BaseGate(Layer):
    """Score network and aux-loss slot (``gate.py:100``)."""

    def __init__(self, num_expert: int, world_size: int):
        super().__init__()
        self.world_size = world_size
        self.num_expert = num_expert
        self.tot_expert = world_size * num_expert
        self.loss = None

    def set_loss(self, loss):
        self.loss = loss

    def get_loss(self, clear: bool = True):
        loss = self.loss
        if clear:
            self.loss = None
        return loss

    def dispatch_info(self, x):
        """(combine (S, E, C), aux_loss) for flattened tokens ``x (S,
        d)``."""
        raise NotImplementedError


class NaiveGate(BaseGate):
    """Plain linear top-k gate, no aux loss (``gate.py:121``)."""

    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 topk: int = 2, capacity=(1.2, 2.4), *, device=None,
                 dtype=torch.float32):
        super().__init__(num_expert, world_size)
        self.gate = Linear(d_model, self.tot_expert,
                           device=resolve_device(device), dtype=dtype)
        self.top_k = topk
        self.capacity = capacity

    def forward(self, inp, return_all_scores: bool = False):
        score = self.gate(inp)
        val, idx = _top_k(score, self.top_k)
        idx = idx.to(torch.int32)
        if return_all_scores:
            return val, idx, score
        return val, idx

    def _cap(self, S: int) -> int:
        return _capacity(self.capacity[0 if self.training else 1], S,
                         self.tot_expert, self.top_k)

    def _routed(self, x):
        """(idx (S, K) int32 [-1 = dropped], weights (S, K), aux): the
        gate's routing decision, shared by both dispatch forms."""
        logits = self.gate(x)
        probs = torch.softmax(logits, dim=-1)
        val, idx = _top_k(probs, self.top_k)
        val = val / val.sum(dim=-1, keepdim=True)
        return idx.to(torch.int32), val, logits.new_zeros(())

    def dispatch_info(self, x):
        S, E = x.shape[0], self.tot_expert
        C = self._cap(S)
        idx, w, aux = self._routed(x)
        return _build_combine(idx, w, E, C), aux

    def dispatch_plan(self, x):
        """(loc (S, K), w (S, K), capacity, aux): the compact dispatch
        (``_build_plan``); the same assignments as ``dispatch_info``."""
        S, E = x.shape[0], self.tot_expert
        C = self._cap(S)
        idx, w, aux = self._routed(x)
        loc, wk = _build_plan(idx, w, E, C)
        return loc, wk, C, aux


class GShardGate(NaiveGate):
    """Top-2 gate with the load-balance aux loss ``mean(c_e * m_e) *
    E^2`` over the raw top-2 assignments (before random routing drops a
    second choice), capacity dropping, and in training random routing
    that keeps the second choice with probability ``2 * p2``
    (``gate.py:182``)."""

    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 topk: int = 2, capacity=(1.2, 2.4),
                 random_routing: bool = True, group=None, *, device=None,
                 dtype=torch.float32):
        assert topk == 2, "topk should be 2 in gshard"
        _refuse_group("GShardGate", group)
        super().__init__(d_model, num_expert, world_size, topk=topk,
                         capacity=capacity, device=device, dtype=dtype)
        self.random_routing = random_routing

    def _routed(self, x):
        S, E = x.shape[0], self.tot_expert
        logits = self.gate(x)
        probs = torch.softmax(logits.float(), dim=-1)
        val, idx = _top_k(probs, 2)
        # load-balance loss over the raw (pre-capacity) assignments
        c_e = _one_hot(idx, E).float().sum(dim=(0, 1)) / S
        m_e = probs.mean(dim=0)
        aux = (c_e * m_e).mean() * (E * E)
        if self.random_routing and self.training:
            u = torch.rand((S,), device=probs.device)
            keep2 = u < 2.0 * val[:, 1]
            idx = torch.stack([idx[:, 0], torch.where(
                keep2, idx[:, 1], torch.full_like(idx[:, 1], -1))], dim=1)
        norm = val / val.sum(dim=-1, keepdim=True).clamp(min=1e-9)
        return idx.to(torch.int32), norm.to(logits.dtype), aux


class SwitchGate(NaiveGate):
    """Top-1 gate with uniform ``(1 - eps, 1 + eps)`` input jitter in
    training and the aux loss ``sum(frac_e * prob_e) * E``
    (``gate.py:228``)."""

    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 topk: int = 1, switch_eps: float = 0.1,
                 capacity=(1.2, 2.4), group=None, *, device=None,
                 dtype=torch.float32):
        assert topk == 1, "topk should be 1 in switch"
        _refuse_group("SwitchGate", group)
        super().__init__(d_model, num_expert, world_size, topk=1,
                         capacity=capacity, device=device, dtype=dtype)
        self.switch_eps = switch_eps

    def _routed(self, x):
        S, E = x.shape[0], self.tot_expert
        if self.training:
            jitter = torch.empty_like(x).uniform_(1.0 - self.switch_eps,
                                                  1.0 + self.switch_eps)
            x = x * jitter
        logits = self.gate(x)
        probs = torch.softmax(logits.float(), dim=-1)
        val, idx = _top_k(probs, 1)
        frac = _one_hot(idx[:, 0], E).float().sum(dim=0) / S
        prob = probs.sum(dim=0) / S
        aux = (frac * prob).sum() * E
        return idx.to(torch.int32), val.to(logits.dtype), aux


class ExpertChoiceGate(BaseGate):
    """Expert-choice routing (Zhou et al. 2022; ``gate.py:274``): each
    expert picks its top-C tokens by affinity, so every expert processes
    exactly C tokens and there is no aux loss. A token may be chosen by
    several experts or by none."""

    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 capacity_factor: float = 2.0, *, device=None,
                 dtype=torch.float32):
        super().__init__(num_expert, world_size)
        self.gate = Linear(d_model, self.tot_expert,
                           device=resolve_device(device), dtype=dtype)
        self.capacity_factor = float(capacity_factor)

    def capacity_for(self, S: int) -> int:
        # clamped to S, so it always matches the plan's C
        return min(S, max(1, int(S * self.capacity_factor
                                 / self.tot_expert)))

    def dispatch_plan_ec(self, x):
        """Expert-major compact plan: (idx (E, C) token ids, val (E, C)
        affinities, aux)."""
        C = self.capacity_for(x.shape[0])
        logits = self.gate(x)
        probs = torch.softmax(logits.float(), dim=-1)
        val, idx = _top_k(probs.t(), C)
        return (idx.to(torch.int32), val.to(logits.dtype),
                probs.new_zeros(()))

    def dispatch_info(self, x):
        S, E = x.shape[0], self.tot_expert
        idx, val, aux = self.dispatch_plan_ec(x)
        C = idx.shape[1]
        combine = val.new_zeros((S, E, C))
        e = torch.arange(E, device=idx.device)[:, None].expand(E, C)
        c = torch.arange(C, device=idx.device)[None, :].expand(E, C)
        # each expert's C picks are distinct tokens: every write lands on
        # its own (s, e, c)
        combine[idx.long(), e, c] = val
        return combine, aux
