"""Deterministic fault injection — the port of
``paddle_tpu/testing/fault_injection.py``.

The port exposes the reference's named *fault points*: the window
between a checkpoint's shard writes and its COMMIT marker
(``ckpt:pre_commit``), each host-barrier attempt (``ckpt:host_barrier``),
each shard-file write (``ckpt:shard_write``) and the training batch
entering the step (``trainer:batch``). A fault point is one call into
this module's registry; with nothing armed it is a test of an empty
dict, so the production overhead is nil.

The serving stack's fault points, the chaos harness's hooks into the
inference engine:

- ``serving:alloc`` — every :meth:`BlockAllocator.alloc` grant (``n=``,
  ``free=``): raise to simulate an allocator failure during admission
  or lazy decode growth;
- ``serving:prefix_splice`` / ``serving:prefix_copy`` — the per-request
  prefix-cache seeding in ``ServingEngine._admit`` (``rid=``,
  ``slot=``): raise to fault one request's splice or copy;
- ``serving:prefill_chunk`` — each request's chunk-prefill turn
  (``rid=``, ``slot=``);
- ``serving:dispatch`` — every program dispatch through
  :class:`~paddle_tpu_torch.inference.program_set.ProgramSet`
  (``program=``, ``attempt=``): raise to simulate a transient dispatch
  error (the bounded retry absorbs it), sleep to trip the stall
  watchdog;
- ``serving:tick`` — the top of every ``ServingEngine.step_decode``
  tick (``engine=``, ``step=``): raise to crash mid-tick (the
  engine-scoped circuit breaker), or use :func:`nan_kv` to poison one
  slot's committed KV and trip the NaN-logit guard;
- ``serving:spill_write`` — every host-tier block write
  (``HostTier.write``, ``n=``): the victim degrades to re-prefill;
- ``serving:swap_in`` — every host-to-device block restore
  (``DecodeEngine.restore_blocks``, ``n=``): fires before any device
  write, and the resumed request falls back to a full re-prefill.

Tests arm injectors with the :func:`inject` context manager:

    with inject("ckpt:pre_commit", raise_(InjectedCrash()), times=1):
        checkpoint.save_state(...)  # dies after writing shards,
                                    # before committing

Injection is deterministic: triggers are expressed over the context the
fault point passes (``step=k``, ``version=...``), never over wall clock
or randomness, so every resilience test replays identically.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

__all__ = ["InjectedCrash", "Injector", "inject", "fault_point", "transform",
           "raise_", "sleep_", "nan_batch", "nan_kv", "simulate_preemption",
           "armed"]


class InjectedCrash(BaseException):
    """Simulated process death (e.g. preemption mid-checkpoint).

    Deliberately a ``BaseException``: retry loops that catch
    ``Exception`` must NOT absorb a simulated crash — it has to
    propagate like a real SIGKILL would end the process.
    """


_LOCK = threading.RLock()
_REGISTRY: Dict[str, List["Injector"]] = {}


class Injector:
    """One armed fault: fires ``action(ctx)`` when ``when(ctx)`` holds,
    at most ``times`` times (None = unlimited)."""

    def __init__(self, action: Callable[[Dict[str, Any]], Any],
                 when: Optional[Callable[[Dict[str, Any]], bool]] = None,
                 times: Optional[int] = None):
        self.action = action
        self.when = when
        self.times = times
        self.fired = 0

    def maybe_fire(self, ctx: Dict[str, Any]):
        if self.times is not None and self.fired >= self.times:
            return None, False
        if self.when is not None and not self.when(ctx):
            return None, False
        self.fired += 1
        return self.action(ctx), True


def armed(name: str) -> bool:
    return bool(_REGISTRY.get(name))


def fault_point(name: str, **ctx) -> None:
    """Production-side hook: run every armed injector for ``name``.
    Actions may raise or sleep; their return values are ignored here
    (value-rewriting faults go through :func:`transform`)."""
    if not _REGISTRY:
        return
    with _LOCK:
        injectors = list(_REGISTRY.get(name, ()))
    for inj in injectors:
        inj.maybe_fire(ctx)


def transform(name: str, value, **ctx):
    """Production-side hook for value-rewriting faults: each firing
    injector maps ``value`` through its action's return."""
    if not _REGISTRY:
        return value
    with _LOCK:
        injectors = list(_REGISTRY.get(name, ()))
    for inj in injectors:
        ctx["value"] = value
        out, fired = inj.maybe_fire(ctx)
        if fired:
            value = out
    return value


@contextmanager
def inject(name: str, action: Callable[[Dict[str, Any]], Any],
           when: Optional[Callable[[Dict[str, Any]], bool]] = None,
           times: Optional[int] = None):
    """Arm ``action`` at fault point ``name`` for the with-block; yields
    the :class:`Injector` so tests can assert ``.fired``."""
    inj = Injector(action, when=when, times=times)
    with _LOCK:
        _REGISTRY.setdefault(name, []).append(inj)
    try:
        yield inj
    finally:
        with _LOCK:
            _REGISTRY[name].remove(inj)
            if not _REGISTRY[name]:
                del _REGISTRY[name]


# -- canned actions ----------------------------------------------------------

def raise_(exc: BaseException) -> Callable:
    """Action: raise ``exc`` (an instance, re-raised each firing)."""

    def action(ctx):
        raise exc

    return action


def sleep_(seconds: float) -> Callable:
    """Action: stall (slow host barrier / slow IO simulation)."""

    def action(ctx):
        time.sleep(seconds)

    return action


def _poison(leaf):
    if isinstance(leaf, torch.Tensor):
        return (torch.full_like(leaf, float("nan"))
                if leaf.is_floating_point() else leaf)
    if isinstance(leaf, (tuple, list)):
        return type(leaf)(_poison(x) for x in leaf)
    if isinstance(leaf, dict):
        return {k: _poison(v) for k, v in leaf.items()}
    arr = np.asarray(leaf)
    if np.issubdtype(arr.dtype, np.floating):
        return np.full_like(arr, np.nan)
    return leaf


def nan_batch() -> Callable:
    """Transform action for ``trainer:batch``: poison every floating
    torch tensor or numpy leaf with NaN (integer leaves, such as token
    ids, are left alone), producing NaN loss and gradients through the
    real step."""

    def action(ctx):
        return _poison(ctx["value"])

    return action


def nan_kv(slot: int) -> Callable:
    """Action for ``serving:tick``: poison arena ``slot``'s committed KV
    storage with NaN (``ServingEngine.poison_slot_kv``), so the slot's
    next logits go non-finite through the real kernels — the NaN-logit
    guard's trigger condition, scoped to exactly one request the way
    real storage corruption would be."""

    def action(ctx):
        ctx["engine"].poison_slot_kv(slot)

    return action


def simulate_preemption() -> None:
    """Deliver a real SIGTERM to this process (the preemption notice
    path); handlers installed by CheckpointManager run."""
    import os
    import signal

    os.kill(os.getpid(), signal.SIGTERM)
