"""Request-queue policy of the serving engine.

The port's own copy of ``paddle_tpu/inference/frontend/scheduler.py``:
the :class:`Scheduler` contract (:45) and :class:`FifoScheduler`
(:164). The engine calls exactly these methods between ticks; the
kernels never see a policy. ``FairScheduler`` and replica placement are
later slices.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Optional, Sequence, Tuple

__all__ = ["Scheduler", "FifoScheduler"]


class Scheduler:
    """Queue-policy contract consumed by ``ServingEngine``.

    A *due* request is one whose ``arrival_time`` offset has passed.
    ``next_due`` PEEKS the policy's pick; the engine then ``pop``\\ s it
    (admission proceeding) or leaves it queued. ``requeue`` re-inserts a
    request at the FRONT of the order — a preempted request resuming, or
    an admission that could not get blocks. ``on_tick`` is called once
    per engine tick."""

    tick: int = 0

    def submit(self, req) -> None:
        raise NotImplementedError

    def requeue(self, req) -> None:
        raise NotImplementedError

    def next_due(self, now: float):
        raise NotImplementedError

    def pop(self, req) -> None:
        raise NotImplementedError

    def depth(self) -> int:
        raise NotImplementedError

    def pending(self) -> list:
        """Snapshot of every queued request (no particular order)."""
        raise NotImplementedError

    def due_count(self, now: float) -> int:
        raise NotImplementedError

    def next_arrival(self, now: float) -> Optional[float]:
        raise NotImplementedError

    def on_tick(self, now: Optional[float] = None) -> None:
        self.tick += 1

    def select_victim(self, cands: Sequence[Tuple[int, Any, int]],
                      now: float) -> Optional[int]:
        """Pick the preemption victim among ``(slot, request,
        admission_seq)`` candidates; returns the slot index."""
        raise NotImplementedError


class FifoScheduler(Scheduler):
    """Strict submission order with head-of-line admission (a due
    request behind a future head waits), preempted requests resume at
    the head, and the preemption victim is the newest-admitted slot."""

    def __init__(self):
        self.tick = 0
        self._q: deque = deque()

    def submit(self, req) -> None:
        self._q.append(req)

    def requeue(self, req) -> None:
        self._q.appendleft(req)

    def next_due(self, now: float):
        if self._q and self._q[0].arrival_time <= now:
            return self._q[0]
        return None

    def pop(self, req) -> None:
        if self._q and self._q[0] is req:
            self._q.popleft()
        else:
            self._q.remove(req)

    def depth(self) -> int:
        return len(self._q)

    def pending(self) -> list:
        return list(self._q)

    def due_count(self, now: float) -> int:
        n = 0
        for r in list(self._q):   # FIFO: stop at the first future arrival
            if r.arrival_time > now:
                break
            n += 1
        return n

    def next_arrival(self, now: float) -> Optional[float]:
        return self._q[0].arrival_time if self._q else None

    def select_victim(self, cands, now):
        return max(cands, key=lambda c: c[2])[0] if cands else None
