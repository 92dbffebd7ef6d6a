"""Pluggable request-queue policies of the serving engine.

The port's copy of ``paddle_tpu/inference/frontend/scheduler.py``: the
:class:`Scheduler` contract (:45), :class:`FifoScheduler` (:164),
:class:`Tenant` (:230) and :class:`FairScheduler` (:265). The engine
calls exactly these methods between ticks; the kernels never see a
policy.

- :class:`FifoScheduler` — strict submission order, head-of-line
  admission, preempted requests back at the head, the newest-admitted
  slot as the preemption victim. The engine's default.
- :class:`FairScheduler` — the multi-tenant policy: per-tenant lanes
  ordered by due time, priority tiers (a lower tier wins), weighted
  fair queuing within a tier (start-time fair queuing over a
  token-cost virtual clock), a HARD starvation bound in engine ticks,
  and deadline-aware preemption victims (lowest priority, then most
  deadline slack, then newest). Scheduling delays are counted in
  engine ticks per tier (``max_delay_ticks``).

Both are pure host code and decide as the reference does, decision for
decision. The reference's replica placement seams (``select_slot``,
``select_seq_parallel``) arrive with the replica mesh. All mutating
calls happen under the engine's lock.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["Scheduler", "FifoScheduler", "FairScheduler", "Tenant"]


class Scheduler:
    """Queue-policy contract consumed by ``ServingEngine``.

    A *due* request is one whose ``arrival_time`` offset has passed.
    ``next_due`` PEEKS the policy's current pick; the engine then
    either ``pop``\\ s it (admission proceeding) or leaves it queued.
    ``requeue`` re-inserts a request at the FRONT of the policy's
    order — used for preempted requests resuming and for an admission
    that could not get blocks — and must not re-charge any fairness
    accounting. ``on_tick`` is called once per engine tick; tick
    counts are the unit of the starvation bound.
    """

    tick: int = 0

    def submit(self, req) -> None:
        raise NotImplementedError

    def requeue(self, req) -> None:
        raise NotImplementedError

    def next_due(self, now: float):
        raise NotImplementedError

    def pop(self, req) -> None:
        raise NotImplementedError

    def remove(self, req) -> bool:
        raise NotImplementedError

    def pop_expired(self, now: float) -> List[Any]:
        raise NotImplementedError

    def depth(self) -> int:
        raise NotImplementedError

    def pending(self) -> List[Any]:
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
    """The engine's historical policy, extracted verbatim: strict
    submission order with head-of-line admission (a due request behind
    a future head WAITS — open-loop traces are submitted in arrival
    order, so this never bites them), preempted requests resume at the
    head, and the preemption victim is the newest-admitted slot."""

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

    def remove(self, req) -> bool:
        try:
            self._q.remove(req)
            return True
        except ValueError:
            return False

    def pop_expired(self, now: float) -> List[Any]:
        out = [r for r in self._q
               if r.deadline is not None and now > r.deadline]
        for r in out:
            self._q.remove(r)
        return out

    def depth(self) -> int:
        return len(self._q)

    def pending(self) -> List[Any]:
        return list(self._q)

    def due_count(self, now: float) -> int:
        n = 0
        # list() snapshot: a cross-thread submit() appending mid-count
        # must not raise "deque mutated during iteration"
        for r in list(self._q):  # FIFO: stop at the first future arrival
            if r.arrival_time > now:
                break
            n += 1
        return n

    def next_arrival(self, now: float) -> Optional[float]:
        return self._q[0].arrival_time if self._q else None

    def select_victim(self, cands, now):
        return max(cands, key=lambda c: c[2])[0] if cands else None


@dataclass
class Tenant:
    """One tenant's scheduling configuration.

    ``weight`` sets the tenant's fair share WITHIN its tier (2.0 gets
    ~2x the admissions of 1.0 under contention). ``tier`` is the
    priority class — LOWER numbers are served first; a tier is starved
    only up to the scheduler's starvation bound. ``max_queue_depth``
    caps the tenant's queued (not running) requests; ``None`` defers
    to the front door's global/default caps."""

    name: str
    weight: float = 1.0
    tier: int = 0
    max_queue_depth: Optional[int] = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.name!r}: weight must be > 0, got "
                f"{self.weight}")
        if self.tier < 0:
            raise ValueError(
                f"tenant {self.name!r}: tier must be >= 0, got "
                f"{self.tier}")


class _Entry:
    __slots__ = ("req", "seq", "due_tick")

    def __init__(self, req, seq):
        self.req = req
        self.seq = seq
        self.due_tick: Optional[int] = None


class FairScheduler(Scheduler):
    """Per-tenant weighted fair queuing with priority tiers, a hard
    starvation bound, and SLO-aware preemption victims.

    Pick order for the next admission, evaluated over each tenant's
    DUE head (within a tenant, requests are ordered by (arrival_time,
    submission seq) — a live late submission that is already due
    overtakes a queued future arrival, unlike strict FIFO):

    1. resumed requests (preempted, or bounced off a full block pool)
       — absolute priority, preserving the engine's historical
       head-of-line resume semantics;
    2. any head whose age since first becoming schedulable is >=
       ``starvation_bound`` ticks — oldest such first. This is the
       HARD bound: no tier mix can delay a due request further;
    3. the lowest tier with a due head;
    4. within that tier, the tenant with the smallest virtual time
       (start-time fair queuing: popping a request advances its
       tenant's clock by ``(prompt + max_new_tokens) / weight``, and
       an idling tenant's clock is lifted to the floor on its next
       pop, so sleeping never banks credit);
    5. ties by submission order.

    ``max_delay_ticks`` records, per tier, the worst observed
    admission delay in engine ticks (due -> pop) — the counted
    starvation metric the CI gate pins. Unknown tenant names get a
    default ``Tenant`` on first use (weight 1, tier 0).

    Batch surfaces: ``score``/``embed`` requests are
    throughput work — they retire at prefill completion and hold no
    decode slot, so they should soak idle capacity, not contend with
    interactive decode. They are scheduled in ``throughput_tier``
    (default: one below the lowest configured tenant tier) regardless
    of the submitting tenant's tier; an explicit per-request
    ``priority`` still overrides, and the starvation bound applies to
    this tier like any other, so a scoring backlog is delayed by at
    most ``starvation_bound`` ticks under sustained interactive load.
    The same tier drives ``select_victim``, making batch work the
    preferred preemption victim during a pool shortage.

    Batch requests queue in a per-tenant SUB-queue (``next_due`` only
    compares queue heads, so a scoring request at a shared head would
    block the same tenant's interactive work behind it regardless of
    tier); both sub-queues charge the one tenant virtual-time clock.
    """

    _BATCH_SUFFIX = "\x00batch"     # cannot collide with tenant names

    def __init__(self, tenants: Optional[Sequence[Tenant]] = None,
                 starvation_bound: int = 64,
                 throughput_tier: Optional[int] = None):
        if starvation_bound < 1:
            raise ValueError(
                f"starvation_bound must be >= 1 tick, got "
                f"{starvation_bound}")
        self.tick = 0
        self.starvation_bound = int(starvation_bound)
        self.throughput_tier = (None if throughput_tier is None
                                else int(throughput_tier))
        self.tenants: Dict[str, Tenant] = {}
        for t in tenants or []:
            if t.name in self.tenants:
                raise ValueError(f"duplicate tenant {t.name!r}")
            self.tenants[t.name] = t
        self._queues: Dict[str, List[_Entry]] = {}
        self._front: deque = deque()          # resumed/preempted reqs
        self._vtime: Dict[str, float] = {}
        self._vfloor = 0.0
        self._seq = 0
        # counted scheduling-delay stats (engine ticks, due -> pop)
        self.max_delay_ticks: Dict[int, int] = {}
        self.admitted_by_tenant: Dict[str, int] = {}

    def on_tick(self, now: Optional[float] = None) -> None:
        """Advance the tick clock AND stamp newly-due heads: the
        due->pop delay (and the starvation aging it drives) must keep
        counting through fully-saturated stretches, when ``next_due``
        is never consulted because no slot is free — otherwise the
        counted starvation metric starts only once a slot opens and a
        real starvation regression under saturation stays invisible."""
        self.tick += 1
        if now is None:
            return
        for q in list(self._queues.values()):
            if q and q[0].due_tick is None \
                    and q[0].req.arrival_time <= now:
                q[0].due_tick = self.tick

    def tenant(self, name: str) -> Tenant:
        t = self.tenants.get(name)
        if t is None:
            t = Tenant(name)
            self.tenants[name] = t
        return t

    def _tier(self, req) -> int:
        if getattr(req, "priority", None) is not None:
            return int(req.priority)
        if getattr(req, "kind", "generate") in ("score", "embed"):
            if self.throughput_tier is not None:
                return self.throughput_tier
            # default: one tier below the lowest-priority configured
            # tenant (recomputed per call — tenants auto-register)
            tiers = [t.tier for t in self.tenants.values()]
            return (max(tiers) + 1) if tiers else 1
        return self.tenant(req.tenant).tier

    def _qname(self, req) -> str:
        """Queue key: the tenant, or its batch sub-queue for
        score/embed work (a per-request ``priority`` opts back into
        the interactive queue, matching ``_tier``)."""
        name = getattr(req, "tenant", "default")
        if getattr(req, "priority", None) is None and \
                getattr(req, "kind", "generate") in ("score", "embed"):
            return name + self._BATCH_SUFFIX
        return name

    @classmethod
    def _tenant_of(cls, qname: str) -> str:
        return qname.split("\x00", 1)[0]

    # -- queue ops --------------------------------------------------------
    def submit(self, req) -> None:
        self.tenant(getattr(req, "tenant", "default"))  # auto-register
        q = self._queues.setdefault(self._qname(req), [])
        e = _Entry(req, self._seq)
        self._seq += 1
        # insertion sort by (arrival_time, seq): queues are short and
        # live traffic arrives nearly sorted, so this is O(1) amortized
        i = len(q)
        while i > 0 and (q[i - 1].req.arrival_time, q[i - 1].seq) > \
                (req.arrival_time, e.seq):
            i -= 1
        q.insert(i, e)

    def requeue(self, req) -> None:
        self._front.appendleft(req)

    def next_due(self, now: float):
        if self._front:
            return self._front[0]
        starved = None          # (due_tick, seq, req)
        best = None             # (tier, vtime, seq, req)
        for name in list(self._queues):
            q = self._queues[name]
            if not q:
                continue
            e = q[0]
            if e.req.arrival_time > now:
                continue
            if e.due_tick is None:
                e.due_tick = self.tick
            if self.tick - e.due_tick >= self.starvation_bound:
                key = (e.due_tick, e.seq)
                if starved is None or key < starved[:2]:
                    starved = (*key, e.req)
                continue
            vt = max(self._vtime.get(self._tenant_of(name), 0.0),
                     self._vfloor)
            key = (self._tier(e.req), vt, e.seq)
            if best is None or key < best[:3]:
                best = (*key, e.req)
        if starved is not None:
            return starved[2]
        return best[3] if best is not None else None

    def pop(self, req) -> None:
        if self._front:
            try:
                self._front.remove(req)
                return      # resumes carry no new fairness charge
            except ValueError:
                pass
        name = getattr(req, "tenant", "default")
        q = self._queues.get(self._qname(req), [])
        idx = next(i for i, e in enumerate(q) if e.req is req)
        e = q.pop(idx)
        tier = self._tier(req)
        delay = self.tick - (e.due_tick if e.due_tick is not None
                             else self.tick)
        self.max_delay_ticks[tier] = max(
            self.max_delay_ticks.get(tier, 0), delay)
        self.admitted_by_tenant[name] = \
            self.admitted_by_tenant.get(name, 0) + 1
        t = self.tenant(name)
        cost = float(len(req.prompt) + req.max_new_tokens)
        start = max(self._vtime.get(name, 0.0), self._vfloor)
        self._vfloor = start
        self._vtime[name] = start + cost / t.weight

    def remove(self, req) -> bool:
        try:
            self._front.remove(req)
            return True
        except ValueError:
            pass
        q = self._queues.get(self._qname(req), [])
        for i, e in enumerate(q):
            if e.req is req:
                q.pop(i)
                return True
        return False

    def pop_expired(self, now: float) -> List[Any]:
        out = []
        for r in list(self._front):
            if r.deadline is not None and now > r.deadline:
                self._front.remove(r)
                out.append(r)
        for q in self._queues.values():
            expired = [e for e in q
                       if e.req.deadline is not None
                       and now > e.req.deadline]
            for e in expired:
                q.remove(e)
                out.append(e.req)
        return out

    # -- introspection ----------------------------------------------------
    # Read methods snapshot self._queues with list() first: the engine
    # tick loop calls them WITHOUT the engine lock while a cross-thread
    # submit() may setdefault a first-ever tenant key — list(dict
    # .values()) is a single GIL-atomic C call, so the snapshot never
    # sees "dictionary changed size during iteration". The entry lists
    # themselves tolerate concurrent insert (worst case an off-by-one
    # backlog sample); every MUTATING path runs under the engine lock.
    def depth(self) -> int:
        return len(self._front) + sum(
            len(q) for q in list(self._queues.values()))

    def pending(self) -> List[Any]:
        out = list(self._front)
        for q in list(self._queues.values()):
            out.extend(e.req for e in list(q))
        return out

    def tenant_depth(self, name: str) -> int:
        n = len(self._queues.get(name, [])) \
            + len(self._queues.get(name + self._BATCH_SUFFIX, []))
        n += sum(1 for r in self._front
                 if getattr(r, "tenant", "default") == name)
        return n

    def due_count(self, now: float) -> int:
        n = len(self._front)
        for q in list(self._queues.values()):
            for e in list(q):
                if e.req.arrival_time <= now:
                    n += 1
        return n

    def next_arrival(self, now: float) -> Optional[float]:
        if self._front:
            return now      # resumed requests are due immediately
        heads = [q[0].req.arrival_time
                 for q in list(self._queues.values()) if q]
        return min(heads) if heads else None

    def select_victim(self, cands, now):
        """SLO-aware victim: lowest priority tier first (highest tier
        number), then most deadline slack (no deadline = infinite
        slack, the most preemptable), then newest-admitted — so a
        high-priority request racing its deadline is the LAST thing a
        pool shortage evicts."""
        if not cands:
            return None

        def key(c):
            slot, req, seq = c
            slack = float("inf") if req.deadline is None \
                else req.deadline - now
            return (self._tier(req), slack, seq)

        return max(cands, key=key)[0]
