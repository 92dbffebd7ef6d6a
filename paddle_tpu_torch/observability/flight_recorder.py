"""Flight recorder: a bounded ring buffer of engine events.

The preemption-storm and eviction-under-load bugs of the paged-KV
round were debugged blind: by the time the symptom surfaced (a hang, a
double-free assertion, a wrong token) the scheduler state that led
there was gone. The flight recorder keeps the last N engine events —
admissions, preemptions, block alloc/free, trie evictions, program
launches, recompiles, the front-door lifecycle kinds ``cancel``,
``deadline_exceeded`` and ``admit_rejected`` (backpressure), plus the
adaptive controllers' ``adapt`` decisions (controller, old -> new
value, and the measured signal snapshot that triggered the move) — in a
fixed-size ring, cheap enough to leave on in production, and dumps
them on demand or on crash:

- ``ServingEngine.run()`` dumps the ring to a JSONL file when the
  serving loop dies with an exception (the postmortem nobody has to
  remember to enable);
- ``python -m paddle_tpu_torch.observability.dump FILE`` renders a dump
  (filter by kind / request id, or ``--summary`` for per-kind counts).

Events are host-side dicts: ``{"seq": monotonic index, "ts": seconds
on the recorder clock, "kind": str, ...fields}``. ``seq`` survives ring
wrap (it counts every event ever recorded), so a dump states exactly
how many events preceded its window — silent truncation never reads
as "covered everything".
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["FlightRecorder", "get_flight_recorder", "load_dump",
           "parse_dump_lines"]


class FlightRecorder:
    """Bounded in-memory event ring.

    Parameters
    ----------
    capacity : int
        Ring size; the oldest event is overwritten past it.
    clock : callable
        Monotonic seconds (injectable for deterministic tests); share
        it with the :class:`~paddle_tpu_torch.observability.trace.
        RequestTracer` so dump and trace timestamps line up.
    """

    def __init__(self, capacity: int = 4096, clock=time.perf_counter):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.clock = clock
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.total_events = 0    # survives wrap: seq of the next event

    def record(self, kind: str, **fields) -> None:
        # seq/ts are assigned INSIDE the lock: two threads reading
        # total_events before either appends would mint duplicate seqs,
        # breaking the dump's total-order contract
        with self._lock:
            ev: Dict[str, Any] = {"seq": self.total_events,
                                  "ts": self.clock(), "kind": kind}
            ev.update(fields)
            self._ring.append(ev)
            self.total_events += 1

    # -- queries ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._ring)

    @property
    def dropped(self) -> int:
        """Events that fell off the ring."""
        return self.total_events - len(self._ring)

    def events(self, kind: Optional[str] = None,
               last: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            evs = list(self._ring)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        if last is not None:
            evs = evs[-last:]
        return evs

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events():
            out[e["kind"]] = out.get(e["kind"], 0) + 1
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    # -- dump -------------------------------------------------------------
    def save(self, path: str, reason: str = "manual",
             context: Optional[Dict[str, Any]] = None) -> str:
        """Write the ring as JSONL: a ``_meta`` header line (reason,
        capacity, dropped count, context) then one event per line,
        oldest first. Returns the path."""
        evs = self.events()
        meta = {"kind": "_meta", "reason": reason,
                "capacity": self.capacity, "events": len(evs),
                "dropped": self.dropped,
                "total_events": self.total_events}
        if context:
            meta["context"] = context
        with open(path, "w") as f:
            f.write(json.dumps(meta) + "\n")
            for ev in evs:
                f.write(json.dumps(ev) + "\n")
        return path

    def dump_on_crash(self, exc: BaseException,
                      context: Optional[Dict[str, Any]] = None,
                      tag: str = "") -> Optional[str]:
        """Best-effort crash dump into ``$PADDLE_TPU_FLIGHT_DIR`` (or
        the system temp dir): never raises — the original exception
        must stay the one the caller sees. Returns the written path,
        or None. ``tag`` lands in the filename so two dumps of one
        incident (e.g. the serving loop's and the front-door pump's)
        cannot overwrite each other within the same second.

        The unset-env fallback is the TEMP dir, not the cwd: every
        benchmark/test crash used to strand a ``flight-*.jsonl`` at
        whatever directory the process happened to run from (a dozen
        of them had accumulated at the repo root). A postmortem the
        operator wants kept belongs in an explicit
        ``$PADDLE_TPU_FLIGHT_DIR``."""
        try:
            import tempfile

            base = os.environ.get("PADDLE_TPU_FLIGHT_DIR") \
                or tempfile.gettempdir()
            tag = f"-{tag}" if tag else ""
            path = os.path.join(
                base,
                f"flight-{os.getpid()}{tag}-{int(time.time())}.jsonl")
            ctx = {"exception": repr(exc)}
            if context:
                ctx.update(context)
            return self.save(path, reason="exception", context=ctx)
        except Exception:
            return None


def parse_dump_lines(lines) -> tuple:
    """Parse dump JSONL lines into ``(meta, events)`` — the shared
    reader behind :func:`load_dump` (files) and the dump CLI's
    ``--url`` mode (a live engine's ``/debug/flight`` endpoint emits
    the same format). Tolerates a missing header (meta = {}) so
    hand-made JSONL streams also load."""
    meta: Dict[str, Any] = {}
    events: List[Dict[str, Any]] = []
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        obj = json.loads(line)
        if i == 0 and obj.get("kind") == "_meta":
            meta = obj
        else:
            events.append(obj)
    return meta, events


def load_dump(path: str) -> tuple:
    """Read a dump file back: ``(meta, events)``."""
    with open(path) as f:
        return parse_dump_lines(f)


_default: Optional[FlightRecorder] = None
_default_lock = threading.Lock()


def get_flight_recorder() -> FlightRecorder:
    """Process-default recorder for emit sites with no engine handle;
    engines default to a private ring (see ``Telemetry``)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = FlightRecorder()
        return _default
