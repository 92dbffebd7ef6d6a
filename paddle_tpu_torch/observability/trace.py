"""Per-request lifecycle tracing for the serving engine.

"What happened to request 4812?" — the question the window-aggregate
``ServingMetrics`` cannot answer. This module records each request's
lifecycle as a timeline keyed by request id: submitted -> admitted ->
prefix_hit -> prefill_chunk x N -> first_token -> per-token decode
progress -> preempted/resumed -> finished(+reason), every mark a
monotonic-clock timestamp taken at the emit site. A cancelled or
deadline-expired request's lane ends the same way — a ``finished``
mark whose reason says ``cancelled`` / ``deadline_exceeded`` (with a
``cancel_requested`` instant where the client asked), so a killed
request is as legible as a served one.

Export is chrome-trace JSON (the trace-viewer / Perfetto format
``torch.profiler`` exports): ONE LANE PER REQUEST — pid = the "requests"
process, tid = request id — with the lifecycle phases rendered as
duration events (queued / prefill / decode / preempted bands) and the
point marks as instants on the same lane. Because it is the same
format, concatenating its ``traceEvents`` with a device trace's merges
the two unchanged: request lanes overlay the trace viewer's
device/host lanes on one time axis, which is what turns "decode step
took 40ms" into "request 17's third prefill chunk is what it stalled
behind".

The tracer is bounded: at most ``max_requests`` retired request
timelines are retained (oldest evicted first); live requests are never
evicted. Event *counting* is unconditional and O(1) — a counted
telemetry-overhead gate can ride on it.
"""

from __future__ import annotations

import gzip
import json
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

__all__ = ["RequestTracer"]

# lifecycle phase bands synthesized from mark pairs at export:
# (span name, begin mark, end mark). The queued band begins at
# "arrived" (the request's due time — what queue_wait charges from)
# when the emitter provides it, falling back to "submitted"; an
# open-loop trace submits requests long before their arrival_time, and
# a band from submit would show phantom queue time the
# serving_queue_wait_seconds histogram never recorded.
_PHASES = (
    ("queued", "arrived", "admitted"),
    ("prefill", "admitted", "first_token"),
    ("decode", "first_token", "finished"),
    ("preempted", "preempted", "resumed"),
)


class _Lane:
    __slots__ = ("events", "marks", "spans", "done")

    def __init__(self):
        self.events: List[Dict[str, Any]] = []   # instants
        self.marks: Dict[str, List[float]] = {}  # name -> [ts, ...]
        self.spans: List[Dict[str, Any]] = []    # explicit X events
        self.done = False


class RequestTracer:
    """Bounded per-request lifecycle recorder.

    Parameters
    ----------
    max_requests : int
        Retired lanes retained (LRU of completion order). Live lanes
        don't count against the bound.
    clock : callable
        Monotonic seconds; injectable for deterministic tests. The
        same clock must be shared with whatever produces the device
        trace for lanes to align (both default to
        ``time.perf_counter``).
    """

    def __init__(self, max_requests: int = 512, clock=time.perf_counter):
        self.max_requests = int(max_requests)
        self.clock = clock
        self._live: Dict[int, _Lane] = {}
        self._retired: "OrderedDict[int, _Lane]" = OrderedDict()
        self.total_events = 0        # counted, never trimmed
        self.dropped_requests = 0

    # -- recording --------------------------------------------------------
    def _lane(self, rid: int) -> _Lane:
        lane = self._live.get(rid)
        if lane is not None:
            return lane
        lane = self._retired.get(rid)
        if lane is not None:
            # a straggler event for a FINISHED request (e.g. a
            # RecordEvent span ending after the finished mark) lands on
            # the retired lane IN PLACE — resurrecting it into _live
            # would exempt it from the max_requests bound forever (no
            # second 'finished' ever re-retires it)
            if not lane.done:
                del self._retired[rid]
                self._live[rid] = lane
            return lane
        lane = _Lane()
        self._live[rid] = lane
        return lane

    def lifecycle(self, rid: int, name: str,
                  ts: Optional[float] = None, **args):
        """One lifecycle mark on request ``rid``'s lane: an instant in
        the export AND (for the known phase marks) an endpoint the
        exporter pairs into queued/prefill/decode/preempted bands.
        ``finished`` retires the lane into the bounded history."""
        ts = self.clock() if ts is None else ts
        lane = self._lane(rid)
        lane.marks.setdefault(name, []).append(ts)
        ev: Dict[str, Any] = {"name": name, "ts": ts}
        if args:
            ev["args"] = args
        lane.events.append(ev)
        self.total_events += 1
        if name == "finished":
            lane.done = True
            self._retire(rid)

    def event(self, rid: int, name: str, **args):
        """Plain instant on the lane (e.g. per-token decode progress)
        — no phase pairing."""
        lane = self._lane(rid)
        ev: Dict[str, Any] = {"name": name, "ts": self.clock()}
        if args:
            ev["args"] = args
        lane.events.append(ev)
        self.total_events += 1

    def span(self, rid: int, name: str, t0: float, dt: float, **args):
        """Explicit duration event on the lane — the sink
        ``profiler.RecordEvent(span_id=..., sink=...)`` feeds, so the
        op spans already annotating the device trace
        (serving:prefill_chunk et al.) also land in the request lane."""
        lane = self._lane(rid)
        ev: Dict[str, Any] = {"name": name, "ts": t0, "dur": dt}
        if args:
            ev["args"] = args
        lane.spans.append(ev)
        self.total_events += 1

    def record_event_sink(self, name: str, span_id, t0: float, dt: float):
        """Adapter with the RecordEvent sink signature."""
        self.span(int(span_id), name, t0, dt)

    def _retire(self, rid: int):
        lane = self._live.pop(rid, None)
        if lane is None:
            return
        self._retired[rid] = lane
        while len(self._retired) > self.max_requests:
            self._retired.popitem(last=False)
            self.dropped_requests += 1

    # -- queries ----------------------------------------------------------
    def request_ids(self) -> List[int]:
        return sorted([*self._retired, *self._live])

    def timeline(self, rid: int) -> List[Dict[str, Any]]:
        """The raw recorded instants+spans for one request, time
        ordered — the programmatic answer to "what happened to request
        N" (the chrome export is the visual one)."""
        lane = self._live.get(rid) or self._retired.get(rid)
        if lane is None:
            return []
        return sorted([*lane.events, *lane.spans],
                      key=lambda e: e["ts"])

    # -- export -----------------------------------------------------------
    def to_chrome_trace(self, pid: int = 1,
                        process_name: str = "serving requests") -> dict:
        """One chrome-trace dict: lane per request (tid = request id),
        phase bands as X events, marks as instants. Timestamps are the
        tracer clock in microseconds — the unit the format requires."""
        events: List[Dict[str, Any]] = [{
            "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": process_name}}]
        lanes = {**self._retired, **self._live}
        for rid in sorted(lanes):
            lane = lanes[rid]
            events.append({
                "ph": "M", "pid": pid, "tid": rid, "name": "thread_name",
                "args": {"name": f"request {rid}"}})
            for span, b_mark, e_mark in _PHASES:
                begins = lane.marks.get(b_mark, [])
                if not begins and span == "queued":
                    begins = lane.marks.get("submitted", [])
                ends = lane.marks.get(e_mark, [])
                # pair in order; an unmatched begin (live request, or
                # preempted-at-shutdown) is left open-ended = dropped
                for t0, t1 in zip(begins, ends):
                    if t1 < t0:
                        continue
                    events.append({
                        "ph": "X", "pid": pid, "tid": rid, "name": span,
                        "ts": t0 * 1e6, "dur": (t1 - t0) * 1e6,
                        "cat": "lifecycle"})
            for ev in lane.events:
                out = {"ph": "i", "s": "t", "pid": pid, "tid": rid,
                       "name": ev["name"], "ts": ev["ts"] * 1e6,
                       "cat": "lifecycle"}
                if "args" in ev:
                    out["args"] = ev["args"]
                events.append(out)
            for ev in lane.spans:
                out = {"ph": "X", "pid": pid, "tid": rid,
                       "name": ev["name"], "ts": ev["ts"] * 1e6,
                       "dur": ev["dur"] * 1e6, "cat": "op"}
                if "args" in ev:
                    out["args"] = ev["args"]
                events.append(out)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path: str, **kw) -> str:
        """Write the chrome trace to ``path`` (gzipped when it ends in
        ``.gz`` — the trace viewer and Perfetto ingest both forms).
        Returns the path."""
        trace = self.to_chrome_trace(**kw)
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "wt") as f:
            json.dump(trace, f)
        return path
