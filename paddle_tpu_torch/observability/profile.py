"""Tick-anatomy profiler: where a serving tick's time actually goes.

The stack counts *events* exhaustively (metrics registry, flight ring,
per-request lanes) but before this module it attributed *time*
nowhere: an operator staring at ``/metrics`` could not say whether a
slow tick went to trie walks, spill copies, dispatch enqueue, or the
token sync — nor whether replica 1 idled while replica 0 saturated.
:class:`TickProfiler` closes that gap: the serving engine wraps each
phase of its tick in a named monotonic-clock span, and the profiler

- streams **per-phase duration histograms**
  (``serving_tick_phase_seconds{phase=}``) and a cumulative
  ``serving_tick_phase_seconds_total{phase=}`` counter into the
  metrics registry, next to a ``serving_tick_seconds`` tick-wall
  histogram and a ``serving_tick_untracked_seconds_total`` honesty
  counter (wall time no top-level phase claimed);
- keeps a bounded ring of committed ticks and exports them as ONE
  chrome-trace "tick lane" per engine (:meth:`to_chrome_trace` /
  :meth:`save`) that merges unchanged
  alongside the tracer's request lanes — same clock
  (``time.perf_counter`` by default), same time axis.

Phase names the serving engine emits (top-level phases are disjoint
within a tick; nested ones attribute time INSIDE a parent and are
excluded from the coverage sum so nothing double-counts):

==================  =====================================================
``admission``       tick-boundary cancellations/expiries/admissions
``bookkeeping``     scheduler tick stamp, load samples, backlog reads
``prefill_dispatch``  the chunk-prefill half of the tick (incl. finish)
``block_growth``    paged lazy block growth (preemption lives here)
``draft``           speculative drafter proposal (host side)
``decode_dispatch`` decode/verify program ENQUEUE (async dispatch)
``overlap_window``  next-tick host work run while programs are in flight
``token_sync``      device completion + host token materialization
``callbacks``       the commit loop: tracer marks, client callbacks,
                    retirement
``trie_lookup``     (nested) prefix-trie walk inside an admission
``trie_splice``     (nested) slot storage seeding: splice/copy/placement
``spill``           (nested) victim KV spill to the host tier
``swap_in``         (nested) host-tier KV splice-back at re-admission
==================  =====================================================

Contracts, pinned by tests:

- **Observability, never control flow.** The engine calls every
  profiler method through an absorb-count-warn guard
  (``serving_profiler_errors_total``): a raising profiler cannot
  quarantine a request, trip the breaker, or move a token.
- **No device work, no new programs.** Spans are host clock reads —
  ``executable_count()`` stays 2 and recompiles stay 0 with profiling
  on, and a profiled run is token-identical to an unprofiled one.
- **Counted separately.** Profiler spans do NOT land in
  ``Telemetry.events_emitted()`` (the per-decode-step telemetry gate
  stays untouched by profiling); the profiler counts its own volume
  in ``total_events``, gated per tick in CI.
- **Honest coverage.** Top-level phase durations must sum to the
  measured tick wall time within tolerance (5% in the tests); the
  un-attributed remainder is exported, never hidden. Phase
  *fractions* are the reportable currency — wall seconds on a CPU
  container are context, never a gate (PERF.md discipline).
"""

from __future__ import annotations

import gzip
import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .metrics import MetricsRegistry, log_buckets

__all__ = ["TickProfiler", "PHASE_BUCKETS"]

# phase/program spans run from microseconds (a host bookkeeping pass)
# to seconds (a cold cache-miss sync): wider than the serving-latency
# buckets, same fixed log-spaced discipline
PHASE_BUCKETS = log_buckets(1e-6, 10.0)


class _PhaseSpan:
    """One open phase span; re-entrant-safe via the tick's own stack.
    Cheap no-op when no tick is open (phases fired outside the tick
    loop — e.g. a snapshot-driven spill — are deliberately not
    recorded: they are not tick anatomy)."""

    __slots__ = ("_p", "name", "_t0", "_depth")

    def __init__(self, profiler: "TickProfiler", name: str):
        self._p = profiler
        self.name = name
        self._t0 = None
        self._depth = 0

    def __enter__(self):
        tick = self._p._tick
        if tick is not None:
            self._depth = len(tick["stack"])
            tick["stack"].append(self.name)
            self._t0 = self._p.clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        tick = self._p._tick
        if self._t0 is not None and tick is not None:
            tick["stack"].pop()
            tick["spans"].append(
                {"name": self.name, "ts": self._t0,
                 "dur": self._p.clock() - self._t0,
                 "depth": self._depth})
        return False


class TickProfiler:
    """Per-engine tick-phase profiler on the ``Telemetry`` bundle.

    Disabled by default (``ServingEngine(profile=True)`` or
    :meth:`enable` arms it); when disabled, ``tick_begin`` returns
    None and every phase span is a no-op — the tick loop pays an
    attribute read per phase, nothing more.

    The tick loop (single-threaded) owns the in-progress tick; the
    committed history and aggregates are lock-guarded so scrape
    threads (``/debug/profile``, ``/debug/trace``) read consistent
    snapshots.

    Parameters
    ----------
    registry : MetricsRegistry
        Where the phase histograms/counters stream.
    clock : callable
        Monotonic seconds; share it with the request tracer so the
        tick lane and the request lanes sit on one time axis (both
        default to ``time.perf_counter``).
    max_ticks : int
        Committed ticks retained for the chrome lane (oldest dropped
        first, counted in ``dropped_ticks``); aggregates and registry
        series are cumulative regardless.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 clock=time.perf_counter, max_ticks: int = 1024,
                 enabled: bool = False):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.clock = clock
        self.enabled = bool(enabled)
        self._tick: Optional[Dict[str, Any]] = None
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=int(max_ticks))
        self.dropped_ticks = 0
        # cumulative aggregates (committed ticks only)
        self.ticks = 0
        self.tick_seconds = 0.0
        self.top_phase_seconds = 0.0
        self.total_events = 0   # committed spans + one per tick
        self._phases: Dict[str, List[float]] = {}  # name -> [count, secs]
        # registry families, eager (a scrape before the first profiled
        # tick shows the families; labeled children appear per phase)
        r = self.registry
        self._c_ticks = r.counter(
            "serving_ticks_profiled_total",
            "scheduler ticks the tick profiler decomposed")
        self._h_tick = r.histogram(
            "serving_tick_seconds",
            "wall duration of one profiled scheduler tick",
            PHASE_BUCKETS)
        self._c_phase = r.counter(
            "serving_tick_phase_seconds_total",
            "cumulative seconds spent per tick phase (nested phases "
            "also attribute into their own name)",
            labelnames=("phase",))
        self._h_phase = r.histogram(
            "serving_tick_phase_seconds",
            "per-span duration of each tick phase",
            PHASE_BUCKETS, labelnames=("phase",))
        self._c_untracked = r.counter(
            "serving_tick_untracked_seconds_total",
            "tick wall seconds no top-level phase claimed (the "
            "coverage honesty counter: large = instrument the gap)")

    # -- arming -----------------------------------------------------------
    def enable(self) -> "TickProfiler":
        self.enabled = True
        return self

    def disable(self) -> "TickProfiler":
        self.enabled = False
        return self

    # -- recording (tick thread) ------------------------------------------
    def tick_begin(self) -> Optional[Dict[str, Any]]:
        """Open a tick; returns the token :meth:`tick_end` closes (None
        when disabled). An unclosed prior tick (the engine's breaker
        absorbed an exception mid-tick) is simply replaced — its
        spans are discarded with it."""
        if not self.enabled:
            return None
        tick: Dict[str, Any] = {"t0": self.clock(), "spans": [],
                                "stack": []}
        self._tick = tick
        return tick

    def tick_end(self, token: Optional[Dict[str, Any]],
                 commit: bool = True) -> None:
        """Close the open tick. ``commit=False`` (an idle or faulted
        loop iteration — not a real scheduler tick) discards the
        spans; committed ticks land in the aggregates, the registry
        and the chrome lane."""
        if token is None:
            return
        if self._tick is token:
            self._tick = None
        if not commit:
            return
        t1 = self.clock()
        wall = max(t1 - token["t0"], 0.0)
        spans = token["spans"]
        top = sum(s["dur"] for s in spans if s["depth"] == 0)
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped_ticks += 1
            self._ring.append({"t0": token["t0"], "wall": wall,
                               "spans": spans})
            self.ticks += 1
            self.tick_seconds += wall
            self.top_phase_seconds += top
            self.total_events += len(spans) + 1
            for s in spans:
                agg = self._phases.setdefault(s["name"], [0, 0.0])
                agg[0] += 1
                agg[1] += s["dur"]
        self._c_ticks.inc()
        self._h_tick.observe(wall)
        self._c_untracked.inc(max(wall - top, 0.0))
        for s in spans:
            self._c_phase.labels(phase=s["name"]).inc(s["dur"])
            self._h_phase.labels(phase=s["name"]).observe(s["dur"])

    def phase(self, name: str) -> _PhaseSpan:
        """Context manager spanning one named phase of the open tick.
        Spans opened while another span is open are NESTED: they
        attribute time inside their parent and are excluded from the
        top-level coverage sum (no double counting)."""
        return _PhaseSpan(self, name)

    # -- queries ----------------------------------------------------------
    def has_ticks(self) -> bool:
        return self.ticks > 0

    def coverage_fraction(self) -> float:
        """sum(top-level phase durations) / sum(tick wall) over every
        committed tick — 1.0 when the named phases account for the
        whole tick. The tests assert this within 5%."""
        with self._lock:
            if self.tick_seconds <= 0.0:
                return 1.0
            return self.top_phase_seconds / self.tick_seconds

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able breakdown — what ``/debug/profile`` serves."""
        with self._lock:
            ticks = self.ticks
            phases = {
                name: {"spans": int(c),
                       "seconds_total": s,
                       "mean_s": s / c if c else 0.0,
                       "fraction_of_tick":
                           s / self.tick_seconds
                           if self.tick_seconds > 0 else 0.0}
                for name, (c, s) in sorted(self._phases.items())}
            cov = (self.top_phase_seconds / self.tick_seconds
                   if self.tick_seconds > 0 else 1.0)
            return {"enabled": self.enabled,
                    "ticks": ticks,
                    "tick_seconds_total": self.tick_seconds,
                    "top_phase_seconds_total": self.top_phase_seconds,
                    "coverage_fraction": cov,
                    "events": self.total_events,
                    "dropped_ticks": self.dropped_ticks,
                    "phases": phases}

    # -- export -----------------------------------------------------------
    def to_chrome_trace(self, pid: int = 2,
                        process_name: str = "serving ticks") -> dict:
        """The tick lane as a chrome-trace dict: one lane (tid 0) per
        engine/profiler, a ``tick`` duration event per committed tick
        with its phase spans nested inside by timestamp — the same
        format (and, by default, the same clock) as the request
        tracer's lanes, so the two files' ``traceEvents`` merge onto
        one time axis unchanged."""
        events: List[Dict[str, Any]] = [
            {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
             "args": {"name": process_name}},
            {"ph": "M", "pid": pid, "tid": 0, "name": "thread_name",
             "args": {"name": "engine tick"}},
        ]
        with self._lock:
            ring = list(self._ring)
        for t in ring:
            events.append({"ph": "X", "pid": pid, "tid": 0,
                           "name": "tick", "ts": t["t0"] * 1e6,
                           "dur": t["wall"] * 1e6, "cat": "tick"})
            for s in t["spans"]:
                events.append({"ph": "X", "pid": pid, "tid": 0,
                               "name": s["name"], "ts": s["ts"] * 1e6,
                               "dur": s["dur"] * 1e6, "cat": "phase",
                               "args": {"depth": s["depth"]}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path: str, **kw) -> str:
        """Write the tick lane to ``path`` (gzipped for ``.gz``), the
        same contract as ``RequestTracer.save``."""
        trace = self.to_chrome_trace(**kw)
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "wt") as f:
            json.dump(trace, f)
        return path
