"""Serving telemetry: metrics registry, request tracing, flight
recorder, recompile sentinel — the port of
``paddle_tpu/observability/``, pure Python like the reference.

Four pieces, one bundle (:class:`Telemetry`) the serving stack emits
into:

- :mod:`~paddle_tpu_torch.observability.metrics` — Counter/Gauge/Histogram
  registry with Prometheus text exposition and JSON snapshots; counted
  first, so the numbers mean the same thing on a noisy CPU container
  as on quiet hardware.
- :mod:`~paddle_tpu_torch.observability.trace` — per-request lifecycle
  lanes, exportable as chrome-trace JSON, the format
  ``torch.profiler`` exports device traces in.
- :mod:`~paddle_tpu_torch.observability.flight_recorder` — bounded ring of
  engine events with dump-on-exception and a
  ``python -m paddle_tpu_torch.observability.dump`` postmortem CLI.
- :mod:`~paddle_tpu_torch.observability.sentinel` — live recompile guard
  over the engine's program registry: each new argument signature a
  program is dispatched with past its first (``recompile_events_total``).

``ServingEngine`` constructs a private ``Telemetry()`` by default —
always on, isolated per engine. Pass your own to hold a handle on the
exports, or to fold an engine into the process-wide scrape registry.
(Sharing one bundle across SEVERAL engines merges their series:
counters/histograms accumulate fleet-wide, but the unlabeled load
gauges are last-writer-wins — keep per-engine bundles when per-engine
load must stay distinguishable.)

    from paddle_tpu_torch.observability import Telemetry, get_registry
    tel = Telemetry(registry=get_registry())
    eng = ServingEngine(model, ..., telemetry=tel)
    ...
    print(tel.registry.to_prometheus_text())
    tel.tracer.save("requests.trace.json")
"""

from __future__ import annotations

import time
from typing import Optional

from .flight_recorder import (FlightRecorder, get_flight_recorder,
                              load_dump)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      DEFAULT_SIZE_BUCKETS, DEFAULT_TIME_BUCKETS,
                      get_registry, log_buckets)
from .ops_plane import OpsPlane, PROM_CONTENT_TYPE
from .profile import PHASE_BUCKETS, TickProfiler
from .sentinel import RecompileError, RecompileSentinel, describe_args
from .slo import DEFAULT_OBJECTIVE, SLOObjective, SLOTracker
from .trace import RequestTracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "log_buckets",
    "get_registry", "DEFAULT_TIME_BUCKETS", "DEFAULT_SIZE_BUCKETS",
    "RequestTracer", "FlightRecorder", "get_flight_recorder",
    "load_dump", "RecompileSentinel", "RecompileError", "describe_args",
    "SLOObjective", "SLOTracker", "DEFAULT_OBJECTIVE",
    "OpsPlane", "PROM_CONTENT_TYPE",
    "TickProfiler", "PHASE_BUCKETS",
    "Telemetry",
]


class Telemetry:
    """One engine's telemetry bundle: a metrics registry, a request
    tracer, a flight recorder, and a recompile sentinel wired to the
    first two. All components share one monotonic clock so metric
    windows, request lanes and flight events line up.

    Parameters
    ----------
    registry, tracer, recorder : optional
        Inject shared instances (e.g. ``registry=get_registry()`` to
        expose several engines through one scrape); fresh private ones
        are created otherwise.
    strict_recompile : bool
        Make the sentinel RAISE at the dispatch site on a detected
        recompile instead of only counting — CI/canary mode.
    clock : callable
        Monotonic seconds, injectable for deterministic tests.
    slo : SLOTracker, optional
        Inject a configured tracker (per-tenant objectives, window);
        a default-objective tracker on this bundle's registry is
        created otherwise.
    profiler : TickProfiler, optional
        Inject a configured tick profiler (e.g. pre-enabled, custom
        ring size); a DISABLED profiler on this bundle's registry is
        created otherwise — ``ServingEngine(profile=True)`` arms it.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[RequestTracer] = None,
                 recorder: Optional[FlightRecorder] = None,
                 strict_recompile: bool = False,
                 clock=time.perf_counter,
                 slo: Optional[SLOTracker] = None,
                 profiler: Optional[TickProfiler] = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.tracer = tracer if tracer is not None \
            else RequestTracer(clock=clock)
        self.recorder = recorder if recorder is not None \
            else FlightRecorder(clock=clock)
        self.slo = slo if slo is not None \
            else SLOTracker(self.registry, clock=clock)
        self.profiler = profiler if profiler is not None \
            else TickProfiler(self.registry, clock=clock)
        self.sentinel = RecompileSentinel(
            self.registry, self.recorder, strict=strict_recompile)

    def events_emitted(self) -> int:
        """Counted telemetry volume: flight-recorder events + tracer
        events ever emitted (ring wrap and lane eviction don't lower
        it). A per-decode-step overhead gate
        divides this by decode steps — a new emit site lands in the
        count, a lost one does too. (The SLO tracker's evaluations are
        counted SEPARATELY — ``slo.total_events``, gated per request —
        so attaching SLO tracking never moved this per-step gate; the
        tick profiler's spans likewise count only in its own
        ``profiler.total_events``, gated per tick.)"""
        return self.recorder.total_events + self.tracer.total_events

    def recompile_events(self) -> int:
        """recompile_events_total as a number (0 when never armed)."""
        return self.sentinel.events
