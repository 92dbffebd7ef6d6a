"""Per-tenant SLO tracking over the serving request stream.

The registry's histograms answer "what was TTFT" — but a fleet router
or an operator routes on "is tenant X still inside its objective",
which is a different shape of number: per tenant, per objective, a
rolling-window attainment fraction and how fast the error budget is
burning (the SRE burn-rate framing: burn 1.0 = failing exactly as
often as the objective tolerates, burn 2.0 = the budget gone in half
the window). :class:`SLOTracker` computes exactly that, fed one
retired request at a time from ``ServingMetrics.record_request`` —
the stream already carries TTFT and TPOT, so the tracker adds no new
instrumentation to the tick loop.

Counted-first, like everything in this package:

- ``slo_violations_total{tenant,objective}`` is a labeled counter — a
  pure function of the request outcomes, diffable across scrapes and
  gate-able in CI.
- ``slo_attainment{tenant,objective}`` / ``slo_error_budget_burn
  {tenant,objective}`` are labeled gauges over the rolling window —
  the signals ``/readyz`` and a fleet scheduler consult.
- ``total_events`` counts objective EVALUATIONS (not violations): per
  retired request, one event per objective that had a sample (TTFT
  always; TPOT only when the request generated >= 2 tokens). On a
  fixed trace this is a pure function of the code — the
  ``slo_tracker_events_per_request`` CI gate rides on it, and a
  violation count (which depends on wall-clock timings) never moves
  it.

The tracker is service-lifetime state (it lives on the
:class:`~paddle_tpu_torch.observability.Telemetry` bundle, like the
registry), windowed on its OWN monotonic clock — engine epochs reset
their clock anchor per run, and a rolling window must not.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, Optional, Tuple

__all__ = ["SLOObjective", "SLOTracker", "DEFAULT_OBJECTIVE"]


@dataclass(frozen=True)
class SLOObjective:
    """One tenant's service-level objective.

    ``ttft_s`` / ``tpot_s`` are the per-request latency bounds (a
    request *meets* the objective when its sample is <= the bound);
    ``target`` is the attainment goal — the fraction of requests that
    must meet each bound over the rolling window (0.99 = an error
    budget of 1%)."""

    ttft_s: float = 2.0
    tpot_s: float = 0.5
    target: float = 0.99

    def __post_init__(self):
        if self.ttft_s <= 0 or self.tpot_s <= 0:
            raise ValueError(
                f"objective bounds must be positive seconds, got "
                f"ttft_s={self.ttft_s}, tpot_s={self.tpot_s}")
        if not 0.0 < self.target < 1.0:
            # target 1.0 has a zero error budget — burn rate would be
            # infinite on the first violation, which is not a signal
            # anyone can route on; pick 0.999... instead
            raise ValueError(
                f"target must be in (0, 1), got {self.target}")


DEFAULT_OBJECTIVE = SLOObjective()


class SLOTracker:
    """Rolling-window SLO attainment and burn rate, per tenant.

    Parameters
    ----------
    registry : MetricsRegistry, optional
        Where the ``slo_*`` families are registered (a private one is
        created when not given — unit-test mode).
    objectives : dict, optional
        Per-tenant :class:`SLOObjective` overrides; tenants not listed
        use ``default``.
    default : SLOObjective
        Objective for tenants without an explicit entry.
    window_s : float
        Rolling window the attainment/burn gauges are computed over.
    clock : callable
        Monotonic seconds; injectable for deterministic tests.
    """

    OBJECTIVES = ("ttft", "tpot")

    def __init__(self, registry=None,
                 objectives: Optional[Dict[str, SLOObjective]] = None,
                 default: SLOObjective = DEFAULT_OBJECTIVE,
                 window_s: float = 60.0,
                 clock=time.perf_counter):
        from .metrics import MetricsRegistry

        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.objectives = dict(objectives or {})
        self.default = default
        self.window_s = float(window_s)
        self.clock = clock
        self.total_events = 0    # counted objective evaluations
        self._lock = threading.Lock()
        # (tenant, objective) -> deque of (ts, met) inside the window
        self._win: Dict[Tuple[str, str], Deque[Tuple[float, bool]]] = {}
        labels = ("tenant", "objective")
        self._c_viol = self.registry.counter(
            "slo_violations_total",
            "retired requests that missed the tenant's objective "
            "bound", labelnames=labels)
        self._g_att = self.registry.gauge(
            "slo_attainment",
            "rolling-window fraction of requests meeting the "
            "objective (1.0 when the window is empty)",
            labelnames=labels)
        self._g_burn = self.registry.gauge(
            "slo_error_budget_burn",
            "rolling-window error-budget burn rate: (1 - attainment) "
            "/ (1 - target); 1.0 = burning exactly at budget",
            labelnames=labels)

    def objective_for(self, tenant: str) -> SLOObjective:
        return self.objectives.get(tenant, self.default)

    # -- feed -------------------------------------------------------------
    def observe(self, tenant: str, ttft: Optional[float],
                tpot: Optional[float]) -> None:
        """One retired request's samples (seconds; None = no sample,
        e.g. TPOT of a 1-token request). Called from
        ``ServingMetrics.record_request`` — the emit site already on
        the retire path, so the tracker costs two dict/deque updates
        per REQUEST, never per token or per tick."""
        obj = self.objective_for(tenant)
        now = self.clock()
        for name, value, bound in (("ttft", ttft, obj.ttft_s),
                                   ("tpot", tpot, obj.tpot_s)):
            if value is None:
                continue
            met = value <= bound
            with self._lock:
                self.total_events += 1
                win = self._win.setdefault((tenant, name), deque())
                win.append((now, met))
                self._trim(win, now)
                att = sum(1 for _, ok in win if ok) / len(win)
            if not met:
                self._c_viol.labels(tenant=tenant, objective=name).inc()
            self._g_att.labels(tenant=tenant, objective=name).set(att)
            self._g_burn.labels(tenant=tenant, objective=name).set(
                (1.0 - att) / (1.0 - obj.target))

    def _trim(self, win, now: float) -> None:
        cutoff = now - self.window_s
        while win and win[0][0] < cutoff:
            win.popleft()

    # -- queries ----------------------------------------------------------
    def attainment(self, tenant: str, objective: str) -> float:
        """Rolling-window attainment; 1.0 when no sample is in the
        window (no data is not a violation)."""
        if objective not in self.OBJECTIVES:
            raise ValueError(f"unknown objective {objective!r}; "
                             f"expected one of {self.OBJECTIVES}")
        now = self.clock()
        with self._lock:
            win = self._win.get((tenant, objective))
            if win is None:
                return 1.0
            self._trim(win, now)
            if not win:
                return 1.0
            return sum(1 for _, ok in win if ok) / len(win)

    def burn_rate(self, tenant: str, objective: str) -> float:
        obj = self.objective_for(tenant)
        return (1.0 - self.attainment(tenant, objective)) \
            / (1.0 - obj.target)

    def worst_burn(self) -> Tuple[float, Optional[str], Optional[str]]:
        """``(burn, tenant, objective)`` of the worst-burning series
        in the window — the single number ``/readyz`` consults.
        ``(0.0, None, None)`` when nothing has been observed."""
        with self._lock:
            keys = list(self._win)
        worst = (0.0, None, None)
        for tenant, objective in keys:
            b = self.burn_rate(tenant, objective)
            if b > worst[0]:
                worst = (b, tenant, objective)
        return worst

    def tenants(self):
        with self._lock:
            return sorted({t for t, _ in self._win})
