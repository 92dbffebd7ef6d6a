"""Bounded admission with explicit backpressure for the front door.

The port's copy of ``paddle_tpu/inference/frontend/admission.py``.

A production front door must fail FAST and say why: an unbounded
queue converts overload into silent latency (every queued request
eventually times out client-side, after burning scheduler work), while
a bounded one converts it into an immediate, typed rejection the
client can back off on. Admission here is checked at ``submit()``
time, before a request id is minted — a rejected request never touches
the engine, the scheduler, or the metrics window beyond the rejection
counters themselves.

Two limits, both on QUEUED (not running) requests:

- a global queue depth across all tenants;
- a per-tenant depth (``Tenant.max_queue_depth``, falling back to the
  controller's ``max_tenant_depth`` default) — one tenant's burst
  cannot consume the whole global budget and starve admission for
  everyone else.

Rejections raise :class:`AdmissionRejected` carrying a machine-readable
``reason`` (``"backpressure:global"`` / ``"backpressure:tenant"``);
the front door records each as an ``admit_rejected`` flight-recorder
event and a ``frontdoor_rejected_total{reason=...}`` counter.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["AdmissionController", "AdmissionRejected"]


class AdmissionRejected(RuntimeError):
    """A request the front door refused to enqueue.

    ``reason`` is machine-readable (``"backpressure:global"`` or
    ``"backpressure:tenant"``); ``tenant`` names the offender for the
    per-tenant case."""

    def __init__(self, reason: str, message: str,
                 tenant: Optional[str] = None):
        super().__init__(message)
        self.reason = reason
        self.tenant = tenant


class AdmissionController:
    """Depth-bounded admission policy.

    Parameters
    ----------
    max_queue_depth : int
        Global cap on queued requests across every tenant.
    max_tenant_depth : int, optional
        Default per-tenant cap; a tenant's own ``max_queue_depth``
        (on its :class:`~paddle_tpu_torch.inference.frontend.scheduler.
        Tenant`) overrides it. ``None`` means no per-tenant cap
        beyond the global one.
    """

    def __init__(self, max_queue_depth: int = 256,
                 max_tenant_depth: Optional[int] = None):
        if max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {max_queue_depth}")
        if max_tenant_depth is not None and max_tenant_depth < 1:
            raise ValueError(
                f"max_tenant_depth must be >= 1, got {max_tenant_depth}")
        self.max_queue_depth = int(max_queue_depth)
        self.max_tenant_depth = max_tenant_depth

    def check(self, scheduler, tenant_name: str) -> None:
        """Raise :class:`AdmissionRejected` if enqueueing one more
        request for ``tenant_name`` would exceed a bound. Called under
        the engine lock, so depth reads and the subsequent submit are
        atomic."""
        depth = scheduler.depth()
        if depth >= self.max_queue_depth:
            raise AdmissionRejected(
                "backpressure:global",
                f"admission queue full ({depth}/{self.max_queue_depth} "
                "queued); retry with backoff", tenant=tenant_name)
        limit = self.max_tenant_depth
        tenant_cfg = getattr(scheduler, "tenants", {}).get(tenant_name)
        if tenant_cfg is not None and \
                tenant_cfg.max_queue_depth is not None:
            limit = tenant_cfg.max_queue_depth
        if limit is None:
            return
        if hasattr(scheduler, "tenant_depth"):
            td = scheduler.tenant_depth(tenant_name)
        else:       # FIFO policies: approximate with the global depth
            td = depth
        if td >= limit:
            raise AdmissionRejected(
                "backpressure:tenant",
                f"tenant {tenant_name!r} queue full ({td}/{limit} "
                "queued); retry with backoff", tenant=tenant_name)
