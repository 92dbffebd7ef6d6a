"""Fleet layer: N engine processes behind one health-driven router.

The port's copy of ``paddle_tpu/inference/fleet/``.

Llumnix (arXiv:2406.03243) argues LLM serving needs REQUEST-level
rescheduling across engine instances — placement by live load, victim
migration off hot/degraded engines, failover off dead ones — and the
whole substrate already exists here one layer down: token-exact
``snapshot_request``/``restore_request``, scrapeable load and
readiness surfaces (the ops plane), and the iteration-level tick boundary
(Orca) that makes a mid-flight migration a clean edge. This package
is the glue:

- :class:`~.client.EngineClient` — stdlib-urllib transport to one
  engine's ingest + ops planes (submit/stream/cancel/migrate/drain,
  metrics/readyz scrapes), every failure a typed
  :class:`~.client.TransportError`;
- :class:`~.router.FleetRouter` — placement across engines by scraped
  free slots/blocks/queue depth/replica skew, jittered-backoff retry,
  per-engine circuit breakers fed by ``/readyz``, live migration
  (snapshot -> ship -> restore, corrupt-transfer fallback to
  re-prefill), failover for engines that die mid-stream, and graceful
  shutdown that drains every engine and audits zero leaks;
- :mod:`~.engine_proc` — ``python -m paddle_tpu_torch.inference.fleet.
  engine_proc``: one engine process wearing both HTTP planes, the
  unit the router multiplies.

House rules carry over wholesale: migrations fork zero executables
(everything here is host-side HTTP), every degradation is counted and
never a crash, and the fleet is held to token-identical
outputs and zero leaked blocks across kill-engine / corrupt-transfer
/ scrape-blackhole faults.
"""

from .client import EngineClient, SubmitRejected, TransportError
from .router import EngineRef, FleetHandle, FleetRouter

__all__ = [
    "EngineClient", "TransportError", "SubmitRejected",
    "EngineRef", "FleetRouter", "FleetHandle",
]
