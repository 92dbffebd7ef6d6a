"""Ops plane: the HTTP surface of a live serving engine.

The telemetry (registry, tracer, flight ring, sentinel) and the
enumerable per-request state (``audit()``) live inside the process as
Python objects. A fleet router doing
Llumnix-style rescheduling, a load tester driving a closed loop, or an
operator with ``curl`` needs the same signals OVER THE WIRE. This
module is that plane: a stdlib-only (``http.server``) HTTP server
attachable to a :class:`~paddle_tpu_torch.inference.frontend.server.
FrontDoor` or a bare :class:`~paddle_tpu_torch.inference.serving.
ServingEngine`::

    plane = OpsPlane(door, port=0).start()   # port 0 = ephemeral
    # curl http://127.0.0.1:{plane.port}/metrics

Endpoints (all GET, all read-only):

- ``/metrics`` — the engine registry's Prometheus text exposition
  (``text/plain; version=0.0.4``), with the scrape-time load gauges
  the fleet router needs refreshed first (free slots/blocks, queue
  depth per tier, overlap fraction, breaker state, in-progress
  dispatch stalls — ``ServingEngine.publish_load_gauges()``).
- ``/healthz`` — LIVENESS: the process answers. Always 200 while the
  server runs; counted (``ops_plane_healthz_total``).
- ``/readyz`` — READINESS: should a router keep sending traffic.
  503 + machine-readable reasons when the circuit breaker is open,
  the last audit found leaked blocks/orphaned pins (host-tier leaks
  included), a compiled dispatch is currently past its stall
  watchdog, the front-door pump died, BOTH KV tiers are full
  (``host_tier_exhausted`` — the device pool is dry and no victim's
  work can even be parked), or (when ``slo_burn_limit`` is set) the
  worst per-tenant SLO burn rate exceeds it. Counted by verdict
  (``ops_plane_readyz_total{state}``).
- ``/debug/requests`` — the live slot/queue table plus the
  reconciliation report, straight from ``audit()``'s enumeration.
- ``/debug/flight?last=N`` — the flight ring's tail as JSONL (same
  format as a crash dump; ``observability.dump --url`` renders it).
- ``/debug/trace`` — the request tracer's chrome-trace JSON, as a
  download; when the tick profiler has committed ticks, its tick
  lane is merged into the same trace (one time axis, one file).
- ``/debug/profile`` — the tick-anatomy snapshot: phase
  breakdown with coverage, top programs by cumulative dispatch wall
  time, and the per-replica utilization/skew split.

Isolation contract (pinned by test): telemetry is observability,
never control flow. The server runs on its OWN daemon threads
(``ThreadingHTTPServer``), every response is built as a complete byte
string from short read-only snapshots BEFORE the first byte is
written, and a wedged or stalled scraper therefore blocks only its
own handler thread — never the pump, the tick loop, or ``stop()``
(``block_on_close=False``; handler sockets carry a timeout so a
stalled peer eventually releases its thread).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

__all__ = ["OpsPlane", "PROM_CONTENT_TYPE"]

# the Prometheus text exposition content type scrapers negotiate on
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class _BadRequest(ValueError):
    """A malformed CLIENT request (bad query parameter): answered 400
    and never counted into ``ops_plane_scrape_errors_total`` — that
    counter is CI-gated at 0 as SERVER-side failures, and a client
    typo must not be able to fail the gate or page an operator."""


class OpsPlane:
    """HTTP ops server over a ``FrontDoor`` or a bare
    ``ServingEngine``.

    Parameters
    ----------
    target : FrontDoor | ServingEngine
        A front door (detected by its ``pump_alive`` surface —
        ``/readyz`` then also covers pump death) or an engine.
    port : int
        TCP port; 0 (default) binds an ephemeral port, read it back
        from ``plane.port`` after :meth:`start`.
    host : str
        Bind address; loopback by default — exposing the debug
        surface beyond the host is a deployment decision, not a
        default.
    slo_burn_limit : float, optional
        When set, ``/readyz`` reports not-ready while the worst
        per-tenant error-budget burn rate exceeds it (e.g. 10.0 =
        "budget gone in a tenth of the window"). Unset, SLO state is
        reported in the body but never flips readiness.
    handler_timeout : float
        Socket timeout per handler; bounds how long a stalled peer
        can pin one daemon thread.
    """

    def __init__(self, target, port: int = 0, host: str = "127.0.0.1",
                 slo_burn_limit: Optional[float] = None,
                 handler_timeout: float = 60.0):
        if hasattr(target, "pump_alive"):        # FrontDoor
            self.door = target
            self.engine = target.engine
        else:                                    # bare ServingEngine
            self.door = None
            self.engine = target
        if not hasattr(self.engine, "telemetry"):
            raise TypeError(
                f"OpsPlane needs a FrontDoor or a ServingEngine, got "
                f"{type(target).__name__}")
        self.host = host
        self.port = int(port)       # rewritten to the bound port
        self.slo_burn_limit = slo_burn_limit
        self.handler_timeout = float(handler_timeout)
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # eager registration so a scrape before the first probe shows
        # explicit 0s; use sites re-resolve get-or-create against the
        # engine's CURRENT registry, so a set_telemetry() swap moves
        # the ops counters along with every other serving family
        for c in (self._c_req, self._c_err, self._c_health,
                  self._c_ready):
            c()

    # counters resolved against the live registry (get-or-create is a
    # dict lookup; the scrape path is not the tick loop)
    def _c_req(self):
        return self.engine.telemetry.registry.counter(
            "ops_plane_requests_total",
            "ops-plane HTTP requests served, by endpoint",
            labelnames=("endpoint",))

    def _c_err(self):
        return self.engine.telemetry.registry.counter(
            "ops_plane_scrape_errors_total",
            "ops-plane requests that failed server-side (handler "
            "exception answered 500)")

    def _c_health(self):
        return self.engine.telemetry.registry.counter(
            "ops_plane_healthz_total", "liveness probes answered")

    def _c_ready(self):
        return self.engine.telemetry.registry.counter(
            "ops_plane_readyz_total", "readiness probes by verdict",
            labelnames=("state",))

    # -- lifecycle --------------------------------------------------------
    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "OpsPlane":
        if self._server is not None:
            raise RuntimeError("OpsPlane already started")
        plane = self

        class Handler(BaseHTTPRequestHandler):
            timeout = plane.handler_timeout

            def do_GET(self):
                plane._handle(self)

            def log_message(self, *args):      # no stderr chatter
                pass

        srv = ThreadingHTTPServer((self.host, self.port), Handler)
        # scraper threads must never couple to the engine's or the
        # server's lifetime: daemon handlers, and close() must not
        # join a thread a stalled peer is pinning
        srv.daemon_threads = True
        srv.block_on_close = False
        self._server = srv
        self.port = srv.server_address[1]
        self._thread = threading.Thread(
            target=srv.serve_forever, name="ops-plane", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop accepting and close the listener. Idempotent. Wedged
        handler threads (stalled peers) are daemons and are NOT joined
        — stop() returns regardless of them."""
        srv, self._server = self._server, None
        if srv is None:
            return
        srv.shutdown()
        srv.server_close()
        self._thread = None

    def __enter__(self) -> "OpsPlane":
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        return False

    # -- routing ----------------------------------------------------------
    def _handle(self, h: BaseHTTPRequestHandler) -> None:
        parsed = urlparse(h.path)
        route = parsed.path.rstrip("/") or "/"
        qs = parse_qs(parsed.query)
        try:
            if route == "/metrics":
                body, ctype, code, extra = self._metrics()
            elif route == "/healthz":
                body, ctype, code, extra = self._healthz()
            elif route == "/readyz":
                body, ctype, code, extra = self._readyz()
            elif route == "/debug/requests":
                body, ctype, code, extra = self._debug_requests()
            elif route == "/debug/flight":
                body, ctype, code, extra = self._debug_flight(qs)
            elif route == "/debug/trace":
                body, ctype, code, extra = self._debug_trace()
            elif route == "/debug/profile":
                body, ctype, code, extra = self._debug_profile()
            else:
                body = json.dumps(
                    {"error": f"no such endpoint: {route}"}).encode()
                ctype, code, extra = "application/json", 404, {}
            self._c_req().labels(endpoint=route if code != 404
                                 else "unknown").inc()
        except _BadRequest as e:
            body = json.dumps({"error": str(e)}).encode()
            ctype, code, extra = "application/json", 400, {}
        except Exception as e:
            # a broken snapshot must answer 500, counted — never kill
            # the handler thread silently or leak a traceback page
            self._c_err().inc()
            body = json.dumps({"error": repr(e)}).encode()
            ctype, code, extra = "application/json", 500, {}
        try:
            h.send_response(code)
            h.send_header("Content-Type", ctype)
            h.send_header("Content-Length", str(len(body)))
            for k, v in extra.items():
                h.send_header(k, v)
            h.end_headers()
            h.wfile.write(body)
        except (BrokenPipeError, ConnectionError, OSError):
            # the client vanished mid-write: its problem, not the
            # engine's — nothing to count, nothing to propagate
            pass

    # -- endpoints --------------------------------------------------------
    def _metrics(self):
        self.engine.publish_load_gauges()
        text = self.engine.telemetry.registry.to_prometheus_text()
        return text.encode(), PROM_CONTENT_TYPE, 200, {}

    def _healthz(self):
        eng = self.engine
        self._c_health().inc()
        body = {"alive": True,
                "ticks": int(getattr(eng, "_ticks_total", 0)),
                "active": eng.active_count(),
                "queued": eng.queue_depth()}
        return (json.dumps(body).encode(), "application/json", 200, {})

    def readiness(self):
        """``(ready, reasons, checks)`` — the ``/readyz`` computation,
        callable in-process (tests, a co-located router)."""
        eng = self.engine
        reasons = []
        checks = {}
        br = eng.breaker_state()
        checks["breaker"] = br
        if br["open"]:
            reasons.append(
                f"breaker_open:failures={br['failures']}")
        au = eng.audit_state()
        checks["audit"] = au
        if au["leaked_blocks"] or au["orphaned_pins"] or \
                au.get("leaked_host_blocks"):
            reasons.append(
                f"audit_leak:blocks={au['leaked_blocks']},"
                f"pins={au['orphaned_pins']},"
                f"host={au.get('leaked_host_blocks', 0)}")
        # tiered-KV degradation: with the device pool dry
        # AND the host tier full, preemption is back to destroying
        # work (nothing can even be parked) — the router should place
        # new load elsewhere until one tier drains
        host = eng.host_tier_state() if hasattr(eng, "host_tier_state") \
            else None
        checks["host_tier"] = host
        if host is not None:
            fb = eng.free_block_count()
            if fb == 0 and host["free"] == 0:
                reasons.append(
                    f"host_tier_exhausted:device_free=0,"
                    f"host_free=0,host_capacity={host['capacity']}")
        stalls = eng.dispatch_stalled()
        checks["dispatch_stalls_in_progress"] = stalls
        if stalls:
            reasons.append(f"dispatch_stalled:programs={stalls}")
        if self.door is not None:
            alive = self.door.pump_alive()
            checks["pump_alive"] = alive
            if not alive:
                err = self.door.pump_error
                reasons.append("pump_dead" if err is None
                               else f"pump_dead:{err!r}")
            # graceful drain: the door still SERVES what it
            # holds, but a router must stop placing new work here —
            # not-ready with an honest reason is that signal
            draining = bool(getattr(self.door, "draining", False))
            checks["draining"] = draining
            if draining:
                reasons.append("draining")
            # disaggregated prefill engine: its scarce
            # resource is prompt tokens still waiting to prefill, not
            # decode slots — saturation degrades readiness so the
            # router aims the next long prompt at another prefill
            # engine instead of queueing behind this backlog
            limit = getattr(self.door, "prefill_backlog_limit", None)
            if (getattr(self.door, "role", "mixed") == "prefill"
                    and limit is not None
                    and hasattr(eng, "prefill_backlog_tokens")):
                backlog = int(eng.prefill_backlog_tokens())
                checks["prefill_backlog_tokens"] = backlog
                if backlog >= limit:
                    reasons.append(
                        f"prefill_backlog_saturated:tokens={backlog},"
                        f"limit={limit}")
        burn, tenant, objective = eng.telemetry.slo.worst_burn()
        checks["slo_worst_burn"] = {
            "burn": burn, "tenant": tenant, "objective": objective}
        if self.slo_burn_limit is not None and \
                burn > self.slo_burn_limit:
            reasons.append(
                f"slo_burn:tenant={tenant},objective={objective},"
                f"burn={burn:.3f}")
        return (not reasons, reasons, checks)

    def _readyz(self):
        ready, reasons, checks = self.readiness()
        self._c_ready().labels(
            state="ready" if ready else "not_ready").inc()
        body = {"ready": ready, "reasons": reasons, "checks": checks}
        return (json.dumps(body).encode(), "application/json",
                200 if ready else 503, {})

    def _debug_requests(self):
        table = self.engine.debug_requests()
        return (json.dumps(table).encode(), "application/json", 200,
                {})

    def _debug_flight(self, qs):
        last = None
        if "last" in qs:
            try:
                last = int(qs["last"][0])
            except ValueError:
                raise _BadRequest(
                    f"?last= must be an integer, got {qs['last'][0]!r}")
        rec = self.engine.telemetry.recorder
        events = rec.events(last=last)
        # same shape as FlightRecorder.save(): a _meta header line,
        # then one event per line — observability.dump reads both
        meta = {"kind": "_meta", "reason": "live",
                "capacity": rec.capacity, "events": len(events),
                "dropped": rec.dropped,
                "total_events": rec.total_events}
        lines = [json.dumps(meta)]
        lines += [json.dumps(ev) for ev in events]
        body = ("\n".join(lines) + "\n").encode()
        return body, "application/x-ndjson", 200, {}

    def _debug_trace(self):
        trace = self.engine.telemetry.tracer.to_chrome_trace()
        # merge the tick profiler's lane onto the same
        # time axis: both ride the bundle's monotonic clock, so the
        # downloaded file shows request lanes AND the tick anatomy
        # without a separate aggregate step
        prof = getattr(self.engine.telemetry, "profiler", None)
        if prof is not None and prof.has_ticks():
            trace["traceEvents"].extend(
                prof.to_chrome_trace(pid=2)["traceEvents"])
        body = json.dumps(trace).encode()
        return (body, "application/json", 200,
                {"Content-Disposition":
                 'attachment; filename="requests.trace.json"'})

    def _debug_profile(self):
        fn = getattr(self.engine, "profile_state", None)
        state = fn() if fn is not None else {
            "enabled": False, "profiler": None, "top_programs": [],
            "replicas": None}
        return (json.dumps(state).encode(), "application/json", 200,
                {})
