"""The front door: a live, multi-tenant server over ``ServingEngine``.

The port's copy of ``paddle_tpu/inference/frontend/server.py``: the
same pump, handles, admission and lifecycle over the port's engine.

``ServingEngine.run()`` is a host loop over whatever was submitted
before the call — fine for replaying traces, useless for serving: a
production front end must ACCEPT requests while the engine runs,
stream tokens back as they commit, cancel on client disconnect, and
push back when overloaded. :class:`FrontDoor` adds exactly that layer,
entirely ABOVE the compiled programs (Orca/Sarathi's observation,
PAPERS.md: admission, fairness and preemption are host policies; the
executables never change):

- a daemon PUMP THREAD drives the engine; when idle it parks on the
  engine's wake condition (no busy-poll) and is woken by ``submit()``
  / ``cancel()`` from any thread;
- ``submit()`` is thread-safe, checks admission bounds (global and
  per-tenant queue depth — :mod:`.admission`) and returns a
  :class:`RequestHandle` whose token stream is consumable as a plain
  iterator OR an ``async for`` iterable; the handle also exposes
  ``cancel()``, ``wait()`` and ``result()``;
- per-request :class:`~paddle_tpu_torch.inference.frontend.sampling.
  SamplingParams` (temperature/top-k/top-p/greedy/seed) ride the
  engine's runtime per-slot vectors — any mix, two executables;
- ``deadline`` is a seconds BUDGET from submission: a request that
  cannot finish inside it is retired ``deadline_exceeded`` (queued or
  running) instead of burning slots on an answer nobody is waiting
  for.

Scheduling policy is the engine's pluggable ``scheduler`` — the
default built here is a :class:`~.scheduler.FairScheduler` over the
given tenants (weighted fair queuing, priority tiers, hard starvation
bound, SLO-aware preemption victims).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, Optional, Sequence

from paddle_tpu_torch.inference.serving import Request, ServingEngine

from .admission import AdmissionController, AdmissionRejected
from .sampling import SamplingParams
from .scheduler import FairScheduler, Tenant

__all__ = ["FrontDoor", "RequestHandle"]

_DONE = object()     # token-stream sentinel


class RequestHandle:
    """A live request's client-side handle.

    Iterate it (sync or ``async for``) to stream token ids as they
    commit; iteration ends when the request retires for ANY reason —
    check ``finish_reason`` afterwards (``"eos"``, ``"length"``,
    ``"cancelled"``, ``"deadline_exceeded"``, ``"complete"`` for
    score/embed, ``"constraint_dead_end"`` for a constrained request
    whose grammar ran out of legal moves). The handle is also a
    future: ``wait()`` blocks until retirement, ``result()`` returns
    the full token list (raising on cancellation/deadline unless
    ``strict=False``)."""

    def __init__(self, door: "FrontDoor",
                 on_token: Optional[Callable] = None):
        self._door = door
        self._user_on_token = on_token
        self._q: "queue.Queue" = queue.Queue()
        self._finished = threading.Event()
        self.request: Optional[Request] = None   # set by submit()

    # engine-thread callbacks ---------------------------------------------
    def _on_token(self, req: Request, tok: int, done: bool) -> None:
        self._q.put(int(tok))
        if self._user_on_token is not None:
            self._user_on_token(req, tok, done)

    def _on_finish(self, req: Request) -> None:
        self._q.put(_DONE)
        self._finished.set()

    # client side ---------------------------------------------------------
    @property
    def id(self) -> int:
        return self.request.id

    @property
    def tokens(self):
        return list(self.request.tokens)

    @property
    def status(self) -> str:
        return self.request.status

    @property
    def finish_reason(self) -> Optional[str]:
        return self.request.finish_reason

    def cancel(self) -> bool:
        """Request cancellation; queued requests drop on the next
        scheduler pass, running ones retire at the next tick boundary
        with reason ``"cancelled"``. Returns False if already done."""
        return self._door.cancel(self)

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._finished.wait(timeout)

    def result(self, timeout: Optional[float] = None,
               strict: bool = True):
        """Block until retirement and return the token list. With
        ``strict`` (default) a cancelled/deadline-exceeded request
        raises RuntimeError instead of returning a partial answer.
        ``"complete"`` (score/embed) is a success — read
        ``handle.request.logprobs`` / ``.embedding`` for the payload;
        ``"constraint_dead_end"`` is strict-fatal: the tokens are all
        grammar-legal but the output is not a finished match."""
        if not self.wait(timeout):
            raise TimeoutError(
                f"request {self.request.id} not finished within "
                f"{timeout}s")
        if strict and self.finish_reason not in ("eos", "length",
                                                 "complete"):
            raise RuntimeError(
                f"request {self.request.id} retired with reason "
                f"{self.finish_reason!r}")
        return self.tokens

    def __iter__(self) -> Iterable[int]:
        while True:
            item = self._q.get()
            if item is _DONE:
                return
            yield item

    def __aiter__(self):
        return self._aiter()

    async def _aiter(self):
        import asyncio

        loop = asyncio.get_event_loop()
        while True:
            item = await loop.run_in_executor(None, self._q.get)
            if item is _DONE:
                return
            yield item


class FrontDoor:
    """Thread-pump server over a :class:`ServingEngine`.

    Parameters
    ----------
    model : optional
        Builds a fresh engine (with ``**engine_kwargs``) when
        ``engine`` is not given.
    engine : ServingEngine, optional
        Serve an existing engine (its scheduler is used as-is).
    tenants : sequence of Tenant, optional
        Tenant configs for the default :class:`FairScheduler`; unknown
        tenant names submitted later get default weight/tier.
    scheduler : optional
        Explicit policy for the built engine (overrides ``tenants``).
    max_queue_depth / max_tenant_depth / admission :
        Backpressure bounds (see :class:`AdmissionController`); pass
        ``admission=`` to inject a custom controller.
    ops_port : int, optional
        Attach an :class:`~paddle_tpu_torch.observability.ops_plane.
        OpsPlane` for the door's lifetime: ``start()`` binds it (0 =
        ephemeral port, read ``door.ops.port`` back), ``stop()``
        detaches it. ``/readyz`` then also degrades on pump death.
        ``ops_host`` widens the bind address beyond loopback.
    ingest_port : int, optional
        Attach an :class:`~paddle_tpu_torch.inference.frontend.ingest.
        IngestServer` — the HTTP request front door (`/v1/submit`,
        SSE `/v1/stream/{id}`, `/v1/cancel/{id}`, migration and drain
        endpoints) — for the door's lifetime, same semantics as
        ``ops_port`` (0 = ephemeral, read ``door.ingest.port`` back).
    ingest_api_key : str, optional
        Static bearer token the attached ingest server requires on
        every request (``Authorization: Bearer <key>``); missing or
        wrong keys get a counted 401. ``None`` (default) leaves the
        listener open — auth off.
    role : str
        Fleet role: ``"mixed"`` (default) serves everything;
        ``"prefill"`` marks this engine as the long-prompt prefill leg
        of a disaggregated fleet (the router sends it handoff traffic
        and steers ordinary traffic elsewhere); ``"decode"`` marks a
        preferred handoff destination. Declarative — behaviour lives
        in the :class:`~paddle_tpu_torch.inference.fleet.router.FleetRouter`.
    prefill_backlog_limit : int, optional
        For a ``role="prefill"`` door only: when the engine's
        un-prefilled prompt backlog (``serving_prefill_backlog_tokens``)
        reaches this many tokens, ``/readyz`` degrades with reason
        ``prefill_backlog_saturated`` so the router stops feeding it.

    Use as a context manager, or ``start()`` / ``stop()`` explicitly.
    ``stop(drain=True)`` (default) lets queued work finish;
    ``drain=False`` cancels everything in flight first. ``stop()`` is
    idempotent and safe to call concurrently (double-stop during
    failover is the fleet router's normal path).
    """

    def __init__(self, model=None, *, engine: Optional[ServingEngine] = None,
                 tenants: Optional[Sequence[Tenant]] = None,
                 scheduler=None, max_queue_depth: int = 256,
                 max_tenant_depth: Optional[int] = None,
                 admission: Optional[AdmissionController] = None,
                 ops_port: Optional[int] = None,
                 ops_host: str = "127.0.0.1",
                 ingest_port: Optional[int] = None,
                 ingest_host: str = "127.0.0.1",
                 ingest_api_key: Optional[str] = None,
                 role: str = "mixed",
                 prefill_backlog_limit: Optional[int] = None,
                 **engine_kwargs):
        if role not in ("prefill", "decode", "mixed"):
            raise ValueError(
                f"role must be 'prefill', 'decode' or 'mixed', got "
                f"{role!r}")
        if prefill_backlog_limit is not None:
            if role != "prefill":
                raise ValueError(
                    "prefill_backlog_limit only applies to a "
                    f"role='prefill' door (this one is {role!r}); a "
                    "mixed/decode door's readiness already tracks "
                    "slots and blocks")
            if int(prefill_backlog_limit) <= 0:
                raise ValueError(
                    f"prefill_backlog_limit must be > 0, got "
                    f"{prefill_backlog_limit}")
        if engine is None:
            if model is None:
                raise ValueError("FrontDoor needs a model or an engine")
            if scheduler is None:
                scheduler = FairScheduler(tenants=tenants)
            engine = ServingEngine(model, scheduler=scheduler,
                                   **engine_kwargs)
        elif scheduler is not None or tenants is not None:
            raise ValueError(
                "pass tenants/scheduler when FrontDoor builds the "
                "engine; an injected engine keeps its own scheduler")
        self.engine = engine
        self.scheduler = engine.scheduler
        # disaggregated-fleet role: purely declarative here
        # — the fleet router reads it off EngineRef to steer placement
        # and handoffs; the door itself only uses it for /readyz's
        # prefill-backlog saturation signal
        self.role = role
        self.prefill_backlog_limit = (
            int(prefill_backlog_limit)
            if prefill_backlog_limit is not None else None)
        self.admission = admission if admission is not None else \
            AdmissionController(max_queue_depth=max_queue_depth,
                                max_tenant_depth=max_tenant_depth)
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        # stop() must be idempotent and safe against concurrent
        # callers (double-stop during failover is the router's normal
        # path): the whole teardown runs under this lock, and the
        # thread handle is claimed atomically inside it
        self._stop_lock = threading.Lock()
        self._pump_error: Optional[BaseException] = None
        # draining: stop ACCEPTING without stopping SERVING — the
        # graceful half of shutdown the fleet router drives before a
        # migrate-off (/readyz degrades, submit rejects "draining",
        # everything in flight runs out)
        self._draining = False
        self._ops_port = ops_port
        self._ops_host = ops_host
        self.ops = None          # OpsPlane while attached
        self._ingest_port = ingest_port
        self._ingest_host = ingest_host
        self._ingest_api_key = ingest_api_key
        self.ingest = None       # IngestServer while attached
        reg = engine.telemetry.registry
        self._c_rejected = reg.counter(
            "frontdoor_rejected_total",
            "submissions rejected at admission", labelnames=("reason",))
        self._c_cancelled = reg.counter(
            "frontdoor_cancel_requests_total",
            "cancellations requested through the front door")

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "FrontDoor":
        if self._thread is not None:
            raise RuntimeError("FrontDoor already started")
        self._stop = False
        self._thread = threading.Thread(
            target=self._pump, daemon=True, name="frontdoor-pump")
        self._thread.start()
        if self._ops_port is not None and self.ops is None:
            # attach AFTER the pump is up, so the very first /readyz a
            # router sees is answered against a live pump (lazy import:
            # observability.ops_plane is only needed when asked for).
            # A bind failure (e.g. the port is taken) must not leak
            # the just-started pump: callers see the error BEFORE
            # __enter__ returns, so __exit__ would never stop it.
            from paddle_tpu_torch.observability.ops_plane import OpsPlane

            try:
                self.ops = OpsPlane(self, port=self._ops_port,
                                    host=self._ops_host).start()
            except BaseException:
                try:
                    self.stop(drain=False)
                except Exception:
                    pass    # the bind failure is the actionable error
                raise
        if self._ingest_port is not None and self.ingest is None:
            from paddle_tpu_torch.inference.frontend.ingest import IngestServer

            try:
                self.ingest = IngestServer(
                    self, port=self._ingest_port,
                    host=self._ingest_host,
                    api_key=self._ingest_api_key).start()
            except BaseException:
                try:
                    self.stop(drain=False)
                except Exception:
                    pass    # the bind failure is the actionable error
                raise
        return self

    def pump_alive(self) -> bool:
        """True while the pump thread is running and has not died —
        the readiness signal the ops plane's ``/readyz`` consults
        (this method is also how :class:`~paddle_tpu_torch.observability.
        ops_plane.OpsPlane` recognizes a FrontDoor)."""
        return (self._thread is not None and self._thread.is_alive()
                and self._pump_error is None)

    @property
    def pump_error(self) -> Optional[BaseException]:
        """The exception that killed the pump, if it died (sticky
        until ``stop()`` re-raises it)."""
        return self._pump_error

    def _pump(self):
        eng = self.engine
        try:
            while True:
                with eng._wake:
                    while not self._stop and not (
                            eng.scheduler.depth() or eng.active_count()
                            or eng.boundary_jobs_pending()):
                        # parked, not polling: submit()/cancel()/
                        # at_tick_boundary() notify this condition; the
                        # timeout only bounds shutdown latency if a
                        # notify is ever missed
                        eng._wake.wait(timeout=0.5)
                    if self._stop and not (eng.scheduler.depth()
                                           or eng.active_count()):
                        return
                # keep ONE serving epoch across bursts: arrival stamps,
                # deadlines and the metrics window stay on one anchor
                # for the server's whole life. Each iteration (one
                # run() burst between idle parks) is wall-timed into
                # the registry: pump-iteration duration is
                # the front door's own tick anatomy — a long
                # iteration means the engine held the pump through a
                # long busy stretch, visible on the same scrape as
                # the engine's tick phases. Resolved get-or-create
                # per iteration so a set_telemetry() swap moves the
                # series with every other serving family.
                t0 = time.perf_counter()
                eng.run(keep_epoch=True)
                dt = time.perf_counter() - t0
                reg = eng.telemetry.registry
                reg.counter(
                    "frontdoor_pump_iterations_total",
                    "engine.run bursts the pump has driven").inc()
                reg.histogram(
                    "frontdoor_pump_iteration_seconds",
                    "wall duration of one pump iteration (an "
                    "engine.run burst between idle parks)").observe(dt)
        except BaseException as e:     # surfaced by stop()/submit()
            self._pump_error = e
            # postmortem BEFORE the handles unblock: the pump can die
            # outside run() (whose own crash dump then never fired),
            # and the clients about to receive 'error' will ask what
            # happened — the engine_died event + ring dump is the
            # answer. When run() already dumped, this tagged dump is
            # a deliberate superset (it carries engine_died and the
            # pump context) — two small files per fatal incident beat
            # a postmortem missing its last event. Best-effort: a
            # broken recorder must not keep the handles hanging.
            try:
                eng.telemetry.recorder.record(
                    "engine_died", error=repr(e),
                    active=eng.active_count(),
                    queued=eng.queue_depth())
                path = eng.telemetry.recorder.dump_on_crash(
                    e, context={"source": "frontdoor_pump",
                                "active": eng.active_count(),
                                "queued": eng.queue_depth()},
                    tag="pump")
                if path is not None:
                    import sys

                    print(f"[frontdoor] pump died; flight recorder "
                          f"dumped to {path}", file=sys.stderr)
            except Exception as rec_err:
                # counted + warned, never silently swallowed — the
                # same contract as the engine's own crash path (and
                # _warn_dump_failed itself never raises)
                eng._warn_dump_failed("pump postmortem", rec_err)
            self._fail_outstanding()

    def _fail_outstanding(self):
        """The pump died: every in-flight handle must UNBLOCK — a
        client parked in ``for tok in h`` or ``wait()`` with no pump
        left would hang forever. Each live request's on_finish fires
        with ``finish_reason='error'``; strict ``result()`` then
        raises instead of returning a partial answer."""
        eng = self.engine
        try:
            with eng._lock:
                live = [r for r in eng._slots if r is not None]
                live += eng.scheduler.pending()
        except Exception:
            return
        for r in live:
            try:
                if r.finish_reason is None:
                    r.finish_reason = "error"
                r.status = "done"
                if r.on_finish is not None:
                    r.on_finish(r)
            except Exception:
                continue

    def drain(self) -> dict:
        """Graceful-shutdown half-step: stop ACCEPTING (``submit()``
        rejects with reason ``"draining"``, ``/readyz`` degrades)
        while the pump keeps serving everything already admitted. The
        fleet router calls this before migrating victims off or
        retiring the engine; returns the in-flight census the caller
        waits out."""
        self._draining = True
        eng = self.engine
        with eng._telemetry("draining event"):
            eng.telemetry.recorder.record(
                "draining", active=eng.active_count(),
                queued=eng.queue_depth())
        return {"draining": True, "active": eng.active_count(),
                "queued": eng.queue_depth()}

    @property
    def draining(self) -> bool:
        return self._draining

    def stop(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop the pump. ``drain=True`` serves out everything already
        accepted first; ``drain=False`` cancels queued AND running
        requests (they retire ``"cancelled"``) before stopping. An
        attached ops plane / ingest server is detached on every exit
        path — including the re-raise of a pump death — so a stopped
        door never leaves a live HTTP listener behind. Idempotent and
        safe under CONCURRENT callers (double-stop during failover is
        the fleet router's normal path, often racing a pump that is
        dying at that very moment): callers serialize on one lock,
        exactly one claims the thread, joins it and re-raises a pump
        death; every other call is a clean no-op."""
        with self._stop_lock:
            thread, self._thread = self._thread, None
            if thread is None:
                self._detach_ingest()
                self._detach_ops()
                return
            try:
                if not drain:
                    with self.engine._lock:
                        live = [r for r in self.engine._slots
                                if r is not None]
                        live += self.engine.scheduler.pending()
                    # flag everything; the pump's next pass retires
                    # each with reason "cancelled" through normal
                    # bookkeeping
                    for r in live:
                        self.engine.cancel(r)
                self._stop = True
                self.engine._wake_up()
                thread.join(timeout)
                if thread.is_alive():
                    # put the handle back so the caller can retry the
                    # join; nothing was torn down yet
                    self._thread = thread
                    raise TimeoutError(
                        "front-door pump did not stop in time")
                if self._pump_error is not None:
                    err, self._pump_error = self._pump_error, None
                    raise err
            finally:
                self._detach_ingest()
                self._detach_ops()

    def _detach_ops(self):
        if self.ops is not None:
            ops, self.ops = self.ops, None
            ops.stop()

    def _detach_ingest(self):
        if self.ingest is not None:
            ingest, self.ingest = self.ingest, None
            ingest.stop()

    def __enter__(self) -> "FrontDoor":
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop(drain=exc_type is None)
        return False

    # -- request API ------------------------------------------------------
    def submit(self, prompt: Sequence[int], *, tenant: str = "default",
               sampling: Optional[SamplingParams] = None,
               max_new_tokens: int = 32,
               deadline: Optional[float] = None,
               priority: Optional[int] = None,
               eos_id: Optional[int] = None,
               adapter: Optional[str] = None,
               kind: str = "generate",
               on_token: Optional[Callable] = None) -> RequestHandle:
        """Enqueue a request; thread-safe, callable while the engine
        is mid-flight. ``deadline`` is a seconds budget from NOW.
        Raises :class:`AdmissionRejected` (with a machine-readable
        reason) when a queue bound is hit — the explicit backpressure
        signal.

        ``kind`` selects the surface: ``"generate"``
        (default) decodes; ``"score"`` returns per-position prompt
        logprobs on ``handle.request.logprobs`` and ``"embed"`` the
        final hidden state on ``handle.request.embedding`` — both
        retire at prefill completion (reason ``"complete"``) with no
        decode loop, and the default FairScheduler places them in its
        throughput tier. Constrained decoding rides
        ``sampling.response_format`` (generate only)."""
        if self._pump_error is not None:
            # sticky: EVERY submit against a dead pump must refuse —
            # clearing here would let the next one enqueue onto an
            # engine no thread is driving and hang its handle
            raise RuntimeError("front-door pump died") from \
                self._pump_error
        eng = self.engine
        handle = RequestHandle(self, on_token=on_token)
        with eng._lock:
            if self._draining:
                self._c_rejected.labels(reason="draining").inc()
                eng.telemetry.recorder.record(
                    "admit_rejected", reason="draining", tenant=tenant,
                    queued=eng.scheduler.depth(),
                    prompt_len=len(prompt))
                raise AdmissionRejected(
                    "draining", "front door is draining; place this "
                    "request on another engine", tenant=tenant)
            try:
                self.admission.check(eng.scheduler, tenant)
            except AdmissionRejected as e:
                self._c_rejected.labels(reason=e.reason).inc()
                eng.telemetry.recorder.record(
                    "admit_rejected", reason=e.reason, tenant=tenant,
                    queued=eng.scheduler.depth(),
                    prompt_len=len(prompt))
                raise
            # stamp the request's due time on the ENGINE clock: live
            # submissions are due now, and queue-wait/deadline charge
            # from this instant (not from the serving epoch's start)
            arrival = eng._now() if eng._t0 is not None else 0.0
            req = Request(
                prompt=list(prompt), max_new_tokens=max_new_tokens,
                eos_id=eos_id, sampling=sampling, tenant=tenant,
                priority=priority, adapter=adapter, kind=kind,
                arrival_time=arrival,
                deadline=None if deadline is None
                else arrival + float(deadline),
                on_token=handle._on_token, on_finish=handle._on_finish)
            handle.request = req
            eng.submit(req)
        return handle

    def cancel(self, handle: RequestHandle) -> bool:
        return self.cancel_request(handle.request)

    def cancel_request(self, req: Request) -> bool:
        """Cancel by engine-side :class:`Request` — the ingest layer
        holds requests (not handles) for streams it serves over HTTP."""
        self._c_cancelled.inc()
        return self.engine.cancel(req)

    # -- introspection ----------------------------------------------------
    def metrics(self):
        """The engine's live :class:`ServingMetrics` window."""
        return self.engine.metrics

    def queue_depth(self) -> int:
        return self.engine.scheduler.depth()

    def active_count(self) -> int:
        return self.engine.active_count()
