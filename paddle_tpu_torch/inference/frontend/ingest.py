"""HTTP request ingest: the fleet-facing front door over the wire.

The port's copy of ``paddle_tpu/inference/frontend/ingest.py``.

:class:`~paddle_tpu_torch.inference.frontend.server.FrontDoor` made the
engine a live server for IN-PROCESS callers; this module is the same
contract over HTTP, stdlib-only (``http.server``), so N engine
processes can sit behind one fleet router with nothing but sockets
between them::

    door = FrontDoor(model, ingest_port=0, ops_port=0, ...).start()
    # curl -d '{"prompt": [1,2,3], "max_new_tokens": 8}' \\
    #      http://127.0.0.1:{door.ingest.port}/v1/submit

Endpoints:

- ``POST /v1/submit`` — JSON body (``prompt`` [ints], ``max_new_
  tokens``, ``tenant``, ``eos_id``, ``deadline``, ``priority``,
  ``kind`` {generate|score|embed}, ``sampling`` {temperature, top_k,
  top_p, greedy, seed, response_format}) -> ``{"id": rid}``.
  Backpressure answers 429, draining/pump-death 503, malformed input
  400/413 — every rejection counted by reason
  (``ingest_rejections_total``), never a stalled client.
- ``POST /v1/score`` / ``POST /v1/embed`` — the batched surfaces
  as synchronous calls: same body as submit (no
  ``kind``/``sampling``), waits for the request to retire at prefill
  completion and answers ``{"id", "logprobs": [...]}`` /
  ``{"id", "embedding": [...]}`` in one round trip (202 with the id
  if still queued past the wait bound — poll ``/v1/requests/{id}``,
  whose body carries the payload once done).
- ``GET /v1/stream/{id}?from=N`` — Server-Sent Events: one
  ``data: {"token": t, "index": i}`` event per committed token
  (starting at index N — reconnect/resume is a query param, which is
  also how a router resumes a migrated stream on the peer), then one
  ``data: {"done": true, "finish_reason": ...}`` terminator. A
  request that migrated away terminates with reason ``"migrated"`` —
  a forwarding address, not an error.
- ``POST /v1/cancel/{id}`` -> ``{"cancelled": bool}``.
- ``GET /v1/requests/{id}`` — status/tokens snapshot (the router's
  reconciliation read).
- ``POST /v1/migrate_out/{id}`` — snapshot-and-retire the live
  request at the next tick boundary; the response body IS the
  snapshot byte frame (``application/octet-stream``). 409 when the
  request already finished (the race every migration has to lose
  gracefully).
- ``POST /v1/migrate_in`` — body is a snapshot frame from a peer's
  migrate-out; restores at the tick boundary ->
  ``{"id", "outcome", "tokens_done"}`` (outcome ``swap_in`` |
  ``reprefill`` | ``corrupt_fallback`` — a corrupt transfer degrades
  to re-prefill, counted, never a crash).
- ``POST /v1/drain`` — graceful draining: stop accepting, keep
  serving (``/readyz`` degrades with reason ``"draining"``).

Auth: pass ``api_key=`` (or ``FrontDoor(ingest_api_key=)``)
to require ``Authorization: Bearer <key>`` on EVERY endpoint; a
missing or wrong key answers 401 as a counted typed rejection
(``ingest_rejections_total{reason="unauthorized"}``). Off by default —
a loopback dev listener stays curl-able.

Isolation contract (the ops plane's, extended): handlers run on their
own daemon threads with socket timeouts; non-stream responses are
complete byte strings built before the first write. SSE is the one
deliberately streaming surface — a wedged or vanished consumer costs
exactly one handler thread until its socket times out (counted
``ingest_stream_aborts_total``), and NEVER touches the pump or the
tick loop, because the stream thread only reads request state under
its own condition variable.
"""

from __future__ import annotations

import hmac
import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, urlparse

from .admission import AdmissionRejected
from .sampling import SamplingParams

__all__ = ["IngestServer"]

SSE_CONTENT_TYPE = "text/event-stream; charset=utf-8"


class _Reject(Exception):
    """A counted, typed ingest rejection: HTTP ``code`` + machine-
    readable ``reason`` (the ``ingest_rejections_total`` label) +
    human message."""

    def __init__(self, code: int, reason: str, message: str):
        super().__init__(message)
        self.code = code
        self.reason = reason


class _Entry:
    """Registry row for one HTTP-visible request: the engine-side
    Request plus the condition its stream threads wait on. Token
    commits notify; finish is detected by status (the engine's
    on_finish hook belongs to the RequestHandle for submits, so the
    stream loop polls status on a short wait — bounded staleness,
    zero coupling to the pump)."""

    def __init__(self):
        self.req = None           # set right after submit/restore
        self.cond = threading.Condition()

    # engine-thread callback (rides FrontDoor's user on_token seam or
    # restore_request overrides)
    def notify_token(self, req, tok, done):
        with self.cond:
            self.cond.notify_all()

    def notify_finish(self, req):
        with self.cond:
            self.cond.notify_all()


class IngestServer:
    """HTTP ingest over a :class:`FrontDoor`.

    Parameters
    ----------
    door : FrontDoor
        The in-process front door; submissions ride its admission
        bounds, handles and pump untouched.
    port / host :
        Bind address; port 0 (default) is ephemeral — read
        ``server.port`` back after :meth:`start`.
    max_body_bytes : int
        Hard cap on a ``/v1/submit`` (and any JSON) body; larger
        answers 413 ``body_too_large``.
    max_frame_bytes : int
        Cap for ``/v1/migrate_in`` snapshot frames (KV payloads are
        orders of magnitude bigger than prompts).
    handler_timeout : float
        Socket timeout per handler thread: bounds how long a wedged
        peer can pin one daemon thread (reads AND stream writes).
    boundary_timeout : float
        How long a migrate in/out waits for the engine's next tick
        boundary before answering 503 (a dead pump must fail the
        migration, not hang the router).
    retain_finished : int
        Finished requests kept in the registry for late status/stream
        reads before eviction.
    api_key : str, optional
        Static bearer token required on every endpoint
        (``Authorization: Bearer <key>``, compared constant-time);
        missing/wrong answers a counted 401. ``None`` (default)
        disables auth.
    """

    def __init__(self, door, port: int = 0, host: str = "127.0.0.1",
                 max_body_bytes: int = 1 << 20,
                 max_frame_bytes: int = 256 << 20,
                 handler_timeout: float = 60.0,
                 boundary_timeout: float = 30.0,
                 retain_finished: int = 512,
                 api_key: Optional[str] = None):
        if not hasattr(door, "pump_alive"):
            raise TypeError(
                f"IngestServer needs a FrontDoor, got "
                f"{type(door).__name__} (bare engines have no "
                "admission or pump to serve HTTP traffic with)")
        self.door = door
        self.engine = door.engine
        self.host = host
        self.port = int(port)        # rewritten to the bound port
        self.max_body_bytes = int(max_body_bytes)
        self.max_frame_bytes = int(max_frame_bytes)
        self.handler_timeout = float(handler_timeout)
        self.boundary_timeout = float(boundary_timeout)
        self.retain_finished = int(retain_finished)
        self.api_key = api_key
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._entries: Dict[int, _Entry] = {}
        self._conns: set = set()     # live SSE sockets (for kill())
        # eager registration: a scrape before first traffic shows 0s
        for c in (self._c_req, self._c_rej, self._c_streams,
                  self._c_aborts, self._c_mig_in, self._c_mig_out):
            c()

    # counters re-resolved against the engine's CURRENT registry so a
    # set_telemetry() swap moves the family (ops-plane discipline)
    def _c_req(self):
        return self.engine.telemetry.registry.counter(
            "ingest_requests_total",
            "ingest HTTP requests served, by endpoint",
            labelnames=("endpoint",))

    def _c_rej(self):
        return self.engine.telemetry.registry.counter(
            "ingest_rejections_total",
            "ingest requests refused, by machine-readable reason "
            "(backpressure, draining, malformed input, unknown id, "
            "pump death, boundary timeout)", labelnames=("reason",))

    def _c_streams(self):
        return self.engine.telemetry.registry.counter(
            "ingest_streams_total", "SSE token streams opened")

    def _c_aborts(self):
        return self.engine.telemetry.registry.counter(
            "ingest_stream_aborts_total",
            "SSE streams severed before their terminator (client "
            "vanished or wedged past the socket timeout; costs one "
            "handler thread, never the pump)")

    def _c_mig_in(self):
        return self.engine.telemetry.registry.counter(
            "ingest_migrations_in_total",
            "snapshot frames restored from a peer, by KV outcome",
            labelnames=("outcome",))

    def _c_mig_out(self):
        return self.engine.telemetry.registry.counter(
            "ingest_migrations_out_total",
            "live requests snapshot-and-retired for a peer")

    # -- lifecycle --------------------------------------------------------
    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "IngestServer":
        if self._server is not None:
            raise RuntimeError("IngestServer already started")
        ingest = self

        class Handler(BaseHTTPRequestHandler):
            timeout = ingest.handler_timeout
            protocol_version = "HTTP/1.1"

            def do_GET(self):
                ingest._handle(self, "GET")

            def do_POST(self):
                ingest._handle(self, "POST")

            def log_message(self, *args):    # no stderr chatter
                pass

        srv = ThreadingHTTPServer((self.host, self.port), Handler)
        srv.daemon_threads = True
        srv.block_on_close = False
        self._server = srv
        self.port = srv.server_address[1]
        self._thread = threading.Thread(
            target=srv.serve_forever, name="ingest", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop accepting and close the listener. Idempotent. Stream
        handler threads are daemons with socket timeouts and are not
        joined."""
        srv, self._server = self._server, None
        if srv is None:
            return
        srv.shutdown()
        srv.server_close()
        self._thread = None

    def kill(self) -> None:
        """Abrupt teardown for chaos tests: close the listener AND
        sever every live SSE socket mid-stream, the way a SIGKILL'd
        process drops its connections — clients see a reset, not a
        graceful terminator."""
        self.stop()
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                # shutdown, not close: the handler thread's makefile()
                # objects hold _io_refs on the socket, so close() here
                # would be deferred until the handler exits — the
                # opposite of a kill. shutdown() severs the TCP stream
                # immediately regardless of references.
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    # -- registry ---------------------------------------------------------
    def _register(self, entry: _Entry) -> None:
        with self._lock:
            self._entries[entry.req.id] = entry
            if len(self._entries) > self.retain_finished:
                # evict oldest FINISHED rows (dict preserves insertion
                # order); live rows are never evicted
                for rid in list(self._entries):
                    if len(self._entries) <= self.retain_finished:
                        break
                    r = self._entries[rid].req
                    if r is not None and r.status == "done":
                        del self._entries[rid]

    def _entry(self, rid: int) -> _Entry:
        with self._lock:
            entry = self._entries.get(rid)
        if entry is None:
            raise _Reject(404, "unknown_id",
                          f"no such request id {rid} on this engine")
        return entry

    # -- routing ----------------------------------------------------------
    def _handle(self, h: BaseHTTPRequestHandler, method: str) -> None:
        parsed = urlparse(h.path)
        route = parsed.path.rstrip("/") or "/"
        qs = parse_qs(parsed.query)
        endpoint = route
        try:
            self._check_auth(h)
            if method == "POST" and route == "/v1/submit":
                body, ctype, code = self._submit(h)
            elif method == "POST" and route == "/v1/score":
                body, ctype, code = self._batch(h, "score")
            elif method == "POST" and route == "/v1/embed":
                body, ctype, code = self._batch(h, "embed")
            elif method == "GET" and route.startswith("/v1/stream/"):
                endpoint = "/v1/stream"
                self._stream(h, self._route_rid(route, 3), qs)
                return                   # streamed its own response
            elif method == "POST" and route.startswith("/v1/cancel/"):
                endpoint = "/v1/cancel"
                body, ctype, code = self._cancel(
                    self._route_rid(route, 3))
            elif method == "GET" and route.startswith("/v1/requests/"):
                endpoint = "/v1/requests"
                body, ctype, code = self._status(
                    self._route_rid(route, 3))
            elif method == "POST" and \
                    route.startswith("/v1/migrate_out/"):
                endpoint = "/v1/migrate_out"
                body, ctype, code = self._migrate_out(
                    self._route_rid(route, 3))
            elif method == "POST" and route == "/v1/migrate_in":
                body, ctype, code = self._migrate_in(h, qs)
            elif method == "POST" and route == "/v1/drain":
                body, ctype, code = self._drain()
            else:
                endpoint = "unknown"
                body = json.dumps(
                    {"error": f"no such endpoint: {method} "
                     f"{route}"}).encode()
                ctype, code = "application/json", 404
            self._c_req().labels(endpoint=endpoint).inc()
        except _Reject as e:
            self._c_rej().labels(reason=e.reason).inc()
            body = json.dumps(
                {"error": str(e), "reason": e.reason}).encode()
            ctype, code = "application/json", e.code
            if code in (401, 411, 413):
                # the unread body must not be parsed as the next
                # request on this keep-alive socket (401 rejects
                # BEFORE reading any body)
                h.close_connection = True
        except Exception as e:
            # a handler bug answers 500 — counted via the rejection
            # family so the fleet bench's zero-crash arithmetic sees it
            self._c_rej().labels(reason="internal_error").inc()
            body = json.dumps({"error": repr(e),
                               "reason": "internal_error"}).encode()
            ctype, code = "application/json", 500
        self._respond(h, code, ctype, body)

    def _check_auth(self, h) -> None:
        """Static bearer-token gate. Runs before routing
        and before any body read, so an unauthorized caller learns
        nothing — not even which endpoints exist. Constant-time
        compare: a timing probe must not leak key prefixes."""
        if self.api_key is None:
            return
        auth = h.headers.get("Authorization") or ""
        if not hmac.compare_digest(auth, f"Bearer {self.api_key}"):
            raise _Reject(401, "unauthorized",
                          "missing or invalid bearer token")

    @staticmethod
    def _route_rid(route: str, seg: int) -> int:
        part = route.split("/")[seg]
        try:
            return int(part)
        except ValueError:
            raise _Reject(400, "bad_field",
                          f"request id must be an integer, got "
                          f"{part!r}")

    @staticmethod
    def _respond(h, code: int, ctype: str, body: bytes) -> None:
        try:
            h.send_response(code)
            h.send_header("Content-Type", ctype)
            h.send_header("Content-Length", str(len(body)))
            h.end_headers()
            h.wfile.write(body)
        except (BrokenPipeError, ConnectionError, OSError):
            pass    # client vanished mid-write: its problem

    def _read_body(self, h, limit: int) -> bytes:
        cl = h.headers.get("Content-Length")
        if cl is None:
            raise _Reject(411, "length_required",
                          "Content-Length is required")
        try:
            n = int(cl)
        except ValueError:
            raise _Reject(400, "bad_field",
                          f"bad Content-Length {cl!r}")
        if n < 0 or n > limit:
            raise _Reject(413, "body_too_large",
                          f"body of {n} bytes exceeds the {limit}-"
                          "byte bound")
        data = h.rfile.read(n)
        if len(data) != n:
            raise _Reject(400, "bad_field",
                          "body shorter than its Content-Length")
        return data

    def _read_json(self, h) -> Dict[str, Any]:
        data = self._read_body(h, self.max_body_bytes)
        try:
            payload = json.loads(data)
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise _Reject(400, "bad_json", f"body is not JSON ({e})")
        if not isinstance(payload, dict):
            raise _Reject(400, "bad_json",
                          "body must be a JSON object")
        return payload

    # -- endpoints --------------------------------------------------------
    def _parse_submit(self, payload):
        prompt = payload.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) and not isinstance(t, bool)
                           for t in prompt)):
            raise _Reject(400, "bad_field",
                          "prompt must be a non-empty list of ints")
        kwargs: Dict[str, Any] = {}
        if "response_format" in payload:
            # unknown top-level keys are ignored, but a misplaced
            # constraint must NOT be — the request would serve
            # unconstrained while the caller believes the output is
            # grammar-valid
            raise _Reject(400, "bad_field",
                          "response_format belongs inside 'sampling'")
        if "max_new_tokens" in payload:
            kwargs["max_new_tokens"] = payload["max_new_tokens"]
        if "tenant" in payload:
            if not isinstance(payload["tenant"], str):
                raise _Reject(400, "bad_field", "tenant must be a str")
            kwargs["tenant"] = payload["tenant"]
        for key in ("eos_id", "priority"):
            if payload.get(key) is not None:
                kwargs[key] = payload[key]
        if payload.get("adapter") is not None:
            if not isinstance(payload["adapter"], str):
                raise _Reject(400, "bad_field", "adapter must be a str")
            kwargs["adapter"] = payload["adapter"]
        if payload.get("deadline") is not None:
            kwargs["deadline"] = payload["deadline"]
        if "kind" in payload:
            kind = payload["kind"]
            if kind not in ("generate", "score", "embed"):
                raise _Reject(400, "bad_field",
                              "kind must be 'generate', 'score' or "
                              f"'embed', got {kind!r}")
            kwargs["kind"] = kind
        sampling = payload.get("sampling")
        if sampling is not None:
            if not isinstance(sampling, dict):
                raise _Reject(400, "bad_field",
                              "sampling must be a JSON object")
            allowed = {"temperature", "top_k", "top_p", "greedy",
                       "seed", "response_format"}
            unknown = set(sampling) - allowed
            if unknown:
                raise _Reject(400, "bad_field",
                              f"unknown sampling keys: "
                              f"{sorted(unknown)}")
            try:
                kwargs["sampling"] = SamplingParams(**sampling)
            except (TypeError, ValueError) as e:
                raise _Reject(400, "bad_field",
                              f"bad sampling params: {e}")
        return prompt, kwargs

    def _door_submit(self, prompt, entry: _Entry, kwargs):
        try:
            handle = self.door.submit(prompt,
                                      on_token=entry.notify_token,
                                      **kwargs)
        except AdmissionRejected as e:
            code = 503 if e.reason == "draining" else 429
            raise _Reject(code, e.reason, str(e))
        except RuntimeError as e:
            if "pump died" in str(e):
                raise _Reject(503, "pump_dead", str(e))
            raise
        except (TypeError, ValueError) as e:
            # the engine's own submit() validation (prompt too long,
            # bad deadline, illegal grammar, ...) — client input,
            # client error
            raise _Reject(400, "bad_field", str(e))
        entry.req = handle.request
        self._register(entry)
        return handle

    def _submit(self, h):
        payload = self._read_json(h)
        prompt, kwargs = self._parse_submit(payload)
        entry = _Entry()
        handle = self._door_submit(prompt, entry, kwargs)
        body = json.dumps({"id": handle.request.id}).encode()
        return body, "application/json", 200

    def _batch(self, h, kind: str):
        """Synchronous score/embed: submit with the given
        kind and wait out the retire — these requests finish at
        prefill completion, so one round trip is the natural shape.
        Past the wait bound the id comes back as 202 instead of
        hanging the socket; the client polls ``/v1/requests/{id}``."""
        payload = self._read_json(h)
        if "kind" in payload or "sampling" in payload:
            raise _Reject(400, "bad_field",
                          f"/v1/{kind} sets kind itself and takes no "
                          "sampling params")
        prompt, kwargs = self._parse_submit(payload)
        kwargs["kind"] = kind
        entry = _Entry()
        handle = self._door_submit(prompt, entry, kwargs)
        req = handle.request
        if not handle.wait(self.boundary_timeout):
            body = json.dumps({"id": req.id, "pending": True}).encode()
            return body, "application/json", 202
        if req.finish_reason != "complete":
            raise _Reject(409, "not_complete",
                          f"request {req.id} retired with reason "
                          f"{req.finish_reason!r}")
        out: Dict[str, Any] = {"id": req.id,
                               "prompt_len": len(req.prompt)}
        if kind == "score":
            out["logprobs"] = [float(x) for x in req.logprobs]
        else:
            out["embedding"] = [float(x) for x in req.embedding]
        body = json.dumps(out).encode()
        return body, "application/json", 200

    def _cancel(self, rid: int):
        entry = self._entry(rid)
        done = entry.req.status == "done"
        if not done:
            self.door.cancel_request(entry.req)
        body = json.dumps({"cancelled": not done}).encode()
        return body, "application/json", 200

    def _status(self, rid: int):
        entry = self._entry(rid)
        req = entry.req
        out = {
            "id": req.id, "status": req.status,
            "finish_reason": req.finish_reason,
            "tokens": [int(t) for t in req.tokens],
            "prompt_len": len(req.prompt),
            "max_new_tokens": int(req.max_new_tokens),
            "kind": getattr(req, "kind", "generate"),
        }
        if req.status == "done":
            if getattr(req, "logprobs", None) is not None:
                out["logprobs"] = [float(x) for x in req.logprobs]
            if getattr(req, "embedding", None) is not None:
                out["embedding"] = [float(x) for x in req.embedding]
        body = json.dumps(out).encode()
        return body, "application/json", 200

    def _drain(self):
        census = self.door.drain()
        return (json.dumps(census).encode(), "application/json", 200)

    def _migrate_out(self, rid: int):
        entry = self._entry(rid)
        if entry.req.status == "done":
            raise _Reject(409, "not_live",
                          f"request {rid} already finished "
                          f"({entry.req.finish_reason}); nothing to "
                          "migrate")
        eng = self.engine
        try:
            frame = eng.at_tick_boundary(
                lambda: eng.migrate_out_request(rid),
                timeout=self.boundary_timeout)
        except TimeoutError as e:
            raise _Reject(503, "boundary_timeout", str(e))
        except (ValueError, RuntimeError) as e:
            # lost the race (retired between the check and the
            # boundary) or still prefilling — the router's cue to
            # retry later or re-place from record
            raise _Reject(409, "not_live", str(e))
        self._c_mig_out().inc()
        return frame, "application/octet-stream", 200

    def _migrate_in(self, h, qs):
        if self.door.draining:
            if qs.get("handoff"):
                # a prefill->decode handoff frame is NEW work arriving
                # on the migrate_in path — distinct counted reason so
                # drain dashboards can tell evacuations (which a
                # draining engine must keep refusing identically)
                # from handoffs the router should aim elsewhere
                raise _Reject(503, "draining_handoff",
                              "front door is draining; route this "
                              "prefill->decode handoff to another "
                              "decode engine")
            raise _Reject(503, "draining",
                          "front door is draining; restore this "
                          "frame on another engine")
        if self.door.pump_error is not None:
            raise _Reject(503, "pump_dead", "front-door pump died")
        frame = self._read_body(h, self.max_frame_bytes)
        entry = _Entry()
        eng = self.engine
        try:
            req = eng.at_tick_boundary(
                lambda: eng.restore_request(
                    frame, on_token=entry.notify_token,
                    on_finish=entry.notify_finish),
                timeout=self.boundary_timeout)
        except TimeoutError as e:
            raise _Reject(503, "boundary_timeout", str(e))
        except ValueError as e:
            raise _Reject(400, "bad_frame", str(e))
        entry.req = req
        self._register(entry)
        outcome = getattr(req, "_restore_outcome", "reprefill")
        self._c_mig_in().labels(outcome=outcome).inc()
        body = json.dumps({"id": req.id, "outcome": outcome,
                           "tokens_done": len(req.tokens)}).encode()
        return body, "application/json", 200

    # -- SSE --------------------------------------------------------------
    def _stream(self, h, rid: int, qs) -> None:
        """Stream committed tokens as SSE. Deliberately NOT the
        complete-bytes pattern: the whole point is tokens on the wire
        as they commit. The loop reads request state under the
        entry's condition (never the engine lock), writes ride the
        handler's socket timeout, and every abnormal exit is counted
        — one wedged consumer costs one daemon thread, bounded."""
        start = 0
        if "from" in qs:
            try:
                start = int(qs["from"][0])
            except ValueError:
                raise _Reject(400, "bad_field",
                              f"?from= must be an integer, got "
                              f"{qs['from'][0]!r}")
            if start < 0:
                raise _Reject(400, "bad_field", "?from= must be >= 0")
        entry = self._entry(rid)
        req = entry.req
        self._c_streams().inc()
        self._c_req().labels(endpoint="/v1/stream").inc()
        conn = h.connection
        with self._lock:
            self._conns.add(conn)
        clean = False
        try:
            h.send_response(200)
            h.send_header("Content-Type", SSE_CONTENT_TYPE)
            h.send_header("Cache-Control", "no-store")
            # SSE has no length; close delimits the stream (the
            # handler's HTTP/1.1 keep-alive must not wait for more
            # requests on this socket)
            h.send_header("Connection", "close")
            h.end_headers()
            sent = start
            last_write = time.monotonic()
            while True:
                with entry.cond:
                    if len(req.tokens) <= sent and \
                            req.status != "done":
                        entry.cond.wait(timeout=0.1)
                    toks = list(req.tokens[sent:])
                    done = req.status == "done"
                for t in toks:
                    self._sse(h, {"token": int(t), "index": sent})
                    sent += 1
                    last_write = time.monotonic()
                if done and len(req.tokens) <= sent:
                    self._sse(h, {"done": True,
                                  "finish_reason": req.finish_reason,
                                  "tokens": sent})
                    clean = True
                    return
                if not toks and \
                        time.monotonic() - last_write > 15.0:
                    # keepalive comment: a vanished client surfaces
                    # as a write error here instead of pinning the
                    # thread for the request's whole lifetime
                    h.wfile.write(b": keepalive\n\n")
                    h.wfile.flush()
                    last_write = time.monotonic()
        except (BrokenPipeError, ConnectionError, OSError):
            pass
        finally:
            with self._lock:
                self._conns.discard(conn)
            if not clean:
                self._c_aborts().inc()
            try:
                h.close_connection = True
            except Exception:
                pass

    @staticmethod
    def _sse(h, obj) -> None:
        h.wfile.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
        h.wfile.flush()
