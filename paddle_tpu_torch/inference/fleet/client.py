"""Typed HTTP transport to ONE engine's ingest + ops planes.

The port's copy of ``paddle_tpu/inference/fleet/client.py``.

The router's view of an engine is exactly two base URLs: the ingest
plane (``/v1/*``, :mod:`paddle_tpu_torch.inference.frontend.ingest`) and
the ops plane (``/metrics``, ``/readyz``, ``/debug/requests`` —
:mod:`paddle_tpu_torch.observability.ops_plane`). This client wraps both
with stdlib ``urllib`` only, and collapses every way the wire can
fail into two typed exceptions:

- :class:`TransportError` — the ENGINE could not be reached or died
  mid-response (connection refused/reset, timeout, truncated stream).
  The router treats these as health signals: breaker food, failover
  triggers.
- :class:`SubmitRejected` — the engine answered, and said no
  (backpressure 429, draining/pump-dead 503, malformed 4xx). Carries
  the machine-readable ``reason`` the ingest plane counted.

Everything else returns parsed values. No retries here — retry,
backoff and jitter are ROUTER policy (they need fleet-wide context:
which peer to try next, whether a breaker is open), and keeping the
transport dumb keeps that policy in one place.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterator, List, Optional, Tuple
from urllib.error import HTTPError, URLError
from urllib.request import Request, urlopen

__all__ = ["EngineClient", "TransportError", "SubmitRejected"]


class TransportError(RuntimeError):
    """The engine was unreachable or vanished mid-response — a health
    signal, not a protocol answer."""


class SubmitRejected(RuntimeError):
    """The engine answered with a typed refusal (backpressure,
    draining, bad input...)."""

    def __init__(self, reason: str, message: str, code: int):
        super().__init__(message)
        self.reason = reason
        self.code = code


class EngineClient:
    """Transport to one engine process's two HTTP planes."""

    def __init__(self, ingest_url: str, ops_url: Optional[str] = None,
                 timeout: float = 10.0,
                 api_key: Optional[str] = None):
        self.ingest_url = ingest_url.rstrip("/")
        self.ops_url = (ops_url or ingest_url).rstrip("/")
        self.timeout = float(timeout)
        # keyed ingest plane: sent on every call; a 401
        # from a key mismatch surfaces as SubmitRejected
        # reason='unauthorized' — an OPERATOR error, so the router
        # must not treat it as breaker food
        self.api_key = api_key

    def _headers(self) -> Dict[str, str]:
        if self.api_key is None:
            return {}
        return {"Authorization": f"Bearer {self.api_key}"}

    # -- raw I/O ----------------------------------------------------------
    def _call(self, base: str, path: str, data: Optional[bytes] = None,
              timeout: Optional[float] = None) -> bytes:
        req = Request(base + path, data=data, headers=self._headers(),
                      method="POST" if data is not None else "GET")
        try:
            with urlopen(req, timeout=timeout or self.timeout) as resp:
                return resp.read()
        except HTTPError as e:
            body = b""
            try:
                body = e.read()
            except OSError:
                pass
            reason, msg = self._reject_fields(body, e.code)
            raise SubmitRejected(reason, msg, e.code)
        except (URLError, OSError, ConnectionError) as e:
            # URLError subclasses OSError; sockets reset mid-read land
            # here too — all of it is "engine unreachable"
            raise TransportError(f"{base}{path}: {e}")

    @staticmethod
    def _reject_fields(body: bytes, code: int) -> Tuple[str, str]:
        try:
            payload = json.loads(body)
            return (payload.get("reason", f"http_{code}"),
                    payload.get("error", body.decode(errors="replace")))
        except (json.JSONDecodeError, UnicodeDecodeError):
            return f"http_{code}", body.decode(errors="replace")

    # -- ingest plane -----------------------------------------------------
    def submit(self, payload: Dict[str, Any]) -> int:
        """POST /v1/submit -> the engine-side request id."""
        body = self._call(self.ingest_url, "/v1/submit",
                          json.dumps(payload).encode())
        return int(json.loads(body)["id"])

    def stream(self, rid: int, from_: int = 0,
               timeout: Optional[float] = None) -> Iterator[Dict]:
        """GET /v1/stream/{rid}?from=N — yield SSE events as dicts
        (``{"token": t, "index": i}`` ..., then the ``done``
        terminator). A connection that dies BEFORE the terminator
        raises :class:`TransportError` — the router's failover
        trigger; a stream must end honestly or not at all."""
        url = f"{self.ingest_url}/v1/stream/{rid}?from={from_}"
        try:
            resp = urlopen(Request(url, headers=self._headers()),
                           timeout=timeout or self.timeout)
        except HTTPError as e:
            body = b""
            try:
                body = e.read()
            except OSError:
                pass
            reason, msg = self._reject_fields(body, e.code)
            raise SubmitRejected(reason, msg, e.code)
        except (URLError, OSError, ConnectionError) as e:
            raise TransportError(f"{url}: {e}")
        terminated = False
        try:
            with resp:
                for line in resp:
                    line = line.strip()
                    if not line.startswith(b"data: "):
                        continue   # keepalive comments, blank lines
                    ev = json.loads(line[6:])
                    yield ev
                    if ev.get("done"):
                        terminated = True
                        return
        except (URLError, OSError, ConnectionError,
                json.JSONDecodeError) as e:
            raise TransportError(f"{url}: stream died mid-flight: {e}")
        if not terminated:
            raise TransportError(
                f"{url}: stream closed without its terminator")

    def cancel(self, rid: int) -> bool:
        body = self._call(self.ingest_url, f"/v1/cancel/{rid}", b"")
        return bool(json.loads(body).get("cancelled"))

    def status(self, rid: int) -> Dict[str, Any]:
        body = self._call(self.ingest_url, f"/v1/requests/{rid}")
        return json.loads(body)

    def migrate_out(self, rid: int,
                    timeout: Optional[float] = None) -> bytes:
        """POST /v1/migrate_out/{rid} -> the snapshot byte frame."""
        return self._call(self.ingest_url, f"/v1/migrate_out/{rid}",
                          b"", timeout=timeout)

    def migrate_in(self, frame: bytes,
                   timeout: Optional[float] = None,
                   handoff: bool = False) -> Dict[str, Any]:
        """POST /v1/migrate_in -> {"id", "outcome", "tokens_done"}.

        ``handoff=True`` marks the frame as the decode leg of a
        prefill->decode handoff; a draining engine refuses it with the
        distinct reason ``draining_handoff`` (it is NEW work, unlike a
        drain-driven evacuation migrate_in, which stays accepted)."""
        path = "/v1/migrate_in" + ("?handoff=1" if handoff else "")
        body = self._call(self.ingest_url, path, frame,
                          timeout=timeout)
        return json.loads(body)

    def drain(self) -> Dict[str, Any]:
        body = self._call(self.ingest_url, "/v1/drain", b"")
        return json.loads(body)

    # -- ops plane --------------------------------------------------------
    def readyz(self) -> Tuple[bool, List[str]]:
        """``(ready, reasons)`` — 503 is a VALID readiness answer
        (not-ready with reasons), only transport failures raise."""
        try:
            body = self._call(self.ops_url, "/readyz")
            return True, []
        except SubmitRejected as e:
            if e.code != 503:
                raise
            try:
                payload = json.loads(str(e))
            except json.JSONDecodeError:
                return False, [str(e)]
            return False, list(payload.get("reasons", []))

    def load(self) -> Dict[str, float]:
        """Scrape ``/metrics`` for the placement gauges: free slots,
        free blocks, total queued (summed over tiers), replica skew."""
        text = self._call(self.ops_url, "/metrics").decode()
        out = {"free_slots": 0.0, "free_blocks": 0.0,
               "queued": 0.0, "replica_skew": 1.0,
               "prefill_backlog": 0.0,
               "prefix_hit_tokens": 0.0, "prefix_trie_bytes": 0.0,
               "adapter_slots_in_use": 0.0}
        for line in text.splitlines():
            if line.startswith("#") or not line.strip():
                continue
            try:
                name_part, value = line.rsplit(None, 1)
                val = float(value)
            except ValueError:
                continue
            if name_part == "serving_free_slots":
                out["free_slots"] = val
            elif name_part == "serving_free_blocks":
                out["free_blocks"] = val
            elif name_part.startswith("serving_queue_depth_tier"):
                out["queued"] += val
            elif name_part == "serving_replica_skew":
                out["replica_skew"] = val
            elif name_part == "serving_prefill_backlog_tokens":
                out["prefill_backlog"] = val
            # per-replica prefix-cache gauges, summed over
            # the replica label — the KV-locality signal the handoff
            # router steers on: a decode engine whose trie
            # demonstrably retains prefix KV is worth a bounded load
            # detour
            elif name_part.startswith(
                    "serving_prefix_hit_tokens_recovered"):
                out["prefix_hit_tokens"] += val
            elif name_part.startswith("serving_prefix_trie_bytes"):
                out["prefix_trie_bytes"] += val
            # multi-LoRA pool occupancy: a non-zero value confirms the engine's pool
            # demonstrably retains adapters before the router trades
            # any load for adapter locality
            elif name_part == "serving_adapter_slots_in_use":
                out["adapter_slots_in_use"] = val
        return out

    def debug_requests(self) -> Dict[str, Any]:
        """``/debug/requests`` — the audit/reconciliation read the
        router's shutdown report verifies zero leaks with."""
        body = self._call(self.ops_url, "/debug/requests")
        return json.loads(body)
