"""Health-driven request router across N engine processes.

The port's copy of ``paddle_tpu/inference/fleet/router.py``.

Llumnix-style request-level rescheduling (arXiv:2406.03243) over the
HTTP planes each engine already wears:

- **Placement** scores live ``/metrics`` scrapes — free decode slots
  first (a queued request burns TTFT), then free KV blocks (headroom
  before the allocator starts spilling), then queue depth as the
  tiebreak. No static assignment: a drained or dying engine falls out
  of the candidate set on the next scrape.
- **Circuit breakers**, one per engine, fed by transport failures and
  ``/readyz``. ``threshold`` consecutive failures open the breaker;
  after ``cooldown`` seconds one half-open probe decides re-close vs
  re-open. An open breaker removes the engine from placement without
  removing it from the fleet — engines come back.
- **Live migration**: ``migrate_out`` (tick-boundary snapshot on the
  source) → ship the byte frame → ``migrate_in`` on the destination.
  The frame's payload hash is checked engine-side: a corrupt transfer
  degrades to metadata-only re-prefill THERE (counted ``outcome=
  corrupt_fallback``), still token-exact. A transfer the destination
  cannot parse at all falls back to resubmit-from-record here
  (``outcome=resubmit``). Never a crash.
- **Failover**: a stream that dies without its terminator triggers
  snapshot-failover if the source still answers, else
  resubmit-from-record (prompt + tokens-so-far, shortened budget) on a
  surviving engine. Greedy requests stay token-exact either way;
  temperature requests stay token-exact only on the snapshot path
  (keydata rides the frame — a resubmit re-seeds, and is counted so
  the bench can tell the difference).
- **Graceful shutdown** drains every engine, waits out in-flight
  streams, then scrapes ``/debug/requests`` audits into a leak report.

Every degradation increments a counter on the router's own metrics
registry (``fleet_*``); telemetry observes, it never steers. The only
testing-only seam is :func:`~paddle_tpu_torch.testing.fault_injection`
hooks at ``fleet:scrape`` / ``fleet:submit`` / ``fleet:transfer`` —
no-ops unless a test arms them.
"""

from __future__ import annotations

import random
import threading
from collections import OrderedDict
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Set

from paddle_tpu_torch.observability.metrics import MetricsRegistry
from paddle_tpu_torch.testing.fault_injection import fault_point, transform

from .client import EngineClient, SubmitRejected, TransportError

__all__ = ["EngineRef", "FleetHandle", "FleetRouter",
           "NoEngineAvailable"]


class NoEngineAvailable(RuntimeError):
    """Every engine was unreachable, draining, or breaker-open after
    the bounded retry budget — the router's honest 'fleet full'."""


@dataclass(frozen=True)
class EngineRef:
    """Where one engine lives: its two HTTP base URLs, plus its role
    in a disaggregated fleet. ``mixed`` (the default)
    serves everything; ``prefill`` engines take only the long-prompt
    prefill leg of a handoff (normal placement avoids them);
    ``decode`` engines are normal targets AND the preferred handoff
    destination."""
    name: str
    ingest_url: str
    ops_url: str
    role: str = "mixed"


class _EngineState:
    """Router-side view of one engine: client + breaker + last load."""

    def __init__(self, ref: EngineRef, timeout: float,
                 api_key: Optional[str] = None):
        self.ref = ref
        self.role = ref.role
        self.client = EngineClient(ref.ingest_url, ref.ops_url,
                                   timeout=timeout, api_key=api_key)
        self.breaker = "closed"        # closed | open | half_open
        self.failures = 0
        self.opened_at = 0.0
        self.draining = False
        self.load: Dict[str, float] = {}


class FleetHandle:
    """Router-side lifetime of one request, stable across engines.

    ``tokens`` only ever grows; ``engine``/``rid`` change on each
    migration or failover (``placements`` records the trail). A handle
    always terminates: ``finish_reason`` is the engine's own reason
    (``eos``/``length``/``cancelled``) when the stream completed, or
    the router's honest failure (``failover_failed``,
    ``migrate_lost``) when the fleet could not keep it alive.
    """

    def __init__(self, fid: int, payload: Dict[str, Any]):
        self.fid = fid
        self.payload = payload          # resubmit-from-record source
        self.tokens: List[int] = []
        self.status = "running"         # running | done | failed
        self.finish_reason: Optional[str] = None
        self.engine: Optional[str] = None
        self.rid: Optional[int] = None
        # batch-surface payloads: filled from the engine's
        # status read when a score/embed request terminates "complete"
        self.logprobs: Optional[List[float]] = None
        self.embedding: Optional[List[float]] = None
        self.gen = 0                    # bumps on every (re)placement
        self.base = 0                   # tokens baked into the prompt
        #   on the CURRENT placement: 0 after migration (the snapshot
        #   carries token history, so engine indices stay continuous),
        #   len(tokens) after a resubmit (the rebuilt request counts
        #   its indices from zero)
        self.migrations = 0
        self.resubmits = 0
        self.placements: List[str] = []
        self.cond = threading.Condition()
        # serializes every post-submit re-placement (migrate vs the
        # puller's failover) so one handle never holds two live
        # engine-side requests
        self.replace_lock = threading.Lock()

    def wait(self, timeout: Optional[float] = None) -> bool:
        with self.cond:
            self.cond.wait_for(lambda: self.status != "running",
                               timeout=timeout)
            return self.status != "running"

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self.wait(timeout):
            raise TimeoutError(
                f"fleet request {self.fid} still running")
        return list(self.tokens)

    def __iter__(self) -> Iterator[int]:
        i = 0
        while True:
            with self.cond:
                self.cond.wait_for(
                    lambda: len(self.tokens) > i
                    or self.status != "running")
                if len(self.tokens) > i:
                    tok = self.tokens[i]
                else:
                    return
            i += 1
            yield tok


class FleetRouter:
    """Places, watches, migrates, and drains requests across a fleet.

    One daemon puller thread per live request consumes its SSE stream
    and drives failover; all cross-engine policy (retry, breakers,
    migration) lives here so the transport and the engines stay dumb.
    """

    def __init__(self, engines: Sequence[EngineRef],
                 registry: Optional[MetricsRegistry] = None,
                 seed: int = 0,
                 timeout: float = 10.0,
                 stream_timeout: float = 60.0,
                 breaker_threshold: int = 3,
                 breaker_cooldown: float = 5.0,
                 max_submit_attempts: int = 4,
                 backoff_base: float = 0.05,
                 backoff_cap: float = 1.0,
                 handoff_min_tokens: Optional[int] = None,
                 handoff_max_imbalance: int = 1,
                 adapter_max_imbalance: int = 1,
                 api_key: Optional[str] = None):
        if not engines:
            raise ValueError("FleetRouter needs at least one engine")
        for e in engines:
            if e.role not in ("prefill", "decode", "mixed"):
                raise ValueError(
                    f"engine {e.name!r} has role {e.role!r}; a fleet "
                    "role is 'prefill', 'decode' or 'mixed'")
        self._states = {e.name: _EngineState(e, timeout,
                                             api_key=api_key)
                        for e in engines}
        if len(self._states) != len(engines):
            raise ValueError("engine names must be unique")
        # disaggregated prefill->decode handoff (DistServe,
        # PAPERS.md arXiv:2401.09670 — phase-pure engines stop prefill
        # bursts from stalling decode tenants): prompts of at least
        # this many tokens prefill on a role='prefill' engine and
        # hand their KV to a decode engine after the first token.
        # None disables classification (roles still shape placement).
        # Below the threshold, shipping blocks costs more than
        # re-prefilling the short prompt would.
        self._handoff_min = int(handoff_min_tokens) \
            if handoff_min_tokens is not None else None
        if self._handoff_min is not None and self._handoff_min < 1:
            raise ValueError(
                f"handoff_min_tokens must be >= 1, got "
                f"{handoff_min_tokens}")
        if self._handoff_min is not None and not any(
                e.role == "prefill" for e in engines):
            raise ValueError(
                "handoff_min_tokens without any role='prefill' engine "
                "would silently never hand off; tag at least one "
                "engine or leave the threshold unset")
        # KV-locality handoff routing: how many free slots
        # of load headroom the handoff target pick will give up to
        # land on the decode engine whose trie already holds the
        # prompt's prefix — serving's affinity_max_imbalance bound,
        # lifted to the fleet. The router's own bounded prompt-prefix
        # index remembers where each prefix last landed; the engine's
        # published serving_prefix_trie_bytes gauge confirms its trie
        # actually retains data before any load is traded for it.
        self._handoff_max_imbalance = int(handoff_max_imbalance)
        self._prefix_index: "OrderedDict[tuple, str]" = OrderedDict()
        self._prefix_index_cap = 1024
        # adapter-aware placement: the prefix-index
        # pattern, keyed by adapter name — route a tenant's traffic to
        # the engine whose AdapterPool already holds its adapter
        # instead of paying a fresh pool load (and possibly an
        # eviction) on a cold peer. Bounded FIFO; stale entries are
        # harmless because the engine's published
        # serving_adapter_slots_in_use gauge and the imbalance bound
        # gate every use.
        self._adapter_max_imbalance = int(adapter_max_imbalance)
        self._adapter_index: "OrderedDict[str, str]" = OrderedDict()
        self._adapter_index_cap = 1024
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._rng = random.Random(seed)   # deterministic jitter
        self._stream_timeout = float(stream_timeout)
        self._breaker_threshold = int(breaker_threshold)
        self._breaker_cooldown = float(breaker_cooldown)
        self._max_attempts = int(max_submit_attempts)
        self._backoff_base = float(backoff_base)
        self._backoff_cap = float(backoff_cap)
        self._lock = threading.Lock()
        self._handles: Dict[int, FleetHandle] = {}
        self._next_fid = 0
        self._closed = False
        self._pullers: List[threading.Thread] = []

        r = self.registry
        self._c_requests = r.counter(
            "fleet_requests_total", "requests accepted by the router")
        self._c_migrations = r.counter(
            "fleet_migrations_total",
            "migrations by restore outcome (swap_in / reprefill / "
            "corrupt_fallback / resubmit)", labelnames=("outcome",))
        self._c_failovers = r.counter(
            "fleet_failovers_total",
            "mid-stream failovers by mode (snapshot / reprefill)",
            labelnames=("mode",))
        self._c_retries = r.counter(
            "fleet_submit_retries_total",
            "placement attempts beyond the first")
        self._c_scrape_fail = r.counter(
            "fleet_scrape_failures_total",
            "load scrapes that raised (breaker food)")
        self._c_trips = r.counter(
            "fleet_breaker_trips_total",
            "closed->open breaker transitions")
        self._c_terminated = r.counter(
            "fleet_streams_terminated_total",
            "handle terminations by reason",
            labelnames=("reason",))
        self._c_handoffs = r.counter(
            "fleet_kv_handoffs_total",
            "prefill->decode KV handoffs by outcome (shipped / "
            "reprefill / not_live / failed)", labelnames=("outcome",))
        self._c_handoff_shipped = r.counter(
            "fleet_handoff_tokens_shipped_total",
            "prompt tokens whose KV shipped prefill->decode instead "
            "of re-prefilling on the decode side")
        self._c_handoff_reprefill = r.counter(
            "fleet_handoff_reprefilled_tokens_total",
            "prompt tokens the decode side re-prefilled after a "
            "degraded handoff (0 on the clean path)")
        self._c_adapter_locality = r.counter(
            "fleet_adapter_locality_total",
            "adapter-carrying placement decisions (locality = "
            "detoured within the imbalance bound to the engine whose "
            "pool holds the adapter; load = least-loaded pick, no "
            "usable holder)", labelnames=("decision",))
        self._c_handoff_locality = r.counter(
            "fleet_handoff_locality_total",
            "handoff target decisions (locality = detoured within the "
            "imbalance bound to the decode engine whose trie holds "
            "the prompt's prefix; load = least-loaded pick, no usable "
            "prefix holder)", labelnames=("decision",))
        # eager registration: gated families exist at value 0 even on
        # a run where nothing degrades
        for outcome in ("swap_in", "reprefill", "corrupt_fallback",
                        "resubmit"):
            self._c_migrations.labels(outcome)
        for mode in ("snapshot", "reprefill"):
            self._c_failovers.labels(mode)
        for outcome in ("shipped", "reprefill", "not_live", "failed"):
            self._c_handoffs.labels(outcome)
        for decision in ("locality", "load"):
            self._c_handoff_locality.labels(decision)
            self._c_adapter_locality.labels(decision)

    # -- breakers & health ------------------------------------------------
    def _note_failure(self, st: _EngineState) -> None:
        with self._lock:
            st.failures += 1
            if (st.breaker == "closed"
                    and st.failures >= self._breaker_threshold):
                st.breaker = "open"
                st.opened_at = time.monotonic()
                self._c_trips.inc()
            elif st.breaker == "half_open":
                # probe failed: back to open, restart the cooldown
                st.breaker = "open"
                st.opened_at = time.monotonic()

    def _note_success(self, st: _EngineState) -> None:
        with self._lock:
            st.failures = 0
            st.breaker = "closed"

    def _usable(self, st: _EngineState) -> bool:
        with self._lock:
            if st.draining:
                return False
            if st.breaker == "open":
                if (time.monotonic() - st.opened_at
                        < self._breaker_cooldown):
                    return False
                st.breaker = "half_open"   # one probe allowed through
            return True

    def _probe_ready(self, st: _EngineState) -> bool:
        """Half-open probe: ``/readyz`` decides re-close vs re-open."""
        try:
            ready, _reasons = st.client.readyz()
        except (TransportError, SubmitRejected):
            self._note_failure(st)
            return False
        if ready:
            self._note_success(st)
            return True
        self._note_failure(st)
        return False

    def _scrape(self, st: _EngineState) -> Optional[Dict[str, float]]:
        try:
            fault_point("fleet:scrape", engine=st.ref.name)
            load = st.client.load()
        except (TransportError, SubmitRejected):
            self._c_scrape_fail.inc()
            self._note_failure(st)
            return None
        st.load = load
        return load

    def engine_health(self) -> Dict[str, Dict[str, Any]]:
        """Introspection for tests and the shutdown report."""
        with self._lock:
            return {n: {"breaker": st.breaker,
                        "failures": st.failures,
                        "draining": st.draining,
                        "load": dict(st.load)}
                    for n, st in self._states.items()}

    # -- placement --------------------------------------------------------
    def _candidates(self, exclude: Set[str],
                    want: Optional[str] = None,
                    kind: str = "generate") -> List[_EngineState]:
        """Usable engines, best placement first. Scraping is part of
        candidacy: an engine whose metrics won't answer is not a
        candidate (and its breaker hears about it).

        ``want`` narrows by role: ``"prefill"`` keeps only prefill
        engines (the handoff's prefill leg), ``"decode"`` drops them
        (a handoff destination must be able to decode to completion).
        With ``want=None`` prefill engines stay eligible — a fleet of
        only-prefill engines must still serve — but sort strictly
        after every mixed/decode engine, so ordinary traffic lands on
        them only when nothing else is usable.

        ``kind`` inverts that penalty for the batch surfaces
       : a score/embed request IS pure prefill work — it
        retires at prefill completion, never holding a decode loop —
        so on a disaggregated fleet it soaks the phase-pure prefill
        engines first, keeping mixed/decode capacity for interactive
        traffic. Everything else about candidacy is unchanged."""
        scored = []
        for name, st in self._states.items():
            if name in exclude or not self._usable(st):
                continue
            if want == "prefill" and st.role != "prefill":
                continue
            if want == "decode" and st.role == "prefill":
                continue
            if st.breaker == "half_open" and not self._probe_ready(st):
                continue
            load = self._scrape(st)
            if load is None:
                continue
            if kind in ("score", "embed"):
                penalty = 0 if st.role == "prefill" else 1
            else:
                penalty = 1 if (want is None
                                and st.role == "prefill") else 0
            scored.append(((penalty, -load["free_slots"],
                            -load["free_blocks"], load["queued"]), st))
        scored.sort(key=lambda pair: pair[0])
        return [st for _score, st in scored]

    def _backoff(self, attempt: int) -> None:
        delay = min(self._backoff_cap,
                    self._backoff_base * (2 ** attempt))
        with self._lock:
            jitter = 0.5 + self._rng.random()   # 0.5x .. 1.5x
        time.sleep(delay * jitter)

    # -- submit -----------------------------------------------------------
    def submit(self, prompt: Sequence[int],
               max_new_tokens: int = 16,
               sampling: Optional[Dict[str, Any]] = None,
               tenant: Optional[str] = None,
               eos_id: Optional[int] = None,
               adapter: Optional[str] = None,
               kind: str = "generate") -> FleetHandle:
        """Place a request on the best engine and start pulling its
        stream. Raises :class:`NoEngineAvailable` only after the
        bounded jittered-backoff budget is spent.

        ``kind="score"`` / ``"embed"`` route the batch
        surfaces: placement prefers phase-pure prefill engines (the
        work retires at prefill completion), the KV-handoff
        classification is skipped (there is no decode leg to hand
        to), and the finished payload lands on ``handle.logprobs`` /
        ``handle.embedding``."""
        if self._closed:
            raise NoEngineAvailable("router is shut down")
        if kind not in ("generate", "score", "embed"):
            raise ValueError(
                f"kind must be 'generate', 'score' or 'embed', got "
                f"{kind!r}")
        payload: Dict[str, Any] = {"prompt": list(prompt),
                                   "max_new_tokens": int(max_new_tokens)}
        if sampling:
            payload["sampling"] = dict(sampling)
        if tenant is not None:
            payload["tenant"] = tenant
        if eos_id is not None:
            payload["eos_id"] = eos_id
        if adapter is not None:
            payload["adapter"] = adapter
        if kind != "generate":
            payload["kind"] = kind
        with self._lock:
            fid = self._next_fid
            self._next_fid += 1
        h = FleetHandle(fid, payload)
        # disaggregation: a long prompt prefills on a prefill-role
        # engine, then hands its KV to a decode engine after the first
        # token. Falls back to ordinary placement if no prefill engine
        # will take it right now — classification is a preference, not
        # a correctness property. Batch kinds never hand off: their
        # whole life IS the prefill.
        handoff = (kind == "generate"
                   and self._handoff_min is not None
                   and len(payload["prompt"]) >= self._handoff_min)
        name = rid = None
        if handoff:
            try:
                name, rid = self._place(payload, exclude=set(),
                                        want="prefill")
            except NoEngineAvailable:
                handoff = False
        if name is None:
            name, rid = self._place(payload, exclude=set())
        # a prefill-role engine holds a handoff prompt's KV only until
        # the ship-off retires the slot — noting it as the prefix
        # holder would overwrite the decode destination the NEXT
        # same-prefix prompt should detour to
        if self._states[name].role != "prefill":
            self._note_prefix(payload["prompt"], name)
        with h.cond:
            h.engine, h.rid, h.gen = name, rid, h.gen + 1
            h.placements.append(name)
        with self._lock:
            self._handles[fid] = h
        self._c_requests.inc()
        t = threading.Thread(target=self._pull, args=(h,),
                             name=f"fleet-pull-{fid}", daemon=True)
        self._pullers.append(t)
        t.start()
        if handoff:
            w = threading.Thread(target=self._watch_handoff, args=(h,),
                                 name=f"fleet-handoff-{fid}",
                                 daemon=True)
            self._pullers.append(w)
            w.start()
        return h

    def _place(self, payload: Dict[str, Any],
               exclude: Set[str],
               want: Optional[str] = None) -> "tuple":
        """The bounded retry loop shared by submit and failover."""
        last: Optional[BaseException] = None
        tried: Set[str] = set(exclude)
        kind = payload.get("kind", "generate")
        for attempt in range(self._max_attempts):
            if attempt:
                self._c_retries.inc()
                self._backoff(attempt - 1)
            fault_point("fleet:submit", attempt=attempt)
            cands = self._candidates(tried, want=want, kind=kind)
            if payload.get("adapter") is not None and cands:
                cands = self._prefer_adapter(payload["adapter"], cands)
            for st in cands:
                try:
                    rid = st.client.submit(payload)
                    self._note_success(st)
                    if payload.get("adapter") is not None:
                        self._note_adapter(payload["adapter"],
                                           st.ref.name)
                    return st.ref.name, rid
                except SubmitRejected as e:
                    last = e
                    if e.reason == "draining":
                        with self._lock:
                            st.draining = True
                    elif e.reason.startswith("backpressure"):
                        tried.add(st.ref.name)   # full this round
                    else:
                        raise    # bad_field etc: OUR payload is wrong
                except TransportError as e:
                    last = e
                    self._note_failure(st)
                    tried.add(st.ref.name)
            # next attempt rechecks engines that were merely busy
            tried = set(exclude)
        raise NoEngineAvailable(
            f"no engine accepted after {self._max_attempts} attempts: "
            f"{last}")

    # -- the per-request puller -------------------------------------------
    def _pull(self, h: FleetHandle) -> None:
        while True:
            with h.cond:
                if h.status != "running":
                    return
                name, rid, seen_gen = h.engine, h.rid, h.gen
                base = h.base
                start = len(h.tokens) - base
            st = self._states[name]
            try:
                for ev in st.client.stream(
                        rid, from_=start,
                        timeout=self._stream_timeout):
                    if ev.get("done"):
                        if ev.get("finish_reason") == "migrated":
                            if not self._await_replacement(h, seen_gen):
                                return
                            break    # reconnect at the new placement
                        if ev.get("finish_reason") == "complete":
                            # batch surface: the result is not in the
                            # token stream — read it off the engine's
                            # status endpoint (best-effort: a vanished
                            # engine loses the payload, the handle
                            # still terminates honestly)
                            try:
                                status = st.client.status(rid)
                                if status.get("logprobs") is not None:
                                    h.logprobs = [
                                        float(x) for x in
                                        status["logprobs"]]
                                if status.get("embedding") is not None:
                                    h.embedding = [
                                        float(x) for x in
                                        status["embedding"]]
                            except (TransportError, SubmitRejected):
                                pass
                        self._finish(h, ev.get("finish_reason",
                                               "unknown"))
                        return
                    with h.cond:
                        if ev["index"] + base == len(h.tokens):
                            h.tokens.append(int(ev["token"]))
                            h.cond.notify_all()
                        # index+base < len: replay after reconnect, drop
                else:
                    continue   # unreachable: stream() raises or done
            except (TransportError, SubmitRejected):
                self._note_failure(st)
                if not self._failover(h, seen_gen):
                    return

    def _await_replacement(self, h: FleetHandle, seen_gen: int,
                           timeout: float = 30.0) -> bool:
        """The source said 'migrated'; wait for the router thread to
        install the new placement (or for the handle to die)."""
        with h.cond:
            ok = h.cond.wait_for(
                lambda: h.gen != seen_gen or h.status != "running",
                timeout=timeout)
        if ok:
            return h.status == "running"
        self._fail(h, "migrate_lost")
        return False

    def _finish(self, h: FleetHandle, reason: str) -> None:
        with h.cond:
            if h.status != "running":
                return
            h.status = "done"
            h.finish_reason = reason
            h.cond.notify_all()
        self._c_terminated.labels("served" if reason in ("eos", "length")
                                  else reason).inc()

    def _fail(self, h: FleetHandle, reason: str) -> None:
        with h.cond:
            if h.status != "running":
                return
            h.status = "failed"
            h.finish_reason = reason
            h.cond.notify_all()
        self._c_terminated.labels(reason).inc()

    # -- migration --------------------------------------------------------
    def migrate(self, h: FleetHandle,
                dest: Optional[str] = None) -> str:
        """Live-migrate one running request off its current engine.

        Returns the destination engine's restore outcome (``swap_in``,
        ``reprefill``, ``corrupt_fallback``) or ``resubmit`` when the
        frame could not be delivered and the request was rebuilt from
        the router's own record. Raises only if the handle is not
        running."""
        with h.replace_lock:
            with h.cond:
                if h.status != "running":
                    raise ValueError(
                        f"fleet request {h.fid} is {h.status}")
                src, rid = h.engine, h.rid
            st = self._states[src]
            try:
                frame = st.client.migrate_out(
                    rid, timeout=self._stream_timeout)
            except (TransportError, SubmitRejected):
                # source won't give up the snapshot (dead, or the
                # request finished under us) — fall back to rebuilding
                # from the router's own record
                self._note_failure(st)
                self._c_migrations.labels("resubmit").inc()
                if self._resubmit(h, {src}):
                    return "resubmit"
                return "failed"
            frame = transform("fleet:transfer", frame, fid=h.fid,
                              src=src)
            return self._place_frame(h, frame, exclude={src},
                                     dest=dest)

    # -- disaggregated prefill->decode handoff ----------------------------
    def _watch_handoff(self, h: FleetHandle) -> None:
        """Daemon: wait for the prefill engine to emit the FIRST token
        (the engine refuses to snapshot a still-prefilling slot — the
        first token is the proof that every prompt block is committed),
        then ship the KV to a decode engine."""
        with h.cond:
            h.cond.wait_for(lambda: len(h.tokens) > 0
                            or h.status != "running")
            if h.status != "running":
                self._c_handoffs.labels("not_live").inc()
                return
        self._handoff(h)

    def _handoff(self, h: FleetHandle) -> None:
        """Move ``h`` off its prefill engine onto a decode engine,
        shipping the prompt KV inside the snapshot frame. Every exit is
        counted; every failure degrades to re-prefill or resubmit —
        the request survives, only the saved prefill work is lost."""
        plen = len(h.payload["prompt"])
        with h.replace_lock:
            with h.cond:
                if h.status != "running":
                    self._c_handoffs.labels("not_live").inc()
                    return
                src, rid = h.engine, h.rid
            st = self._states[src]
            try:
                # chaos seam: kill-prefill-engine-mid-handoff arms here,
                # BEFORE migrate_out, so the snapshot request itself
                # hits the dead engine deterministically
                fault_point("fleet:handoff", fid=h.fid, src=src)
                frame = st.client.migrate_out(
                    rid, timeout=self._stream_timeout)
            except (TransportError, SubmitRejected):
                # prefill engine won't give up the snapshot — rebuild
                # from the router's record; the decode side re-prefills
                # the whole prompt (counted, not hidden)
                self._note_failure(st)
                self._c_handoffs.labels("reprefill").inc()
                self._c_handoff_reprefill.inc(plen)
                self._resubmit(h, {src})
                return
            covered = self._frame_tokens_covered(frame)
            frame = transform("fleet:transfer", frame, fid=h.fid,
                              src=src)
            outcome = self._place_frame(h, frame, exclude={src},
                                        want="decode", handoff=True)
        if outcome == "swap_in":
            # clean path: full blocks shipped; only the prompt tail
            # short of a block boundary (plen % block_size) re-prefills
            self._c_handoffs.labels("shipped").inc()
            self._c_handoff_shipped.inc(min(covered, plen))
            self._c_handoff_reprefill.inc(max(0, plen - covered))
        elif outcome in ("reprefill", "corrupt_fallback", "resubmit"):
            self._c_handoffs.labels("reprefill").inc()
            self._c_handoff_reprefill.inc(plen)
        else:
            self._c_handoffs.labels("failed").inc()

    @staticmethod
    def _frame_tokens_covered(frame: bytes) -> int:
        """How many prompt tokens the frame's KV payload covers, read
        from the snapshot header (``extra.tokens_covered``). Layout is
        serving's ``_SNAP_MAGIC`` wire format: 8-byte magic, 8-byte LE
        header length, JSON header. 0 on any parse trouble — the
        conservative answer, since the counters treat uncovered tokens
        as re-prefilled."""
        import json
        try:
            if frame[:8] != b"PTRQSNP1":
                return 0
            hlen = int.from_bytes(frame[8:16], "little")
            header = json.loads(frame[16:16 + hlen].decode("utf-8"))
            return int(header.get("extra", {}).get("tokens_covered", 0))
        except Exception:
            return 0

    # -- KV-locality handoff routing ---------------------------
    #: prompt tokens hashed into a prefix-index key — prompts sharing
    #: this head overwhelmingly share trie chunks (the prefix cache
    #: matches chunk-aligned heads), and a shorter key would alias
    #: unrelated tenants
    _PREFIX_KEY_TOKENS = 16

    def _prefix_key(self, prompt: Sequence[int]) -> tuple:
        return tuple(prompt[:self._PREFIX_KEY_TOKENS])

    def _note_prefix(self, prompt: Sequence[int], name: str) -> None:
        """Remember that ``name``'s trie now holds ``prompt``'s
        prefix (bounded FIFO index — stale entries are harmless: the
        gauge check and the imbalance bound gate every use)."""
        key = self._prefix_key(prompt)
        with self._lock:
            self._prefix_index.pop(key, None)
            self._prefix_index[key] = name
            while len(self._prefix_index) > self._prefix_index_cap:
                self._prefix_index.popitem(last=False)

    def _prefer_locality(self, prompt: Sequence[int],
                         targets: List[_EngineState]) \
            -> List[_EngineState]:
        """Reorder the load-sorted handoff candidates: move the
        engine whose trie already holds ``prompt``'s prefix to the
        front IF its published trie gauge shows retained data and its
        free-slot gap to the best candidate is within
        ``handoff_max_imbalance`` — serving's trie-affinity trade at
        fleet scope. Every decision is counted."""
        with self._lock:
            holder = self._prefix_index.get(self._prefix_key(prompt))
        if holder is not None and targets \
                and holder != targets[0].ref.name:
            for i, st in enumerate(targets):
                if st.ref.name != holder:
                    continue
                gap = targets[0].load.get("free_slots", 0.0) \
                    - st.load.get("free_slots", 0.0)
                if st.load.get("prefix_trie_bytes", 0.0) > 0 \
                        and gap <= self._handoff_max_imbalance:
                    self._c_handoff_locality.labels("locality").inc()
                    return [st] + targets[:i] + targets[i + 1:]
                break
        elif holder is not None and targets:
            # the prefix holder IS the least-loaded pick: locality and
            # load agree, counted as a locality win (the trie gauge
            # still gates — an emptied trie is a plain load pick)
            if targets[0].load.get("prefix_trie_bytes", 0.0) > 0:
                self._c_handoff_locality.labels("locality").inc()
                return targets
        self._c_handoff_locality.labels("load").inc()
        return targets

    # -- adapter-aware placement -------------------------------
    def _note_adapter(self, adapter: str, name: str) -> None:
        """Remember that ``name``'s pool now holds ``adapter`` (the
        engine registers it on first use). Bounded FIFO, same shape
        as the prefix index: staleness is harmless — the pool gauge
        and the imbalance bound gate every use, and an evicted
        adapter just costs one plain load-pick."""
        with self._lock:
            self._adapter_index.pop(adapter, None)
            self._adapter_index[adapter] = name
            while len(self._adapter_index) > self._adapter_index_cap:
                self._adapter_index.popitem(last=False)

    def _prefer_adapter(self, adapter: str,
                        targets: List[_EngineState]) \
            -> List[_EngineState]:
        """Reorder the load-sorted candidates: move the engine whose
        AdapterPool already holds ``adapter`` to the front IF its
        published ``serving_adapter_slots_in_use`` gauge shows a
        non-empty pool and its free-slot gap to the best candidate is
        within ``adapter_max_imbalance`` — the trie-affinity trade
       , keyed by adapter instead of prompt prefix. Every
        adapter-carrying decision is counted
        (``fleet_adapter_locality_total``)."""
        with self._lock:
            holder = self._adapter_index.get(adapter)
        if holder is not None and targets \
                and holder != targets[0].ref.name:
            for i, st in enumerate(targets):
                if st.ref.name != holder:
                    continue
                gap = targets[0].load.get("free_slots", 0.0) \
                    - st.load.get("free_slots", 0.0)
                if st.load.get("adapter_slots_in_use", 0.0) > 0 \
                        and gap <= self._adapter_max_imbalance:
                    self._c_adapter_locality.labels("locality").inc()
                    return [st] + targets[:i] + targets[i + 1:]
                break
        elif holder is not None and targets:
            # holder IS the least-loaded pick: locality and load
            # agree (gauge still gates — a drained pool is a plain
            # load pick)
            if targets[0].load.get("adapter_slots_in_use", 0.0) > 0:
                self._c_adapter_locality.labels("locality").inc()
                return targets
        self._c_adapter_locality.labels("load").inc()
        return targets

    def _place_frame(self, h: FleetHandle, frame: bytes,
                     exclude: Set[str],
                     dest: Optional[str] = None,
                     want: Optional[str] = None,
                     handoff: bool = False) -> str:
        """Ship a snapshot frame to a destination engine; degrade to
        resubmit-from-record if nobody can take it."""
        if dest is not None:
            targets = [self._states[dest]]
        else:
            targets = self._candidates(set(exclude), want=want)
            if handoff and targets:
                targets = self._prefer_locality(h.payload["prompt"],
                                                targets)
        for st in targets:
            try:
                resp = st.client.migrate_in(
                    frame, timeout=self._stream_timeout,
                    handoff=handoff)
            except SubmitRejected as e:
                # bad_frame: the frame is damaged beyond the engine's
                # own corrupt-payload fallback — no other engine will
                # parse it either, rebuild from our record
                if e.reason == "bad_frame":
                    break
                if e.reason == "draining_handoff":
                    # the decode engine is draining: it won't take NEW
                    # work, and a handoff frame is new work even though
                    # it arrives on the migrate_in path
                    with self._lock:
                        st.draining = True
                    continue
                self._note_failure(st)
                continue
            except TransportError:
                self._note_failure(st)
                continue
            self._note_success(st)
            outcome = resp.get("outcome", "swap_in")
            with h.cond:
                h.engine = st.ref.name
                h.rid = int(resp["id"])
                h.gen += 1
                h.migrations += 1
                h.placements.append(st.ref.name)
                h.cond.notify_all()
            self._c_migrations.labels(outcome).inc()
            self._note_prefix(h.payload["prompt"], st.ref.name)
            return outcome
        self._c_migrations.labels("resubmit").inc()
        if self._resubmit(h, exclude):
            return "resubmit"
        return "failed"

    # -- failover ---------------------------------------------------------
    def _failover(self, h: FleetHandle, seen_gen: int) -> bool:
        """The stream to ``h``'s engine died without a terminator.
        Re-place the request; True means the puller should reconnect.
        Serialized against migrate() via ``replace_lock`` — whichever
        got there first wins, the loser just reconnects."""
        with h.replace_lock:
            with h.cond:
                if h.status != "running":
                    return False
                if h.gen != seen_gen:
                    return True   # a migration beat us to it: reconnect
                src, rid = h.engine, h.rid
            st = self._states[src]
            # snapshot path first: the engine may be healthy with only
            # our stream's socket severed
            try:
                frame = st.client.migrate_out(
                    rid, timeout=self._stream_timeout)
            except (TransportError, SubmitRejected):
                frame = None
            if frame is not None:
                frame = transform("fleet:transfer", frame, fid=h.fid,
                                  src=src)
                outcome = self._place_frame(h, frame, exclude={src})
                if outcome != "failed":
                    self._c_failovers.labels("snapshot").inc()
                    return True
                return False
            self._c_failovers.labels("reprefill").inc()
            return self._resubmit(h, {src})

    def _resubmit(self, h: FleetHandle, exclude: Set[str]) -> bool:
        """Rebuild the request from the router's own record: original
        prompt + tokens streamed so far, shortened budget. Token-exact
        for greedy; a seeded-sampling request re-seeds from here (the
        keydata lived in the lost snapshot) — counted, not hidden."""
        with h.cond:
            done = list(h.tokens)
        budget = int(h.payload["max_new_tokens"]) - len(done)
        if budget <= 0:
            # every token already arrived; only the terminator was lost
            self._finish(h, "length")
            return False
        payload = dict(h.payload)
        payload["prompt"] = list(h.payload["prompt"]) + done
        payload["max_new_tokens"] = budget
        try:
            name, rid = self._place(payload, exclude=exclude)
        except (NoEngineAvailable, SubmitRejected, TransportError):
            self._fail(h, "failover_failed")
            return False
        with h.cond:
            h.engine, h.rid = name, rid
            h.gen += 1
            h.base = len(done)   # the rebuilt request indexes from 0
            h.resubmits += 1
            h.placements.append(name)
            h.cond.notify_all()
        return True

    # -- cancel / shutdown ------------------------------------------------
    def cancel(self, h: FleetHandle) -> bool:
        with h.cond:
            if h.status != "running":
                return False
            name, rid = h.engine, h.rid
        try:
            return self._states[name].client.cancel(rid)
        except (TransportError, SubmitRejected):
            # the engine is gone; its puller will fail the handle
            return False

    def handles(self) -> List[FleetHandle]:
        with self._lock:
            return list(self._handles.values())

    def shutdown(self, drain: bool = True,
                 timeout: float = 60.0) -> Dict[str, Any]:
        """Stop placing, drain every engine, wait out in-flight
        streams, audit every engine for leaks. Returns the report the
        chaos bench gates on; never raises for a dead engine."""
        self._closed = True
        report: Dict[str, Any] = {"engines": {}, "leaked_blocks": 0,
                                  "orphaned_pins": 0,
                                  "unterminated_streams": 0,
                                  "unreachable_engines": []}
        if drain:
            for name, st in self._states.items():
                with self._lock:
                    st.draining = True
                try:
                    st.client.drain()
                except (TransportError, SubmitRejected):
                    report["unreachable_engines"].append(name)
        deadline = time.monotonic() + timeout
        for h in self.handles():
            h.wait(timeout=max(0.0, deadline - time.monotonic()))
        for t in list(self._pullers):
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        for h in self.handles():
            if h.status == "running":
                report["unterminated_streams"] += 1
                self._fail(h, "router_shutdown")
        for name, st in self._states.items():
            if name in report["unreachable_engines"]:
                continue
            try:
                dbg = st.client.debug_requests()
            except (TransportError, SubmitRejected):
                report["unreachable_engines"].append(name)
                continue
            audit = dbg.get("audit", {})
            report["engines"][name] = audit
            report["leaked_blocks"] += int(
                audit.get("leaked_blocks", 0))
            report["orphaned_pins"] += int(
                audit.get("orphaned_pins", 0))
        return report
