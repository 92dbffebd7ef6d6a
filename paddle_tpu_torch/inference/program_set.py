"""The serving engines' program registry — the port of
``paddle_tpu/inference/program_set.py``, one device.

Every serving engine is a handful of programs (chunk prefill, decode
step, speculative verify, the dense prefix-cache copy/extract pair)
plus host scheduling around them, and the stack's core invariant is
that this set stays FLAT: offsets, block tables and sampling vectors
are runtime arguments, never shapes, so no arrival pattern or
allocation mix may mint a new program. The reference's programs are
jitted JAX functions; the port's are the engine's eager methods, whose
kernels (K2, K4, K5) are built once per source. What the reference's
jit cache counts, the port counts as ARGUMENT SIGNATURES: the shapes
and dtypes of each dispatch's tensors and arrays, which is what a
kernel's launch grid and a CUDA graph of the decode step are keyed on
(``observability/sentinel.py``).

:class:`ProgramSet` keeps the registry explicit and single-sourced:

- **register(name, builder)** declares a program; the builder runs
  lazily on first dispatch (a program never dispatched is never built
  and never counted: a speculative engine whose plain decode step
  never runs reports chunk + verify = 2).
- **call(name, *args)** dispatches, passes the ``serving:dispatch``
  fault point, records the argument signature and reports the
  program's signature count to the recompile sentinel after every
  dispatch — the sentinel hookup lives HERE, so no dispatch site can
  forget it.
- **resilience hooks**: ``dispatch_retries`` bounded jittered retry
  absorbs transient dispatch errors before they reach the serving
  engine's fault quarantine, and ``stall_threshold`` arms a
  wall-clock watchdog per warm dispatch — a dispatch that overruns it
  leaves a counted ``dispatch_stall`` flight event WHILE still hung (a
  timer thread records it). Both default off.
- **executable_count()** sums the signature counts of every built
  program — the one number the tests, the sentinel baseline and
  ``ServingEngine.executable_count()`` all read.
- **dispatch ledger**: every dispatch is counted per program
  (``program_dispatches_total{program=}`` when the serving engine arms
  the hook) and wall-timed with the ENQUEUE and the FINALIZE measured
  separately: ``call(defer=True)``'s enqueue->finalize gap is the
  device-side window the host overlapped. ``dispatch_stats()`` is the
  always-counted per-program table ``/debug/profile`` serves.

Device completion: PyTorch enqueues a program's kernels on the card's
current stream and returns. An armed watchdog records a
``torch.cuda.Event`` right after the enqueue, and ``finalize()`` waits
on that event alone (``event.synchronize()``), never on the whole
device. On the CPU a dispatch is synchronous, so ``finalize`` only
closes the window.

``mesh`` is accepted at None only; without a mesh the collective
counts are what the reference's are for a one-device program: None
until the program has dispatched once, then 0.
"""

from __future__ import annotations

import random
import threading
import time
import weakref
from typing import Any, Callable, Dict, Optional

from paddle_tpu_torch.core.unported import refuse_unported
from paddle_tpu_torch.testing.fault_injection import fault_point

__all__ = ["ProgramSet"]


def _signature(x) -> Any:
    """The hashable argument signature of one dispatch argument: shape
    and dtype of a tensor or array (a torch tensor and a numpy array of
    one element type sign alike), the signatures of a sequence's items,
    the type of anything else."""
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return (tuple(int(d) for d in shape),
                str(dtype).replace("torch.", ""))
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    return type(x).__name__


def _weak_program(method) -> Callable[[], Callable[..., Any]]:
    """A builder for an engine's program method that does not keep the
    engine alive: the registry would otherwise close a reference cycle
    (engine -> registry -> bound method -> engine), and a dropped
    engine's KV arena would stay allocated until the cyclic collector
    ran."""
    ref = weakref.WeakMethod(method)
    return lambda: lambda *args: ref()(*args)


class _Program:
    """One built program and the argument signatures it was dispatched
    with; ``_cache_size()`` is their count, what the sentinel reads."""

    __slots__ = ("fn", "signatures")

    def __init__(self, fn: Callable[..., Any]):
        self.fn = fn
        self.signatures: set = set()

    def __call__(self, *args):
        self.signatures.add(_signature(args))
        return self.fn(*args)

    def _cache_size(self) -> int:
        return len(self.signatures)


def _device_event(out):
    """A CUDA event recorded on the current stream after ``out``'s
    kernels were enqueued, or None when ``out`` holds no CUDA tensor
    (the CPU ran it synchronously)."""
    import torch

    def on_card(x):
        if isinstance(x, torch.Tensor):
            return x.is_cuda
        if isinstance(x, (list, tuple)):
            return any(on_card(v) for v in x)
        return False

    if not on_card(out):
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


class ProgramSet:
    """Named registry of an engine's programs. ``mesh`` is accepted at
    None only (one device)."""

    def __init__(self, mesh=None):
        refuse_unported("ProgramSet", mesh=(mesh, None))
        self._builders: Dict[str, Callable[[], Any]] = {}
        self._fns: Dict[str, _Program] = {}
        # programs that dispatched successfully at least once: a cold
        # first dispatch builds the program and is exempt from the
        # stall watchdog and the steady-state ledger
        self._warm: set = set()
        # optional RecompileSentinel (observability/); None costs nothing
        self.sentinel = None
        # -- resilience hooks (all default OFF / zero-cost) -------------
        self.dispatch_retries = 0
        self.retry_backoff = 0.05       # seconds, jittered, doubling
        self.stall_threshold: Optional[float] = None
        self.recorder = None            # FlightRecorder (optional)
        self.stall_counter = None       # .inc()-ables (optional)
        self.retry_counter = None
        self.stall_events = 0           # counted regardless of hooks
        self.retry_events = 0
        # dispatch windows CURRENTLY past the stall watchdog (live
        # state: up when the timer fires while the program is still
        # running, down when that window closes) — what /readyz reads
        self.stalls_in_progress = 0
        self._stall_lock = threading.Lock()
        # -- dispatch ledger --------------------------------------------
        self._disp_lock = threading.Lock()
        self._disp_stats: Dict[str, Dict[str, float]] = {}
        self.dispatch_counter = None    # Counter{program=} (optional)
        self.enqueue_hist = None        # Histogram{program=} (optional)
        self.window_hist = None
        self.wall_hist = None

    # -- registry ---------------------------------------------------------
    def register(self, name: str, builder: Callable[[], Any],
                 replace: bool = False):
        """Declare program ``name``; ``builder()`` returns the callable.
        Lazy: nothing is built until the first dispatch. Re-registering
        an already-BUILT name is an error unless ``replace`` (a silently
        swapped program would orphan the signatures the sentinel
        baselined)."""
        if not replace and name in self._fns:
            raise ValueError(
                f"program {name!r} is already built; re-registering "
                "would orphan its signatures")
        self._builders[name] = builder
        if replace:
            self._fns.pop(name, None)
            self._warm.discard(name)

    def defined(self, name: str) -> bool:
        return name in self._builders

    def built(self, name: str) -> bool:
        return name in self._fns

    def get(self, name: str):
        """The program handle for ``name``, building it on first use."""
        fn = self._fns.get(name)
        if fn is None:
            try:
                builder = self._builders[name]
            except KeyError:
                raise KeyError(
                    f"no program {name!r} registered "
                    f"(have: {sorted(self._builders)})") from None
            fn = self._fns[name] = _Program(builder())
        return fn

    # -- dispatch ---------------------------------------------------------
    def call(self, name: str, *args,
             describe: Optional[Callable[[], Any]] = None,
             defer: bool = False):
        """Dispatch ``name`` with ``args``: build on first use, run with
        bounded retry and the stall watchdog when armed, then report the
        program's signature count to the sentinel (``describe`` supplies
        the arg summary a recompile event records).

        ``defer=True`` returns ``(out, finalize)`` the moment the
        program's kernels are enqueued, so the caller can run host work
        (the serving tick's next-round admission) while the card
        computes, and close the window by calling ``finalize()`` right
        before it reads the results. With ``defer=False`` (default)
        ``finalize`` runs inline."""
        fn = self.get(name)
        warm = name in self._warm
        attempt = 0
        while True:
            try:
                t_disp = time.perf_counter()
                out, finalize = self._dispatch(name, fn, args, warm,
                                               attempt)
                t_enq = time.perf_counter()
                break
            except Exception as e:
                if attempt >= self.dispatch_retries:
                    raise
                attempt += 1
                self.retry_events += 1
                if self.retry_counter is not None:
                    self.retry_counter.inc()
                if self.recorder is not None:
                    self.recorder.record("dispatch_retry", program=name,
                                         attempt=attempt, error=repr(e))
                # jittered exponential backoff: bounded, desynchronized
                time.sleep(self.retry_backoff * (2 ** (attempt - 1))
                           * (0.5 + random.random()))
        finalize = self._timed_finalize(name, finalize, t_disp, t_enq,
                                        warm)
        try:
            self._warm.add(name)
            if self.sentinel is not None:
                self.sentinel.observe(name, fn,
                                      describe if describe is not None
                                      else (lambda: {}))
        except BaseException:
            # post-dispatch bookkeeping raised (the sentinel's strict
            # mode): close the dispatch's window before propagating, or
            # an armed timer would record a spurious stall
            finalize()
            raise
        if defer:
            return out, finalize
        finalize()
        return out

    def _dispatch(self, name: str, fn, args, warm: bool,
                  attempt: int = 0):
        """One dispatch; returns ``(out, finalize)``. Watchdogged when
        ``stall_threshold`` is set AND the program is warm (a cold first
        dispatch builds the program and never counts as a stall). The
        watchdog is a timer thread that records the ``dispatch_stall``
        flight event at the threshold, while the dispatch is still
        running. The returned ``finalize`` closes the window: it waits
        for the event recorded after the enqueue, then cancels the
        timer. Unarmed dispatches get a no-op ``finalize`` (the caller's
        host read is the sync)."""
        if self.stall_threshold is None or not warm:
            # chaos hook: armed injectors simulate transient dispatch
            # errors (raise) or hung programs (sleep)
            fault_point("serving:dispatch", program=name,
                        attempt=attempt)
            return fn(*args), (lambda: None)
        t0 = time.perf_counter()
        # "fired" and "closed" flip under one lock: the timer callback
        # runs on its own thread and can race the window close
        # (``timer.cancel()`` does not wait for a callback already
        # running), so a stall never leaves ``stalls_in_progress`` high
        state = {"fired": False, "closed": False}

        def stalled():
            with self._stall_lock:
                if not state["closed"]:
                    state["fired"] = True
                    self.stalls_in_progress += 1
            self.stall_events += 1
            if self.stall_counter is not None:
                self.stall_counter.inc()
            if self.recorder is not None:
                self.recorder.record(
                    "dispatch_stall", program=name,
                    threshold_s=self.stall_threshold,
                    elapsed_s=time.perf_counter() - t0)

        timer = threading.Timer(self.stall_threshold, stalled)
        timer.daemon = True

        def close_window():
            timer.cancel()
            with self._stall_lock:
                state["closed"] = True
                if state["fired"]:
                    state["fired"] = False
                    self.stalls_in_progress -= 1

        timer.start()
        try:
            # inside the watchdog window on purpose: an injected hang
            # must trip the watchdog exactly like a wedged program
            fault_point("serving:dispatch", program=name,
                        attempt=attempt)
            out = fn(*args)
            event = _device_event(out)
        except BaseException:
            # this attempt failed (possibly about to be retried): close
            # its window — the retry arms a fresh one
            close_window()
            raise

        def finalize():
            try:
                if event is not None:
                    event.synchronize()
            finally:
                close_window()

        return out, finalize

    # -- dispatch ledger --------------------------------------------------
    def _timed_finalize(self, name: str, inner, t_disp: float,
                        t_enq: float, warm: bool):
        """Wrap a dispatch's ``finalize`` so closing the window records
        the ledger entry: enqueue = the host-side dispatch call, device
        window = enqueue-return -> window close (under the armed
        watchdog that includes the event wait; unarmed, it runs up to
        the caller's own sync point without forcing one), wall =
        dispatch -> window close. Recorded in a ``finally`` so a
        finalize that raises still leaves its timing. A COLD dispatch
        lands only in the separate cold counters."""
        def finalize():
            try:
                inner()
            finally:
                t_done = time.perf_counter()
                self._record_dispatch(name, t_enq - t_disp,
                                      t_done - t_enq, t_done - t_disp,
                                      warm)
        return finalize

    def _record_dispatch(self, name: str, enqueue_s: float,
                         window_s: float, wall_s: float, warm: bool):
        with self._disp_lock:
            st = self._disp_stats.setdefault(
                name, {"dispatches": 0.0, "enqueue_s": 0.0,
                       "device_window_s": 0.0, "wall_s": 0.0,
                       "cold_dispatches": 0.0, "cold_wall_s": 0.0})
            st["dispatches"] += 1
            if warm:
                st["enqueue_s"] += enqueue_s
                st["device_window_s"] += window_s
                st["wall_s"] += wall_s
            else:
                st["cold_dispatches"] += 1
                st["cold_wall_s"] += wall_s
        if self.dispatch_counter is not None:
            self.dispatch_counter.labels(program=name).inc()
        if not warm:
            return
        if self.enqueue_hist is not None:
            self.enqueue_hist.labels(program=name).observe(enqueue_s)
        if self.window_hist is not None:
            self.window_hist.labels(program=name).observe(window_s)
        if self.wall_hist is not None:
            self.wall_hist.labels(program=name).observe(wall_s)

    def dispatch_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-program cumulative dispatch counts and seconds (a copy):
        ``dispatches`` counts every dispatch, ``enqueue_s`` /
        ``device_window_s`` / ``wall_s`` time the warm ones, and the
        cold first dispatches are split out as ``cold_dispatches`` /
        ``cold_wall_s``."""
        with self._disp_lock:
            return {name: dict(st)
                    for name, st in self._disp_stats.items()}

    # -- counted metrics --------------------------------------------------
    def executable_count(self) -> Optional[int]:
        """Distinct ``(program, signature)`` pairs across every BUILT
        program (a program dispatched with a new argument signature
        counts again, so a per-arrival fork is visible)."""
        return sum(fn._cache_size() for fn in self._fns.values())

    def collective_count(self, name: str) -> Optional[int]:
        """Collectives one dispatch of ``name`` executes: None until it
        has dispatched once, then 0 (one device, no mesh)."""
        return 0 if name in self._warm else None

    def cross_replica_collective_count(self, name: str,
                                       tp: int) -> Optional[int]:
        """Collectives of ``name`` spanning more than one replica: None
        until it has dispatched once, then 0 (one device, no mesh)."""
        return 0 if name in self._warm else None
