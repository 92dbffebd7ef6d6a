"""Fault-tolerant training — the port of
``paddle_tpu/distributed/resilience.py``.

- :func:`retry_call` — bounded retries with jittered exponential
  backoff and structured :class:`TransientFailureWarning`s, used by the
  checkpoint's shard write and host barrier.
- :class:`RetentionPolicy` — keep-last-N plus keep-every-M-steps.
- :class:`CheckpointManager` — periodic async saves on top of
  ``checkpoint.AsyncCheckpointer``, checksum-verified restore with
  automatic fallback to the newest *committed and valid* version, and
  a SIGTERM/preemption handler that drains the in-flight save and
  writes an emergency checkpoint before exit.
- :class:`AnomalyConfig` — the step-level anomaly policy consumed by
  ``ShardedTrainer.enable_anomaly_policy`` (a finite check on the loss
  and the global gradient norm, read once before the update;
  ``skip_step`` / ``rollback`` / ``raise``; loss-spike detection against
  a running median).

The port trains on one card in one process, so process 0 is the only
process: pruning needs no process index and the checkpoint's barriers
have no peer to wait for.
"""

from __future__ import annotations

import os
import random
import shutil
import signal as _signal
import time
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import paddle_tpu_torch.distributed.checkpoint as ckpt
from paddle_tpu_torch.core.flags import get_flag

__all__ = [
    "TransientFailureWarning", "retry_call", "RetentionPolicy",
    "AnomalyConfig", "CheckpointManager",
]


class TransientFailureWarning(UserWarning):
    """A recoverable fault was observed and handled (retried, skipped,
    or fallen back from). Structured enough to grep in run logs; loud
    enough that silent degradation does not accumulate."""


def retry_call(fn: Callable, *args,
               retries: Optional[int] = None,
               base_delay: Optional[float] = None,
               max_delay: float = 30.0,
               retry_on: Tuple[type, ...] = (OSError,),
               describe: str = "",
               **kwargs):
    """Call ``fn`` with bounded retries and jittered exponential
    backoff.

    Defaults come from ``FLAGS_io_max_retries`` /
    ``FLAGS_io_backoff_base_ms``. Attempt ``i`` (0-based) sleeps
    ``min(max_delay, base * 2^i)`` scaled by a uniform [0.5, 1.5)
    jitter before the next try — the jitter decorrelates the retry
    storms of many hosts hitting the same flaky store. Exceptions
    outside ``retry_on`` (including BaseExceptions like a simulated
    crash) propagate immediately; the final failure re-raises the
    original error.
    """
    budget = int(get_flag("FLAGS_io_max_retries")) if retries is None \
        else int(retries)
    base = (float(get_flag("FLAGS_io_backoff_base_ms")) / 1000.0
            if base_delay is None else float(base_delay))
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if attempt >= budget:
                raise
            delay = min(max_delay, base * (2.0 ** attempt))
            delay *= 0.5 + random.random()
            warnings.warn(TransientFailureWarning(
                f"{describe or getattr(fn, '__name__', 'call')}: "
                f"attempt {attempt + 1}/{budget + 1} failed "
                f"({type(e).__name__}: {e}); retrying in "
                f"{delay * 1e3:.0f} ms"), stacklevel=2)
            time.sleep(delay)
            attempt += 1


@dataclass
class RetentionPolicy:
    """Which checkpoint versions survive pruning.

    ``keep_last`` newest committed versions always survive
    (0 = keep everything); additionally every version whose step is a
    multiple of ``keep_every`` survives (0 = off) — the long-horizon
    trail for post-hoc analysis/rollback beyond the recent window.
    """

    keep_last: int = 3
    keep_every: int = 0

    def survivors(self, versions: Iterable[int]) -> set:
        versions = sorted(versions)
        if not self.keep_last:
            return set(versions)
        keep = set(versions[-self.keep_last:])
        if self.keep_every:
            keep.update(v for v in versions if v % self.keep_every == 0)
        return keep


@dataclass
class AnomalyConfig:
    """Step-level anomaly policy for ``ShardedTrainer``.

    ``policy``:
      - ``"skip_step"`` — count and drop the update (the GradScaler
        skip-on-inf shape): parameters/optimizer state keep their
        pre-step values, the step counter still advances.
      - ``"rollback"`` — skip, and after ``rollback_after``
        CONSECUTIVE bad steps restore the last good checkpoint from
        the attached CheckpointManager (persistent blow-ups mean the
        state itself went bad, not just one batch).
      - ``"raise"`` — fail fast with ``FloatingPointError``.

    ``spike_window`` > 0 additionally treats a finite loss above
    ``spike_factor`` x the running median of the last ``spike_window``
    good losses as anomalous (caught by the same fused predicate — the
    threshold is fed into the compiled step as a scalar, so there is
    still no per-op host sync).
    """

    policy: str = "raise"
    rollback_after: int = 3
    spike_window: int = 0
    spike_factor: float = 10.0

    def __post_init__(self):
        if self.policy not in ("skip_step", "rollback", "raise"):
            raise ValueError(
                f"AnomalyConfig: unknown policy {self.policy!r}; expected "
                "'skip_step', 'rollback', or 'raise'")
        if self.rollback_after < 1:
            raise ValueError("AnomalyConfig: rollback_after must be >= 1")


class CheckpointManager:
    """Periodic, preemption-safe checkpointing with retention and
    checksum-verified fallback restore.

    Built on ``checkpoint.AsyncCheckpointer``: ``save()`` copies every
    tensor to host memory synchronously and commits in the background,
    so the training loop stalls only for the host copy. Retention
    (:class:`RetentionPolicy`) prunes *committed* versions once the
    next save has drained. ``restore()`` walks committed versions
    newest-first, verifying per-shard checksums, and falls back (with
    a warning) past corrupt or incomplete versions to the newest valid
    one. ``install_preemption_handler()`` arms a SIGTERM hook that
    drains any in-flight save, writes a final synchronous checkpoint,
    and (by default) re-delivers the signal so the process still dies
    the way the preemption system expects.
    """

    def __init__(self, path: str, trainer=None, *,
                 every_steps: int = 0,
                 keep_last: int = 3, keep_every: int = 0,
                 retention: Optional[RetentionPolicy] = None,
                 async_save: bool = True,
                 verify: Optional[bool] = None):
        self.path = str(path)
        self.retention = retention or RetentionPolicy(keep_last, keep_every)
        self.every_steps = int(every_steps)
        self.async_save = bool(async_save)
        self.verify = verify
        self._trainer = trainer
        self._checkpointer = ckpt.AsyncCheckpointer()
        self._last_saved_step: Optional[int] = None
        self._prev_handlers: Dict[int, Any] = {}
        self._preempted = False

    # -- wiring ---------------------------------------------------------------
    def attach(self, trainer) -> "CheckpointManager":
        self._trainer = trainer
        return self

    def _trainer_snapshot(self):
        t = self._trainer
        if t is None:
            raise ValueError(
                "CheckpointManager: no trainer attached and no explicit "
                "state passed — call attach(trainer) or save(state=...)")
        return t._checkpoint_state(), t._checkpoint_extra()

    # -- saving ---------------------------------------------------------------
    def save(self, state: Optional[Dict[str, Any]] = None,
             extra: Optional[Dict[str, Any]] = None,
             step: Optional[int] = None, *, blocking: bool = False) -> int:
        """Checkpoint ``state`` (or the attached trainer's full train
        state) as version ``step``. Async by default; ``blocking=True``
        commits before returning (emergency/final saves)."""
        if state is None:
            state, t_extra = self._trainer_snapshot()
            extra = {**t_extra, **(extra or {})}
        extra = dict(extra or {})
        if step is None:
            step = int(extra.get("step", 0))
        extra.setdefault("step", step)
        # previous save must commit first (ordering), and its committed
        # version becomes prunable now
        self._checkpointer.wait_until_finished()
        self.prune()
        if blocking or not self.async_save:
            ckpt.save_state(state, self.path, extra=extra, version=step,
                            keep_last=0)
        else:
            self._checkpointer.save(state, self.path, extra=extra,
                                    version=step, keep_last=0)
        self._last_saved_step = step
        return step

    def maybe_save(self, step: Optional[int] = None) -> bool:
        """Periodic hook: save when ``step`` crosses ``every_steps``.
        Returns True when a save was started."""
        if not self.every_steps:
            return False
        if step is None:
            t = self._trainer
            step = int(getattr(t, "_global_step", 0)) if t else 0
        if step <= 0 or step % self.every_steps:
            return False
        if self._last_saved_step == step:
            return False
        self.save(step=step)
        return True

    def wait(self) -> None:
        """Drain the in-flight save (re-raising its error, if any)."""
        self._checkpointer.wait_until_finished()

    # -- retention ------------------------------------------------------------
    def prune(self) -> None:
        """Delete committed versions outside the retention policy.
        Only process 0 touches the store (matching the commit
        protocol; the port's one process is process 0); in-flight
        staging dirs are never touched."""
        versions = ckpt.list_versions(self.path)
        keep = self.retention.survivors(v for v, _ in versions)
        for v, d in versions:
            if v not in keep:
                shutil.rmtree(d, ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def restore(self, mesh=None, specs=None, *, device="cuda"):
        """Restore from the newest committed AND valid version.

        With a trainer attached, loads the full train state into it (on
        the trainer's device) and returns the restored step. Otherwise
        returns ``(arrays, extra)``: tensors on ``device``, ``mesh`` and
        ``specs`` as ``checkpoint.load_state`` takes them. A version that
        fails checksum verification (or any load error: partial coverage,
        unreadable shards) is skipped with a
        :class:`TransientFailureWarning` and the next-older committed
        version is tried.

        A save still in flight is drained first, so the newest state
        saved is a candidate (the reference lists the versions at once: a
        rollback right after an async save raced its commit). A drained
        save that failed is warned about, and the versions committed
        before it are tried.
        """
        try:
            self._checkpointer.wait_until_finished()
        except Exception as e:  # a failed save must not block restore
            warnings.warn(TransientFailureWarning(
                f"in-flight save failed before restore: {e}"), stacklevel=2)
        versions = ckpt.list_versions(self.path)
        if not versions:
            raise FileNotFoundError(
                f"CheckpointManager: no committed checkpoint under "
                f"{self.path}")
        last_err: Optional[BaseException] = None
        verify = True if self.verify is None else bool(self.verify)
        for v, d in reversed(versions):
            try:
                # one verification pass per candidate version: the
                # load itself checksums the shards (verify=) and raises
                # CheckpointCorruptError, which the except below turns
                # into fallback to the next-older committed version
                if self._trainer is not None:
                    self._trainer.load_checkpoint(d, verify=verify)
                    return v
                arrays, extra = ckpt.load_state(d, mesh, specs,
                                                verify=verify, device=device)
                return arrays, extra
            except ckpt.CheckpointCorruptError as e:
                last_err = e
                warnings.warn(TransientFailureWarning(
                    f"checkpoint v{v} failed integrity check ({e}); "
                    "falling back to the previous committed version"),
                    stacklevel=2)
            except (ValueError, OSError) as e:
                last_err = e
                warnings.warn(TransientFailureWarning(
                    f"checkpoint v{v} unreadable ({type(e).__name__}: "
                    f"{e}); falling back to the previous committed "
                    "version"), stacklevel=2)
        raise ckpt.CheckpointCorruptError(
            f"CheckpointManager: every committed checkpoint under "
            f"{self.path} is corrupt or unreadable") from last_err

    # -- preemption -----------------------------------------------------------
    @property
    def preempted(self) -> bool:
        return self._preempted

    def install_preemption_handler(self, signals=(_signal.SIGTERM,),
                                   exit_after_save: bool = True) -> None:
        """Arm the preemption hook: on signal, drain the in-flight
        async save, write a synchronous emergency checkpoint of the
        attached trainer's current state, then either re-deliver the
        signal with the original disposition (``exit_after_save=True``,
        the production default — the preemption system still sees the
        process die) or return to the interrupted program (tests,
        cooperative shutdown loops that poll ``preempted``)."""

        def handler(signum, frame):
            self._preempted = True
            warnings.warn(TransientFailureWarning(
                f"preemption signal {signum}: draining in-flight save "
                "and writing emergency checkpoint"), stacklevel=2)
            try:
                self._checkpointer.wait_until_finished()
            except BaseException as e:  # a dying save must not block the
                warnings.warn(TransientFailureWarning(  # emergency write
                    f"in-flight save failed during drain: {e}"),
                    stacklevel=2)
            if self._trainer is not None:
                self.save(blocking=True)
                self.prune()
            prev = self._prev_handlers.get(signum)
            if exit_after_save:
                _signal.signal(signum, prev if prev is not None
                               else _signal.SIG_DFL)
                os.kill(os.getpid(), signum)
            elif callable(prev):
                prev(signum, frame)

        for s in signals:
            self._prev_handlers[s] = _signal.signal(s, handler)

    def uninstall_preemption_handler(self) -> None:
        for s, prev in self._prev_handlers.items():
            _signal.signal(s, prev if prev is not None else _signal.SIG_DFL)
        self._prev_handlers.clear()

    # -- lifecycle ------------------------------------------------------------
    def close(self) -> None:
        """Drain, prune, disarm. Safe to call more than once."""
        try:
            self._checkpointer.wait_until_finished()
        finally:
            self.uninstall_preemption_handler()
        self.prune()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
