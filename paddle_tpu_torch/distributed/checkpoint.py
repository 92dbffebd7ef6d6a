"""Checkpoint save/resume — the port of
``paddle_tpu/distributed/checkpoint.py``.

It writes the reference's on-disk format (``"format":
"paddle_tpu.sharded.v1"``), so a checkpoint written by either package
loads in the other:

- ``path/v<version:012d>/`` per version, written as
  ``v<...>.staging`` and renamed once committed;
- ``shard-0.npz`` (one entry ``<name>#<j>`` per saved piece),
  ``index-0.json`` (each entry's array name and global
  ``[[start, stop], ...]`` window), ``checksums-0.json`` (the sha256 of
  both), ``meta.json`` (every array's shape and dtype name, the
  ``extra`` train state, ``"nprocs"``) and ``COMMIT-0``.

One process writes every tensor whole as one piece. Over a mesh of
ranks (``torch.distributed``), the reference's multi-process layout:
each rank writes ``shard-<rank>.npz`` and ``index-<rank>.json`` with
the pieces it is the first replica of (a ``_Piece``: this rank's window
of a tensor of a global shape, written when ``replica_id`` would be 0),
its ``checksums-<rank>.json`` and ``COMMIT-<rank>``; rank 0 writes
``meta.json`` (``"nprocs"``: the world size); then a barrier over the
process group, the rename by rank 0, and a second barrier.
:func:`load_state` assembles each array, or with a ``mesh`` and
``specs`` each rank's window of it, from every saved piece that
overlaps it, whatever mesh or package saved it. It returns torch
tensors on a keyword-only ``device`` (``"cuda"`` unless the caller asks
for the CPU). The async checkpointer's commit runs off the training
thread, where no collective may run: over more than one rank it raises
``NotImplementedError`` (ROADMAP.md Queue 1 item 6).

bfloat16: numpy has no bfloat16 without ``ml_dtypes``. The reference
writes a bf16 array's raw 2-byte elements (numpy reads them back as
``'<V2'``) with ``"dtype": "bfloat16"`` in ``meta.json``; the port
writes the same bytes the same way and reads ``'<V2'`` entries back
through int16 into ``torch.bfloat16``, bit for bit.

The train state's RNG: the reference stores its JAX key data under
``extra["rng"]``, which the port cannot reproduce (threefry). The port
stores torch's global generators (the CPU one and each card's) under a
key of its own, ``extra["torch_rng"]`` (:func:`save_rng_state`), and
never writes ``"rng"``; each package ignores the other's entry. So the
tensors, ``step`` and ``lr_scheduler`` cross both ways.

Crash safety, retries and fault points are the reference's: the shard
write runs under ``resilience.retry_call`` behind the fault point
``ckpt:shard_write``; ``ckpt:pre_commit`` sits between the data files
and the ``COMMIT`` marker; every host barrier attempt passes
``ckpt:host_barrier`` (with one process there is no peer to wait for).
"""

from __future__ import annotations

import atexit
import hashlib
import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.core.place import resolve_device

__all__ = ["save_state", "load_state", "load_meta", "save_rng_state",
           "load_rng_state", "AsyncCheckpointer", "CheckpointCorruptError",
           "list_versions", "verify_checkpoint"]

# meta.json's dtype names (numpy's, as the reference writes them)
_DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int64: "int64", torch.int32: "int32",
                torch.int16: "int16", torch.int8: "int8",
                torch.uint8: "uint8", torch.bool: "bool"}
_RAW_BF16 = np.dtype("V2")


class CheckpointCorruptError(RuntimeError):
    """A committed checkpoint failed its integrity check (per-shard
    checksum mismatch / unreadable shard). CheckpointManager catches
    this to fall back to the previous committed version."""


class _Piece:
    """This rank's window ``bounds`` (``[[start, stop], ...]``) of a
    tensor of global ``shape``, written when ``write`` (the first
    replica of that window)."""

    __slots__ = ("value", "shape", "bounds", "write")

    def __init__(self, value, shape, bounds, write: bool):
        self.value, self.shape = value, tuple(shape)
        self.bounds, self.write = bounds, write


def _rank_world() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier(tag: str):
    """The barrier of a multi-process save, over the process group; one
    process has no peer to wait for."""
    import torch.distributed as dist

    if _rank_world()[1] > 1:
        dist.barrier()


def _host_barrier(tag: str):
    """The host-side barrier of the async commit, under the reference's
    bounded retries (``resilience.retry_call`` on ConnectionError and
    TimeoutError). Each attempt passes the ``ckpt:host_barrier`` fault
    point; with one process there is nothing more to wait for."""
    from paddle_tpu_torch.distributed.resilience import retry_call
    from paddle_tpu_torch.testing import fault_injection as fi

    def attempt():
        fi.fault_point("ckpt:host_barrier", tag=tag)

    retry_call(attempt, describe=f"checkpoint barrier {tag!r}",
               retry_on=(ConnectionError, TimeoutError))


def _to_host(value) -> Tuple[np.ndarray, str]:
    """A host copy of one value, never sharing its storage (training
    updates tensors in place while an async save is still writing), and
    its dtype name. bf16 becomes its raw 2-byte elements."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        name = _DTYPE_NAMES[t.dtype]
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arr = t.to("cpu", copy=True).numpy()
        return (arr.view(_RAW_BF16) if name == "bfloat16" else arr), name
    arr = np.array(value, copy=True)
    return arr, str(arr.dtype)


def _snapshot_to_host(state: Dict[str, Any]):
    """Host copies of every value: the only part of a save that must be
    synchronous with training (the async checkpointer's phase split)."""
    shards: Dict[str, np.ndarray] = {}
    index_map: Dict[str, Dict] = {}
    meta_arrays: Dict[str, Dict] = {}
    for name, value in state.items():
        key = f"{name}#0"
        if isinstance(value, _Piece):
            meta_arrays[name] = {"shape": list(value.shape),
                                 "dtype": _DTYPE_NAMES[value.value.dtype]}
            if value.write:
                shards[key] = _to_host(value.value)[0]
                index_map[key] = {"name": name, "bounds": value.bounds}
            continue
        arr, dtype = _to_host(value)
        meta_arrays[name] = {"shape": list(arr.shape), "dtype": dtype}
        shards[key] = arr
        index_map[key] = {"name": name,
                          "bounds": [[0, d] for d in arr.shape]}
    return shards, index_map, meta_arrays


def save_state(state: Dict[str, Any], path: str,
               extra: Optional[Dict[str, Any]] = None,
               version: Optional[int] = None, keep_last: int = 2):
    """Write every tensor (or array) of ``state`` as version ``version``
    (default ``extra["step"]``) under ``path``, crash-safely: the data
    goes into ``v<version>.staging``, which is renamed to ``v<version>``
    only once its COMMIT marker is written, so an interrupted save never
    clobbers the previous checkpoint. Committed versions beyond the
    newest ``keep_last`` are pruned (0 keeps every version)."""
    if version is None:
        version = int((extra or {}).get("step", 0))
    shards, index_map, meta_arrays = _snapshot_to_host(state)
    _write_shards(path, version, shards, index_map, meta_arrays,
                  extra, keep_last)


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _write_shards(path: str, version: int, shards, index_map, meta_arrays,
                  extra, keep_last: int, barrier: Callable = _barrier):
    from paddle_tpu_torch.distributed.resilience import retry_call
    from paddle_tpu_torch.testing import fault_injection as fi

    final = os.path.join(path, f"v{version:012d}")
    staging = final + ".staging"
    pid, nprocs = _rank_world()
    os.makedirs(staging, exist_ok=True)

    def write_data():
        # transient filesystem errors retry with backoff; the files are
        # rewritten whole on each attempt
        fi.fault_point("ckpt:shard_write", version=version, process=pid)
        np.savez(os.path.join(staging, f"shard-{pid}.npz"), **shards)
        with open(os.path.join(staging, f"index-{pid}.json"), "w") as f:
            json.dump(index_map, f)

    retry_call(write_data, describe=f"checkpoint shard write v{version}",
               retry_on=(OSError,))
    # integrity record, written AFTER the data files so a crash between
    # them leaves a detectably incomplete version
    sums = {name: _sha256_file(os.path.join(staging, name))
            for name in (f"shard-{pid}.npz", f"index-{pid}.json")}
    with open(os.path.join(staging, f"checksums-{pid}.json"), "w") as f:
        json.dump(sums, f)
    if pid == 0:
        with open(os.path.join(staging, "meta.json"), "w") as f:
            json.dump({"arrays": meta_arrays, "extra": extra or {},
                       "nprocs": nprocs, "format": "paddle_tpu.sharded.v1"},
                      f)
    # a crash here leaves a staging dir with full data and no COMMIT:
    # load_state ignores it and restores the previous committed version
    fi.fault_point("ckpt:pre_commit", version=version, process=pid)
    with open(os.path.join(staging, f"COMMIT-{pid}"), "w") as f:
        f.write("ok")
    barrier(f"save-{version}")
    if pid == 0:
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(staging, final)
        versions = sorted(d for d in os.listdir(path)
                          if d.startswith("v") and not d.endswith(".staging")
                          and os.path.isdir(os.path.join(path, d)))
        for old in versions[:-keep_last] if keep_last else []:
            shutil.rmtree(os.path.join(path, old), ignore_errors=True)
    barrier(f"commit-{version}")


class AsyncCheckpointer:
    """Background-thread checkpoint writer.

    ``save()`` copies every tensor to host memory synchronously (so
    training may update the tensors in place at once), then writes and
    commits on a daemon thread. ``wait_until_finished()`` joins the
    in-flight save and re-raises its error; a new ``save()`` first waits
    for the previous one (checkpoints commit in order); an atexit hook
    drains the last save so a normal interpreter exit cannot drop a
    checkpoint mid-write.
    """

    def __init__(self):
        self._thread = None
        self._error = None
        atexit.register(self._drain_at_exit)

    def _drain_at_exit(self):
        t = self._thread
        if t is not None and t.is_alive():
            t.join()

    def save(self, state: Dict[str, Any], path: str,
             extra: Optional[Dict[str, Any]] = None,
             version: Optional[int] = None, keep_last: int = 2) -> None:
        self.wait_until_finished()
        if _rank_world()[1] > 1:
            raise NotImplementedError(
                "AsyncCheckpointer over more than one rank: its commit "
                "needs a host barrier off the collectives (ROADMAP.md "
                "Queue 1 item 6); use save_state")
        if version is None:
            version = int((extra or {}).get("step", 0))
        shards, index_map, meta_arrays = _snapshot_to_host(state)

        def work():
            try:
                _write_shards(path, version, shards, index_map,
                              meta_arrays, extra, keep_last,
                              barrier=_host_barrier)
            except BaseException as e:  # surfaced on wait/next save
                self._error = e

        self._thread = threading.Thread(
            target=work, name="paddle-tpu-torch-async-ckpt", daemon=True)
        self._thread.start()

    def wait_until_finished(self) -> None:
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    @property
    def in_flight(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()


def _is_committed(d: str) -> bool:
    meta_path = os.path.join(d, "meta.json")
    if not os.path.exists(meta_path):
        return False
    with open(meta_path) as f:
        nprocs = json.load(f).get("nprocs", 1)
    return all(os.path.exists(os.path.join(d, f"COMMIT-{i}"))
               for i in range(nprocs))


def _resolve_dir(path: str) -> str:
    """Accept either a committed version dir itself or the checkpoint
    root (picks the newest committed version)."""
    if os.path.exists(os.path.join(path, "meta.json")):
        return path
    versions = sorted((d for d in os.listdir(path)
                       if d.startswith("v") and not d.endswith(".staging")),
                      reverse=True)
    for d in versions:
        cand = os.path.join(path, d)
        if _is_committed(cand):
            return cand
    raise FileNotFoundError(f"no committed checkpoint under {path}")


def list_versions(path: str) -> List[Tuple[int, str]]:
    """All COMMITTED versions under the checkpoint root, oldest first,
    as (version, dirpath). Staging leftovers and uncommitted dirs are
    excluded — they are exactly what a crashed save leaves behind."""
    if not os.path.isdir(path):
        return []
    out = []
    for d in sorted(os.listdir(path)):
        if not d.startswith("v") or d.endswith(".staging"):
            continue
        cand = os.path.join(path, d)
        if os.path.isdir(cand) and _is_committed(cand):
            try:
                out.append((int(d[1:]), cand))
            except ValueError:
                continue
    return out


def verify_checkpoint(path: str) -> None:
    """Integrity-check one version dir: every shard/index file must
    match its recorded sha256. Raises :class:`CheckpointCorruptError`
    on mismatch or unreadable data; checkpoints written before
    checksums existed (no checksums-*.json) pass unverified."""
    path = _resolve_dir(path)
    sum_files = [f for f in os.listdir(path) if f.startswith("checksums-")]
    for fname in sum_files:
        with open(os.path.join(path, fname)) as f:
            sums = json.load(f)
        for name, want in sums.items():
            target = os.path.join(path, name)
            try:
                got = _sha256_file(target)
            except OSError as e:
                raise CheckpointCorruptError(
                    f"checkpoint {path}: cannot read {name}: {e}") from e
            if got != want:
                raise CheckpointCorruptError(
                    f"checkpoint {path}: checksum mismatch for {name} "
                    f"(expected {want[:12]}…, got {got[:12]}…) — shard "
                    "data corrupted after commit")


def _load_indices(path: str):
    files = sorted(f for f in os.listdir(path) if f.startswith("index-"))
    per_name: Dict[str, list] = {}
    for fname in files:
        pid = fname[len("index-"):-len(".json")]
        with open(os.path.join(path, fname)) as f:
            idx = json.load(f)
        for key, rec in idx.items():
            per_name.setdefault(rec["name"], []).append(
                (pid, key, rec["bounds"]))
    return per_name


def load_meta(path: str) -> Dict[str, Any]:
    with open(os.path.join(_resolve_dir(path), "meta.json")) as f:
        return json.load(f)


def _host_dtype(name: str) -> np.dtype:
    return _RAW_BF16 if name == "bfloat16" else np.dtype(name)


def _assemble(path, name, pieces, want, dtype, npz) -> np.ndarray:
    """The window ``want`` (``[[start, stop], ...]``) of array ``name``
    from every saved piece that overlaps it; raises ValueError when the
    pieces do not cover it."""
    shape = tuple(b - a for a, b in want)
    if len(pieces) == 1 and pieces[0][2] == want:
        data = npz(pieces[0][0])[pieces[0][1]]   # one piece, the window
        if data.shape == shape and data.dtype == dtype:
            return data
    buf = np.empty(shape, dtype)
    filled = 0
    for pid, key, bounds in pieces:
        inter = [(max(a1, a2), min(b1, b2))
                 for (a1, b1), (a2, b2) in zip(bounds, want)]
        if any(a >= b for a, b in inter):
            continue
        data = npz(pid)[key]
        src = tuple(slice(a - sb[0], b - sb[0])
                    for (a, b), sb in zip(inter, bounds))
        dst = tuple(slice(a - w[0], b - w[0]) for (a, b), w in zip(inter,
                                                                 want))
        buf[dst] = data[src]
        filled += int(np.prod([b - a for a, b in inter]))
    if filled != int(np.prod(buf.shape)):
        raise ValueError(
            f"checkpoint {path}: array {name!r} window {want} not fully "
            "covered by saved shards (was the save interrupted?)")
    return buf


def load_state(path: str, mesh=None, specs=None,
               verify: Optional[bool] = None, *, device="cuda"
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Restore every array of a checkpoint as a tensor on ``device``.

    ``path`` may be the checkpoint root (the newest committed version is
    used) or a version dir. Each array is assembled from the saved pieces
    that overlap it, whatever mesh saved it: whole, or, with a ``mesh``
    of ranks (``distributed.env.Mesh``), this rank's window of the spec
    ``specs[name]`` gives it (replicated where ``specs`` has none).
    Returns ``(tensors, extra)``.

    ``verify`` (default ``FLAGS_ckpt_verify``) checksums every shard
    before reading; corruption raises :class:`CheckpointCorruptError`.
    Fallback to an older version is the caller's decision
    (``resilience.CheckpointManager.restore``)."""
    from paddle_tpu_torch.distributed.env import Mesh

    if mesh is not None and getattr(mesh, "size", 1) != 1 \
            and not isinstance(mesh, Mesh):
        raise NotImplementedError(
            "load_state: a mesh of more than one device is a "
            "distributed.env Mesh over torch.distributed ranks")
    ranked = isinstance(mesh, Mesh) and mesh.size > 1
    dev = resolve_device(device)
    path = _resolve_dir(path)
    if verify is None:
        from paddle_tpu_torch.core.flags import get_flag

        verify = bool(get_flag("FLAGS_ckpt_verify"))
    if verify:
        verify_checkpoint(path)
    meta = load_meta(path)
    per_name = _load_indices(path)
    npz_cache: Dict[str, Any] = {}

    def npz(pid: str):
        if pid not in npz_cache:
            npz_cache[pid] = np.load(os.path.join(path, f"shard-{pid}.npz"))
        return npz_cache[pid]

    out: Dict[str, torch.Tensor] = {}
    try:
        for name, info in meta["arrays"].items():
            pieces = per_name.get(name)
            if not pieces:
                raise FileNotFoundError(
                    f"checkpoint {path} has no data for array {name!r}")
            shape = tuple(info["shape"])
            want = (mesh.window((specs or {}).get(name, ()), shape)
                    if ranked else [[0, d] for d in shape])
            arr = _assemble(path, name, pieces, want,
                            _host_dtype(info["dtype"]), npz)
            if info["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            out[name] = t.to(dev)
    finally:
        for z in npz_cache.values():
            z.close()
    return out, meta.get("extra", {})


def save_rng_state() -> Dict[str, list]:
    """Torch's global generators as JSON-able lists (for exact resume):
    ``{"cpu": [...], "cuda": [[...] per card]}``; the card's only once
    CUDA is initialized (before that no draw has touched them)."""
    cuda = ([s.tolist() for s in torch.cuda.get_rng_state_all()]
            if torch.cuda.is_available() and torch.cuda.is_initialized()
            else [])
    return {"cpu": torch.get_rng_state().tolist(), "cuda": cuda}


def load_rng_state(data) -> None:
    torch.set_rng_state(torch.tensor(data["cpu"], dtype=torch.uint8))
    if data.get("cuda") and torch.cuda.is_available():
        for i, s in enumerate(data["cuda"][:torch.cuda.device_count()]):
            torch.cuda.set_rng_state(torch.tensor(s, dtype=torch.uint8), i)
