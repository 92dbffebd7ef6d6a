"""Distributed API tail — the port of ``paddle_tpu/distributed/compat.py``:
``ParallelMode``, ``spawn`` and the gloo shims.

``spawn`` starts ``nprocs`` local processes with the launcher's
environment (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_LOCAL_RANK``, ``PADDLE_MASTER``); the function calls
``init_parallel_env`` itself. ``gloo_init_parallel_env`` joins a CPU
process group over gloo at ``server_endpoint``; ``gloo_barrier`` and
``gloo_release`` wait on it and leave it.

The parameter-server data facades of the reference's file
(``InMemoryDataset``, ``QueueDataset``, ``ProbabilityEntry``,
``CountFilterEntry``, ``ShowClickEntry``) are ROADMAP.md Queue 1 item 6
(the parameter server) and are not here.
"""

from __future__ import annotations

import multiprocessing
import os
from typing import Callable

__all__ = ["ParallelMode", "spawn", "gloo_init_parallel_env",
           "gloo_barrier", "gloo_release"]


class ParallelMode:
    """Reference fleet/base/topology.py ParallelMode constants."""

    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


def _spawn_entry(func, rank, nprocs, env_vars, args):
    for k, v in env_vars.items():
        os.environ[k] = v
    os.environ["PADDLE_TRAINER_ID"] = str(rank)
    os.environ["PADDLE_LOCAL_RANK"] = str(rank)
    os.environ["PADDLE_TRAINERS_NUM"] = str(nprocs)
    func(*args)


def spawn(func: Callable, args=(), nprocs: int = 1, join: bool = True,
          daemon: bool = False, **options):
    """Run ``func(*args)`` in ``nprocs`` local processes with the trainer
    environment set. ``options``: ``master`` (``host:port`` or a
    ``tcp://``/``file://`` URL; default ``127.0.0.1:<port>``, a free
    port unless ``port`` names one). With ``join`` a failed process
    raises ``RuntimeError`` naming the exit codes."""
    from paddle_tpu_torch.distributed.env import _free_port

    ctx = multiprocessing.get_context("spawn")
    master = options.get("master",
                         f"127.0.0.1:{options.get('port', _free_port())}")
    env_vars = {"PADDLE_MASTER": master}
    procs = []
    for rank in range(nprocs):
        p = ctx.Process(target=_spawn_entry,
                        args=(func, rank, nprocs, env_vars, tuple(args)),
                        daemon=daemon)
        p.start()
        procs.append(p)
    if join:
        for p in procs:
            p.join()
        bad = [p.exitcode for p in procs if p.exitcode]
        if bad:
            raise RuntimeError(f"spawned process failed: exitcodes {bad}")
    return procs


def gloo_init_parallel_env(rank_id: int, rank_num: int,
                           server_endpoint: str):
    """Join a gloo process group of ``rank_num`` ranks at
    ``server_endpoint`` as ``rank_id``."""
    from paddle_tpu_torch.distributed.env import init_parallel_env

    os.environ.setdefault("PADDLE_TRAINER_ID", str(rank_id))
    os.environ.setdefault("PADDLE_TRAINERS_NUM", str(rank_num))
    os.environ.setdefault("PADDLE_MASTER", server_endpoint)
    init_parallel_env(server_endpoint, rank_num, rank_id, backend="gloo")


def gloo_barrier():
    from paddle_tpu_torch.distributed.collective import barrier

    barrier()


def gloo_release():
    """Leave the process group (nothing to do without one)."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import env

    if env._dist_on():
        dist.destroy_process_group()
    env._GLOBAL["initialized"] = False
    return None
