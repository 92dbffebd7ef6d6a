"""``python -m paddle_tpu_torch.distributed.launch`` — the port of
``paddle_tpu/distributed/launch/main.py``.

Parses the job's shape, writes each worker's environment (the
``PADDLE_*`` contract ``init_parallel_env`` reads: ``PADDLE_MASTER``,
``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, ``PADDLE_LOCAL_RANK``,
``PADDLE_NODE_RANK``, ``PADDLE_RESTART_COUNT``), starts one worker
process per rank with its output in ``<log_dir>/workerlog.<rank>``,
watches the gang, tears it down when a worker fails, and restarts the
whole gang up to ``--max_restarts`` times (single node). Each worker
joins the process group itself (``init_parallel_env`` or ``fleet.init``)
at ``PADDLE_MASTER``, a free local port unless ``--master`` names one;
rank ``r`` of a node takes card ``PADDLE_LOCAL_RANK % device_count``.
``--devices 0,1`` sets the workers' ``CUDA_VISIBLE_DEVICES``.

The reference's elastic membership (``--elastic_store``, ``--job_id``:
``fleet/elastic``) is ROADMAP.md Queue 1 item 6 and is not here.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import List, Optional

__all__ = ["launch", "main"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="Launch a multi-process distributed job")
    p.add_argument("--nnodes", type=int, default=1,
                   help="number of hosts in the job")
    p.add_argument("--node_rank", type=int,
                   default=int(os.environ.get("PADDLE_NODE_RANK", "0")),
                   help="this host's index")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="worker processes on this host")
    p.add_argument("--master", type=str,
                   default=os.environ.get("PADDLE_MASTER"),
                   help="rendezvous address host:port (defaults to a "
                        "local free port for single-node jobs)")
    p.add_argument("--log_dir", type=str, default="log",
                   help="per-rank stdout/stderr directory")
    p.add_argument("--max_restarts", type=int, default=0,
                   help="restart the whole gang on worker failure up to "
                        "this many times")
    p.add_argument("--devices", type=str, default=None,
                   help="the workers' CUDA_VISIBLE_DEVICES (e.g. '0,1')")
    p.add_argument("training_script", type=str,
                   help="the script to run")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _worker_env(args, local_rank: int, restart: int) -> dict:
    world = args.nnodes * args.nproc_per_node
    rank = args.node_rank * args.nproc_per_node + local_rank
    env = dict(os.environ)
    env.update({
        "PADDLE_MASTER": args.master,
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_LOCAL_RANK": str(local_rank),
        "PADDLE_NODE_RANK": str(args.node_rank),
        "PADDLE_RESTART_COUNT": str(restart),
    })
    if args.devices:
        env["CUDA_VISIBLE_DEVICES"] = args.devices
    return env


def _spawn(args, restart: int) -> List[subprocess.Popen]:
    os.makedirs(args.log_dir, exist_ok=True)
    procs = []
    for local_rank in range(args.nproc_per_node):
        rank = args.node_rank * args.nproc_per_node + local_rank
        cmd = [sys.executable, args.training_script,
               *args.training_script_args]
        log_path = os.path.join(args.log_dir, f"workerlog.{rank}")
        logf = open(log_path, "ab")
        proc = subprocess.Popen(cmd, env=_worker_env(args, local_rank,
                                                     restart),
                                stdout=logf, stderr=subprocess.STDOUT)
        proc._log_file = logf  # keep the handle alive with the proc
        procs.append(proc)
    return procs


def _terminate(procs: List[subprocess.Popen], sig=signal.SIGTERM,
               grace: float = 10.0):
    for p in procs:
        if p.poll() is None:
            try:
                p.send_signal(sig)
            except OSError:
                pass
    deadline = time.time() + grace
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    for p in procs:
        f = getattr(p, "_log_file", None)
        if f is not None:
            f.close()


def _watch(procs: List[subprocess.Popen], poll_interval: float = 0.2) -> int:
    """Block until all workers exit (0) or any fails (its returncode);
    on failure the rest of the gang is torn down."""
    while True:
        alive = False
        for p in procs:
            rc = p.poll()
            if rc is None:
                alive = True
            elif rc != 0:
                _terminate([q for q in procs if q is not p])
                return rc
        if not alive:
            return 0
        time.sleep(poll_interval)


def launch(argv: Optional[List[str]] = None) -> int:
    from paddle_tpu_torch.distributed.env import _free_port

    args = parse_args(argv)
    if not args.master:
        if args.nnodes > 1:
            raise SystemExit("--master host:port is required for multi-node "
                             "jobs")
        args.master = f"127.0.0.1:{_free_port()}"
    attempt = 0
    while True:
        procs = _spawn(args, attempt)
        print(f"[launch] attempt {attempt}: spawned "
              f"{len(procs)} workers (node {args.node_rank}/{args.nnodes}, "
              f"master {args.master}, logs in {args.log_dir}/)",
              flush=True)
        try:
            rc = _watch(procs)
        except KeyboardInterrupt:
            _terminate(procs, signal.SIGINT)
            return 130
        _terminate(procs)
        if rc == 0:
            return 0
        if attempt >= args.max_restarts:
            print(f"[launch] worker failed with exit code {rc}; "
                  f"no restarts left", flush=True)
            return rc
        if args.nnodes > 1:
            print(f"[launch] worker failed with exit code {rc}; in-place "
                  "restart is single-node only (multi-node gangs must be "
                  "relaunched by the job scheduler)", flush=True)
            return rc
        attempt += 1
        args.master = f"127.0.0.1:{_free_port()}"
        print(f"[launch] worker failed with exit code {rc}; restarting "
              f"(attempt {attempt}/{args.max_restarts})", flush=True)


def main():
    sys.exit(launch())


if __name__ == "__main__":
    main()
