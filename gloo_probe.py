#!/usr/bin/env python3
"""Which collectives the gloo backend takes with CUDA tensors, and what
the port's collective layer does with them, on this machine's card.

Run from the root of a checkout on a machine with a card:
``python3 gloo_probe.py``. Each collective runs in a gang of two ranks
of its own (spawned processes on card 0, a ``file://`` store), since a
refused one may kill its process; a gang is joined with a timeout and
killed past it. Then two ranks time a 0.5 GB fp32 all-reduce and a
gather of 2 x 0.25 GB over gloo, and run the port's ``send``/``recv``,
``alltoall`` and ``ppermute`` (``paddle_tpu_torch/distributed/
collective.py``) on CUDA tensors, checking their values. One line a
result; the ``nvidia-smi`` name and power limit first. It imports
nothing of JAX or ``paddle_tpu``.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time

JOIN_S = 90.0


def _cases(torch, dist, rank, dev):
    x = torch.arange(4.0, device=dev) + rank

    def empties(n, k=4):
        return [torch.empty(k, device=dev) for _ in range(n)]

    return {
        "all_reduce sum": lambda: dist.all_reduce(x.clone()),
        "all_reduce max": lambda: dist.all_reduce(x.clone(),
                                                  op=dist.ReduceOp.MAX),
        "all_reduce avg": lambda: dist.all_reduce(x.clone(),
                                                  op=dist.ReduceOp.AVG),
        "all_reduce product": lambda: dist.all_reduce(
            x.clone(), op=dist.ReduceOp.PRODUCT),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(2, device=dev), x.clone()),
        "all_gather": lambda: dist.all_gather(empties(2), x.clone()),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8, device=dev), x.clone()),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty(4, device=dev), x.clone()),
        "all_to_all (list)": lambda: dist.all_to_all(
            empties(2, 2), list(x.clone().chunk(2))),
        "reduce": lambda: dist.reduce(x.clone(), 0),
        "scatter": lambda: dist.scatter(
            torch.empty(4, device=dev),
            [x.clone(), x.clone()] if rank == 0 else None, src=0),
        "gather": lambda: dist.gather(
            x.clone(), empties(2) if rank == 0 else None, dst=0),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_gather_object": lambda: dist.all_gather_object([None] * 2,
                                                            rank),
        "send/recv": lambda: (dist.send(x.clone(), 1) if rank == 0
                              else dist.recv(torch.empty(4, device=dev), 0)),
        "barrier": lambda: dist.barrier(),
    }


def _one(rank, store, name, out):
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=2,
                            timeout=datetime.timedelta(seconds=30))
    try:
        _cases(torch, dist, rank, torch.device("cuda", 0))[name]()
        torch.cuda.synchronize()
        res = "takes it"
    except RuntimeError as e:
        res = "refuses it: " + str(e).splitlines()[0][:120]
    if rank == 0:
        with open(out, "w") as f:
            f.write(res)
    dist.destroy_process_group()


def _port(rank, store, out):
    """Timings of raw gloo, then the port's staged collectives."""
    import torch
    import torch.distributed as dist

    import paddle_tpu_torch.distributed as pdist
    from paddle_tpu_torch.distributed import env

    torch.cuda.set_device(0)
    pdist.init_parallel_env(f"file://{store}", 2, rank, backend="gloo",
                            timeout=120)
    dev = torch.device("cuda", 0)
    big = torch.randn(124_000_000, device=dev)
    dist.all_reduce(big)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist.all_reduce(big)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    parts = [torch.empty(62_000_000, device=dev) for _ in range(2)]
    dist.all_gather(parts, big[:62_000_000])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del big, parts
    lines = [f"0.5 GB fp32 all-reduce {t1 - t0:.3f} s, 2 x 0.25 GB "
             f"all-gather {t2 - t1:.3f} s"]
    t = torch.full((3,), float(rank), device=dev)
    if rank == 0:
        pdist.send(t + 7, dst=1)
    else:
        pdist.recv(t, src=0)
    got = pdist.alltoall(torch.arange(4.0, device=dev) + 10 * rank)
    mesh = pdist.build_mesh([2], ["mp"])
    with env._mesh_scope(mesh):
        perm = pdist.ppermute(torch.full((2,), float(rank), device=dev),
                              [(0, 1), (1, 0)], "mp")
    ok = (t.tolist() == ([0.0] * 3 if rank == 0 else [7.0] * 3)
          and got.tolist() == ([0.0, 1.0, 10.0, 11.0] if rank == 0
                               else [2.0, 3.0, 12.0, 13.0])
          and perm.tolist() == [float(1 - rank)] * 2)
    lines.append("the port's send/recv, alltoall and ppermute on CUDA "
                 f"tensors over gloo: {'right' if ok else 'WRONG'}")
    if rank == 0:
        with open(out, "w") as f:
            f.write("\n".join(lines))
    dist.destroy_process_group()
    if not ok:
        raise SystemExit(1)


def _gang(target, args, tmp, tag):
    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(tmp, f"store-{tag}")
    procs = [ctx.Process(target=target, args=(r, store, *args))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(0.1, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    return [p.exitcode for p in procs]


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("gloo_probe.py needs a card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), f"| torch {torch.__version__}", flush=True)
    tmp = tempfile.mkdtemp(prefix="gloo-probe-")
    import torch.distributed as dist

    for i, name in enumerate(_cases(torch, dist, 0, "cpu")):
        out = os.path.join(tmp, f"res{i}")
        codes = _gang(_one, (name, out), tmp, i)
        res = open(out).read() if os.path.exists(out) \
            else "killed the process"
        print(f"gloo, CUDA tensors: {name}: {res} (exit codes {codes})",
              flush=True)
    out = os.path.join(tmp, "port")
    codes = _gang(_port, (out,), tmp, "port")
    print(open(out).read() if os.path.exists(out) else "no result",
          f"(exit codes {codes})", flush=True)
    if codes != [0, 0]:
        sys.exit(1)


if __name__ == "__main__":
    main()
