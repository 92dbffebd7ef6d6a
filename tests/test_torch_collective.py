"""The port's collectives (``paddle_tpu_torch.distributed.collective``)
over a gang of four gloo ranks on the CPU, against numpy and against the
JAX package's ``shard_map`` forms at the same inputs
(``tests/test_distributed.py:74-142``), and one launch of
``python -m paddle_tpu_torch.distributed.launch``.

One gang of four spawned processes runs every case (a module-scoped
fixture). Each rank joins over ``init_method="file://<tmp>/store"`` (no
port to race for under xdist) with a 60 s timeout on the group, and each
join of the gang carries its own timeout. The spawned ranks import this
module, which imports no JAX: the JAX references run in the test
process, inside the tests. Every collective's result is exact (small
integers in fp32).

``run_gang`` is shared with the other gang tests
(``test_torch_mp_layers.py``, ``test_torch_mesh_trainer.py``,
``test_torch_pipeline.py``, ``test_torch_sep.py``), and so are
``start_gang`` (the same in a thread, beside the JAX references) and
``once_per_session``, which builds each module's gang once per test
session under xdist.
"""

import json
import multiprocessing
import os
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

GANG_TIMEOUT_S = 150.0
GROUP_TIMEOUT_S = 60.0
WORLD = 4
REPO = Path(__file__).resolve().parents[1]


def _rank_entry(target, rank, world, store, args):
    torch.set_num_threads(1)
    err = Path(store).with_name(f"rank{rank}.err")
    try:
        import torch.distributed as dist

        from paddle_tpu_torch.distributed import init_parallel_env

        init_parallel_env(f"file://{store}", world, rank, backend="gloo",
                          timeout=GROUP_TIMEOUT_S)
        target(rank, *args)
        dist.destroy_process_group()
    except BaseException:
        err.write_text(traceback.format_exc())
        raise


def _alive(pid: int) -> bool:
    """Whether process ``pid`` runs (a zombie does not)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return True
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


def once_per_session(tmp_path_factory, name, build,
                     timeout=2 * GANG_TIMEOUT_S):
    """``build(work_dir)``'s value, computed once per test session. Under
    xdist a module's tests spread over the workers and each would build
    its own module fixture (a gang of ranks and the JAX runs); here the
    first worker to ask builds it in the session's shared temp dir and
    pickles the value, and the others wait for that file (at most
    ``timeout`` seconds) and load it. The lock holds the builder's pid: a
    waiter fails at once when the builder is gone without a result (a
    worker that crashed mid-build)."""
    import pickle
    import time

    if "PYTEST_XDIST_WORKER" not in os.environ:
        return build(tmp_path_factory.mktemp(name))
    root = tmp_path_factory.getbasetemp().parent
    done = root / f"{name}.pkl"
    lock = root / f"{name}.lock"
    try:
        fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        deadline = time.monotonic() + timeout
        while not done.exists():
            assert time.monotonic() < deadline, \
                f"{name}: the worker building it did not finish"
            pid = lock.read_text().strip()
            assert not pid or _alive(int(pid)) or done.exists(), \
                f"{name}: the worker building it (pid {pid}) died"
            time.sleep(0.5)
        ok, value = pickle.loads(done.read_bytes())
        assert ok, f"{name}: its build failed in another worker:\n{value}"
        return value
    os.write(fd, str(os.getpid()).encode())
    os.close(fd)
    work = root / name
    work.mkdir()
    try:
        value = build(work)
    except BaseException:
        result = (False, traceback.format_exc())
        raise
    else:
        result = (True, value)
    finally:
        tmp = root / f"{name}.pkl.tmp"
        tmp.write_bytes(pickle.dumps(result))
        tmp.rename(done)
    return value


def run_gang(target, world, tmp, *args, timeout=GANG_TIMEOUT_S):
    """Run ``target(rank, *args)`` in ``world`` spawned gloo ranks; every
    rank must exit 0 within ``timeout`` seconds."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    store = tmp / "store"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry,
                         args=(target, r, world, str(store), args))
             for r in range(world)]
    for p in procs:
        p.start()
    import time

    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.1, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    errs = "".join(f.read_text() for f in sorted(tmp.glob("rank*.err")))
    assert not hung, f"gang timed out after {timeout} s\n{errs}"
    assert all(p.exitcode == 0 for p in procs), \
        f"exit codes {[p.exitcode for p in procs]}\n{errs}"


def wait_for(path, timeout=GANG_TIMEOUT_S):
    """In a rank: wait until the test process has written ``path``."""
    import time

    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        assert time.monotonic() < deadline, f"{path} never came"
        time.sleep(0.2)


def start_gang(target, world, tmp, *args, timeout=GANG_TIMEOUT_S):
    """``run_gang`` in a thread, so the test process computes its JAX
    references while the ranks run; returns a function that waits for
    the gang and raises its failure."""
    import threading

    failed = []

    def body():
        try:
            run_gang(target, world, tmp, *args, timeout=timeout)
        except BaseException as e:     # re-raised by wait()
            failed.append(e)

    thread = threading.Thread(target=body, daemon=True)
    thread.start()

    def wait():
        thread.join()
        if failed:
            raise failed[0]

    return wait


# -- the gang -----------------------------------------------------------------

def _x(rank):
    """Rank r's input: (8, 2) with entries 100 r + 0..15."""
    return torch.arange(16, dtype=torch.float32).reshape(8, 2) + 100 * rank


def _collectives(rank, out):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import env

    res = {}
    for op in ("sum", "max", "min", "avg", "prod"):
        t = _x(rank)[:2] / 100 + 1
        dist.all_reduce(t, op=op)
        res[f"all_reduce_{op}"] = t.tolist()
    res["all_reduce_x"] = dist.all_reduce(_x(rank)).tolist()
    res["all_gather"] = dist.all_gather(_x(rank)).tolist()
    res["all_gather_tiled"] = dist.all_gather(_x(rank), tiled=True).tolist()
    lst = []
    dist.all_gather(lst, _x(rank)[0])
    res["all_gather_list"] = [t.tolist() for t in lst]
    res["reduce_scatter"] = dist.reduce_scatter(_x(rank)).tolist()
    res["reduce_scatter_dim1"] = dist.reduce_scatter(
        _x(rank).t().contiguous(), scatter_dim=1).tolist()
    t = _x(rank)
    dist.broadcast(t, src=2)
    res["broadcast"] = t.tolist()
    t = _x(rank)
    dist.reduce(t, dst=1)
    res["reduce"] = t.tolist()
    t = torch.zeros(2)
    dist.scatter(t, [torch.full((2,), float(10 * i + rank)) for i in
                     range(WORLD)] if rank == 3 else None, src=3)
    res["scatter"] = t.tolist()
    res["alltoall"] = dist.alltoall(_x(rank), split_axis=0,
                                    concat_axis=1).tolist()
    outs = []
    dist.alltoall([torch.full((3,), float(10 * rank + j))
                   for j in range(WORLD)], outs)
    res["alltoall_list"] = [o.tolist() for o in outs]
    objs = []
    dist.all_gather_object(objs, {"rank": rank})
    res["all_gather_object"] = objs
    if rank in (0, 3):
        t = torch.full((2,), float(rank))
        if rank == 0:
            dist.send(t + 7, dst=3)
        else:
            dist.recv(t, src=0)
        res["send_recv"] = t.tolist()
    dist.barrier()
    # subgroups and the axes of a bound 2 x 2 mesh
    g = dist.new_group([1, 3])
    t = torch.full((2,), float(rank))
    if rank in (1, 3):
        dist.all_reduce(t, group=g)
    res["subgroup"] = t.tolist()
    mesh = dist.build_mesh([2, 2], ["dp", "mp"])
    res["mesh_coord"] = [mesh.coord["dp"], mesh.coord["mp"]]
    with env._mesh_scope(mesh):
        for axis in ("dp", "mp"):
            t = torch.full((2,), float(rank))
            dist.all_reduce(t, axis_name=axis)
            res[f"axis_{axis}"] = t.tolist()
        res["ppermute"] = dist.ppermute(
            torch.full((2,), float(rank)), [(0, 1), (1, 0)], "mp").tolist()
        res["ppermute_partial"] = dist.ppermute(
            torch.full((2,), float(rank)), [(0, 1)], "dp").tolist()
    (Path(out) / f"coll{rank}.json").write_text(json.dumps(res))


def _build_gang(tmp):
    run_gang(_collectives, WORLD, tmp, str(tmp))
    return [json.loads((tmp / f"coll{r}.json").read_text())
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    return once_per_session(tmp_path_factory, "collective_gang",
                            _build_gang)


X = np.stack([_x(r).numpy() for r in range(WORLD)])       # (4, 8, 2)


@pytest.mark.parametrize("op,fn", [
    ("sum", np.sum), ("max", np.max), ("min", np.min), ("avg", np.mean),
    ("prod", np.prod)])
def test_all_reduce_matches_numpy(gang, op, fn):
    want = fn(X[:, :2] / 100 + 1, axis=0)
    for r in range(WORLD):
        np.testing.assert_allclose(gang[r][f"all_reduce_{op}"], want,
                                   rtol=1e-6)


def test_gathers_and_reduce_scatter_match_numpy(gang):
    for r in range(WORLD):
        np.testing.assert_array_equal(gang[r]["all_gather"], X)
        np.testing.assert_array_equal(gang[r]["all_gather_tiled"],
                                      X.reshape(32, 2))
        np.testing.assert_array_equal(gang[r]["all_gather_list"], X[:, 0])
        total = X.sum(0)
        np.testing.assert_array_equal(gang[r]["reduce_scatter"],
                                      total[2 * r:2 * r + 2])
        np.testing.assert_array_equal(gang[r]["reduce_scatter_dim1"],
                                      total.T[:, 2 * r:2 * r + 2])
        assert gang[r]["all_gather_object"] == [{"rank": i}
                                                for i in range(WORLD)]


def test_rooted_and_point_to_point_match_numpy(gang):
    for r in range(WORLD):
        np.testing.assert_array_equal(gang[r]["broadcast"], X[2])
        np.testing.assert_array_equal(gang[r]["scatter"], [10 * r + 3] * 2)
        np.testing.assert_array_equal(gang[r]["alltoall_list"],
                                      [[10 * j + r] * 3 for j in range(4)])
    np.testing.assert_array_equal(gang[1]["reduce"], X.sum(0))
    assert gang[3]["send_recv"] == [7.0, 7.0]


def test_groups_and_mesh_axes(gang):
    """Mesh [2, 2] ("dp", "mp"): rank = 2 dp + mp, the reference's
    coordinate order; an axis reduces over its slice."""
    for r in range(WORLD):
        dp, mp = divmod(r, 2)
        assert gang[r]["mesh_coord"] == [dp, mp]
        assert gang[r]["axis_mp"] == [float(2 * dp + 2 * dp + 1)] * 2
        assert gang[r]["axis_dp"] == [float(mp + mp + 2)] * 2
        assert gang[r]["subgroup"] == ([4.0] * 2 if r in (1, 3)
                                       else [float(r)] * 2)
        assert gang[r]["ppermute"] == [float(2 * dp + (1 - mp))] * 2
        # only dp 0 -> dp 1 is sent: dp 0 receives nothing (zeros)
        assert gang[r]["ppermute_partial"] == (
            [float(mp)] * 2 if dp == 1 else [0.0, 0.0])


def test_collectives_match_jax_shard_map(gang):
    """The reference's traced collectives on its CPU mesh at the same
    inputs: psum, all_gather (tiled), psum_scatter and all_to_all."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    import paddle_tpu.distributed as jdist
    from paddle_tpu.distributed import build_mesh

    mesh = build_mesh([WORLD], ["mp"], devices=jax.devices()[:WORLD])
    xs = jnp.asarray(X.reshape(WORLD * 8, 2))

    def run(body, out_specs=P("mp")):
        return np.asarray(shard_map(body, mesh=mesh, in_specs=P("mp"),
                                    out_specs=out_specs, check_vma=False)(xs))

    summed = run(lambda v: jdist.all_reduce(v, axis_name="mp"))
    gathered = run(lambda v: jdist.all_gather(v, axis_name="mp", tiled=True),
                   P())
    scattered = run(lambda v: jdist.reduce_scatter(v, axis_name="mp"))
    a2a = run(lambda v: jdist.alltoall(v, axis_name="mp", split_axis=0,
                                       concat_axis=1))
    for r in range(WORLD):
        np.testing.assert_array_equal(gang[r]["all_reduce_x"],
                                      summed[8 * r:8 * r + 8])
        np.testing.assert_array_equal(gang[r]["all_gather_tiled"], gathered)
        np.testing.assert_array_equal(gang[r]["reduce_scatter"],
                                      scattered[2 * r:2 * r + 2])
        np.testing.assert_array_equal(gang[r]["alltoall"],
                                      a2a[2 * r:2 * r + 2])
    np.testing.assert_array_equal(summed[:8], X.sum(0))


def test_launch_runs_a_two_rank_gang(tmp_path):
    """``python -m paddle_tpu_torch.distributed.launch --nproc_per_node
    2`` writes each worker's environment and log; the workers join over
    gloo and all-reduce. The gang meets at a ``file://`` store named by
    ``--master``: a free TCP port picked and then released could be
    taken by another test process's gang before rank 0 binds it."""
    script = tmp_path / "job.py"
    script.write_text(
        "import sys, torch\n"
        "import paddle_tpu_torch.distributed as dist\n"
        "env = dist.init_parallel_env(backend='gloo', timeout=60)\n"
        "t = torch.tensor([float(env.rank + 1)])\n"
        "dist.all_reduce(t)\n"
        "open(sys.argv[1] + f'/out{env.rank}', 'w').write("
        "f'{env.rank} {env.world_size} {env.local_rank} {t.item()}')\n")
    logs = tmp_path / "logs"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--log_dir", str(logs),
         "--master", f"file://{tmp_path / 'store'}", str(script),
         str(tmp_path)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=GANG_TIMEOUT_S)
    assert res.returncode == 0, res.stdout + res.stderr + "".join(
        p.read_text() for p in sorted(logs.glob("workerlog.*")))
    assert sorted(p.name for p in logs.iterdir()) == ["workerlog.0",
                                                      "workerlog.1"]
    for r in range(2):
        assert (tmp_path / f"out{r}").read_text() == f"{r} 2 {r} 3.0"


def _spawned(out):
    """A rank started by ``spawn``: the gloo shims and one all-reduce."""
    import os

    import paddle_tpu_torch.distributed as dist

    env = dist.ParallelEnv()
    dist.gloo_init_parallel_env(env.rank, env.world_size,
                                os.environ["PADDLE_MASTER"])
    t = torch.tensor([float(env.rank + 1)])
    dist.all_reduce(t)
    dist.gloo_barrier()
    (Path(out) / f"spawn{env.rank}").write_text(
        f"{env.rank} {env.world_size} {t.item()}")
    dist.gloo_release()


def test_spawn_and_the_gloo_shims(tmp_path):
    """``spawn`` writes each process's trainer environment; the gloo
    shims join, wait and leave."""
    from paddle_tpu_torch.distributed import spawn

    procs = spawn(_spawned, args=(str(tmp_path),), nprocs=2, join=False,
                  master=f"file://{tmp_path}/store")
    for p in procs:
        p.join(GANG_TIMEOUT_S)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    assert not hung and [p.exitcode for p in procs] == [0, 0]
    for r in range(2):
        assert (tmp_path / f"spawn{r}").read_text() == f"{r} 2 3.0"


def test_once_per_session_fails_at_once_when_the_builder_died(
        tmp_path_factory, monkeypatch):
    """A waiter reads the builder's pid from the lock and stops waiting
    when that process is gone without a result."""
    import time

    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    name = f"dead_builder_{os.getpid()}"
    lock = tmp_path_factory.getbasetemp().parent / f"{name}.lock"
    lock.write_text(str(dead.pid))
    monkeypatch.setenv("PYTEST_XDIST_WORKER", "gw0")
    t0 = time.monotonic()
    try:
        with pytest.raises(AssertionError, match="died"):
            once_per_session(tmp_path_factory, name, lambda work: 0)
    finally:
        lock.unlink()
    assert time.monotonic() - t0 < 5
