"""Heterogeneous stages on the 1F1B schedule, interleaved or not — the
port of ``paddle_tpu/distributed/pipeline_1f1b.py`` (:86-752).

Layout, kept exactly as the reference lays it out (checkpoints and the
CPU parity with the JAX package read it):

- stage 0 runs ``first`` (the embedding) then its body blocks, stage
  S-1 its body blocks then ``last`` (final norm, head) and the loss;
- the body is segmented uniformly when ``len(blocks)`` divides by
  ``W = S * V`` (``V = virtual_pipeline_degree``), else balanced by
  parameter count (:func:`_segment_by_param_count`); a short stage's
  chain is padded to the longest with block 0's values, and the padded
  slots are never run, so their gradients are zero (the optimizer still
  steps them: weight decay moves them, as in the reference);
- each body parameter is stacked to ``(W, ...)`` as ``stage__<name>``
  (dots as ``__``), slot ``j = s * V + v`` holding virtual stage
  ``v * S + s`` (``_virtual_order``), with ``dist_spec ("pp", *orig)``:
  ``ShardedTrainer`` hands pp rank ``s`` its ``V`` chunks;
- ``first`` and ``last`` ("extras") keep their own names and specs,
  replicated over ``pp``; a parameter both use (a tied embedding) is one
  parameter, stored once.

The schedule is the reference's tick table, driven by each rank's host
over ``torch.distributed`` (the reference compiles it into one
``lax.scan``). ``schedule_constants()`` gives ``W``, the circular
buffer's ``K = 2W - 1`` slots and the ``T = M V + S (V + 1) - 2``
ticks. On tick ``t`` rank ``s`` runs one forward sub-tick, the flat
index ``f = t - s`` decoded mixed-radix into (microbatch, chunk), and
one backward sub-tick, ``b = t - (W - 1) - (S - 1 - s)`` decoded in
reverse chunk order. Then activations go to ``s + 1`` (the ``S - 1 ->
0`` wrap carries interleaved chunks) and cotangents to ``s - 1``. A
rank sends on a tick only where its sub-tick ran and has a successor in
the chain, and receives only where its neighbour sends; both sides read
that off the same table, so no rank posts a receive its neighbour never
matches, and all ranks stay in lockstep.

The forward sub-tick runs without a graph and saves its boundary input
in slot ``t mod K``; the backward sub-tick recomputes its chunk from
that input under ``torch.enable_grad`` and back-propagates the received
cotangent (on the last virtual stage, the loss over ``M``), as the
reference's ``jax.vjp`` does. Only the ``2W - 1`` boundary activations
live across ticks, so activation memory is flat in ``M``. The loss
chunk (the last virtual stage, on rank S-1) sends nothing forward, so
its forward sub-tick only saves its input: the recompute gives the loss
value and its gradient in one pass (the reference runs that forward
because its SPMD switch runs in lockstep on every stage). Dropout draws
the same masks in a chunk's forward and its recompute: both run with the
device's default generator seeded by (step key, microbatch, virtual
stage), its state restored afterwards.

After the last tick the extras' gradients are summed over ``pp``
(embedding on stage 0, head on stage S-1, a tied weight on both: the
reference's final ``psum``, its stand-in for upstream Paddle's
``allreduce_shared_weight_gradients``), and the loss is summed over
``pp`` from the last stage, so every rank returns the mean over
microbatches.

Without a ``pp`` mesh, :meth:`loss_and_grads` runs the same
microbatches and chunk seeds in order with plain autograd (no
recompute), and ``forward`` runs first, every virtual stage in order and
last; with a ``pp`` mesh bound, ``forward`` first gathers the stacked
parameters over ``pp`` (for evaluation).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.amp.auto_cast import amp_state
from paddle_tpu_torch.distributed import collective as _coll
from paddle_tpu_torch.distributed import env as _env
from paddle_tpu_torch.distributed.pipeline import _exchange, _release
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.layers.container import LayerList

__all__ = ["Pipeline1F1B"]


class _BlockChain(Layer):
    """A stage's run of body blocks, applied in sequence; ``count`` (an
    int) runs only the first ``count`` (an uneven stage's real blocks)."""

    def __init__(self, blocks: Sequence[Layer]):
        super().__init__()
        self.layers = LayerList(list(blocks))

    def forward(self, x, count=None):
        blocks = list(self.layers)
        if count is not None:
            blocks = blocks[:int(count)]
        for blk in blocks:
            x = blk(x)
        return x


def _segment_by_param_count(blocks: Sequence[Layer], S: int) -> List[int]:
    """Contiguous partition of ``blocks`` into S runs minimising the
    largest run's parameter count (reference ``:117-171``); per-stage
    block counts."""
    sizes = [sum(p.numel() for _, p in b.named_parameters()) or 1
             for b in blocks]
    N = len(sizes)
    prefix = np.concatenate([[0], np.cumsum(sizes)])

    def feasible(cap):
        runs, start = [], 0
        for i in range(1, N + 1):
            if prefix[i] - prefix[start] > cap:
                if i - 1 == start:
                    return None
                runs.append(i - 1 - start)
                start = i - 1
        runs.append(N - start)
        if len(runs) > S:
            return None
        return runs + [0] * (S - len(runs))

    lo, hi = max(sizes), int(prefix[-1])
    best, cap = None, hi
    while lo <= hi:
        mid = (lo + hi) // 2
        c = feasible(mid)
        if c is not None:
            best, cap = c, mid
            hi = mid - 1
        else:
            lo = mid + 1
    assert best is not None
    # the even spread when it also meets the optimal cap
    base, rem = N // S, N % S
    spread = [base + (1 if s < rem else 0) for s in range(S)]
    bounds = np.concatenate([[0], np.cumsum(spread)])
    if all(prefix[bounds[s + 1]] - prefix[bounds[s]] <= cap
           for s in range(S)):
        best = spread
    if 0 in best:
        for s in range(S):
            if best[s] == 0:
                donor = max(range(S), key=lambda j: best[j])
                best[donor] -= 1
                best[s] += 1
    assert all(c >= 1 for c in best) and sum(best) == N
    return best


def _generator(device: torch.device):
    if device.type == "cuda":
        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        return torch.cuda.default_generators[idx]
    return torch.default_generator


@contextlib.contextmanager
def _chunk_rng(device: torch.device, seed: int):
    """The device's default generator seeded with ``seed`` for the
    duration, its state restored after."""
    gen = _generator(device)
    state = gen.get_state()
    gen.manual_seed(seed)
    try:
        yield
    finally:
        gen.set_state(state)


class Pipeline1F1B(Layer):
    """Heterogeneous-stage 1F1B pipeline module (``first``: the
    embedding stage's head-end, ``blocks``: the homogeneous body,
    ``last``: the head, ``loss_fn(output, labels)`` per microbatch on
    the last stage; see the module's notes)."""

    _is_1f1b = True

    def __init__(self, first: Layer, blocks: Sequence[Layer], last: Layer,
                 loss_fn: Callable, num_stages: int,
                 num_microbatches: int = 1,
                 virtual_pipeline_degree: int = 1):
        super().__init__()
        S = int(num_stages)
        V = int(virtual_pipeline_degree)
        if S < 1:
            raise ValueError("num_stages must be >= 1")
        if V < 1:
            raise ValueError("virtual_pipeline_degree must be >= 1")
        if V > 1 and int(num_microbatches) % S:
            raise ValueError(
                f"interleaved 1F1B needs num_microbatches "
                f"({num_microbatches}) divisible by num_stages ({S}): "
                "microbatches advance in pipeline-width groups")
        if len(blocks) < S * V:
            raise ValueError(
                f"len(blocks)={len(blocks)} < num_stages*virtual"
                f"_pipeline_degree={S * V}: every (virtual) stage needs "
                "at least one body block")
        self.num_stages = S
        self.virtual_pipeline_degree = V
        self.num_virtual_stages = S * V
        self.num_microbatches = int(num_microbatches)
        self.loss_fn = loss_fn
        self.first = first
        self.last = last
        object.__setattr__(self, "_mesh", None)
        self._steps = 0
        for part, name in ((first, "first"), (last, "last")):
            if dict(part.named_buffers()):
                raise NotImplementedError(
                    f"buffers inside the pipeline `{name}` stage are not "
                    "supported (BatchNorm-style state cannot thread "
                    "through the 1F1B schedule)")
        W = S * V
        if len(blocks) % W == 0:
            counts = [len(blocks) // W] * W
        else:
            counts = _segment_by_param_count(blocks, W)
        self._stage_counts: List[int] = counts
        k = max(counts)
        self._blocks_per_stage = k
        self._uneven = len(set(counts)) > 1
        if any(dict(b.named_buffers()) for b in blocks):
            raise NotImplementedError(
                "buffers inside pipeline body blocks are not supported")
        starts = np.concatenate([[0], np.cumsum(counts)]).tolist()
        stage_blocks = [list(blocks[starts[w]:starts[w + 1]])
                        for w in range(W)]
        # slot j = s*V + v holds virtual stage w = v*S + s
        self._virtual_order: List[int] = [
            (j % V) * S + (j // V) for j in range(W)]
        self._slot_of_virtual: List[int] = [
            (w % S) * V + (w // S) for w in range(W)]
        block_ref = dict(blocks[0].named_parameters())
        if self._uneven:
            for i, b in enumerate(blocks[1:], 1):
                t = dict(b.named_parameters())
                if list(t) != list(block_ref) or any(
                        t[n].shape != block_ref[n].shape
                        or t[n].dtype != block_ref[n].dtype
                        for n in block_ref):
                    raise ValueError(
                        f"uneven pipeline segmentation needs structurally "
                        f"identical body blocks; block {i} differs from "
                        f"block 0")
        trees = []
        for w, sb in enumerate(stage_blocks):
            t = dict(_BlockChain(sb).named_parameters())
            for j in range(counts[w], k):
                for n, p in block_ref.items():
                    t[f"layers.{j}.{n}"] = p
            trees.append(t)
        ref = trees[0]
        for s, t in enumerate(trees[1:], 1):
            if sorted(t) != sorted(ref) or any(
                    t[n].shape != ref[n].shape or t[n].dtype != ref[n].dtype
                    for n in ref):
                raise ValueError(
                    f"pipeline body blocks must be structurally identical "
                    f"across stages; stage {s} differs from stage 0")
        self._stack_names: List[str] = list(ref)
        self._stacked: Dict[str, torch.nn.Parameter] = {}
        self._stack_storage: Dict[str, str] = {}
        for name in self._stack_names:
            p = torch.nn.Parameter(
                torch.stack([trees[w][name].detach()
                             for w in self._virtual_order]),
                requires_grad=ref[name].requires_grad)
            orig = getattr(ref[name], "dist_spec", None)
            p.dist_spec = ("pp", *orig) if orig else ("pp",)
            for attr in ("optimize_attr", "regularizer", "need_clip"):
                if hasattr(ref[name], attr):
                    setattr(p, attr, getattr(ref[name], attr))
            safe = "stage__" + name.replace(".", "__")
            self.register_parameter(safe, p)
            self._stacked[name] = p
            self._stack_storage[name] = safe
        # the template runs any chunk's math with its values substituted
        # (its first k blocks give the structure); off the module tree
        template = _BlockChain(blocks[:k])
        object.__setattr__(self, "_template", template)
        _release(template)
        storage_by_id = {id(p): n for n, p in self.named_parameters()
                         if not n.startswith("stage__")}
        self._first_map = {ln: storage_by_id[id(p)]
                           for ln, p in first.named_parameters()}
        self._last_map = {ln: storage_by_id[id(p)]
                          for ln, p in last.named_parameters()}
        self._extra_names = sorted({*self._first_map.values(),
                                    *self._last_map.values()})

    # -- the mesh ---------------------------------------------------------
    def attach_mesh(self, mesh, data_axes: Tuple[str, ...] = ()):
        """Run the schedule over ``mesh``'s ``pp`` axis. ``data_axes``
        (the reference's sharding constraint on the microbatches) is
        accepted and not read: each rank already holds its slice."""
        object.__setattr__(self, "_mesh", mesh)
        pp = mesh.shape.get("pp", 1) if mesh is not None else 1
        if pp > 1 and pp != self.num_stages:
            raise ValueError(
                f"mesh 'pp' axis size {pp} != num_stages {self.num_stages}")

    def pipelined(self) -> bool:
        m = self._mesh
        return (m is not None and m.shape.get("pp", 1) > 1
                and self.num_stages > 1)

    def schedule_constants(self) -> Tuple[int, int, int]:
        """(W, K, T): virtual pipeline depth, circular-buffer slots and
        ticks (V = 1: K = 2S - 1, T = M + 2(S - 1))."""
        S, V, M = (self.num_stages, self.virtual_pipeline_degree,
                   self.num_microbatches)
        W = S * V
        return W, 2 * W - 1, M * V + S * (V + 1) - 2

    # -- stage application ------------------------------------------------
    def _apply_chain(self, block_params: Dict[str, torch.Tensor], x,
                     count=None):
        return torch.func.functional_call(
            self._template, block_params, (x,),
            {"count": count} if count is not None else {})

    def _chunk(self, stacked: Dict[str, torch.Tensor], j: int, w: int, x):
        """Virtual stage ``w``'s blocks (stacked slot ``j`` of
        ``stacked``) on ``x``."""
        return self._apply_chain(
            {n: v[j] for n, v in stacked.items()}, x,
            self._stage_counts[w] if self._uneven else None)

    def _loss(self, out, labels) -> torch.Tensor:
        return self.loss_fn(out, labels).float()

    def _seed(self, key: int, m: int, w: int) -> int:
        return ((key * 1000003 + m) * 1000033 + w) % (2 ** 63)

    def _key(self, key) -> int:
        if key is None:
            key = torch.initial_seed() * 7919 + self._steps
        self._steps += 1
        return int(key)

    def _full_stacked(self) -> Dict[str, torch.Tensor]:
        """The stacked parameters with every slot: this rank's window
        gathered over ``pp`` when the trainer cut them (no graph)."""
        W = self.num_virtual_stages
        out = {}
        for n, p in self._stacked.items():
            if p.shape[0] == W:
                out[n] = p
                continue
            mesh = _env._bound_mesh() or self._mesh
            with _env._mesh_scope(mesh):
                out[n] = _coll.all_gather(p.detach().contiguous(),
                                          axis_name="pp", tiled=True)
        return out

    # -- the step ---------------------------------------------------------
    def loss_and_grads(self, params, batch, key):
        """One step's mean loss over the microbatches, its gradients
        accumulated into the parameters' ``.grad`` (and returned by
        storage name). ``params`` must be None (the module's own
        parameters are used), ``batch`` is ``(inputs, labels)``, ``key``
        an int seeding the chunks' dropout (None: drawn from the step
        count). Pipelined over ``pp`` when an attached mesh has it above
        1 (``ShardedTrainer`` binds that mesh), else in order on this
        rank."""
        if params is not None:
            raise NotImplementedError(
                "Pipeline1F1B.loss_and_grads: the port steps the module's "
                "own parameters; pass params=None")
        xb, yb = batch
        M = self.num_microbatches
        if xb.shape[0] % M:
            raise ValueError(f"batch {xb.shape[0]} not divisible by "
                             f"num_microbatches {M}")
        key = self._key(key)
        if self.pipelined():
            loss = self._loss_and_grads_pipelined(xb.chunk(M), yb.chunk(M),
                                                  key)
        else:
            loss = self._loss_and_grads_sequential(xb.chunk(M), yb.chunk(M),
                                                   key)
        # every parameter steps, as the reference's gradient tree holds
        # them all: a slot this rank never ran (an uneven stage's
        # padding) takes a zero gradient, so weight decay still moves it
        grads = {}
        for n, p in self.named_parameters():
            if p.requires_grad:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads[n] = p.grad
        return loss, grads

    def _loss_and_grads_sequential(self, xs, ys, key):
        """Every microbatch through every virtual stage in order, with
        the chunk seeds of the pipelined run, by plain autograd."""
        M, W = self.num_microbatches, self.num_virtual_stages
        stacked = self._stacked
        dev = self._stacked[self._stack_names[0]].device
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for m in range(M):
            h = xs[m]
            for w in range(W):
                with _chunk_rng(dev, self._seed(key, m, w)):
                    if w == 0:
                        h = self.first(h)
                    h = self._chunk(stacked, self._slot_of_virtual[w], w, h)
                    if w == W - 1:
                        loss = self._loss(self.last(h), ys[m]) / M
            loss.backward()
            total += loss.detach()
        return total

    def _sends_fwd(self, r: int, t: int) -> bool:
        """Whether rank ``r`` sends an activation on tick ``t``."""
        S, V, M = (self.num_stages, self.virtual_pipeline_degree,
                   self.num_microbatches)
        f = t - r
        if not 0 <= f < M * V:
            return False
        v = (f % (S * V)) // S
        return not (r == S - 1 and v == V - 1)

    def _sends_bwd(self, r: int, t: int) -> bool:
        """Whether rank ``r`` sends a cotangent on tick ``t``."""
        S, V, M = (self.num_stages, self.virtual_pipeline_degree,
                   self.num_microbatches)
        W = S * V
        b = t - (W - 1) - (S - 1 - r)
        if not 0 <= b < M * V:
            return False
        v = (V - 1) - (b % W) // S
        return not (r == 0 and v == 0)

    def _loss_and_grads_pipelined(self, xs, ys, key):
        mesh = self._mesh
        S, V, M = (self.num_stages, self.virtual_pipeline_degree,
                   self.num_microbatches)
        W, K, T = self.schedule_constants()
        s = mesh.index("pp")
        nxt, prv = (s + 1) % S, (s - 1) % S
        stacked = self._stacked
        p0 = stacked[self._stack_names[0]]
        dev = p0.device
        # this rank's chunk v is local slot v once the trainer cut the
        # stacked dim over pp, slot s*V + v of an uncut parameter
        base = s * V if p0.shape[0] == W else 0
        like = self._activation_like(xs[0], dev)
        buf: List = [None] * K
        x_recv = g_recv = None
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        for t in range(T):
            y_send = dx_send = None
            # ---- forward sub-tick: microbatch m, chunk v, no graph ----
            # (the loss chunk sends nothing: its backward sub-tick's
            # recompute gives the loss, so its forward only keeps x_recv)
            f = t - s
            if 0 <= f < M * V:
                r = f % W
                v, m = r // S, (f // W) * S + r % S
                w = v * S + s
                if not (s == S - 1 and v == V - 1):
                    with torch.no_grad(), \
                            _chunk_rng(dev, self._seed(key, m, w)):
                        h = self.first(xs[m]) if s == 0 and v == 0 \
                            else x_recv
                        y_send = self._chunk(stacked, base + v, w,
                                             h).to(like.dtype)
                if not (s == 0 and v == 0):
                    buf[t % K] = x_recv
            # ---- backward sub-tick: the recompute, then its vjp -------
            b = t - (W - 1) - (S - 1 - s)
            if 0 <= b < M * V:
                r = b % W
                v, m = (V - 1) - r // S, (b // W) * S + r % S
                w = v * S + s
                slot = (t - (2 * (W - 1) - 2 * w)) % K
                first_chunk = s == 0 and v == 0
                with torch.enable_grad(), \
                        _chunk_rng(dev, self._seed(key, m, w)):
                    if first_chunk:
                        xin, h = None, self.first(xs[m])
                    else:
                        xin = h = buf[slot].requires_grad_(True)
                    y = self._chunk(stacked, base + v, w, h)
                    if s == S - 1 and v == V - 1:
                        loss = self._loss(self.last(y), ys[m])
                        (loss / M).backward()
                        loss_acc += loss.detach()
                    else:
                        torch.autograd.backward(y, g_recv.to(y.dtype))
                if not first_chunk:
                    dx_send = xin.grad.to(like.dtype)
                    buf[slot] = None
            # ---- rotate: activations s -> s+1, cotangents s -> s-1 ----
            sends, recvs = [], []
            if y_send is not None:
                sends.append((nxt, y_send, 0))
            if dx_send is not None:
                sends.append((prv, dx_send, 1))
            want_x = self._sends_fwd(prv, t)
            want_g = self._sends_bwd(nxt, t)
            if want_x:
                recvs.append((prv, like, 0))
            if want_g:
                recvs.append((nxt, like, 1))
            got = _exchange(mesh, "pp", sends, recvs) if sends or recvs \
                else []   # fill and drain ticks can exchange nothing
            x_recv = got.pop(0) if want_x else None
            g_recv = got.pop(0) if want_g else None
        with _env._mesh_scope(mesh):
            self._sum_extras_over_pp()
            _coll.all_reduce(loss_acc, axis_name="pp")
        return loss_acc / M

    def _activation_like(self, x, dev):
        """An empty tensor of a boundary activation's shape and dtype for
        microbatch ``x``: ``first`` run once on one row, under the AMP
        state in force, and kept for later steps of the same shape and
        state (every rank probes, so all agree on the dtype)."""
        st = amp_state()
        key = (tuple(x.shape), x.dtype, st.enabled, st.dtype, st.level,
               tuple(p.dtype for p in self.first.parameters()))
        if getattr(self, "_like", (None,))[0] != key:
            with torch.no_grad(), _chunk_rng(dev, 0):
                a = self.first(x[:1])
            self._like = (key, (a.shape[1:], a.dtype))
        shape, dtype = self._like[1]
        return torch.empty((x.shape[0], *shape), dtype=dtype, device=dev)

    def _sum_extras_over_pp(self):
        """Sum the extras' gradients over ``pp`` in one all-reduce (a
        rank that never used one contributes zeros)."""
        params = dict(self.named_parameters())
        ps = [params[n] for n in self._extra_names
              if params[n].requires_grad]
        if not ps:
            return
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1).float()
                          for p in ps])
        _coll.all_reduce(flat, axis_name="pp")
        off = 0
        for p in ps:
            n = p.numel()
            p.grad = flat[off:off + n].view_as(p).to(p.dtype)
            off += n

    # -- sequential forward (evaluation, generation, one process) --------
    def forward(self, x):
        """first, every virtual stage in order, last: the model's output
        (e.g. logits). Under a bound ``pp`` mesh the stacked parameters
        are gathered first."""
        stacked = self._full_stacked()
        h = self.first(x)
        for w in range(self.num_virtual_stages):
            h = self._chunk(stacked, self._slot_of_virtual[w], w, h)
        return self.last(h)

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """``PipelineParallel.train_batch`` (``pipeline_parallel.py:152``)
        on this module: the sequential forward, ``loss_fn``, backward and
        the optimizer's step."""
        x, label = data
        loss = self.loss_fn(self.forward(torch.as_tensor(x)),
                            torch.as_tensor(label))
        optimizer.clear_grad()
        if scaler is not None:
            scaler.scale(loss).backward()
            scaler.step(optimizer)
            scaler.update()
        else:
            loss.backward()
            optimizer.step()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss
