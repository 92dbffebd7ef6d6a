"""The incubate API's tail — the port of ``paddle_tpu/incubate/extras.py``:
the LookAhead and ModelAverage optimizer wrappers, the fused softmax-mask
ops, the segment reductions, graph message passing and the graph
samplers.

The tensor ops take torch tensors (ids may also be numpy arrays) and
run where their data lives; each reads its id range back once to size
its output, as the reference does (it needs concrete ids). Empty segments
and isolated nodes read 0 under max and min, not the reduction's
identity. ``graph_reindex`` and the samplers work on the host in numpy,
as the reference does, and return int64 tensors on the device of their
first tensor input, else on the default place (the card unless
``set_device("cpu")`` named the CPU). The reference samples from
an unseeded ``np.random.RandomState()``; the port's samplers take a
keyword-only ``seed`` and draw from ``np.random.RandomState(seed)``
(unseeded when it is None).
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.amp.auto_cast import maybe_cast_inputs
from paddle_tpu_torch.core.place import resolve_device

__all__ = ["LookAhead", "ModelAverage", "softmax_mask_fuse",
           "softmax_mask_fuse_upper_triangle", "segment_sum",
           "segment_mean", "segment_max", "segment_min",
           "graph_send_recv", "graph_reindex", "graph_sample_neighbors",
           "graph_khop_sampler"]


# -- optimizer wrappers ------------------------------------------------------


class LookAhead:
    """k fast steps of the inner optimizer, then the slow weights move
    ``alpha`` of the way toward the fast ones and the fast weights take
    them (reference ``incubate/optimizer/lookahead.py``)."""

    def __init__(self, inner_optimizer, alpha: float = 0.5, k: int = 5,
                 name=None):
        self._inner = inner_optimizer
        self.alpha = float(alpha)
        self.k = max(int(k), 1)
        self._step_count = 0
        self._slow = None

    def __getattr__(self, name):
        return getattr(self._inner, name)

    @property
    def inner_opt(self):
        return self._inner

    def _params(self):
        return [p for p in self._inner._parameter_list if p.requires_grad]

    @torch.no_grad()
    def step(self):
        if self._slow is None:
            self._slow = [p.detach().clone() for p in self._params()]
        self._inner.step()
        self._step_count += 1
        if self._step_count % self.k == 0:
            for slow, p in zip(self._slow, self._params()):
                p.copy_(slow + self.alpha * (p - slow))
            self._slow = [p.detach().clone() for p in self._params()]

    def clear_grad(self):
        self._inner.clear_grad()

    def minimize(self, loss):
        loss.backward()
        self.step()
        self.clear_grad()


class ModelAverage:
    """Running sum of the parameters over a window, swapped in by
    ``apply()`` and back out by ``restore()`` (reference
    ``incubate/optimizer/modelaverage.py``, condensed as the reference
    condenses it)."""

    def __init__(self, average_window_rate: float, parameters=None,
                 min_average_window: int = 10000,
                 max_average_window: int = 10000, name=None):
        self._parameter_list = list(parameters or [])
        self.rate = average_window_rate
        self.min_window = min_average_window
        self.max_window = max_average_window
        self._sums = [torch.zeros_like(p, requires_grad=False)
                      for p in self._parameter_list]
        self._count = 0
        self._backup = None

    @torch.no_grad()
    def step(self):
        """Accumulate the current parameter values (after the inner
        optimizer's step)."""
        window = max(min(int(self._count * self.rate) + 1,
                         self.max_window), 1)
        if self._count >= window and self._count >= self.min_window:
            self._sums = [torch.zeros_like(s) for s in self._sums]
            self._count = 0
        self._sums = [s + p for s, p in zip(self._sums, self._parameter_list)]
        self._count += 1

    @torch.no_grad()
    def apply(self, executor=None, need_restore: bool = True):
        """Swap the averaged parameters in (``need_restore=False`` makes
        them permanent: ``restore`` is then a no-op)."""
        if self._count == 0:
            return
        self._backup = [p.detach().clone() for p in self._parameter_list] \
            if need_restore else None
        for p, s in zip(self._parameter_list, self._sums):
            p.copy_(s / self._count)

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is None:
            return
        for p, b in zip(self._parameter_list, self._backup):
            p.copy_(b)
        self._backup = None


# -- fused softmax-mask ------------------------------------------------------


def softmax_mask_fuse(x, mask, name=None):
    """``softmax(x + mask)`` over the last axis."""
    x, mask = maybe_cast_inputs("softmax_mask_fuse", (x, mask))
    return torch.softmax(x + mask, dim=-1)


def softmax_mask_fuse_upper_triangle(x):
    """Softmax over the last axis with the causal pattern: entries above
    the diagonal take -1e9 first."""
    x = maybe_cast_inputs("softmax_mask_fuse_upper_triangle", (x,))[0]
    causal = torch.ones((x.shape[-2], x.shape[-1]), dtype=torch.bool,
                        device=x.device).tril()
    return torch.softmax(torch.where(causal, x, -1e9), dim=-1)


# -- segment reductions ------------------------------------------------------


def _ids(ids, device):
    return torch.as_tensor(ids, device=device).long()


def _reduce(msgs, dst, n: int, how: str):
    """``msgs`` reduced into ``n`` rows by ``dst``: "sum", "mean", or
    "amax"/"amin" with empty rows 0."""
    out = msgs.new_zeros((n,) + tuple(msgs.shape[1:]))
    if how in ("sum", "mean"):
        out = out.index_add(0, dst, msgs)
        if how == "sum":
            return out
        cnt = msgs.new_zeros((n,)).index_add(
            0, dst, msgs.new_ones((msgs.shape[0],)))
        return out / cnt.clamp(min=1.0).reshape((-1,) + (1,) * (
            msgs.dim() - 1))
    index = dst.reshape((-1,) + (1,) * (msgs.dim() - 1)).expand_as(msgs)
    # include_self=False over zeros: a row nothing reaches stays 0
    return out.scatter_reduce(0, index, msgs, how, include_self=False)


def _segment(op_name, how):
    def fn(data, segment_ids, name=None):
        (data,) = maybe_cast_inputs(op_name, (data,))
        ids = _ids(segment_ids, data.device)
        return _reduce(data, ids, int(ids.max()) + 1, how)

    fn.__name__ = op_name
    return fn


segment_sum = _segment("segment_sum", "sum")
segment_max = _segment("segment_max", "amax")
segment_min = _segment("segment_min", "amin")


def segment_mean(data, segment_ids, name=None):
    (data,) = maybe_cast_inputs("segment_mean", (data,))
    ids = _ids(segment_ids, data.device)
    return _reduce(data, ids, int(ids.max()) + 1, "mean")


# -- graph ops ---------------------------------------------------------------


def graph_send_recv(x, src_index, dst_index, pool_type: str = "sum",
                    out_size=None, name=None):
    """Message passing: gather ``x[src]``, reduce into the ``dst`` rows
    (reference ``incubate/operators/graph_send_recv.py``)."""
    pool_type = pool_type.lower()
    if pool_type not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unsupported pool_type {pool_type!r}")
    (x,) = maybe_cast_inputs("graph_send_recv", (x,))
    n = int(out_size) if out_size else x.shape[0]
    msgs = x.index_select(0, _ids(src_index, x.device))
    how = {"max": "amax", "min": "amin"}.get(pool_type, pool_type)
    return _reduce(msgs, _ids(dst_index, x.device), n, how)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _device_of(*xs):
    """The first tensor argument's device, else the default place (the
    card unless ``set_device("cpu")`` named the CPU)."""
    for a in xs:
        if isinstance(a, torch.Tensor):
            return a.device
    return resolve_device(None)


def _out(arr, device):
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def graph_reindex(x, neighbors, count, value_buffer=None, index_buffer=None,
                  flag_buffer_hashtable: bool = False, name=None):
    """Reindex a sampled subgraph to contiguous local ids (reference
    ``incubate/operators/graph_reindex.py``): (reindexed neighbors, each
    center's local id repeated ``count`` times, the nodes in local-id
    order)."""
    dev = _device_of(x, neighbors, count)
    x_np, nb, cnt = _host(x), _host(neighbors), _host(count)
    order = {int(v): i for i, v in enumerate(x_np.tolist())}
    out_nodes = list(x_np.tolist())
    reindexed = np.empty_like(nb)
    for i, v in enumerate(nb.tolist()):
        if int(v) not in order:
            order[int(v)] = len(out_nodes)
            out_nodes.append(int(v))
        reindexed[i] = order[int(v)]
    src = np.repeat(np.arange(len(x_np)), cnt)
    return (_out(reindexed, dev), _out(src, dev),
            _out(np.asarray(out_nodes, x_np.dtype), dev))


def _sample(row_np, colptr_np, nodes, sample_size: int, rs):
    """Per node: the CSC positions kept (all, or ``sample_size`` drawn
    without replacement from ``rs``)."""
    out = []
    for nid in nodes.tolist():
        beg, end = int(colptr_np[nid]), int(colptr_np[nid + 1])
        pos = np.arange(beg, end)
        if sample_size > 0 and len(pos) > sample_size:
            pos = rs.choice(pos, size=sample_size, replace=False)
        out.append(pos)
    return out


def graph_sample_neighbors(row, colptr, input_nodes, sample_size: int = -1,
                           eids=None, return_eids: bool = False,
                           perm_buffer=None, name=None, *, seed=None):
    """Uniform neighbor sampling over a CSC graph (reference
    ``incubate/operators/graph_sample_neighbors.py``): (neighbors,
    count a node[, edge ids]); ``sample_size <= 0`` keeps every
    neighbor."""
    dev = _device_of(row, colptr, input_nodes)
    row_np = _host(row)
    pos = _sample(row_np, _host(colptr), _host(input_nodes), sample_size,
                  np.random.RandomState(seed))
    nb = (np.concatenate([row_np[p] for p in pos]) if pos
          else np.zeros((0,), row_np.dtype))
    cnt = _out(np.asarray([len(p) for p in pos], np.int32), dev)
    if not return_eids:
        return _out(nb, dev), cnt
    pos_all = np.concatenate(pos) if pos else np.zeros((0,), np.int64)
    # an edge's id is its CSC position unless ``eids`` maps it
    sampled = _host(eids)[pos_all] if eids is not None else pos_all
    return _out(nb, dev), cnt, _out(sampled, dev)


def graph_khop_sampler(row, colptr, input_nodes, sample_sizes,
                       sorted_eids=None, return_eids: bool = False,
                       name=None, *, seed=None):
    """Multi-hop sampling and reindex (reference
    ``incubate/operators/graph_khop_sampler.py``): each hop samples the
    new nodes of the last, then the union is reindexed to local ids:
    (src, dst, nodes). Every hop draws from one
    ``np.random.RandomState(seed)``."""
    if return_eids:
        raise NotImplementedError(
            "graph_khop_sampler return_eids: sample per-hop with "
            "graph_sample_neighbors(..., return_eids=True) instead")
    dev = _device_of(row, colptr, input_nodes)
    row_np, colptr_np = _host(row), _host(colptr)
    frontier = _host(input_nodes)
    rs = np.random.RandomState(seed)
    seen = list(frontier.tolist())
    local = {int(v): i for i, v in enumerate(seen)}
    all_src, all_dst = [], []
    for size in sample_sizes:
        pos = _sample(row_np, colptr_np, frontier, size, rs)
        nb = (np.concatenate([row_np[p] for p in pos]) if pos
              else np.zeros((0,), row_np.dtype))
        all_src.append(nb)
        all_dst.append(np.repeat(frontier, [len(p) for p in pos]))
        nxt = []
        for v in nb.tolist():
            if int(v) not in local:
                local[int(v)] = len(seen)
                seen.append(int(v))
                nxt.append(int(v))
        frontier = np.asarray(nxt, dtype=frontier.dtype)
        if frontier.size == 0:
            break
    src = np.concatenate(all_src) if all_src else np.zeros((0,), np.int64)
    dst = np.concatenate(all_dst) if all_dst else np.zeros((0,), np.int64)
    return (_out(np.asarray([local[int(v)] for v in src.tolist()], np.int64),
                 dev),
            _out(np.asarray([local[int(v)] for v in dst.tolist()], np.int64),
                 dev),
            _out(np.asarray(seen, np.int64), dev))
