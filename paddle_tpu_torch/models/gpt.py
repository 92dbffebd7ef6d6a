"""GPT decoder-only language model — the port of ``models/gpt.py``.

Same architecture and parameter names as the JAX package: pre-LN
transformer blocks (``ln_1``, ``attn.qkv_proj``, ``attn.out_proj``,
``ln_2``, ``mlp.fc_in``, ``mlp.fc_out``), learned positions, tanh GELU,
and the LM head tied to the token embedding (``gpt.py:637``). Weights are
paddle's (in, out) layout, so ``set_state_dict`` copies a ``paddle_tpu``
model's arrays by name with no transposes.

A GPT-MoE config (``num_experts > 0``) puts a ``GPTMoEMLP`` in every
``moe_every_k``-th block: the experts stacked by ``incubate``'s
``MoELayer`` under the reference's names (``mlp.moe.htoh4__weight``,
...), the gate at ``mlp.moe.gate.gate``. A MoE block routes whatever
rows it is given, so every forward mode below serves it unchanged; its
capacity follows from the rows of the call (a prefill chunk's pad tail
and idle decode slots included, as in the reference).

Forward modes:

- no cache: causal attention over the whole sequence through
  ``F.scaled_dot_product_attention``, whose gate sends the shapes the
  JAX package sends to flash to the flash kernels (K1 forward, K3
  backward) and the rest to the plain attention. With ``labels`` the
  model returns the mean next-token loss through the fused chunked head
  and cross entropy (``F.linear_cross_entropy``, ``gpt.py:605-632``):
  the training path;
- the PAGED cache (``gpt.py:284-359``): per layer a ``(k_pool, v_pool,
  table, t)`` tuple — pools ``(num_blocks, block_size, H, D)``, an int32
  block table ``(b, blocks_per_slot)`` and the write offset ``t``, a
  0-dim tensor for single-slot chunk prefill or ``(b,)`` per-slot
  offsets for lockstep decode — or the QUANTIZED 7-tuple ``(k_pool,
  v_pool, k_scale, v_scale, table, t, cl)``: int8 code pools, fp32
  ``(num_blocks, H)`` absmax scales, and ``cl``, the count of real rows
  in this commit. New K/V rows commit into the pools IN PLACE (JAX
  donates the buffers instead; :func:`_upd_paged`, :func:`_upd_paged_q`),
  then attention reads back through the table: a query chunk (s > 1) at
  a scalar offset runs the chunk-prefill kernel K5, everything else the
  paged decode kernel K4 — the routing of ``gpt.py:350-357``;
- the DENSE static cache (``gpt.py:361-419``): per layer ``(k_buf,
  v_buf, t)`` — ``(b, max_len, H, D)`` buffers and the write offset
  ``t``, a 0-dim tensor for a chunk (row j lands at ``t + j``; rows
  past ``max_len`` are DROPPED, as the reference's ``mode="drop"``
  scatter drops them) or ``(b,)`` per-slot offsets for a step or a
  verify (each slot's rows land at ``min(t, max_len - s) + j``: the
  start clamp of ``dynamic_update_slice``, which only an idle slot's
  garbage ever reaches). New rows commit IN PLACE (:func:`_upd_dense`);
  then each query row reads ``cols <= t + j`` through the plain masked
  attention, as the reference runs it in XLA (no Pallas kernel there,
  so none here);
- the CONCAT cache (``gpt.py:420-423``): per layer ``(k, v)`` of the
  rows so far, extended by the new ones — ``generate(use_cache=True)``'s
  eager decode. Its causal attention goes through
  ``F.scaled_dot_product_attention``'s gate: a prompt's forward from an
  empty cache can take K1, a one-token step the plain attention.

:meth:`GPTForCausalLM.generate` is the model's own inference entry
(``gpt.py:679-940``): eager with or without the concat cache, or
(``jit=True``) the whole batch through a dense
:class:`~paddle_tpu_torch.inference.serving.DecodeEngine` kept on the
model, optionally speculative (``spec=``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from paddle_tpu_torch.amp.auto_cast import maybe_cast_inputs
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.core.random import LANE_DRAW, position_uniforms
from paddle_tpu_torch.core.random import generator as make_generator
from paddle_tpu_torch.distributed.fleet.utils import recompute
from paddle_tpu_torch.distributed.meta_parallel import (ColumnParallelLinear,
                                                        RowParallelLinear,
                                                        VocabParallelEmbedding)
from paddle_tpu_torch.distributed.meta_parallel.mp_layers import (
    MP_AXIS, ParallelCrossEntropy, _gather_last, _pg, axis_in_scope,
    mp_identity)
from paddle_tpu_torch.distributed.pipeline_1f1b import Pipeline1F1B
from paddle_tpu_torch.distributed.ring_attention import (
    _sep_position_offset, get_sep_sharded_scope)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.layers import Dropout, Embedding, LayerList, LayerNorm
from paddle_tpu_torch.ops.kernels.chunk_prefill import chunk_prefill
from paddle_tpu_torch.ops.kernels.paged_attention import paged_attention

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "GPTEmbeddingStage",
           "GPTHeadStage", "GPTForCausalLMPipe", "gpt_tiny",
           "gpt_tiny8", "gpt_moe_tiny", "gpt_moe_1p3b", "gpt2_small",
           "gpt3_1p3b", "gpt3_13b"]

_INT_DTYPES = (torch.int8, torch.uint8, torch.int16, torch.int32,
               torch.int64)


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None   # default 4*hidden
    max_position_embeddings: int = 1024
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    initializer_range: float = 0.02
    layer_norm_epsilon: float = 1e-5
    tie_word_embeddings: bool = True
    # per-block activation recompute: None | "full" (gpt.py:59-62): each
    # block rematerializes its forward in the backward
    recompute_granularity: Optional[str] = None
    # GPT-MoE (gpt.py:63-69): a MoE FFN every moe_every_k-th block
    num_experts: int = 0           # 0 = dense
    moe_top_k: int = 2
    moe_gate: str = "gshard"       # naive | gshard | switch
    moe_every_k: int = 2
    moe_aux_weight: float = 0.01   # load-balance loss coefficient
    moe_capacity_factor: Optional[float] = None  # None = the gate's

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    def num_params(self) -> int:
        """Parameter count of the tied DENSE model (``gpt.py:75``; a
        MoE config's experts and gates are not in it, as in the
        reference)."""
        h, l, v = self.hidden_size, self.num_layers, self.vocab_size
        return v * h + self.max_position_embeddings * h + l * (
            4 * h * h + 2 * h * self.ffn_size + 13 * h) + 2 * h


def _paged_write_rows(table, t, s: int, block_size: int):
    """Flat pool rows a commit of ``s`` new rows per slot lands on, as
    ``(dst, src)``: ``dst`` indexes the pool viewed as (num_blocks *
    block_size, H, D), ``src`` the new rows flattened (slot, step).

    Rows past the table's reach (the pad tail of a final short prefill
    chunk) are DROPPED, never clamped: torch has no ``mode="drop"``
    scatter, so they are masked out here (one host sync on CUDA). No
    sentinel index is used at all — ``-1`` would wrap to the last pool
    row (the JAX commit uses a past-the-end sentinel for that reason,
    ``gpt.py:86-89``). Computed once per forward: every layer shares the
    table and the offsets."""
    nb, bp = table.shape
    steps = torch.arange(s, device=table.device)
    pos = (t.reshape(-1, 1).long() + steps).expand(nb, s)
    blk = torch.gather(table.long(), 1, (pos // block_size).clamp(max=bp - 1))
    flat = blk * block_size + pos % block_size
    src = (pos < bp * block_size).reshape(-1).nonzero().squeeze(1)
    return flat.reshape(-1)[src], src


def _upd_paged(kp, vp, kn, vn, tbl, tv, rows=None):
    """Commit new K/V rows ``(b, s, H, D)`` into the pools through the
    block table, IN PLACE; rows past the table's reach are dropped
    (:func:`_paged_write_rows`). Counterpart of ``gpt.py:81``."""
    if rows is None:
        rows = _paged_write_rows(tbl, tv, kn.shape[1], kp.shape[1])
    dst, src = rows
    tail = tuple(kp.shape[2:])
    kp.view((-1,) + tail).index_copy_(
        0, dst, kn.reshape((-1,) + tail).index_select(0, src).to(kp.dtype))
    vp.view((-1,) + tail).index_copy_(
        0, dst, vn.reshape((-1,) + tail).index_select(0, src).to(vp.dtype))
    return kp, vp


class _QuantPlan:
    """Where a quantized commit of ``s`` new rows per slot lands — shared
    by every layer of one forward (they share the table and offsets),
    so the one host sync (the selection of touched blocks) happens once
    per forward. Mirrors the index arithmetic of ``_upd_paged_q``
    (``gpt.py:144-199``): a window of ``W = min(B, ceil((bs-1+s)/bs))``
    logical blocks per slot starting at the block of ``t``."""

    def __init__(self, table, t, cl, s: int, bs: int):
        nb, B = table.shape
        dev = table.device
        rows = B * bs
        W = min(B, (s + bs - 2) // bs + 1)
        self.nb, self.W, self.bs = nb, W, bs
        wrows = W * bs
        tvv = t.reshape(-1).long().expand(nb)
        pos = tvv[:, None] + torch.arange(s, device=dev)       # (nb, s)
        first = tvv // bs
        last = pos[:, -1].clamp(max=rows - 1) // bs
        wj = first[:, None] + torch.arange(W, device=dev)      # (nb, W)
        # physical blocks of the window; lanes past the table repeat its
        # last block, are never touched and are never written back
        self.wtbl = torch.gather(table.long(), 1, wj.clamp(max=B - 1))
        # window-local row of each new row; rows past the table's reach
        # go to an extra row past the window that is cut off, never to
        # the pool (the JAX commit drops them with a past-the-end index)
        lpos = torch.where(pos < rows, pos - (first * bs)[:, None],
                           torch.full_like(pos, wrows))
        self.new_idx = (torch.arange(nb, device=dev)[:, None] * (wrows + 1)
                        + lpos).reshape(-1)
        # absmax over rows below the REAL committed end t + cl only
        self.valid = ((first * bs)[:, None]
                      + torch.arange(wrows, device=dev)
                      < (tvv + cl)[:, None])[:, :, None, None]
        # blocks whose first row predates this write keep their scale as
        # a floor; the touched blocks are [first, last]
        self.keep = ((wj * bs) < tvv[:, None])[:, :, None]
        touched = wj <= last[:, None]
        self.touched = touched[:, :, None]
        self.sel = touched.reshape(-1).nonzero().squeeze(1)    # host sync
        self.dest = self.wtbl.reshape(-1).index_select(0, self.sel)


def _upd_paged_q(kp, vp, ksc, vsc, kn, vn, tbl, tv, cl, plan=None):
    """Quantized commit into int8 code pools and their ``(nblk, H)``
    absmax scales, IN PLACE — ``gpt.py:111`` as plain torch ops, with
    ``cl`` the commit's count of real rows (``plan``, the
    :class:`_QuantPlan` of ``tbl``/``tv``/``cl``, is shared by the
    layers of one forward). The W-block window is gathered and
    dequantized, the new fp rows land in it, the touched blocks are
    requantized and ONLY they are written back: untouched blocks
    (prefix-spliced shared ones included) are never rewritten. The
    scale discipline is the
    reference's: the absmax covers rows below ``t + cl`` only
    (multiplied by the mask, as ``gpt.py:190-193`` does, so a NaN in a
    stale row of the window still reaches the absmax); a block that
    predates the write keeps its scale as a floor; an all-zero block
    gets scale 1.0. ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    if plan is None:
        plan = _QuantPlan(tbl, tv, cl, kn.shape[1], kp.shape[1])
    nb, W, bs = plan.nb, plan.W, plan.bs
    tail = tuple(kp.shape[2:])
    for pool, sc, new in ((kp, ksc, kn), (vp, vsc, vn)):
        code = pool[plan.wtbl]                        # (nb, W, bs, H, D)
        old = sc[plan.wtbl]                           # (nb, W, H)
        view = torch.empty((nb, W * bs + 1) + tail, dtype=torch.float32,
                           device=pool.device)
        view[:, :W * bs] = (code.float() * old[:, :, None, :, None]
                            ).reshape((nb, W * bs) + tail)
        view.view((-1,) + tail).index_copy_(
            0, plan.new_idx, new.reshape((-1,) + tail).float())
        view = view[:, :W * bs]
        amax = (view.abs() * plan.valid).reshape(
            (nb, W, bs) + tail).amax(dim=(2, 4))      # (nb, W, H)
        scale = torch.maximum(torch.where(plan.keep, old, 0.0),
                              amax / 127.0)
        scale = torch.where(scale > 0, scale, 1.0)
        scale = torch.where(plan.touched, scale, old)
        q = torch.round(view.reshape((nb, W, bs) + tail)
                        / scale[:, :, None, :, None]).clamp(-127, 127)
        pool.index_copy_(0, plan.dest, q.to(torch.int8).reshape(
            (nb * W, bs) + tail).index_select(0, plan.sel))
        sc.index_copy_(0, plan.dest,
                       scale.reshape(nb * W, -1).index_select(0, plan.sel))
    return kp, vp, ksc, vsc


class _DensePlan:
    """Where a dense commit of ``s`` new rows per slot lands and what each
    query row may read — shared by every layer of one forward (they
    share the offsets and the buffers' geometry).

    ``dst`` indexes the buffer viewed as (b * max_len, H, D), ``src`` the
    new rows flattened (slot, step), None when every row lands. A scalar
    ``t`` (a chunk) writes row j at ``t + j`` and drops rows past
    ``max_len`` (one host sync, as the paged commit's); a ``(b,)`` ``t``
    writes slot i's rows at ``min(t[i], max_len - s) + j``, never
    dropping (``dynamic_update_slice``'s clamp, ``gpt.py:388-395``).
    ``mask`` is ``cols <= t + j`` over the buffer's ``max_len`` columns
    (``gpt.py:401-418``), with the UNclamped ``t``."""

    def __init__(self, t, b: int, s: int, max_len: int):
        dev = t.device
        steps = torch.arange(s, device=dev)
        cols = torch.arange(max_len, device=dev)[None, None, None, :]
        base = torch.arange(b, device=dev)[:, None] * max_len
        if t.dim() == 0:
            pos = (t.long() + steps).expand(b, s)
            keep = (pos < max_len).reshape(-1)
            self.src = keep.nonzero().squeeze(1)              # host sync
            self.dst = (base + pos).reshape(-1).index_select(0, self.src)
            self.mask = cols <= (t + steps)[None, None, :, None]
        else:
            start = t.long().reshape(-1, 1).clamp(max=max_len - s)
            self.src = None
            self.dst = (base + start + steps).reshape(-1)
            self.mask = cols <= (t.reshape(-1, 1, 1, 1)
                                 + steps[None, None, :, None])


def _upd_dense(kb, vb, kn, vn, plan: _DensePlan):
    """Commit new K/V rows ``(b, s, H, D)`` into the dense ``(b, max_len,
    H, D)`` buffers IN PLACE, where ``plan`` says (JAX returns new
    buffers instead; ``gpt.py:370-397``)."""
    tail = tuple(kb.shape[2:])
    for buf, new in ((kb, kn), (vb, vn)):
        rows = new.reshape((-1,) + tail)
        if plan.src is not None:
            rows = rows.index_select(0, plan.src)
        buf.view((-1,) + tail).index_copy_(0, plan.dst, rows.to(buf.dtype))
    return kb, vb


def _lora_delta(x, ab, ids):
    """Per-slot low-rank delta ``x @ A[id] @ B[id]`` (``gpt.py:227-247``,
    multi-LoRA serving): ``ab`` is ONE layer's stacked pools ``(A
    (num_slots, din, r), B (num_slots, r, dout))`` and ``ids`` the (b,)
    per-slot adapter ids, a device tensor. Slot 0 is the all-zero
    identity row, so an adapter-less row adds an exact zero. A gather
    and two batched matmuls, never the densified (din, dout) delta; the
    gathered factors take the activation's dtype, as the reference casts
    them."""
    a, b_ = ab
    ids = ids.long()
    ag = a.index_select(0, ids).to(x.dtype)          # (b, din, r)
    bg = b_.index_select(0, ids).to(x.dtype)         # (b, r, dout)
    return torch.bmm(torch.bmm(x, ag), bg)


def _cache_plan(c0, s: int):
    """The commit plan of one forward over caches whose first layer's
    tuple is ``c0``: the quantized, paged or dense plan, or None for the
    concat cache (nothing to plan)."""
    if len(c0) == 7:
        return _QuantPlan(c0[4], c0[5], c0[6], s, c0[0].shape[1])
    if len(c0) == 4:
        return _paged_write_rows(c0[2], c0[3], s, c0[0].shape[1])
    if len(c0) == 3:
        return _DensePlan(c0[2], c0[0].shape[0], s, c0[0].shape[1])
    return None


class GPTAttention(Layer):
    def __init__(self, config: GPTConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_heads
        self.head_dim = h // config.num_heads
        self.qkv_proj = ColumnParallelLinear(h, 3 * h, device=device,
                                             dtype=dtype)
        self.out_proj = RowParallelLinear(h, h, device=device, dtype=dtype)
        self.attn_dropout_p = config.attention_dropout
        self.resid_dropout = Dropout(config.hidden_dropout)

    def forward(self, x, cache=None, lora=None, *, write_rows=None):
        """``write_rows``: the commit's plan, shared by the layers of one
        forward (:func:`_paged_write_rows` / :class:`_QuantPlan` /
        :class:`_DensePlan`; computed here when None). ``lora`` is this
        layer's ``{"ids": (b,), "qkv": (A, B), "out": (A, B), ...}``
        adapter slice (:func:`_lora_delta`)."""
        b, s = x.shape[0], x.shape[1]
        if axis_in_scope(self.qkv_proj._axis) and \
                self.num_heads % _pg(self.qkv_proj._axis)[1]:
            raise ValueError(
                f"{self.num_heads} heads do not split over "
                f"{_pg(self.qkv_proj._axis)[1]} tensor-parallel ranks")
        qkv = self.qkv_proj(x)
        if lora is not None and lora.get("qkv") is not None:
            # delta BEFORE the head split, so an adapted K/V lands in
            # the cache exactly as a merged-weights model writes it
            qkv = qkv + _lora_delta(x, lora["qkv"], lora["ids"])
        # the split is PER HEAD (gpt.py:276-277): each head's 3*D slice
        # holds its q, k, v — not three hidden-wide thirds
        # (under tensor parallelism the column shard holds whole heads:
        # this rank's num_heads / mp of them)
        qkv = qkv.reshape(b, s, -1, 3 * self.head_dim)
        q, k, v = qkv.split(self.head_dim, dim=-1)
        mask, causal, out = None, True, None
        if cache is not None and len(cache) not in (2, 3, 4, 7):
            raise ValueError(
                f"a cache is (k, v), (k_buf, v_buf, t), (k_pool, v_pool, "
                f"table, t) or (k_pool, v_pool, k_scale, v_scale, table, "
                f"t, cl); got a {len(cache)}-tuple")
        if cache is not None and len(cache) == 3:
            k_buf, v_buf, t = cache
            plan = write_rows if write_rows is not None \
                else _DensePlan(t, b, s, k_buf.shape[1])
            _upd_dense(k_buf, v_buf, k, v, plan)
            k, v, mask, causal = k_buf, v_buf, plan.mask, False
            cache = (k_buf, v_buf, t + s)
        elif cache is not None and len(cache) == 2:
            k = torch.cat([cache[0], k.to(cache[0].dtype)], dim=1)
            v = torch.cat([cache[1], v.to(cache[1].dtype)], dim=1)
            cache = (k, v)
        elif cache is not None:
            quantized = len(cache) == 7
            if quantized:
                k_pool, v_pool, k_sc, v_sc, table, t, cl = cache
                _upd_paged_q(k_pool, v_pool, k_sc, v_sc, k, v, table, t, cl,
                             plan=write_rows)
            else:
                k_pool, v_pool, table, t = cache
                k_sc = v_sc = None
                _upd_paged(k_pool, v_pool, k, v, table, t, rows=write_rows)
            q = q.contiguous()
            attend = chunk_prefill if s > 1 and t.dim() == 0 \
                else paged_attention
            out = attend(q, k_pool, v_pool, table, t, k_scale=k_sc,
                         v_scale=v_sc)
            cache = (k_pool, v_pool, k_sc, v_sc, table, t + s, cl) \
                if quantized else (k_pool, v_pool, table, t + s)
        if out is None:
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal,
                dropout_p=self.attn_dropout_p, training=self.training)
        out = out.reshape(b, s, -1)
        proj = self.out_proj(out)
        if lora is not None and lora.get("out") is not None:
            proj = proj + _lora_delta(out, lora["out"], lora["ids"])
        out = self.resid_dropout(proj)
        return out if cache is None else (out, cache)


class GPTMLP(Layer):
    def __init__(self, config: GPTConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        h, ffn = config.hidden_size, config.ffn_size
        self.fc_in = ColumnParallelLinear(h, ffn, device=device, dtype=dtype)
        self.fc_out = RowParallelLinear(ffn, h, device=device, dtype=dtype)
        self.dropout = Dropout(config.hidden_dropout)

    def forward(self, x, lora=None):
        h = self.fc_in(x)
        if lora is not None and lora.get("fc_in") is not None:
            h = h + _lora_delta(x, lora["fc_in"], lora["ids"])
        h = F.gelu(h, approximate=True)
        out = self.fc_out(h)
        if lora is not None and lora.get("fc_out") is not None:
            out = out + _lora_delta(h, lora["fc_out"], lora["ids"])
        return self.dropout(out)


class GPTMoEMLP(Layer):
    """The MoE FFN block (``gpt.py:462``): ``num_experts`` routed
    ``ExpertLayer``s stacked by ``MoELayer`` (bmm over the (E, C, d)
    buffers), the gate of ``moe_gate`` at ``moe_top_k``."""

    def __init__(self, config: GPTConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        from paddle_tpu_torch.incubate.distributed.models.moe import (
            ExpertLayer, MoELayer)
        from paddle_tpu_torch.nn import initializer as I

        h = config.hidden_size
        std = config.initializer_range
        experts = [ExpertLayer(
            h, config.ffn_size, weight_attr=I.Normal(0.0, std),
            out_weight_attr=I.Normal(
                0.0, std / math.sqrt(2 * config.num_layers)),
            device=device, dtype=dtype)
            for _ in range(config.num_experts)]
        gate_cfg = {"type": config.moe_gate, "top_k": config.moe_top_k}
        if config.moe_capacity_factor is not None:
            gate_cfg["capacity"] = config.moe_capacity_factor
        self.moe = MoELayer(d_model=h, experts=experts, gate=gate_cfg)
        self.dropout = Dropout(config.hidden_dropout)

    def forward(self, x):
        return self.dropout(self.moe(x))


class GPTBlock(Layer):
    def __init__(self, config: GPTConfig, use_moe: bool = False, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        eps = config.layer_norm_epsilon
        self.ln_1 = LayerNorm(config.hidden_size, epsilon=eps, device=device,
                              dtype=dtype)
        self.attn = GPTAttention(config, device=device, dtype=dtype)
        self.ln_2 = LayerNorm(config.hidden_size, epsilon=eps, device=device,
                              dtype=dtype)
        self.mlp = (GPTMoEMLP if use_moe else GPTMLP)(
            config, device=device, dtype=dtype)

    def forward(self, x, cache=None, lora=None, *, write_rows=None):
        if cache is None:
            x = x + self.attn(self.ln_1(x), lora=lora)
        else:
            a, cache = self.attn(self.ln_1(x), cache=cache, lora=lora,
                                 write_rows=write_rows)
            x = x + a
        h = self.ln_2(x)
        if isinstance(self.mlp, GPTMLP):
            x = x + self.mlp(h, lora=lora)
        else:
            # a MoE block carries no MLP adapter (the routed experts are
            # not one projection to perturb); attention deltas still
            # apply (gpt.py:505-511)
            x = x + self.mlp(h)
        return x if cache is None else (x, cache)


class GPTModel(Layer):
    def __init__(self, config: GPTConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.config = config
        self.wte = VocabParallelEmbedding(config.vocab_size,
                                          config.hidden_size, device=device,
                                          dtype=dtype)
        self.wpe = Embedding(config.max_position_embeddings,
                             config.hidden_size, device=device, dtype=dtype)
        self.drop = Dropout(config.hidden_dropout)
        # a MoE FFN in every moe_every_k-th block (gpt.py:527-529)
        self.h = LayerList([
            GPTBlock(config, use_moe=(
                config.num_experts > 0
                and i % config.moe_every_k == config.moe_every_k - 1),
                device=device, dtype=dtype)
            for i in range(config.num_layers)])
        self.ln_f = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_epsilon,
                              device=device, dtype=dtype)

    def forward(self, input_ids, position_ids=None, caches=None,
                adapters=None):
        """``adapters``: the multi-LoRA runtime arguments (``gpt.py:
        535-584``), ``{"ids": (b,) per-slot adapter ids, target: (A (L,
        N, din, r), B (L, N, r, dout))}`` (``inference/adapter_pool.
        py``); each block takes its layer's slice of the stacked
        pools."""
        b, s = input_ids.shape[0], input_ids.shape[1]
        steps = torch.arange(s, device=input_ids.device)
        if position_ids is None:
            if caches is None:
                # a sequence chunk (ring_attention.sep_sharded_scope)
                # starts at its global offset
                position_ids = steps + _sep_position_offset(s)
            elif len(caches[0]) == 2:
                # the concat cache: its rows so far (gpt.py:557-558)
                position_ids = caches[0][0].shape[1] + steps
            else:
                # a scalar start (chunk prefill) or (b,) per-slot
                # starts: the last of the dense 3 and the paged 4, the
                # 6th of the quantized 7 (whose last is cl: the
                # reference reads it there, gpt.py:549, a fault)
                t = caches[0][5] if len(caches[0]) == 7 else caches[0][-1]
                position_ids = t + steps if t.dim() == 0 \
                    else t.reshape(-1, 1) + steps
        # the pad tail of a final prefill chunk can run past the position
        # table; those rows are dropped at commit and their outputs
        # discarded, so clamping only keeps the lookup in range
        position_ids = position_ids.long().clamp(
            max=self.config.max_position_embeddings - 1)
        x = self.drop(self.wte(input_ids) + self.wpe(position_ids))
        loras = [self._layer_lora(adapters, i) for i in range(len(self.h))]
        if caches is None:
            # per-BLOCK remat (gpt.py:563-582): only while training with
            # no cache; each block's forward is replayed in the backward
            remat = (self.config.recompute_granularity == "full"
                     and self.training)
            for block, lora in zip(self.h, loras):
                x = recompute(block, x) if remat else block(x, lora=lora)
            return self.ln_f(x)
        rows = _cache_plan(caches[0], s)
        new_caches = []
        for block, cache, lora in zip(self.h, caches, loras):
            x, c = block(x, cache=cache, lora=lora, write_rows=rows)
            new_caches.append(c)
        return self.ln_f(x), new_caches

    @staticmethod
    def _layer_lora(adapters, i: int):
        """Layer ``i``'s slice of the stacked adapter pools (None
        without adapters)."""
        if adapters is None:
            return None
        lora = {"ids": adapters["ids"]}
        for key in ("qkv", "out", "fc_in", "fc_out"):
            ab = adapters.get(key)
            lora[key] = None if ab is None else (ab[0][i], ab[1][i])
        return lora


def _draw_weights(config: GPTConfig, gen, wte, wpe, blocks):
    """GPT's weights from ``gen``: normal(0, initializer_range), output
    projections scaled by 1/sqrt(2 * num_layers), in the order
    ``GPTForCausalLM`` and ``GPTForCausalLMPipe`` share, so one seed
    gives both the same weights."""
    std = config.initializer_range
    out_std = std / math.sqrt(2 * config.num_layers)
    with torch.no_grad():
        wte.weight.normal_(0.0, std, generator=gen)
        wpe.weight.normal_(0.0, std, generator=gen)
        for blk in blocks:
            blk.attn.qkv_proj.weight.normal_(0.0, std, generator=gen)
            blk.attn.out_proj.weight.normal_(0.0, out_std, generator=gen)
            if isinstance(blk.mlp, GPTMLP):
                blk.mlp.fc_in.weight.normal_(0.0, std, generator=gen)
                blk.mlp.fc_out.weight.normal_(0.0, out_std,
                                              generator=gen)
                continue
            # the stacked experts as GPTMoEMLP's initializers draw
            # them; the gate XavierUniform, its bias 0 (the
            # reference's Linear defaults)
            moe = blk.mlp.moe
            moe.htoh4__weight.normal_(0.0, std, generator=gen)
            moe.h4toh__weight.normal_(0.0, out_std, generator=gen)
            moe.htoh4__bias.zero_()
            moe.h4toh__bias.zero_()
            w = moe.gate.gate.weight
            lim = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
            w.uniform_(-lim, lim, generator=gen)
            moe.gate.gate.bias.zero_()


class GPTForCausalLM(Layer):
    """GPT with the tied LM head. ``device`` defaults to ``"cuda"``
    (raising on a host without a card — pass ``device="cpu"`` to opt
    in); weights are drawn from a generator seeded by ``seed``:
    normal(0, initializer_range), output projections scaled by
    1/sqrt(2 * num_layers), biases 0, LayerNorm 1/0 — the JAX package's
    initialisers, though not its random numbers."""

    def __init__(self, config: GPTConfig, *, device=None, seed: int = 0,
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        if not config.tie_word_embeddings:
            raise NotImplementedError(
                "the untied LM head is not ported; the GPT configs of the "
                "repo tie it to the token embedding")
        self.gpt = GPTModel(config, device=dev, dtype=dtype)
        self._init_weights(make_generator(seed, dev))

    def _init_weights(self, gen):
        _draw_weights(self.config, gen, self.gpt.wte, self.gpt.wpe,
                      self.gpt.h)

    def forward(self, input_ids, labels=None, position_ids=None,
                caches=None, adapters=None, output_hidden=False):
        """Logits, or ``(logits, new_caches)`` with ``caches``; with
        ``labels`` (integer ids of ``input_ids``' shape) the mean
        next-token loss instead, through the fused chunked head and
        cross entropy — the (N, vocab) logits never exist at once.
        ``adapters`` are the multi-LoRA arguments of
        :meth:`GPTModel.forward`; ``output_hidden=True`` also returns
        the final hidden states (after ``ln_f``, before the head):
        ``(logits, hidden)``, or ``(logits, hidden, new_caches)`` with
        ``caches`` (``gpt.py:639-648``)."""
        if labels is not None and (
                tuple(labels.shape) != tuple(input_ids.shape)
                or labels.dtype not in _INT_DTYPES):
            raise TypeError(
                "labels must be integer ids with input_ids' shape — got "
                f"shape {tuple(labels.shape)}; if you meant position_ids, "
                "pass it by keyword (forward(input_ids, labels=None, "
                "position_ids=None, caches=None))")
        out = self.gpt(input_ids, position_ids, caches, adapters=adapters)
        hidden = out if caches is None else out[0]
        axis = self.gpt.wte._axis
        parallel = axis_in_scope(axis)
        if labels is not None:
            sep = get_sep_sharded_scope()
            if sep is not None and caches is None:
                return self._sep_loss(hidden, labels, sep,
                                      axis if parallel else None)
            # under tensor parallelism wte is this rank's vocab rows: the
            # vocab-parallel online logsumexp (no gather of wte)
            return F.loss._linear_cross_entropy(
                hidden[:, :-1], self.gpt.wte.weight, labels[:, 1:],
                reduction="mean", w_vocab_major=True,
                axis=axis if parallel else None)
        # tied head: hidden @ wte^T, the white-listed op "matmul"
        h, w = maybe_cast_inputs("matmul", (hidden, self.gpt.wte.weight))
        if parallel:
            logits = _gather_last(torch.matmul(mp_identity(h, axis), w.t()),
                                  axis)
        else:
            logits = torch.matmul(h, w.t())
        if output_hidden:
            return (logits, hidden) if caches is None \
                else (logits, hidden, out[1])
        return logits if caches is None else (logits, out[1])

    def _sep_loss(self, hidden, labels, sep, axis):
        """The mean next-token loss of the WHOLE sequence when this rank
        holds one chunk of it (``sep_sharded_scope``): row ``j`` of chunk
        ``r`` predicts the label at global position ``r*S + j + 1`` (the
        next chunk's first label for the last row; the last chunk's last
        row predicts nothing), so the labels are gathered (ids only) and
        this rank's rows go through the fused head. The value is the
        global mean (the ranks' sums all-reduced); the gradient is this
        rank's part only, which the trainer's sum over ``sep`` completes.
        No rank gathers the hidden states or the logits."""
        from paddle_tpu_torch.distributed import collective
        from paddle_tpu_torch.distributed import env as dist_env
        from paddle_tpu_torch.distributed.ring_attention import _gather_seq

        mesh, sep_axis = sep
        c, r = hidden.shape[1], mesh.index(sep_axis)
        whole = _gather_seq(labels, mesh, sep_axis)
        tgt = whole[:, r * c + 1:(r + 1) * c + 1]
        part = F.loss._linear_cross_entropy(
            hidden[:, :tgt.shape[1]], self.gpt.wte.weight, tgt,
            reduction="sum", w_vocab_major=True, axis=axis)
        total = part.detach().float().clone()
        with dist_env._mesh_scope(mesh):
            collective.all_reduce(total, axis_name=sep_axis)
        count = (whole[:, 1:] != -100).float().sum().clamp(min=1.0)
        return (part.float() + (total - part.detach().float())) / count

    @staticmethod
    def loss(logits, labels):
        """Functional LM loss (``gpt.py:656``): shift-by-one causal CE."""
        return F.cross_entropy(logits[:, :-1], labels[:, 1:],
                               reduction="mean")

    def loss_with_aux(self, logits, labels):
        """The LM loss plus ``moe_aux_weight`` times each MoE gate's
        load-balance loss recorded in the same forward (``gpt.py:663``;
        the ``ShardedTrainer`` loss_fn of a GPT-MoE model). Reading a
        gate's loss clears it."""
        from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer

        loss = GPTForCausalLM.loss(logits, labels)
        w = self.config.moe_aux_weight
        for sub in self.modules():
            if isinstance(sub, MoELayer):
                aux = sub.gate.get_loss()
                if aux is not None:
                    loss = loss + aux * w
        return loss

    # -- generation ---------------------------------------------------------
    def generate(self, input_ids, max_new_tokens: int = 20,
                 temperature: float = 1.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, use_cache: bool = True,
                 jit: bool = False, spec=None):
        """Autoregressive sampling (``gpt.py:679``): ``input_ids`` (b, s0)
        in, (b, s0 + max_new_tokens) out, in the input's integer dtype on
        the model's device.

        ``use_cache=True`` decodes one token a forward through the concat
        caches; ``use_cache=False`` re-runs the whole sequence each
        token. ``jit=True`` runs the whole batch through a dense
        :class:`~paddle_tpu_torch.inference.serving.DecodeEngine` kept on
        the model under the reference's key (batch, max_len, dtypes,
        ``top_k``, speculation's k): the prompt in chunks, then one
        lockstep step a token (PyTorch compiles nothing; the engine is
        kept for its buffers' geometry and reallocates them each call).
        ``spec`` (with ``jit=True``) is ``"ngram"`` or a drafter
        instance: draft-and-verify through
        :class:`~paddle_tpu_torch.inference.speculative.SpeculativeEngine`.

        Draws: one ``(b, 2)`` key data a call from torch's default CPU
        generator (``core.random.seed`` seeds it), and the token landing
        at position P of row i is drawn at ``position_uniforms(keydata[i],
        P)``, on every path; the reference's threefry stream is not
        reproduced. Greedy decoding (``top_k=1``) draws nothing that
        matters and is token-exact with the reference on every path."""
        from paddle_tpu_torch.inference.serving import (DecodeEngine,
                                                        apply_topk_topp)

        ids = torch.as_tensor(input_ids, device=self.gpt.wte.weight.device)
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if spec is not None and not jit:
            raise ValueError(
                "speculative decoding rides the static-cache path; call "
                "generate(..., jit=True, spec=...)")
        self.eval()
        if max_new_tokens <= 0:
            return ids
        keydata = torch.randint(0, 1 << 32, (ids.shape[0], 2),
                                dtype=torch.int64).numpy().astype(np.uint32)
        if jit:
            return self._generate_jit(ids, max_new_tokens, temperature,
                                      top_k, top_p, spec=spec,
                                      keydata=keydata)
        kd = torch.from_numpy(keydata.astype(np.int64)).to(ids.device)

        def sample(logits):
            last = logits[:, -1].float() / max(float(temperature), 1e-6)
            if top_k is not None:
                kth = torch.sort(last, dim=-1).values[:, -top_k][:, None]
                last = torch.where(last < kth, float("-inf"), last)
            if top_p is not None:
                b = last.shape[0]
                last = apply_topk_topp(
                    last, torch.zeros(b, dtype=torch.int64,
                                      device=last.device),
                    torch.full((b,), top_p, device=last.device))
            # the token lands at position ids.shape[1]
            pos = torch.full((last.shape[0],), ids.shape[1],
                             dtype=torch.int64, device=last.device)
            nxt = DecodeEngine._draw_dev(
                last, position_uniforms(kd, pos, LANE_DRAW))
            return nxt[:, None].to(ids.dtype)

        with torch.inference_mode():
            if not use_cache:
                for _ in range(max_new_tokens):
                    ids = torch.cat([ids, sample(self(ids))], dim=1)
                return ids
            # prefill from empty concat caches, then one-token steps
            b, heads = ids.shape[0], self.config.num_heads
            w = self.gpt.wte.weight
            empty = torch.zeros((b, 0, heads,
                                 self.config.hidden_size // heads),
                                dtype=w.dtype, device=w.device)
            logits, caches = self(ids, caches=[(empty, empty)
                                               for _ in self.gpt.h])
            tok = sample(logits)
            ids = torch.cat([ids, tok], dim=1)
            for _ in range(max_new_tokens - 1):
                logits, caches = self(tok, caches=caches)
                tok = sample(logits)
                ids = torch.cat([ids, tok], dim=1)
        return ids

    _decode_cache: Optional[dict] = None

    def _generate_jit(self, input_ids, max_new_tokens: int,
                      temperature: float, top_k: Optional[int],
                      top_p: Optional[float] = None, spec=None, *,
                      keydata=None):
        """The whole batch through a dense engine cached on the model
        (``gpt.py:778``): the prompt through ``prefill``, then
        ``max_new_tokens - 1`` steps, or the speculative loop; the
        engine's buffers (and the drafter's) are released at the end.
        ``keydata`` is the call's (b, 2) uint32 key data."""
        from paddle_tpu_torch.inference.serving import DecodeEngine

        ids = input_ids
        b, s0 = ids.shape
        mpe = self.config.max_position_embeddings
        drafter, spec_k = None, 0
        if spec is not None:
            from paddle_tpu_torch.inference.speculative import (
                NgramDrafter, SpeculativeEngine)

            if isinstance(spec, str):
                if spec != "ngram":
                    raise ValueError(
                        f"unknown spec drafter {spec!r}; pass 'ngram' or a "
                        "drafter instance (NgramDrafter / "
                        "DraftModelDrafter)")
                drafter = NgramDrafter()
            else:
                drafter = spec
            spec_k = drafter.k
        # spec reserves k rows of verify headroom past the last generated
        # position (frozen rows keep verifying until the batch finishes)
        need = s0 + max_new_tokens + spec_k
        if need > mpe:
            raise ValueError(
                f"prompt + max_new_tokens"
                f"{f' + spec headroom k={spec_k}' if spec_k else ''} = "
                f"{need} exceeds max_position_embeddings {mpe}")
        max_len = min(-(-need // 64) * 64, mpe)
        if self._decode_cache is None:
            self._decode_cache = {}
        key = (b, max_len, str(self.gpt.wte.weight.dtype), str(ids.dtype),
               top_k, spec_k or None)
        eng = self._decode_cache.get(key)
        if eng is None:
            if drafter is not None:
                eng = SpeculativeEngine(self, b, max_len, k=spec_k,
                                        top_k=top_k)
            else:
                eng = DecodeEngine(self, b, max_len, top_k=top_k)
            self._decode_cache[key] = eng
        else:
            eng.refresh_params()
        temps = np.full((b,), max(float(temperature), 1e-6), np.float32)
        greedy = np.zeros((b,), bool)
        topps = np.full((b,), top_p if top_p is not None else 1.0,
                        np.float32)
        slots = np.arange(b, dtype=np.int32)
        plens = np.full((b,), s0, np.int32)
        try:
            if drafter is not None:
                gen = self._spec_decode_loop(
                    eng, drafter, ids, max_new_tokens, temps, greedy,
                    keydata, slots, plens, topps=topps)
                return torch.cat([ids, torch.as_tensor(
                    gen, device=ids.device).to(ids.dtype)], dim=1)
            tok = eng.prefill(ids, slots, plens, temps, greedy, keydata,
                              topps=topps)
            t = np.full((b,), s0, np.int32)
            pieces = [ids, tok.to(ids.dtype)]
            for _ in range(max_new_tokens - 1):
                tok = eng.step(tok, t, temps, greedy, keydata, topps=topps)
                t += 1
                pieces.append(tok.to(ids.dtype))
            return torch.cat(pieces, dim=1)
        finally:
            # a cached engine keeps its geometry, not its buffers
            eng.release_buffers()
            if drafter is not None:
                drafter.release()

    def _spec_decode_loop(self, eng, drafter, ids_v, max_new_tokens, temps,
                          greedy, keydata, slots, plens, topps=None):
        """The whole-batch speculative loop (``gpt.py:896``): draft k,
        verify once, commit the accepted prefix plus one target token a
        row; a row that reached its quota freezes (offset and pending
        token stop) until the slowest finishes. Returns the (b,
        max_new_tokens) generated ids on the host."""
        b, s0 = ids_v.shape
        drafter.begin(eng.b, eng.max_len)
        tok = eng.prefill(ids_v, slots, plens, temps, greedy, keydata,
                          topps=topps)
        prompts = ids_v.cpu().numpy()
        drafter.admit(np.arange(b, dtype=np.int32), prompts, plens)
        prompts = prompts.tolist()
        pending = tok.cpu().numpy().astype(np.int64)          # (b, 1)
        gen = [[int(pending[i, 0])] for i in range(b)]
        t = np.full((b,), s0, np.int32)
        cap = min(drafter.accept_cap, drafter.k)
        while any(len(g) < max_new_tokens for g in gen):
            ctxs = [prompts[i] + gen[i] for i in range(b)]
            drafts = drafter.propose(ctxs, pending[:, 0], t)
            out, acc = eng.verify(pending, drafts, t, temps, greedy,
                                  keydata, topps=topps)
            out, acc = out.cpu().numpy(), acc.cpu().numpy()
            for i in range(b):
                rem = max_new_tokens - len(gen[i])
                if rem <= 0:
                    continue   # frozen row
                a = min(int(acc[i]), cap, rem - 1)
                gen[i].extend(int(x) for x in out[i, :a + 1])
                t[i] += a + 1
                pending[i, 0] = out[i, a]
        return np.asarray(gen, np.int64)

    def kv_cache_spec(self) -> dict:
        """Cache geometry the serving engine sizes its pools from."""
        cfg = self.config
        w = self.gpt.wte.weight
        return {"num_layers": len(self.gpt.h),
                "num_heads": cfg.num_heads,
                "head_dim": cfg.hidden_size // cfg.num_heads,
                "dtype": w.dtype, "device": w.device,
                "max_position_embeddings": cfg.max_position_embeddings}


class GPTEmbeddingStage(Layer):
    """The pipeline's stage-0 head-end (``gpt.py:944``): token and
    position embeddings and the embedding dropout, inside stage 0 of the
    1F1B schedule."""

    def __init__(self, config: GPTConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.wte = VocabParallelEmbedding(config.vocab_size,
                                          config.hidden_size, device=device,
                                          dtype=dtype)
        self.wpe = Embedding(config.max_position_embeddings,
                             config.hidden_size, device=device, dtype=dtype)
        self.drop = Dropout(config.hidden_dropout)

    def forward(self, input_ids):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device) \
            + _sep_position_offset(s)
        return self.drop(self.wte(input_ids) + self.wpe(pos))


class GPTHeadStage(Layer):
    """The pipeline's last-stage tail (``gpt.py:966``): the final norm
    and the LM head. Tied, it holds the embedding stage's
    ``VocabParallelEmbedding`` object itself, so the weight is one
    parameter whose gradient sums both uses (the schedule's sum over
    ``pp``). Under tensor parallelism it returns this rank's vocab
    columns of the logits (the tied matmul behind ``mp_identity``, or
    the untied column-parallel head without its gather), which
    ``GPTForCausalLMPipe.pipe_loss`` reduces vocab-parallel."""

    def __init__(self, config: GPTConfig, tied_embedding=None, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.ln_f = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_epsilon,
                              device=device, dtype=dtype)
        if tied_embedding is not None:
            self.wte = tied_embedding
            self.lm_head = None
        else:
            self.wte = None
            self.lm_head = ColumnParallelLinear(
                config.hidden_size, config.vocab_size, has_bias=False,
                gather_output=False, device=device, dtype=dtype)

    def forward(self, h):
        h = self.ln_f(h)
        if self.lm_head is not None:
            return self.lm_head(h)
        h, w = maybe_cast_inputs("matmul", (h, self.wte.weight))
        if axis_in_scope(MP_AXIS):
            return torch.matmul(mp_identity(h, MP_AXIS), w.t())
        return torch.matmul(h, w.t())


class GPTForCausalLMPipe(Pipeline1F1B):
    """Pipeline-parallel GPT (``gpt.py:1011``): the embedding inside
    stage 0, the blocks stage-stacked over ``pp``, the head (tied or
    not) and the loss inside stage S-1, on the 1F1B schedule
    (``distributed/pipeline_1f1b.py``). The weights are drawn as
    ``GPTForCausalLM``'s from ``seed``, so the two hold the same values
    under one seed (an untied head's weight is drawn last). A GPT-MoE
    config refuses: the MoE pipeline is ROADMAP.md Queue 1 item 6 (6d).

    ``forward`` returns whole-vocabulary logits (gathered over ``mp``
    under tensor parallelism), for ``loss`` and evaluation; the schedule
    runs ``pipe_loss`` on the head's own output."""

    def __init__(self, config: GPTConfig, num_stages: int = 1,
                 num_microbatches: int = 1,
                 virtual_pipeline_degree: int = 1, *, device=None,
                 seed: int = 0, dtype=torch.float32):
        if config.num_experts > 0:
            raise NotImplementedError(
                "GPTForCausalLMPipe with a GPT-MoE config: the MoE pipeline "
                "over ranks is ROADMAP.md Queue 1 item 6 (6d); train "
                "GPTForCausalLM with the MoE config instead")
        dev = resolve_device(device)
        embed = GPTEmbeddingStage(config, device=dev, dtype=dtype)
        head = GPTHeadStage(
            config,
            tied_embedding=embed.wte if config.tie_word_embeddings else None,
            device=dev, dtype=dtype)
        blocks = [GPTBlock(config, device=dev, dtype=dtype)
                  for _ in range(config.num_layers)]
        gen = make_generator(seed, dev)
        _draw_weights(config, gen, embed.wte, embed.wpe, blocks)
        if head.lm_head is not None:
            with torch.no_grad():
                head.lm_head.weight.normal_(0.0, config.initializer_range,
                                            generator=gen)
        super().__init__(first=embed, blocks=blocks, last=head,
                         loss_fn=GPTForCausalLMPipe.pipe_loss,
                         num_stages=num_stages,
                         num_microbatches=num_microbatches,
                         virtual_pipeline_degree=virtual_pipeline_degree)
        self.config = config

    def forward(self, input_ids, position_ids=None):
        if position_ids is not None:
            raise NotImplementedError(
                "GPTForCausalLMPipe derives position ids inside its "
                "embedding stage (arange over the sequence); explicit "
                "position_ids are not supported on the pipelined path — "
                "use GPTForCausalLM for custom positions")
        logits = super().forward(input_ids)
        if axis_in_scope(MP_AXIS) and _pg(MP_AXIS)[1] > 1:
            logits = _gather_last(logits, MP_AXIS)
        return logits

    @staticmethod
    def pipe_loss(logits, labels):
        """Shift-by-one causal CE; under tensor parallelism the logits
        are this rank's vocab columns and the loss is
        ``ParallelCrossEntropy``'s."""
        shifted, targets = logits[:, :-1], labels[:, 1:]
        if axis_in_scope(MP_AXIS):
            return ParallelCrossEntropy()(shifted, targets).mean()
        return F.cross_entropy(shifted, targets, reduction="mean")

    loss = GPTForCausalLM.loss


def gpt_tiny() -> GPTConfig:
    """CI-sized config (``gpt.py:1088``)."""
    return GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                     num_heads=4, max_position_embeddings=128,
                     hidden_dropout=0.0, attention_dropout=0.0)


def gpt_tiny8() -> GPTConfig:
    """gpt_tiny with EIGHT heads of 8 (``gpt.py:1095``)."""
    return GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                     num_heads=8, max_position_embeddings=128,
                     hidden_dropout=0.0, attention_dropout=0.0)


def gpt_moe_tiny() -> GPTConfig:
    """CI-sized GPT-MoE (``gpt.py:1106``): gshard top-2, 4 experts in
    every other block."""
    return GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                     num_heads=4, max_position_embeddings=128,
                     hidden_dropout=0.0, attention_dropout=0.0,
                     num_experts=4, moe_top_k=2, moe_gate="gshard",
                     moe_every_k=2)


def gpt_moe_1p3b() -> GPTConfig:
    """GPT-MoE on the GPT-3 XL backbone (``gpt.py:1115``): 16 gshard
    top-2 experts in every other block."""
    return GPTConfig(vocab_size=50304, hidden_size=2048, num_layers=24,
                     num_heads=16, max_position_embeddings=2048,
                     num_experts=16, moe_top_k=2, moe_gate="gshard",
                     moe_every_k=2)


def gpt2_small() -> GPTConfig:
    """GPT-2 small (``gpt.py:1124``)."""
    return GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                     num_heads=12, max_position_embeddings=1024)


def gpt3_1p3b() -> GPTConfig:
    """GPT-3 XL (``gpt.py:1129``): 24 layers, 16 heads of 128."""
    return GPTConfig(vocab_size=50304, hidden_size=2048, num_layers=24,
                     num_heads=16, max_position_embeddings=2048)


def gpt3_13b() -> GPTConfig:
    """GPT-3 13B (``gpt.py:1135``): 40 layers, 40 heads of 128."""
    return GPTConfig(vocab_size=50304, hidden_size=5120, num_layers=40,
                     num_heads=40, max_position_embeddings=2048)
