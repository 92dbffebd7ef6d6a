"""GPT decoder-only language model — the port of ``models/gpt.py``.

Same architecture and parameter names as the JAX package: pre-LN
transformer blocks (``ln_1``, ``attn.qkv_proj``, ``attn.out_proj``,
``ln_2``, ``mlp.fc_in``, ``mlp.fc_out``), learned positions, tanh GELU,
and the LM head tied to the token embedding (``gpt.py:637``). Weights are
paddle's (in, out) layout, so ``set_state_dict`` copies a ``paddle_tpu``
model's arrays by name with no transposes.

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
  paged decode kernel K4 — the routing of ``gpt.py:350-357``.

The dense static arena is a later slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from paddle_tpu_torch.amp.auto_cast import maybe_cast_inputs
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.core.random import generator as make_generator
from paddle_tpu_torch.core.unported import refuse_unported
from paddle_tpu_torch.distributed.meta_parallel import (ColumnParallelLinear,
                                                        RowParallelLinear,
                                                        VocabParallelEmbedding)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.layers import Dropout, Embedding, LayerList, LayerNorm
from paddle_tpu_torch.ops.kernels.chunk_prefill import chunk_prefill
from paddle_tpu_torch.ops.kernels.paged_attention import paged_attention

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt_tiny",
           "gpt2_small"]

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

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    def num_params(self) -> int:
        """Parameter count of the tied model (``gpt.py:75``)."""
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

    def forward(self, x, cache=None, write_rows=None):
        b, s = x.shape[0], x.shape[1]
        # the split is PER HEAD (gpt.py:276-277): each head's 3*D slice
        # holds its q, k, v — not three hidden-wide thirds
        qkv = self.qkv_proj(x).reshape(b, s, self.num_heads,
                                       3 * self.head_dim)
        q, k, v = qkv.split(self.head_dim, dim=-1)
        if cache is not None:
            if len(cache) not in (4, 7):
                raise NotImplementedError(
                    "only the paged caches (k_pool, v_pool, table, t) and "
                    "(k_pool, v_pool, k_scale, v_scale, table, t, cl) are "
                    "ported; the dense arena is a later slice")
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
        else:
            out = F.scaled_dot_product_attention(
                q, k, v, is_causal=True, dropout_p=self.attn_dropout_p,
                training=self.training)
        out = self.resid_dropout(self.out_proj(
            out.reshape(b, s, self.num_heads * self.head_dim)))
        return out if cache is None else (out, cache)


class GPTMLP(Layer):
    def __init__(self, config: GPTConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        h, ffn = config.hidden_size, config.ffn_size
        self.fc_in = ColumnParallelLinear(h, ffn, device=device, dtype=dtype)
        self.fc_out = RowParallelLinear(ffn, h, device=device, dtype=dtype)
        self.dropout = Dropout(config.hidden_dropout)

    def forward(self, x):
        return self.dropout(self.fc_out(F.gelu(self.fc_in(x),
                                               approximate=True)))


class GPTBlock(Layer):
    def __init__(self, config: GPTConfig, use_moe: bool = False, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        refuse_unported("GPTBlock", use_moe=(use_moe, False))
        eps = config.layer_norm_epsilon
        self.ln_1 = LayerNorm(config.hidden_size, epsilon=eps, device=device,
                              dtype=dtype)
        self.attn = GPTAttention(config, device=device, dtype=dtype)
        self.ln_2 = LayerNorm(config.hidden_size, epsilon=eps, device=device,
                              dtype=dtype)
        self.mlp = GPTMLP(config, device=device, dtype=dtype)

    def forward(self, x, cache=None, write_rows=None):
        if cache is None:
            x = x + self.attn(self.ln_1(x))
        else:
            a, cache = self.attn(self.ln_1(x), cache=cache,
                                 write_rows=write_rows)
            x = x + a
        x = x + self.mlp(self.ln_2(x))
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
        self.h = LayerList([GPTBlock(config, device=device, dtype=dtype)
                            for _ in range(config.num_layers)])
        self.ln_f = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_epsilon,
                              device=device, dtype=dtype)

    def forward(self, input_ids, position_ids=None, caches=None):
        b, s = input_ids.shape[0], input_ids.shape[1]
        steps = torch.arange(s, device=input_ids.device)
        if position_ids is None:
            if caches is None:
                position_ids = steps
            else:
                # a scalar start (chunk prefill) or (b,) per-slot
                # starts: the 4th of 4 or the 6th of 7 cache elements
                # (never the last: in the quantized tuple that is cl)
                t = caches[0][5] if len(caches[0]) == 7 else caches[0][3]
                position_ids = t + steps if t.dim() == 0 \
                    else t.reshape(-1, 1) + steps
        # the pad tail of a final prefill chunk can run past the position
        # table; those rows are dropped at commit and their outputs
        # discarded, so clamping only keeps the lookup in range
        position_ids = position_ids.long().clamp(
            max=self.config.max_position_embeddings - 1)
        x = self.drop(self.wte(input_ids) + self.wpe(position_ids))
        if caches is None:
            for block in self.h:
                x = block(x)
            return self.ln_f(x)
        c0 = caches[0]
        if len(c0) == 7:
            rows = _QuantPlan(c0[4], c0[5], c0[6], s, c0[0].shape[1])
        else:
            rows = _paged_write_rows(c0[2], c0[3], s, c0[0].shape[1])
        new_caches = []
        for block, cache in zip(self.h, caches):
            x, c = block(x, cache=cache, write_rows=rows)
            new_caches.append(c)
        return self.ln_f(x), new_caches


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
        std = self.config.initializer_range
        out_std = std / math.sqrt(2 * self.config.num_layers)
        with torch.no_grad():
            self.gpt.wte.weight.normal_(0.0, std, generator=gen)
            self.gpt.wpe.weight.normal_(0.0, std, generator=gen)
            for blk in self.gpt.h:
                blk.attn.qkv_proj.weight.normal_(0.0, std, generator=gen)
                blk.attn.out_proj.weight.normal_(0.0, out_std, generator=gen)
                blk.mlp.fc_in.weight.normal_(0.0, std, generator=gen)
                blk.mlp.fc_out.weight.normal_(0.0, out_std, generator=gen)

    def forward(self, input_ids, labels=None, position_ids=None,
                caches=None):
        """Logits, or ``(logits, new_caches)`` with ``caches``; with
        ``labels`` (integer ids of ``input_ids``' shape) the mean
        next-token loss instead, through the fused chunked head and
        cross entropy — the (N, vocab) logits never exist at once."""
        if labels is not None and (
                tuple(labels.shape) != tuple(input_ids.shape)
                or labels.dtype not in _INT_DTYPES):
            raise TypeError(
                "labels must be integer ids with input_ids' shape — got "
                f"shape {tuple(labels.shape)}; if you meant position_ids, "
                "pass it by keyword (forward(input_ids, labels=None, "
                "position_ids=None, caches=None))")
        out = self.gpt(input_ids, position_ids, caches)
        hidden = out if caches is None else out[0]
        if labels is not None:
            return F.linear_cross_entropy(
                hidden[:, :-1], self.gpt.wte.weight, labels[:, 1:],
                reduction="mean", w_vocab_major=True)
        # tied head: hidden @ wte^T, the white-listed op "matmul"
        h, w = maybe_cast_inputs("matmul", (hidden, self.gpt.wte.weight))
        logits = torch.matmul(h, w.t())
        return logits if caches is None else (logits, out[1])

    @staticmethod
    def loss(logits, labels):
        """Functional LM loss (``gpt.py:656``): shift-by-one causal CE."""
        return F.cross_entropy(logits[:, :-1], labels[:, 1:],
                               reduction="mean")

    def kv_cache_spec(self) -> dict:
        """Cache geometry the serving engine sizes its pools from."""
        cfg = self.config
        w = self.gpt.wte.weight
        return {"num_layers": len(self.gpt.h),
                "num_heads": cfg.num_heads,
                "head_dim": cfg.hidden_size // cfg.num_heads,
                "dtype": w.dtype, "device": w.device,
                "max_position_embeddings": cfg.max_position_embeddings}


def gpt_tiny() -> GPTConfig:
    """CI-sized config (``gpt.py:1088``)."""
    return GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                     num_heads=4, max_position_embeddings=128,
                     hidden_dropout=0.0, attention_dropout=0.0)


def gpt2_small() -> GPTConfig:
    """GPT-2 small (``gpt.py:1124``)."""
    return GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                     num_heads=12, max_position_embeddings=1024)
