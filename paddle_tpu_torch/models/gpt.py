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
- the PAGED full-precision cache (``gpt.py:284-359``): per layer a
  ``(k_pool, v_pool, table, t)`` tuple — pools ``(num_blocks,
  block_size, H, D)``, an int32 block table ``(b, blocks_per_slot)`` and
  the write offset ``t``, a 0-dim tensor for single-slot chunk prefill
  or ``(b,)`` per-slot offsets for lockstep decode. New K/V rows commit
  into the pools IN PLACE (JAX donates the buffers instead), then
  attention reads back through the table: a query chunk (s > 1) at a
  scalar offset runs the chunk-prefill kernel K5, everything else the
  paged decode kernel K4 — the routing of ``gpt.py:350-357``.

The dense static arena and the int8 pools are later slices.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from paddle_tpu_torch.amp.auto_cast import maybe_cast_inputs
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.core.random import generator as make_generator
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


class GPTAttention(Layer):
    def __init__(self, config: GPTConfig, device=None, dtype=torch.float32):
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
            if len(cache) != 4:
                raise NotImplementedError(
                    "only the paged full-precision cache (k_pool, v_pool, "
                    "table, t) is ported; the dense arena and int8 pools "
                    "are later slices")
            k_pool, v_pool, table, t = cache
            _upd_paged(k_pool, v_pool, k, v, table, t, rows=write_rows)
            q = q.contiguous()
            if s > 1 and t.dim() == 0:
                out = chunk_prefill(q, k_pool, v_pool, table, t)
            else:
                out = paged_attention(q, k_pool, v_pool, table, t)
            cache = (k_pool, v_pool, table, t + s)
        else:
            out = F.scaled_dot_product_attention(
                q, k, v, is_causal=True, dropout_p=self.attn_dropout_p,
                training=self.training)
        out = self.resid_dropout(self.out_proj(
            out.reshape(b, s, self.num_heads * self.head_dim)))
        return out if cache is None else (out, cache)


class GPTMLP(Layer):
    def __init__(self, config: GPTConfig, device=None, dtype=torch.float32):
        super().__init__()
        h, ffn = config.hidden_size, config.ffn_size
        self.fc_in = ColumnParallelLinear(h, ffn, device=device, dtype=dtype)
        self.fc_out = RowParallelLinear(ffn, h, device=device, dtype=dtype)
        self.dropout = Dropout(config.hidden_dropout)

    def forward(self, x):
        return self.dropout(self.fc_out(F.gelu(self.fc_in(x),
                                               approximate=True)))


class GPTBlock(Layer):
    def __init__(self, config: GPTConfig, device=None, dtype=torch.float32):
        super().__init__()
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
    def __init__(self, config: GPTConfig, device=None, dtype=torch.float32):
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
                # the offset is the last element of each cache tuple: a
                # scalar start (chunk prefill) or (b,) per-slot starts
                t = caches[0][-1]
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
        k_pool, _, table, t = caches[0]
        rows = _paged_write_rows(table, t, s, k_pool.shape[1])
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

    def __init__(self, config: GPTConfig, device=None, seed: int = 0,
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
