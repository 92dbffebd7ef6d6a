"""BERT of the port (``paddle_tpu/models/bert.py``).

The reference's structure and parameter names: embeddings (word +
position + token type, LayerNorm, dropout), the ``TransformerEncoder``
stack (post-norm, ``hidden_act``, no dropout after the activation), a
tanh pooler over the first token; pretraining heads (MLM decoded
against the tied word embeddings, NSP) and a sequence classifier. A JAX
model's ``state_dict()`` loads by name through ``set_state_dict``.

Attention runs through ``F.scaled_dot_product_attention``: with no
``attention_mask`` and attention dropout off (0, or eval mode) it is the
flash kernels K1a/K3a, non-causally; a (batch, seq) 1/0
``attention_mask`` becomes the reference's additive fp32 (batch, 1, 1,
seq) mask of -1e9 and takes the plain attention. Every LayerNorm is K2
at ``layer_norm_eps`` (1e-12).

The models take the port's keyword-only ``device`` (``"cuda"`` unless
the caller asks for the CPU), ``dtype``, and ``seed``: with a seed every
weight is drawn from one generator seeded with it on the device, else
from the device's default generator. ``BertForPretrainingPipe`` is the
MLM objective on the 1F1B pipeline (``distributed/pipeline_1f1b.py``):
the embeddings inside stage 0, the encoder layers stage-stacked over
``pp``, ``BertMLMHeadStage`` (tied to the word embeddings) inside stage
S-1. Under ``ring_attention.sep_sharded_scope`` the embeddings add the
sequence chunk's offset to their positions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.core.random import generator as make_generator
from paddle_tpu_torch.distributed.pipeline_1f1b import Pipeline1F1B
from paddle_tpu_torch.distributed.ring_attention import _sep_position_offset
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.layers.common import Dropout, Embedding, Linear
from paddle_tpu_torch.nn.layers.norm import LayerNorm
from paddle_tpu_torch.nn.layers.transformer import (TransformerEncoder,
                                                    TransformerEncoderLayer)

__all__ = ["BertConfig", "BertModel", "BertForPretraining",
           "BertForSequenceClassification", "BertMLMHeadStage",
           "BertForPretrainingPipe"]


def _build(device, seed: Optional[int]):
    """(device, scope): the resolved device, and the scope the weights
    are drawn in (one generator seeded with ``seed``, or the default)."""
    dev = resolve_device(device)
    return dev, I._drawing_from(
        None if seed is None else make_generator(seed, dev))


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    num_labels: int = 2


class BertEmbeddings(Layer):
    def __init__(self, c: BertConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        init = I.Normal(0.0, c.initializer_range)
        self.word_embeddings = Embedding(c.vocab_size, c.hidden_size,
                                         weight_attr=init, **kw)
        self.position_embeddings = Embedding(c.max_position_embeddings,
                                             c.hidden_size, weight_attr=init,
                                             **kw)
        self.token_type_embeddings = Embedding(c.type_vocab_size,
                                               c.hidden_size, weight_attr=init,
                                               **kw)
        self.layer_norm = LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps,
                                    **kw)
        self.dropout = Dropout(c.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        s = input_ids.shape[1]
        if position_ids is None:
            off = _sep_position_offset(s)
            position_ids = ops.arange(off, off + s, dtype="int32",
                                      device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = ops.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


def _additive_mask(attention_mask):
    """A (batch, seq) 1/0 mask as the reference's additive fp32 (batch, 1,
    1, seq) mask: 0 where kept, -1e9 where padded; any other mask as it
    is."""
    if attention_mask is None or attention_mask.dim() != 2:
        return attention_mask
    m = (1.0 - attention_mask.float()) * -1e9
    return m.unsqueeze(1).unsqueeze(1)


class BertModel(Layer):
    # subclasses (ErnieModel) swap the embeddings implementation without
    # paying for a discarded BertEmbeddings build
    embeddings_cls = BertEmbeddings

    def __init__(self, config: BertConfig, *, device=None,
                 dtype=torch.float32, seed: Optional[int] = None):
        super().__init__()
        self.config = config
        c = config
        dev, scope = _build(device, seed)
        kw = dict(device=dev, dtype=dtype)
        with scope:
            self.embeddings = self.embeddings_cls(c, **kw)
            enc_layer = TransformerEncoderLayer(
                c.hidden_size, c.num_attention_heads, c.intermediate_size,
                dropout=c.hidden_dropout_prob, activation=c.hidden_act,
                attn_dropout=c.attention_probs_dropout_prob,
                act_dropout=0.0, **kw)
            self.encoder = TransformerEncoder(enc_layer, c.num_hidden_layers)
            self.pooler = Linear(c.hidden_size, c.hidden_size, **kw)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        attention_mask = _additive_mask(attention_mask)
        seq = self.encoder(x, src_mask=attention_mask)
        pooled = F.tanh(self.pooler(ops.getitem(seq, (slice(None), 0))))
        return seq, pooled


class BertForPretraining(Layer):
    def __init__(self, config: BertConfig, *, device=None,
                 dtype=torch.float32, seed: Optional[int] = None):
        super().__init__()
        c = config
        dev, scope = _build(device, seed)
        kw = dict(device=dev, dtype=dtype)
        with scope:
            self.bert = BertModel(c, **kw)
            self.mlm_transform = Linear(c.hidden_size, c.hidden_size, **kw)
            self.mlm_norm = LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps,
                                      **kw)
            self.nsp_head = Linear(c.hidden_size, 2, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids,
                                attention_mask=attention_mask)
        h = self.mlm_norm(F.gelu(self.mlm_transform(seq)))
        # decode against tied word embeddings
        mlm_logits = ops.matmul(
            h, ops.transpose(self.bert.embeddings.word_embeddings.weight,
                             [1, 0]))
        nsp_logits = self.nsp_head(pooled)
        return mlm_logits, nsp_logits


class BertForSequenceClassification(Layer):
    def __init__(self, config: BertConfig, *, device=None,
                 dtype=torch.float32, seed: Optional[int] = None):
        super().__init__()
        dev, scope = _build(device, seed)
        kw = dict(device=dev, dtype=dtype)
        with scope:
            self.bert = BertModel(config, **kw)
            self.dropout = Dropout(config.hidden_dropout_prob)
            self.classifier = Linear(config.hidden_size, config.num_labels,
                                     **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids,
                              attention_mask=attention_mask)
        return self.classifier(self.dropout(pooled))


class BertMLMHeadStage(Layer):
    """The pipeline's tail stage (``bert.py:132``): MLM transform, norm
    and the decode against the tied word embeddings (the embedding
    stage's ``Embedding`` object itself, so its gradient sums both
    uses)."""

    def __init__(self, c: BertConfig, tied_embeddings: Embedding, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.mlm_transform = Linear(c.hidden_size, c.hidden_size, **kw)
        self.mlm_norm = LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps,
                                  **kw)
        self.word_embeddings = tied_embeddings

    def forward(self, seq):
        h = self.mlm_norm(F.gelu(self.mlm_transform(seq)))
        return ops.matmul(
            h, ops.transpose(self.word_embeddings.weight, [1, 0]))


def _encoder_layers(c: BertConfig, kw):
    return [TransformerEncoderLayer(
        c.hidden_size, c.num_attention_heads, c.intermediate_size,
        dropout=c.hidden_dropout_prob, activation=c.hidden_act,
        attn_dropout=c.attention_probs_dropout_prob, act_dropout=0.0, **kw)
        for _ in range(c.num_hidden_layers)]


class BertForPretrainingPipe(Pipeline1F1B):
    """Pipeline-parallel BERT pretraining (the MLM objective,
    ``bert.py:152``) on the 1F1B schedule. The NSP head and attention
    masks are not part of the pipelined variant (the per-microbatch
    carry is the hidden sequence alone), as in the reference."""

    embeddings_cls = BertEmbeddings

    def __init__(self, config: BertConfig, num_stages: int = 1,
                 num_microbatches: int = 1, *, device=None,
                 dtype=torch.float32, seed: Optional[int] = None):
        c = config
        dev, scope = _build(device, seed)
        kw = dict(device=dev, dtype=dtype)
        with scope:
            emb = self.embeddings_cls(c, **kw)
            blocks = _encoder_layers(c, kw)
            head = BertMLMHeadStage(c, emb.word_embeddings, **kw)
        super().__init__(first=emb, blocks=blocks, last=head,
                         loss_fn=BertForPretrainingPipe.mlm_loss,
                         num_stages=num_stages,
                         num_microbatches=num_microbatches)
        self.config = config

    @staticmethod
    def mlm_loss(logits, labels):
        """Masked-LM cross entropy; label -100 marks the unmasked
        positions (the reference's ignore_index contract)."""
        return F.cross_entropy(logits, labels, ignore_index=-100,
                               reduction="mean")
