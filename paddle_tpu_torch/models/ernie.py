"""ERNIE of the port (``paddle_tpu/models/ernie.py``).

ERNIE-1.0 is the BERT trunk (``models/bert.py``) plus a task-type
embedding table; the reference's structure and parameter names, so a
JAX model's ``state_dict()`` loads by name. The models take the port's
keyword-only ``device``, ``dtype`` and ``seed``, as BERT's do.
``ErnieForPretrainingPipe`` is ``BertForPretrainingPipe`` with the ERNIE
embeddings (task type 0 inside the embedding stage).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.distributed.ring_attention import _sep_position_offset
from paddle_tpu_torch.models.bert import (BertConfig, BertEmbeddings,
                                          BertForPretrainingPipe, BertModel,
                                          _additive_mask, _build)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.layers.common import Dropout, Embedding, Linear

__all__ = ["ErnieConfig", "ErnieModel", "ErnieForSequenceClassification",
           "ernie_1_0", "ErnieForPretrainingPipe"]


@dataclass
class ErnieConfig(BertConfig):
    # ERNIE-1.0 defaults (vocab from the reference ecosystem's tokenizer)
    vocab_size: int = 18000
    task_type_vocab_size: int = 3
    use_task_id: bool = True


class ErnieEmbeddings(BertEmbeddings):
    """BERT embeddings + task-type table."""

    def __init__(self, c: ErnieConfig, *, device=None, dtype=torch.float32):
        super().__init__(c, device=device, dtype=dtype)
        self.use_task_id = c.use_task_id
        if c.use_task_id:
            self.task_type_embeddings = Embedding(
                c.task_type_vocab_size, c.hidden_size,
                weight_attr=I.Normal(0.0, c.initializer_range),
                device=device, dtype=dtype)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                task_type_ids=None):
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
        if self.use_task_id:
            if task_type_ids is None:
                task_type_ids = ops.zeros_like(input_ids)
            x = x + self.task_type_embeddings(task_type_ids)
        return self.dropout(self.layer_norm(x))


class ErnieModel(BertModel):
    embeddings_cls = ErnieEmbeddings   # same trunk, task-aware embeddings

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, task_type_ids=None):
        x = self.embeddings(input_ids, token_type_ids, position_ids,
                            task_type_ids)
        attention_mask = _additive_mask(attention_mask)
        seq = self.encoder(x, src_mask=attention_mask)
        pooled = F.tanh(self.pooler(ops.getitem(seq, (slice(None), 0))))
        return seq, pooled


class ErnieForSequenceClassification(Layer):
    def __init__(self, config: ErnieConfig, *, device=None,
                 dtype=torch.float32, seed: Optional[int] = None):
        super().__init__()
        dev, scope = _build(device, seed)
        kw = dict(device=dev, dtype=dtype)
        with scope:
            self.ernie = ErnieModel(config, **kw)
            self.dropout = Dropout(config.hidden_dropout_prob)
            self.classifier = Linear(config.hidden_size, config.num_labels,
                                     **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                task_type_ids=None):
        _, pooled = self.ernie(input_ids, token_type_ids,
                               attention_mask=attention_mask,
                               task_type_ids=task_type_ids)
        return self.classifier(self.dropout(pooled))


def ernie_1_0() -> ErnieConfig:
    """ERNIE-1.0 base: 12L/768H/12A over the 18k Chinese vocab."""
    return ErnieConfig()


class ErnieForPretrainingPipe(BertForPretrainingPipe):
    """ERNIE MLM pretraining on the 1F1B schedule (``ernie.py:98``):
    ``BertForPretrainingPipe``'s shape with ``ErnieEmbeddings``."""

    embeddings_cls = ErnieEmbeddings

    def __init__(self, config: ErnieConfig, num_stages: int = 1,
                 num_microbatches: int = 1, *, device=None,
                 dtype=torch.float32, seed: Optional[int] = None):
        super().__init__(config, num_stages, num_microbatches, device=device,
                         dtype=dtype, seed=seed)
