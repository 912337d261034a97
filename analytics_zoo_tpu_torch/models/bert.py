"""BERT task models.

Port of `analytics_zoo_tpu/models/bert.py`: `_BERTTask` (L28) and
`BERTClassifier` (L61), a thin head over the port's `keras.transformer.BERT`.
`BERTNER`, `BERTSQuAD`, `default_compile` and `load_tf_checkpoint` (which
needs TensorFlow) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from analytics_zoo_tpu_torch.common.device import DeviceLike
from analytics_zoo_tpu_torch.keras.engine import KerasNet, new_parameter
from analytics_zoo_tpu_torch.keras.layers import fill_
from analytics_zoo_tpu_torch.keras.transformer import (BERT,
                                                       _no_training_dropout)
from analytics_zoo_tpu_torch.serving.quantization import maybe_int8_matmul


class _BERTTask(KerasNet):
    """Shared plumbing: a BERT encoder plus a task head."""

    def __init__(self, bert: BERT, name: Optional[str] = None):
        super().__init__(name)
        self.bert = bert


class BERTClassifier(_BERTTask):
    """Sequence classification: pooled output → dropout →
    Dense(num_classes) logits. The encoder is named "bert", as in the JAX
    package, so parameter keys are stable (`convert.py`)."""

    def __init__(self, num_classes: int, bert: Optional[BERT] = None,
                 dropout: float = 0.1, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32, **bert_kw):
        bert = bert or BERT(pooled_only=True, name="bert", device=device,
                            dtype=dtype, **bert_kw)
        bert.pooled_only = True
        super().__init__(bert)
        self.num_classes = num_classes
        self.dropout = dropout
        emb = bert.word_embeddings
        self.cls_kernel = new_parameter((bert.hidden_size, num_classes),
                                        emb.device, emb.dtype)
        self.cls_bias = new_parameter((num_classes,), emb.device, emb.dtype)

    def build(self, generator):
        self.bert.build(generator)
        fill_(self.cls_kernel,
              torch.randn(tuple(self.cls_kernel.shape), generator=generator)
              * 0.02)
        fill_(self.cls_bias, torch.zeros(self.cls_bias.shape))

    def apply(self, inputs, *, training: bool = False):
        pooled = self.bert.call(inputs, training=training)
        _no_training_dropout(training, self.dropout)
        return maybe_int8_matmul(pooled, self, "cls_kernel") + self.cls_bias
