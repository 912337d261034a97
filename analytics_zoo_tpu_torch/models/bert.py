"""BERT task models.

Port of `analytics_zoo_tpu/models/bert.py`: `_BERTTask` (L28) with
`default_compile` (L36) and `BERTClassifier` (L61), a thin head over the
port's `keras.transformer.BERT`. `BERTNER`, `BERTSQuAD` and
`load_tf_checkpoint` (which needs TensorFlow) are not ported yet
(ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Optional

import torch

from analytics_zoo_tpu_torch.common.device import DeviceLike
from analytics_zoo_tpu_torch.keras.engine import KerasNet, new_parameter
from analytics_zoo_tpu_torch.keras.layers import fill_
from analytics_zoo_tpu_torch.keras.transformer import (BERT, _dropout,
                                                       _site_seeds)
from analytics_zoo_tpu_torch.serving.quantization import maybe_int8_matmul


class _BERTTask(KerasNet):
    """Shared plumbing: a BERT encoder plus a task head."""

    def __init__(self, bert: BERT, name: Optional[str] = None):
        super().__init__(name)
        self.bert = bert

    def default_compile(self, lr: float = 5e-5, total_steps: int = -1,
                        loss: str = "sparse_categorical_crossentropy",
                        metrics=("accuracy",)):
        """The reference's fine-tuning defaults: AdamWeightDecay with a
        10% linear warmup, logits crossentropy, accuracy."""
        from analytics_zoo_tpu_torch.ops.objectives import get as get_loss
        from analytics_zoo_tpu_torch.ops.optimizers import adam_weight_decay
        self.compile(adam_weight_decay(lr, warmup_portion=0.1,
                                       total_steps=total_steps),
                     get_loss(loss, from_logits=True), list(metrics))
        return self


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

    def apply(self, inputs, *, training: bool = False,
              seed: Optional[int] = None):
        bert_seed, drop_seed = _site_seeds(training, seed, 2)
        pooled = self.bert.call(inputs, training=training, seed=bert_seed)
        if drop_seed is not None and self.dropout > 0:
            pooled = _dropout(drop_seed, self.dropout, pooled)
        return maybe_int8_matmul(pooled, self, "cls_kernel") + self.cls_bias
