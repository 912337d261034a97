"""BERT task models and the TF-checkpoint import.

Port of `analytics_zoo_tpu/models/bert.py`: `_BERTTask` (L28) with
`default_compile` (L36) and `load_tf_checkpoint` (L46), `BERTClassifier`
(L61), `BERTNER` (L98), `BERTSQuAD` (L129) and `load_tf_checkpoint`
(L163), each a thin head over the port's `keras.transformer.BERT`.

`load_tf_checkpoint` maps a Google-format TF1 BERT checkpoint
(`bert/encoder/layer_0/attention/self/query/kernel`, ...) onto the
encoder's parameters exactly as the JAX package does (L185-221): the q, k
and v kernels concatenate on axis 1 into the fused `[D, 3D]` QKV kernel,
their biases into `[3D]`, and every shape is checked against the model.
It reads the checkpoint with the port's own bundle reader
(`utils/tf_checkpoint.py`), without TensorFlow. A variable the checkpoint
lacks raises KeyError, a shape that does not fit the model ValueError,
as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

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

    def load_tf_checkpoint(self, ckpt_path: str) -> "_BERTTask":
        """The encoder's weights from a Google TF1 BERT checkpoint (the
        head keeps its own)."""
        if not self.built:
            raise RuntimeError("Build the model first (ensure_built or fit)")
        self.bert.load_state_dict(load_tf_checkpoint(self.bert, ckpt_path))
        return self

    def _new_head(self, name: str, width: int) -> None:
        """A `[hidden, width]` kernel and `[width]` bias named
        `<name>_kernel` / `<name>_bias`, as the JAX tree names them."""
        emb = self.bert.word_embeddings
        self.register_parameter(name + "_kernel", new_parameter(
            (self.bert.hidden_size, width), emb.device, emb.dtype))
        self.register_parameter(name + "_bias", new_parameter(
            (width,), emb.device, emb.dtype))

    def _build_head(self, name: str, generator) -> None:
        """The encoder, then the head: kernel N(0, 0.02), bias zeros."""
        self.bert.build(generator)
        kernel = getattr(self, name + "_kernel")
        bias = getattr(self, name + "_bias")
        fill_(kernel, torch.randn(tuple(kernel.shape), generator=generator)
              * 0.02)
        fill_(bias, torch.zeros(bias.shape))


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
        self._new_head("cls", num_classes)

    def build(self, generator):
        self._build_head("cls", generator)

    def apply(self, inputs, *, training: bool = False,
              seed: Optional[int] = None):
        bert_seed, drop_seed = _site_seeds(training, seed, 2)
        pooled = self.bert.call(inputs, training=training, seed=bert_seed)
        if drop_seed is not None and self.dropout > 0:
            pooled = _dropout(drop_seed, self.dropout, pooled)
        return maybe_int8_matmul(pooled, self, "cls_kernel") + self.cls_bias


class BERTNER(_BERTTask):
    """Token classification (`bert_ner.py`): sequence output → per-token
    Dense(num_entities) logits `[B, T, num_entities]`."""

    def __init__(self, num_entities: int, bert: Optional[BERT] = None,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32, **bert_kw):
        bert = bert or BERT(name="bert", device=device, dtype=dtype,
                            **bert_kw)
        bert.pooled_only = False
        super().__init__(bert)
        self.num_entities = num_entities
        self._new_head("ner", num_entities)

    def build(self, generator):
        self._build_head("ner", generator)

    def apply(self, inputs, *, training: bool = False,
              seed: Optional[int] = None):
        seq_out, _ = self.bert.call(inputs, training=training, seed=seed)
        return maybe_int8_matmul(seq_out, self, "ner_kernel") + self.ner_bias


class BERTSQuAD(_BERTTask):
    """Extractive QA (`bert_squad.py`): sequence output → start and end
    logits, `([B, T], [B, T])`; compile with one loss per output."""

    def __init__(self, bert: Optional[BERT] = None, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32, **bert_kw):
        bert = bert or BERT(name="bert", device=device, dtype=dtype,
                            **bert_kw)
        bert.pooled_only = False
        super().__init__(bert)
        self._new_head("qa", 2)

    def build(self, generator):
        self._build_head("qa", generator)

    def apply(self, inputs, *, training: bool = False,
              seed: Optional[int] = None):
        seq_out, _ = self.bert.call(inputs, training=training, seed=seed)
        logits = maybe_int8_matmul(seq_out, self, "qa_kernel") + self.qa_bias
        return logits[..., 0], logits[..., 1]           # start, end


# ---------------------------------------------------------------------------
# Google TF1 BERT checkpoint import
# ---------------------------------------------------------------------------
def load_tf_checkpoint(bert: BERT, ckpt_path: str,
                       params: Optional[Mapping[str, torch.Tensor]] = None
                       ) -> Dict[str, torch.Tensor]:
    """The `bert/...` TF1 variables of the checkpoint at `ckpt_path` (a
    bundle prefix, or a directory with a `checkpoint` file) as a state dict
    for `bert` (CPU tensors; `bert.load_state_dict` puts them in place).
    `params` (default `bert.state_dict()`) gives the shapes to validate
    against. KeyError for a missing variable, ValueError for a shape that
    does not match."""
    from analytics_zoo_tpu_torch.utils.tf_checkpoint import load_checkpoint
    reader = load_checkpoint(ckpt_path)

    def get(name):
        full = f"bert/{name}"
        if not reader.has_tensor(full):
            raise KeyError(f"checkpoint missing {full}")
        return torch.from_numpy(reader.get_tensor(full))

    ref = dict(params) if params is not None else bert.state_dict()
    p: Dict[str, torch.Tensor] = {
        "word_embeddings": get("embeddings/word_embeddings"),
        "position_embeddings": get("embeddings/position_embeddings"),
        "token_type_embeddings": get("embeddings/token_type_embeddings"),
        "emb_ln.gamma": get("embeddings/LayerNorm/gamma"),
        "emb_ln.beta": get("embeddings/LayerNorm/beta"),
        "pooler_kernel": get("pooler/dense/kernel"),
        "pooler_bias": get("pooler/dense/bias"),
    }
    for i in range(len(bert.blocks)):
        base = f"encoder/layer_{i}"
        blk = f"blocks.{i}."
        qkv = [get(f"{base}/attention/self/{w}/kernel")
               for w in ("query", "key", "value")]
        qkv_b = [get(f"{base}/attention/self/{w}/bias")
                 for w in ("query", "key", "value")]
        p[blk + "attn.qkv_kernel"] = torch.cat(qkv, dim=1)
        p[blk + "attn.qkv_bias"] = torch.cat(qkv_b)
        p[blk + "attn.out_kernel"] = get(
            f"{base}/attention/output/dense/kernel")
        p[blk + "attn.out_bias"] = get(f"{base}/attention/output/dense/bias")
        p[blk + "ln1.gamma"] = get(f"{base}/attention/output/LayerNorm/gamma")
        p[blk + "ln1.beta"] = get(f"{base}/attention/output/LayerNorm/beta")
        p[blk + "ffn_in_kernel"] = get(f"{base}/intermediate/dense/kernel")
        p[blk + "ffn_in_bias"] = get(f"{base}/intermediate/dense/bias")
        p[blk + "ffn_out_kernel"] = get(f"{base}/output/dense/kernel")
        p[blk + "ffn_out_bias"] = get(f"{base}/output/dense/bias")
        p[blk + "ln2.gamma"] = get(f"{base}/output/LayerNorm/gamma")
        p[blk + "ln2.beta"] = get(f"{base}/output/LayerNorm/beta")
    want = {k: tuple(v.shape) for k, v in ref.items()}
    got = {k: tuple(v.shape) for k, v in p.items()}
    if want != got:
        raise ValueError("checkpoint shapes do not match the model config")
    return p
