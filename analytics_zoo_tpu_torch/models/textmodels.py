"""Named-entity, POS and intent models (TFPark's text.keras models).

Port of `analytics_zoo_tpu/models/textmodels.py`: `_char_feature` (L31),
`NER` (L42) with `transitions`, `crf_loss` and `decode`, `SequenceTagger`
(L106) with its alias `POSTagger`, and `IntentEntity` (L159): the same
graphs on the port's layers, the same input and output contracts:

- word ids [B, S]; char ids [B, S, W] (chars a word);
- NER → entity scores [B, S, num_entities];
- SequenceTagger → (pos [B, S, P], chunk [B, S, C]);
- IntentEntity → (intent [B, I], tags [B, S, E]).

NER's CRF head: the model emits scores, and `crf_loss` and `decode` run
`ops/crf.py` over them with the model's `transitions` (a [K, K] numpy
matrix, zeros until set, as in the JAX package) on the device the model
lives on: `emissions` is one forward there whose scores stay there (the
JAX package's `predict` returns them to the host), and the forward
algorithm and the Viterbi recursion run on them in place; only the
decoded paths come back.

`device` says where the parameters are created (None is `cuda`; the CPU
only when asked).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.device import DeviceLike
from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.keras.engine import Input, Model
from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.ops import crf as crf_ops


def _char_feature(chars_in, char_vocab: int, char_emb: int, lstm_dim: int,
                  name: str, device: DeviceLike = None):
    """[B, S, W] → the per-word char BiLSTM feature [B, S, 2·lstm_dim]."""
    emb = L.Embedding(char_vocab, char_emb, name=f"{name}_char_emb",
                      device=device)(chars_in)
    return L.TimeDistributed(
        L.Bidirectional(L.LSTM(lstm_dim, name=f"{name}_char_lstm",
                               device=device)),
        name=f"{name}_char_td")(emb)


class NER(ZooModel):
    """`ner.py:21`: word and char features → 2 BiLSTM taggers → entity
    scores. `crf_mode="reg"` pairs them with a transitions matrix used by
    `crf_loss` and `decode`."""

    def __init__(self, num_entities: int, word_vocab_size: int,
                 char_vocab_size: int, word_length: int = 12,
                 word_emb_dim: int = 100, char_emb_dim: int = 30,
                 tagger_lstm_dim: int = 100, dropout: float = 0.5,
                 crf_mode: str = "reg", device: DeviceLike = None):
        super().__init__()
        if crf_mode not in ("reg", "pad"):
            raise ValueError(f"Unsupported crf_mode: {crf_mode}")
        self._config = dict(num_entities=num_entities,
                            word_vocab_size=word_vocab_size,
                            char_vocab_size=char_vocab_size,
                            word_length=word_length,
                            word_emb_dim=word_emb_dim,
                            char_emb_dim=char_emb_dim,
                            tagger_lstm_dim=tagger_lstm_dim,
                            dropout=dropout, crf_mode=crf_mode)
        self.num_entities = num_entities
        self.crf_mode = crf_mode
        dev = device
        words = Input(shape=(None,))
        chars = Input(shape=(None, word_length))
        w = L.Embedding(word_vocab_size, word_emb_dim, name="word_emb",
                        device=dev)(words)
        c = _char_feature(chars, char_vocab_size, char_emb_dim,
                          char_emb_dim, "ner", dev)
        feats = L.merge([w, c], mode="concat", concat_axis=-1)
        feats = L.Dropout(dropout, name="ner_drop")(feats)
        h = L.Bidirectional(L.LSTM(tagger_lstm_dim, return_sequences=True,
                                   name="tagger1", device=dev))(feats)
        h = L.Bidirectional(L.LSTM(tagger_lstm_dim, return_sequences=True,
                                   name="tagger2", device=dev))(h)
        scores = L.TimeDistributed(
            L.Dense(num_entities, name="tag_dense", device=dev),
            name="tag_td")(h)
        self.model = Model([words, chars], scores)
        self._transitions: Optional[np.ndarray] = None

    @property
    def transitions(self) -> np.ndarray:
        if self._transitions is None:
            self._transitions = np.zeros(
                (self.num_entities, self.num_entities), np.float32)
        return self._transitions

    @transitions.setter
    def transitions(self, v):
        self._transitions = np.asarray(v, np.float32)

    def emissions(self, x) -> torch.Tensor:
        """The tag scores of `x` ([word ids, char ids]) [B, S, K] from one
        inference forward on the model's device, where they stay (float32
        for a bf16 model)."""
        self.model.ensure_built(x)
        device = next(self.model.parameters()).device
        with torch.inference_mode():
            out = self.model([torch.as_tensor(a, device=device) for a in x],
                             training=False)
        return out.float()

    def crf_loss(self, x, tags, mask=None) -> float:
        """The exact CRF NLL of `tags` under the current emissions."""
        return float(crf_ops.crf_loss(self.emissions(x), tags,
                                      self.transitions, mask))

    def decode(self, x, mask=None) -> np.ndarray:
        """Viterbi-decoded tag paths; with zero transitions, the per-step
        argmax of the emissions."""
        tags, _ = crf_ops.viterbi_decode(self.emissions(x),
                                         self.transitions, mask)
        return tags.cpu().numpy()


class SequenceTagger(ZooModel):
    """`pos_tagging.py:21`: 3 stacked BiLSTMs; a softmax pos head and a
    chunk head conditioned on the pos features (nlp-architect's
    chunker)."""

    def __init__(self, num_pos_labels: int, num_chunk_labels: int,
                 word_vocab_size: int, char_vocab_size: Optional[int] = None,
                 word_length: int = 12, feature_size: int = 100,
                 dropout: float = 0.2, classifier: str = "softmax",
                 device: DeviceLike = None):
        super().__init__()
        classifier = classifier.lower()
        if classifier not in ("softmax", "crf"):
            raise ValueError("classifier should be either softmax or crf")
        self._config = dict(num_pos_labels=num_pos_labels,
                            num_chunk_labels=num_chunk_labels,
                            word_vocab_size=word_vocab_size,
                            char_vocab_size=char_vocab_size,
                            word_length=word_length,
                            feature_size=feature_size, dropout=dropout,
                            classifier=classifier)
        dev = device
        words = Input(shape=(None,))
        inputs = [words]
        feats = L.Embedding(word_vocab_size, feature_size, name="word_emb",
                            device=dev)(words)
        if char_vocab_size is not None:
            chars = Input(shape=(None, word_length))
            inputs.append(chars)
            c = _char_feature(chars, char_vocab_size, feature_size // 2,
                              feature_size // 2, "tagger", dev)
            feats = L.merge([feats, c], mode="concat", concat_axis=-1)
        h = feats
        for i in range(3):
            h = L.Bidirectional(L.LSTM(feature_size, return_sequences=True,
                                       name=f"bilstm{i}", device=dev))(h)
            h = L.Dropout(dropout, name=f"drop{i}")(h)
        pos = L.TimeDistributed(
            L.Dense(num_pos_labels, activation="softmax", name="pos_dense",
                    device=dev), name="pos_td")(h)
        merged = L.merge([h, pos], mode="concat", concat_axis=-1)
        chunk = L.TimeDistributed(
            L.Dense(num_chunk_labels, activation="softmax",
                    name="chunk_dense", device=dev), name="chunk_td")(merged)
        self.model = Model(inputs if len(inputs) > 1 else inputs[0],
                           [pos, chunk])


POSTagger = SequenceTagger


class IntentEntity(ZooModel):
    """`intent_extraction.py:21`: joint intent and slots. Char BiLSTM word
    features and word embeddings → a tagger BiLSTM; the intent head pools
    the tagger's states, the entity head tags each step."""

    def __init__(self, num_intents: int, num_entities: int,
                 word_vocab_size: int, char_vocab_size: int,
                 word_length: int = 12, word_emb_dim: int = 100,
                 char_emb_dim: int = 30, char_lstm_dim: int = 30,
                 tagger_lstm_dim: int = 100, dropout: float = 0.2,
                 device: DeviceLike = None):
        super().__init__()
        self._config = dict(num_intents=num_intents,
                            num_entities=num_entities,
                            word_vocab_size=word_vocab_size,
                            char_vocab_size=char_vocab_size,
                            word_length=word_length,
                            word_emb_dim=word_emb_dim,
                            char_emb_dim=char_emb_dim,
                            char_lstm_dim=char_lstm_dim,
                            tagger_lstm_dim=tagger_lstm_dim,
                            dropout=dropout)
        dev = device
        words = Input(shape=(None,))
        chars = Input(shape=(None, word_length))
        w = L.Embedding(word_vocab_size, word_emb_dim, name="word_emb",
                        device=dev)(words)
        c = _char_feature(chars, char_vocab_size, char_emb_dim,
                          char_lstm_dim, "intent", dev)
        feats = L.merge([w, c], mode="concat", concat_axis=-1)
        feats = L.Dropout(dropout, name="in_drop")(feats)
        seq = L.Bidirectional(L.LSTM(tagger_lstm_dim, return_sequences=True,
                                     name="tagger", device=dev))(feats)
        seq = L.Dropout(dropout, name="tag_drop")(seq)
        intent_feat = L.GlobalMaxPooling1D()(seq)
        intent = L.Dense(num_intents, activation="softmax",
                         name="intent_dense", device=dev)(intent_feat)
        tags = L.TimeDistributed(
            L.Dense(num_entities, activation="softmax", name="ent_dense",
                    device=dev), name="ent_td")(seq)
        self.model = Model([words, chars], [intent, tags])
