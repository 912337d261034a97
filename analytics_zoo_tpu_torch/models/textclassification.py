"""TextClassifier: a cnn, lstm or gru encoder over (pretrained) word
embeddings.

Port of `analytics_zoo_tpu/models/textclassification.py`: `TextClassifier`
(L19), the reference's `TextClassifier.scala:43-67`: an `Embedding`, or a
frozen `WordEmbedding` over given weights; the encoder (cnn:
`Convolution1D(encoder_output_dim, 5, relu)` and `GlobalMaxPooling1D`;
lstm or gru: the recurrence's last state); then `Dense(128)`,
`Dropout(0.2)`, relu and `Dense(class_num, softmax)`. `pretrained=True`
without weights rebuilds the frozen structure over a zero matrix, which
a loaded state dict fills.

`device` says where the parameters are created (None is `cuda`; the CPU
only when asked, as everywhere in the port).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from analytics_zoo_tpu_torch.common.device import DeviceLike
from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.keras.engine import Sequential
from analytics_zoo_tpu_torch.models.common import ZooModel


class TextClassifier(ZooModel):
    def __init__(self, class_num: int, embedding_dim: Optional[int] = None,
                 vocab_size: Optional[int] = None,
                 sequence_length: int = 500, encoder: str = "cnn",
                 encoder_output_dim: int = 256,
                 embedding_weights: Optional[np.ndarray] = None,
                 pretrained: bool = False, device: DeviceLike = None):
        super().__init__()
        if embedding_weights is None and (embedding_dim is None
                                          or vocab_size is None):
            raise ValueError("Provide embedding_weights or "
                             "(vocab_size, embedding_dim)")
        self.class_num = class_num
        self.sequence_length = sequence_length
        self.encoder = encoder.lower()
        self.encoder_output_dim = encoder_output_dim
        if embedding_weights is None and pretrained:
            embedding_weights = np.zeros((vocab_size, embedding_dim),
                                         np.float32)
        self.embedding_weights = embedding_weights
        self.vocab_size = vocab_size if embedding_weights is None \
            else embedding_weights.shape[0]
        self.embedding_dim = embedding_dim if embedding_weights is None \
            else embedding_weights.shape[1]
        self._config = dict(class_num=class_num,
                            embedding_dim=int(self.embedding_dim),
                            vocab_size=int(self.vocab_size),
                            sequence_length=sequence_length, encoder=encoder,
                            encoder_output_dim=encoder_output_dim,
                            pretrained=embedding_weights is not None)
        self.device = device
        self.model = self.build_model()

    def build_model(self) -> Sequential:
        dev = self.device
        shape = (self.sequence_length,)
        m = Sequential()
        if self.embedding_weights is not None:
            m.add(L.WordEmbedding(self.embedding_weights, input_shape=shape,
                                  device=dev))
        else:
            m.add(L.Embedding(self.vocab_size, self.embedding_dim,
                              input_shape=shape, device=dev))
        if self.encoder == "cnn":
            m.add(L.Convolution1D(self.encoder_output_dim, 5,
                                  activation="relu", device=dev))
            m.add(L.GlobalMaxPooling1D())
        elif self.encoder == "lstm":
            m.add(L.LSTM(self.encoder_output_dim, device=dev))
        elif self.encoder == "gru":
            m.add(L.GRU(self.encoder_output_dim, device=dev))
        else:
            raise ValueError(f"Unsupported encoder: {self.encoder} "
                             "(use cnn | lstm | gru)")
        m.add(L.Dense(128, device=dev))
        m.add(L.Dropout(0.2))
        m.add(L.Activation("relu"))
        m.add(L.Dense(self.class_num, activation="softmax", device=dev))
        return m
