"""TextSet + text preprocessing pipeline.

Copied from `analytics_zoo_tpu/data/text.py` as it is (L1-146):
`TextFeature` (L23), `TextSet` (L33) and `load_glove` (L129).

The reference's distributed text pipeline (`zoo/.../feature/text/
TextSet.scala`, ~800 LoC; python mirror `pyzoo/zoo/feature/text/`):
tokenize → normalize → word2idx → shapeSequence → generateSample, plus
pretrained GloVe embedding loading for `WordEmbedding`. Same stages here as
host-side numpy ops feeding padded int32 batches (static shapes for jit).
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from analytics_zoo_tpu_torch.data.minibatch import pad_sequences

_TOKEN_RE = re.compile(r"[a-zA-Z]+|[0-9]+|[^\sa-zA-Z0-9]")


class TextFeature:
    """One text sample (`feature/text/TextFeature.scala`)."""

    def __init__(self, text: str, label: Optional[int] = None):
        self.text = text
        self.label = label
        self.tokens: Optional[List[str]] = None
        self.indices: Optional[List[int]] = None


class TextSet:
    """Batch of TextFeatures with chained preprocessing
    (`TextSet.scala` tokenize/normalize/word2idx/shapeSequence)."""

    def __init__(self, features: Sequence[TextFeature]):
        self.features = list(features)
        self.word_index: Optional[Dict[str, int]] = None

    @staticmethod
    def from_texts(texts: Sequence[str],
                   labels: Optional[Sequence[int]] = None) -> "TextSet":
        labels = labels if labels is not None else [None] * len(texts)
        return TextSet([TextFeature(t, l) for t, l in zip(texts, labels)])

    @staticmethod
    def read_csv(path: str, text_col: str = "text",
                 label_col: Optional[str] = "label") -> "TextSet":
        import pandas as pd
        df = pd.read_csv(path)
        labels = df[label_col].tolist() if label_col and label_col in df \
            else None
        return TextSet.from_texts(df[text_col].tolist(), labels)

    # -- pipeline stages ---------------------------------------------------
    def tokenize(self) -> "TextSet":
        for f in self.features:
            f.tokens = _TOKEN_RE.findall(f.text)
        return self

    def normalize(self) -> "TextSet":
        """Lower-case + strip non-alphanumeric tokens (`Normalizer`)."""
        for f in self.features:
            if f.tokens is None:
                raise ValueError("normalize() requires tokenize() first")
            f.tokens = [t.lower() for t in f.tokens if t.isalnum()]
        return self

    def word2idx(self, remove_topN: int = 0, max_words_num: int = -1,
                 min_freq: int = 1,
                 existing_map: Optional[Dict[str, int]] = None) -> "TextSet":
        """Build the vocab (1-based; 0 is the pad index) with the reference's
        knobs (`TextSet.scala` word2idx: removeTopN, maxWordsNum, minFreq,
        existingMap)."""
        if existing_map is not None:
            self.word_index = dict(existing_map)
        else:
            counts = Counter()
            for f in self.features:
                if f.tokens is None:
                    raise ValueError("word2idx() requires tokenize() first")
                counts.update(f.tokens)
            ordered = [w for w, c in counts.most_common() if c >= min_freq]
            ordered = ordered[remove_topN:]
            if max_words_num > 0:
                ordered = ordered[:max_words_num]
            self.word_index = {w: i + 1 for i, w in enumerate(ordered)}
        for f in self.features:
            f.indices = [self.word_index[t] for t in (f.tokens or [])
                         if t in self.word_index]
        return self

    def shape_sequence(self, len: int, trunc_mode: str = "pre",  # noqa: A002
                       pad_element: int = 0) -> "TextSet":
        """Fix sequence length (`TextSet.shapeSequence`; default truncation
        keeps the tail, BigDL semantics)."""
        self._seq_len = len
        self._trunc = trunc_mode
        self._pad = pad_element
        return self

    def generate_sample(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Materialize (x, y) arrays."""
        if not hasattr(self, "_seq_len"):
            raise ValueError("call shape_sequence(len) before generate_sample")
        seqs = [f.indices if f.indices is not None else [] for f in self.features]
        x = pad_sequences(seqs, self._seq_len, value=self._pad,
                          truncating=self._trunc)
        labels = [f.label for f in self.features]
        y = None if any(l is None for l in labels) \
            else np.asarray(labels, np.int32)
        return x, y

    def to_dataset(self, batch_size: int = -1, batch_per_thread: int = -1):
        from analytics_zoo_tpu_torch.data.dataset import TPUDataset
        x, y = self.generate_sample()
        return TPUDataset(x, y, batch_size, batch_per_thread)

    def get_word_index(self) -> Dict[str, int]:
        if self.word_index is None:
            raise ValueError("word2idx has not been run")
        return self.word_index

    def __len__(self):
        return len(self.features)


def load_glove(path: str, word_index: Optional[Dict[str, int]] = None,
               dim: int = 100) -> np.ndarray:
    """Load GloVe vectors into an embedding matrix aligned with word_index
    (`WordEmbedding.scala` glove loading). Row 0 is the pad vector."""
    vectors: Dict[str, np.ndarray] = {}
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            parts = line.rstrip().split(" ")
            if len(parts) != dim + 1:
                continue
            vectors[parts[0]] = np.asarray(parts[1:], np.float32)
    if word_index is None:
        word_index = {w: i + 1 for i, w in enumerate(vectors)}
    mat = np.zeros((max(word_index.values()) + 1, dim), np.float32)
    for w, i in word_index.items():
        if w in vectors:
            mat[i] = vectors[w]
    return mat
