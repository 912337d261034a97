"""KNRM: the kernel-pooling neural ranking model for text matching.

Port of `analytics_zoo_tpu/models/textmatching.py`: `KNRM` (L25), the
reference's `models/textmatching/KNRM.scala:75-103`, on `Ranker`
(`models/common.py`) for NDCG and MAP. It takes the concatenation [B, L1 +
L2] of query and document ids (one embedding, sliced, shares its weights
between the two), computes the translation matrix by a batched product,
applies `kernel_num` RBF kernels (means spaced over [-1, 1], the
exact-match kernel's sigma at 1.0), log-sum pools them, and scores with a
Dense(1) head: sigmoid for classification, linear for ranking (with the
`rank_hinge` loss). The kernel pooling is a `Lambda` (JAX L71-84).

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
from analytics_zoo_tpu_torch.models.common import Ranker, ZooModel
from analytics_zoo_tpu_torch.ops.autograd import Lambda


class KNRM(ZooModel, Ranker):
    def __init__(self, text1_length: int, text2_length: int,
                 vocab_size: Optional[int] = None,
                 embed_size: int = 300,
                 embed_weights: Optional[np.ndarray] = None,
                 train_embed: bool = True, kernel_num: int = 21,
                 sigma: float = 0.1, exact_sigma: float = 0.001,
                 target_mode: str = "ranking", device: DeviceLike = None):
        super().__init__()
        if kernel_num < 2:
            raise ValueError("kernel_num must be >= 2")
        if target_mode not in ("ranking", "classification"):
            raise ValueError(f"Unsupported target_mode: {target_mode}")
        self.text1_length = text1_length
        self.text2_length = text2_length
        self.embed_weights = embed_weights
        self.vocab_size = vocab_size if embed_weights is None \
            else embed_weights.shape[0]
        self.embed_size = embed_size if embed_weights is None \
            else embed_weights.shape[1]
        # the derived sizes, so a KNRM built over weights reloads (the
        # Embedding is the same either way; the checkpoint's weights
        # overwrite the fresh init)
        self._config = dict(text1_length=text1_length,
                            text2_length=text2_length,
                            vocab_size=int(self.vocab_size),
                            embed_size=int(self.embed_size),
                            train_embed=train_embed, kernel_num=kernel_num,
                            sigma=sigma, exact_sigma=exact_sigma,
                            target_mode=target_mode)
        self.train_embed = train_embed
        self.kernel_num = kernel_num
        self.sigma = sigma
        self.exact_sigma = exact_sigma
        self.target_mode = target_mode
        self.device = device
        self.model = self.build_model()

    def build_model(self) -> Model:
        len1, len2 = self.text1_length, self.text2_length
        kernel_num = self.kernel_num
        sigma, exact_sigma = self.sigma, self.exact_sigma

        inp = Input(shape=(len1 + len2,))
        embed = L.Embedding(self.vocab_size, self.embed_size,
                            weights=self.embed_weights,
                            trainable=self.train_embed,
                            device=self.device)(inp)

        def kernel_pooling(e):
            q = e[:, :len1]                         # [B, L1, D]
            d = e[:, len1:]                         # [B, L2, D]
            mm = torch.einsum("bld,bmd->blm", q, d)   # translation matrix
            feats = []
            for i in range(kernel_num):
                mu = 1.0 / (kernel_num - 1) + (2.0 * i) / (kernel_num - 1) \
                    - 1.0
                s = sigma
                if mu > 1.0:  # the exact-match kernel (`KNRM.scala:87-90`)
                    mu, s = 1.0, exact_sigma
                mm_exp = torch.exp(-0.5 * (mm - mu) ** 2 / (s * s))
                mm_doc_sum = mm_exp.sum(dim=2)              # [B, L1]
                mm_log = torch.log(mm_doc_sum + 1.0)
                feats.append(mm_log.sum(dim=1))             # [B]
            return torch.stack(feats, dim=1)                # [B, K]

        phi = Lambda(kernel_pooling)(embed)
        activation = None if self.target_mode == "ranking" else "sigmoid"
        out = L.Dense(1, init="uniform", activation=activation,
                      device=self.device)(phi)
        return Model(inp, out)
