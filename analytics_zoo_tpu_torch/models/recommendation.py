"""Recommendation models: NeuralCF, WideAndDeep, SessionRecommender and
the ranking helpers.

Port of `analytics_zoo_tpu/models/recommendation.py`: `UserItemFeature`
(L29), `Recommender` (L37) with `predict_user_item_pair`,
`recommend_for_user` and `recommend_for_item`, `NeuralCF` (L68) with its
`lazy_embedding_specs` (L117-140), `WideAndDeep` (L144-218) and
`SessionRecommender` (L221-279) with `recommend_for_session`. The
architectures are the reference's:

- NeuralCF (`NeuralCF.scala:60-97`): MLP user and item embeddings
  concatenated into a Dense relu stack, and a GMF branch (the product of
  the MF embeddings) concatenated before the softmax.
- WideAndDeep (`wide_and_deep.py:94,140-180`): a linear layer over the
  wide columns (base and crossed, multi-hot) and a deep tower over the
  indicator columns, one embedding a categorical column (`Select`,
  `Embedding(init="uniform")`, `Flatten`) and the continuous columns,
  concatenated into a Dense relu stack that ends in a relu Dense to
  `class_num`; `wide` is the linear part alone, `deep` the tower alone,
  `wide_n_deep` their sum, each into a softmax. It declares no
  `lazy_embedding_specs`, as the JAX model does not. Unlike the JAX model,
  a deep tower without columns and `embed_in_dims` / `embed_out_dims` of
  different lengths raise ValueError (the JAX model raises IndexError for
  the first and drops the columns past the shorter list for the second;
  ROADMAP.md queue 3).
- SessionRecommender (`session_recommender.py:69-94`): a GRU stack over
  the session's item embeddings; with `include_history=True` also an MLP
  over the history's item embeddings summed by an `ops/autograd.Lambda`,
  the two logits summed into the softmax over the items.

Ids are 1-based, so the tables have count + 1 rows.

`device` says where the parameters are created (None is `cuda`; the CPU
only when asked, as everywhere in the port).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.device import DeviceLike
from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.keras.engine import Input, Model
from analytics_zoo_tpu_torch.learn.lazy_embedding import LazyEmbeddingSpec
from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.ops.autograd import Lambda


class UserItemFeature:
    """(user_id, item_id, label) record used by the recommender helpers
    (`pyzoo/zoo/models/recommendation/utils.py`)."""

    def __init__(self, user_id: int, item_id: int, label: int = 0):
        self.user_id, self.item_id, self.label = user_id, item_id, label


class Recommender(ZooModel):
    """Shared ranking helpers (`Recommender` in
    `pyzoo/zoo/models/recommendation/__init__.py`)."""

    def predict_user_item_pair(self, features: Sequence[UserItemFeature],
                               batch_per_thread: int = 32) -> np.ndarray:
        x = np.array([[f.user_id, f.item_id] for f in features], np.int32)
        return self.predict(x, batch_per_thread=batch_per_thread)

    def recommend_for_user(self, features: Sequence[UserItemFeature],
                           max_items: int = 5, batch_per_thread: int = 32):
        """Top-N (item, score) per user from candidate pairs; the score is
        the last class's probability."""
        probs = self.predict_user_item_pair(features, batch_per_thread)
        score = probs[:, -1] if probs.ndim > 1 else probs
        by_user = {}
        for f, s in zip(features, score):
            by_user.setdefault(f.user_id, []).append((f.item_id, float(s)))
        return {u: sorted(items, key=lambda t: -t[1])[:max_items]
                for u, items in by_user.items()}

    def recommend_for_item(self, features: Sequence[UserItemFeature],
                           max_users: int = 5, batch_per_thread: int = 32):
        probs = self.predict_user_item_pair(features, batch_per_thread)
        score = probs[:, -1] if probs.ndim > 1 else probs
        by_item = {}
        for f, s in zip(features, score):
            by_item.setdefault(f.item_id, []).append((f.user_id, float(s)))
        return {i: sorted(users, key=lambda t: -t[1])[:max_users]
                for i, users in by_item.items()}


def _ids_fn(col: int):
    return lambda xb: xb[..., col].to(torch.int32)


def _set_ids_fn(col: int):
    """The write twin of `_ids_fn`, for the fused sparse backward: a copy of
    the batch whose id column reads positions 0..B into the pre-gathered
    rows (B < 2^24, exact even in a float input)."""
    def set_ids(xb, ids):
        out = xb.clone()
        out[..., col] = ids.to(xb.dtype)
        return out
    return set_ids


class NeuralCF(Recommender):
    """Neural Collaborative Filtering (`NeuralCF.scala:60`). Input: [B, 2]
    of (user id, item id)."""

    def __init__(self, user_count: int, item_count: int, class_num: int,
                 user_embed: int = 20, item_embed: int = 20,
                 hidden_layers: Sequence[int] = (40, 20, 10),
                 include_mf: bool = True, mf_embed: int = 20,
                 device: DeviceLike = None):
        super().__init__()
        self._config = dict(user_count=user_count, item_count=item_count,
                            class_num=class_num, user_embed=user_embed,
                            item_embed=item_embed,
                            hidden_layers=list(hidden_layers),
                            include_mf=include_mf, mf_embed=mf_embed)
        self.user_count, self.item_count = user_count, item_count
        self.class_num = class_num
        self.user_embed, self.item_embed = user_embed, item_embed
        self.hidden_layers = list(hidden_layers)
        self.include_mf, self.mf_embed = include_mf, mf_embed
        self.device = device
        self.model = self.build_model()

    def build_model(self) -> Model:
        dev = self.device
        inp = Input(shape=(2,))
        user = L.Select(1, 0)(inp)
        item = L.Select(1, 1)(inp)
        mlp_user = L.Flatten()(
            L.Embedding(self.user_count + 1, self.user_embed, init="uniform",
                        device=dev, name="ncf_mlp_user")(user))
        mlp_item = L.Flatten()(
            L.Embedding(self.item_count + 1, self.item_embed, init="uniform",
                        device=dev, name="ncf_mlp_item")(item))
        x = L.merge([mlp_user, mlp_item], mode="concat")
        for units in self.hidden_layers:
            x = L.Dense(units, activation="relu", device=dev)(x)
        table_names = ["ncf_mlp_user", "ncf_mlp_item"]
        if self.include_mf:
            if self.mf_embed <= 0:
                raise ValueError("include_mf needs mf_embed > 0")
            mf_user = L.Flatten()(
                L.Embedding(self.user_count + 1, self.mf_embed,
                            init="uniform", device=dev,
                            name="ncf_mf_user")(user))
            mf_item = L.Flatten()(
                L.Embedding(self.item_count + 1, self.mf_embed,
                            init="uniform", device=dev,
                            name="ncf_mf_item")(item))
            gmf = L.merge([mf_user, mf_item], mode="mul")
            x = L.merge([x, gmf], mode="concat")
            table_names += ["ncf_mf_user", "ncf_mf_item"]
        out = L.Dense(self.class_num, activation="softmax", device=dev)(x)
        model = Model(inp, out)
        # the tables for the row-sparse optimizer path
        # (`learn/lazy_embedding.py`; Estimator.fit(lazy_embeddings=True))
        col = {"ncf_mlp_user": 0, "ncf_mlp_item": 1,
               "ncf_mf_user": 0, "ncf_mf_item": 1}
        model.lazy_embedding_specs = [
            LazyEmbeddingSpec((n, "embeddings"), _ids_fn(col[n]),
                              set_ids_fn=_set_ids_fn(col[n]))
            for n in table_names]
        return model


class WideAndDeep(Recommender):
    """Wide & Deep (`wide_and_deep.py:94,140-180`). Inputs, in this order
    and as `model_type` has them: wide [B, sum(wide_base_dims) +
    sum(wide_cross_dims)], indicator [B, sum(indicator_dims)], embedding
    ids [B, len(embed_in_dims)] (1-based), continuous
    [B, len(continuous_cols)]; a model with one input takes the array
    itself."""

    def __init__(self, class_num: int, model_type: str = "wide_n_deep",
                 wide_base_dims: Sequence[int] = (),
                 wide_cross_dims: Sequence[int] = (),
                 indicator_dims: Sequence[int] = (),
                 embed_in_dims: Sequence[int] = (),
                 embed_out_dims: Sequence[int] = (),
                 continuous_cols: Sequence[str] = (),
                 hidden_layers: Sequence[int] = (40, 20, 10),
                 device: DeviceLike = None):
        super().__init__()
        self._config = dict(class_num=class_num, model_type=model_type,
                            wide_base_dims=list(wide_base_dims),
                            wide_cross_dims=list(wide_cross_dims),
                            indicator_dims=list(indicator_dims),
                            embed_in_dims=list(embed_in_dims),
                            embed_out_dims=list(embed_out_dims),
                            continuous_cols=list(continuous_cols),
                            hidden_layers=list(hidden_layers))
        self.class_num = class_num
        self.model_type = model_type
        self.wide_dims = sum(wide_base_dims) + sum(wide_cross_dims)
        self.indicator_dims = list(indicator_dims)
        self.embed_in_dims = list(embed_in_dims)
        self.embed_out_dims = list(embed_out_dims)
        self.continuous_cols = list(continuous_cols)
        self.hidden_layers = list(hidden_layers)
        self.device = device
        self.model = self.build_model()

    def _deep_branch(self):
        if len(self.embed_in_dims) != len(self.embed_out_dims):
            raise ValueError(
                f"embed_in_dims has {len(self.embed_in_dims)} columns, "
                f"embed_out_dims {len(self.embed_out_dims)}")
        if not (self.indicator_dims or self.embed_in_dims
                or self.continuous_cols):
            raise ValueError(
                f"model_type {self.model_type!r} needs deep columns: "
                "indicator_dims, embed_in_dims or continuous_cols")
        dev = self.device
        inputs, merged = [], []
        if self.indicator_dims:
            ind = Input(shape=(sum(self.indicator_dims),))
            inputs.append(ind)
            merged.append(ind)
        if self.embed_in_dims:
            emb_in = Input(shape=(len(self.embed_in_dims),))
            inputs.append(emb_in)
            for i, (vin, vout) in enumerate(zip(self.embed_in_dims,
                                                self.embed_out_dims)):
                col = L.Select(1, i)(emb_in)
                merged.append(L.Flatten()(L.Embedding(
                    vin + 1, vout, init="uniform", device=dev)(col)))
        if self.continuous_cols:
            con = Input(shape=(len(self.continuous_cols),))
            inputs.append(con)
            merged.append(con)
        x = merged[0] if len(merged) == 1 else L.merge(merged, mode="concat")
        for units in self.hidden_layers:
            x = L.Dense(units, activation="relu", device=dev)(x)
        # the reference ends the deep tower with a relu Dense to class_num
        # (`wide_and_deep.py:179`)
        out = L.Dense(self.class_num, activation="relu", device=dev)(x)
        return inputs, out

    def build_model(self) -> Model:
        dev = self.device
        if self.model_type == "wide":
            wide = Input(shape=(self.wide_dims,))
            out = L.Activation("softmax")(
                L.Dense(self.class_num, device=dev)(wide))
            return Model(wide, out)
        if self.model_type == "deep":
            inputs, deep = self._deep_branch()
            out = L.Activation("softmax")(deep)
            return Model(inputs if len(inputs) > 1 else inputs[0], out)
        if self.model_type == "wide_n_deep":
            wide = Input(shape=(self.wide_dims,))
            wide_linear = L.Dense(self.class_num, device=dev)(wide)
            inputs, deep = self._deep_branch()
            merged = L.merge([wide_linear, deep], mode="sum")
            out = L.Activation("softmax")(merged)
            return Model([wide] + inputs, out)
        raise TypeError(f"Unsupported model_type: {self.model_type}")


def _sum_over_history(t):
    """The history branch's Lambda: the item embeddings summed over the
    history, [B, H, E] -> [B, E]."""
    return torch.sum(t, dim=1)


class SessionRecommender(Recommender):
    """Session-based GRU recommender (`session_recommender.py:30,69-94`).
    Input: [B, session_length] of 1-based item ids, and with
    `include_history` a list of that and [B, history_length] of the
    user's earlier items; output: a softmax over the `item_count`
    items."""

    def __init__(self, item_count: int, item_embed: int = 100,
                 rnn_hidden_layers: Sequence[int] = (40, 20),
                 session_length: int = 0, include_history: bool = False,
                 mlp_hidden_layers: Sequence[int] = (40, 20),
                 history_length: int = 0, device: DeviceLike = None):
        super().__init__()
        if session_length <= 0:
            raise ValueError("session_length must be positive")
        if include_history and history_length <= 0:
            raise ValueError("history_length must be positive with history")
        self._config = dict(item_count=item_count, item_embed=item_embed,
                            rnn_hidden_layers=list(rnn_hidden_layers),
                            session_length=session_length,
                            include_history=include_history,
                            mlp_hidden_layers=list(mlp_hidden_layers),
                            history_length=history_length)
        self.item_count = item_count
        self.item_embed = item_embed
        self.rnn_hidden_layers = list(rnn_hidden_layers)
        self.session_length = session_length
        self.include_history = include_history
        self.mlp_hidden_layers = list(mlp_hidden_layers)
        self.history_length = history_length
        self.device = device
        self.model = self.build_model()

    def build_model(self) -> Model:
        dev = self.device
        inp = Input(shape=(self.session_length,))
        x = L.Embedding(self.item_count + 1, self.item_embed, init="uniform",
                        device=dev)(inp)
        for units in self.rnn_hidden_layers[:-1]:
            x = L.GRU(units, return_sequences=True, device=dev)(x)
        x = L.GRU(self.rnn_hidden_layers[-1], device=dev)(x)
        rnn_logits = L.Dense(self.item_count, device=dev)(x)
        if not self.include_history:
            return Model(inp, L.Activation("softmax")(rnn_logits))
        inp_mlp = Input(shape=(self.history_length,))
        h = L.Embedding(self.item_count + 1, self.item_embed, init="uniform",
                        device=dev)(inp_mlp)
        h = Lambda(_sum_over_history)(h)
        for units in self.mlp_hidden_layers:
            h = L.Dense(units, activation="relu", device=dev)(h)
        mlp_logits = L.Dense(self.item_count, device=dev)(h)
        merged = L.merge([rnn_logits, mlp_logits], mode="sum")
        return Model([inp, inp_mlp], L.Activation("softmax")(merged))

    def recommend_for_session(self, sessions: np.ndarray, max_items: int = 5,
                              zero_based_label: bool = True):
        """The `max_items` most probable items of each session, as (item,
        probability) pairs; items are 0-based unless `zero_based_label` is
        False."""
        probs = self.predict(sessions)
        top = np.argsort(-probs, axis=-1)[:, :max_items]
        shift = 0 if zero_based_label else 1
        return [list(zip((t + shift).tolist(), probs[i, t].tolist()))
                for i, t in enumerate(top)]
