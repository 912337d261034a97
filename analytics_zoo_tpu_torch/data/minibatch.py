"""MiniBatch construction with the reference's padding semantics.

Copied from `analytics_zoo_tpu/data/minibatch.py` (L1-80): `PaddingParam`
(L19), `_pad_to` (L29), `batch_samples` (L40, its `jax.tree_util` calls
the port's `common/tree.py`) and `pad_sequences` (L66).

The reference batches Samples into `MiniBatch`es with optional
`PaddingParam`s (BigDL SampleToMiniBatch, wrapped at
`zoo/.../tfpark/SampleToMiniBatch.scala`, `TFMiniBatch.scala`): features and
labels are (possibly nested) tensor lists; variable-length tensors are padded
to the batch max or to a fixed `paddingLen` with a pad value. On TPU, fixed
padding is the important case — static shapes keep one compiled program
(`hard_code_batch_size` analogue, `tf_dataset.py:158-173`).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Union

import numpy as np

from analytics_zoo_tpu_torch.common.tree import tree_flatten, tree_unflatten


class PaddingParam:
    """Padding spec (BigDL PaddingParam): pad value + optional fixed length
    per dimension (-1 → batch max)."""

    def __init__(self, value: float = 0.0,
                 fixed_length: Optional[Sequence[int]] = None):
        self.value = value
        self.fixed_length = list(fixed_length) if fixed_length else None


def _pad_to(arr: np.ndarray, target_shape: Sequence[int],
            value: float) -> np.ndarray:
    pads = [(0, t - s) for s, t in zip(arr.shape, target_shape)]
    if any(p[1] < 0 for p in pads):
        raise ValueError(
            f"Sample shape {arr.shape} exceeds fixed padding {target_shape}")
    if all(p[1] == 0 for p in pads):
        return arr
    return np.pad(arr, pads, constant_values=value)


def batch_samples(samples: Sequence[Any],
                  padding: Optional[PaddingParam] = None) -> Any:
    """Stack a list of per-sample pytrees into one batched pytree, padding
    ragged tensors (the SampleToMiniBatch contract)."""
    treedef = tree_flatten(samples[0])[1]
    leaves_per_sample = [tree_flatten(s)[0] for s in samples]
    batched = []
    for i in range(len(leaves_per_sample[0])):
        arrs = [np.asarray(ls[i]) for ls in leaves_per_sample]
        shapes = np.array([a.shape for a in arrs])
        if padding is not None and padding.fixed_length is not None:
            target = list(padding.fixed_length)
            for d in range(len(target)):
                if target[d] == -1:
                    target[d] = int(shapes[:, d].max())
        else:
            target = list(shapes.max(axis=0))
        value = padding.value if padding else 0.0
        if not (shapes == shapes[0]).all() or padding is not None:
            arrs = [_pad_to(a, target, value) for a in arrs]
        batched.append(np.stack(arrs))
    return tree_unflatten(treedef, batched)


def pad_sequences(seqs: Sequence[Sequence[int]], maxlen: int,
                  value: int = 0, truncating: str = "post",
                  padding: str = "post", dtype=np.int32) -> np.ndarray:
    """Keras-style sequence padding used by the text pipeline
    (`TextSet.shapeSequence`, `feature/text/TextSet.scala`)."""
    out = np.full((len(seqs), maxlen), value, dtype=dtype)
    for i, s in enumerate(seqs):
        s = list(s)
        if len(s) > maxlen:
            s = s[-maxlen:] if truncating == "pre" else s[:maxlen]
        if padding == "pre":
            out[i, maxlen - len(s):] = s
        else:
            out[i, :len(s)] = s
    return out
