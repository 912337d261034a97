"""Serving pre-processing: decoding a record field.

Copied from `analytics_zoo_tpu/serving/pre_post.py` (`decode_record_field`,
L56), for the encodings the decode engine takes: the b64 raw codec dict
(`broker.encode_ndarray`) and a nested list. The arrow codec and the b64
image payloads need pyarrow and the image loader of the data layer; they
wait for the serving plane (ROADMAP.md queue 1, item 4) and raise
NotImplementedError here.
"""

from __future__ import annotations

import numpy as np

from analytics_zoo_tpu_torch.serving.broker import decode_ndarray

NOT_PORTED = ("arrow and image record encodings are not ported yet "
              "(ROADMAP.md queue 1, item 4: serving plane)")


def decode_record_field(value) -> np.ndarray:
    """A record field as an ndarray: the b64 raw codec dict, or a nested
    list (as float32, like the JAX package)."""
    if isinstance(value, dict):
        if "b64" in value:
            return decode_ndarray(value)
        if "arrow" in value or "image_b64" in value:
            raise NotImplementedError(NOT_PORTED)
        raise ValueError(f"Unknown record encoding: {sorted(value)}")
    if isinstance(value, (bytes, bytearray)):
        raise NotImplementedError(NOT_PORTED)
    return np.asarray(value, np.float32)
