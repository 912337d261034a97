"""Matmul dispatch for raw-matmul layers (transformer blocks, BERT heads).

Port of `analytics_zoo_tpu/serving/quantization.py` `maybe_int8_matmul`
(L83), float path only. The int8 path (`<key>_q` + `<key>_scale` leaves,
`quantize_model_params`, the int8 sidecar) is not yet ported: a module or
tree that holds a `*_q` key raises NotImplementedError.
"""

from __future__ import annotations

from torch import nn, Tensor

INT8_NOT_PORTED = ("int8 serving (`*_q` weights) is not ported yet: it "
                   "comes with the int8 serving slice of the port")


def maybe_int8_matmul(x: Tensor, params: nn.Module, key: str) -> Tensor:
    """`x @ params.<key>`, the weight stored `[in, out]` as in the JAX
    package; `params` is the module that owns it."""
    if hasattr(params, key + "_q"):
        raise NotImplementedError(INT8_NOT_PORTED)
    return x @ getattr(params, key)
