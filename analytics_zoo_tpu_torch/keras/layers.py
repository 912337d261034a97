"""Initializers, activations and LayerNormalization.

Port of the part of `analytics_zoo_tpu/keras/layers.py` that BERT uses:
`get_init` (L44), `get_activation` (L73) and `LayerNormalization` (L456).
Initializers match the JAX ones in distribution, not in bits (the two
frameworks draw different numbers from one seed). `"gelu"` is
`jax.nn.gelu`'s default, the tanh approximation — not torch's erf form.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.common.device import DeviceLike
from analytics_zoo_tpu_torch.keras.engine import Layer, new_parameter

Init = Callable[[torch.Generator, tuple], torch.Tensor]


def _fans(shape):
    if len(shape) < 2:
        return shape[0] if shape else 1, shape[0] if shape else 1
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def _uniform(gen, shape, limit):
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * limit


def _glorot_uniform(gen, shape):
    fan_in, fan_out = _fans(shape)
    return _uniform(gen, shape, math.sqrt(6.0 / (fan_in + fan_out)))


# The rest of the JAX package's initializers come with the layers that use
# them (Dense, Embedding, convolutions, recurrent kernels).
_INITS: Dict[str, Init] = {
    "glorot_uniform": _glorot_uniform,
}


def get_init(name_or_fn) -> Init:
    """`init(generator, shape) -> f32 CPU tensor`."""
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if key not in _INITS:
        raise ValueError(f"Unsupported initializer: {name_or_fn}")
    return _INITS[key]


def fill_(param: torch.Tensor, value: torch.Tensor) -> None:
    """Copy an init drawn on the CPU into a parameter on any device."""
    with torch.no_grad():
        param.copy_(value.to(dtype=param.dtype))


_ACTIVATIONS: Dict[str, Callable] = {
    "relu": F.relu,
    "relu6": F.relu6,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "hard_sigmoid": lambda x: F.relu6(x + 3.0) / 6.0,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "log_softmax": lambda x: torch.log_softmax(x, dim=-1),
    "softplus": F.softplus,
    "softsign": F.softsign,
    "elu": F.elu,
    "selu": F.selu,
    # jax.nn.gelu defaults to approximate=True
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "swish": F.silu,
    "silu": F.silu,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "linear": lambda x: x,
}


def get_activation(name_or_fn) -> Callable:
    if name_or_fn is None:
        return lambda x: x
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if key not in _ACTIVATIONS:
        raise ValueError(f"Unsupported activation: {name_or_fn}")
    return _ACTIVATIONS[key]


class LayerNormalization(Layer):
    """BERT-style layer norm over the last axis: population variance,
    epsilon 1e-12 (JAX L456-474). The port needs the normalised width at
    construction, where the JAX layer reads it from the input shape."""

    def __init__(self, dim: int, epsilon: float = 1e-12,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.epsilon = epsilon
        self.gamma = new_parameter((dim,), device, dtype)
        self.beta = new_parameter((dim,), device, dtype)

    def build(self, generator):
        fill_(self.gamma, torch.ones(self.gamma.shape))
        fill_(self.beta, torch.zeros(self.beta.shape))
        return self

    def call(self, x, *, training: bool = False):
        return F.layer_norm(x, self.gamma.shape, self.gamma, self.beta,
                            self.epsilon)
