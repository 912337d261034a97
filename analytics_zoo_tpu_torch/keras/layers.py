"""Initializers, activations and the core layers.

Port of the part of `analytics_zoo_tpu/keras/layers.py` that BERT and
NeuralCF use: `get_init` (L44, with the "glorot_uniform", "uniform" and
"zeros" families of L30-41), `get_activation` (L73), `Dense` (L96),
`Activation` (L131), `Flatten` (L156), `Select` (L241), `Merge` (L275, all
seven modes), `merge` (L329), `Embedding` (L338) and `LayerNormalization`
(L456). Initializers match the JAX ones in distribution, not in bits (the
two frameworks draw different numbers from one seed); `"uniform"` is
`jax.nn.initializers.uniform(0.05)`, which draws from [0, 0.05), not
±0.05. `"gelu"` is `jax.nn.gelu`'s default, the tanh approximation — not
torch's erf form. `Dense` keeps its kernel as [in, out], the JAX layout.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.common.device import DeviceLike
from analytics_zoo_tpu_torch.keras.engine import Layer, Node, new_parameter

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
# them (convolutions, recurrent kernels).
_INITS: Dict[str, Init] = {
    "glorot_uniform": _glorot_uniform,
    "uniform": lambda gen, shape: torch.rand(shape, generator=gen) * 0.05,
    "zeros": lambda gen, shape: torch.zeros(shape),
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


def _match_param_dtype(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Float operands follow the parameter's dtype (bf16 under mixed
    precision); integer inputs pass through, since casting float-encoded
    ids to bf16 corrupts values above 256."""
    if x.is_floating_point() and x.dtype != ref.dtype:
        return x.to(ref.dtype)
    return x


class Dense(Layer):
    """`keras/layers/Dense.scala`, on the last axis (any rank). The kernel,
    [in, out], is created at the first call on a node, whose shape gives
    the input width, or at construction when `input_shape` is given."""

    def __init__(self, output_dim: int, activation=None, use_bias: bool = True,
                 init="glorot_uniform", input_shape: Optional[Sequence] = None,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.output_dim = output_dim
        self.activation = get_activation(activation)
        self.use_bias = use_bias
        self.init = get_init(init)
        self._device, self._dtype = device, dtype
        if input_shape is not None:
            self.create_parameters((None,) + tuple(input_shape))
            self._params_created = True

    def create_parameters(self, input_shape):
        self.kernel = new_parameter((input_shape[-1], self.output_dim),
                                    self._device, self._dtype)
        if self.use_bias:
            self.bias = new_parameter((self.output_dim,), self._device,
                                      self._dtype)

    def build(self, generator):
        fill_(self.kernel, self.init(generator, tuple(self.kernel.shape)))
        if self.use_bias:
            fill_(self.bias, torch.zeros(self.bias.shape))
        return self

    def call(self, x, *, training: bool = False):
        y = _match_param_dtype(x, self.kernel) @ self.kernel
        if self.use_bias:
            y = y + self.bias
        return self.activation(y)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)


class Activation(Layer):
    def __init__(self, activation, name: Optional[str] = None):
        super().__init__(name=name)
        self.activation = get_activation(activation)

    def call(self, x, *, training: bool = False):
        return self.activation(x)


class Flatten(Layer):
    def call(self, x, *, training: bool = False):
        return x.reshape(x.shape[0], -1)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], int(np.prod(input_shape[1:])))


class Select(Layer):
    """`keras/layers/Select.scala`: index `index` along `dim`, which goes
    away."""

    def __init__(self, dim: int, index: int, name: Optional[str] = None):
        super().__init__(name=name)
        self.dim, self.index = dim, index

    def call(self, x, *, training: bool = False):
        return x.select(self.dim, self.index)

    def compute_output_shape(self, input_shape):
        s = list(input_shape)
        del s[self.dim]
        return tuple(s)


class Merge(Layer):
    """`keras/layers/Merge.scala`: combine a list of inputs; mode is one of
    sum, mul, ave, max, concat, dot, cos."""

    MODES = ("sum", "mul", "ave", "max", "concat", "dot", "cos")

    def __init__(self, mode: str = "sum", concat_axis: int = -1,
                 name: Optional[str] = None):
        super().__init__(name=name)
        if mode not in self.MODES:
            raise ValueError(f"Unsupported merge mode: {mode}")
        self.mode = mode
        self.concat_axis = concat_axis

    def call(self, xs, *, training: bool = False):
        mode = self.mode
        if mode in ("sum", "mul", "max"):
            out = xs[0]
            for x in xs[1:]:
                out = (out + x if mode == "sum" else
                       out * x if mode == "mul" else torch.maximum(out, x))
            return out
        if mode == "ave":
            return sum(xs) / len(xs)
        if mode == "concat":
            return torch.cat(list(xs), dim=self.concat_axis)
        a, b = xs
        if mode == "cos":
            a = a / torch.clamp(torch.linalg.norm(a, dim=-1, keepdim=True),
                                min=1e-7)
            b = b / torch.clamp(torch.linalg.norm(b, dim=-1, keepdim=True),
                                min=1e-7)
        return torch.sum(a * b, dim=-1, keepdim=True)

    def compute_output_shape(self, input_shapes):
        if self.mode in ("sum", "mul", "ave", "max"):
            return input_shapes[0]
        if self.mode == "concat":
            out = list(input_shapes[0])
            axis = self.concat_axis
            out[axis] = sum(s[axis] for s in input_shapes)
            return tuple(out)
        return (input_shapes[0][0], 1)


def merge(inputs: Sequence[Node], mode: str = "sum", concat_axis: int = -1,
          name: Optional[str] = None) -> Node:
    """Functional helper matching pyzoo's `merge`."""
    return Merge(mode=mode, concat_axis=concat_axis, name=name)(inputs)


class Embedding(Layer):
    """`keras/layers/Embedding.scala`: integer ids → rows of a [input_dim,
    output_dim] table (float ids are cast to integers). `weights` gives the
    table's values at `build`; `trainable=False` keeps it out of the
    gradient."""

    def __init__(self, input_dim: int, output_dim: int, init="uniform",
                 weights: Optional[np.ndarray] = None, trainable: bool = True,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.input_dim, self.output_dim = input_dim, output_dim
        self.init = get_init(init)
        self.weights = weights
        self.trainable = trainable
        self.embeddings = new_parameter((input_dim, output_dim), device,
                                        dtype)

    def build(self, generator):
        if self.weights is not None:
            table = torch.as_tensor(np.asarray(self.weights, np.float32))
            if tuple(table.shape) != (self.input_dim, self.output_dim):
                raise ValueError(
                    f"{self.name}: pretrained weights shape "
                    f"{tuple(table.shape)} != ({self.input_dim}, "
                    f"{self.output_dim})")
        else:
            table = self.init(generator, (self.input_dim, self.output_dim))
        fill_(self.embeddings, table)
        return self

    def call(self, x, *, training: bool = False):
        table = self.embeddings if self.trainable \
            else self.embeddings.detach()
        return F.embedding(torch.as_tensor(x).long(), table)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape) + (self.output_dim,)
