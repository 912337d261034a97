"""Initializers, activations and the core layers.

Port of the part of `analytics_zoo_tpu/keras/layers.py` that BERT,
NeuralCF, the image models and the recurrent models use: `get_init` (L44,
with the whole table of L30-41), `get_activation` (L73), `Dense` (L96),
`Activation` (L131), `Dropout` (L140), `Flatten` (L156), `Reshape` (L164),
`Permute` (L184), `RepeatVector` (L198), `Squeeze` (L210), `ExpandDim`
(L227), `Select` (L241), `Narrow` (L257),
`Merge` (L275, all seven modes), `merge` (L329), `Embedding` (L338),
`WordEmbedding` (L380), `BatchNormalization` (L392), `LayerNormalization`
(L456), the convolutions and pools of L479-704 (`_to_channels_last`,
`_from_channels_last`, `_ConvND` with `Convolution1D/2D/3D` and their
`Conv*D` aliases, `_PoolND` with `MaxPooling1D/2D` and
`AveragePooling1D/2D`, `_GlobalPool` with its four subclasses),
`ZeroPadding2D` (L706), `UpSampling2D` (L727), the recurrent layers of
L753-928 (`_Recurrent`, `SimpleRNN`, `LSTM`, `GRU` (both reset forms),
`Bidirectional` and `TimeDistributed`) and, as L944 does, every layer of
`keras/layers_ext.py` in this namespace. Initializers
match the JAX ones in distribution, not in bits (the two frameworks draw
different numbers from one seed); `"uniform"` is
`jax.nn.initializers.uniform(0.05)`, which draws from [0, 0.05), not
±0.05. `"gelu"` is `jax.nn.gelu`'s default, the tanh approximation — not
torch's erf form. `Dense` keeps its kernel as [in, out], the JAX layout.
`Dense`, `Embedding` and `_ConvND` take the int8 path of the JAX layers
(L117, L366, L532) when their module holds the quantized form of the
weight (`kernel_q` / `embeddings_q` buffers with their scales,
`serving/quantization.py`): an int8 product, a per-row dequantizing
gather, and a weight-only int8 convolution in bf16 (the port's `kernel_q`
is OIHW, scaled over O, where the JAX one is HWIO).

The recurrences are PyTorch ops in a Python loop over time, as the JAX
package's are `lax.scan`s outside any Pallas kernel. They cannot go to
cuDNN's RNNs: the default inner activation is `hard_sigmoid`, not the
sigmoid cuDNN fixes, and the default GRU applies its reset gate before the
recurrent product.

Images stay channels-last (NHWC) at the API, as in the JAX package
(`dim_ordering="th"` takes NCHW). Inside a convolution or a pool,
`x.permute(0, 3, 1, 2)` of a contiguous NHWC tensor is an NCHW view in
PyTorch's `channels_last` memory format, which cuDNN takes without a copy;
the output, channels_last too, is permuted back to an NHWC view. A
convolution's kernel is stored `[out, in / groups, *window]` (PyTorch's
OIHW, 2-D kernels in `channels_last` memory), where the JAX package keeps
HWIO; `convert` transposes between the two. `"same"` padding is XLA's:
per spatial axis `total = max((ceil(n / s) - 1)·s + k - n, 0)`, `total // 2`
before and the rest after, so a stride-2 window on an even size pads
(0, 1) and the 7×7/2 stem on 224 pads (2, 3). PyTorch's `padding=` is
symmetric, so an uneven pair is padded explicitly first (zeros for a
convolution and an average, −inf for a max). The computations are
cuDNN's and PyTorch's: the JAX package runs them outside any Pallas kernel
(`lax.conv_general_dilated`, `reduce_window`, `jnp`).

`BatchNormalization` keeps the JAX numerics: normalisation by the batch's
biased variance in training, `moving = momentum·moving + (1 −
momentum)·batch statistic` with the biased variance too (PyTorch's own
running variance is unbiased and its momentum weighs the new value), and
epsilon 1e-3. The moving statistics are buffers (`keras/engine.py`).
"""

from __future__ import annotations

import copy
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.common.device import DeviceLike, resolve_device
from analytics_zoo_tpu_torch.keras.engine import (Layer, Node, merge_state,
                                                  new_parameter)
from analytics_zoo_tpu_torch.kernels.dropout import fused_dropout
from analytics_zoo_tpu_torch.serving.quantization import (dequantize_rows,
                                                          int8_conv,
                                                          int8_matmul)

Init = Callable[[torch.Generator, tuple], torch.Tensor]


def _fans(shape):
    if len(shape) < 2:
        return shape[0] if shape else 1, shape[0] if shape else 1
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def _uniform(gen, shape, limit):
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * limit


# the standard deviation of N(0, 1) truncated to (-2, 2)
_TRUNCATED_STD = 0.87962566103423978


def _truncated_normal(gen, shape):
    """N(0, 1) truncated to (-2, 2), by the inverse CDF of a uniform draw
    (the method of `jax.random.truncated_normal`)."""
    lo, hi = (math.erf(b / math.sqrt(2.0)) for b in (-2.0, 2.0))
    u = lo + (hi - lo) * torch.rand(shape, generator=gen)
    return (math.sqrt(2.0) * torch.erfinv(u)).clamp_(-2.0, 2.0)


def _variance_scaling(scale: float, mode: str, distribution: str) -> Init:
    """`jax.nn.initializers.variance_scaling` (fans from the last two axes
    and the window before them)."""
    def init(gen, shape):
        fan_in, fan_out = _fans(shape)
        denom = fan_in if mode == "fan_in" else (fan_in + fan_out) / 2
        if distribution == "uniform":
            return _uniform(gen, shape, math.sqrt(3.0 * scale / denom))
        return _truncated_normal(gen, shape) * (math.sqrt(scale / denom)
                                                / _TRUNCATED_STD)
    return init


def _orthogonal(gen, shape):
    """`jax.nn.initializers.orthogonal()`: the last axis holds the columns;
    a [rows, cols] matrix has orthonormal columns when rows >= cols, else
    orthonormal rows (a recurrent kernel [H, n·H]: orthonormal rows). Q of
    the QR of a Gaussian matrix, its columns' signs set by R's diagonal."""
    if len(shape) < 2:
        raise ValueError("orthogonal initializer requires at least a 2D "
                         "shape")
    cols = shape[-1]
    rows = math.prod(shape) // cols
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=gen)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    return (q.T if rows < cols else q).reshape(shape).contiguous()


# the JAX package's table (`keras/layers.py:30-41`); they match it in
# distribution, not in bits
_INITS: Dict[str, Init] = {
    "glorot_uniform": _variance_scaling(1.0, "fan_avg", "uniform"),
    "glorot_normal": _variance_scaling(1.0, "fan_avg", "truncated_normal"),
    "he_normal": _variance_scaling(2.0, "fan_in", "truncated_normal"),
    "he_uniform": _variance_scaling(2.0, "fan_in", "uniform"),
    "lecun_normal": _variance_scaling(1.0, "fan_in", "truncated_normal"),
    "orthogonal": _orthogonal,
    "zeros": lambda gen, shape: torch.zeros(shape),
    "ones": lambda gen, shape: torch.ones(shape),
    "uniform": lambda gen, shape: torch.rand(shape, generator=gen) * 0.05,
    "normal": lambda gen, shape: torch.randn(shape, generator=gen) * 0.05,
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
    # jax.nn.hard_sigmoid, relu6(x + 3) / 6, in one pass (x / 6 + 1/2
    # clamped to [0, 1]; a bf16 input rounds once, where JAX rounds twice)
    "hard_sigmoid": F.hardsigmoid,
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
        super().__init__(name=name, input_shape=input_shape)
        self.output_dim = output_dim
        self.activation = get_activation(activation)
        self.use_bias = use_bias
        self.init = get_init(init)
        self._device, self._dtype = device, dtype
        if self.input_shape is not None:
            self.ensure_parameters(self.input_shape)

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
        if hasattr(self, "kernel_q"):   # int8 serving (serving/quantization)
            y = int8_matmul(x, self.kernel_q, self.kernel_scale)
        else:
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


class Dropout(Layer):
    """`keras/layers/Dropout.scala`: inverted dropout, active only in
    training, on the dropout kernel (`kernels/dropout.py`). The seed is the
    one its `Model` hands this node: an int, or in a training step a
    `kernels.philox.DeviceSeed`, which the kernel reads on the card."""

    def __init__(self, p: float, name: Optional[str] = None):
        super().__init__(name=name)
        self.rate = float(p)

    def call(self, x, *, training: bool = False,
             seed: Optional[int] = None):
        if not training or self.rate <= 0.0:
            return x
        if seed is None:
            raise ValueError(f"{self.name}: dropout in training needs a seed")
        return fused_dropout(x, self.rate, seed=seed)

    def call_and_state(self, x, *, training: bool = False,
                       seed: Optional[int] = None):
        return self.call(x, training=training, seed=seed), {}


class Flatten(Layer):
    def call(self, x, *, training: bool = False):
        return x.reshape(x.shape[0], -1)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], int(np.prod(input_shape[1:])))


class Reshape(Layer):
    """`keras/layers/Reshape.scala`: the target shape excludes the batch;
    one -1 is allowed."""

    def __init__(self, target_shape: Sequence[int],
                 input_shape: Optional[Sequence] = None,
                 name: Optional[str] = None):
        super().__init__(name=name, input_shape=input_shape)
        self.target_shape = tuple(target_shape)

    def call(self, x, *, training: bool = False):
        return x.reshape((x.shape[0],) + self.target_shape)

    def compute_output_shape(self, input_shape):
        known = int(np.prod(input_shape[1:]))
        tgt = list(self.target_shape)
        if -1 in tgt:
            tgt[tgt.index(-1)] = known // int(-np.prod(tgt))
        return (input_shape[0],) + tuple(tgt)


class Permute(Layer):
    """Dims are 1-indexed over the non-batch axes (the Keras contract)."""

    def __init__(self, dims: Sequence[int], name: Optional[str] = None):
        super().__init__(name=name)
        self.dims = tuple(dims)

    def call(self, x, *, training: bool = False):
        return x.permute((0,) + self.dims)

    def compute_output_shape(self, input_shape):
        return (input_shape[0],) + tuple(input_shape[d] for d in self.dims)


class RepeatVector(Layer):
    def __init__(self, n: int, name: Optional[str] = None):
        super().__init__(name=name)
        self.n = n

    def call(self, x, *, training: bool = False):
        return x[:, None, :].expand(-1, self.n, -1)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], self.n, input_shape[1])


class Squeeze(Layer):
    """`keras/layers/Squeeze.scala`: drop axis `dim` (counted with the
    batch, as the JAX layer counts it) of size 1."""

    def __init__(self, dim: int, name: Optional[str] = None):
        super().__init__(name=name)
        self.dim = dim

    def call(self, x, *, training: bool = False):
        if x.shape[self.dim] != 1:
            raise ValueError(f"{self.name}: cannot squeeze axis {self.dim} "
                             f"of size {x.shape[self.dim]}")
        return x.squeeze(self.dim)

    def compute_output_shape(self, input_shape):
        s = list(input_shape)
        del s[self.dim]
        return tuple(s)


class ExpandDim(Layer):
    def __init__(self, dim: int, name: Optional[str] = None):
        super().__init__(name=name)
        self.dim = dim

    def call(self, x, *, training: bool = False):
        return x.unsqueeze(self.dim)

    def compute_output_shape(self, input_shape):
        s = list(input_shape)
        s.insert(self.dim, 1)
        return tuple(s)


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


class Narrow(Layer):
    """`keras/layers/Narrow.scala`: `length` elements from `offset` along
    `dim`."""

    def __init__(self, dim: int, offset: int, length: int = 1,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.dim, self.offset, self.length = dim, offset, length

    def call(self, x, *, training: bool = False):
        return x.narrow(self.dim, self.offset, self.length)

    def compute_output_shape(self, input_shape):
        s = list(input_shape)
        s[self.dim] = self.length
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
                 input_shape: Optional[Sequence] = None,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 name: Optional[str] = None):
        super().__init__(name=name, input_shape=input_shape)
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
        ids = torch.as_tensor(x).long()
        if hasattr(self, "embeddings_q"):   # int8 serving
            return dequantize_rows(self.embeddings_q, self.embeddings_scale,
                                   ids)
        table = self.embeddings if self.trainable \
            else self.embeddings.detach()
        return F.embedding(ids, table)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape) + (self.output_dim,)


class WordEmbedding(Embedding):
    """`keras/layers/WordEmbedding.scala`: a frozen `Embedding` over a given
    [vocab, dim] matrix. The table stays a parameter, with a zero gradient
    (JAX: `stop_gradient`), so an optimizer without weight decay leaves it
    as it is."""

    def __init__(self, embedding_matrix: np.ndarray, **kw):
        vocab, dim = np.shape(embedding_matrix)
        super().__init__(vocab, dim, weights=np.asarray(embedding_matrix),
                         trainable=False, **kw)


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------
class BatchNormalization(Layer):
    """`keras/layers/BatchNormalization.scala` over `axis` (-1: the last,
    channels-last; 1: channels-first). `gamma` and `beta` are parameters;
    `moving_mean` and `moving_var` are buffers, updated by a training
    forward (`call_and_state`, then `merge_state`) and read by inference.
    Sizes come from the input at the first call on a node, or from
    `input_shape` (batch excluded)."""

    stateful = True

    def __init__(self, epsilon: float = 1e-3, momentum: float = 0.99,
                 axis: int = -1, input_shape: Optional[Sequence] = None,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 name: Optional[str] = None):
        super().__init__(name=name, input_shape=input_shape)
        self.epsilon, self.momentum, self.axis = epsilon, momentum, axis
        self._device, self._dtype = device, dtype
        if self.input_shape is not None:
            self.ensure_parameters(self.input_shape)

    def create_parameters(self, input_shape):
        dim = input_shape[self.axis]
        self.gamma = new_parameter((dim,), self._device, self._dtype)
        self.beta = new_parameter((dim,), self._device, self._dtype)
        kw = dict(device=resolve_device(self._device), dtype=self._dtype)
        self.register_buffer("moving_mean", torch.zeros(dim, **kw))
        self.register_buffer("moving_var", torch.ones(dim, **kw))

    def build(self, generator):
        fill_(self.gamma, torch.ones(self.gamma.shape))
        fill_(self.beta, torch.zeros(self.beta.shape))
        fill_(self.moving_mean, torch.zeros(self.moving_mean.shape))
        fill_(self.moving_var, torch.ones(self.moving_var.shape))
        return self

    def _norm_axis(self, ndim: int) -> int:
        return self.axis % ndim

    def call_and_state(self, x, *, training: bool = False,
                       seed: Optional[int] = None):
        """`(y, {"moving_mean": ..., "moving_var": ...})` in training (the
        updates in the parameters' dtype: bf16 under mixed precision, from
        the bf16-cast statistics, as the JAX step computes them), `(y, {})`
        otherwise."""
        x = _match_param_dtype(x, self.gamma)
        axis = self._norm_axis(x.dim())
        xc = x.movedim(axis, 1)
        if not training:
            y = F.batch_norm(xc, self.moving_mean.to(x.dtype),
                             self.moving_var.to(x.dtype), self.gamma,
                             self.beta, training=False, eps=self.epsilon)
            return y.movedim(1, axis), {}
        # one pass gives the output and the batch's statistics: the mean
        # and 1/√(var + ε), var biased (the running statistics PyTorch
        # would keep are not asked for)
        y, mean, invstd = torch.native_batch_norm(
            xc, self.gamma, self.beta, None, None, True, 0.0, self.epsilon)
        with torch.no_grad():
            var = invstd.float().pow(-2) - self.epsilon
            dt = self.gamma.dtype
            # the JAX package's Python floats become weak-typed constants
            # of the statistics' dtype: round them to it first
            keep = float(torch.tensor(self.momentum, dtype=dt))
            new = float(torch.tensor(1.0 - self.momentum, dtype=dt))
            updates = {
                "moving_mean": self.moving_mean.to(dt) * keep
                + mean.to(dt) * new,
                "moving_var": self.moving_var.to(dt) * keep
                + var.to(dt) * new}
        return y.movedim(1, axis), updates

    def call(self, x, *, training: bool = False):
        """The forward of the layer on its own: a training call writes its
        updates into its buffers, as `F.batch_norm` does."""
        y, updates = self.call_and_state(x, training=training)
        merge_state(self, {"": updates} if updates else {})
        return y


# ---------------------------------------------------------------------------
# Convolutions & pooling (channels-last at the API)
# ---------------------------------------------------------------------------
def _channels_first(x, dim_ordering: str, spatial_rank: int):
    """The NC... view PyTorch's convolutions and pools take."""
    return x if dim_ordering == "th" else x.movedim(spatial_rank + 1, 1)


def _to_channels_last(x, dim_ordering: str, spatial_rank: int):
    """An NC... input ("th") as the N...C view the layer computes on."""
    return x.movedim(1, spatial_rank + 1) if dim_ordering == "th" else x


def _from_channels_last(x, dim_ordering: str, spatial_rank: int):
    """Inverse of `_to_channels_last`."""
    return x.movedim(spatial_rank + 1, 1) if dim_ordering == "th" else x


def _spatial_out(size, k: int, s: int, padding: str):
    if size is None:
        return None
    if padding == "SAME":
        return -(-size // s)
    return (size - k) // s + 1


def _same_pads(sizes, window, strides) -> List[Tuple[int, int]]:
    """XLA's "SAME" padding, (before, after) per spatial axis."""
    pads = []
    for n, k, s in zip(sizes, window, strides):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pad_arg(pads) -> List[int]:
    """(before, after) pairs in axis order → `F.pad`'s last-axis-first
    list."""
    return [v for pair in reversed(pads) for v in pair]


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


class _ConvND(Layer):
    """N-d convolution, channels-last at the API unless `dim_ordering` is
    "th". The kernel, `[nb_filter, in / groups, *kernel_size]`, is created
    at the first call on a node (or from `input_shape`)."""

    spatial_rank = 2

    def __init__(self, nb_filter: int, kernel_size: Sequence[int],
                 activation=None, subsample: Optional[Sequence[int]] = None,
                 border_mode: str = "valid", dim_ordering: str = "tf",
                 use_bias: bool = True, init="glorot_uniform",
                 groups: int = 1, input_shape: Optional[Sequence] = None,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 name: Optional[str] = None):
        super().__init__(name=name, input_shape=input_shape)
        self.nb_filter = nb_filter
        self.kernel_size = tuple(kernel_size)
        self.activation = get_activation(activation)
        self.strides = tuple(subsample or (1,) * self.spatial_rank)
        if border_mode not in ("valid", "same"):
            raise ValueError(f"Unsupported border_mode: {border_mode}")
        self.padding = border_mode.upper()
        self.dim_ordering = dim_ordering
        self.use_bias = use_bias
        self.init = get_init(init)
        self.groups = int(groups)
        # rhs dilation: 1 here, the atrous rate in `AtrousConvolution*D`
        self.dilation = (1,) * self.spatial_rank
        self._device, self._dtype = device, dtype
        if self.input_shape is not None:
            self.ensure_parameters(self.input_shape)

    def _window(self) -> Tuple[int, ...]:
        """The dilated window, which "same" padding and the output size
        follow."""
        return tuple((k - 1) * r + 1 for k, r in
                     zip(self.kernel_size, self.dilation))

    def create_parameters(self, input_shape):
        in_ch = input_shape[1] if self.dim_ordering == "th" \
            else input_shape[-1]
        if in_ch % self.groups or self.nb_filter % self.groups:
            raise ValueError(
                f"groups={self.groups} must divide in_ch={in_ch} and "
                f"nb_filter={self.nb_filter}")
        self.kernel = new_parameter(
            (self.nb_filter, in_ch // self.groups) + self.kernel_size,
            self._device, self._dtype)
        if self.spatial_rank == 2:
            self.kernel.data = self.kernel.data.contiguous(
                memory_format=torch.channels_last)
        if self.use_bias:
            self.bias = new_parameter((self.nb_filter,), self._device,
                                      self._dtype)

    def build(self, generator):
        # drawn in the JAX layout (HWIO: fans from the window, in and out)
        r = self.spatial_rank
        hwio = self.init(generator, self.kernel_size + (
            self.kernel.shape[1], self.nb_filter))
        fill_(self.kernel, hwio.permute(r + 1, r, *range(r)))
        if self.use_bias:
            fill_(self.bias, torch.zeros(self.bias.shape))
        return self

    def call(self, x, *, training: bool = False):
        if not x.is_floating_point():
            # raw integer images are refused, not trained on as 0-255
            raise TypeError(f"{self.name}: convolution input must be a "
                            f"float tensor, got {x.dtype}")
        int8 = hasattr(self, "kernel_q")     # int8 serving, weight-only
        x = _channels_first(x if int8 else _match_param_dtype(x, self.kernel),
                            self.dim_ordering, self.spatial_rank)
        padding: Any = 0
        if self.padding == "SAME":
            pads = _same_pads(x.shape[2:], self._window(), self.strides)
            if all(lo == hi for lo, hi in pads):
                padding = tuple(lo for lo, _ in pads)
            else:
                x = F.pad(x, _pad_arg(pads))
        conv = _CONV[self.spatial_rank]
        if int8:
            y = int8_conv(x, self.kernel_q, self.kernel_scale, conv,
                          stride=self.strides, padding=padding,
                          groups=self.groups)
            if self.use_bias:       # f32, after the bf16 convolution
                y = y + self.bias.reshape((-1,) + (1,) * self.spatial_rank)
        else:
            y = conv(x, self.kernel, self.bias if self.use_bias else None,
                     stride=self.strides, padding=padding,
                     dilation=self.dilation, groups=self.groups)
        # the activation runs channels-last, as in the JAX package (softmax
        # takes the last axis)
        y = self.activation(y.movedim(1, -1))
        return y.movedim(-1, 1) if self.dim_ordering == "th" else y

    def compute_output_shape(self, input_shape):
        th = self.dim_ordering == "th"
        spatial = input_shape[2:] if th else input_shape[1:-1]
        out = tuple(_spatial_out(d, k, s, self.padding) for d, k, s in
                    zip(spatial, self._window(), self.strides))
        if th:
            return (input_shape[0], self.nb_filter) + out
        return (input_shape[0],) + out + (self.nb_filter,)


class Convolution2D(_ConvND):
    """`keras/layers/Convolution2D.scala`."""

    def __init__(self, nb_filter, nb_row, nb_col, **kw):
        super().__init__(nb_filter, (nb_row, nb_col), **kw)


class Convolution1D(_ConvND):
    spatial_rank = 1

    def __init__(self, nb_filter, filter_length, **kw):
        super().__init__(nb_filter, (filter_length,), **kw)


class Convolution3D(_ConvND):
    spatial_rank = 3

    def __init__(self, nb_filter, kernel_dim1, kernel_dim2, kernel_dim3,
                 **kw):
        super().__init__(nb_filter, (kernel_dim1, kernel_dim2, kernel_dim3),
                         **kw)


# keras2-flavoured aliases (`keras2/layers/`)
Conv1D = Convolution1D
Conv2D = Convolution2D
Conv3D = Convolution3D


_POOLS = {2: (F.max_pool2d, F.avg_pool2d), 3: (F.max_pool3d, F.avg_pool3d)}


class _PoolND(Layer):
    """Max or average pooling over 1, 2 or 3 spatial axes. Under "same"
    the max pads with −inf and the average divides each window's sum by its
    count of real elements (the JAX package's two `reduce_window`s). A 1-d
    pool runs as a 2-d one over a unit height."""

    spatial_rank = 2
    reducer = "max"

    def __init__(self, pool_size=None, strides=None, border_mode="valid",
                 dim_ordering="tf", name: Optional[str] = None):
        super().__init__(name=name)
        self.pool_size = tuple(pool_size or (2,) * self.spatial_rank)
        self.strides = tuple(strides or self.pool_size)
        self.padding = border_mode.upper()
        self.dim_ordering = dim_ordering

    def call(self, x, *, training: bool = False):
        r = self.spatial_rank
        xc = _channels_first(x, self.dim_ordering, r)
        window, strides = self.pool_size, self.strides
        if r == 1:
            xc, window, strides = xc.unsqueeze(2), (1,) + window, \
                (1,) + strides
        pads = _same_pads(xc.shape[2:], window, strides) \
            if self.padding == "SAME" else [(0, 0)] * len(window)
        flat = _pad_arg(pads)
        max_pool, avg_pool = _POOLS[len(window)]
        if self.reducer == "max":
            if any(flat):
                xc = F.pad(xc, flat, value=float("-inf"))
            y = max_pool(xc, window, strides)
        else:
            ones = torch.ones((1, 1) + tuple(xc.shape[2:]), dtype=xc.dtype,
                              device=xc.device)
            sums = avg_pool(F.pad(xc, flat), window, strides,
                            divisor_override=1)
            counts = avg_pool(F.pad(ones, flat), window, strides,
                              divisor_override=1)
            y = sums / counts
        if r == 1:
            y = y.squeeze(2)
        return y if self.dim_ordering == "th" else y.movedim(1, r + 1)

    def compute_output_shape(self, input_shape):
        th = self.dim_ordering == "th"
        spatial = input_shape[2:] if th else input_shape[1:-1]
        out = tuple(_spatial_out(d, k, s, self.padding) for d, k, s in
                    zip(spatial, self.pool_size, self.strides))
        if th:
            return tuple(input_shape[:2]) + out
        return (input_shape[0],) + out + (input_shape[-1],)


class MaxPooling2D(_PoolND):
    pass


class AveragePooling2D(_PoolND):
    reducer = "avg"


class MaxPooling1D(_PoolND):
    spatial_rank = 1

    def __init__(self, pool_length: int = 2, stride: Optional[int] = None,
                 **kw):
        super().__init__((pool_length,), (stride,) if stride else None,
                         **kw)


class AveragePooling1D(MaxPooling1D):
    reducer = "avg"


class _GlobalPool(Layer):
    """Max or mean over the spatial axes; a bf16 mean sums in float32 and
    rounds once, as `jnp.mean` does."""

    spatial_axes: Tuple[int, ...] = (1, 2)
    reducer = "max"

    def __init__(self, dim_ordering="tf", name: Optional[str] = None):
        super().__init__(name=name)
        self.dim_ordering = dim_ordering

    def call(self, x, *, training: bool = False):
        axes = self.spatial_axes if self.dim_ordering == "tf" else \
            tuple(a + 1 for a in self.spatial_axes)
        if self.reducer == "max":
            return x.amax(dim=axes)
        acc = torch.promote_types(x.dtype, torch.float32)
        return x.mean(dim=axes, dtype=acc).to(x.dtype)

    def compute_output_shape(self, input_shape):
        if self.dim_ordering == "tf":
            return (input_shape[0], input_shape[-1])
        return (input_shape[0], input_shape[1])


class GlobalMaxPooling2D(_GlobalPool):
    pass


class GlobalAveragePooling2D(_GlobalPool):
    reducer = "avg"


class GlobalMaxPooling1D(_GlobalPool):
    spatial_axes = (1,)


class GlobalAveragePooling1D(_GlobalPool):
    spatial_axes = (1,)
    reducer = "avg"


class ZeroPadding2D(Layer):
    """Zero rows and columns on both sides of the two spatial axes (JAX
    L706); `padding` is (rows, columns) a side."""

    def __init__(self, padding=(1, 1), dim_ordering: str = "tf",
                 input_shape: Optional[Sequence] = None,
                 name: Optional[str] = None):
        super().__init__(name=name, input_shape=input_shape)
        self.pad = tuple(padding)
        self.dim_ordering = dim_ordering

    def call(self, x, *, training: bool = False):
        ph, pw = self.pad
        if self.dim_ordering == "tf":
            return F.pad(x, (0, 0, pw, pw, ph, ph))
        return F.pad(x, (pw, pw, ph, ph))

    def compute_output_shape(self, input_shape):
        s = list(input_shape)
        first = 1 if self.dim_ordering == "tf" else 2
        for axis, p in zip((first, first + 1), self.pad):
            s[axis] = None if s[axis] is None else s[axis] + 2 * p
        return tuple(s)


class UpSampling2D(Layer):
    """Repeat each row `size[0]` times and each column `size[1]` times
    (JAX L727)."""

    def __init__(self, size=(2, 2), dim_ordering: str = "tf",
                 input_shape: Optional[Sequence] = None,
                 name: Optional[str] = None):
        super().__init__(name=name, input_shape=input_shape)
        self.size = tuple(size)
        self.dim_ordering = dim_ordering

    def call(self, x, *, training: bool = False):
        first = 1 if self.dim_ordering == "tf" else 2
        sh, sw = self.size
        return x.repeat_interleave(sh, dim=first).repeat_interleave(
            sw, dim=first + 1)

    def compute_output_shape(self, input_shape):
        s = list(input_shape)
        first = 1 if self.dim_ordering == "tf" else 2
        for axis, k in zip((first, first + 1), self.size):
            s[axis] = None if s[axis] is None else s[axis] * k
        return tuple(s)


# ---------------------------------------------------------------------------
# Recurrent layers
# ---------------------------------------------------------------------------
class _Recurrent(Layer):
    """A recurrence over the time axis of `[B, T, F]` (JAX L753-812). The
    parameters are the JAX package's, in its layout and gate order: `kernel`
    [F, n·H], `recurrent` [H, n·H], `bias` [n·H]. The input product of every
    step is one GEMM before the loop (`x @ kernel + bias`, time-major), so a
    step is one `h @ recurrent` and its gate math: the JAX step's function
    up to rounding (it adds the bias after the two products). The loop is
    Python over PyTorch ops, as the JAX package scans outside any Pallas
    kernel; the per-step inputs come from one `unbind` and the sequence
    goes out through one `stack`, whose backwards are one op each.

    The input follows the parameters' dtype and so does the carry (JAX
    L790, L799-802): under bf16 mixed precision h (and an LSTM's c) stay
    bf16 at every step. `go_backwards` walks time from the end; with
    `return_sequences` the sequence comes back in input order (JAX
    L804-806; Keras would leave it reversed)."""

    n_gates = 1

    def __init__(self, output_dim: int, activation="tanh",
                 inner_activation="hard_sigmoid",
                 return_sequences: bool = False, go_backwards: bool = False,
                 init="glorot_uniform", inner_init="orthogonal",
                 input_shape: Optional[Sequence] = None,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 name: Optional[str] = None):
        super().__init__(name=name, input_shape=input_shape)
        self.output_dim = output_dim
        self.activation = get_activation(activation)
        self.inner_activation = get_activation(inner_activation)
        self.return_sequences = return_sequences
        self.go_backwards = go_backwards
        self.init = get_init(init)
        self.inner_init = get_init(inner_init)
        self._device, self._dtype = device, dtype
        if self.input_shape is not None:
            self.ensure_parameters(self.input_shape)

    def create_parameters(self, input_shape):
        width = self.n_gates * self.output_dim
        self.kernel = new_parameter((input_shape[-1], width), self._device,
                                    self._dtype)
        self.recurrent = new_parameter((self.output_dim, width),
                                       self._device, self._dtype)
        self.bias = new_parameter((width,), self._device, self._dtype)

    def build(self, generator):
        fill_(self.kernel, self.init(generator, tuple(self.kernel.shape)))
        fill_(self.recurrent, self.inner_init(
            generator, tuple(self.recurrent.shape)))
        fill_(self.bias, torch.zeros(self.bias.shape))
        return self

    def initial_state(self, batch: int):
        return self.kernel.new_zeros((batch, self.output_dim))

    def step(self, carry, xw_t):
        """`(carry, h)` after one step; `xw_t` is this step's
        `x_t @ kernel + bias`."""
        raise NotImplementedError

    def call(self, x, *, training: bool = False):
        x = _match_param_dtype(x, self.kernel)
        batch, steps = x.shape[0], x.shape[1]
        xw = torch.addmm(self.bias, x.transpose(0, 1).reshape(
            steps * batch, -1), self.kernel).view(steps, batch, -1)
        xw = xw.unbind(0)
        carry = self.initial_state(batch)
        order = range(steps - 1, -1, -1) if self.go_backwards \
            else range(steps)
        outs = [None] * steps
        for t in order:
            carry, h = self.step(carry, xw[t])
            outs[t] = h
        return torch.stack(outs, dim=1) if self.return_sequences else h

    def compute_output_shape(self, input_shape):
        if self.return_sequences:
            return (input_shape[0], input_shape[1], self.output_dim)
        return (input_shape[0], self.output_dim)


class SimpleRNN(_Recurrent):
    """`h = activation(x_t @ kernel + h @ recurrent + bias)` (JAX L815)."""

    n_gates = 1

    def step(self, h, xw_t):
        h = self.activation(torch.addmm(xw_t, h, self.recurrent))
        return h, h


class LSTM(_Recurrent):
    """Gate order i, f, c, o (Keras's; JAX L824). The inner activation
    takes the i|f columns in one call."""

    n_gates = 4

    def initial_state(self, batch: int):
        zeros = super().initial_state(batch)
        return zeros, zeros

    def step(self, carry, xw_t):
        h, c = carry
        d = self.output_dim
        zif, zc, zo = torch.addmm(xw_t, h, self.recurrent).split(
            (2 * d, d, d), dim=1)
        i, f = self.inner_activation(zif).chunk(2, dim=1)
        c = torch.addcmul(f * c, i, self.activation(zc))
        h = self.inner_activation(zo) * self.activation(c)
        return (h, c), h


class GRU(_Recurrent):
    """Gate order z, r, h (Keras's; JAX L845). The default applies the
    reset gate to `h @ recurrent` before adding the input's candidate
    columns (Keras's reset-before form, which cuDNN's GRU does not
    compute); `reset_after=True` adds a `recurrent_bias` [3·H] to
    `h @ recurrent` first (the torch / cuDNN form, for converting their
    weights). The new state `z·h + (1 − z)·candidate` is one `lerp`."""

    n_gates = 3

    def __init__(self, *args, reset_after: bool = False, **kw):
        self.reset_after = reset_after
        super().__init__(*args, **kw)

    def create_parameters(self, input_shape):
        super().create_parameters(input_shape)
        if self.reset_after:
            self.recurrent_bias = new_parameter(
                (self.n_gates * self.output_dim,), self._device, self._dtype)

    def build(self, generator):
        super().build(generator)
        if self.reset_after:
            fill_(self.recurrent_bias, torch.zeros(self.recurrent_bias.shape))
        return self

    def step(self, h, xw_t):
        d = self.output_dim
        hz = torch.addmm(self.recurrent_bias, h, self.recurrent) \
            if self.reset_after else h @ self.recurrent
        x_zr, x_h = xw_t.split((2 * d, d), dim=1)
        h_zr, h_h = hz.split((2 * d, d), dim=1)
        z, r = self.inner_activation(x_zr + h_zr).chunk(2, dim=1)
        candidate = self.activation(torch.addcmul(x_h, r, h_h))
        h = torch.lerp(candidate, h, z)
        return h, h


class Bidirectional(Layer):
    """`keras/layers/Bidirectional.scala` (JAX L875): the wrapped layer
    and a copy walking time the other way, merged by concat, sum, mul or
    ave. The two are submodules `forward_layer` and `backward_layer` (an
    `nn.Module` cannot have a child named `forward`); `convert` maps them
    to the JAX tree's `forward` and `backward`."""

    MODES = ("concat", "sum", "mul", "ave")

    def __init__(self, layer: _Recurrent, merge_mode: str = "concat",
                 input_shape: Optional[Sequence] = None,
                 name: Optional[str] = None):
        if merge_mode not in self.MODES:
            raise ValueError(f"Unsupported merge_mode: {merge_mode}")
        super().__init__(name=name, input_shape=input_shape)
        self.forward_layer = layer
        self.backward_layer = copy.deepcopy(layer)
        self.backward_layer.name = layer.name + "_bwd"
        self.backward_layer.go_backwards = not layer.go_backwards
        self.merge_mode = merge_mode
        if self.input_shape is not None:
            self.ensure_parameters(self.input_shape)

    def create_parameters(self, input_shape):
        self.forward_layer.ensure_parameters(input_shape)
        self.backward_layer.ensure_parameters(input_shape)

    def call(self, x, *, training: bool = False):
        f = self.forward_layer.call(x, training=training)
        b = self.backward_layer.call(x, training=training)
        if self.merge_mode == "concat":
            return torch.cat([f, b], dim=-1)
        if self.merge_mode == "sum":
            return f + b
        if self.merge_mode == "mul":
            return f * b
        return (f + b) / 2.0

    def compute_output_shape(self, input_shape):
        out = list(self.forward_layer.compute_output_shape(input_shape))
        if self.merge_mode == "concat":
            out[-1] *= 2
        return tuple(out)


class TimeDistributed(Layer):
    """`keras/layers/TimeDistributed.scala` (JAX L913): the inner layer on
    every step, time folded into the batch (one call on [B·T, ...]). Its
    parameters are the submodule `layer`'s; the JAX tree keeps them at the
    wrapper's own level, which `convert` maps. As in the JAX package, the
    inner layer's state updates are not kept."""

    def __init__(self, layer: Layer, input_shape: Optional[Sequence] = None,
                 name: Optional[str] = None):
        super().__init__(name=name, input_shape=input_shape)
        self.layer = layer
        if self.input_shape is not None:
            self.ensure_parameters(self.input_shape)

    @staticmethod
    def _inner_shape(input_shape):
        return (input_shape[0],) + tuple(input_shape[2:])

    def create_parameters(self, input_shape):
        self.layer.ensure_parameters(self._inner_shape(input_shape))

    def call_and_state(self, x, *, training: bool = False,
                       seed: Optional[int] = None):
        b, t = x.shape[0], x.shape[1]
        y, _ = self.layer.call_and_state(
            x.reshape((b * t,) + tuple(x.shape[2:])), training=training,
            seed=seed)
        return y.reshape((b, t) + tuple(y.shape[1:])), {}

    def call(self, x, *, training: bool = False):
        return self.call_and_state(x, training=training)[0]

    def compute_output_shape(self, input_shape):
        inner = self.layer.compute_output_shape(
            self._inner_shape(input_shape))
        return (input_shape[0], input_shape[1]) + tuple(inner[1:])


# `LayerNorm.scala` names layer normalization this way too (JAX L939)
LayerNorm = LayerNormalization

# The extended Keras1 set (advanced activations, noise, the convolution
# variants, ConvLSTM, LRN, the torch-style elementwise layers, ...) lives
# in layers_ext and belongs to this namespace, as in the JAX package (L944);
# it imports from this module, so it comes last.
from analytics_zoo_tpu_torch.keras.layers_ext import *  # noqa: E402,F401,F403
