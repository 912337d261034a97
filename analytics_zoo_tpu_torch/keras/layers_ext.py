"""The extended Keras1 layer set.

Port of `analytics_zoo_tpu/keras/layers_ext.py`, every class of its
`__all__` (L44-61), in its order: the advanced activations (L66-123), the
noise and structured-dropout layers and `Masking` (L127-203),
`Highway` and `MaxoutDense` (L208-272), the convolution family (L277-565:
`SeparableConvolution2D`, `Deconvolution2D`, `AtrousConvolution1D/2D`,
`LocallyConnected1D/2D`), cropping, padding, upsampling and the 3-D pools
(L570-716), `ConvLSTM2D/3D` (L725-818), `LRN2D`, `WithinChannelLRN2D`,
`ResizeBilinear` and `GaussianSampler` (L823-922), the torch-style
elementwise layers (L927-1065) and the long tail (L1070-1302). The
`keras/layers.py` namespace re-exports all of them, as the JAX one does.

The layers follow the port's contract (`keras/engine.py`): a layer is an
`nn.Module` owning its parameters, created at construction or, when their
sizes come from the input, at the first call on a node (`input_shape` at
construction does it at once), on `device` in `dtype`, and filled by
`build(generator)` with the JAX initializers' distributions. Images stay
channels-last at the API; `dim_ordering="th"` takes channels-first.

Weight layouts. Dense-like weights keep the JAX layout (`Highway`'s
`[d, d]`, `MaxoutDense`'s `[nb_feature, in, out]`, `LocallyConnected*D`'s
`[positions, window·in, out]`). Convolution kernels are PyTorch's, as
`_ConvND`'s are: `SeparableConvolution2D`'s `depthwise` is `[in·depth,
1, kh, kw]` and its `pointwise` `[out, in·depth, 1, 1]`; `ConvLSTM*D`'s
`kernel` `[4·filters, in, *window]` and `recurrent` `[4·filters, filters,
*window]`; `Deconvolution2D`'s kernel is `conv_transpose2d`'s `[in, out,
kh, kw]`. `convert` moves each between the two layouts.

`Deconvolution2D` has scatter semantics (the gradient of a convolution):
the JAX layer flips its kernel and hands it to `lax.conv_transpose`, which
correlates. That is `conv_transpose2d` with the kernel as it is; the
output is then taken from the scatter's full result at the offset and
length `lax.conv_transpose`'s padding gives ("valid": `(n - 1)·s + k`, or
`n·s` when the stride passes the window; "same": `n·s`), zeros past the
scatter's end.

`ResizeBilinear(align_corners=False)` is `jax.image.resize(...,
"bilinear")`, which antialiases when it shrinks: `F.interpolate(...,
antialias=True)` computes the same triangle filter over the same
half-pixel grid. `align_corners=True` is the JAX layer's own gather.

The random layers (`GaussianNoise`, `GaussianDropout`,
`SpatialDropout1D/2D/3D`, `RReLU`, `GaussianSampler`) draw from the seed
their model hands their node, as `Dropout` does: Philox words
(`kernels/philox.dropout_bits`, the dropout kernel's counters) made into
uniforms in [0, 1) from their top 24 bits, and normals by Box-Muller. The
draw is plain PyTorch, on the device of the input, and works with a
`DeviceSeed` (a training step's seed on the card, inside a CUDA graph).
The bits differ from `jax.random`'s; the distributions are the same. Each
layer's `noise(shape, seed, device)` is its draw and `apply(x, draw)` its
function of it, so a draw can be injected. None of them is a Pallas kernel
in the JAX package, and none has a hand kernel here.

The computations are PyTorch's (convolutions on cuDNN); the JAX package
runs them outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.common.device import DeviceLike
from analytics_zoo_tpu_torch.keras.engine import Layer, new_parameter
from analytics_zoo_tpu_torch.keras.layers import (
    _CONV, _ConvND, _GlobalPool, _PoolND, _Recurrent, _from_channels_last,
    _match_param_dtype, _pad_arg, _same_pads, _to_channels_last,
    Convolution2D, Dense, fill_, get_activation, get_init)
from analytics_zoo_tpu_torch.kernels.philox import Seed, dropout_bits

__all__ = [
    "LeakyReLU", "ELU", "PReLU", "SReLU", "ThresholdedReLU",
    "GaussianNoise", "GaussianDropout", "SpatialDropout1D", "SpatialDropout2D",
    "SpatialDropout3D", "Masking",
    "Highway", "MaxoutDense",
    "SeparableConvolution2D", "SeparableConv2D", "Deconvolution2D",
    "Conv2DTranspose", "AtrousConvolution1D", "AtrousConvolution2D",
    "LocallyConnected1D", "LocallyConnected2D",
    "Cropping1D", "Cropping2D", "Cropping3D",
    "ZeroPadding1D", "ZeroPadding3D", "UpSampling1D", "UpSampling3D",
    "MaxPooling3D", "AveragePooling3D", "GlobalMaxPooling3D",
    "GlobalAveragePooling3D",
    "ConvLSTM2D", "ConvLSTM3D",
    "LRN2D", "WithinChannelLRN2D", "ResizeBilinear", "GaussianSampler",
    "Scale", "CAdd", "CMul", "AddConstant", "MulConstant", "Abs", "Clamp",
    "HardTanh", "Exp", "Log", "Power", "Square", "Sqrt", "Negative",
    "Identity", "HardShrink", "SoftShrink", "Threshold",
    "Softmax", "BinaryThreshold", "Mul", "Max", "RReLU", "SelectTable",
    "SplitTensor", "Expand", "GetShape", "ShareConvolution2D",
    "SparseDense", "SparseEmbedding",
]


class _Sized(Layer):
    """A layer whose parameters take their sizes from its input's shape
    (`create_parameters`), made on `device` in `dtype`. A subclass sets its
    configuration, then calls `_ready()`."""

    def __init__(self, input_shape: Optional[Sequence] = None,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 name: Optional[str] = None):
        super().__init__(name=name, input_shape=input_shape)
        self._device, self._dtype = device, dtype

    def _ready(self) -> None:
        if self.input_shape is not None:
            self.ensure_parameters(self.input_shape)

    def _new(self, shape) -> torch.nn.Parameter:
        return new_parameter(tuple(shape), self._device, self._dtype)


def _hwio_draw(init, generator, window, cin: int, cout: int):
    """A kernel drawn in the JAX layout (HWIO: fans from the window, in and
    out), returned `[out, in, *window]`."""
    r = len(window)
    hwio = init(generator, tuple(window) + (cin, cout))
    return hwio.permute(r + 1, r, *range(r))


# ---------------------------------------------------------------------------
# The random draws
# ---------------------------------------------------------------------------
def uniform_noise(shape, seed: Seed, device, n_draws: int = 1):
    """`n_draws` float32 tensors of `shape`, uniform in [0, 1): the top 24
    bits of the Philox words of `seed` (`philox.dropout_bits`)."""
    n = math.prod(shape)
    bits = dropout_bits(n * n_draws, seed, device)
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return [d.reshape(shape) for d in u.split(n)]


def normal_noise(shape, seed: Seed, device):
    """float32 N(0, 1) of `shape`: Box-Muller of two uniform draws."""
    u1, u2 = uniform_noise(shape, seed, device, 2)
    radius = torch.sqrt(-2.0 * torch.log1p(-u1))
    return radius * torch.cos((2.0 * math.pi) * u2)


class _Random(Layer):
    """A layer that draws in training, from the seed its model hands its
    node (`call_and_state(..., seed=)`), through `noise`; `apply(x, draw)`
    is the layer's function of a draw. Outside training, or where the layer
    has nothing to draw (a rate of 0), it is `inference`."""

    def active(self) -> bool:
        return True

    def inference(self, x):
        return x

    def noise(self, shape, seed: Seed, device):
        raise NotImplementedError

    def apply(self, x, draw):
        raise NotImplementedError

    def _noise_shape(self, x):
        return tuple(x.shape)

    def call(self, x, *, training: bool = False,
             seed: Optional[Seed] = None):
        if not training or not self.active():
            return self.inference(x)
        if seed is None:
            raise ValueError(f"{self.name}: needs a seed in training")
        ref = x[0] if isinstance(x, (list, tuple)) else x
        draw = self.noise(self._noise_shape(x), seed, ref.device)
        return self.apply(x, draw)

    def call_and_state(self, x, *, training: bool = False,
                       seed: Optional[Seed] = None):
        return self.call(x, training=training, seed=seed), {}


# ---------------------------------------------------------------------------
# Advanced activations
# ---------------------------------------------------------------------------
class LeakyReLU(Layer):
    """`keras/layers/advanced_activations` LeakyReLU(alpha)."""

    def __init__(self, alpha: float = 0.3, name: Optional[str] = None):
        super().__init__(name=name)
        self.alpha = float(alpha)

    def call(self, x, *, training: bool = False):
        return F.leaky_relu(x, self.alpha)


class ELU(Layer):
    def __init__(self, alpha: float = 1.0, name: Optional[str] = None):
        super().__init__(name=name)
        self.alpha = float(alpha)

    def call(self, x, *, training: bool = False):
        return F.elu(x, self.alpha)


class ThresholdedReLU(Layer):
    def __init__(self, theta: float = 1.0, name: Optional[str] = None):
        super().__init__(name=name)
        self.theta = float(theta)

    def call(self, x, *, training: bool = False):
        return x * (x > self.theta).to(x.dtype)


class PReLU(_Sized):
    """Learnable per-element leaky slope (Keras1: the alphas have the full
    non-batch input shape), zeros at build."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._ready()

    def create_parameters(self, input_shape):
        self.alpha = self._new(input_shape[1:])

    def build(self, generator):
        fill_(self.alpha, torch.zeros(self.alpha.shape))
        return self

    def call(self, x, *, training: bool = False):
        return torch.clamp(x, min=0.0) + self.alpha * torch.clamp(x, max=0.0)


class SReLU(_Sized):
    """S-shaped ReLU (`SReLU.scala`): two learnable thresholds and
    slopes."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._ready()

    def create_parameters(self, input_shape):
        shape = input_shape[1:]
        for leaf in ("t_left", "a_left", "t_right", "a_right"):
            setattr(self, leaf, self._new(shape))

    def build(self, generator):
        for leaf, value in (("t_left", 0.0), ("a_left", 0.0),
                            ("t_right", 1.0), ("a_right", 1.0)):
            t = getattr(self, leaf)
            fill_(t, torch.full(t.shape, value))
        return self

    def call(self, x, *, training: bool = False):
        tl, al, tr, ar = self.t_left, self.a_left, self.t_right, self.a_right
        y_left = tl + al * (x - tl)
        y_right = tr + ar * (x - tr)
        return torch.where(x < tl, y_left, torch.where(x > tr, y_right, x))


# ---------------------------------------------------------------------------
# Noise / structured dropout / masking
# ---------------------------------------------------------------------------
class GaussianNoise(_Random):
    def __init__(self, sigma: float, name: Optional[str] = None):
        super().__init__(name=name)
        self.sigma = float(sigma)

    def active(self):
        return self.sigma > 0.0

    def noise(self, shape, seed, device):
        return normal_noise(shape, seed, device)

    def apply(self, x, draw):
        return x + self.sigma * draw.to(x.dtype)


class GaussianDropout(_Random):
    """Multiplicative 1-mean gaussian noise with std sqrt(p / (1 − p))."""

    def __init__(self, p: float, name: Optional[str] = None):
        super().__init__(name=name)
        self.rate = float(p)

    def active(self):
        return self.rate > 0.0

    def noise(self, shape, seed, device):
        return normal_noise(shape, seed, device)

    def apply(self, x, draw):
        std = math.sqrt(self.rate / (1.0 - self.rate))
        return x * (1.0 + std * draw.to(x.dtype))


class _SpatialDropout(_Random):
    """Drops whole feature maps: one keep decision a (sample, channel),
    broadcast over the spatial axes."""

    spatial_rank = 2

    def __init__(self, p: float = 0.5, dim_ordering: str = "tf",
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.rate = float(p)
        self.dim_ordering = dim_ordering

    def active(self):
        return self.rate > 0.0

    def _noise_shape(self, x):
        shape = list(x.shape)
        first = 1 if self.dim_ordering == "tf" else 2
        for ax in range(first, first + self.spatial_rank):
            shape[ax] = 1
        return tuple(shape)

    def noise(self, shape, seed, device):
        """The keep mask (bool), kept with probability 1 − p."""
        u, = uniform_noise(shape, seed, device)
        return u < 1.0 - self.rate

    def apply(self, x, draw):
        keep = 1.0 - self.rate
        return torch.where(draw, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


class SpatialDropout1D(_SpatialDropout):
    spatial_rank = 1


class SpatialDropout2D(_SpatialDropout):
    spatial_rank = 2


class SpatialDropout3D(_SpatialDropout):
    spatial_rank = 3


class Masking(Layer):
    """`Masking.scala`: zero the timesteps whose features all equal
    `mask_value`."""

    def __init__(self, mask_value: float = 0.0, name: Optional[str] = None):
        super().__init__(name=name)
        self.mask_value = float(mask_value)

    def call(self, x, *, training: bool = False):
        keep = torch.any(x != self.mask_value, dim=-1, keepdim=True)
        return x * keep.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense variants
# ---------------------------------------------------------------------------
class Highway(_Sized):
    """`Highway.scala`: y = t·h(x) + (1 − t)·x; the output width is the
    input's."""

    def __init__(self, activation="tanh", use_bias: bool = True,
                 init="glorot_uniform", **kw):
        super().__init__(**kw)
        self.activation = get_activation(activation)
        self.use_bias = use_bias
        self.init = get_init(init)
        self._ready()

    def create_parameters(self, input_shape):
        d = input_shape[-1]
        self.kernel = self._new((d, d))
        self.transform_kernel = self._new((d, d))
        if self.use_bias:
            self.bias = self._new((d,))
            self.transform_bias = self._new((d,))

    def build(self, generator):
        d = self.kernel.shape[0]
        fill_(self.kernel, self.init(generator, (d, d)))
        fill_(self.transform_kernel, self.init(generator, (d, d)))
        if self.use_bias:
            fill_(self.bias, torch.zeros(d))
            # a negative transform bias carries by default (the highway
            # paper)
            fill_(self.transform_bias, torch.full((d,), -2.0))
        return self

    def call(self, x, *, training: bool = False):
        x = _match_param_dtype(x, self.kernel)
        h = x @ self.kernel
        t = x @ self.transform_kernel
        if self.use_bias:
            h = h + self.bias
            t = t + self.transform_bias
        h = self.activation(h)
        t = torch.sigmoid(t)
        return t * h + (1.0 - t) * x


class MaxoutDense(_Sized):
    """`MaxoutDense.scala`: the max over `nb_feature` affine maps."""

    def __init__(self, output_dim: int, nb_feature: int = 4,
                 use_bias: bool = True, init="glorot_uniform", **kw):
        super().__init__(**kw)
        self.output_dim = output_dim
        self.nb_feature = nb_feature
        self.use_bias = use_bias
        self.init = get_init(init)
        self._ready()

    def create_parameters(self, input_shape):
        self.kernel = self._new((self.nb_feature, input_shape[-1],
                                 self.output_dim))
        if self.use_bias:
            self.bias = self._new((self.nb_feature, self.output_dim))

    def build(self, generator):
        fill_(self.kernel, self.init(generator, tuple(self.kernel.shape)))
        if self.use_bias:
            fill_(self.bias, torch.zeros(self.bias.shape))
        return self

    def call(self, x, *, training: bool = False):
        x = _match_param_dtype(x, self.kernel)
        y = torch.einsum("bd,fdo->bfo", x, self.kernel)
        if self.use_bias:
            y = y + self.bias
        return y.amax(dim=1)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], self.output_dim)


# ---------------------------------------------------------------------------
# Convolution family
# ---------------------------------------------------------------------------
def _conv_same(x, weight, bias, strides, window, padding: str, groups=1,
               dilation=None):
    """A 2-d or 3-d convolution of a channels-first input with XLA's
    "same" (or "valid") padding, as `_ConvND` computes one."""
    r = x.dim() - 2
    pad = 0
    if padding == "SAME":
        pads = _same_pads(x.shape[2:], window, strides)
        if all(lo == hi for lo, hi in pads):
            pad = tuple(lo for lo, _ in pads)
        else:
            x = F.pad(x, _pad_arg(pads))
    return _CONV[r](x, weight, bias, stride=tuple(strides), padding=pad,
                    dilation=tuple(dilation or (1,) * r), groups=groups)


def _out_size(size, k: int, s: int, padding: str):
    if size is None:
        return None
    return -(-size // s) if padding == "SAME" else (size - k) // s + 1


class SeparableConvolution2D(_Sized):
    """`SeparableConvolution2D.scala`: a depthwise convolution (one group a
    channel, `depth_multiplier` outputs each) then a 1×1 pointwise one."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, subsample=(1, 1), border_mode="valid",
                 depth_multiplier: int = 1, dim_ordering="tf",
                 use_bias: bool = True, init="glorot_uniform", **kw):
        super().__init__(**kw)
        self.nb_filter = nb_filter
        self.kernel_size = (nb_row, nb_col)
        self.activation = get_activation(activation)
        self.strides = tuple(subsample)
        self.padding = border_mode.upper()
        self.depth_multiplier = depth_multiplier
        self.dim_ordering = dim_ordering
        self.use_bias = use_bias
        self.init = get_init(init)
        self._ready()

    def create_parameters(self, input_shape):
        in_ch = input_shape[1] if self.dim_ordering == "th" \
            else input_shape[-1]
        mid = in_ch * self.depth_multiplier
        self.depthwise = self._new((mid, 1) + self.kernel_size)
        self.pointwise = self._new((self.nb_filter, mid, 1, 1))
        if self.use_bias:
            self.bias = self._new((self.nb_filter,))

    def build(self, generator):
        mid = self.depthwise.shape[0]
        fill_(self.depthwise, _hwio_draw(self.init, generator,
                                         self.kernel_size, 1, mid))
        fill_(self.pointwise, _hwio_draw(self.init, generator, (1, 1), mid,
                                         self.nb_filter))
        if self.use_bias:
            fill_(self.bias, torch.zeros(self.bias.shape))
        return self

    def call(self, x, *, training: bool = False):
        x = _match_param_dtype(x, self.depthwise)
        xc = x if self.dim_ordering == "th" else x.movedim(3, 1)
        y = _conv_same(xc, self.depthwise, None, self.strides,
                       self.kernel_size, self.padding, groups=xc.shape[1])
        y = F.conv2d(y, self.pointwise,
                     self.bias if self.use_bias else None)
        y = self.activation(y.movedim(1, -1))
        return _from_channels_last(y, self.dim_ordering, 2)

    def compute_output_shape(self, input_shape):
        th = self.dim_ordering == "th"
        h, w = input_shape[2:4] if th else input_shape[1:3]
        out = (_out_size(h, self.kernel_size[0], self.strides[0],
                         self.padding),
               _out_size(w, self.kernel_size[1], self.strides[1],
                         self.padding))
        if th:
            return (input_shape[0], self.nb_filter) + out
        return (input_shape[0],) + out + (self.nb_filter,)


SeparableConv2D = SeparableConvolution2D


def _transpose_crop(k: int, s: int, padding: str) -> int:
    """Where the JAX output starts in the scatter's full result: `k − 1 −
    pad_a` of `lax.conv_transpose`'s padding (`_conv_transpose_padding`)."""
    if padding == "VALID":
        return 0
    if s > k - 1:
        return 0
    return k - 1 - math.ceil((k + s - 2) / 2)


def _transpose_len(n: int, k: int, s: int, padding: str) -> int:
    """The JAX output length along one axis."""
    if padding == "SAME":
        return n * s
    return n * s + max(k - s, 0)


class Deconvolution2D(_Sized):
    """`Deconvolution2D.scala` (transposed convolution, Conv2DTranspose),
    with scatter semantics; the kernel is `conv_transpose2d`'s `[in, out,
    kh, kw]`."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, subsample=(1, 1), border_mode="valid",
                 dim_ordering="tf", use_bias: bool = True,
                 init="glorot_uniform", **kw):
        super().__init__(**kw)
        self.nb_filter = nb_filter
        self.kernel_size = (nb_row, nb_col)
        self.activation = get_activation(activation)
        self.strides = tuple(subsample)
        self.padding = border_mode.upper()
        self.dim_ordering = dim_ordering
        self.use_bias = use_bias
        self.init = get_init(init)
        self._ready()

    def create_parameters(self, input_shape):
        in_ch = input_shape[1] if self.dim_ordering == "th" \
            else input_shape[-1]
        self.kernel = self._new((in_ch, self.nb_filter) + self.kernel_size)
        if self.use_bias:
            self.bias = self._new((self.nb_filter,))

    def build(self, generator):
        hwio = self.init(generator, self.kernel_size + (
            self.kernel.shape[0], self.nb_filter))
        fill_(self.kernel, hwio.permute(2, 3, 0, 1))
        if self.use_bias:
            fill_(self.bias, torch.zeros(self.bias.shape))
        return self

    def call(self, x, *, training: bool = False):
        x = _match_param_dtype(x, self.kernel)
        xc = x if self.dim_ordering == "th" else x.movedim(3, 1)
        crops = [_transpose_crop(k, s, self.padding)
                 for k, s in zip(self.kernel_size, self.strides)]
        lengths = [_transpose_len(n, k, s, self.padding) for n, k, s in
                   zip(xc.shape[2:], self.kernel_size, self.strides)]
        # `padding` crops the scatter's result at both ends; its far end
        # is then zero-padded or cropped to the JAX length
        y = F.conv_transpose2d(xc, self.kernel, None, stride=self.strides,
                               padding=tuple(crops))
        fix = [n - m for n, m in zip(lengths, y.shape[2:])]
        if any(fix):
            y = F.pad(y, [0, fix[1], 0, fix[0]])
        if self.use_bias:
            y = y + self.bias.reshape(-1, 1, 1)
        y = self.activation(y.movedim(1, -1))
        return _from_channels_last(y, self.dim_ordering, 2)

    def compute_output_shape(self, input_shape):
        """The JAX layer's formula: "same" n·s, "valid" (n − 1)·s + k."""
        def out(size, k, s):
            if size is None:
                return None
            return size * s if self.padding == "SAME" else (size - 1) * s + k
        th = self.dim_ordering == "th"
        h, w = input_shape[2:4] if th else input_shape[1:3]
        hw = (out(h, self.kernel_size[0], self.strides[0]),
              out(w, self.kernel_size[1], self.strides[1]))
        if th:
            return (input_shape[0], self.nb_filter) + hw
        return (input_shape[0],) + hw + (self.nb_filter,)


Conv2DTranspose = Deconvolution2D


class AtrousConvolution2D(_ConvND):
    """`AtrousConvolution2D.scala`: a dilated convolution."""

    def __init__(self, nb_filter, nb_row, nb_col, atrous_rate=(1, 1), **kw):
        super().__init__(nb_filter, (nb_row, nb_col), **kw)
        self.dilation = self.atrous_rate = tuple(atrous_rate)


class AtrousConvolution1D(_ConvND):
    spatial_rank = 1

    def __init__(self, nb_filter, filter_length, atrous_rate: int = 1, **kw):
        super().__init__(nb_filter, (filter_length,), **kw)
        self.dilation = self.atrous_rate = (atrous_rate,)


class LocallyConnected1D(_Sized):
    """`LocallyConnected1D.scala`: an unshared convolution, one kernel a
    position: the windows (`unfold`) and one batched contraction."""

    spatial_rank = 1

    def __init__(self, nb_filter: int, filter_length: int, activation=None,
                 subsample_length: int = 1, use_bias: bool = True,
                 init="glorot_uniform", **kw):
        super().__init__(**kw)
        self.nb_filter = nb_filter
        self.kernel_size = (filter_length,)
        self.strides = (subsample_length,)
        self.activation = get_activation(activation)
        self.use_bias = use_bias
        self.init = get_init(init)
        self._ready()

    def _out_len(self, size):
        return (size - self.kernel_size[0]) // self.strides[0] + 1

    def create_parameters(self, input_shape):
        out_len = self._out_len(input_shape[1])
        self.kernel = self._new((out_len, self.kernel_size[0]
                                 * input_shape[-1], self.nb_filter))
        if self.use_bias:
            self.bias = self._new((out_len, self.nb_filter))

    def build(self, generator):
        fill_(self.kernel, self.init(generator, tuple(self.kernel.shape)))
        if self.use_bias:
            fill_(self.bias, torch.zeros(self.bias.shape))
        return self

    def call(self, x, *, training: bool = False):
        x = _match_param_dtype(x, self.kernel)
        # [B, L, C] → windows [B, out, C, k] → [B, out, k·C]
        win = x.unfold(1, self.kernel_size[0], self.strides[0])
        patches = win.transpose(2, 3).reshape(x.shape[0], win.shape[1], -1)
        y = torch.einsum("bok,okf->bof", patches, self.kernel)
        if self.use_bias:
            y = y + self.bias
        return self.activation(y)

    def compute_output_shape(self, input_shape):
        return (input_shape[0], self._out_len(input_shape[1]),
                self.nb_filter)


class LocallyConnected2D(_Sized):
    """`LocallyConnected2D.scala`."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, subsample=(1, 1), use_bias: bool = True,
                 dim_ordering="tf", init="glorot_uniform", **kw):
        super().__init__(**kw)
        self.nb_filter = nb_filter
        self.kernel_size = (nb_row, nb_col)
        self.strides = tuple(subsample)
        self.activation = get_activation(activation)
        self.use_bias = use_bias
        self.dim_ordering = dim_ordering
        self.init = get_init(init)
        self._ready()

    @staticmethod
    def _out(size, k, s):
        return (size - k) // s + 1

    def create_parameters(self, input_shape):
        if self.dim_ordering == "th":
            in_ch, h, w = input_shape[1], input_shape[2], input_shape[3]
        else:
            h, w, in_ch = input_shape[1], input_shape[2], input_shape[3]
        (kh, kw), (sh, sw) = self.kernel_size, self.strides
        oh, ow = self._out(h, kh, sh), self._out(w, kw, sw)
        self.kernel = self._new((oh * ow, kh * kw * in_ch, self.nb_filter))
        if self.use_bias:
            self.bias = self._new((oh, ow, self.nb_filter))

    def build(self, generator):
        fill_(self.kernel, self.init(generator, tuple(self.kernel.shape)))
        if self.use_bias:
            fill_(self.bias, torch.zeros(self.bias.shape))
        return self

    def call(self, x, *, training: bool = False):
        x = _to_channels_last(x, self.dim_ordering, 2)
        x = _match_param_dtype(x, self.kernel)
        (kh, kw), (sh, sw) = self.kernel_size, self.strides
        b = x.shape[0]
        # windows [B, oh, ow, C, kh, kw] → the kernel's (kh, kw, C) order
        win = x.unfold(1, kh, sh).unfold(2, kw, sw)
        oh, ow = win.shape[1], win.shape[2]
        patches = win.permute(0, 1, 2, 4, 5, 3).reshape(b, oh * ow, -1)
        y = torch.einsum("bok,okf->bof", patches, self.kernel)
        y = y.reshape(b, oh, ow, self.nb_filter)
        if self.use_bias:
            y = y + self.bias
        y = self.activation(y)
        return _from_channels_last(y, self.dim_ordering, 2)

    def compute_output_shape(self, input_shape):
        th = self.dim_ordering == "th"
        h, w = (input_shape[2], input_shape[3]) if th \
            else (input_shape[1], input_shape[2])
        hw = (self._out(h, self.kernel_size[0], self.strides[0]),
              self._out(w, self.kernel_size[1], self.strides[1]))
        if th:
            return (input_shape[0], self.nb_filter) + hw
        return (input_shape[0],) + hw + (self.nb_filter,)


# ---------------------------------------------------------------------------
# Cropping / padding / upsampling
# ---------------------------------------------------------------------------
class Cropping1D(Layer):
    def __init__(self, cropping=(1, 1), name: Optional[str] = None):
        super().__init__(name=name)
        self.cropping = tuple(cropping)

    def call(self, x, *, training: bool = False):
        a, b = self.cropping
        return x[:, a:x.shape[1] - b, :]

    def compute_output_shape(self, input_shape):
        s = list(input_shape)
        s[1] -= sum(self.cropping)
        return tuple(s)


class _CroppingND(Layer):
    spatial_rank = 2

    def __init__(self, cropping=None, dim_ordering="tf",
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.cropping = tuple(tuple(c) for c in (
            cropping or ((1, 1),) * self.spatial_rank))
        self.dim_ordering = dim_ordering

    def call(self, x, *, training: bool = False):
        x = _to_channels_last(x, self.dim_ordering, self.spatial_rank)
        idx = [slice(None)]
        for ax, (a, b) in enumerate(self.cropping):
            idx.append(slice(a, x.shape[1 + ax] - b))
        idx.append(slice(None))
        y = x[tuple(idx)]
        return _from_channels_last(y, self.dim_ordering, self.spatial_rank)

    def compute_output_shape(self, input_shape):
        s = list(input_shape)
        off = 2 if self.dim_ordering == "th" else 1
        for ax, (a, b) in enumerate(self.cropping):
            s[off + ax] -= a + b
        return tuple(s)


class Cropping2D(_CroppingND):
    spatial_rank = 2


class Cropping3D(_CroppingND):
    spatial_rank = 3

    def __init__(self, cropping=((1, 1), (1, 1), (1, 1)), **kw):
        super().__init__(cropping, **kw)


class ZeroPadding1D(Layer):
    def __init__(self, padding=1, name: Optional[str] = None):
        super().__init__(name=name)
        self.padding = (padding, padding) if isinstance(padding, int) \
            else tuple(padding)

    def call(self, x, *, training: bool = False):
        a, b = self.padding
        return F.pad(x, (0, 0, a, b))

    def compute_output_shape(self, input_shape):
        s = list(input_shape)
        s[1] += sum(self.padding)
        return tuple(s)


class ZeroPadding3D(Layer):
    def __init__(self, padding=(1, 1, 1), dim_ordering="tf",
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.padding = tuple(padding)
        self.dim_ordering = dim_ordering

    def call(self, x, *, training: bool = False):
        p1, p2, p3 = self.padding
        if self.dim_ordering == "tf":
            return F.pad(x, (0, 0, p3, p3, p2, p2, p1, p1))
        return F.pad(x, (p3, p3, p2, p2, p1, p1))

    def compute_output_shape(self, input_shape):
        s = list(input_shape)
        off = 2 if self.dim_ordering == "th" else 1
        for i, p in enumerate(self.padding):
            s[off + i] += 2 * p
        return tuple(s)


class UpSampling1D(Layer):
    def __init__(self, length: int = 2, name: Optional[str] = None):
        super().__init__(name=name)
        self.length = length

    def call(self, x, *, training: bool = False):
        return x.repeat_interleave(self.length, dim=1)

    def compute_output_shape(self, input_shape):
        s = list(input_shape)
        s[1] *= self.length
        return tuple(s)


class UpSampling3D(Layer):
    def __init__(self, size=(2, 2, 2), dim_ordering="tf",
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.size = tuple(size)
        self.dim_ordering = dim_ordering

    def call(self, x, *, training: bool = False):
        off = 2 if self.dim_ordering == "th" else 1
        for i, s in enumerate(self.size):
            x = x.repeat_interleave(s, dim=off + i)
        return x

    def compute_output_shape(self, input_shape):
        s = list(input_shape)
        off = 2 if self.dim_ordering == "th" else 1
        for i, f in enumerate(self.size):
            s[off + i] *= f
        return tuple(s)


class MaxPooling3D(_PoolND):
    spatial_rank = 3


class AveragePooling3D(_PoolND):
    spatial_rank = 3
    reducer = "avg"


class GlobalMaxPooling3D(_GlobalPool):
    spatial_axes = (1, 2, 3)


class GlobalAveragePooling3D(_GlobalPool):
    spatial_axes = (1, 2, 3)
    reducer = "avg"


# ---------------------------------------------------------------------------
# ConvLSTM
# ---------------------------------------------------------------------------
class ConvLSTM2D(_Recurrent):
    """`ConvLSTM2D.scala`: an LSTM whose gates are convolutions, on
    `[B, T, *spatial, C]` (channels-last). The input's convolution for
    every step is one call before the loop (time folded into the batch,
    with the bias); a step is the recurrent convolution and the gate math
    (i, f, g, o), channels-first inside. Padding is "same" (the state keeps
    its spatial shape), the only mode the reference takes.
    `ConvLSTM3D.scala` is the 3-d subclass."""

    n_gates = 4
    spatial_rank = 2

    def __init__(self, nb_filter: int, nb_kernel, activation="tanh",
                 inner_activation="hard_sigmoid", return_sequences=False,
                 go_backwards=False, border_mode="same", subsample=None,
                 init="glorot_uniform", inner_init="orthogonal", **kw):
        if border_mode != "same":
            raise ValueError(
                f"{type(self).__name__} supports border_mode='same' only")
        self.kernel_size = (nb_kernel,) * self.spatial_rank \
            if isinstance(nb_kernel, int) else tuple(nb_kernel)
        self.strides = tuple(subsample or (1,) * self.spatial_rank)
        super().__init__(nb_filter, activation=activation,
                         inner_activation=inner_activation,
                         return_sequences=return_sequences,
                         go_backwards=go_backwards, init=init,
                         inner_init=inner_init, **kw)

    def _out_spatial(self, spatial):
        return tuple(None if d is None else -(-d // s)
                     for d, s in zip(spatial, self.strides))

    def create_parameters(self, input_shape):
        f4 = 4 * self.output_dim
        self.kernel = new_parameter((f4, input_shape[-1]) + self.kernel_size,
                                    self._device, self._dtype)
        self.recurrent = new_parameter(
            (f4, self.output_dim) + self.kernel_size, self._device,
            self._dtype)
        self.bias = new_parameter((f4,), self._device, self._dtype)

    def build(self, generator):
        f4 = 4 * self.output_dim
        fill_(self.kernel, _hwio_draw(self.init, generator, self.kernel_size,
                                      self.kernel.shape[1], f4))
        fill_(self.recurrent, _hwio_draw(self.inner_init, generator,
                                         self.kernel_size, self.output_dim,
                                         f4))
        fill_(self.bias, torch.zeros(f4))
        return self

    def call(self, x, *, training: bool = False):
        x = _match_param_dtype(x, self.kernel)
        r = self.spatial_rank
        b, steps = x.shape[0], x.shape[1]
        xs = x.reshape((b * steps,) + tuple(x.shape[2:])).movedim(-1, 1)
        zx = _conv_same(xs, self.kernel, self.bias, self.strides,
                        self.kernel_size, "SAME")
        zx = zx.reshape((b, steps) + tuple(zx.shape[1:])).unbind(1)
        h = zx[0].new_zeros((b, self.output_dim) + tuple(zx[0].shape[2:]))
        c = h
        ones = (1,) * r
        order = range(steps - 1, -1, -1) if self.go_backwards \
            else range(steps)
        outs = [None] * steps
        for t in order:
            z = zx[t] + _conv_same(h, self.recurrent, None, ones,
                                   self.kernel_size, "SAME")
            i, f, g, o = z.chunk(4, dim=1)
            c = self.inner_activation(f) * c \
                + self.inner_activation(i) * self.activation(g)
            h = self.inner_activation(o) * self.activation(c)
            outs[t] = h
        if self.return_sequences:
            return torch.stack(outs, dim=1).movedim(2, -1)
        return h.movedim(1, -1)

    def compute_output_shape(self, input_shape):
        b, t = input_shape[:2]
        out = self._out_spatial(input_shape[2:2 + self.spatial_rank])
        if self.return_sequences:
            return (b, t) + out + (self.output_dim,)
        return (b,) + out + (self.output_dim,)


class ConvLSTM3D(ConvLSTM2D):
    """`ConvLSTM3D.scala`: the volumetric ConvLSTM, on [B, T, D, H, W, C]."""

    spatial_rank = 3


# ---------------------------------------------------------------------------
# Normalization / resize / sampling
# ---------------------------------------------------------------------------
class LRN2D(Layer):
    """`LRN2D.scala`: cross-channel local response normalization,
    x / (k + alpha / n · Σ x²)^beta over a window of channels."""

    def __init__(self, alpha: float = 1e-4, k: float = 1.0,
                 beta: float = 0.75, n: int = 5, dim_ordering: str = "tf",
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.alpha, self.k, self.beta, self.n = alpha, k, beta, n
        self.dim_ordering = dim_ordering

    def call(self, x, *, training: bool = False):
        x = _to_channels_last(x, self.dim_ordering, 2)
        half = self.n // 2
        sq = F.pad(x * x, (half, self.n - 1 - half))
        summed = sq.unfold(-1, self.n, 1).sum(-1)
        y = x / torch.pow(self.k + (self.alpha / self.n) * summed, self.beta)
        return _from_channels_last(y, self.dim_ordering, 2)


class WithinChannelLRN2D(Layer):
    """`WithinChannelLRN2D.scala`: LRN over a spatial window within each
    channel."""

    def __init__(self, size: int = 5, alpha: float = 1.0,
                 beta: float = 0.75, name: Optional[str] = None):
        super().__init__(name=name)
        self.size, self.alpha, self.beta = size, alpha, beta

    def call(self, x, *, training: bool = False):
        n = self.size
        half = n // 2
        sq = (x * x).movedim(3, 1)
        sq = F.pad(sq, (half, n - 1 - half, half, n - 1 - half))
        summed = F.avg_pool2d(sq, n, 1, divisor_override=1).movedim(1, 3)
        return x / torch.pow(1.0 + self.alpha * (summed / float(n * n)),
                             self.beta)


class ResizeBilinear(Layer):
    """`ResizeBilinear.scala`: a bilinear spatial resize (NHWC).
    `align_corners=True` takes corner-aligned source coordinates (out_i ·
    (in − 1) / (out − 1), TF's align_corners grid); False is
    `jax.image.resize`'s half-pixel grid, antialiased when shrinking."""

    def __init__(self, output_height: int, output_width: int,
                 align_corners: bool = False, name: Optional[str] = None):
        super().__init__(name=name)
        self.out_hw = (output_height, output_width)
        self.align_corners = align_corners

    @staticmethod
    def _interp_axis(x, out_size: int, axis: int):
        in_size = x.shape[axis]
        if out_size == 1 or in_size == 1:
            coords = torch.zeros(out_size, device=x.device)
        else:
            coords = torch.linspace(0.0, in_size - 1.0, out_size,
                                    device=x.device)
        lo = coords.floor().long().clamp(0, in_size - 1)
        hi = (lo + 1).clamp(0, in_size - 1)
        shape = [1] * x.dim()
        shape[axis] = out_size
        w = (coords - lo).to(x.dtype).reshape(shape)
        return (x.index_select(axis, lo) * (1 - w)
                + x.index_select(axis, hi) * w)

    def call(self, x, *, training: bool = False):
        if not self.align_corners:
            y = F.interpolate(x.movedim(3, 1), size=self.out_hw,
                              mode="bilinear", align_corners=False,
                              antialias=True)
            return y.movedim(1, 3)
        y = self._interp_axis(x, self.out_hw[0], 1)
        return self._interp_axis(y, self.out_hw[1], 2)

    def compute_output_shape(self, input_shape):
        return (input_shape[0],) + self.out_hw + (input_shape[-1],)


class GaussianSampler(_Random):
    """`GaussianSampler.scala` (the VAE's reparameterization): input
    `[mean, log_var]` → mean + exp(log_var / 2)·ε in training, the mean
    otherwise."""

    def inference(self, xs):
        return xs[0]

    def _noise_shape(self, xs):
        return tuple(xs[0].shape)

    def noise(self, shape, seed, device):
        return normal_noise(shape, seed, device)

    def apply(self, xs, draw):
        mean, log_var = xs
        return mean + torch.exp(log_var * 0.5) * draw.to(mean.dtype)

    def compute_output_shape(self, input_shapes):
        return input_shapes[0]


# ---------------------------------------------------------------------------
# Torch-style elementwise layers (`pyzoo/.../keras/layers/torch.py`)
# ---------------------------------------------------------------------------
class Scale(_Sized):
    """A learnable per-channel affine y = a·x + b, ones and zeros at
    build."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._ready()

    def create_parameters(self, input_shape):
        self.alpha = self._new((input_shape[-1],))
        self.beta = self._new((input_shape[-1],))

    def build(self, generator):
        fill_(self.alpha, torch.ones(self.alpha.shape))
        fill_(self.beta, torch.zeros(self.beta.shape))
        return self

    def call(self, x, *, training: bool = False):
        return x * self.alpha + self.beta


class CAdd(Layer):
    """A learnable bias of a broadcastable shape."""

    def __init__(self, size: Sequence[int], device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.size = tuple(size)
        self.bias = new_parameter(self.size, device, dtype)

    def build(self, generator):
        fill_(self.bias, torch.zeros(self.size))
        return self

    def call(self, x, *, training: bool = False):
        return x + self.bias


class CMul(Layer):
    def __init__(self, size: Sequence[int], device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.size = tuple(size)
        self.weight = new_parameter(self.size, device, dtype)

    def build(self, generator):
        fill_(self.weight, torch.ones(self.size))
        return self

    def call(self, x, *, training: bool = False):
        return x * self.weight


class _Elementwise(Layer):
    fn = staticmethod(lambda x: x)

    def call(self, x, *, training: bool = False):
        return type(self).fn(x)


class AddConstant(Layer):
    def __init__(self, constant_scalar: float, name: Optional[str] = None):
        super().__init__(name=name)
        self.c = constant_scalar

    def call(self, x, *, training: bool = False):
        return x + self.c


class MulConstant(Layer):
    def __init__(self, constant_scalar: float, name: Optional[str] = None):
        super().__init__(name=name)
        self.c = constant_scalar

    def call(self, x, *, training: bool = False):
        return x * self.c


class Abs(_Elementwise):
    fn = staticmethod(torch.abs)


class Exp(_Elementwise):
    fn = staticmethod(torch.exp)


class Log(_Elementwise):
    fn = staticmethod(torch.log)


class Square(_Elementwise):
    fn = staticmethod(torch.square)


class Sqrt(_Elementwise):
    fn = staticmethod(torch.sqrt)


class Negative(_Elementwise):
    fn = staticmethod(torch.negative)


class Identity(_Elementwise):
    pass


class Power(Layer):
    """y = (scale·x + shift)^power."""

    def __init__(self, power: float, scale: float = 1.0, shift: float = 0.0,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.power, self.scale, self.shift = power, scale, shift

    def call(self, x, *, training: bool = False):
        return torch.pow(self.scale * x + self.shift, self.power)


class Clamp(Layer):
    def __init__(self, min: float, max: float, name: Optional[str] = None):
        super().__init__(name=name)
        self.min_v, self.max_v = float(min), float(max)

    def call(self, x, *, training: bool = False):
        return torch.clamp(x, self.min_v, self.max_v)


class HardTanh(Clamp):
    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 **kw):
        super().__init__(min_value, max_value, **kw)


class HardShrink(Layer):
    def __init__(self, value: float = 0.5, name: Optional[str] = None):
        super().__init__(name=name)
        self.value = value

    def call(self, x, *, training: bool = False):
        return torch.where(x.abs() > self.value, x, torch.zeros_like(x))


class SoftShrink(Layer):
    def __init__(self, value: float = 0.5, name: Optional[str] = None):
        super().__init__(name=name)
        self.value = value

    def call(self, x, *, training: bool = False):
        return torch.sign(x) * torch.clamp(x.abs() - self.value, min=0.0)


class Threshold(Layer):
    """y = x if x > th else v."""

    def __init__(self, th: float = 1e-6, v: float = 0.0,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.th, self.v = th, v

    def call(self, x, *, training: bool = False):
        return torch.where(x > self.th, x, torch.full_like(x, self.v))


# ---------------------------------------------------------------------------
# Long-tail parity layers (`keras/layers/*.scala` remaining inventory)
# ---------------------------------------------------------------------------
class Softmax(Layer):
    """Softmax as a layer (`Softmax.scala`); the last axis by default."""

    def __init__(self, axis: int = -1, name: Optional[str] = None):
        super().__init__(name=name)
        self.axis = int(axis)

    def call(self, x, *, training: bool = False):
        return torch.softmax(x, dim=self.axis)


class BinaryThreshold(Layer):
    """`BinaryThreshold.scala`: an element below th → 0, else 1."""

    def __init__(self, th: float = 1e-6, name: Optional[str] = None):
        super().__init__(name=name)
        self.th = float(th)

    def call(self, x, *, training: bool = False):
        return (x >= self.th).to(torch.float32)


class Mul(Layer):
    """`Mul.scala`: the input times ONE learnable scalar, U(−0.05, 0.05) at
    build."""

    def __init__(self, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.weight = new_parameter((1,), device, dtype)

    def build(self, generator):
        fill_(self.weight, torch.rand(1, generator=generator) * 0.1 - 0.05)
        return self

    def call(self, x, *, training: bool = False):
        return x * self.weight


class Max(Layer):
    """`Max.scala`: the max over axis `dim` (counted with the batch, which
    it may not be); `return_value=False` gives the argmax (int32)
    instead."""

    def __init__(self, dim: int, return_value: bool = True,
                 name: Optional[str] = None):
        super().__init__(name=name)
        if dim < 1:
            raise ValueError("Max cannot reduce the batch dimension")
        self.dim = int(dim)
        self.return_value = return_value

    def call(self, x, *, training: bool = False):
        if self.return_value:
            return x.amax(dim=self.dim)
        return x.argmax(dim=self.dim).to(torch.int32)

    def compute_output_shape(self, input_shape):
        shape = list(input_shape)
        del shape[self.dim]
        return tuple(shape)


class RReLU(_Random):
    """`RReLU.scala`: a randomized leaky ReLU, its slope U(lower, upper) an
    element in training and (lower + upper) / 2 otherwise."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.lower, self.upper = float(lower), float(upper)

    def inference(self, x):
        return self.apply(x, (self.lower + self.upper) / 2.0)

    def noise(self, shape, seed, device):
        u, = uniform_noise(shape, seed, device)
        return self.lower + (self.upper - self.lower) * u

    def apply(self, x, draw):
        return torch.clamp(x, min=0.0) + draw * torch.clamp(x, max=0.0)


class SelectTable(Layer):
    """`SelectTable.scala`: element `index` (0-based) of a list input."""

    def __init__(self, index: int, name: Optional[str] = None):
        super().__init__(name=name)
        self.index = int(index)

    def call(self, x, *, training: bool = False):
        if not isinstance(x, (list, tuple)):
            raise ValueError("SelectTable expects a list input")
        return x[self.index]

    def compute_output_shape(self, input_shape):
        return input_shape[self.index]


class SplitTensor(Layer):
    """`SplitTensor.scala`: split axis `dimension` (counted with the batch,
    which it may not be) into `num` equal parts, as a list."""

    def __init__(self, dimension: int, num: int, name: Optional[str] = None):
        super().__init__(name=name)
        if dimension == 0:
            raise ValueError("SplitTensor cannot split the batch dimension")
        self.dimension, self.num = int(dimension), int(num)

    def call(self, x, *, training: bool = False):
        return list(x.chunk(self.num, dim=self.dimension))

    def compute_output_shape(self, input_shape):
        shape = list(input_shape)
        if shape[self.dimension] is not None:
            if shape[self.dimension] % self.num:
                raise ValueError(
                    f"SplitTensor: dim {self.dimension} size "
                    f"{shape[self.dimension]} not divisible by {self.num}")
            shape[self.dimension] //= self.num
        return [tuple(shape)] * self.num


class Expand(Layer):
    """`Expand.scala` (InternalExpand): broadcast singleton axes to
    `tgt_sizes` (the whole shape, batch included; -1 keeps an axis)."""

    def __init__(self, tgt_sizes: Sequence[int], name: Optional[str] = None):
        super().__init__(name=name)
        self.tgt_sizes = tuple(int(d) for d in tgt_sizes)

    def _target(self, in_shape) -> Tuple:
        if len(self.tgt_sizes) != len(in_shape):
            raise ValueError(
                f"Expand tgt_sizes rank {len(self.tgt_sizes)} != input "
                f"rank {len(in_shape)} (shape {tuple(in_shape)})")
        return tuple(s if t == -1 else t
                     for t, s in zip(self.tgt_sizes, in_shape))

    def call(self, x, *, training: bool = False):
        return x.expand(self._target(x.shape))

    def compute_output_shape(self, input_shape):
        return self._target(input_shape)


class GetShape(Layer):
    """`GetShape.scala`: the input's shape (batch included) as an int32
    tensor."""

    def call(self, x, *, training: bool = False):
        return torch.tensor(tuple(x.shape), dtype=torch.int32,
                            device=x.device)

    def compute_output_shape(self, input_shape):
        return (len(input_shape),)


class ShareConvolution2D(Convolution2D):
    """`ShareConvolution2D.scala`: a 2-d convolution whose weights are
    meant for sharing across graph sites (calling one layer at several
    nodes shares them); `propagate_back=False` stops the input's
    gradient."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, subsample=(1, 1),
                 border_mode: str = "valid", propagate_back: bool = True,
                 **kw):
        super().__init__(nb_filter, nb_row, nb_col, activation=activation,
                         subsample=subsample, border_mode=border_mode, **kw)
        self.propagate_back = propagate_back

    def call(self, x, *, training: bool = False):
        if not self.propagate_back:
            x = x.detach()
        return super().call(x, training=training)


class SparseDense(Dense):
    """`SparseDense.scala` on dense-coded sparse rows: a Dense that does not
    backpropagate into its input unless `propagate_back=True` (the
    reference's suppressed gradInput)."""

    def __init__(self, output_dim: int, activation=None,
                 propagate_back: bool = False, **kw):
        super().__init__(output_dim, activation=activation, **kw)
        self.propagate_back = propagate_back

    def call(self, x, *, training: bool = False):
        if not self.propagate_back:
            x = x.detach()
        return super().call(x, training=training)


class SparseEmbedding(Layer):
    """`SparseEmbedding.scala`: the lookup of id lists padded with 0 (the
    sparse tensor's role); padding positions give zero vectors. The table
    is U(−0.05, 0.05) at build."""

    def __init__(self, input_dim: int, output_dim: int,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.input_dim, self.output_dim = int(input_dim), int(output_dim)
        self.embeddings = new_parameter((self.input_dim, self.output_dim),
                                        device, dtype)

    def build(self, generator):
        shape = (self.input_dim, self.output_dim)
        fill_(self.embeddings, torch.rand(shape, generator=generator) * 0.1
              - 0.05)
        return self

    def call(self, x, *, training: bool = False):
        ids = torch.as_tensor(x).long()
        vecs = F.embedding(ids, self.embeddings)
        return vecs * (ids != 0).unsqueeze(-1).to(vecs.dtype)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape) + (self.output_dim,)
