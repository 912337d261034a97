"""The Keras2-flavoured layer API (`zoo/.../pipeline/api/keras2/layers/`).

Port of `analytics_zoo_tpu/keras2/layers.py`: thin adapters over the
port's `keras.layers` with the keras-2 argument names (units, filters,
kernel_size, strides, padding, kernel_initializer, data_format): `Dense`,
`Conv1D`, `Conv2D`, the 1-d and 2-d pools and global pools; the merge
modes as classes (`Add`, `Multiply`, `Average`, `Maximum`, `Subtract`,
`Minimum`, `Concatenate`, `Dot` with `normalize`) and the functional
`add`, `multiply`, `average`, `maximum` and `concatenate`; and the rest of
the keras2 inventory (`Activation`, `Dropout`, `Flatten`, `Softmax`,
`Cropping1D`, `LocallyConnected1D`, the 1-d and 3-d global pools).
`keras.layers`' own `Conv1D/2D/3D` aliases stay as they are.
"""

from __future__ import annotations

from typing import Optional

import torch

from analytics_zoo_tpu_torch.keras import layers as k1
from analytics_zoo_tpu_torch.keras.engine import Layer


def _pair(v) -> tuple:
    return (v, v) if isinstance(v, int) else tuple(v)


def _data_format_to_ordering(data_format: Optional[str]) -> str:
    if data_format in (None, "channels_last"):
        return "tf"
    if data_format == "channels_first":
        return "th"
    raise ValueError(f"Unsupported data_format: {data_format}")


class Dense(k1.Dense):
    def __init__(self, units: int, activation=None, use_bias: bool = True,
                 kernel_initializer="glorot_uniform", **kw):
        super().__init__(units, activation=activation, use_bias=use_bias,
                         init=kernel_initializer, **kw)


class Conv1D(k1.Convolution1D):
    def __init__(self, filters: int, kernel_size: int, strides: int = 1,
                 padding: str = "valid", activation=None,
                 use_bias: bool = True,
                 kernel_initializer="glorot_uniform", **kw):
        super().__init__(filters, kernel_size, subsample=(strides,),
                         border_mode=padding, activation=activation,
                         use_bias=use_bias, init=kernel_initializer, **kw)


class Conv2D(k1.Convolution2D):
    def __init__(self, filters: int, kernel_size, strides=(1, 1),
                 padding: str = "valid", data_format: Optional[str] = None,
                 activation=None, use_bias: bool = True,
                 kernel_initializer="glorot_uniform", **kw):
        kh, kw_ = _pair(kernel_size)
        super().__init__(filters, kh, kw_, subsample=_pair(strides),
                         border_mode=padding,
                         dim_ordering=_data_format_to_ordering(data_format),
                         activation=activation, use_bias=use_bias,
                         init=kernel_initializer, **kw)


class MaxPooling1D(k1.MaxPooling1D):
    def __init__(self, pool_size: int = 2, strides: Optional[int] = None,
                 padding: str = "valid", **kw):
        super().__init__(pool_length=pool_size, stride=strides,
                         border_mode=padding, **kw)


class AveragePooling1D(k1.AveragePooling1D):
    def __init__(self, pool_size: int = 2, strides: Optional[int] = None,
                 padding: str = "valid", **kw):
        super().__init__(pool_length=pool_size, stride=strides,
                         border_mode=padding, **kw)


class MaxPooling2D(k1.MaxPooling2D):
    def __init__(self, pool_size=(2, 2), strides=None,
                 padding: str = "valid", data_format: Optional[str] = None,
                 **kw):
        super().__init__(pool_size=_pair(pool_size),
                         strides=_pair(strides) if strides else None,
                         border_mode=padding,
                         dim_ordering=_data_format_to_ordering(data_format),
                         **kw)


class AveragePooling2D(k1.AveragePooling2D):
    def __init__(self, pool_size=(2, 2), strides=None,
                 padding: str = "valid", data_format: Optional[str] = None,
                 **kw):
        super().__init__(pool_size=_pair(pool_size),
                         strides=_pair(strides) if strides else None,
                         border_mode=padding,
                         dim_ordering=_data_format_to_ordering(data_format),
                         **kw)


class GlobalMaxPooling2D(k1.GlobalMaxPooling2D):
    def __init__(self, data_format: Optional[str] = None, **kw):
        super().__init__(dim_ordering=_data_format_to_ordering(data_format),
                         **kw)


class GlobalAveragePooling2D(k1.GlobalAveragePooling2D):
    def __init__(self, data_format: Optional[str] = None, **kw):
        super().__init__(dim_ordering=_data_format_to_ordering(data_format),
                         **kw)


# -- merge classes (`keras2/layers/merge.py` flavour) -----------------------
class _MergeBase(k1.Merge):
    mode = "sum"

    def __init__(self, **kw):
        super().__init__(mode=type(self).mode, **kw)


class Add(_MergeBase):
    mode = "sum"


class Multiply(_MergeBase):
    mode = "mul"


class Average(_MergeBase):
    mode = "ave"


class Maximum(_MergeBase):
    mode = "max"


class Subtract(Layer):
    def call(self, xs, *, training: bool = False):
        a, b = xs
        return a - b

    def compute_output_shape(self, input_shapes):
        return input_shapes[0]


class Minimum(Layer):
    def call(self, xs, *, training: bool = False):
        out = xs[0]
        for x in xs[1:]:
            out = torch.minimum(out, x)
        return out

    def compute_output_shape(self, input_shapes):
        return input_shapes[0]


class Concatenate(k1.Merge):
    def __init__(self, axis: int = -1, **kw):
        super().__init__(mode="concat", concat_axis=axis, **kw)


class Dot(Layer):
    """keras2 Dot: a per-sample tensordot over the given axes (counted
    with the batch, which they may not name); `normalize=True`
    L2-normalizes along the contraction axes first (cosine proximity)."""

    def __init__(self, axes=-1, normalize: bool = False,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.axes = tuple(axes) if isinstance(axes, (list, tuple)) \
            else (axes, axes)
        self.normalize = normalize

    def _sample_axes(self, shapes):
        # full-tensor axes as per-sample (batch-stripped) ones
        out = []
        for ax, shape in zip(self.axes, shapes):
            a = ax if ax >= 0 else len(shape) + ax
            if a == 0:
                raise ValueError("Dot axes cannot include the batch dim")
            out.append(a - 1)
        return tuple(out)

    def call(self, xs, *, training: bool = False):
        a, b = xs
        ax_a, ax_b = self._sample_axes([a.shape, b.shape])
        if self.normalize:
            a = a / torch.clamp(torch.linalg.norm(a, dim=ax_a + 1,
                                                  keepdim=True), min=1e-7)
            b = b / torch.clamp(torch.linalg.norm(b, dim=ax_b + 1,
                                                  keepdim=True), min=1e-7)
        a = a.movedim(ax_a + 1, -1)
        b = b.movedim(ax_b + 1, -1)
        n, k = a.shape[0], a.shape[-1]
        rest = tuple(a.shape[1:-1]) + tuple(b.shape[1:-1])
        y = torch.einsum("bik,bjk->bij", a.reshape(n, -1, k),
                         b.reshape(n, -1, k)).reshape((n,) + rest)
        return y[:, None] if y.dim() == 1 else y

    def compute_output_shape(self, input_shapes):
        sa, sb = input_shapes
        ax_a, ax_b = self._sample_axes([sa, sb])
        rest_a = [d for i, d in enumerate(sa[1:]) if i != ax_a]
        rest_b = [d for i, d in enumerate(sb[1:]) if i != ax_b]
        out = tuple([sa[0]] + rest_a + rest_b)
        return out if len(out) > 1 else (sa[0], 1)


def add(inputs, name=None):
    return Add(name=name)(inputs)


def multiply(inputs, name=None):
    return Multiply(name=name)(inputs)


def average(inputs, name=None):
    return Average(name=name)(inputs)


def maximum(inputs, name=None):
    return Maximum(name=name)(inputs)


def concatenate(inputs, axis=-1, name=None):
    return Concatenate(axis=axis, name=name)(inputs)


# ---------------------------------------------------------------------------
# The rest of the keras2 inventory
# ---------------------------------------------------------------------------
class Activation(k1.Activation):
    pass


class Dropout(k1.Dropout):
    def __init__(self, rate: float, **kw):
        super().__init__(rate, **kw)


class Flatten(k1.Flatten):
    def __init__(self, data_format: Optional[str] = None, **kw):
        if data_format == "channels_first":
            # tf.keras moves channels last before flattening; taking the
            # flag would permute the features a downstream Dense sees
            raise NotImplementedError(
                "Flatten(data_format='channels_first') is not supported")
        if data_format not in (None, "channels_last"):
            raise ValueError(f"Unsupported data_format: {data_format}")
        super().__init__(**kw)


class Softmax(k1.Softmax):
    pass


class Cropping1D(k1.Cropping1D):
    pass


class LocallyConnected1D(k1.LocallyConnected1D):
    def __init__(self, filters: int, kernel_size: int, strides: int = 1,
                 padding: str = "valid", activation=None,
                 use_bias: bool = True,
                 kernel_initializer="glorot_uniform", **kw):
        if padding != "valid":
            raise ValueError(
                "LocallyConnected1D only supports padding='valid'")
        super().__init__(filters, kernel_size, activation=activation,
                         subsample_length=strides, use_bias=use_bias,
                         init=kernel_initializer, **kw)


def _check_1d_format(data_format: Optional[str]) -> None:
    if data_format not in (None, "channels_last"):
        raise ValueError(
            "1D global pools are channels_last only "
            f"(got data_format={data_format!r})")


class GlobalMaxPooling1D(k1.GlobalMaxPooling1D):
    def __init__(self, data_format: Optional[str] = None, **kw):
        _check_1d_format(data_format)
        super().__init__(**kw)


class GlobalAveragePooling1D(k1.GlobalAveragePooling1D):
    def __init__(self, data_format: Optional[str] = None, **kw):
        _check_1d_format(data_format)
        super().__init__(**kw)


class GlobalMaxPooling3D(k1.GlobalMaxPooling3D):
    def __init__(self, data_format: Optional[str] = None, **kw):
        super().__init__(
            dim_ordering=_data_format_to_ordering(data_format), **kw)


class GlobalAveragePooling3D(k1.GlobalAveragePooling3D):
    def __init__(self, data_format: Optional[str] = None, **kw):
        super().__init__(
            dim_ordering=_data_format_to_ordering(data_format), **kw)
