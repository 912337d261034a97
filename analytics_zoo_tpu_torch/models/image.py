"""Image classification: the ResNet family, Inception-v1, LeNet-5 and the
`ImageClassifier` wrapper.

Port of `analytics_zoo_tpu/models/image.py`: `_conv_bn` (L28),
`_basic_block` (L37), `_bottleneck_block` (L47), `resnet` (L58; depths 18,
34 and 50, v1.5: the stride sits on the 3×3 convolution of a bottleneck),
`_inception_block` (L84), `inception_v1` (L117), `lenet` (L145,
channels-first) and `ImageClassifier` (L167) with `top_n` and
`predict_image_set`. The graphs are built layer for layer in the JAX
package's order, so `convert` maps weights by graph order: ResNet-50 at
224×224 has 174 layers, 53 convolutions each followed by a BatchNorm, 161
trainable leaves (25,557,032 parameters) and 53,120 moving-statistic
values in buffers.

`device` says where the parameters are created (None is `cuda`; the CPU
only when asked, as everywhere in the port).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.common.device import DeviceLike
from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.keras.engine import Input, Model
from analytics_zoo_tpu_torch.models.common import ZooModel

_CONFIGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
}


def _conv_bn(x, filters, k, stride=1, activation="relu", device=None):
    x = L.Convolution2D(filters, k, k, subsample=(stride, stride),
                        border_mode="same", use_bias=False,
                        device=device)(x)
    x = L.BatchNormalization(device=device)(x)
    if activation:
        x = L.Activation(activation)(x)
    return x


def _basic_block(x, filters, stride, device=None):
    shortcut = x
    y = _conv_bn(x, filters, 3, stride, device=device)
    y = _conv_bn(y, filters, 3, 1, activation=None, device=device)
    if stride != 1 or x.shape[-1] != filters:
        shortcut = _conv_bn(x, filters, 1, stride, activation=None,
                            device=device)
    out = L.merge([y, shortcut], mode="sum")
    return L.Activation("relu")(out)


def _bottleneck_block(x, filters, stride, device=None):
    shortcut = x
    y = _conv_bn(x, filters, 1, 1, device=device)
    y = _conv_bn(y, filters, 3, stride, device=device)
    y = _conv_bn(y, 4 * filters, 1, 1, activation=None, device=device)
    if stride != 1 or x.shape[-1] != 4 * filters:
        shortcut = _conv_bn(x, 4 * filters, 1, stride, activation=None,
                            device=device)
    out = L.merge([y, shortcut], mode="sum")
    return L.Activation("relu")(out)


def resnet(depth: int = 50, class_num: int = 1000,
           input_shape: Sequence[int] = (224, 224, 3),
           include_top: bool = True, device: DeviceLike = None) -> Model:
    """ResNet v1.5 (stride 2 on the 3×3 convolution of bottlenecks),
    NHWC."""
    if depth not in _CONFIGS:
        raise ValueError(f"Unsupported depth {depth}; choose {list(_CONFIGS)}")
    kind, reps = _CONFIGS[depth]
    block = _basic_block if kind == "basic" else _bottleneck_block

    inp = Input(shape=tuple(input_shape))
    x = L.Convolution2D(64, 7, 7, subsample=(2, 2), border_mode="same",
                        use_bias=False, device=device)(inp)
    x = L.BatchNormalization(device=device)(x)
    x = L.Activation("relu")(x)
    x = L.MaxPooling2D(pool_size=(3, 3), strides=(2, 2),
                       border_mode="same")(x)
    filters = 64
    for stage, n in enumerate(reps):
        for i in range(n):
            stride = 2 if (i == 0 and stage > 0) else 1
            x = block(x, filters, stride, device=device)
        filters *= 2
    x = L.GlobalAveragePooling2D()(x)
    if include_top:
        x = L.Dense(class_num, activation="softmax", device=device)(x)
    return Model(inp, x)


def _inception_block(x, c1, c3r, c3, c5r, c5, pp, device=None):
    """One GoogLeNet inception module: 1x1 / 1x1→3x3 / 1x1→5x5 /
    pool→1x1 branches concatenated on channels."""
    b1 = _conv_bn(x, c1, 1, device=device)
    b3 = _conv_bn(_conv_bn(x, c3r, 1, device=device), c3, 3, device=device)
    b5 = _conv_bn(_conv_bn(x, c5r, 1, device=device), c5, 5, device=device)
    bp = L.MaxPooling2D(pool_size=(3, 3), strides=(1, 1),
                        border_mode="same")(x)
    bp = _conv_bn(bp, pp, 1, device=device)
    return L.merge([b1, b3, b5, bp], mode="concat", concat_axis=-1)


# (branch filter tables of GoogLeNet/Inception-v1, stage 3a..5b)
_INCEPTION_V1 = [
    ("3a", 64, 96, 128, 16, 32, 32), ("3b", 128, 128, 192, 32, 96, 64),
    ("pool", ),
    ("4a", 192, 96, 208, 16, 48, 64), ("4b", 160, 112, 224, 24, 64, 64),
    ("4c", 128, 128, 256, 24, 64, 64), ("4d", 112, 144, 288, 32, 64, 64),
    ("4e", 256, 160, 320, 32, 128, 128),
    ("pool", ),
    ("5a", 256, 160, 320, 32, 128, 128),
    ("5b", 384, 192, 384, 48, 128, 128),
]


def inception_v1(class_num: int = 1000,
                 input_shape: Sequence[int] = (224, 224, 3),
                 dropout: float = 0.4, device: DeviceLike = None) -> Model:
    """GoogLeNet/Inception-v1 with BatchNorm after every convolution and no
    auxiliary heads; `dropout` before the classifier runs on the dropout
    kernel in training."""
    inp = Input(shape=tuple(input_shape))
    x = _conv_bn(inp, 64, 7, stride=2, device=device)
    x = L.MaxPooling2D(pool_size=(3, 3), strides=(2, 2),
                       border_mode="same")(x)
    x = _conv_bn(x, 64, 1, device=device)
    x = _conv_bn(x, 192, 3, device=device)
    x = L.MaxPooling2D(pool_size=(3, 3), strides=(2, 2),
                       border_mode="same")(x)
    for row in _INCEPTION_V1:
        if row[0] == "pool":
            x = L.MaxPooling2D(pool_size=(3, 3), strides=(2, 2),
                               border_mode="same")(x)
        else:
            _, c1, c3r, c3, c5r, c5, pp = row
            x = _inception_block(x, c1, c3r, c3, c5r, c5, pp, device=device)
    x = L.GlobalAveragePooling2D()(x)
    if dropout > 0:
        x = L.Dropout(dropout)(x)
    x = L.Dense(class_num, activation="softmax", device=device)(x)
    return Model(inp, x)


def lenet(class_num: int = 10,
          input_shape: Sequence[int] = (1, 28, 28),
          device: DeviceLike = None) -> Model:
    """LeNet-5 (conv20-pool-conv50-pool-fc500-fc10), channels-first like
    its Caffe lineage, so the flatten order matches an imported
    artifact's."""
    inp = Input(shape=tuple(input_shape))
    x = L.Convolution2D(20, 5, 5, border_mode="valid", dim_ordering="th",
                        device=device)(inp)
    x = L.MaxPooling2D(pool_size=(2, 2), strides=(2, 2),
                       dim_ordering="th")(x)
    x = L.Convolution2D(50, 5, 5, border_mode="valid", dim_ordering="th",
                        device=device)(x)
    x = L.MaxPooling2D(pool_size=(2, 2), strides=(2, 2),
                       dim_ordering="th")(x)
    x = L.Flatten()(x)
    x = L.Dense(500, activation="relu", device=device)(x)
    x = L.Dense(class_num, activation="softmax", device=device)(x)
    return Model(inp, x)


class ImageClassifier(ZooModel):
    """Model + label map (`models/image/imageclassification/
    ImageClassifier.scala` surface)."""

    def __init__(self, depth: int = 50, class_num: int = 1000,
                 input_shape: Sequence[int] = (224, 224, 3),
                 label_map: Optional[Dict[int, str]] = None,
                 arch: str = "resnet", device: DeviceLike = None):
        super().__init__()
        # json keys are strings: normalize to int here, stringify in config
        self.label_map = {int(k): v for k, v in (label_map or {}).items()}
        self._config = dict(depth=depth, class_num=class_num,
                            input_shape=list(input_shape),
                            label_map={str(k): v
                                       for k, v in self.label_map.items()},
                            arch=arch)
        if arch == "inception-v1":
            self.model = inception_v1(class_num, input_shape, device=device)
        elif arch == "resnet":
            self.model = resnet(depth, class_num, input_shape, device=device)
        elif arch == "lenet":
            self.model = lenet(class_num, input_shape, device=device)
        else:
            raise ValueError(
                f"Unknown arch {arch!r}: resnet|inception-v1|lenet")

    def top_n(self, probs, top_n: int = 5) -> List[List]:
        """Per-row top-N (label, prob) through the label map."""
        out = []
        for p in np.asarray(probs):
            top = np.argsort(-p)[:top_n]
            out.append([(self.label_map.get(int(i), int(i)), float(p[i]))
                        for i in top])
        return out

    def predict_image_set(self, image_set, top_n: int = 5,
                          batch_per_thread: int = 8) -> List[List]:
        """Classify the images of `image_set` (any object with `.images`,
        a sequence of HWC arrays); returns per-image top-N (label,
        prob)."""
        x = np.stack(image_set.images).astype(np.float32)
        probs = self.predict(x, batch_per_thread=batch_per_thread)
        return self.top_n(probs, top_n)
