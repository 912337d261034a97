"""ImageSet + image preprocessing pipeline.

Copied from `analytics_zoo_tpu/data/image.py` (L1-737): `load_image`
(L35), every transform (`ImageProcessing` L49 to `ImageMatToTensor`
L533), `parallel_map_ordered` (L547), `ImageSet` (L578),
`image_folder_dataset` (L641) and its lazy dataset (L672). `cv2` is
imported inside the calls that need it (`load_image`, the resizes, the
HSV jitters), where the JAX package imports it at the top in a `try`
(L21-25): the package imports on a host without OpenCV, and the
numpy-only transforms run there.

The reference's distributed image pipeline (`zoo/.../feature/image/
ImageSet.scala:368` + OpenCV-backed `ImageProcessing` transforms inherited
from BigDL: Resize/Crop/Normalize/Brightness/Flip, python mirrors
`pyzoo/zoo/feature/image/imagePreprocessing.py`). Same composable-transform
surface here over numpy/cv2 on the host; the output feeds the mesh as NHWC
float batches (TPU-native layout). Host-side augmentation parallelizes over
XShards; device-side normalization could fuse into the jit program but is
kept host-side for reference parity.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np


def _require_cv2():
    """The `cv2` module, imported at first use."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "opencv-python (cv2) is required for image decoding/resizing; "
            "it is unavailable in this environment") from e
    return cv2


def load_image(value) -> np.ndarray:
    """Image path or raw encoded bytes -> RGB HWC uint8 ndarray (the serving
    client's image ingestion; reference ships b64 JPEG, `client.py:114`)."""
    cv2 = _require_cv2()
    if isinstance(value, (bytes, bytearray)):
        arr = cv2.imdecode(np.frombuffer(bytes(value), np.uint8),
                           cv2.IMREAD_COLOR)
    else:
        arr = cv2.imread(str(value))
    if arr is None:
        raise ValueError("Could not decode image input")
    return cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)


class ImageProcessing:
    """Composable transform; `>>` or `chain` composes (the reference's
    `->` pipeline operator)."""

    def apply(self, img: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def __call__(self, img):
        return self.apply(img)

    def __rshift__(self, other: "ImageProcessing") -> "ChainedPreprocessing":
        return ChainedPreprocessing([self, other])


class ChainedPreprocessing(ImageProcessing):
    def __init__(self, transforms: Sequence[ImageProcessing]):
        self.transforms = list(transforms)

    def apply(self, img):
        for t in self.transforms:
            img = t.apply(img)
        return img

    def __rshift__(self, other):
        return ChainedPreprocessing(self.transforms + [other])


class ImageResize(ImageProcessing):
    """`ImageResize` (bilinear, W×H)."""

    def __init__(self, resize_h: int, resize_w: int):
        self.h, self.w = resize_h, resize_w

    def apply(self, img):
        cv2 = _require_cv2()
        return cv2.resize(img, (self.w, self.h),
                          interpolation=cv2.INTER_LINEAR)


class ImageCenterCrop(ImageProcessing):
    def __init__(self, crop_h: int, crop_w: int):
        self.h, self.w = crop_h, crop_w

    def apply(self, img):
        H, W = img.shape[:2]
        if H < self.h or W < self.w:
            raise ValueError(f"Image {H}x{W} smaller than crop "
                             f"{self.h}x{self.w}")
        y0 = (H - self.h) // 2
        x0 = (W - self.w) // 2
        return img[y0:y0 + self.h, x0:x0 + self.w]


class ImageRandomCrop(ImageProcessing):
    def __init__(self, crop_h: int, crop_w: int, seed: Optional[int] = None):
        self.h, self.w = crop_h, crop_w
        self.rng = np.random.RandomState(seed)

    def apply(self, img):
        H, W = img.shape[:2]
        if H < self.h or W < self.w:
            raise ValueError(f"Image {H}x{W} smaller than crop "
                             f"{self.h}x{self.w}")
        y0 = self.rng.randint(0, H - self.h + 1)
        x0 = self.rng.randint(0, W - self.w + 1)
        return img[y0:y0 + self.h, x0:x0 + self.w]


class ImageHFlip(ImageProcessing):
    """Horizontal flip with probability p (`ImageHFlip`)."""

    def __init__(self, p: float = 0.5, seed: Optional[int] = None):
        self.p = p
        self.rng = np.random.RandomState(seed)

    def apply(self, img):
        if self.rng.rand() < self.p:
            return img[:, ::-1].copy()
        return img


class ImageBrightness(ImageProcessing):
    """Additive brightness jitter in [delta_low, delta_high]
    (`ImageBrightness`)."""

    def __init__(self, delta_low: float = -32.0, delta_high: float = 32.0,
                 seed: Optional[int] = None):
        self.low, self.high = delta_low, delta_high
        self.rng = np.random.RandomState(seed)

    def apply(self, img):
        return img.astype(np.float32) + self.rng.uniform(self.low, self.high)


class ImageChannelNormalize(ImageProcessing):
    """(x - mean) / std per channel (`ImageChannelNormalize`)."""

    def __init__(self, mean_r: float, mean_g: float, mean_b: float,
                 std_r: float = 1.0, std_g: float = 1.0, std_b: float = 1.0):
        self.mean = np.array([mean_r, mean_g, mean_b], np.float32)
        self.std = np.array([std_r, std_g, std_b], np.float32)

    def apply(self, img):
        return (img.astype(np.float32) - self.mean) / self.std


def _as_uint8(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return img
    return np.clip(img, 0, 255).astype(np.uint8)


class ImageHue(ImageProcessing):
    """Random hue rotation: H += delta ∈ [delta_low, delta_high] in HSV
    space, wrapping over OpenCV's 0-180 hue range (`ImageHue.scala` /
    BigDL `augmentation.Hue`)."""

    def __init__(self, delta_low: float = -18.0, delta_high: float = 18.0,
                 seed: Optional[int] = None):
        self.low, self.high = delta_low, delta_high
        self.rng = np.random.RandomState(seed)

    def apply(self, img):
        cv2 = _require_cv2()
        delta = self.rng.uniform(self.low, self.high)
        hsv = cv2.cvtColor(_as_uint8(img), cv2.COLOR_RGB2HSV).astype(
            np.int32)
        hsv[..., 0] = (hsv[..., 0] + int(round(delta))) % 180
        return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)


class ImageSaturation(ImageProcessing):
    """Random saturation scale: S *= f ∈ [delta_low, delta_high]
    (`ImageSaturation.scala`). A grayscale image is a fixed point."""

    def __init__(self, delta_low: float = 0.5, delta_high: float = 1.5,
                 seed: Optional[int] = None):
        self.low, self.high = delta_low, delta_high
        self.rng = np.random.RandomState(seed)

    def apply(self, img):
        cv2 = _require_cv2()
        f = self.rng.uniform(self.low, self.high)
        hsv = cv2.cvtColor(_as_uint8(img), cv2.COLOR_RGB2HSV).astype(
            np.float32)
        hsv[..., 1] = np.clip(hsv[..., 1] * f, 0, 255)
        return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)


class ImageContrast(ImageProcessing):
    """Random contrast scale: x *= f ∈ [delta_low, delta_high] (BigDL
    `augmentation.Contrast`, the ColorJitter contrast leg)."""

    def __init__(self, delta_low: float = 0.5, delta_high: float = 1.5,
                 seed: Optional[int] = None):
        self.low, self.high = delta_low, delta_high
        self.rng = np.random.RandomState(seed)

    def apply(self, img):
        f = self.rng.uniform(self.low, self.high)
        return np.clip(img.astype(np.float32) * f, 0, 255).astype(img.dtype)


class ImageChannelOrder(ImageProcessing):
    """Random channel permutation (`ImageChannelOrder.scala`)."""

    def __init__(self, seed: Optional[int] = None):
        self.rng = np.random.RandomState(seed)

    def apply(self, img):
        return img[..., self.rng.permutation(img.shape[-1])]


class ImageColorJitter(ImageProcessing):
    """The SSD photometric distortion stack (`ImageColorJitter.scala`):
    probabilistic brightness, then contrast either before or after the
    saturation+hue pair (coin flip — the Caffe two-order rule), then
    probabilistic channel shuffle; `shuffle=True` instead applies all
    four ops in a random order."""

    def __init__(self, brightness_prob: float = 0.5,
                 brightness_delta: float = 32.0,
                 contrast_prob: float = 0.5, contrast_lower: float = 0.5,
                 contrast_upper: float = 1.5, hue_prob: float = 0.5,
                 hue_delta: float = 18.0, saturation_prob: float = 0.5,
                 saturation_lower: float = 0.5,
                 saturation_upper: float = 1.5,
                 random_order_prob: float = 0.0, shuffle: bool = False,
                 seed: Optional[int] = None):
        self.rng = np.random.RandomState(seed)

        def sub():
            return int(self.rng.randint(0, 2 ** 31 - 1))

        self.brightness = (brightness_prob, ImageBrightness(
            -brightness_delta, brightness_delta, seed=sub()))
        self.contrast = (contrast_prob, ImageContrast(
            contrast_lower, contrast_upper, seed=sub()))
        self.saturation = (saturation_prob, ImageSaturation(
            saturation_lower, saturation_upper, seed=sub()))
        self.hue = (hue_prob, ImageHue(-hue_delta, hue_delta, seed=sub()))
        self.channel_order = (random_order_prob,
                              ImageChannelOrder(seed=sub()))
        self.shuffle = shuffle

    def _maybe(self, img, prob_op):
        p, op = prob_op
        if self.rng.rand() < p:
            img = _as_uint8(op.apply(img))
        return img

    def apply(self, img):
        img = _as_uint8(img)
        if self.shuffle:
            ops = [self.brightness, self.contrast, self.saturation,
                   self.hue]
            for i in self.rng.permutation(len(ops)):
                img = self._maybe(img, ops[i])
        else:
            img = self._maybe(img, self.brightness)
            if self.rng.rand() < 0.5:
                img = self._maybe(img, self.contrast)
                img = self._maybe(img, self.saturation)
                img = self._maybe(img, self.hue)
            else:
                img = self._maybe(img, self.saturation)
                img = self._maybe(img, self.hue)
                img = self._maybe(img, self.contrast)
        return self._maybe(img, self.channel_order)


class ImageExpand(ImageProcessing):
    """Paste into a mean-filled canvas of random ratio ∈
    [min_expand_ratio, max_expand_ratio] at a random offset
    (`ImageExpand.scala`; the bbox-tracking variant is
    `data/roi.py RoiExpand`)."""

    def __init__(self, means_r: float = 123.0, means_g: float = 117.0,
                 means_b: float = 104.0, min_expand_ratio: float = 1.0,
                 max_expand_ratio: float = 4.0,
                 seed: Optional[int] = None):
        if min_expand_ratio < 1.0:
            raise ValueError("min_expand_ratio must be >= 1 (expand only "
                             "grows the canvas; use a crop to shrink)")
        self.means = np.array([means_r, means_g, means_b], np.float32)
        self.min_ratio, self.max_ratio = min_expand_ratio, max_expand_ratio
        self.rng = np.random.RandomState(seed)

    def apply(self, img):
        H, W = img.shape[:2]
        r = self.rng.uniform(self.min_ratio, self.max_ratio)
        nH, nW = int(round(H * r)), int(round(W * r))
        y0 = int(self.rng.uniform(0, nH - H + 1))
        x0 = int(self.rng.uniform(0, nW - W + 1))
        canvas = np.empty((nH, nW, img.shape[2]), img.dtype)
        canvas[...] = self.means.astype(img.dtype)
        canvas[y0:y0 + H, x0:x0 + W] = img
        return canvas


class ImageFiller(ImageProcessing):
    """Fill a normalized-coordinate sub-rectangle with a constant
    (occlusion augmentation, `ImageFiller.scala`)."""

    def __init__(self, start_x: float, start_y: float, end_x: float,
                 end_y: float, value: int = 255):
        if not (0 <= start_x <= end_x <= 1 and 0 <= start_y <= end_y <= 1):
            raise ValueError("filler rect must satisfy "
                             "0 <= start <= end <= 1")
        self.rect = (start_x, start_y, end_x, end_y)
        self.value = value

    def apply(self, img):
        H, W = img.shape[:2]
        x1, y1, x2, y2 = self.rect
        out = img.copy()
        out[int(y1 * H):int(y2 * H), int(x1 * W):int(x2 * W)] = self.value
        return out


class ImageFixedCrop(ImageProcessing):
    """Crop a fixed region given in normalized or pixel coordinates;
    `is_clip` clips the region to the image bounds first
    (`ImageFixedCrop.scala`)."""

    def __init__(self, x1: float, y1: float, x2: float, y2: float,
                 normalized: bool = True, is_clip: bool = True):
        self.box = (x1, y1, x2, y2)
        self.normalized = normalized
        self.is_clip = is_clip

    def apply(self, img):
        H, W = img.shape[:2]
        x1, y1, x2, y2 = self.box
        if self.normalized:
            x1, y1, x2, y2 = x1 * W, y1 * H, x2 * W, y2 * H
        if self.is_clip:
            x1, x2 = np.clip([x1, x2], 0.0, float(W))
            y1, y2 = np.clip([y1, y2], 0.0, float(H))
            x1, y1 = min(x1, W - 1.0), min(y1, H - 1.0)
        xi1, yi1 = int(round(x1)), int(round(y1))
        xi2, yi2 = max(xi1 + 1, int(round(x2))), max(yi1 + 1,
                                                     int(round(y2)))
        if not (0 <= xi1 < W and 0 <= yi1 < H and xi2 <= W and yi2 <= H):
            raise ValueError(
                f"crop {self.box} out of bounds for {H}x{W} image" +
                ("" if self.is_clip else " (pass is_clip=True to clip)"))
        return img[yi1:yi2, xi1:xi2].copy()


class ImageMirror(ImageProcessing):
    """Flip around BOTH axes (`ImageMirror.scala` = `Core.flip(mat, -1)`);
    for the horizontal-only flip use `ImageHFlip`."""

    def apply(self, img):
        return img[::-1, ::-1].copy()


class ImageRandomResize(ImageProcessing):
    """Resize to SxS with S drawn uniformly from [min_size, max_size)
    (`ImageRandomResize.scala`)."""

    def __init__(self, min_size: int, max_size: int,
                 seed: Optional[int] = None):
        self.min_size, self.max_size = min_size, max_size
        self.rng = np.random.RandomState(seed)

    def apply(self, img):
        cv2 = _require_cv2()
        s = int(self.rng.randint(self.min_size, max(self.min_size + 1,
                                                    self.max_size)))
        return cv2.resize(img, (s, s), interpolation=cv2.INTER_LINEAR)


class ImageAspectScale(ImageProcessing):
    """Scale the SHORT edge to min_size keeping aspect ratio, cap the long
    edge at max_size, round dims down to a multiple of scale_multiple_of
    (`ImageAspectScale` in the pyzoo surface / Faster-RCNN input prep)."""

    def __init__(self, min_size: int, scale_multiple_of: int = 1,
                 max_size: int = 1000):
        self.min_size = min_size
        self.multiple = scale_multiple_of
        self.max_size = max_size

    def _target(self, H: int, W: int) -> Tuple[int, int]:
        short, long = min(H, W), max(H, W)
        scale = self.min_size / short
        if long * scale > self.max_size:
            scale = self.max_size / long
        nH, nW = int(round(H * scale)), int(round(W * scale))
        if self.multiple > 1:
            nH = max(self.multiple, nH // self.multiple * self.multiple)
            nW = max(self.multiple, nW // self.multiple * self.multiple)
        return nH, nW

    def apply(self, img):
        cv2 = _require_cv2()
        nH, nW = self._target(*img.shape[:2])
        return cv2.resize(img, (nW, nH), interpolation=cv2.INTER_LINEAR)


class ImageRandomAspectScale(ImageAspectScale):
    """Aspect-preserving scale with the short-edge target drawn from
    `scales` (`ImageRandomAspectScale`)."""

    def __init__(self, scales: Sequence[int], scale_multiple_of: int = 1,
                 max_size: int = 1000, seed: Optional[int] = None):
        super().__init__(int(scales[0]), scale_multiple_of, max_size)
        self.scales = [int(s) for s in scales]
        self.rng = np.random.RandomState(seed)

    def apply(self, img):
        # local draw, no shared-state mutation: transform objects are
        # called concurrently from the threaded pipeline
        cv2 = _require_cv2()
        pick = self.scales[self.rng.randint(len(self.scales))]
        nH, nW = ImageAspectScale(
            pick, self.multiple, self.max_size)._target(*img.shape[:2])
        return cv2.resize(img, (nW, nH), interpolation=cv2.INTER_LINEAR)


class ImageChannelScaledNormalizer(ImageProcessing):
    """(x - mean_c) * scale (`ImageChannelScaledNormalizer.scala`)."""

    def __init__(self, mean_r: float, mean_g: float, mean_b: float,
                 scale: float):
        self.mean = np.array([mean_r, mean_g, mean_b], np.float32)
        self.scale = scale

    def apply(self, img):
        return (img.astype(np.float32) - self.mean) * self.scale


class ImagePixelNormalize(ImageProcessing):
    """Per-pixel mean subtraction: data - means, means in HWC order
    (`ImagePixelNormalizer.scala`)."""

    def __init__(self, means: np.ndarray):
        self.means = np.asarray(means, np.float32)

    def apply(self, img):
        if self.means.shape != img.shape:
            raise ValueError(
                f"pixel means shape {self.means.shape} != image shape "
                f"{img.shape}")
        return img.astype(np.float32) - self.means


# opencv NormTypes used by the reference's PerImageNormalize
NORM_INF, NORM_L1, NORM_L2, NORM_MINMAX = 1, 2, 4, 32


class PerImageNormalize(ImageProcessing):
    """Per-image cv::normalize semantics (`PerImageNormalize` in the pyzoo
    surface): MINMAX maps the value range onto [min, max]; the norm types
    scale so that the chosen norm equals `min`."""

    def __init__(self, min: float, max: float = 0.0,
                 norm_type: int = NORM_MINMAX):
        self.min, self.max = float(min), float(max)
        self.norm_type = norm_type

    def apply(self, img):
        x = img.astype(np.float32)
        if self.norm_type == NORM_MINMAX:
            lo, hi = float(x.min()), float(x.max())
            span = hi - lo if hi > lo else 1.0
            a, b = min(self.min, self.max), max(self.min, self.max)
            return (x - lo) / span * (b - a) + a
        norm = {NORM_INF: np.abs(x).max(),
                NORM_L1: np.abs(x).sum(),
                NORM_L2: np.sqrt((x * x).sum())}.get(self.norm_type)
        if norm is None:
            raise ValueError(f"Unsupported norm_type {self.norm_type}")
        return x * (self.min / max(float(norm), 1e-12))


class ImageRandomPreprocessing(ImageProcessing):
    """Apply the wrapped transform with probability p
    (`ImageRandomPreprocessing.scala`)."""

    def __init__(self, transform: ImageProcessing, p: float = 0.5,
                 seed: Optional[int] = None):
        self.transform = transform
        self.p = p
        self.rng = np.random.RandomState(seed)

    def apply(self, img):
        if self.rng.rand() < self.p:
            return self.transform.apply(img)
        return img


class ImageRandomCropper(ImageProcessing):
    """Fixed-size crop by random or center placement plus optional random
    horizontal mirror (`ImageRandomCropper.scala`, BigDL RandomCropper)."""

    def __init__(self, crop_width: int, crop_height: int,
                 mirror: bool = False, cropper_method: str = "random",
                 seed: Optional[int] = None):
        if cropper_method not in ("random", "center"):
            raise ValueError("cropper_method must be 'random' or 'center'")
        self.w, self.h = crop_width, crop_height
        self.mirror = mirror
        self.method = cropper_method
        self.rng = np.random.RandomState(seed)

    def apply(self, img):
        H, W = img.shape[:2]
        if H < self.h or W < self.w:
            raise ValueError(f"Image {H}x{W} smaller than crop "
                             f"{self.h}x{self.w}")
        if self.method == "center":
            y0, x0 = (H - self.h) // 2, (W - self.w) // 2
        else:
            y0 = self.rng.randint(0, H - self.h + 1)
            x0 = self.rng.randint(0, W - self.w + 1)
        out = img[y0:y0 + self.h, x0:x0 + self.w]
        if self.mirror and self.rng.rand() < 0.5:
            out = out[:, ::-1]
        return out.copy()


class ImageMatToTensor(ImageProcessing):
    """To float32; NHWC stays native (TPU conv layout) unless
    format='NCHW' requested (`ImageMatToTensor` toChw)."""

    def __init__(self, format: str = "NHWC"):
        self.format = format

    def apply(self, img):
        img = img.astype(np.float32)
        if self.format == "NCHW":
            return np.transpose(img, (2, 0, 1))
        return img


def parallel_map_ordered(fn, items: Sequence[Any], num_workers: int,
                         window: Optional[int] = None):
    """Order-preserving threaded map with a bounded in-flight window —
    decode/augment overlap without holding the whole corpus in futures.
    cv2 releases the GIL in decode/resize, so threads give real
    parallelism on the hot ops."""
    if num_workers <= 1:
        for it in items:
            yield fn(it)
        return
    import collections
    from concurrent.futures import ThreadPoolExecutor
    window = window or num_workers * 4
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        pending: "collections.deque" = collections.deque()
        it = iter(items)
        try:
            for _ in range(window):
                pending.append(pool.submit(fn, next(it)))
        except StopIteration:
            it = None
        while pending:
            done = pending.popleft()
            if it is not None:
                try:
                    pending.append(pool.submit(fn, next(it)))
                except StopIteration:
                    it = None
            yield done.result()


class ImageSet:
    """Collection of images + optional labels (`ImageSet.scala:368`
    read/transform surface), sharded like XShards."""

    def __init__(self, images: List[np.ndarray],
                 labels: Optional[np.ndarray] = None,
                 paths: Optional[List[str]] = None):
        self.images = images
        self.labels = labels
        self.paths = paths

    @staticmethod
    def _list_files(path: str) -> List[str]:
        if os.path.isdir(path):
            files = sorted(glob.glob(os.path.join(path, "**", "*.*"),
                                     recursive=True))
            files = [f for f in files if f.rsplit(".", 1)[-1].lower() in
                     ("jpg", "jpeg", "png", "bmp")]
        else:
            files = [path]
        if not files:
            raise FileNotFoundError(f"No images under {path}")
        return files

    @staticmethod
    def _folder_labels(files: List[str],
                       one_based_label: bool) -> np.ndarray:
        classes = sorted({os.path.basename(os.path.dirname(f))
                          for f in files})
        base = 1 if one_based_label else 0
        cls_idx = {c: i + base for i, c in enumerate(classes)}
        return np.array([cls_idx[os.path.basename(os.path.dirname(f))]
                         for f in files], np.int32)

    @staticmethod
    def read(path: str, with_label: bool = False,
             one_based_label: bool = True,
             num_workers: int = 1) -> "ImageSet":
        """Read image file/dir (optionally `dir/<class>/img.jpg` layout for
        labels, like `ImageSet.read` + label resolution); `num_workers > 1`
        decodes in a thread pool."""
        files = ImageSet._list_files(path)
        _require_cv2()
        images = list(parallel_map_ordered(load_image, files, num_workers))
        labels = (ImageSet._folder_labels(files, one_based_label)
                  if with_label else None)
        return ImageSet(images, labels, files)

    def transform(self, transformer: ImageProcessing,
                  num_workers: int = 1) -> "ImageSet":
        return ImageSet(list(parallel_map_ordered(
            transformer, self.images, num_workers)),
            self.labels, self.paths)

    def to_dataset(self, batch_size: int = -1, batch_per_thread: int = -1):
        from analytics_zoo_tpu_torch.data.dataset import TPUDataset
        x = np.stack(self.images)
        return TPUDataset(x, self.labels, batch_size, batch_per_thread)

    def __len__(self):
        return len(self.images)


def image_folder_dataset(path: str, transform=None,
                         with_label: bool = True,
                         one_based_label: bool = False,
                         batch_size: int = -1, batch_per_thread: int = -1,
                         shuffle: bool = True, num_workers: int = 8,
                         prefetch_batches: int = 2):
    """Lazy `dir/<class>/img.jpg` dataset: JPEG decode + augmentation run
    in a thread pool overlapped with the training step, so image training
    is not single-thread-Python bound (the role of the reference's
    per-executor OpenCV pipeline feeding `FeatureSet`; here the
    parallelism is host threads instead of Spark partitions).

    `transform` must produce a fixed output shape (the batch is stacked).
    With num_workers > 1 the per-op RNG draws land in nondeterministic
    order across samples — seed order is only reproducible at
    num_workers=1."""
    files = ImageSet._list_files(path)
    labels = (ImageSet._folder_labels(files, one_based_label)
              if with_label else None)
    return _ImageFolderDataset(files, labels, transform, batch_size,
                               batch_per_thread, shuffle, num_workers,
                               prefetch_batches)


def _default_float(img):
    return np.asarray(img, np.float32)


_folder_dataset_cls = None


def _ImageFolderDataset(*args, **kwargs):
    """Lazy TPUDataset over image files (decode+augment in threads). The
    class is built once on first use against a late TPUDataset import
    (avoids the dataset<->image import cycle)."""
    global _folder_dataset_cls
    if _folder_dataset_cls is None:
        from analytics_zoo_tpu_torch.data.dataset import TPUDataset

        class _Impl(TPUDataset):
            def __init__(self, files, labels, transform, batch_size,
                         batch_per_thread, shuffle, num_workers,
                         prefetch_batches):
                super().__init__(x=None, y=None, batch_size=batch_size,
                                 batch_per_thread=batch_per_thread,
                                 shuffle=shuffle)
                self._files = files
                self._labels = labels
                self._transform = transform or _default_float
                self._workers = num_workers
                self._prefetch = max(1, prefetch_batches)

            def _load_one(self, i: int):
                img = self._transform(load_image(self._files[i]))
                y = None if self._labels is None else self._labels[i]
                return np.asarray(img, np.float32), y

            def n_samples(self) -> int:
                return len(self._files)

            def first_sample(self):
                return self._load_one(0)

            def materialize(self):
                pairs = list(parallel_map_ordered(
                    self._load_one, range(len(self._files)),
                    self._workers))
                x = np.stack([p[0] for p in pairs])
                y = None if self._labels is None \
                    else np.asarray([p[1] for p in pairs])
                return x, y

            def iter_train(self, data_parallel: int, seed: int = 0):
                batch = self.global_batch(data_parallel)
                order = np.arange(len(self._files))
                if self.shuffle:
                    np.random.RandomState(seed).shuffle(order)
                # bounded window = prefetch_batches of decoded samples
                # in flight while the accelerator consumes the current
                # batch
                stream = parallel_map_ordered(
                    self._load_one, order, self._workers,
                    window=batch * self._prefetch)
                buf_x, buf_y = [], []
                for xi, yi in stream:
                    buf_x.append(xi)
                    buf_y.append(yi)
                    if len(buf_x) == batch:
                        yb = None if self._labels is None \
                            else np.asarray(buf_y)
                        yield np.stack(buf_x), yb, batch
                        buf_x, buf_y = [], []
                # tail dropped: the jitted train step needs static shapes

        _Impl.__name__ = "ImageFolderDataset"
        _folder_dataset_cls = _Impl
    return _folder_dataset_cls(*args, **kwargs)
