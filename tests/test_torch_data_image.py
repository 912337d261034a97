"""The port's image pipeline (`analytics_zoo_tpu_torch/data/image.py`)
held against the JAX package's: every transform bitwise equal on images
made from numpy seeds (the seeded ones through several draws),
`load_image`, `parallel_map_ordered`, `ImageSet` and the lazy
`image_folder_dataset`; the cases of `tests/test_image_ops.py` run
against the port's copy; and a JPEG sent through `ClusterServing` on the
memory broker (`InputQueue.enqueue(image=...)`) answered as the direct
forward of `load_image`'s pixels."""

import os
import time

import numpy as np
import pytest
import test_image_ops as jio
import torch
from torch_data_impls import run_jax_case, with_timeout

from analytics_zoo_tpu.data import image as J
from analytics_zoo_tpu_torch.data import image as T

cv2 = pytest.importorskip("cv2")


def _images(seed, n=3, shape=(24, 32, 3)):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, shape).astype(np.uint8) for _ in range(n)]


# (name, args, kwargs): each built in both packages with these arguments
TRANSFORMS = [
    ("ImageResize", (12, 20), {}),
    ("ImageCenterCrop", (10, 14), {}),
    ("ImageRandomCrop", (10, 14), {"seed": 3}),
    ("ImageHFlip", (), {"p": 0.5, "seed": 4}),
    ("ImageBrightness", (-20.0, 30.0), {"seed": 5}),
    ("ImageChannelNormalize", (120.0, 110.0, 100.0, 50.0, 60.0, 70.0), {}),
    ("ImageHue", (-18.0, 18.0), {"seed": 6}),
    ("ImageSaturation", (0.5, 1.5), {"seed": 7}),
    ("ImageContrast", (0.5, 1.5), {"seed": 8}),
    ("ImageChannelOrder", (), {"seed": 9}),
    ("ImageColorJitter", (), {"seed": 10}),
    ("ImageColorJitter", (), {"shuffle": True, "random_order_prob": 0.5,
                              "seed": 11}),
    ("ImageExpand", (), {"max_expand_ratio": 2.0, "seed": 12}),
    ("ImageFiller", (0.1, 0.2, 0.6, 0.7), {"value": 9}),
    ("ImageFixedCrop", (0.1, 0.2, 0.8, 0.9), {}),
    ("ImageFixedCrop", (2.0, 3.0, 40.0, 15.0), {"normalized": False}),
    ("ImageMirror", (), {}),
    ("ImageRandomResize", (10, 20), {"seed": 13}),
    ("ImageAspectScale", (16,), {"scale_multiple_of": 4, "max_size": 40}),
    ("ImageRandomAspectScale", ([12, 16, 20],), {"seed": 14}),
    ("ImageChannelScaledNormalizer", (120.0, 110.0, 100.0, 0.017), {}),
    ("PerImageNormalize", (0.0, 1.0), {}),
    ("PerImageNormalize", (2.0,), {"norm_type": 4}),
    ("PerImageNormalize", (3.0,), {"norm_type": 2}),
    ("PerImageNormalize", (1.0,), {"norm_type": 1}),
    ("ImageRandomCropper", (14, 10), {"mirror": True, "seed": 15}),
    ("ImageRandomCropper", (14, 10), {"cropper_method": "center"}),
    ("ImageMatToTensor", (), {}),
    ("ImageMatToTensor", (), {"format": "NCHW"}),
]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name,args,kwargs", TRANSFORMS,
                         ids=[f"{t[0]}-{i}" for i, t in enumerate(TRANSFORMS)])
def test_transform_bitwise_jax(name, args, kwargs, seed):
    j = getattr(J, name)(*args, **kwargs)
    t = getattr(T, name)(*args, **kwargs)
    for img in _images(seed, n=4):
        a, b = j(img), t(img)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_composed_transforms_bitwise_jax(seed):
    rs = np.random.RandomState(seed)
    means = rs.rand(12, 12, 3).astype(np.float32) * 100

    def chain(M):
        return (M.ImageRandomPreprocessing(M.ImageHFlip(p=1.0), p=0.5,
                                           seed=seed)
                >> M.ImageAspectScale(14)
                >> M.ImageRandomCropper(12, 12, mirror=True, seed=seed + 1)
                >> M.ImagePixelNormalize(means))

    j, t = chain(J), chain(T)
    assert isinstance(t, T.ChainedPreprocessing)
    for img in _images(seed + 20, n=5):
        np.testing.assert_array_equal(j(img), t(img))


def test_load_image_bytes_and_path_equal_jax(tmp_path):
    img = _images(3, n=1)[0]
    ok, jpg = cv2.imencode(".jpg", img)
    assert ok
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, img)
    for value in (jpg.tobytes(), bytearray(jpg.tobytes()), path):
        a, b = J.load_image(value), T.load_image(value)
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(T.load_image(path), img[..., ::-1])
    with pytest.raises(ValueError, match="decode"):
        T.load_image(b"not an image")


def test_parallel_map_ordered_in_time():
    got = with_timeout(lambda: list(T.parallel_map_ordered(
        lambda x: x * x, range(200), 4, window=7)), 20)
    assert got == [i * i for i in range(200)]


def _folder(tmp_path, n=5, size=16):
    rs = np.random.RandomState(0)
    for cls in ("cats", "dogs"):
        os.makedirs(tmp_path / cls, exist_ok=True)
        for i in range(n):
            img = rs.randint(0, 256, (size, size + 4, 3)).astype(np.uint8)
            cv2.imwrite(str(tmp_path / cls / f"{i}.png"), img)
    return str(tmp_path)


def test_image_set_and_folder_dataset_equal_jax(tmp_path):
    path = _folder(tmp_path)
    a = J.ImageSet.read(path, with_label=True, num_workers=1)
    b = with_timeout(lambda: T.ImageSet.read(path, with_label=True,
                                             num_workers=3), 20)
    assert a.paths == b.paths
    np.testing.assert_array_equal(a.labels, b.labels)
    tr_j, tr_t = J.ImageResize(8, 8), T.ImageResize(8, 8)
    xa, ya = a.transform(tr_j).to_dataset(batch_size=2).materialize()
    xb, yb = b.transform(tr_t, num_workers=2).to_dataset(
        batch_size=2).materialize()
    np.testing.assert_array_equal(xa, xb)
    np.testing.assert_array_equal(ya, yb)

    def folder(M):
        return M.image_folder_dataset(
            path, transform=M.ImageResize(8, 8)
            >> M.ImageChannelNormalize(0, 0, 0, 255, 255, 255),
            batch_size=4, num_workers=1)

    dj, dt = folder(J), folder(T)
    assert dt.n_samples() == dj.n_samples() == 10
    for p, q in zip(dj.first_sample(), dt.first_sample()):
        np.testing.assert_array_equal(p, q)
    for p, q in zip(dj.materialize(), dt.materialize()):
        np.testing.assert_array_equal(p, q)
    got = with_timeout(lambda: list(dt.iter_train(1, seed=3)), 20)
    want = list(dj.iter_train(1, seed=3))
    assert len(got) == len(want) == 2
    for (gx, gy, gn), (wx, wy, wn) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
        assert gn == wn


def test_image_module_imports_without_cv2():
    """cv2 is imported inside the calls that need it: the module and the
    numpy transforms work on a host without OpenCV."""
    import subprocess
    import sys
    code = ("import sys; sys.modules['cv2'] = None\n"
            "import numpy as np\n"
            "from analytics_zoo_tpu_torch.data import image as T\n"
            "img = np.zeros((8, 8, 3), np.uint8)\n"
            "assert T.ImageRandomCropper(4, 4, mirror=True, seed=0)(img)"
            ".shape == (4, 4, 3)\n"
            "try:\n    T.ImageResize(4, 4)(img)\n"
            "except ImportError as e:\n    print('refused', e)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert res.returncode == 0, res.stderr
    assert "refused opencv-python (cv2) is required" in res.stdout


JAX_CASES = [
    "TestPhotometric.test_hue_shifts_hsv_channel",
    "TestPhotometric.test_saturation_gray_fixed_point",
    "TestPhotometric.test_saturation_scales",
    "TestPhotometric.test_contrast_multiplies",
    "TestPhotometric.test_channel_order_permutes",
    "TestPhotometric.test_color_jitter_runs_and_is_seeded",
    "TestPhotometric.test_color_jitter_shuffle_mode",
    "TestGeometric.test_expand_ratio_and_content",
    "TestGeometric.test_filler_fills_region",
    "TestGeometric.test_fixed_crop_normalized_and_pixel",
    "TestGeometric.test_fixed_crop_clip",
    "TestGeometric.test_mirror_flips_both_axes",
    "TestGeometric.test_random_resize_bounds",
    "TestGeometric.test_aspect_scale_short_edge",
    "TestGeometric.test_random_aspect_scale_choices",
    "TestGeometric.test_random_cropper",
    "TestNormalizers.test_channel_scaled_normalizer",
    "TestNormalizers.test_pixel_normalize",
    "TestNormalizers.test_per_image_normalize_minmax",
    "TestNormalizers.test_per_image_normalize_l2",
    "TestNormalizers.test_random_preprocessing_prob",
    "TestParallelPipeline.test_parallel_map_ordered_preserves_order",
    "TestParallelPipeline.test_parallel_read_matches_serial",
    "TestParallelPipeline.test_folder_dataset_stream",
    "TestParallelPipeline.test_folder_dataset_materialize",
]


@pytest.mark.parametrize("case", JAX_CASES)
def test_jax_image_cases_on_the_port(case, monkeypatch, tmp_path):
    run_jax_case(jio, case, {"I": T}, monkeypatch, tmp_path)


class _Classifier(torch.nn.Module):
    """A fixed linear read-out of the mean colour: softmax over 3
    classes."""

    def __init__(self):
        super().__init__()
        w = np.random.RandomState(0).randn(3, 3).astype(np.float32)
        self.register_buffer("w", torch.from_numpy(w / 100.0))

    def forward(self, x):
        return torch.softmax(x.float().mean(dim=(1, 2)) @ self.w, dim=-1)


def test_jpeg_through_cluster_serving_equals_direct_forward():
    from analytics_zoo_tpu_torch.serving.broker import MemoryBroker
    from analytics_zoo_tpu_torch.serving.client import (InputQueue,
                                                        OutputQueue)
    from analytics_zoo_tpu_torch.serving.inference_model import \
        InferenceModel
    from analytics_zoo_tpu_torch.serving.server import ClusterServing
    jpegs = []
    for img in _images(5, n=4, shape=(16, 16, 3)):
        ok, enc = cv2.imencode(".jpg", img)
        assert ok
        jpegs.append(enc.tobytes())
    im = InferenceModel(device="cpu").load_torch(_Classifier())
    want = im.predict(np.stack([T.load_image(b).astype(np.float32)
                                for b in jpegs]))
    engine = ClusterServing(im, broker=MemoryBroker(), batch_size=4)
    engine.start()
    try:
        q = InputQueue(engine.broker)
        uris = [q.enqueue(f"jpeg{i}", image=b) for i, b in enumerate(jpegs)]
        out, res = OutputQueue(engine.broker), {}
        deadline = time.monotonic() + 30
        while len(res) < len(uris) and time.monotonic() < deadline:
            res.update(out.query_many([u for u in uris if u not in res],
                                      delete=True))
            time.sleep(0.01)
    finally:
        engine.stop()
    assert sorted(res) == sorted(uris)
    for i, u in enumerate(uris):
        np.testing.assert_allclose(res[u], want[i], rtol=0, atol=1e-6)
        assert int(np.argmax(res[u])) == int(np.argmax(want[i]))
