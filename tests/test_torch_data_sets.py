"""The port's in-memory data layer held against the JAX package's:
`TPUDataset.from_ndarrays` / `from_xshards` / `from_dataframe`,
`FeatureSet` in every tier (the native disk tier through the port's
build of `native/zoo_loader.cpp`), `XShards` and its operations, the
readers, `TextSet`, `ParquetDataset`, `minibatch` and the `tf_style`
`Dataset`. Inputs come from numpy seeds, every comparison is exact, and
cases of `tests/test_data.py` and `tests/test_native_loader.py` run
against the port's copies."""

import os

import numpy as np
import pandas as pd
import pytest
import test_data as jtd
import test_native_loader as jtn
from torch_data_impls import no_pipeline_threads, run_jax_case, with_timeout

from analytics_zoo_tpu.data import dataset as jdataset
from analytics_zoo_tpu.data import feature_set as jfs
from analytics_zoo_tpu.data import minibatch as jmb
from analytics_zoo_tpu.data import parquet_dataset as jpq
from analytics_zoo_tpu.data import readers as jreaders
from analytics_zoo_tpu.data import shards as jshards
from analytics_zoo_tpu.data import text as jtext
from analytics_zoo_tpu.data import tf_style as jtf
from analytics_zoo_tpu_torch import data as tdata
from analytics_zoo_tpu_torch.data import dataset as tdataset
from analytics_zoo_tpu_torch.data import feature_set as tfs
from analytics_zoo_tpu_torch.data import image as timage
from analytics_zoo_tpu_torch.data import minibatch as tmb
from analytics_zoo_tpu_torch.data import native_loader as tnl
from analytics_zoo_tpu_torch.data import parquet_dataset as tpq
from analytics_zoo_tpu_torch.data import readers as treaders
from analytics_zoo_tpu_torch.data import shards as tshards
from analytics_zoo_tpu_torch.data import text as ttext
from analytics_zoo_tpu_torch.data import tf_style as ttf
from analytics_zoo_tpu_torch.kernels import _build


def assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_tree_equal(x, y)
    elif isinstance(a, pd.DataFrame):
        pd.testing.assert_frame_equal(a, b)
    elif a is None:
        assert b is None
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _arrays(seed, n=24):
    rs = np.random.RandomState(seed)
    return {"x": (rs.randn(n, 3).astype(np.float32),
                  rs.randint(0, 9, (n, 2)).astype(np.int32)),
            "y": rs.randint(0, 2, n).astype(np.int64)}


@pytest.mark.parametrize("seed", [0, 1])
def test_xshards_ops_equal_jax(seed):
    data = _arrays(seed)
    j, t = jshards.XShards.partition(data, 4), \
        tshards.XShards.partition(data, 4)
    assert t.num_partitions() == j.num_partitions() == 4
    assert len(t) == len(j) == 24
    for a, b in zip(j.collect(), t.collect()):
        assert_tree_equal(a, b)
    assert_tree_equal(j.to_numpy(), t.to_numpy())
    assert_tree_equal(j.repartition(3).collect(), t.repartition(3).collect())
    fn = lambda s: {"x": s["x"][0] * 2, "y": s["y"] + 1}  # noqa: E731
    for par in (False, True):
        assert_tree_equal(j.transform_shard(fn, parallel=par).collect(),
                          t.transform_shard(fn, parallel=par).collect())
    rs = np.random.RandomState(seed)
    df = pd.DataFrame({"k": rs.randint(0, 5, 30), "v": rs.randn(30)})
    jd = jshards.XShards([df.iloc[:10], df.iloc[10:]])
    td = tshards.XShards([df.iloc[:10], df.iloc[10:]])
    assert_tree_equal(jd.partition_by("k", 3).collect(),
                      td.partition_by("k", 3).collect())
    assert_tree_equal(jd.repartition(4).collect(), td.repartition(4).collect())
    assert_tree_equal(jd.zip(jd).collect(), td.zip(td).collect())


def test_xshards_pickles_read_across_packages(tmp_path):
    data = _arrays(3)
    tshards.XShards.partition(data, 3).save_pickle(str(tmp_path / "t.pkl"))
    jshards.XShards.partition(data, 3).save_pickle(str(tmp_path / "j.pkl"))
    assert_tree_equal(jshards.XShards.load_pickle(str(tmp_path / "t.pkl"))
                      .collect(),
                      tshards.XShards.load_pickle(str(tmp_path / "j.pkl"))
                      .collect())


def _iter(ds, seed=0):
    return [(x, y, n) for x, y, n in ds.iter_train(1, seed=seed)]


@pytest.mark.parametrize("seed", [0, 1])
def test_dataset_constructors_equal_jax(seed):
    data = _arrays(seed)
    for make in (lambda m: m.TPUDataset.from_ndarrays(
                     (data["x"], data["y"]), batch_size=8),
                 lambda m: m.TPUDataset.from_ndarrays(data, batch_size=8),
                 lambda m: m.TPUDataset.from_xshards(
                     (jshards if m is jdataset else tshards).XShards
                     .partition(data, 3), batch_size=8)):
        j, t = make(jdataset), make(tdataset)
        assert t.n_samples() == j.n_samples() == 24
        assert_tree_equal(j.materialize(), t.materialize())
        assert_tree_equal(_iter(j, seed), _iter(t, seed))
    rs = np.random.RandomState(seed)
    df = pd.DataFrame({"a": list(rs.randn(16, 2).astype(np.float32)),
                       "b": rs.randn(16), "y": rs.randint(0, 3, 16)})
    for cols in (["a"], ["a", "b"]):
        j = jdataset.TPUDataset.from_dataframe(df, cols, ["y"], batch_size=4)
        t = tdataset.TPUDataset.from_dataframe(df, cols, ["y"], batch_size=4)
        assert_tree_equal(j.materialize(), t.materialize())
        assert_tree_equal(_iter(j, seed), _iter(t, seed))
    with pytest.raises(ValueError, match="simultaneously"):
        tdataset.TPUDataset(data["x"], batch_size=4, batch_per_thread=2)


@pytest.mark.parametrize("memory_type", ["DRAM", "DISK", "DISK_AND_DRAM(50)",
                                         "PMEM"])
def test_feature_set_tiers_equal_jax(memory_type, tmp_path):
    rs = np.random.RandomState(5)
    data = {"x": rs.randn(40, 3).astype(np.float32),
            "y": np.arange(40, dtype=np.int64)}
    j = jfs.FeatureSet(data, memory_type, cache_dir=str(tmp_path))
    t = tfs.FeatureSet(data, memory_type, cache_dir=str(tmp_path))
    try:
        idx = rs.permutation(40)
        assert_tree_equal(j.take(idx), t.take(idx))
        # python path (native=False): the seeded permutation, bitwise JAX
        for workers in (1, 3):
            assert_tree_equal(
                list(j.iter_batches(8, seed=2, native=False,
                                    pipeline_workers=workers)),
                list(t.iter_batches(8, seed=2, native=False,
                                    pipeline_workers=workers)))
        # the native tier for spilled sets: ordered delivery equal to JAX
        # and to the rows; shuffled delivery covers every row once
        got = list(t.iter_batches(8, shuffle=False))
        assert_tree_equal(list(j.iter_batches(8, shuffle=False)), got)
        np.testing.assert_array_equal(
            np.concatenate([b["y"] for b in got]), np.arange(40))
        seen = np.concatenate([b["y"] for b in t.iter_batches(8, seed=3)])
        assert sorted(seen.tolist()) == list(range(40))
        if memory_type.startswith("DISK"):
            assert t._native_cache, "spilled tiers take the native loader"
        assert_tree_equal(j.to_dataset(batch_size=8).materialize(),
                          t.to_dataset(batch_size=8).materialize())
    finally:
        j.close()
        t.close()
    assert no_pipeline_threads() == []


def test_native_loader_built_into_the_port_build_dir():
    assert tnl.available()
    lib = tnl._get_lib()
    assert os.path.realpath(lib._name).startswith(
        os.path.realpath(str(_build.BUILD_DIR)))
    assert os.path.basename(lib._name) == "_zoo_loader.so"


def test_native_loader_rows_and_fallback(monkeypatch):
    rs = np.random.RandomState(0)
    x = rs.randn(100, 6).astype(np.float32)
    y = np.arange(100).astype(np.int64)
    ld = tnl.NativeBatchLoader.from_arrays([x, y], batch_size=16)
    try:
        rows = [b for b in ld.iter_epoch(seed=1)]
        assert len(rows) == 6
        for bx, by in rows:
            np.testing.assert_array_equal(bx, x[by])
    finally:
        ld.close()
    monkeypatch.setattr(tnl, "_build_failed", True)
    monkeypatch.setattr(tnl, "_lib", None)
    assert not tnl.available()
    fs = tfs.FeatureSet({"x": np.arange(40, dtype=np.float32)},
                        memory_type="DISK")
    assert len(list(fs.iter_batches(8, shuffle=False))) == 5
    fs.close()


def test_readers_equal_jax(tmp_path):
    rs = np.random.RandomState(2)
    for i in range(3):
        df = pd.DataFrame({"a": rs.randn(5), "b": rs.randint(0, 9, 5)})
        df.to_csv(tmp_path / f"p{i}.csv", index=False)
        df.to_json(tmp_path / f"p{i}.json")
        df.to_parquet(tmp_path / f"p{i}.parquet", row_group_size=2)
    for fn, arg in (("read_csv", "*.csv"), ("read_json", "*.json"),
                    ("read_parquet", "*.parquet")):
        for workers in (1, 3):
            j = getattr(jreaders, fn)(str(tmp_path / arg),
                                      pipeline_workers=workers)
            t = getattr(treaders, fn)(str(tmp_path / arg),
                                      pipeline_workers=workers)
            assert_tree_equal(j.collect(), t.collect())
    assert_tree_equal(jreaders.read_csv(str(tmp_path), num_shards=2)
                      .collect(),
                      treaders.read_csv(str(tmp_path), num_shards=2)
                      .collect())
    assert tdata.read_csv is treaders.read_csv
    with pytest.raises(FileNotFoundError):
        treaders.read_csv(str(tmp_path / "none*.csv"))


def test_parquet_dataset_equal_jax(tmp_path):
    rs = np.random.RandomState(4)
    images = rs.randint(0, 256, (10, 4, 4, 1)).astype(np.uint8)
    labels = rs.randint(0, 10, 10).astype(np.int64)
    tpq.write_ndarrays(images, labels, str(tmp_path / "t"), block_size=4)
    jpq.write_ndarrays(images, labels, str(tmp_path / "j"), block_size=4)
    for path in ("t", "j"):
        j = jpq.ParquetDataset.read_as_xshards(str(tmp_path / path))
        t = tpq.ParquetDataset.read_as_xshards(str(tmp_path / path))
        assert_tree_equal(j.collect(), t.collect())
        assert_tree_equal(
            jpq.ParquetDataset.read_as_dataset(str(tmp_path / path),
                                               batch_size=2).materialize(),
            tpq.ParquetDataset.read_as_dataset(str(tmp_path / path),
                                               batch_size=2).materialize())


def test_text_pipeline_equal_jax(tmp_path):
    texts = ["The cat sat on the mat.", "A dog; a DOG! 42 dogs",
             "cats and dogs", "the end"]
    out = []
    for m in (jtext, ttext):
        ts = m.TextSet.from_texts(texts, [0, 1, 1, 0]).tokenize().normalize()
        ts.word2idx(remove_topN=1, max_words_num=8).shape_sequence(5)
        out.append((ts.get_word_index(), ts.generate_sample()))
    assert out[0][0] == out[1][0]
    assert_tree_equal(out[0][1], out[1][1])
    glove = tmp_path / "g.txt"
    glove.write_text("the 0.1 0.2\ncat 0.3 0.4\nbad 1\n")
    np.testing.assert_array_equal(
        jtext.load_glove(str(glove), {"cat": 1, "the": 2}, dim=2),
        ttext.load_glove(str(glove), {"cat": 1, "the": 2}, dim=2))


def test_minibatch_and_tf_style_equal_jax():
    rs = np.random.RandomState(6)
    samples = [({"a": rs.randn(rs.randint(1, 5), 2)},
                rs.randn(rs.randint(1, 4), 3)) for _ in range(6)]
    for pad in (None, jmb.PaddingParam(-1.0, [6, -1])):
        tpad = None if pad is None else tmb.PaddingParam(-1.0, [6, -1])
        if pad is None:
            samples_u = [({"a": s[0]["a"][:1]}, s[1][:1]) for s in samples]
            assert_tree_equal(jmb.batch_samples(samples_u),
                              tmb.batch_samples(samples_u))
        else:
            assert_tree_equal(jmb.batch_samples(samples, pad),
                              tmb.batch_samples(samples, tpad))
    seqs = [[1, 2, 3], [4], list(range(9))]
    for t, p in (("pre", "post"), ("post", "pre")):
        np.testing.assert_array_equal(
            jmb.pad_sequences(seqs, 4, truncating=t, padding=p),
            tmb.pad_sequences(seqs, 4, truncating=t, padding=p))
    data = _arrays(7, 12)
    fn = lambda row: {"x": (row["x"][0] + 1, row["x"][1]),  # noqa: E731
                      "y": row["y"] * 2}
    j = jtf.Dataset.from_tensor_slices(data).map(fn)
    t = ttf.Dataset.from_tensor_slices(data).map(fn)
    assert_tree_equal(j.to_xshards().collect(), t.to_xshards().collect())
    assert_tree_equal(j.to_dataset(batch_size=4).materialize(),
                      t.to_dataset(batch_size=4).materialize())


DATA_PATCHES = {
    "FeatureSet": tfs.FeatureSet, "TPUDataset": tdataset.TPUDataset,
    "XShards": tshards.XShards, "read_csv": treaders.read_csv,
    "read_json": treaders.read_json, "read_parquet": treaders.read_parquet,
    "PaddingParam": tmb.PaddingParam, "batch_samples": tmb.batch_samples,
    "pad_sequences": tmb.pad_sequences, "TextSet": ttext.TextSet,
    "load_glove": ttext.load_glove,
    **{name: getattr(timage, name) for name in (
        "ImageBrightness", "ImageCenterCrop", "ImageChannelNormalize",
        "ImageHFlip", "ImageMatToTensor", "ImageRandomCrop", "ImageResize",
        "ImageSet")}}

DATA_CASES = [
    "TestXShards.test_partition_and_collect",
    "TestXShards.test_transform_shard",
    "TestXShards.test_repartition",
    "TestXShards.test_partition_by_and_zip",
    "TestXShards.test_repartition_dataframe_keeps_schema",
    "TestXShards.test_mismatched_lengths_rejected",
    "TestXShards.test_save_load_pickle",
    "TestReaders.test_read_csv_dir",
    "TestReaders.test_read_json",
    "TestReaders.test_read_parquet",
    "TestTPUDataset.test_global_batch_contract",
    "TestTPUDataset.test_from_xshards",
    "TestTPUDataset.test_from_dataframe",
    "TestFeatureSet.test_bad_tier_rejected",
    "TestFeatureSet.test_disk_tier_dataset_is_lazy",
    "TestFeatureSet.test_shared_cache_dir_isolated",
    "TestMiniBatch.test_ragged_padding_to_max",
    "TestMiniBatch.test_fixed_length_padding",
    "TestMiniBatch.test_pad_sequences_modes",
    "TestImagePipeline.test_transform_chain",
    "TestImagePipeline.test_imageset_read_with_labels",
    "TestTextPipeline.test_full_pipeline",
    "TestTextPipeline.test_word2idx_knobs",
]


@pytest.mark.parametrize("case", DATA_CASES)
def test_jax_data_cases_on_the_port(case, monkeypatch, tmp_path):
    run_jax_case(jtd, case, DATA_PATCHES, monkeypatch, tmp_path)


NATIVE_CASES = [
    "TestNativeLoader.test_keep_remainder",
    "TestNativeLoader.test_multidim_leaves",
    "TestFeatureSetIntegration.test_disk_tier_native_matches_python",
    "TestFeatureSetIntegration.test_no_shuffle_preserves_row_order",
    "TestFeatureSetIntegration.test_peek_then_reiterate_no_deadlock",
    "TestFeatureSetIntegration.test_geometries_share_one_packed_file",
    "TestFeatureSetIntegration.test_dram_tier_defaults_to_python",
    "TestFallback.test_python_path_when_disabled",
]


@pytest.mark.parametrize("case", NATIVE_CASES)
def test_jax_native_loader_cases_on_the_port(case, monkeypatch, tmp_path):
    run_jax_case(jtn, case, {"nl": tnl, "FeatureSet": tfs.FeatureSet},
                 monkeypatch, tmp_path)


def test_threaded_feature_set_batches_in_time():
    fs = tfs.FeatureSet({"x": np.arange(64, dtype=np.float32)},
                        memory_type="DISK")
    try:
        got = with_timeout(lambda: list(fs.iter_batches(8, seed=4)), 20)
        assert sorted(np.concatenate([b["x"] for b in got]).tolist()) == \
            list(range(64))
    finally:
        fs.close()
