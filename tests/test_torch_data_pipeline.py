"""The port's parallel shard pipeline and TFRecord stream
(`analytics_zoo_tpu_torch/data/pipeline.py`, `data/dataset.py`) held
against the JAX package's: the same order at 1 and 4 workers, a shard's
error raised at its position, no thread left behind, and
`TPUDataset.from_tfrecord` batches bitwise JAX's for seeds 0 and 1 at 1
and 3 workers. Every threaded case runs under a timeout of its own
(`torch_data_impls.with_timeout`). A few cases of
`tests/test_input_pipeline.py` run against the port's copy."""

import time

import numpy as np
import pytest
import test_input_pipeline as jip
from torch_data_impls import no_pipeline_threads, run_jax_case, with_timeout

from analytics_zoo_tpu.data import pipeline as jpl
from analytics_zoo_tpu.data import tfrecord as jtfr
from analytics_zoo_tpu.data.dataset import TPUDataset as JDataset
from analytics_zoo_tpu_torch.data import pipeline as tpl
from analytics_zoo_tpu_torch.data import tfrecord as ttfr
from analytics_zoo_tpu_torch.data.dataset import TPUDataset as TDataset

PKGS = {"jax": jpl, "torch": tpl}


def _read(s):
    time.sleep(0.001 * ((s * 7) % 5))     # completion order scrambles
    return [f"s{s}-{i}" for i in range(3)]


def _run(pl, shards, read, workers):
    pipe = pl.ShardPipeline(shards, read, workers=workers)
    try:
        return list(pipe.samples())
    finally:
        pipe.close()


@pytest.mark.parametrize("workers", [1, 4])
def test_shard_pipeline_order_matches_jax(workers):
    shards = list(range(10))
    got = with_timeout(lambda: _run(tpl, shards, _read, workers), 20)
    want = with_timeout(lambda: _run(jpl, shards, _read, workers), 20)
    assert got == want == [f"s{s}-{i}" for s in shards for i in range(3)]
    assert no_pipeline_threads() == []


def _error_case(pl):
    def read(s):
        if s == "shard-2":
            raise ValueError("decode blew up")
        return [s]

    got = []
    with pytest.raises(ValueError) as err:
        for item in pl.ShardPipeline(["shard-0", "shard-1", "shard-2",
                                      "shard-3"], read,
                                     workers=4).samples():
            got.append(item)
    return got, str(err.value)


def test_shard_error_raised_at_its_position_as_in_jax():
    got = with_timeout(lambda: _error_case(tpl), 20)
    want = with_timeout(lambda: _error_case(jpl), 20)
    assert got == want == (["shard-0", "shard-1"],
                           "shard-2: decode blew up")
    assert no_pipeline_threads() == []


def test_early_break_and_close_leave_no_thread():
    def case():
        pipe = tpl.ShardPipeline(list(range(30)),
                                 lambda s: (time.sleep(0.001), [s])[1:],
                                 workers=4)
        for item in pipe.samples():
            if item == 3:
                break
        pipe.close()
        return all(not t.is_alive() for t in pipe._threads)

    assert with_timeout(case, 20)
    assert no_pipeline_threads() == []


def test_parallel_read_matches_jax():
    items = [3, 1, 2, 5]
    assert tpl.parallel_read(items, lambda v: v * 10, workers=3) == \
        jpl.parallel_read(items, lambda v: v * 10, workers=3)

    def bad(v):
        if v == "item-1":
            raise KeyError("gone")
        return v

    for pl in (tpl, jpl):
        with pytest.raises(KeyError, match="item-1"):
            pl.parallel_read(["item-0", "item-1"], bad, workers=2)


def test_resolve_workers_reads_the_environment(monkeypatch):
    monkeypatch.delenv("ZOO_PIPELINE_WORKERS", raising=False)
    assert tpl.resolve_workers(3) == 3
    assert tpl.resolve_workers(None, default=2) == 2
    assert tpl.resolve_workers(0) == 1
    monkeypatch.setenv("ZOO_PIPELINE_WORKERS", "5")
    assert tpl.resolve_workers(None) == 5
    assert tpl.resolve_workers(2) == 2            # explicit wins


def test_host_shard_defaults_and_multi_process_refusal(monkeypatch):
    files = [f"f{i}" for i in range(7)]
    assert tpl.host_shard(files) == files == jpl.host_shard(files)
    for i in range(3):
        assert tpl.host_shard(files, index=i, count=3) == \
            jpl.host_shard(files, index=i, count=3)
    with pytest.raises(ValueError, match="no shards"):
        tpl.host_shard(files[:2], index=2, count=3)
    monkeypatch.setattr(tpl, "process_topology", lambda: (1, 2))
    # more than one process: this host's stride (the JAX package's
    # `jax.process_index()` / `process_count()` defaults)
    assert tpl.host_shard(files) == files[1::2] == \
        jpl.host_shard(files, index=1, count=2)
    with pytest.raises(ValueError, match="no shards"):
        tpl.host_shard(files[:1])


def _corpus(tmp_path, n_files=4, per_file=20, dim=6, seed=0):
    rs = np.random.RandomState(seed)
    for s in range(n_files):
        recs = [ttfr.encode_example({
            "x": rs.randn(dim).astype(np.float32),
            "img": rs.randint(0, 256, (4, 4, 3)).astype(np.uint8).tobytes(),
            "y": np.asarray([rs.randint(5)], np.int64)})
            for _ in range(per_file)]
        ttfr.write_tfrecord(str(tmp_path / f"part-{s:05d}.tfrecord"), recs)
    return str(tmp_path / "part-*.tfrecord")


def _parse(ex):
    img = np.frombuffer(ex["img"][0], np.uint8).reshape(4, 4, 3)
    return ({"x": ex["x"], "img": img}, ex["y"].astype(np.int32)[0])


def _stream(cls, pattern, workers, seed, shuffle=True):
    ds = cls.from_tfrecord(pattern, _parse, batch_size=8, shuffle=shuffle,
                           shuffle_buffer=16, num_workers=workers)
    return list(ds.iter_train(1, seed=seed))


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_from_tfrecord_batches_bitwise_jax(seed, workers, tmp_path):
    pattern = _corpus(tmp_path)
    got = with_timeout(lambda: _stream(TDataset, pattern, workers, seed))
    want = with_timeout(lambda: _stream(JDataset, pattern, workers, seed))
    assert len(got) == len(want) == 10
    for (gx, gy, gn), (wx, wy, wn) in zip(got, want):
        assert gn == wn == 8
        assert gx.keys() == wx.keys()
        for k in gx:
            assert gx[k].dtype == wx[k].dtype
            np.testing.assert_array_equal(gx[k], wx[k])
        np.testing.assert_array_equal(gy, wy)
    assert no_pipeline_threads() == []


def test_stream_same_at_any_worker_count_and_unshuffled_order(tmp_path):
    pattern = _corpus(tmp_path, n_files=3, per_file=16)
    runs = [with_timeout(lambda w=w: _stream(TDataset, pattern, w, 4))
            for w in (1, 4)]
    for (ax, ay, _), (bx, by, _) in zip(*runs):
        np.testing.assert_array_equal(ax["x"], bx["x"])
        np.testing.assert_array_equal(ay, by)
    ordered = with_timeout(lambda: _stream(TDataset, pattern, 4, 0, False))
    x = np.concatenate([b[0]["x"] for b in ordered])
    want_x, _ = JDataset.from_tfrecord(pattern, _parse,
                                       batch_size=8).materialize()
    np.testing.assert_array_equal(x, want_x["x"][:len(x)])


def test_abandoned_stream_leaves_no_thread(tmp_path):
    pattern = _corpus(tmp_path, n_files=4, per_file=30)
    ds = TDataset.from_tfrecord(pattern, _parse, batch_size=4,
                                shuffle_buffer=4, num_workers=4)

    def case():
        it = ds.iter_train(1, seed=0)
        next(it)
        it.close()

    with_timeout(case, 20)
    assert no_pipeline_threads() == []


def test_multi_process_stream_is_refused(tmp_path, monkeypatch):
    pattern = _corpus(tmp_path, n_files=2, per_file=8)
    ds = TDataset.from_tfrecord(pattern, _parse, batch_size=3)
    monkeypatch.setattr(tpl, "process_topology", lambda: (0, 2))
    # a global batch the hosts cannot split is refused, as in the JAX
    # package (the multi-process stream itself runs since distributed
    # training was ported: tests/test_torch_distributed_fit.py)
    with pytest.raises(ValueError, match="process count"):
        next(ds.iter_train(1, seed=0))


JAX_CASES = [
    "TestShardPipeline.test_output_identical_at_any_worker_count",
    "TestShardPipeline.test_error_surfaces_at_stream_position_naming_shard",
    "TestShardPipeline.test_error_already_naming_shard_not_double_wrapped",
    "TestShardPipeline.test_residency_bounded_by_workers_plus_slack",
    "TestShardPipeline.test_early_break_closes_cleanly",
    "TestShardPipeline.test_parallel_read_orders_and_names_files",
    "TestShardPipeline.test_resolve_workers_precedence",
    "TestShardPipeline.test_host_shard_disjoint_union",
    "TestDeterminism.test_bitwise_identical_batches_workers_1_vs_4",
    "TestDeterminism.test_stream_is_pure_function_of_seed_epoch",
    "TestDecodeBatchParity.test_vectorized_decode_matches_per_record",
    "TestDecodeBatchParity.test_empty_batch",
    "TestCorruptTail.test_torn_tail_names_file_and_offset",
    "TestCorruptTail.test_torn_tail_not_a_silent_short_epoch",
    "TestCorruptTail.test_corrupt_mid_frame_crc_names_offset",
]


@pytest.mark.parametrize("case", JAX_CASES)
def test_jax_pipeline_cases_on_the_port(case, monkeypatch, tmp_path):
    run_jax_case(jip, case, {
        "tfr": ttfr, "TPUDataset": TDataset,
        "ShardPipeline": tpl.ShardPipeline, "host_shard": tpl.host_shard,
        "parallel_read": tpl.parallel_read,
        "resolve_workers": tpl.resolve_workers}, monkeypatch, tmp_path)
    assert no_pipeline_threads() == []


def test_jax_encoded_corpus_streams_identically(tmp_path):
    """A corpus the JAX package wrote, streamed by both packages."""
    rs = np.random.RandomState(7)
    for s in range(3):
        jtfr.write_tfrecord(str(tmp_path / f"j-{s}.tfrecord"), [
            jtfr.encode_example({
                "x": rs.randn(6).astype(np.float32),
                "img": rs.bytes(48),
                "y": np.asarray([rs.randint(5)], np.int64)})
            for _ in range(12)])
    pattern = str(tmp_path / "j-*.tfrecord")
    got = with_timeout(lambda: _stream(TDataset, pattern, 3, 1))
    want = with_timeout(lambda: _stream(JDataset, pattern, 3, 1))
    assert len(got) == len(want) == 4
    for (gx, gy, _), (wx, wy, _) in zip(got, want):
        np.testing.assert_array_equal(gx["img"], wx["img"])
        np.testing.assert_array_equal(gy, wy)
