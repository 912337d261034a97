"""The port's distributed fit (`learn/trainer.fit_keras(sharding_rules=...)`
over a mesh of ranks, `learn/checkpoint.py`, the multi-process data layer)
held against the JAX package's sharded fit: a tiny BERT at data=2, fsdp=2
on 4 gloo CPU ranks (one group, spawned once: each rank feeds its block
of every global batch) against the JAX GSPMD fit on a 4-device mesh of the
conftest's virtual devices, the same initial weights and batches; the
state at 1/fsdp per rank, sharded against replicated, the sharded
checkpoint (read back by the JAX package) and bitwise auto-resume, the
refusals of JAX `trainer.py:1126-1200`, and the per-host file strides and
equal steps of a TFRecord stream against JAX `_host_files` / `iter_train`
with `jax.process_index` / `process_count` patched here."""

import logging

import jax
import numpy as np
import optax
import pytest
import torch

from analytics_zoo_tpu.common import context as jctx_mod
from analytics_zoo_tpu.common.config import MeshConfig, ZooConfig
from analytics_zoo_tpu.common.mesh import DeviceMesh
from analytics_zoo_tpu.data.dataset import TPUDataset as JDataset
from analytics_zoo_tpu.learn import checkpoint as jckpt
from analytics_zoo_tpu.learn import trainer as jtrainer
from analytics_zoo_tpu.models.bert import BERTClassifier as JClassifier
from analytics_zoo_tpu.ops import objectives as jobj
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.learn import trainer as ttrainer

import torch_dist_workers as w

LOSS_TOL = 1e-4


@pytest.fixture(scope="module")
def init_params():
    jm = JClassifier(2, use_flash=True, **w.FIT_TINY, **w.FIT_NO_DROP)
    return jax.device_get(jm.build(jax.random.PRNGKey(3)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, init_params):
    """The 4-rank group's results and the JAX GSPMD fit's losses
    (data=2 x fsdp=2 on 4 devices), computed while the ranks run."""
    d = tmp_path_factory.mktemp("fit")
    init = d / "init.pt"
    torch.save(convert.params_from_jax(init_params), str(init))
    (d / "ckpt").mkdir()
    (d / "tfr").mkdir()
    glob = w.write_corpus(str(d / "tfr"))
    collect = w.start_group("fit_worker", 4, str(d), str(init),
                            str(d / "ckpt"), glob)
    prev = jctx_mod._GLOBAL["context"]
    jctx_mod._GLOBAL["context"] = jctx_mod.Context(
        ZooConfig(), DeviceMesh(MeshConfig(data=2, fsdp=2),
                                jax.devices()[:4]))
    try:
        jm = JClassifier(2, use_flash=True, **w.FIT_TINY, **w.FIT_NO_DROP)
        jm.params = init_params
        jm.compile(optax.adamw(w.FIT_LR, weight_decay=1e-4),
                   jobj.get("sparse_categorical_crossentropy",
                            from_logits=True))
        x, y = w.fit_data()
        h = jtrainer.fit_keras(jm, x, y, batch_size=w.FIT_BATCH,
                               epochs=w.FIT_EPOCHS,
                               shuffle=False, sharding_rules=True,
                               prefetch=False, device_cache=False, seed=7)
        assert any(any(ax is not None for ax in leaf.sharding.spec)
                   for leaf in jax.tree_util.tree_leaves(jm.params))
    finally:
        jctx_mod._GLOBAL["context"] = prev
    res = collect()
    res[0]["_glob"] = glob
    res[0]["_ckpt"] = str(d / "ckpt")
    return res, h["loss"]


@pytest.fixture(scope="module")
def group(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_sharded_losses(runs):
    return runs[1]


def test_sharded_fit_matches_the_jax_sharded_fit(group, jax_sharded_losses):
    for res in group:
        np.testing.assert_allclose(res["sharded"], jax_sharded_losses,
                                   rtol=0, atol=LOSS_TOL)
        assert res["sharded"] == group[0]["sharded"]
        # Estimator.fit over the ranks: the same fit
        assert res["estimator"] == res["sharded"]
    assert group[0]["sharded"][-1] < group[0]["sharded"][0]


def test_state_at_one_over_fsdp_and_sharded_matches_replicated(group):
    for res in group:
        assert res["sharded_bytes"] < res["replicated_bytes"] / 2 * 1.15
        np.testing.assert_allclose(res["sharded"], res["replicated"],
                                   rtol=0, atol=1e-5)
        for k, v in res["sharded_state"].items():
            diff = (v - res["replicated_state"][k]).abs()
            if k.endswith("attn.qkv_bias"):
                # the key bias gets no gradient but rounding noise, which
                # Adam scales to steps of up to the rate (as in
                # test_torch_training.py's `_k_bias_mask`)
                d = v.shape[0] // 3
                steps = w.FIT_EPOCHS * w.FIT_N // w.FIT_BATCH
                assert diff[d:2 * d].max() <= 2 * w.FIT_LR * steps, k
                diff = torch.cat([diff[:d], diff[2 * d:]])
            assert diff.max() <= 1e-5, k
            # after the fit every rank holds the whole parameters
            assert torch.equal(v, group[0]["sharded_state"][k])


def test_sharded_checkpoint_round_trip(group):
    """Rank 0 published the gathered tree in the JAX layout: the JAX
    package reads it back, bitwise the live parameters."""
    res = group[0]
    root = res["_ckpt"] + "/roundtrip"
    tree, opt_tree, meta = jckpt.load_checkpoint(root)
    live = {k: v for k, v in res["ckpt_live"].items()}
    back = convert.params_from_jax(tree)
    assert set(back) == set(live)
    for k, v in back.items():
        assert torch.equal(v, live[k]), k
    assert meta.get("epoch_finished") is True
    assert jax.tree_util.tree_leaves(opt_tree)
    assert res["ckpt_opt_leaves"] > len(live)
    for r in group[1:]:
        assert torch.equal(torch.as_tensor(
            r["ckpt_tree"]["cls_kernel"]), torch.as_tensor(
            res["ckpt_tree"]["cls_kernel"]))


def test_auto_resume_bitwise_under_sharding(group):
    for res in group:
        full, resumed = res["resume"]
        assert resumed == full[2:]
        assert res["resume_bitwise"]


def test_multi_process_refusals(group):
    for res in group:
        assert res["refuse_batch"].startswith("ValueError") \
            and "fsdp (2)" in res["refuse_batch"]
        assert res["refuse_stream"].startswith("NotImplementedError") \
            and "per-host shard" in res["refuse_stream"]
        assert res["refuse_cache"].startswith("NotImplementedError") \
            and "single-process" in res["refuse_cache"]
        assert res["refuse_counts"].startswith("ValueError") \
            and "[8, 8, 8, 6]" in res["refuse_counts"]


def _port_model(init_params):
    return w._fit_model(convert.params_from_jax(init_params))


def test_single_process_refusals(init_params, caplog):
    x, y = w.fit_data()
    kw = dict(batch_size=w.FIT_BATCH, epochs=1, prefetch=False)
    with pytest.raises(ValueError, match="distributed=True"):
        ttrainer.fit_keras(_port_model(init_params), x, y,
                           sharding_rules=True, distributed=False, **kw)
    with pytest.raises(NotImplementedError, match="lazy_embeddings"):
        ttrainer.fit_keras(_port_model(init_params), x, y,
                           sharding_rules=True, lazy_embeddings=True, **kw)
    with caplog.at_level(logging.WARNING):
        h = ttrainer.fit_keras(_port_model(init_params), x, y,
                               sharding_rules=True, **kw)
    assert "fsdp=1 and tensor=1" in caplog.text
    assert np.isfinite(h["loss"][0])
    for args in [(12, 4, 4), (12, 8, 1), (16, 4, 4), (10, 2, 2)]:
        def msg(fn):
            try:
                fn(*args)
            except ValueError as e:
                return str(e)
        assert msg(ttrainer.check_global_batch) == \
            msg(jtrainer.check_global_batch)


def test_streamed_epoch_per_host_files_and_equal_steps(group, monkeypatch):
    """Each rank streamed its stride of the shuffled files and the hosts
    took equal steps: the JAX iter_train with `jax.process_index` /
    `process_count` and the count all-gather patched to this 4-host
    topology gives the same batches, host by host."""
    from jax.experimental import multihost_utils
    glob = group[0]["_glob"]

    def jax_stream(r):
        monkeypatch.setattr(jax, "process_count", lambda: 4)
        monkeypatch.setattr(jax, "process_index", lambda: r)
        ds = JDataset.from_tfrecord(glob, w.tfr_parse, batch_size=8,
                                    shuffle=True)
        return ds

    counts = []
    for r in range(4):
        ds = jax_stream(r)
        files = list(ds._files)
        np.random.RandomState(3).shuffle(files)
        counts.append(sum(ds._file_count(f) for f in ds._host_files(files)))
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        lambda a: np.asarray(counts))
    steps = min(counts) // 2
    for r, res in enumerate(group):
        ds = jax_stream(r)
        want = [xb["v"] for xb, _, _ in ds.iter_train(1, seed=3)]
        assert len(want) == steps == len(res["stream_batches"])
        for a, b in zip(res["stream_batches"], want):
            np.testing.assert_array_equal(a, b)
        assert res["stream_files"] == ds._host_files(sorted(ds._files))
    # disjoint files, and every host's records its own
    seen = [set(np.concatenate(res["stream_batches"])[:, 0].tolist())
            for res in group]
    assert all(not (seen[i] & seen[j]) for i in range(4)
               for j in range(i + 1, 4))
