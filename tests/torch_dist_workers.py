"""Worker functions of the distributed-training port tests
(`test_torch_mesh_context.py`, `test_torch_sharding.py`,
`test_torch_ring_pipeline.py`, `test_torch_distributed_fit.py`): a helper
module, not a test file, and it imports no jax (the workers are torch
ranks).

Each test file spawns one group of gloo CPU ranks once
(`run_group`: `common/cluster.launch_local_cluster` through a `FileStore`)
running one worker here, which runs every multi-rank case of that file
and writes this rank's results into `<out>/rank<r>.pt`; the tests then
hold those results against the JAX package in the parent process. The
inputs come from numpy seeds, the same on both sides.
"""

import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def start_group(worker: str, n: int, out: str, *args,
                timeout: float = 300.0):
    """Start `torch_dist_workers:<worker>(out, *args)` on `n` CPU ranks;
    returns a function that waits for them and returns every rank's
    results (a list of dicts, rank order), so the caller can compute the
    JAX side meanwhile."""
    from analytics_zoo_tpu_torch.common.cluster import (launch_local_cluster,
                                                        wait_all)
    env = {"PYTHONPATH": os.pathsep.join(
        p for p in (HERE, REPO, os.environ.get("PYTHONPATH")) if p),
        "OMP_NUM_THREADS": "1"}
    t0 = time.perf_counter()
    monitor = launch_local_cluster(f"torch_dist_workers:{worker}", n,
                                   worker_args=[out, *map(str, args)],
                                   env=env)

    def collect():
        wait_all(monitor, timeout=timeout)
        results = [torch.load(os.path.join(out, f"rank{r}.pt"),
                              weights_only=False) for r in range(n)]
        results[0]["_seconds"] = time.perf_counter() - t0
        return results
    return collect


def run_group(worker: str, n: int, out: str, *args, timeout: float = 300.0):
    """`start_group` and wait."""
    return start_group(worker, n, out, *args, timeout=timeout)()


def _save(out: str, rank: int, res: dict) -> None:
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def _ctx(**axes):
    from analytics_zoo_tpu_torch.common.context import init_orca_context
    return init_orca_context(device="cpu", **axes)


def _catch(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the test reads the type and text
        return f"{type(e).__name__}: {e}"
    return None


# ---------------------------------------------------------------------------
# test_torch_mesh_context.py
# ---------------------------------------------------------------------------
def mesh_worker(out: str):
    from analytics_zoo_tpu_torch.common import mesh as mesh_mod
    from analytics_zoo_tpu_torch.common.config import MeshConfig
    from analytics_zoo_tpu_torch.common.mesh import DeviceMesh
    ctx = _ctx(data=2, fsdp=2)
    m = ctx.mesh
    r = m.rank
    mesh_mod.reset_collective_stats()
    res = {"rank": r, "coords": m.coords, "repr": repr(m),
           "backend": m.backend, "batch_index": m.batch_index,
           "routes": m.routes(), "world": m.world}
    base = torch.arange(6, dtype=torch.float32) + 10 * r
    res["sum_batch"] = m.all_reduce(base.clone())
    res["sum_data"] = m.all_reduce(base.clone(), ("data",))
    res["sum_fsdp"] = m.all_reduce(base.clone(), ("fsdp",))
    res["max_all"] = m.all_reduce(base.clone(), ("data", "fsdp"), op="max")
    blk = torch.full((2, 3), float(r))
    res["gather_fsdp0"] = m.all_gather(blk, "fsdp", dim=0)
    res["gather_data1"] = m.all_gather(blk, "data", dim=1)
    res["scatter_fsdp1"] = m.reduce_scatter(
        torch.arange(12, dtype=torch.float32).view(3, 4) * (r + 1),
        "fsdp", dim=1)
    one = torch.tensor([float(r)])
    res["hop_fsdp"] = m.permute(one, "fsdp", 1)
    res["hop_data_back"] = m.permute(one, "data", -1)
    res["hop_sequence"] = m.permute(one, "sequence", 1)   # size 1: identity
    res["ints"] = m.all_gather_ints([r, 7 * r])
    # a second mesh over the same ranks, a ring of 4 on `sequence`
    ring = DeviceMesh(MeshConfig(data=1, sequence=-1), device="cpu")
    res["ring_coords"] = ring.coords
    res["ring_hop"] = ring.permute(one, "sequence", 1)
    res["stats"] = mesh_mod.collective_stats()
    _save(out, r, res)


# ---------------------------------------------------------------------------
# test_torch_sharding.py
# ---------------------------------------------------------------------------
def layout_params(seed: int = 0):
    """A BERT-like flat state dict (port names) with shapes that shard."""
    rs = np.random.RandomState(seed)
    shapes = {
        "bert.word_embeddings": (64, 16),
        "bert.blocks.0.attn.qkv_kernel": (16, 48),
        "bert.blocks.0.attn.qkv_bias": (48,),
        "bert.blocks.0.attn.out_kernel": (16, 16),
        "bert.blocks.0.ln1.gamma": (16,),
        "bert.blocks.0.ffn_in_kernel": (16, 32),
        "bert.blocks.0.ffn_out_kernel": (32, 16),
        "cls_kernel": (16, 3),
    }
    return {k: torch.tensor(rs.randn(*s), dtype=torch.float32)
            for k, s in shapes.items()}


def sharding_worker(out: str):
    from analytics_zoo_tpu_torch.learn.checkpoint import gather_leaf
    from analytics_zoo_tpu_torch.parallel.sharding import (
        TRANSFORMER_RULES, ShardLayout, placements, shard_batch)
    ctx = _ctx(data=2, fsdp=2)
    m = ctx.mesh
    r = m.rank
    params = layout_params()
    lay = ShardLayout(params, m, TRANSFORMER_RULES)
    blocks = lay.shard(params)
    state = lay.shard({"mu": {k: v * 2 for k, v in params.items()},
                       "count": 3})
    res = {"rank": r, "specs": {k: tuple(v) for k, v in lay.specs.items()},
           "dims": lay.dims, "block_shapes": {k: tuple(v.shape)
                                             for k, v in blocks.items()},
           "gathered": lay.gather_dict(blocks),
           "state_gathered": lay.gather(state),
           "local_bytes": sum(t.numel() * 4 for t in blocks.values()),
           "full_bytes": sum(t.numel() * 4 for t in params.values())}
    # every rank's gradient is (its batch index + 1) × the base: the mean
    # over 4 ranks is 2.5 × the base
    grads = {k: v * (m.batch_index + 1) for k, v in params.items()}
    red, loss = lay.reduce_grads(grads, torch.tensor(float(m.batch_index)))
    res["reduced"] = red
    res["mean_loss"] = float(loss)
    res["placements"] = {k: repr(placements(lay.specs[k], m))
                         for k in params}
    batch = {"ids": np.arange(8 * 6).reshape(8, 6)}
    res["batch"] = shard_batch(batch, m)
    k = "bert.blocks.0.attn.qkv_kernel"
    res["gather_leaf"] = gather_leaf(blocks[k], m, lay.dims[k])
    res["gather_leaf_rep"] = gather_leaf(blocks["bert.blocks.0.ln1.gamma"])
    _save(out, r, res)


# ---------------------------------------------------------------------------
# test_torch_ring_pipeline.py
# ---------------------------------------------------------------------------
def ring_inputs(B=4, H=2, T=32, D=8, seed=0):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(B, H, T, D).astype(np.float32) for _ in range(3))
    mask = np.zeros((B, T), np.float32)
    mask[:, 20:] = -10000.0
    return q, k, v, mask


def pipeline_inputs(seed=0):
    rs = np.random.RandomState(seed)
    S, d = 4, 16
    W = (rs.randn(S, d, d) * 0.3).astype(np.float32)
    b = (rs.randn(S, d) * 0.1).astype(np.float32)
    x = rs.randn(32, d).astype(np.float32)
    return W, b, x


def _stage_fn(p, x):
    return torch.tanh(x @ p["W"] + p["b"])


def ring_pipeline_worker(out: str):
    from analytics_zoo_tpu_torch.common.config import MeshConfig
    from analytics_zoo_tpu_torch.common.mesh import DeviceMesh
    from analytics_zoo_tpu_torch.parallel import ring_attention as ra
    from analytics_zoo_tpu_torch.parallel.pipeline import (
        from_microbatches, pipeline_apply, to_microbatches)
    ctx = _ctx(data=1, sequence=-1)
    m = ctx.mesh
    r = m.rank
    n, i = m.size("sequence"), m.coordinate("sequence")
    q, k, v, mask = (torch.from_numpy(a) for a in ring_inputs())
    bl = q.shape[2] // n
    sl = slice(i * bl, (i + 1) * bl)
    res = {"rank": r}
    for name, use_mask in (("nomask", False), ("mask", True)):
        for impl in ("plain", "flash"):
            ql, kl, vl = (t[:, :, sl].clone().requires_grad_()
                          for t in (q, k, v))
            ml = mask[:, sl].contiguous() if use_mask else None
            if impl == "plain":
                o = ra.ring_attention(ql, kl, vl, ml, mesh=m)
            else:
                m4 = None if ml is None else ml[:, None, None].contiguous()
                o = ra._ring_flash(ql, kl, vl, m4, m, "sequence")
            (o ** 2).sum().backward()
            res[f"{impl}_{name}"] = (o.detach(), ql.grad, kl.grad, vl.grad)
    # heads over a tensor axis wait for item 7b
    tp = DeviceMesh(MeshConfig(sequence=2, tensor=2), device="cpu")
    res["tensor_axis"] = _catch(lambda: ra.ring_attention(
        q[:, :, :16], k[:, :, :16], v[:, :, :16], None, mesh=tp))
    # pipeline: 4 stages on 4 ranks, 8 microbatches
    pm = DeviceMesh(MeshConfig(data=1, pipeline=-1), device="cpu")
    W, b, x = (torch.from_numpy(a) for a in pipeline_inputs())
    Wg = W.clone().requires_grad_()
    mbs = to_microbatches(x, 8)
    y = pipeline_apply(_stage_fn, {"W": Wg, "b": b}, mbs, pm)
    (y ** 2).sum().backward()
    gW = pm.all_reduce(Wg.grad.clone(), ("pipeline",))
    res["pipe_y"] = from_microbatches(y.detach())
    res["pipe_gW"] = gW
    res["pipe_bad"] = _catch(lambda: pipeline_apply(
        _stage_fn, {"W": W[:3], "b": b[:3]}, mbs, pm))
    _save(out, r, res)


# ---------------------------------------------------------------------------
# test_torch_distributed_fit.py
# ---------------------------------------------------------------------------
FIT_TINY = dict(vocab=64, hidden_size=32, n_block=1, n_head=2, seq_len=16,
                intermediate_size=64)
FIT_NO_DROP = dict(hidden_drop=0.0, attn_drop=0.0, dropout=0.0)
FIT_LR, FIT_BATCH, FIT_N, FIT_EPOCHS = 1e-2, 8, 32, 2


def fit_data(n=FIT_N, seed=0):
    rs = np.random.RandomState(seed)
    lens = rs.randint(4, 17, n)
    mask = (np.arange(16)[None, :] < lens[:, None]).astype(np.float32)
    return ([rs.randint(0, FIT_TINY["vocab"], (n, 16)).astype(np.int32),
             mask], rs.randint(0, 2, (n,)).astype(np.int32))


def local_rows(index: int, n_shares: int, n=FIT_N, batch=FIT_BATCH):
    """The rows of the global data rank `index` of `n_shares` feeds: its
    block of every global batch (shuffle off)."""
    share = batch // n_shares
    return np.concatenate([np.arange(b * batch + index * share,
                                     b * batch + (index + 1) * share)
                           for b in range(n // batch)])


def _fit_model(state):
    from analytics_zoo_tpu_torch.models.bert import BERTClassifier
    from analytics_zoo_tpu_torch.ops import objectives, optimizers
    m = BERTClassifier(2, use_flash=True, device="cpu", **FIT_TINY,
                       **FIT_NO_DROP)
    m.load_state_dict(state)
    m.compile(optimizer=optimizers.fused_adam(FIT_LR, weight_decay=1e-4),
              loss=objectives.get("sparse_categorical_crossentropy",
                                  from_logits=True))
    return m


def fit_worker(out: str, init_path: str, ckpt_root: str, tfr_glob: str):
    from analytics_zoo_tpu_torch.learn import trainer
    from analytics_zoo_tpu_torch.learn.checkpoint import load_checkpoint
    from analytics_zoo_tpu_torch.observability.registry import get_registry
    ctx = _ctx(data=2, fsdp=2)
    m = ctx.mesh
    r = m.rank
    init = torch.load(init_path, weights_only=False)
    x, y = fit_data()
    rows = local_rows(m.batch_index, m.data_parallel_size)
    xl, yl = [a[rows] for a in x], y[rows]
    kw = dict(batch_size=FIT_BATCH, shuffle=False, prefetch=False,
              device_cache=False, seed=7)
    gauge = get_registry().gauge("training_state_bytes_per_rank")
    res = {"rank": r}

    sh = _fit_model(init)
    res["sharded"] = trainer.fit_keras(sh, xl, yl, epochs=FIT_EPOCHS,
                                       sharding_rules=True, **kw)["loss"]
    res["sharded_bytes"] = gauge.value()
    res["sharded_state"] = {k: v.clone() for k, v in sh.state_dict().items()}
    rep = _fit_model(init)
    res["replicated"] = trainer.fit_keras(rep, xl, yl, epochs=FIT_EPOCHS,
                                          **kw)["loss"]
    res["replicated_bytes"] = gauge.value()
    res["replicated_state"] = {k: v.clone()
                               for k, v in rep.state_dict().items()}
    # the same sharded fit through Estimator.fit (the context's device,
    # `sharding_rules` passed through)
    from analytics_zoo_tpu_torch.data.dataset import TPUDataset
    from analytics_zoo_tpu_torch.learn.estimator import Estimator
    est = Estimator(_fit_model(init))
    res["estimator"] = est.fit(
        TPUDataset.from_ndarrays((xl, yl), batch_size=FIT_BATCH,
                                 shuffle=False),
        epochs=FIT_EPOCHS, seed=7, sharding_rules=True, prefetch=False,
        device_cache=False)["loss"]

    # checkpoint round trip: rank 0 wrote the gathered tree
    root = os.path.join(ckpt_root, "roundtrip")
    ck = _fit_model(init)
    ck.set_checkpoint(root)
    trainer.fit_keras(ck, xl, yl, epochs=1, sharding_rules=True, **kw)
    m.barrier()
    tree, opt_tree, meta = load_checkpoint(root)
    res["ckpt_tree"] = tree
    res["ckpt_meta"] = meta
    res["ckpt_live"] = {k: v.clone() for k, v in ck.state_dict().items()}
    res["ckpt_opt_leaves"] = len([1 for _ in _leaves(opt_tree)])
    m.barrier()

    # auto-resume under sharding continues bitwise
    root = os.path.join(ckpt_root, "resume")
    full = _fit_model(init)
    h_full = trainer.fit_keras(full, xl, yl, epochs=3, sharding_rules=True,
                               **kw)["loss"]
    a = _fit_model(init)
    a.set_checkpoint(root)
    trainer.fit_keras(a, xl, yl, epochs=2, sharding_rules=True, **kw)
    b = _fit_model(init)
    b.set_checkpoint(root)
    h_res = trainer.fit_keras(b, xl, yl, epochs=3, auto_resume=True,
                              sharding_rules=True, **kw)["loss"]
    res["resume"] = (h_full, h_res)
    res["resume_bitwise"] = all(
        torch.equal(p, q) for p, q in zip(full.state_dict().values(),
                                          b.state_dict().values()))

    # the multi-process refusals (JAX L1126-1200)
    def fit(**over):
        return lambda: trainer.fit_keras(_fit_model(init), xl, yl,
                                         **dict(kw, epochs=1, **over))
    res["refuse_batch"] = _catch(fit(batch_size=6))
    res["refuse_stream"] = _catch(fit(
        batch_iter_factory=lambda e: iter([(xl, yl, FIT_BATCH // 4)])))
    res["refuse_cache"] = _catch(fit(device_cache=True))
    n_local = len(yl) - (2 if r == 3 else 0)
    res["refuse_counts"] = _catch(lambda: trainer.fit_keras(
        _fit_model(init), [a[:n_local] for a in xl], yl[:n_local],
        **dict(kw, epochs=1)))

    # the streamed multi-process epoch: this host's files, equal steps
    from analytics_zoo_tpu_torch.data.dataset import TPUDataset
    ds = TPUDataset.from_tfrecord(tfr_glob, tfr_parse, batch_size=8,
                                  shuffle=True)
    res["stream_files"] = ds._host_files(sorted(ds._files))
    res["stream_batches"] = [xb["v"].copy() for xb, _, _ in
                             ds.iter_train(1, seed=3)]
    _save(out, r, res)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def tfr_parse(example):
    """An Example of the streamed corpus → (x, y)."""
    return ({"v": example["v"]}, example["y"].astype(np.int32)[0])


def write_corpus(directory: str, sizes=(5, 9, 7, 12, 6), dim=3,
                 seed=0) -> str:
    """TFRecord files of unequal record counts (the stream's `v` rows
    number each record); returns their glob."""
    from analytics_zoo_tpu_torch.data import tfrecord as ttfr
    rs = np.random.RandomState(seed)
    at = 0
    for s, n in enumerate(sizes):
        recs = []
        for _ in range(n):
            recs.append(ttfr.encode_example({
                "v": np.asarray([at] + list(rs.randn(dim - 1)), np.float32),
                "y": np.asarray([rs.randint(2)], np.int64)}))
            at += 1
        ttfr.write_tfrecord(os.path.join(directory,
                                         f"part-{s:05d}.tfrecord"), recs)
    return os.path.join(directory, "part-*.tfrecord")


if __name__ == "__main__":
    sys.exit(0)
