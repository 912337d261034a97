"""The port's segment-Adam module (`kernels/segment_update.py`) and its
unfused twin (`learn/lazy_embedding.py`) held against the JAX package on
the CPU, at NeuralCF's BENCH_TINY sizes (`bench_ncf.py:52`: 200 users, 100
items; tables here [201, 8] and [101, 8], batches of 512 ids).

The JAX `kernel_apply` runs its Pallas kernel in interpret mode off the
TPU, which the installed jax refuses (`pl.CostEstimate` takes ints only,
ROADMAP.md queue 3), so the oracles are the jnp code that the kernel is
built from: `segment_compact`, `fused_adam._adam_math` with
`_fold_scalars(count, lr, b1, b2, eps, 0.0)` and a scatter of the valid
slots, and `lazy_embedding.row_adam_update`.

Tolerances:
- `segment_compact`: uids and valid exact; g_slots 1e-6 absolute (sums of
  a few gradients of scale 1e-2 added in the same sorted order; XLA may
  add them in another grouping);
- row Adam against `_adam_math`: 1e-7 absolute on parameters of scale 0.05
  and moments (the same operations; XLA may contract a multiply-add);
- the fused path against `row_adam_update`: 1e-6 absolute, since the two
  place the bias correction differently (folded scalars against corrected
  moments) and round differently;
- rows no slot touches: bitwise unchanged.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.learn import lazy_embedding as jlazy
from analytics_zoo_tpu.pallas import fused_adam as jfad
from analytics_zoo_tpu.pallas import segment_update as jseg
from analytics_zoo_tpu_torch.kernels import LAUNCHES
from analytics_zoo_tpu_torch.kernels import fused_adam as fad
from analytics_zoo_tpu_torch.kernels import segment_update as seg
from analytics_zoo_tpu_torch.learn import lazy_embedding as lazy

B, DIM = 512, 8
HP = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
# (table rows, ids drawn from [1, hi]): the user and item tables at
# BENCH_TINY scale, heavy duplicates, and one id for the whole batch
ID_MIXES = {"users": (201, 200), "items": (101, 100), "heavy": (201, 8),
            "single": (201, 1)}


def _ids(mix, seed=0):
    rows, hi = ID_MIXES[mix]
    return rows, np.random.RandomState(seed).randint(1, hi + 1, B) \
        .astype(np.int32)


def _state(rows, seed=1, dtype=np.float32):
    rs = np.random.RandomState(seed)
    return (rs.uniform(-0.05, 0.05, (rows, DIM)).astype(dtype),
            (rs.standard_normal((rows, DIM)) * 1e-3).astype(np.float32),
            ((rs.standard_normal((rows, DIM)) * 1e-3) ** 2)
            .astype(np.float32))


def _rows(seed=2):
    return (np.random.RandomState(seed).standard_normal((B, DIM)) * 1e-2) \
        .astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("mix", sorted(ID_MIXES))
def test_segment_compact_matches_jax(mix):
    _, ids = _ids(mix)
    d_rows = _rows()
    ju, jv, jg = jax.device_get(jseg.segment_compact(jnp.asarray(ids),
                                                     jnp.asarray(d_rows)))
    tu, tv, tg = seg.segment_compact(_t(ids), _t(d_rows))
    np.testing.assert_array_equal(tu.numpy(), ju)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=1e-6)
    assert tu.dtype == torch.int32 and tv.dtype == torch.int32


def test_duplicates_summed_and_tail_zero():
    ids = _t([5, 3, 5, 5, 9, 3])
    d = torch.arange(6, dtype=torch.float32)[:, None].repeat(1, 2)
    uids, valid, g = seg.segment_compact(ids, d)
    assert uids.tolist() == [3, 5, 9, 9, 9, 9]
    assert valid.tolist() == [1, 1, 1, 0, 0, 0]
    assert g[:, 0].tolist() == [1 + 5, 0 + 2 + 3, 4, 0, 0, 0]


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("mix", ["users", "heavy"])
def test_kernel_apply_plain_matches_jax_adam_math(mix, dtype):
    """The plain `kernel_apply` against JAX `segment_compact` +
    `_adam_math` + a scatter of the valid slots, over 3 steps."""
    rows, _ = _ids(mix)
    table, mu, nu = _state(rows)
    bf16 = dtype == "bfloat16"
    if bf16:
        table = np.asarray(jnp.asarray(table, jnp.bfloat16)
                           .astype(jnp.float32))
    tt = _t(table).to(torch.bfloat16 if bf16 else torch.float32)
    tm, tn = _t(mu), _t(nu)
    jt, jm, jn = (jnp.asarray(table, jnp.bfloat16 if bf16 else jnp.float32),
                  jnp.asarray(mu), jnp.asarray(nu))
    for count in (1, 2, 3):
        _, ids = _ids(mix, seed=count)
        d_rows = _rows(seed=10 + count)
        uids, valid, g = jseg.segment_compact(jnp.asarray(ids),
                                              jnp.asarray(d_rows))
        a, b, lrwd = jfad._fold_scalars(count, HP["lr"], HP["b1"], HP["b2"],
                                        HP["eps"], 0.0)
        keep = np.asarray(valid) > 0
        r = np.asarray(uids)[keep]
        pn, mn, vn = jfad._adam_math(jt[r].astype(jnp.float32), jm[r],
                                     jn[r], g[keep], a, b, lrwd, HP["b1"],
                                     HP["b2"])
        jt = jt.at[r].set(pn.astype(jt.dtype))
        jm, jn = jm.at[r].set(mn), jn.at[r].set(vn)
        scal = fad._fold_scalars(count, HP["lr"], HP["b1"], HP["b2"],
                                 HP["eps"], 0.0)
        tu, tv, tg = seg.segment_compact(_t(ids), _t(d_rows))
        out = seg.kernel_apply(tt, tm, tn, tu, tv, tg, scal, b1=HP["b1"],
                               b2=HP["b2"])
        assert all(o is t for o, t in zip(out, (tt, tm, tn)))   # in place
    want_t = np.asarray(jt.astype(jnp.float32))
    np.testing.assert_allclose(tt.float().numpy(), want_t, rtol=0,
                               atol=(2 ** -9 * 0.06) if bf16 else 1e-7)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=0,
                               atol=1e-7)


@pytest.mark.parametrize("mix", ["users", "items", "heavy"])
def test_segment_adam_update_matches_row_adam_update(mix):
    """The fused path given a dense table gradient (one row per distinct id
    through `_dedup_rows`) against JAX `row_adam_update`."""
    rows, ids = _ids(mix)
    table, mu, nu = _state(rows)
    g_table = (np.random.RandomState(3).standard_normal((rows, DIM))
               * 1e-2).astype(np.float32)
    spec = jlazy.LazyEmbeddingSpec(("t", "embeddings"), None, lr=HP["lr"])
    jt, jm, jn = jax.device_get(jlazy.row_adam_update(
        spec, jnp.asarray(table), jnp.asarray(mu), jnp.asarray(nu),
        jnp.asarray(g_table), jnp.asarray(ids), jnp.asarray(2, jnp.int32)))
    tt, tm, tn = _t(table), _t(mu), _t(nu)
    seg.segment_adam_update(tt, tm, tn, _t(ids),
                            seg._dedup_rows(_t(g_table), _t(ids)), 2, **HP)
    for got, want in ((tt, jt), (tm, jm), (tn, jn)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mix", ["users", "heavy"])
def test_row_adam_update_matches_jax(mix):
    """The port's unfused row Adam (the plain path) against the JAX one:
    the same arithmetic, 1e-7."""
    rows, ids = _ids(mix)
    table, mu, nu = _state(rows)
    g_table = (np.random.RandomState(4).standard_normal((rows, DIM))
               * 1e-2).astype(np.float32)
    jspec = jlazy.LazyEmbeddingSpec(("t", "embeddings"), None, lr=HP["lr"])
    want = jax.device_get(jlazy.row_adam_update(
        jspec, jnp.asarray(table), jnp.asarray(mu), jnp.asarray(nu),
        jnp.asarray(g_table), jnp.asarray(ids), jnp.asarray(3, jnp.int32)))
    tspec = lazy.LazyEmbeddingSpec(("t", "embeddings"), None, lr=HP["lr"])
    got = lazy.row_adam_update(tspec, _t(table), _t(mu), _t(nu),
                               _t(g_table), _t(ids), 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-7)
    untouched = np.setdiff1d(np.arange(rows), ids)
    np.testing.assert_array_equal(got[0].numpy()[untouched],
                                  table[untouched])


def test_dedup_rows_matches_jax():
    rows, ids = _ids("heavy")
    g_table = np.random.RandomState(5).standard_normal((rows, DIM)) \
        .astype(np.float32)
    want = jax.device_get(jseg._dedup_rows(jnp.asarray(g_table),
                                           jnp.asarray(ids)))
    got = seg._dedup_rows(_t(g_table), _t(ids))
    np.testing.assert_array_equal(got.numpy(), want)


def test_untouched_rows_bitwise_and_invalid_tail_ignored():
    """Whatever the tail's uids say (a valid slot's row, another row), an
    invalid slot writes nothing, and no row outside the valid slots
    changes by a bit."""
    rows, ids = _ids("users")
    table, mu, nu = _state(rows)
    uids, valid, g = seg.segment_compact(_t(ids), _t(_rows()))
    n_valid = int(valid.sum())
    scal = fad._fold_scalars(1, **{k: HP[k] for k in ("lr", "b1", "b2",
                                                      "eps")},
                             weight_decay=0.0)
    ref = [_t(a) for a in (table, mu, nu)]
    seg.kernel_apply(*ref, uids, valid, g, scal, b1=HP["b1"], b2=HP["b2"])
    garbage = uids.clone()
    garbage[n_valid:] = torch.randint(0, rows, (B - n_valid,),
                                      generator=torch.Generator()
                                      .manual_seed(0)).int()
    garbage[n_valid] = uids[0]
    got = [_t(a) for a in (table, mu, nu)]
    g_tail = g.clone()
    g_tail[n_valid:] = 7.0
    seg.kernel_apply(*got, garbage, valid, g_tail, scal, b1=HP["b1"],
                     b2=HP["b2"])
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    touched = torch.zeros(rows, dtype=torch.bool)
    touched[uids[:n_valid].long()] = True
    for a, before in zip(got, (table, mu, nu)):
        assert torch.equal(a[~touched], _t(before)[~touched])
        assert not torch.equal(a[touched], _t(before)[touched])


def test_kernel_apply_with_no_valid_slot_writes_nothing():
    rows, _ = _ids("users")
    table, mu, nu = (_t(a) for a in _state(rows))
    before = [t.clone() for t in (table, mu, nu)]
    uids = torch.full((4,), 3, dtype=torch.int32)
    seg.kernel_apply(table, mu, nu, uids, torch.zeros(4, dtype=torch.int32),
                     torch.ones(4, DIM), (1e-3, 1e-8, 0.0))
    assert all(torch.equal(a, b) for a, b in zip((table, mu, nu), before))


def test_segment_adam_cost_counts_touched_rows_only():
    flops, nbytes = seg.segment_adam_cost(8192, 64)
    assert flops == 12.0 * 8192 * 64
    assert nbytes == 8192 * 64 * 28
    assert seg.segment_adam_cost(10, 4, torch.bfloat16)[1] == 10 * 4 * 24


def test_plain_versions_count_no_launch_and_other_devices_raise():
    rows, ids = _ids("users")
    table, mu, nu = (_t(a) for a in _state(rows))
    LAUNCHES.reset()
    seg.segment_adam_update(table, mu, nu, _t(ids), _t(_rows()), 1, **HP)
    assert LAUNCHES.snapshot() == {}
    meta = torch.empty((rows, DIM), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        seg.kernel_apply(meta, meta, meta, _t(ids).to("meta"),
                         _t(ids).to("meta"), torch.empty((B, DIM),
                                                         device="meta"),
                         (1.0, 1.0, 0.0))
    with pytest.raises(ValueError, match="unsupported device"):
        seg.segment_sum(torch.empty((B, DIM), device="meta"),
                        *seg.sort_ids(_t(ids).to("meta"))[:2],
                        torch.empty(B, device="meta"))


def test_step_path_reads_nothing_on_the_host():
    """A static check of the no-sync rule: nothing on the step path reads a
    device value on the host."""
    sources = [inspect.getsource(f) for f in (
        seg.sort_ids, seg.segment_compact, seg.segment_adam_update,
        seg.make_fused_one_step, seg._dedup_rows, seg._launch,
        seg._launch_segment_sum, seg.kernel_apply, lazy.init_state)]
    for token in (".item(", "unique(", "nonzero(", ".tolist(", "bool()]"):
        assert not any(token in s for s in sources), token


@pytest.mark.gpu
def test_segment_kernels_on_gpu():
    """On the card: both kernels against their plain versions, bitwise,
    f32 and bf16 tables, with duplicates."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    for dtype in (torch.float32, torch.bfloat16):
        rows, ids = _ids("heavy")
        table, mu, nu = (_t(a).cuda() for a in _state(rows))
        table = table.to(dtype)
        d_rows = _t(_rows()).cuda()
        LAUNCHES.reset()
        uids, valid, g = seg.segment_compact(_t(ids).cuda(), d_rows)
        cu, cv, cg = seg.segment_compact(_t(ids), d_rows.cpu())
        assert torch.equal(g.cpu(), cg) and torch.equal(uids.cpu(), cu)
        plain = [t.clone() for t in (table, mu, nu)]
        scal = fad._fold_scalars(1, HP["lr"], HP["b1"], HP["b2"], HP["eps"],
                                 0.0)
        seg.kernel_apply(table, mu, nu, uids, valid, g, scal)
        seg._reference_kernel_apply(*plain, uids, valid, g, scal, HP["b1"],
                                    HP["b2"])
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip((table, mu, nu), plain))
        assert LAUNCHES.snapshot() == {seg.KERNEL_NAME: 1, seg.SUM_NAME: 1}
