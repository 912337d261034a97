"""Training from captured programs, on the CPU: the step's scalar table,
device seeds, `steps_per_run`, `device_cache` and `compile_cache_dir` in
`fit`, held against the old host-scalar arithmetic, against each other
and against the JAX package.

- The optimizers read their per-step values (bias corrections, the
  scheduled rate, the folded `(a, b, lr·wd)`) from a row of f32 values on
  the device. Each update from a row is held bit for bit against the
  arithmetic with host floats that it replaces (`_old_*` below), step by
  step, in f32 and bf16.
- A `DeviceSeed` names a dropout site by the step seed on the device and a
  static path of site indices; its Philox key, computed with integer
  tensor ops, is held against `site_seed` on Python ints.
- `steps_per_run=k` (a short tail group included) and `device_cache=True`
  change no number: losses, parameters and optimizer state are bitwise
  those of `steps_per_run=1` with host batches. On the CPU a program runs
  the same buffer protocol as on the card, eagerly (the CUDA graphs are
  captured only on the card: `chip_smoke.py`'s training phases).
- Against the JAX package (dropout 0): `fit_keras(steps_per_run=4)` and
  `fit_keras(device_cache=True, shuffle=False)` of an MLP from the same
  weights, within 1e-5 (f32, a few steps of Adam: the packages agree to
  ~1e-7). JAX shuffles a device-cached epoch with `jax.random`, which the
  port does not reproduce (it keeps the host path's order), so that case
  runs unshuffled.
"""

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import triggers as jtg
from analytics_zoo_tpu.keras import Sequential as JSequential
from analytics_zoo_tpu.keras import layers as JL
from analytics_zoo_tpu.learn import trainer as jtrainer
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.common import triggers as tg
from analytics_zoo_tpu_torch.compile_cache import CompileCache
from analytics_zoo_tpu_torch.kernels import dropout as dr
from analytics_zoo_tpu_torch.kernels import fused_adam as fad
from analytics_zoo_tpu_torch.kernels import philox
from analytics_zoo_tpu_torch.kernels import segment_update as seg
from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.keras.engine import Sequential
from analytics_zoo_tpu_torch.learn import lazy_embedding as lz
from analytics_zoo_tpu_torch.learn import schedule, trainer
from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
from analytics_zoo_tpu_torch.ops import optimizers

CROSS_TOL = 1e-5
f32 = np.float32


# ---------------------------------------------------------------------------
# The arithmetic with host floats that the scalar rows replace
# ---------------------------------------------------------------------------
def _old_scale_by_lr(lr_value: float, updates):
    step = np.float32(-np.float32(lr_value))
    return {n: u * torch.tensor(float(step), dtype=u.dtype)
            for n, u in updates.items()}


def _old_adam(lr, b1, b2, eps, wd):
    def update(grads, state, params):
        count = state.count + 1
        bc1 = float(f32(1.0) - f32(b1) ** f32(count))
        bc2 = float(f32(1.0) - f32(b2) ** f32(count))
        step = -float(f32(lr(state.count)))
        updates = {}
        for name, g in grads.items():
            mu, nu = state.mu[name], state.nu[name]
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * (g * g))
            mu_hat = mu / torch.tensor(bc1, dtype=torch.float32).to(mu.dtype)
            nu_hat = nu / torch.tensor(bc2, dtype=torch.float32).to(nu.dtype)
            u = mu_hat / (torch.sqrt(nu_hat) + eps)
            if wd is not None:
                u = u + wd * params[name]
            updates[name] = u * torch.tensor(step, dtype=u.dtype)
        return updates, optimizers.FusedAdamState(count, state.mu, state.nu)
    return update


def _old_adagrad(lr, eps=1e-7):
    def update(grads, state, params):
        sos = {n: g * g + state[0].sum_of_squares[n]
               for n, g in grads.items()}
        u = {n: torch.where(sos[n] > 0, torch.rsqrt(sos[n] + eps), 0.0) * g
             for n, g in grads.items()}
        count = optimizers._lr_count(state)
        return (_old_scale_by_lr(lr(count), u),
                (optimizers.ScaleByRssState(sos),
                 optimizers._next_lr_state(lr, state)))
    return update


def _old_sgd(lr):
    def update(grads, state, params):
        count = optimizers._lr_count(state)
        return (_old_scale_by_lr(lr(count), grads),
                (optimizers.EmptyState(),
                 optimizers._next_lr_state(lr, state)))
    return update


_SCHED = schedule.Poly(0.5, 7).make(0.01)
_WARM = optimizers.warmup_linear_decay(1e-3, 10, 0.3)
_OPTIMIZERS = {
    "adam": (lambda: optimizers.adam(1e-3),
             lambda: _old_adam(lambda c: 1e-3, 0.9, 0.999, 1e-8, None)),
    "adamw": (lambda: optimizers.adamw(1e-3, weight_decay=1e-2),
              lambda: _old_adam(lambda c: 1e-3, 0.9, 0.999, 1e-8, 1e-2)),
    "adamw_warmup": (lambda: optimizers.adamw(_WARM, weight_decay=1e-2),
                     lambda: _old_adam(_WARM, 0.9, 0.999, 1e-8, 1e-2)),
    "adagrad": (lambda: optimizers.adagrad(0.01),
                lambda: _old_adagrad(lambda c: 0.01)),
    "adagrad_poly": (lambda: optimizers.adagrad(_SCHED),
                     lambda: _old_adagrad(_SCHED)),
    "sgd_poly": (lambda: optimizers.sgd(_SCHED), lambda: _old_sgd(_SCHED)),
}


def _tree(seed, dtype):
    rs = np.random.RandomState(seed)
    return {n: torch.from_numpy(np.asarray(rs.randn(*shape),
                                           np.float32)).to(dtype)
            for n, shape in (("w", (5, 3)), ("b", (3,)), ("s", ()))}


def _clone(tree):
    return {k: v.clone() for k, v in tree.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(_OPTIMIZERS))
def test_table_row_update_is_bitwise_the_host_scalar_update(name, dtype):
    """Five steps: the update reading its row of the scalar table equals
    the old update with host floats, and the update that computes and
    uploads its own row, bit for bit (updates and state)."""
    make, make_old = _OPTIMIZERS[name]
    opt, old = make(), make_old()
    params = _tree(0, dtype)
    s_row, s_self, s_old = (opt.init(params) for _ in range(3))
    for step in range(5):
        grads = _tree(10 + step, dtype)
        row = optimizers.scalar_row(opt.scalars(s_row), "cpu")
        u_row, s_row = opt.update(_clone(grads), s_row, params, scalars=row)
        u_self, s_self = opt.update(_clone(grads), s_self, params)
        u_old, s_old = old(_clone(grads), s_old, params)
        for k in params:
            assert torch.equal(u_row[k], u_old[k]), (step, k)
            assert torch.equal(u_self[k], u_old[k]), (step, k)
        for a, b in zip(trainer.tree_leaves(s_row),
                        trainer.tree_leaves(s_old)):
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else a == b)
        params = {k: p + u_row[k] for k, p in params.items()}


@pytest.mark.parametrize("pdtype", [torch.float32, torch.bfloat16])
def test_fused_adam_row_is_bitwise_its_host_floats(pdtype):
    """The fused twin's folded row (`scalars`) against the same sweep given
    `count` and `lr` as host floats, three steps with a schedule."""
    opt = optimizers.fused_adam(_WARM, weight_decay=1e-2)
    pa, pb = _tree(1, pdtype), _tree(1, pdtype)
    sa, sb = opt.init(pa), opt.init(pb)
    for step in range(3):
        g = _tree(20 + step, torch.float32)
        row = optimizers.scalar_row(opt.scalars(sa), "cpu")
        pa, sa = opt.fused_apply(_clone(g), sa, pa, scalars=row)
        fad.fused_adam_step(pb, sb.mu, sb.nu, _clone(g), sb.count + 1,
                            lr=_WARM(sb.count), b1=0.9, b2=0.999, eps=1e-8,
                            weight_decay=1e-2)
        sb = optimizers.FusedAdamState(sb.count + 1, sb.mu, sb.nu)
        for k in pa:
            assert torch.equal(pa[k], pb[k]) and torch.equal(
                sa.mu[k], sb.mu[k]) and torch.equal(sa.nu[k], sb.nu[k])


def test_row_adam_paths_are_bitwise_their_host_floats():
    """The lazy tables' row Adam (`row_adam_update`, bias corrections from
    the row) and the segment path (`kernel_apply`, folded scalars from the
    row) against the same updates from host floats."""
    spec = lz.LazyEmbeddingSpec(("emb", "embeddings"), lambda x: x,
                                lr=1e-2)
    rs = np.random.RandomState(4)
    ids = torch.from_numpy(rs.randint(0, 9, 12))
    table = torch.from_numpy(rs.randn(9, 4).astype(np.float32))
    tables = [table.clone(), table.clone()]
    moments = [[torch.zeros(9, 4), torch.zeros(9, 4)] for _ in range(2)]
    for t in (1, 2, 3):
        g = torch.from_numpy(rs.randn(9, 4).astype(np.float32))
        row = optimizers.scalar_row(lz._corrections(spec, t), "cpu")
        lz.row_adam_update(spec, tables[0], *moments[0], g, ids, t, row)
        lz.row_adam_update(spec, tables[1], *moments[1], g, ids, t)
        assert torch.equal(tables[0], tables[1])
    d_rows = torch.from_numpy(rs.randn(12, 4).astype(np.float32))
    uids, valid, g_slots = seg.segment_compact(ids, d_rows)
    outs = []
    for scal in (fad._fold_scalars(3, 1e-2, 0.9, 0.999, 1e-8, 0.0), None):
        if scal is None:
            scal = optimizers.scalar_row(
                fad._fold_scalars(3, 1e-2, 0.9, 0.999, 1e-8, 0.0), "cpu")
        t, m, v = (x.clone() for x in (tables[0], *moments[0]))
        seg.kernel_apply(t, m, v, uids, valid, g_slots, scal)
        outs.append((t, m, v))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


# ---------------------------------------------------------------------------
# Device seeds
# ---------------------------------------------------------------------------
def test_device_seed_path_is_the_int_rule():
    """`seed_words` of a `DeviceSeed` (tensor ops along its path) is the
    Philox key of `site_seed` applied along the path on ints, for 300
    seeds and paths of depth 0 to 8, sites up to 2^40."""
    rs = np.random.RandomState(7)
    for _ in range(300):
        seed = int(rs.randint(0, 2 ** 62, dtype=np.int64))
        path = tuple(int(rs.choice([rs.randint(0, 64), 2 ** 40 + 3]))
                     for _ in range(rs.randint(0, philox.MAX_SEED_DEPTH + 1)))
        want = seed
        dev = philox.DeviceSeed(torch.tensor([seed]))
        for site in path:
            want = philox.site_seed(want, site)
            dev = philox.site_seed(dev, site)
        assert dev.path == path
        lo, hi = philox.seed_words(dev)
        assert (int(lo), int(hi)) == (want & 0xFFFFFFFF, want >> 32)


def test_device_seed_masks_are_the_int_seed_masks():
    """The plain versions draw the same masks from a `DeviceSeed` as from
    its int seed: element dropout and the attention keep-scale matrix."""
    seed, path = 123456789012345, (3, 0, 1)
    want = seed
    for site in path:
        want = philox.site_seed(want, site)
    dev = philox.DeviceSeed(torch.tensor([seed]), path)
    assert torch.equal(dr.dropout_keep((7, 33), dev, 0.3),
                       dr.dropout_keep((7, 33), want, 0.3))
    assert torch.equal(philox.attention_keep_scale(6, 40, dev, 200),
                       philox.attention_keep_scale(6, 40, want, 200))
    x = torch.randn(7, 33)
    assert torch.equal(dr.fused_dropout(x, 0.3, seed=dev),
                       dr.fused_dropout(x, 0.3, seed=want))
    with pytest.raises(ValueError, match="at most"):
        philox.DeviceSeed(torch.tensor([1]), tuple(range(9)))


# ---------------------------------------------------------------------------
# steps_per_run and device_cache change no number
# ---------------------------------------------------------------------------
def _mlp(seed=0, optimizer="adam"):
    m = Sequential()
    m.add(L.Dense(16, activation="relu", input_shape=(6,), device="cpu"))
    m.add(L.Dropout(0.25))
    m.add(L.Dense(3, activation="softmax", device="cpu"))
    m.compile(optimizer, "sparse_categorical_crossentropy")
    m.ensure_built(seed=seed)
    return m


def _class_data(n, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 6).astype(np.float32)
    return x, (np.abs(x[:, 0] * 2 + x[:, 1]) % 3).astype(np.int32)


def _fit(make, **kw):
    m = make()
    x, y = _class_data(44, 1)
    h = trainer.fit_keras(m, x, y, batch_size=4, epochs=2, seed=3, **kw)
    state = m.__dict__["_train_cache"][1].state
    return (h["loss"], [v.clone() for v in m.state_dict().values()],
            [v.clone() if isinstance(v, torch.Tensor) else v
             for v in trainer.tree_leaves(state)])


def _same(a, b):
    """Losses, parameters (by position: auto-named layers differ between
    instances) and optimizer state leaves, bitwise."""
    return a[0] == b[0] and all(
        torch.equal(u, v) if isinstance(u, torch.Tensor) else u == v
        for u, v in zip(a[1] + a[2], b[1] + b[2]))


@pytest.mark.parametrize("optimizer,fused", [
    ("adam", False), ("adam", True), ("rmsprop", False), ("adagrad", False)])
def test_steps_per_run_and_device_cache_change_no_number(optimizer, fused):
    """11 steps an epoch (groups of 4, 4 and a tail of 3) with dropout, host
    batches and device-resident data, each against one step a run with
    host batches: losses, parameters and the optimizer state (its counts
    included) bitwise."""
    make = lambda: _mlp(optimizer=optimizer)  # noqa: E731
    base = _fit(make, device_cache=False, fused_optimizer=fused)
    for kw in (dict(device_cache=False, steps_per_run=4),
               dict(device_cache=True), dict(device_cache=True,
                                             steps_per_run=4),
               dict()):
        assert _same(_fit(make, fused_optimizer=fused, **kw), base), kw


@pytest.mark.parametrize("fused", [False, True])
def test_lazy_tables_under_programs_change_no_number(fused):
    """NeuralCF's row-sparse tables (the plain row Adam, or the segment
    path with `fused`), 64-step programs over device-resident data against
    one step a run over host batches."""
    def run(**kw):
        ncf = NeuralCF(user_count=40, item_count=30, class_num=2,
                       user_embed=4, item_embed=4, mf_embed=4,
                       hidden_layers=(8, 4), device="cpu")
        ncf.model.ensure_built(seed=0)
        ncf.compile("adam", "sparse_categorical_crossentropy")
        rs = np.random.RandomState(2)
        x = np.stack([rs.randint(1, 40, 160), rs.randint(1, 30, 160)],
                     axis=1).astype(np.int32)
        y = rs.randint(0, 2, 160).astype(np.int32)
        h = ncf.fit(x, y, batch_size=16, nb_epoch=2, lazy_embeddings=True,
                    fused_optimizer=fused, **kw)
        return h["loss"], [v.clone()
                           for v in ncf.model.state_dict().values()]
    base = run(device_cache=False)
    got = run(device_cache=True, steps_per_run=64)
    assert got[0] == base[0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], base[1]))


def test_programs_are_kept_on_the_model_across_fits():
    """A second fit replays the first fit's program over the same state
    tensors (a fresh `init` written into them); a storage change of a
    parameter drops the programs."""
    m = _mlp()
    x, y = _class_data(16, 2)
    trainer.fit_keras(m, x, y, batch_size=4, epochs=1)
    entry = m.__dict__["_train_cache"][1]
    progs, mu = dict(entry.programs), entry.state.mu
    trainer.fit_keras(m, x, y, batch_size=4, epochs=1)
    assert entry is m.__dict__["_train_cache"][1]
    assert entry.programs == progs
    assert all(entry.state.mu[k] is mu[k] for k in mu)
    assert entry.state.count == 4        # a fresh init, then four steps
    with torch.no_grad():
        first = next(m.parameters())
        first.data = first.data.clone()
    trainer.fit_keras(m, x, y, batch_size=4, epochs=1)
    assert set(entry.programs) == set(progs)
    assert all(entry.programs[k] is not progs[k] for k in progs)


def test_device_data_of_the_same_rows_keeps_the_programs():
    """A dataset of the same row shapes and at most as many rows is
    copied into the device buffers the programs gather from, so they stay
    (a subset, then the full data again); a larger one gets new buffers
    and new programs. A copy of the fitted model (serving's
    `copy_module`) starts without the fit's programs and data."""
    from analytics_zoo_tpu_torch.common.modules import copy_module
    m = _mlp()
    x, y = _class_data(44, 1)
    trainer.fit_keras(m, x, y, batch_size=4, device_cache=True)
    entry = m.__dict__["_train_cache"][1]
    progs, dc = dict(entry.programs), entry.dc
    for n in (20, 44):
        trainer.fit_keras(m, x[:n], y[:n], batch_size=4, device_cache=True)
        assert entry.dc is dc and entry.programs == progs
        assert m.__dict__["_device_data"][1].shape[0] == n
    xl, yl = _class_data(48, 2)
    trainer.fit_keras(m, xl, yl, batch_size=4, device_cache=True)
    assert entry.dc is not dc
    assert all(entry.programs[k] is not progs[k] for k in progs)
    twin = copy_module(m, lambda key, t: t.detach().clone())
    assert twin.__dict__.get("_train_cache") is None
    assert twin.__dict__.get("_device_data") is None


def test_device_cache_of_streaming_input_raises():
    m = _mlp()
    x, y = _class_data(8, 0)
    with pytest.raises(NotImplementedError, match="streaming"):
        trainer.fit_keras(m, None, batch_size=4, device_cache=True,
                          batch_iter_factory=lambda e: trainer.iter_batches(
                              x, y, 4))


# ---------------------------------------------------------------------------
# The JAX package's rule and fits
# ---------------------------------------------------------------------------
class _Mesh:
    def __init__(self, n):
        self.n_devices = n


_TRIGGERS = [None, "EveryEpoch", "MaxEpoch", "SeveralIteration",
             "MaxIteration"]


def _trigger(mod, name):
    if name is None:
        return None
    arg = {"EveryEpoch": (), "MaxEpoch": (2,), "SeveralIteration": (3,),
           "MaxIteration": (5,)}[name]
    return getattr(mod, name)(*arg)


@pytest.mark.parametrize("ckpt", _TRIGGERS)
@pytest.mark.parametrize("end", [None, "MaxIteration"])
def test_device_cache_eligible_is_the_jax_rule(ckpt, end):
    """Every flag, size, mesh and process case of the JAX function, with
    the port's triggers in place of the JAX ones."""
    small = (np.zeros((10, 4), np.float32), np.zeros(10, np.int32))
    big = (np.broadcast_to(np.zeros(1, np.float32), (70_000_000,)), None)
    for x, y in (small, big):
        for flag in (None, True, False):
            for mesh, n_proc in ((None, 1), (_Mesh(1), 1), (_Mesh(2), 1),
                                 (None, 2)):
                want = jtrainer._device_cache_eligible(
                    x, y, mesh, n_proc, flag, _trigger(jtg, ckpt),
                    _trigger(jtg, end))
                got = trainer._device_cache_eligible(
                    x, y, mesh, n_proc, flag, _trigger(tg, ckpt),
                    _trigger(tg, end))
                assert got == want, (x.shape, flag, mesh, n_proc)


def _pair(seed=0):
    """(port, jax) Dense(8, relu) → Dense(3, softmax), the same weights."""
    t = Sequential()
    t.add(L.Dense(8, activation="relu", input_shape=(6,), name="hid",
                  device="cpu"))
    t.add(L.Dense(3, activation="softmax", name="out", device="cpu"))
    t.compile("adam", "sparse_categorical_crossentropy")
    t.ensure_built(seed=seed)
    j = JSequential()
    j.add(JL.Dense(8, activation="relu", input_shape=(6,), name="hid"))
    j.add(JL.Dense(3, activation="softmax", name="out"))
    j.compile("adam", "sparse_categorical_crossentropy")
    j.params = convert.model_params_to_jax(
        t.state_dict(), [l.name for l in j._ordered_layers()], t)
    return t, j


@pytest.mark.parametrize("kw", [dict(steps_per_run=4, device_cache=False),
                                dict(device_cache=True, shuffle=False),
                                dict(device_cache=True, shuffle=False,
                                     steps_per_run=3)])
def test_programs_match_the_jax_fit(kw):
    """The JAX `fit_keras` with the same arguments (its k-step `lax.scan`
    run, or its device-resident epoch) against the port's programs: the
    losses of 3 epochs and the parameters within 1e-5."""
    x, y = _class_data(40, 5)
    t, j = _pair()
    th = trainer.fit_keras(t, x, y, batch_size=4, epochs=3, seed=1, **kw)
    jh = jtrainer.fit_keras(j, x, y, batch_size=4, epochs=3, seed=1,
                            distributed=False, prefetch=False, **kw)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=0, atol=CROSS_TOL)
    want = convert.model_params_to_jax(
        t.state_dict(), [l.name for l in j._ordered_layers()], t)
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(j.params)),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=CROSS_TOL)


# ---------------------------------------------------------------------------
# compile_cache_dir
# ---------------------------------------------------------------------------
def test_compile_cache_markers_are_found_by_a_fresh_cache(tmp_path):
    """A fit with `compile_cache_dir` writes one "train" record per
    program (one of 4 steps and its tail of 3); a fresh `CompileCache` over
    the directory lists them, and a fit of a fresh model reports every
    program "cached"; another `steps_per_run` keys other programs."""
    x, y = _class_data(44, 1)
    cc = str(tmp_path / "cc")
    m = _mlp()
    trainer.fit_keras(m, x, y, batch_size=4, steps_per_run=4,
                      compile_cache_dir=cc)
    assert [p["source"] for p in trainer.program_sources(m)] == \
        ["compiled", "compiled"]
    fresh = CompileCache(cc)
    kinds = [e["header"]["kind"] for e in fresh.index()]
    assert kinds.count("train") == 2
    m2 = _mlp(seed=5)
    trainer.fit_keras(m2, x, y, batch_size=4, steps_per_run=4,
                      compile_cache_dir=cc)
    assert [p["source"] for p in trainer.program_sources(m2)] == \
        ["cached", "cached"]
    m3 = _mlp()
    trainer.fit_keras(m3, x, y, batch_size=4, steps_per_run=5,
                      compile_cache_dir=cc)
    assert [p["source"] for p in trainer.program_sources(m3)] == \
        ["compiled", "compiled"]
    m4 = _mlp()
    trainer.fit_keras(m4, x, y, batch_size=4)
    assert {p["source"] for p in trainer.program_sources(m4)} == {"uncached"}
