"""The fused-Adam sweep as one multi-tensor launch: the leaf table the
wrapper builds (`kernels/fused_adam._build_table`), its checks, and the
CPU route of `fused_adam_step` over a mixed leaf set held against the JAX
package's `_fold_scalars` + `_adam_math` per leaf (its jnp path: the
Pallas kernel does not run in interpret mode on this jax).

Tolerances against the JAX package: f32 params rtol 1e-5 / atol 1e-6, the
f32 moments rtol 1e-5 (the same operations in the same order, in another
framework's kernels); bf16 params one bf16 ulp (rtol 2**-7, atol 0: both
compute in f32 and round once to bf16, so only an f32 result on either
side of a rounding boundary parts them). The learning rate, 5e-2, makes
three steps move a bf16 parameter of about 0.5 by many ulps, so a
parameter that was never written back cannot pass.
The CUDA kernel runs only on the card: the tests marked `gpu` hold it
against the plain version bit for bit and skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.pallas import fused_adam as jfa
from analytics_zoo_tpu_torch.kernels import LAUNCHES
from analytics_zoo_tpu_torch.kernels import fused_adam as fad

HP = dict(lr=5e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2)
BF16_ULP = dict(rtol=2.0 ** -7, atol=0.0)

# (shape, param dtype, grad dtype, channels_last): f32 and bf16 leaves,
# the four (p, g) dtype pairs, 4-d conv kernels channels_last, a 0-d leaf,
# an empty one, a leaf of more than one chunk and counts that are not
# multiples of 4 or 8
MIX = [((3, 5), torch.float32, torch.float32, False),
       ((16, 8, 3, 3), torch.float32, torch.float32, True),
       ((), torch.float32, torch.float32, False),
       ((0, 4), torch.float32, torch.float32, False),
       ((fad.CHUNK + 13,), torch.float32, torch.bfloat16, False),
       ((7, 3, 2, 2), torch.bfloat16, torch.bfloat16, True),
       ((37,), torch.bfloat16, torch.float32, False),
       ((64,), torch.bfloat16, torch.bfloat16, False)]


def _mix(device="cpu", seed=0, offset=0):
    """params, mu, nu and three steps of grads over MIX, from numpy;
    `offset` > 0 makes every 1-d leaf a view `offset` elements into a
    larger buffer (not 16-byte aligned)."""
    rs = np.random.RandomState(seed)

    def make(shape, dtype, cl, scale, positive=False):
        a = rs.randn(*shape) * scale
        a = np.array(a * a if positive else a, np.float32)
        t = torch.from_numpy(a).to(device=device, dtype=dtype)
        if cl:
            t = t.contiguous(memory_format=torch.channels_last)
        if offset and t.dim() == 1:
            base = torch.zeros(t.numel() + offset, dtype=dtype,
                               device=device)
            base[offset:] = t
            t = base[offset:]
        return t
    params, mu, nu = {}, {}, {}
    grads = [{} for _ in range(3)]
    for i, (shape, pdt, gdt, cl) in enumerate(MIX):
        k = f"leaf{i}"
        params[k] = make(shape, pdt, cl, 0.5)
        mu[k] = make(shape, torch.float32, cl, 1e-2)
        nu[k] = make(shape, torch.float32, cl, 3e-2, positive=True)
        for g in grads:
            g[k] = make(shape, gdt, cl, 1.0)
    return params, mu, nu, grads


def _lists(params, mu, nu, grads):
    names = list(params)
    return ([params[k] for k in names], [mu[k] for k in names],
            [nu[k] for k in names], [grads[k] for k in names])


# ---------------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------------
def test_table_on_a_leaf_mix():
    params, mu, nu, grads = _mix()
    ps, ms, vs, gs = _lists(params, mu, nu, grads[0])
    t = fad._build_table(ps, ms, vs, gs)
    rows = [i for i, p in enumerate(ps) if p.numel() > 0]
    assert rows == [0, 1, 2, 4, 5, 6, 7]          # the empty leaf skipped
    np.testing.assert_array_equal(
        t.ptrs, [[ps[i].data_ptr(), ms[i].data_ptr(), vs[i].data_ptr(),
                  gs[i].data_ptr()] for i in rows])
    np.testing.assert_array_equal(t.numel, [15, 16 * 8 * 9, 1,
                                            fad.CHUNK + 13, 7 * 3 * 4, 37,
                                            64])
    want_kind = []
    for i in rows:
        k = (fad.P_BF16 if ps[i].dtype == torch.bfloat16 else 0) | \
            (fad.G_BF16 if gs[i].dtype == torch.bfloat16 else 0)
        if all(x.data_ptr() % 16 == 0 for x in (ps[i], ms[i], vs[i], gs[i])):
            k |= fad.ALIGNED
        want_kind.append(k)
    assert t.kind.tolist() == want_kind
    assert t.kind.dtype == np.uint8 and t.ptrs.dtype == np.int64
    # one launch; the leaf of CHUNK + 13 elements owns two chunks
    assert len(t.launches) == 1
    lo, hi, start = t.launches[0]
    assert (lo, hi) == (0, 7) and start.dtype == np.int32
    assert start.tolist() == [0, 1, 2, 3, 5, 6, 7, 8]
    assert t.keep == [] and t.device == torch.device("cpu")
    assert fad.sweep_launches(ps) == 1


def test_alignment_flags_follow_every_pointer():
    """A leaf whose four pointers are 16-byte aligned is flagged; a view
    one element into a buffer, of any of the four, is not."""
    base = torch.zeros(1000)
    aligned = [torch.zeros(37) for _ in range(4)]
    assert all(t.data_ptr() % 16 == 0 for t in aligned)
    t = fad._build_table(*([x] for x in aligned))
    assert t.kind.tolist() == [fad.ALIGNED]
    for which in range(4):
        ts = [torch.zeros(37) for _ in range(4)]
        ts[which] = base[1 + 40 * which:38 + 40 * which]
        t = fad._build_table(*([x] for x in ts))
        assert t.kind.tolist() == [0], which


@pytest.mark.parametrize("n_leaves, cap, want", [
    (fad.MAX_LEAVES + 5, fad.MAX_LEAVES, 2),
    (2 * fad.MAX_LEAVES, fad.MAX_LEAVES, 2),
    (10, 3, 4),
    (10, 1, 10)])
def test_more_leaves_than_a_launch_split_into_launches(n_leaves, cap, want):
    """`n_leaves` leaves that hold elements, with empty ones between them:
    the table keeps the first, and a plan of at most `cap` leaves a launch
    (the wrapper's is `MAX_LEAVES`) takes `want` launches."""
    rs = np.random.RandomState(n_leaves)
    kept = rs.randint(1, 3 * fad.CHUNK, size=n_leaves)
    sizes = np.insert(kept, np.arange(0, n_leaves, 7), 0)   # empty leaves
    ps = [torch.zeros(int(n)) for n in sizes]
    ms = [torch.zeros(int(n)) for n in sizes]
    vs = [torch.zeros(int(n)) for n in sizes]
    gs = [torch.zeros(int(n)) for n in sizes]
    t = fad._build_table(ps, ms, vs, gs)
    np.testing.assert_array_equal(t.numel, kept)
    assert len(t.launches) == fad.sweep_launches(ps) == \
        -(-n_leaves // fad.MAX_LEAVES)
    plan = fad._launch_plan(t.numel, cap)
    if cap == fad.MAX_LEAVES:
        assert len(plan) == len(t.launches) and all(
            (a[0], a[1]) == (b[0], b[1]) and np.array_equal(a[2], b[2])
            for a, b in zip(plan, t.launches))
    assert len(plan) == want
    assert [hi - lo for lo, hi, _ in plan][:-1] == [cap] * (want - 1)
    assert plan[-1][1] == n_leaves
    for lo, hi, start in plan:
        chunks = -(-kept[lo:hi] // fad.CHUNK)
        assert start.tolist() == [0] + np.cumsum(chunks).tolist()
    assert all(k == fad.ALIGNED for k in t.kind.tolist())


def test_table_refuses_what_the_kernel_does_not_take():
    p = torch.zeros(4, 6)
    z = torch.zeros_like
    with pytest.raises(ValueError, match="contiguous"):    # strided view
        fad._build_table([p[:, ::2]], [z(p[:, ::2])], [z(p[:, ::2])],
                         [z(p[:, ::2])])
    with pytest.raises(TypeError, match="float32"):
        fad._build_table([p], [z(p).bfloat16()], [z(p)], [z(p)])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fad._build_table([p.double()], [z(p)], [z(p)], [z(p)])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fad._build_table([p], [z(p)], [z(p)], [z(p).half()])
    with pytest.raises(ValueError, match="match"):
        fad._build_table([p], [z(p)], [z(p)], [torch.zeros(6, 4)])
    with pytest.raises(ValueError, match="share memory"):  # a tied leaf
        fad._build_table([p, p], [z(p), z(p)], [z(p), z(p)], [z(p), z(p)])
    m = torch.zeros(2, 4, 6)
    with pytest.raises(ValueError, match="share memory"):  # moments overlap
        fad._build_table([p, z(p)], [m[0], m[1]], [z(p), m[0]],
                         [z(p), z(p)])
    meta = torch.empty(4, 6, device="meta")
    with pytest.raises(ValueError, match="one device"):
        fad._build_table([p], [z(p)], [meta], [z(p)])
    with pytest.raises(ValueError, match="match"):
        fad._build_table([p], [z(p)], [z(p)], [meta])
    with pytest.raises(ValueError, match="one device"):
        fad.fused_adam_step({"w": p}, {"w": z(p)}, {"w": z(p)},
                            {"w": meta}, 1, lr=1e-3)
    for cap in (0, fad.MAX_LEAVES + 1):
        with pytest.raises(ValueError, match="max_leaves"):
            fad._launch_plan(np.array([4]), cap)


def test_a_gradient_in_another_layout_is_copied_and_counted():
    p = torch.randn(8, 4, 3, 3).contiguous(memory_format=torch.channels_last)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    g = torch.randn(8, 4, 3, 3)                       # default format
    before = fad.GRAD_COPIES.get(fad.KERNEL_NAME)
    t = fad._build_table([p], [m], [v], [g])
    assert fad.GRAD_COPIES.get(fad.KERNEL_NAME) == before + 1
    (copy,) = t.keep
    assert copy.stride() == p.stride() and torch.equal(copy, g)
    assert t.ptrs[0, 3] == copy.data_ptr() != g.data_ptr()
    gl = g.contiguous(memory_format=torch.channels_last)
    t = fad._build_table([p], [m], [v], [gl])
    assert t.keep == [] and t.ptrs[0, 3] == gl.data_ptr()
    assert fad.GRAD_COPIES.get(fad.KERNEL_NAME) == before + 1


def test_checked_leaves_are_remembered_by_identity_and_address():
    ps = [torch.zeros(5), torch.zeros(3, 3)]
    ms = [torch.zeros_like(p) for p in ps]
    vs = [torch.zeros_like(p) for p in ps]
    gs = [torch.zeros_like(p) for p in ps]
    first = fad._state_for(ps, ms, vs)
    assert fad._state_for(ps, ms, vs) is first
    ps[0].set_(torch.zeros(5))              # new storage, same tensor
    again = fad._state_for(ps, ms, vs)
    assert again is not first
    t = fad._build_table(ps, ms, vs, gs)
    assert t.ptrs[0, 0] == ps[0].data_ptr()
    ps[1] = torch.zeros(3, 3)               # a new tensor object
    assert fad._state_for(ps, ms, vs) is not again
    # a gradient is checked on every call, the remembered leaves or not
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fad._build_table(ps, ms, vs, [gs[0], gs[1].half()])


def test_a_leaf_changed_in_place_at_the_same_address_is_checked_again():
    """A remembered leaf that keeps its identity and address but changes
    its size, strides or dtype in place is checked and tabled anew."""
    ps = [torch.zeros(6), torch.zeros(4, 6)]
    ms = [torch.zeros_like(p) for p in ps]
    vs = [torch.zeros_like(p) for p in ps]
    first = fad._build_table(ps, ms, vs, [torch.zeros_like(p) for p in ps])
    assert first.numel.tolist() == [6, 24]
    for t in (ps[0], ms[0], vs[0]):         # the same storage, 2 elements
        addr = t.data_ptr()
        t.set_(t.untyped_storage(), 0, (2,))
        assert t.data_ptr() == addr
    t = fad._build_table(ps, ms, vs, [torch.zeros_like(p) for p in ps])
    assert t.numel.tolist() == [2, 24]
    ps[1].set_(ps[1].untyped_storage(), 0, (4, 6), (1, 4))  # transposed
    with pytest.raises(ValueError, match="contiguous"):
        fad._build_table(ps, ms, vs, [torch.zeros(6), torch.zeros(4, 6)])
    ps[1].set_(ps[1].untyped_storage(), 0, (4, 6), (6, 1))
    fad._build_table(ps, ms, vs, [torch.zeros(2), torch.zeros(4, 6)])
    addr = ps[1].data_ptr()
    ps[1].data = ps[1].data.view(torch.int32)   # the same bytes, int32
    assert ps[1].data_ptr() == addr
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fad._build_table(ps, ms, vs, [torch.zeros(2), torch.zeros(4, 6)])


def test_update_cost_counts_each_gradient_in_its_dtype():
    """Bytes a sweep: g in its own dtype, p read and written in its
    dtype, m and v f32 (the JAX package's count where g is f32)."""
    params = {"a": torch.zeros(10, dtype=torch.bfloat16),
              "b": torch.zeros(3, 4)}
    grads = {"a": torch.zeros(10, dtype=torch.bfloat16),
             "b": torch.zeros(3, 4, dtype=torch.bfloat16)}
    assert fad.update_cost(params) == (12.0 * 22, 10 * (4 + 4 + 16)
                                       + 12 * (4 + 8 + 16))
    assert fad.update_cost(params, grads) == (12.0 * 22, 10 * (2 + 4 + 16)
                                              + 12 * (2 + 8 + 16))


# ---------------------------------------------------------------------------
# the CPU route against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("offset", [0, 1])
def test_cpu_route_matches_the_jax_package_on_a_leaf_mix(offset):
    """3 steps of `fused_adam_step` on the CPU over MIX (views at an odd
    offset with `offset` 1) against `_fold_scalars` + `_adam_math` of the
    JAX package per leaf; in place, no launch."""
    params, mu, nu, grads = _mix(offset=offset)
    # copies: on the CPU jnp.asarray may share a numpy array's memory, which
    # the port's step then writes in place
    jp = {k: jnp.asarray(np.array(v.float().numpy()),
                         jnp.bfloat16 if v.dtype == torch.bfloat16
                         else jnp.float32) for k, v in params.items()}
    jm = {k: jnp.asarray(np.array(v.numpy())) for k, v in mu.items()}
    jn = {k: jnp.asarray(np.array(v.numpy())) for k, v in nu.items()}
    ids = [{k: t.data_ptr() for k, t in d.items()} for d in (params, mu, nu)]
    before = LAUNCHES.snapshot()
    for step, g in enumerate(grads):
        fad.fused_adam_step(params, mu, nu, g, step + 1, **HP)
        a, b, lrwd = jfa._fold_scalars(step + 1, HP["lr"], HP["b1"],
                                       HP["b2"], HP["eps"],
                                       HP["weight_decay"])
        for k in jp:
            gk = jnp.asarray(g[k].float().numpy())
            pn, jm[k], jn[k] = jfa._adam_math(jp[k].astype(jnp.float32),
                                              jm[k], jn[k], gk, a, b, lrwd,
                                              HP["b1"], HP["b2"])
            jp[k] = pn.astype(jp[k].dtype)
    assert LAUNCHES.snapshot() == before
    assert [{k: t.data_ptr() for k, t in d.items()}
            for d in (params, mu, nu)] == ids
    for k, p in params.items():
        tol = dict(rtol=1e-5, atol=1e-6) if p.dtype == torch.float32 \
            else BF16_ULP
        np.testing.assert_allclose(p.float().numpy(),
                                   np.asarray(jp[k].astype(jnp.float32)),
                                   **tol)
        np.testing.assert_allclose(mu[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(nu[k].numpy(), np.asarray(jn[k]),
                                   rtol=1e-5, atol=1e-9)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


def _plain_steps(params, mu, nu, grads):
    """The plain version's 3 steps on copies, leaf by leaf."""
    P = {k: t.clone() for k, t in params.items()}
    M = {k: t.clone() for k, t in mu.items()}
    V = {k: t.clone() for k, t in nu.items()}
    for step, g in enumerate(grads):
        sc = fad._fold_scalars(step + 1, HP["lr"], HP["b1"], HP["b2"],
                               HP["eps"], HP["weight_decay"])
        for k in P:
            pn, mn, vn = fad._adam_math(P[k].float(), M[k], V[k],
                                        g[k].float(), *sc, HP["b1"],
                                        HP["b2"])
            P[k].copy_(pn)
            M[k].copy_(mn)
            V[k].copy_(vn)
    return P, M, V


def _assert_bitwise(got, want):
    for a, b in zip(got, want):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def _capped_step(params, mu, nu, grads, count, max_leaves):
    """One step of the kernel at most `max_leaves` leaves a launch."""
    table = fad._build_table(*(list(d.values())
                               for d in (params, mu, nu, grads)))
    table = table._replace(launches=fad._launch_plan(table.numel,
                                                     max_leaves))
    fad._launch(table, fad._fold_scalars(count, HP["lr"], HP["b1"],
                                         HP["b2"], HP["eps"],
                                         HP["weight_decay"]),
                HP["b1"], HP["b2"])
    return len(table.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("max_leaves", [fad.MAX_LEAVES, 1])
def test_multi_tensor_launch_matches_plain_on_gpu(offset, max_leaves):
    """MIX on the card (the four (p, g) dtype pairs in one launch, ragged
    counts, a 0-d and an empty leaf, channels_last leaves, views one
    element off alignment with `offset` 1): 3 steps bit for bit against
    the plain version, in place, ⌈leaves / max_leaves⌉ launches a step
    (`fused_adam_step` at `MAX_LEAVES`)."""
    _need_gpu()
    params, mu, nu, grads = _mix("cuda", offset=offset)
    want = _plain_steps(params, mu, nu, grads)
    ids = [{k: t.data_ptr() for k, t in d.items()} for d in (params, mu, nu)]
    before = LAUNCHES.get(fad.KERNEL_NAME)
    for step, g in enumerate(grads):
        if max_leaves == fad.MAX_LEAVES:
            fad.fused_adam_step(params, mu, nu, g, step + 1, **HP)
        else:
            _capped_step(params, mu, nu, g, step + 1, max_leaves)
    torch.cuda.synchronize()
    rows = sum(1 for p in params.values() if p.numel() > 0)
    assert LAUNCHES.get(fad.KERNEL_NAME) - before == \
        3 * -(-rows // max_leaves)
    _assert_bitwise((params, mu, nu), want)
    assert [{k: t.data_ptr() for k, t in d.items()}
            for d in (params, mu, nu)] == ids


@pytest.mark.gpu
def test_more_leaves_than_a_launch_on_gpu():
    _need_gpu()
    rs = np.random.RandomState(3)
    sizes = rs.randint(1, 3000, size=fad.MAX_LEAVES + 9)
    params = {i: torch.from_numpy(rs.randn(int(n)).astype(np.float32)).cuda()
              for i, n in enumerate(sizes)}
    mu = {i: torch.randn_like(p) * 1e-2 for i, p in params.items()}
    nu = {i: torch.rand_like(p) * 1e-3 for i, p in params.items()}
    grads = [{i: torch.randn_like(p) for i, p in params.items()}
             for _ in range(3)]
    want = _plain_steps(params, mu, nu, grads)
    before = LAUNCHES.get(fad.KERNEL_NAME)
    for step, g in enumerate(grads):
        fad.fused_adam_step(params, mu, nu, g, step + 1, **HP)
    torch.cuda.synchronize()
    assert LAUNCHES.get(fad.KERNEL_NAME) - before == 3 * 2
    _assert_bitwise((params, mu, nu), want)


@pytest.mark.gpu
def test_a_bad_table_raises_on_gpu():
    """The source refuses a table that breaks its rules: the launch raises,
    nothing falls back."""
    _need_gpu()
    p = torch.zeros(100, device="cuda")
    t = fad._build_table([p], [torch.zeros_like(p)], [torch.zeros_like(p)],
                         [torch.zeros_like(p)])
    bad = t._replace(numel=t.numel * 0 + 2 * fad.CHUNK)   # chunk count off
    before = LAUNCHES.get(fad.KERNEL_NAME)
    with pytest.raises(RuntimeError, match="launch failed"):
        fad._launch(bad, (1e-3, 1e-8, 0.0), 0.9, 0.999)
    assert LAUNCHES.get(fad.KERNEL_NAME) == before
    cfg = fad.launch_config()
    assert (cfg["chunk"], cfg["max_leaves"]) == (fad.CHUNK, fad.MAX_LEAVES)
    assert cfg["sms"] > 0 and cfg["blocks_per_sm"] > 0
