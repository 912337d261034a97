"""The port's decode attention (`kernels/decode_attention.py`, rows 8-9 of
the kernel table) held against the JAX package on the CPU.

Off the TPU, the JAX `decode_attention` and `paged_decode_attention` take
their exact jnp paths (`_reference_decode_attention`,
`_reference_paged_decode_attention`); those are the oracles. Their Pallas
bodies cannot run here in interpret mode (the installed jax refuses their
`pl.CostEstimate`, ROADMAP.md queue 3).

Tolerances: the port's plain versions against the JAX exact paths at 1e-6
absolute (the same f32 operations, summed by another library); the paged
plain version against the contiguous one within the port, bitwise (both
run `_attend_window` on identically laid-out windows). The CUDA kernels
have no CPU mode: their checks are marked `gpu` and skip here.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.pallas import decode_attention as jda
from analytics_zoo_tpu_torch.kernels import LAUNCHES, _build
from analytics_zoo_tpu_torch.kernels import decode_attention as da

REPO = Path(__file__).resolve().parent.parent
BL = 8          # block_len, as tests/test_paged_decode.py uses
TOL = 1e-6


def _inputs(S=4, H=2, L=32, D=8, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.standard_normal((S, H, D)).astype(np.float32)
    k = rs.standard_normal((S, H, L, D)).astype(np.float32)
    v = rs.standard_normal((S, H, L, D)).astype(np.float32)
    return q, k, v


def _scattered(kc, vc, n_kb, seed=7):
    """The contiguous pools' bytes re-homed into a shuffled block pool and
    tables: the same values at other addresses (tests/test_paged_decode.py
    `_scattered`)."""
    S, H, _, D = kc.shape
    num_blocks = S * n_kb + 2
    perm = np.random.RandomState(seed).permutation(
        np.arange(1, num_blocks))[:S * n_kb].reshape(S, n_kb)
    kp = np.zeros((num_blocks, H, BL, D), np.float32)
    vp = np.zeros((num_blocks, H, BL, D), np.float32)
    for s in range(S):
        for j in range(n_kb):
            kp[perm[s, j]] = kc[s, :, j * BL:(j + 1) * BL]
            vp[perm[s, j]] = vc[s, :, j * BL:(j + 1) * BL]
    return kp, vp, perm.astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("kv_bucket", [8, 16, 32])
@pytest.mark.parametrize("lengths", [[5, 17, 32, 1], [1, 1, 1, 1],
                                     [32, 32, 32, 32], [3, 9, 8, 30]])
def test_decode_attention_matches_jax(kv_bucket, lengths):
    q, k, v = _inputs()
    n = np.asarray(lengths, np.int32)
    want = np.asarray(jda.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(n),
        kv_bucket))
    got = da.decode_attention(_t(q), _t(k), _t(v), _t(n), kv_bucket)
    assert got.shape == (4, 2, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("kv_bucket", [8, 24, 32])
def test_paged_decode_attention_matches_jax(kv_bucket):
    q, kc, vc = _inputs(seed=1)
    n = np.asarray([5, 17, 32, 1], np.int32)
    kp, vp, tables = _scattered(kc, vc, 32 // BL)
    want = np.asarray(jda.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(n), kv_bucket))
    got = da.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                    _t(n), kv_bucket)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_gather_kv_window_matches_jax():
    _, kc, _ = _inputs(seed=2)
    kp, _, tables = _scattered(kc, kc, 4)
    want = np.asarray(jda.gather_kv_window(jnp.asarray(kp),
                                           jnp.asarray(tables), 24))
    got = da.gather_kv_window(_t(kp), _t(tables), 24)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), kc[:, :, :24])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_bucket", [16, 32])
def test_paged_is_bitwise_contiguous(dtype, kv_bucket):
    """Scattered blocks holding the contiguous pools' bytes give the same
    bits as the contiguous path (`test_paged_decode.py:210` pins this in
    the JAX package)."""
    q, kc, vc = _inputs(seed=3)
    kp, vp, tables = _scattered(kc, vc, 32 // BL)
    n = _t(np.asarray([5, 17, 32, 1], np.int32))
    q, kc, vc, kp, vp = (_t(a).to(dtype) for a in (q, kc, vc, kp, vp))
    ref = da.decode_attention(q, kc, vc, n, kv_bucket)
    pag = da.paged_decode_attention(q, kp, vp, _t(tables), n, kv_bucket)
    assert pag.dtype == dtype
    assert torch.equal(ref, pag)


def test_bf16_rounds_weights_to_the_pool_dtype():
    """bf16 inputs: the output is bf16 and close to the f32 result."""
    q, k, v = _inputs(seed=4)
    n = _t(np.asarray([5, 17, 32, 1], np.int32))
    f32 = da.decode_attention(_t(q), _t(k), _t(v), n, 32)
    b16 = da.decode_attention(*(_t(a).to(torch.bfloat16) for a in (q, k, v)),
                              n, 32)
    assert b16.dtype == torch.bfloat16
    assert (b16.float() - f32).abs().max().item() < 5e-2


@pytest.mark.parametrize("bad_bucket", [12, 0])
def test_paged_rejects_bad_bucket(bad_bucket):
    """The cases of `test_paged_decode.py:226`: not a multiple of
    block_len, or zero."""
    q = torch.zeros((2, 2, 8))
    pool = torch.zeros((4, 2, BL, 8))
    tables = torch.zeros((2, 2), dtype=torch.int32)
    lengths = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        da.paged_decode_attention(q, pool, pool, tables, lengths, bad_bucket)


def test_paged_rejects_short_table():
    q = torch.zeros((2, 2, 8))
    pool = torch.zeros((4, 2, BL, 8))
    tables = torch.zeros((2, 2), dtype=torch.int32)
    lengths = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        da.paged_decode_attention(q, pool, pool, tables, lengths, 32)


@pytest.mark.parametrize("bad_bucket", [0, 33])
def test_contiguous_rejects_bucket_outside_pool(bad_bucket):
    q, k, v = _inputs()
    lengths = torch.ones(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        da.decode_attention(_t(q), _t(k), _t(v), lengths, bad_bucket)


@pytest.mark.parametrize("kv_bucket", [16, 128, 192, 200, 256])
def test_any_bucket_in_the_pool_matches_jax(kv_bucket):
    """Every bucket in [1, L] is served, the ones the JAX wrapper's 128-key
    tiling does not divide (192, 200: its exact path, L172-177) too."""
    q, k, v = _inputs(L=256, seed=6)
    n = np.asarray([kv_bucket, 1, 150, 255], np.int32)
    want = np.asarray(jda.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(n),
        kv_bucket))
    got = da.decode_attention(_t(q), _t(k), _t(v), _t(n), kv_bucket)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_cpu_route_launches_nothing():
    q, k, v = _inputs()
    n = _t(np.asarray([5, 17, 32, 1], np.int32))
    kp, vp, tables = _scattered(k, v, 32 // BL)
    before = LAUNCHES.snapshot()
    da.decode_attention(_t(q), _t(k), _t(v), n, 32)
    da.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tables), n, 32)
    assert LAUNCHES.snapshot() == before


def test_int64_lengths_and_tables_are_accepted():
    q, k, v = _inputs()
    n32 = np.asarray([5, 17, 32, 1], np.int32)
    kp, vp, tables = _scattered(k, v, 32 // BL)
    a = da.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                  _t(n32), 32)
    b = da.paged_decode_attention(_t(q), _t(kp), _t(vp),
                                  _t(tables.astype(np.int64)),
                                  _t(n32.astype(np.int64)), 32)
    assert torch.equal(a, b)


@pytest.mark.parametrize("case, exc", [
    ("q_rank", ValueError), ("dtype", TypeError), ("head_dim", ValueError),
    ("pool_shape", ValueError), ("lengths", ValueError)])
def test_kernel_input_checks(case, exc):
    """The launch path's checks run before any build (they raise here,
    where there is no nvcc)."""
    q = torch.zeros((2, 2, 8))
    k = torch.zeros((2, 2, 16, 8))
    n = torch.ones(2, dtype=torch.int32)
    if case == "q_rank":
        q = q[None]
    elif case == "dtype":
        q, k = q.half(), k.half()
    elif case == "head_dim":
        q, k = torch.zeros((2, 2, 160)), torch.zeros((2, 2, 16, 160))
    elif case == "pool_shape":
        k = torch.zeros((2, 3, 16, 8))
    elif case == "lengths":
        n = torch.ones(3, dtype=torch.int32)
    with pytest.raises(exc):
        da._launch(q, k, k, n, 16)


def test_source_is_hand_written_cuda_for_both_rows():
    """One source holds both kernels, with a plain C entry point each, and
    names the TPU kernels it replaces."""
    text = (_build.CSRC_DIR / da.SOURCE).read_text()
    for symbol in ("azt_decode_attention", "azt_paged_decode_attention",
                   "_decode_kernel", "_paged_kernel", "__global__"):
        assert symbol in text
    for banned in ("scaled_dot_product_attention", "cudnn", "cutlass"):
        assert banned not in text.lower()


def test_new_modules_never_import_jax():
    """A static scan of this slice's modules (the package-wide scan is in
    test_torch_flash_attention.py)."""
    port = REPO / "analytics_zoo_tpu_torch"
    files = [port / "kernels/decode_attention.py",
             port / "models/generative.py", port / "serving/decode.py",
             port / "serving/paged_kv.py", port / "serving/broker.py",
             port / "serving/breaker.py", port / "serving/client.py",
             port / "serving/elastic.py", port / "serving/partitions.py",
             port / "serving/pre_post.py", port / "common/faults.py",
             port / "observability/registry.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [(path.name, n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib",
                                           "analytics_zoo_tpu")]
    assert bad == []


class TestKernelsOnGPU:
    """The CUDA kernels against their plain versions, on the card."""

    @pytest.mark.gpu
    @pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                            (torch.bfloat16, 2e-2)])
    @pytest.mark.parametrize("D", [64, 8, 30, 128])
    def test_kernels_match_plain_and_paged_is_bitwise(self, dtype, tol, D):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU "
                        "mode)")
        torch.backends.cuda.matmul.allow_tf32 = False
        q, kc, vc = _inputs(S=4, H=3, L=64, D=D, seed=5)
        kp, vp, tables = _scattered(kc, vc, 64 // BL)
        n = _t(np.asarray([5, 64, 33, 1], np.int32)).cuda()
        q, kc, vc, kp, vp = (_t(a).cuda().to(dtype)
                             for a in (q, kc, vc, kp, vp))
        tables = _t(tables).cuda()
        before = LAUNCHES.snapshot()
        out = da.decode_attention(q, kc, vc, n, 64)
        pag = da.paged_decode_attention(q, kp, vp, tables, n, 64)
        torch.cuda.synchronize()
        after = LAUNCHES.snapshot()
        for name in (da.KERNEL_NAME, da.PAGED_NAME):
            assert after.get(name, 0) == before.get(name, 0) + 1
        ref = da._reference_decode_attention(q, kc, vc, n, 64)
        assert (out.float() - ref.float()).abs().max().item() <= tol
        assert torch.equal(out, pag)

    @pytest.mark.gpu
    @pytest.mark.parametrize("kv_bucket", [192, 200])
    def test_buckets_128_does_not_divide_launch(self, kv_bucket):
        """A CUDA tensor launches the kernel at every bucket in [1, L]."""
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU "
                        "mode)")
        q, k, v = (_t(a).cuda() for a in _inputs(L=256, D=64, seed=8))
        n = _t(np.asarray([kv_bucket, 1, 150, 255], np.int32)).cuda()
        before = LAUNCHES.get(da.KERNEL_NAME)
        out = da.decode_attention(q, k, v, n, kv_bucket)
        assert LAUNCHES.get(da.KERNEL_NAME) == before + 1
        ref = da._reference_decode_attention(q, k, v, n, kv_bucket)
        assert (out - ref).abs().max().item() <= 1e-5
