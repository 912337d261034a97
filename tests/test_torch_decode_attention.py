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
run `_attend_window` on identically laid-out windows). The split plan of
the kernels and a plain model of their split and fixed-order combine
(`_split_model`, here only) are checked on the CPU, the model against
`_attend_window` at 1e-6 in f32 (the same softmax, its sums taken per
span and merged). The CUDA kernels have no CPU mode: their checks are
marked `gpu` and skip here.
"""

import ast
import math
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
# the generative engine's kv-bucket ladder, and a bucket 128 does not divide
LADDER = (128, 256, 512, 1024)
SPLITS = (1, 2, 4, 8)


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


def _spans(n: int, n_split: int):
    """The kernel's split of a slot's live positions [0, n) over its
    cluster (csrc/decode_attention.cu): block r takes [r*c, min((r+1)*c,
    n)), with c the least multiple of 16 that is at least n / n_split."""
    c = 16 * -(-n // (16 * n_split))
    return [(min(r * c, n), min((r + 1) * c, n)) for r in range(n_split)]


def _split_model(q, k, v, lengths, kv_bucket: int, n_split: int):
    """A plain model of the kernels' split: block r of a (slot, head)'s
    cluster walks its span of the slot's live positions (`_spans`) in
    tiles of 64 with an online softmax (scores in f32, weights rounded to
    the pool's dtype before P·V), leaving (m, l, acc); the states merge in
    rank order. Windows q [S, H, D], k/v [S, H, kv_bucket, D]."""
    D = q.shape[-1]
    rows = []
    for s in range(q.shape[0]):
        n = min(int(lengths[s]), kv_bucket)
        states = []
        for lo, hi in _spans(n, n_split):
            m = torch.full(q.shape[1:2], -1e30)
            l = torch.zeros(q.shape[1:2])
            acc = torch.zeros(q.shape[1:])
            for t0 in range(lo, hi, da._TILE):
                pos = torch.arange(t0, min(t0 + da._TILE, hi))
                sc = torch.einsum("hd,htd->ht", q[s].float(),
                                  k[s][:, pos].float()) / math.sqrt(D)
                m_new = torch.maximum(m, sc.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(sc - m_new[:, None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[:, None] + torch.einsum(
                    "ht,htd->hd", p.to(v.dtype).float(),
                    v[s][:, pos].float())
                m = m_new
            states.append((m, l, acc))
        big = torch.stack([st[0] for st in states]).amax(0)
        total = torch.zeros(q.shape[1:2])
        o = torch.zeros(q.shape[1:])
        for m, l, acc in states:
            w = torch.exp(m - big)
            total = total + l * w
            o = o + acc * w[:, None]
        rows.append(o / total[:, None])
    return torch.stack(rows).to(q.dtype)


def _edge_lengths(kv_bucket: int, n_split: int):
    """1 (every block but the first empty), n_split spans of 16 exactly,
    one past them (spans of 32, the last block short or empty), and the
    whole bucket."""
    edge = 16 * n_split
    return [1, min(edge, kv_bucket), min(edge + 1, kv_bucket), kv_bucket]


@pytest.mark.parametrize("kv_bucket", LADDER + (192,))
@pytest.mark.parametrize("n_split", SPLITS)
def test_split_spans_cover_the_live_range(kv_bucket, n_split):
    """For every live length, the cluster's spans cover [0, n) exactly, in
    order, each starting at a multiple of 16 and none longer than the span
    the C entry point sizes a block's tiles and table for (that of a slot
    whose length is the whole bucket)."""
    longest = 16 * -(-kv_bucket // (16 * n_split))
    for n in range(1, kv_bucket + 1):
        spans = _spans(n, n_split)
        covered = [p for lo, hi in spans for p in range(lo, hi)]
        assert covered == list(range(n))
        assert all(lo % 16 == 0 and hi - lo <= longest for lo, hi in spans
                   if lo < hi)


def test_split_plan_keeps_a_walk_to_512_positions():
    """One block a (slot, head) up to kv 512 and two at 1024 on the
    engine's ladder; longer buckets split further, at most 8 ways."""
    assert [da._split_plan(kv) for kv in LADDER + (192,)] == [1, 1, 1, 2, 1]
    assert [da._split_plan(kv) for kv in (2048, 4096, 8192)] == [4, 8, 8]


@pytest.mark.parametrize("kv_bucket", LADDER + (192,))
@pytest.mark.parametrize("n_split", SPLITS)
def test_split_model_matches_attend_window(kv_bucket, n_split):
    """The kernel's split and its fixed-order combine at lengths on the
    spans' edges (`_edge_lengths`) agree with the plain version."""
    S, H, D = 4, 2, 8
    q, k, v = _inputs(S=S, H=H, L=kv_bucket, D=D, seed=11)
    n = _t(np.asarray(_edge_lengths(kv_bucket, n_split), np.int32))
    want = da._attend_window(_t(q), _t(k), _t(v), n, kv_bucket)
    got = _split_model(_t(q), _t(k), _t(v), n, kv_bucket, n_split)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)


def _graph_replay(fn):
    """fn's output from one capture and replay of a CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


class TestKernelsOnGPU:
    """The CUDA kernels against their plain versions, on the card."""

    @pytest.mark.gpu
    @pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                            (torch.bfloat16, 2e-2)])
    @pytest.mark.parametrize("D", [32, 64, 128, 30])
    @pytest.mark.parametrize("kv_bucket", [128, 512, 1024, 192])
    @pytest.mark.parametrize("n_split", [None, 2, 8])
    def test_split_kernel_at_span_edges(self, dtype, tol, D, kv_bucket,
                                        n_split, monkeypatch):
        """Lengths on the spans' edges (`_edge_lengths`), 4 slots x 3
        heads, at the wrapper's plan (None) and held to 2 and 8 splits: the
        kernel matches the plain version, paged equals contiguous bit for
        bit, two launches give the same bits, and a CUDA graph's replay
        the eager bits."""
        _need_gpu()
        torch.backends.cuda.matmul.allow_tf32 = False
        if n_split is None:
            n_split = da._split_plan(kv_bucket)
        else:
            monkeypatch.setattr(da, "_split_plan", lambda _kv: n_split)
        S, H = 4, 3
        q, kc, vc = _inputs(S=S, H=H, L=kv_bucket, D=D, seed=12)
        kp, vp, tables = _scattered(kc, vc, kv_bucket // BL)
        n = _t(np.asarray(_edge_lengths(kv_bucket, n_split),
                          np.int32)).cuda()
        q, kc, vc, kp, vp = (_t(a).cuda().to(dtype)
                             for a in (q, kc, vc, kp, vp))
        tables = _t(tables).cuda()

        def contiguous():
            return da.decode_attention(q, kc, vc, n, kv_bucket)

        def paged():
            return da.paged_decode_attention(q, kp, vp, tables, n, kv_bucket)

        out, pag = contiguous(), paged()
        again = contiguous()
        torch.cuda.synchronize()
        ref = da._reference_decode_attention(q, kc, vc, n, kv_bucket)
        assert (out.float() - ref.float()).abs().max().item() <= tol
        assert torch.equal(out, pag)
        assert torch.equal(out, again)
        assert torch.equal(_graph_replay(contiguous), out)
        assert torch.equal(_graph_replay(paged), pag)

    @pytest.mark.gpu
    @pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                            (torch.bfloat16, 2e-2)])
    @pytest.mark.parametrize("S, H", [(1, 1), (32, 12)])
    def test_one_and_full_slot_head_grid(self, dtype, tol, S, H):
        """S·H = 1 and the serving engine's 32 x 12 at kv 1024, ragged
        lengths, blocks of 16 as the engine lays them out."""
        _need_gpu()
        torch.backends.cuda.matmul.allow_tf32 = False
        L, D, bl = 1024, 64, 16
        gen = torch.Generator(device="cuda").manual_seed(13)
        q = torch.randn((S, H, D), device="cuda", generator=gen).to(dtype)
        kc, vc = (torch.randn((S, H, L, D), device="cuda",
                              generator=gen).to(dtype) for _ in range(2))
        n = torch.randint(1, L + 1, (S,), device="cuda", generator=gen,
                          dtype=torch.int32)
        perm = (torch.randperm(S * (L // bl), device="cuda", generator=gen)
                + 1).to(torch.int32).view(S, L // bl)
        kp, vp = (torch.zeros((S * (L // bl) + 1, H, bl, D), device="cuda",
                              dtype=dtype) for _ in range(2))
        for pool, src in ((kp, kc), (vp, vc)):
            pool[perm.reshape(-1).long()] = src.view(
                S, H, L // bl, bl, D).permute(0, 2, 1, 3, 4).reshape(
                    -1, H, bl, D)
        out = da.decode_attention(q, kc, vc, n, L)
        pag = da.paged_decode_attention(q, kp, vp, perm, n, L)
        torch.cuda.synchronize()
        ref = da._reference_decode_attention(q, kc, vc, n, L)
        assert (out.float() - ref.float()).abs().max().item() <= tol
        assert torch.equal(out, pag)

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
