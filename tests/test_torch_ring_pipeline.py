"""The port's ring attention and pipeline schedule
(`analytics_zoo_tpu_torch/parallel/{ring_attention,pipeline}.py`) held
against the JAX package's on the conftest's virtual devices, forward and
gradient (`test_parallel.py:129-242`), f32 at 1e-5 / 1e-4: each of 4 gloo
CPU ranks (one group, spawned once) holds its sequence block (a ring of
4 on `sequence`) or its stage (a pipeline of 4), and its results are the
JAX results' block. The ring runs both routes the port has: the JAX
body's plain einsum path (CPU tensors) and the flash-kernel composition
(`_ring_flash`: per-block O and lse merged, the backward with the ring's
final O and lse), whose flash wrappers take their plain versions here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common.config import MeshConfig
from analytics_zoo_tpu.common.mesh import DeviceMesh
from analytics_zoo_tpu.pallas.flash_attention import _reference_attention
from analytics_zoo_tpu.parallel.pipeline import pipeline_apply as jpipe
from analytics_zoo_tpu.parallel.pipeline import to_microbatches as jmb
from analytics_zoo_tpu.parallel.ring_attention import ring_attention as jring
from analytics_zoo_tpu_torch.common.config import MeshConfig as TMeshConfig
from analytics_zoo_tpu_torch.common.mesh import DeviceMesh as TDeviceMesh
from analytics_zoo_tpu_torch.parallel import pipeline as tpipe
from analytics_zoo_tpu_torch.parallel.ring_attention import ring_attention

from torch_dist_workers import pipeline_inputs, ring_inputs, start_group


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    return start_group("ring_pipeline_worker", 4,
                       str(tmp_path_factory.mktemp("ring")))


@pytest.fixture(scope="module")
def group(started, jax_ring):
    return started()


@pytest.fixture(scope="module")
def jax_ring(started):
    """The JAX ring on data=2 x sequence=4, and its gradients of
    sum(o ** 2), with and without the padding mask (while the ranks
    run)."""
    mesh = DeviceMesh(MeshConfig(data=2, sequence=4))
    q, k, v, mask = (jnp.asarray(a) for a in ring_inputs())
    out = {}
    fwd = jax.jit(lambda q, k, v, m: ring_attention_j(q, k, v, m, mesh))
    grad = jax.jit(jax.grad(
        lambda q, k, v, m: jnp.sum(ring_attention_j(q, k, v, m, mesh) ** 2),
        argnums=(0, 1, 2)))
    for name, m in (("nomask", None), ("mask", mask)):
        o = fwd(q, k, v, m)
        g = grad(q, k, v, m)
        ref = _reference_attention(
            q, k, v, None if m is None else m[:, None, None])
        out[name] = (np.asarray(o), [np.asarray(x) for x in g],
                     np.asarray(ref))
    return out


def ring_attention_j(q, k, v, m, mesh):
    return jring(q, k, v, m, mesh=mesh)


@pytest.mark.parametrize("impl", ["plain", "flash"])
@pytest.mark.parametrize("name", ["nomask", "mask"])
def test_ring_matches_jax_forward_and_grad(group, jax_ring, impl, name):
    o_j, g_j, ref = jax_ring[name]
    T = o_j.shape[2]
    for r, res in enumerate(group):
        sl = slice(r * T // 4, (r + 1) * T // 4)
        o, dq, dk, dv = (t.numpy() for t in res[f"{impl}_{name}"])
        np.testing.assert_allclose(o, o_j[:, :, sl], rtol=0, atol=1e-5)
        np.testing.assert_allclose(o, ref[:, :, sl], rtol=0, atol=1e-5)
        for got, want in zip((dq, dk, dv), g_j):
            np.testing.assert_allclose(got, want[:, :, sl], rtol=0,
                                       atol=1e-4)


def test_ring_refuses_a_tensor_axis(group):
    assert group[0]["tensor_axis"].startswith("NotImplementedError")
    assert "item 7b" in group[0]["tensor_axis"]


def test_ring_on_one_rank_is_the_flash_wrapper():
    """At a sequence axis of 1 the port calls the flash wrapper (its plain
    version on the CPU), where the JAX function calls
    `_reference_attention`: the same numbers."""
    q, k, v, mask = ring_inputs(T=16)
    mesh = TDeviceMesh(TMeshConfig())
    out = ring_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                         torch.from_numpy(mask), mesh=mesh)
    ref = _reference_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v),
                               jnp.asarray(mask)[:, None, None])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def _stage_fn(p, x):
    return jnp.tanh(x @ p["W"] + p["b"])


def test_pipeline_matches_jax_forward_and_grad(group):
    W, b, x = (jnp.asarray(a) for a in pipeline_inputs())
    mesh = DeviceMesh(MeshConfig(pipeline=4, data=2))
    mbs = jmb(x, 8)
    y = jax.jit(lambda W: jpipe(_stage_fn, {"W": W, "b": b}, mbs,
                                mesh))(W)
    y_flat = np.asarray(jnp.swapaxes(y, 0, 1).reshape(32, -1))
    g = np.asarray(jax.jit(jax.grad(lambda W: jnp.sum(jpipe(
        _stage_fn, {"W": W, "b": b}, mbs, mesh) ** 2)))(W))
    for res in group:
        np.testing.assert_allclose(res["pipe_y"].numpy(), y_flat, rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(res["pipe_gW"].numpy(), g, rtol=0,
                                   atol=1e-4)
    assert "ValueError" in group[0]["pipe_bad"]


def test_single_stage_fallback_and_microbatches():
    W, b, x = pipeline_inputs()
    mesh = TDeviceMesh(TMeshConfig())
    Wt, bt, xt = (torch.from_numpy(a) for a in (W, b, x))
    y = tpipe.from_microbatches(tpipe.pipeline_apply(
        lambda p, h: torch.tanh(h @ p["W"] + p["b"]), {"W": Wt, "b": bt},
        tpipe.to_microbatches(xt, 8), mesh))
    jm = DeviceMesh(MeshConfig(data=8))
    jy = jpipe(_stage_fn, {"W": jnp.asarray(W), "b": jnp.asarray(b)},
               jmb(jnp.asarray(x), 8), jm)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jnp.swapaxes(jy, 0, 1).reshape(32, -1)),
        atol=1e-6)
    with pytest.raises(ValueError):
        tpipe.to_microbatches(torch.zeros(10, 3), 4)
    xs = torch.arange(24).reshape(12, 2)
    assert torch.equal(tpipe.from_microbatches(
        tpipe.to_microbatches(xs, 4)), xs)
    np.testing.assert_array_equal(
        tpipe.to_microbatches(xs, 4).numpy(),
        np.asarray(jmb(jnp.asarray(xs.numpy()), 4)))
