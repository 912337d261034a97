"""Shared fixtures of the Cluster Serving port tests
(`test_torch_serving_transports.py`, `test_torch_cluster_serving.py`,
`test_torch_cluster_serving_fleet.py`, `test_torch_cluster_serving_bert.py`).

`IMPLS` holds one namespace per package: the serving modules, and model
constructors that compute the same function in both (`linear` is ``x @ W``
from a seeded W; `fn_model` wraps an elementwise function), each on the
CPU. The `m` fixture parametrises a test over both packages, so a copy
that drifted from its source shows as a case that passes on one and
fails on the other. `no_stray_threads` is autouse in every module that
imports it: no non-daemon thread may outlive a test.
"""

import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from analytics_zoo_tpu.common import faults as jfaults
from analytics_zoo_tpu.observability import registry as jregistry
from analytics_zoo_tpu.observability import slo as jslo
from analytics_zoo_tpu.observability import tracing as jtracing
from analytics_zoo_tpu.serving import broker as jbroker
from analytics_zoo_tpu.serving import client as jclient
from analytics_zoo_tpu.serving import elastic as jelastic
from analytics_zoo_tpu.serving import inference_model as jim
from analytics_zoo_tpu.serving import partitions as jpartitions
from analytics_zoo_tpu.serving import pre_post as jpre_post
from analytics_zoo_tpu.serving import redis_server as jredis_server
from analytics_zoo_tpu.serving import server as jserver
from analytics_zoo_tpu.serving import supervisor as jsupervisor
from analytics_zoo_tpu_torch.common import faults as tfaults
from analytics_zoo_tpu_torch.observability import registry as tregistry
from analytics_zoo_tpu_torch.observability import slo as tslo
from analytics_zoo_tpu_torch.observability import tracing as ttracing
from analytics_zoo_tpu_torch.serving import broker as tbroker
from analytics_zoo_tpu_torch.serving import client as tclient
from analytics_zoo_tpu_torch.serving import elastic as telastic
from analytics_zoo_tpu_torch.serving import inference_model as tim
from analytics_zoo_tpu_torch.serving import partitions as tpartitions
from analytics_zoo_tpu_torch.serving import pre_post as tpre_post
from analytics_zoo_tpu_torch.serving import redis_server as tredis_server
from analytics_zoo_tpu_torch.serving import server as tserver
from analytics_zoo_tpu_torch.serving import supervisor as tsupervisor

STREAM = "serving_stream"
RESULT_KEY = f"result:{STREAM}"


def weights(in_dim=4, out_dim=3, seed=0):
    return np.random.RandomState(seed).randn(in_dim, out_dim).astype(
        np.float32)


def _jax_im(replicas):
    if replicas == 1:
        return jim.InferenceModel()
    return jim.InferenceModel(num_replicas=replicas,
                              devices=jax.devices()[:replicas])


def _port_im(replicas):
    if replicas == 1:
        return tim.InferenceModel(device="cpu")
    return tim.InferenceModel(num_replicas=replicas,
                              devices=["cpu"] * replicas)


def _jax_linear(in_dim=4, out_dim=3, seed=0, replicas=1):
    W = weights(in_dim, out_dim, seed)
    return W, _jax_im(replicas).load_fn(lambda p, x: x @ p, jnp.asarray(W))


class _Matmul(nn.Module):
    def __init__(self, W):
        super().__init__()
        self.register_buffer("w", torch.from_numpy(W))

    def forward(self, x):
        return x @ self.w


def _port_linear(in_dim=4, out_dim=3, seed=0, replicas=1):
    W = weights(in_dim, out_dim, seed)
    return W, _port_im(replicas).load_torch(_Matmul(W))


# elementwise models, the same function in both packages
FNS = {"double": (lambda x: x * 2.0, lambda x: x * 2.0),
       "identity": (lambda x: x, lambda x: x),
       "sum": (lambda x: x.sum(axis=-1, keepdims=True),
               lambda x: x.sum(dim=-1, keepdim=True))}


def _jax_fn_model(kind, replicas=1):
    f = FNS[kind][0]
    return _jax_im(replicas).load_fn(lambda p, x: f(x), params=())


def _port_fn_model(kind, replicas=1):
    f = FNS[kind][1]
    return _port_im(replicas).load_fn(lambda p, x: f(x), nn.Module())


def _ns(name, **mods):
    return SimpleNamespace(name=name, **mods)


IMPLS = {
    "jax": _ns("jax", faults=jfaults, registry=jregistry, slo=jslo,
               tracing=jtracing, broker=jbroker, client=jclient,
               elastic=jelastic, inference_model=jim, partitions=jpartitions,
               pre_post=jpre_post, redis_server=jredis_server,
               server=jserver, supervisor=jsupervisor,
               linear=_jax_linear, fn_model=_jax_fn_model,
               log_root="analytics_zoo_tpu"),
    "port": _ns("port", faults=tfaults, registry=tregistry, slo=tslo,
                tracing=ttracing, broker=tbroker, client=tclient,
                elastic=telastic, inference_model=tim, partitions=tpartitions,
                pre_post=tpre_post, redis_server=tredis_server,
                server=tserver, supervisor=tsupervisor,
                linear=_port_linear, fn_model=_port_fn_model,
                log_root="analytics_zoo_tpu_torch"),
}


@pytest.fixture(params=sorted(IMPLS))
def m(request):
    return IMPLS[request.param]


@pytest.fixture(autouse=True)
def no_stray_threads():
    """No non-daemon thread that a test started may outlive it (a joined
    client thread ends within the grace window)."""
    before = {t.ident for t in threading.enumerate()}
    yield
    deadline = time.monotonic() + 5.0
    while True:
        stray = [t.name for t in threading.enumerate()
                 if not t.daemon and t.ident not in before and t.is_alive()]
        if not stray or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert not stray, f"non-daemon threads outlived the test: {stray}"


def wait_results(m, broker, uris, timeout_s=30.0, delete=False):
    """Poll the result hash every 10 ms until every uri has a result or
    the deadline passes; returns what landed."""
    out = m.client.OutputQueue(broker)
    results = {}
    deadline = time.monotonic() + timeout_s
    while len(results) < len(uris) and time.monotonic() < deadline:
        for u in uris:
            if u not in results:
                r = out.query(u, delete=delete)
                if r is not None:
                    results[u] = r
        if len(results) < len(uris):
            time.sleep(0.01)
    return results


def wait_for(pred, timeout_s=20.0, interval=0.02, msg="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")
