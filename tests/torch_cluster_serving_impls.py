"""Shared fixtures of the Cluster Serving port tests
(`test_torch_serving_transports.py`, `test_torch_cluster_serving.py`,
`test_torch_cluster_serving_fleet.py`, `test_torch_cluster_serving_bert.py`,
`test_torch_fleet.py`, `test_torch_http_frontend.py`,
`test_torch_rollout.py`, `test_torch_serving_cli.py`).

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

from analytics_zoo_tpu import observability as jobservability
from analytics_zoo_tpu.common import faults as jfaults
from analytics_zoo_tpu.learn import checkpoint as jcheckpoint
from analytics_zoo_tpu.observability import memwatch as jmemwatch
from analytics_zoo_tpu.observability import registry as jregistry
from analytics_zoo_tpu.observability import slo as jslo
from analytics_zoo_tpu.observability import tracing as jtracing
from analytics_zoo_tpu.serving import broker as jbroker
from analytics_zoo_tpu.serving import cli as jcli
from analytics_zoo_tpu.serving import client as jclient
from analytics_zoo_tpu.serving import config as jconfig
from analytics_zoo_tpu.serving import elastic as jelastic
from analytics_zoo_tpu.serving import fleet as jfleet
from analytics_zoo_tpu.serving import fleet_metrics as jfleet_metrics
from analytics_zoo_tpu.serving import http_frontend as jhttp_frontend
from analytics_zoo_tpu.serving import inference_model as jim
from analytics_zoo_tpu.serving import partitions as jpartitions
from analytics_zoo_tpu.serving import pre_post as jpre_post
from analytics_zoo_tpu.serving import redis_server as jredis_server
from analytics_zoo_tpu.serving import rollout as jrollout
from analytics_zoo_tpu.serving import server as jserver
from analytics_zoo_tpu.serving import supervisor as jsupervisor
from analytics_zoo_tpu.serving import trace_plane as jtrace_plane
from analytics_zoo_tpu_torch import observability as tobservability
from analytics_zoo_tpu_torch.common import faults as tfaults
from analytics_zoo_tpu_torch.learn import checkpoint as tcheckpoint
from analytics_zoo_tpu_torch.observability import memwatch as tmemwatch
from analytics_zoo_tpu_torch.observability import registry as tregistry
from analytics_zoo_tpu_torch.observability import slo as tslo
from analytics_zoo_tpu_torch.observability import tracing as ttracing
from analytics_zoo_tpu_torch.serving import broker as tbroker
from analytics_zoo_tpu_torch.serving import cli as tcli
from analytics_zoo_tpu_torch.serving import client as tclient
from analytics_zoo_tpu_torch.serving import config as tconfig
from analytics_zoo_tpu_torch.serving import elastic as telastic
from analytics_zoo_tpu_torch.serving import fleet as tfleet
from analytics_zoo_tpu_torch.serving import fleet_metrics as tfleet_metrics
from analytics_zoo_tpu_torch.serving import http_frontend as thttp_frontend
from analytics_zoo_tpu_torch.serving import inference_model as tim
from analytics_zoo_tpu_torch.serving import partitions as tpartitions
from analytics_zoo_tpu_torch.serving import pre_post as tpre_post
from analytics_zoo_tpu_torch.serving import redis_server as tredis_server
from analytics_zoo_tpu_torch.serving import rollout as trollout
from analytics_zoo_tpu_torch.serving import server as tserver
from analytics_zoo_tpu_torch.serving import supervisor as tsupervisor
from analytics_zoo_tpu_torch.serving import trace_plane as ttrace_plane

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


def _jax_slow_double(delay_s=0.03):
    """x * 2 after `delay_s` of host time at RUN time (a bare sleep in a
    jitted function runs only while tracing)."""
    def _slow(a):
        time.sleep(delay_s)
        return np.asarray(a) * 2.0

    return _jax_im(1).load_fn(
        lambda p, x: jax.pure_callback(_slow, x, x), params=())


class _SlowDouble(nn.Module):
    def __init__(self, delay_s):
        super().__init__()
        self.delay_s = delay_s

    def forward(self, x):
        time.sleep(self.delay_s)
        return x * 2.0


def _port_slow_double(delay_s=0.03):
    return _port_im(1).load_torch(_SlowDouble(delay_s))


def _jax_scale(scale):
    """`x * w` with the scalar weight in a {"w": ...} tree: a model whose
    checkpoint tree is its state dict in both packages."""
    return _jax_im(1).load_fn(lambda p, x: x * p["w"],
                              {"w": np.asarray(scale, np.float32)})


class _Scale(nn.Module):
    def __init__(self, scale):
        super().__init__()
        self.register_buffer("w", torch.tensor(scale, dtype=torch.float32))

    def forward(self, x):
        return x * self.w


def _port_scale(scale):
    return _port_im(1).load_torch(_Scale(scale))


def _ns(name, **mods):
    return SimpleNamespace(name=name, **mods)


IMPLS = {
    "jax": _ns("jax", faults=jfaults, registry=jregistry, slo=jslo,
               tracing=jtracing, broker=jbroker, client=jclient,
               elastic=jelastic, inference_model=jim, partitions=jpartitions,
               pre_post=jpre_post, redis_server=jredis_server,
               server=jserver, supervisor=jsupervisor,
               linear=_jax_linear, fn_model=_jax_fn_model,
               observability=jobservability, checkpoint=jcheckpoint,
               memwatch=jmemwatch, cli=jcli, config=jconfig, fleet=jfleet,
               fleet_metrics=jfleet_metrics, http_frontend=jhttp_frontend,
               rollout=jrollout, trace_plane=jtrace_plane,
               slow_double=_jax_slow_double, scale_model=_jax_scale,
               package="analytics_zoo_tpu",
               log_root="analytics_zoo_tpu"),
    "port": _ns("port", faults=tfaults, registry=tregistry, slo=tslo,
                tracing=ttracing, broker=tbroker, client=tclient,
                elastic=telastic, inference_model=tim, partitions=tpartitions,
                pre_post=tpre_post, redis_server=tredis_server,
                server=tserver, supervisor=tsupervisor,
                linear=_port_linear, fn_model=_port_fn_model,
                observability=tobservability, checkpoint=tcheckpoint,
                memwatch=tmemwatch, cli=tcli, config=tconfig, fleet=tfleet,
                fleet_metrics=tfleet_metrics, http_frontend=thttp_frontend,
                rollout=trollout, trace_plane=ttrace_plane,
                slow_double=_port_slow_double, scale_model=_port_scale,
                package="analytics_zoo_tpu_torch",
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
