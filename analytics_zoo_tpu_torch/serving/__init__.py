"""Inference service layer — the Cluster Serving analogue.

Copied from `analytics_zoo_tpu/serving/__init__.py` (L1-52): the lazy
`_EXPORTS` table (PEP 562), every name the JAX package exports.

A host-side serving loop batches queue records into shape-bucketed
forwards on the card. The client protocol surface (`InputQueue` /
`OutputQueue`) is the reference's; the transport is a pluggable broker
(in-memory, TCP, or RESP2 to a Redis or the bundled `MiniRedisServer`).
Submodule attributes resolve lazily, so importing the package does not
drag the broker and server stack into every training-only import.
"""

_EXPORTS = {
    "InferenceModel": "analytics_zoo_tpu_torch.serving.inference_model",
    "MemoryBroker": "analytics_zoo_tpu_torch.serving.broker",
    "TCPBroker": "analytics_zoo_tpu_torch.serving.broker",
    "TCPBrokerServer": "analytics_zoo_tpu_torch.serving.broker",
    "connect_broker": "analytics_zoo_tpu_torch.serving.broker",
    "InputQueue": "analytics_zoo_tpu_torch.serving.client",
    "OutputQueue": "analytics_zoo_tpu_torch.serving.client",
    "ClusterServing": "analytics_zoo_tpu_torch.serving.server",
    "RedisBroker": "analytics_zoo_tpu_torch.serving.broker",
    "MiniRedisServer": "analytics_zoo_tpu_torch.serving.redis_server",
    "Timer": "analytics_zoo_tpu_torch.serving.timer",
    "FrontEnd": "analytics_zoo_tpu_torch.serving.http_frontend",
    "ServingConfig": "analytics_zoo_tpu_torch.serving.config",
    "BackoffPolicy": "analytics_zoo_tpu_torch.serving.breaker",
    "CircuitBreaker": "analytics_zoo_tpu_torch.serving.breaker",
    "ResilientBroker": "analytics_zoo_tpu_torch.serving.breaker",
    "ReplicaSupervisor": "analytics_zoo_tpu_torch.serving.supervisor",
    "FleetTracker": "analytics_zoo_tpu_torch.serving.fleet",
    "HeartbeatPublisher": "analytics_zoo_tpu_torch.serving.fleet",
    "engines_key": "analytics_zoo_tpu_torch.serving.fleet",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        mod = importlib.import_module(_EXPORTS[name])
        value = getattr(mod, name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
