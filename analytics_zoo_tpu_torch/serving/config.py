"""Serving configuration — the `ClusterServingHelper` analogue.

Reference: `serving/utils/ClusterServingHelper.scala:481` parses
`scripts/cluster-serving/config.yaml` (`:3-34`: model path, core_number,
redis host/port, secure flags) and builds the InferenceModel. Same YAML
surface here, with broker URL generalized beyond redis and the model loaded
from this framework's formats.

Copied from `analytics_zoo_tpu/serving/config.py` (L1-1103): `_load_yaml`,
`_parse_simple_yaml`, `ServingConfig` with its validators,
`build_admission`, `build_slo`, `build_generative_model`, `build_model`,
the parsers, `wait_model_secret` and `_find_model_class`. What differs in
the port:

- `params.device` (default ``cuda``) is where the model serves; ``cpu``
  must be asked for, and ``cuda`` without a GPU raises when the model is
  built (the port's device rule, `common/device.py`). A replica count
  above 1 is checked against `torch.cuda.device_count()` (the JAX
  package's `jax.local_device_count()`); on the CPU each replica is a
  copy on the host;
- `placement: sharded` and `params.mesh` raise NotImplementedError naming
  ROADMAP.md queue 1, item 7b (the mesh spellings still parse and
  validate); `secure.model_encrypted`
  raises naming item 8 (`learn/encrypted.py`), though `POST
  /model-secure` and `wait_model_secret` are ported;
- `params.compile_cache_dir` (and `compile_cache_max_bytes`) name the
  port's persistent compile cache (`compile_cache/`): the kernel libraries
  nvcc built and a capture record per warmed program, never a CUDA graph
  (a graph cannot be written to disk), so a warm restart runs no nvcc;
- `build_model` also serves a Keras-style net that is not a `ZooModel`
  (the BERT task models): `model.class` names it, `model.config` holds
  its constructor arguments and `<path>/weights` its artifact
  (`KerasNet.save_weights`); the classes are searched in the JAX
  package's order, `textmatching` (KNRM) and `seq2seq` included, then
  `textmodels` (NER and the taggers), which the JAX lookup leaves out.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

ENCRYPTED_NOT_PORTED = (
    "secure.model_encrypted needs learn/encrypted.py, which is not ported "
    "yet (ROADMAP.md queue 1, item 8)")


def _load_yaml(path: str) -> Dict[str, Any]:
    try:
        import yaml
        with open(path) as fh:
            return yaml.safe_load(fh) or {}
    except ImportError:
        with open(path) as fh:
            return _parse_simple_yaml(fh.read())


def _parse_simple_yaml(text: str) -> Dict[str, Any]:
    """No-PyYAML fallback: nested `key:` maps / `key: value` scalars at any
    indentation depth (config.yaml uses up to three levels:
    model: {class, config: {kwargs...}})."""
    out: Dict[str, Any] = {}
    # stack of (indent, dict) from root to the innermost open map
    stack = [(-1, out)]
    for raw in text.splitlines():
        line = raw.rstrip()
        if not line or line.lstrip().startswith("#"):
            continue
        indent = len(line) - len(line.lstrip())
        key, _, value = line.strip().partition(":")
        value = value.strip()
        while len(stack) > 1 and indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        if value:
            parent[key] = _coerce(value)
        else:
            child: Dict[str, Any] = {}
            parent[key] = child
            stack.append((indent, child))
    return out


def _coerce(v: str):
    if v in ("", "~", "null"):
        return None
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v.strip("'\"")


@dataclass
class ServingConfig:
    """config.yaml schema (reference `scripts/cluster-serving/config.yaml`)."""

    model_path: Optional[str] = None
    model_class: Optional[str] = None       # zoo-model class name
    model_quantize: Optional[str] = None    # "int8" → quantized serving
    broker_url: str = "memory"              # memory | tcp://h:p | redis://h:p
    stream: str = "serving_stream"
    batch_size: int = 32                    # core_number analogue
    batch_timeout_ms: int = 5
    concurrent_num: int = 1
    # multi-device placement: model replicas (one per chip; "auto"/-1 =
    # every local device) or one GSPMD-sharded copy spanning all chips
    num_replicas: Any = 1                   # int, or "auto"
    placement: str = "replicated"           # replicated | sharded
    # where the model serves (the port's device rule): cuda unless the
    # config asks for the cpu
    device: str = "cuda"
    # sharded-placement mesh factorization: params.mesh — a
    # map {data: 1, fsdp: 2, tensor: 4} or the bare-parser string
    # "data=1,fsdp=2,tensor=4". Axis names follow common/mesh.AXIS_NAMES
    # (-1 infers one axis from the device count). Unset keeps the
    # data=1 × fsdp=all default; a `tensor` extent > 1 engages the rule
    # table's column/row-parallel specs for models whose activations
    # must shard too (bigger than one chip).
    mesh_axes: Optional[Dict[str, int]] = None
    # pipelined engine knobs (overlapped decode/compute/sink)
    pipelined: bool = True
    decode_workers: int = 2
    queue_depth: int = 8
    # fault tolerance:
    # replica supervision (quarantine/canary revival) over a replica
    # pool, circuit breaker on the engine's broker connections, bounded
    # sink writeback buffer for broker outages
    supervise: bool = True
    failure_threshold: int = 3
    probe_interval_s: float = 0.5
    latency_factor: float = 8.0
    breaker_failure_threshold: int = 3
    breaker_reset_s: float = 1.0
    sink_buffer_batches: int = 256
    # fleet mode: engine_id names this process as one of N
    # co-consumers ("auto" generates a unique id); heartbeats publish
    # to engines:<stream> every heartbeat_interval_s and the gateway
    # counts an engine dead after engine_ttl_s without one; the claim
    # sweep adopts a dead peer's unacked records once they sit idle
    # claim_min_idle_s, checking every claim_interval_s
    engine_id: Optional[str] = None
    heartbeat_interval_s: float = 2.0
    engine_ttl_s: float = 6.0
    claim_min_idle_s: float = 30.0
    claim_interval_s: float = 5.0
    # partitioned request plane: params.partitions splits the stream into N
    # broker streams keyed by consistent hash of the record id; engines
    # lease partition SETS from a broker table and take over an expired
    # peer's partitions. The count is a FLEET-WIDE agreement persisted
    # in the broker meta row — changing it under a live fleet is
    # rejected unless params.reshard (or --reshard) explicitly
    # acknowledges that in-flight records on the old layout may land on
    # engines not reading their stream until the fleet restarts.
    partitions: int = 1
    reshard: bool = False
    partition_lease_ttl_s: float = 5.0
    # elastic serving: params.batching selects the reader's
    # micro-batching policy (adaptive | fixed | static) and its deadline
    # budget (defaults to slo.latency_ms when unset); params.admission
    # declares priority tiers (lowest first), the HTTP header/record
    # field that carries them, the gateway 429 threshold and the
    # engine-side shed threshold; params.autoscale bounds and tunes the
    # gateway's SLO-driven engine autoscaler
    # versioned rollout: params.rollout.model_dir
    # points the engine's rollout agent (and the gateway's controller,
    # via `gateway --rollout-dir`) at the trainer's checkpoint root;
    # only PUBLISH-marked versions are acted on. poll/drain/canary
    # cadences plus the golden-output delta tolerance (None =
    # finiteness-only canary gate) and the controller's per-engine
    # conversion timeout.
    rollout_model_dir: Optional[str] = None
    rollout_poll_interval_s: float = 2.0
    rollout_drain_timeout_s: float = 10.0
    rollout_canary_timeout_s: float = 10.0
    rollout_golden_tolerance: Optional[float] = None
    rollout_engine_timeout_s: float = 60.0
    batch_policy: str = "adaptive"
    deadline_ms: Optional[float] = None
    batch_margin_ms: float = 2.0
    admission_tiers: Optional[list] = None
    admission_header: str = "X-Priority"
    admission_field: str = "tier"
    admission_max_backlog: int = 512
    shed_backlog: Optional[int] = None
    autoscale: Optional[Dict[str, Any]] = None
    # shape-bucket pre-warming: list of per-record shapes, e.g.
    # [[32, 32, 3]] (or the string "32x32x3,224x224x3" in bare-parser
    # YAML) — every bucket of each shape runs once at load, so no
    # kernel build or first-call cost lands on the request path
    warmup_shapes: Optional[list] = None
    warmup_dtype: str = "float32"
    # persistent compile cache (`compile_cache/`): warmup keys every
    # (replica, bucket) program there — its capture record and the kernel
    # libraries it launches — so a restart runs no nvcc.
    # compile_cache_max_bytes (int, or "512M"/"2G") bounds the dir with
    # LRU eviction.
    compile_cache_dir: Optional[str] = None
    compile_cache_max_bytes: Optional[int] = None
    # request-scoped tracing (`observability/tracing.py`): `trace: true`
    # attaches a span Tracer to the pipeline; trace_path additionally
    # dumps Chrome trace JSON (Perfetto-viewable) on shutdown
    trace: bool = False
    trace_path: Optional[str] = None
    # fleet observability plane: trace_sample > 0 turns on
    # cross-process span export — clients/gateways stamp trace context
    # on every record, engines continue the trace per stage and publish
    # head-sampled spans (plus force-sampled failures/SLO violations)
    # into the traces:<stream> broker hash every
    # trace_export_interval_s; trace_buffer_spans bounds the local span
    # ring (overflow counted in observability_spans_dropped_total).
    # fleet_metrics_interval_s paces each engine's registry snapshot
    # into the metrics:<stream> hash for gateway-aggregated /metrics
    # (0 disables publishing).
    trace_sample: float = 0.0
    trace_buffer_spans: int = 20000
    trace_export_interval_s: float = 0.5
    fleet_metrics_interval_s: float = 2.0
    # SLO objectives: a params.slo
    # block — latency_ms (target at latency_quantile), availability
    # (non-degraded fraction), window_s. Evaluated by the engine's
    # SLOTracker; feeds /healthz and the slo_burn_rate gauges.
    slo_latency_ms: Optional[float] = None
    slo_latency_quantile: float = 0.95
    slo_availability: Optional[float] = None
    slo_window_s: float = 300.0
    # generative decode mode (`serving/decode.py`): a params.generative
    # block switches the engine from the request-batched dispatch path to
    # the continuous-batching decode engine. slots sizes the pooled KV
    # cache (one [slots, heads, max_kv_len, head_dim] buffer per layer);
    # kv_buckets/prompt_buckets are the static shapes warmup pre-compiles
    # (default: pow-2 ladders derived from max_kv_len).
    generative: bool = False
    decode_slots: int = 8
    decode_max_kv_len: int = 256
    decode_kv_buckets: Optional[List[int]] = None
    decode_prompt_buckets: Optional[List[int]] = None
    decode_max_new_tokens: int = 64
    decode_eos_id: Optional[int] = None
    decode_max_waiting: int = 256
    decode_max_prefills: int = 4
    # paged KV: paged: true swaps the stripe pool for the
    # block pool + prefix cache + chunked prefill. block_len sizes one
    # KV block in tokens; kv_blocks the pool (default: slots ×
    # max_kv_len/block_len + scratch — byte parity with the stripes);
    # prefill_chunk bounds tokens per prefill chunk (null = whole
    # prompt); prefix_cache_blocks caps the trie (null = unbounded).
    decode_paged: bool = False
    decode_block_len: int = 16
    decode_kv_blocks: Optional[int] = None
    decode_prefill_chunk: Optional[int] = None
    decode_prefix_cache: bool = True
    decode_prefix_cache_blocks: Optional[int] = None
    # crash-safe serving: max_seq_wall_s arms the
    # per-sequence watchdog (null = off); preempt_max bounds how often
    # one sequence may be preempted under KV pressure before it must
    # complete ahead of new admissions (anti-thrash); writeback_buffer_
    # rows bounds the pending row buffer held through a broker outage
    # (oldest-step rows shed first — the final blob stays
    # authoritative); resume: false opts this engine out of claiming
    # and resuming a dead peer's in-flight generative records;
    # keepalive_s sets the SSE keepalive-comment cadence (null = none).
    decode_max_seq_wall_s: Optional[float] = None
    decode_preempt_max: int = 3
    decode_writeback_buffer: int = 512
    decode_resume: bool = True
    decode_keepalive_s: Optional[float] = None
    # on-demand profiler capture (POST /profile): artifact root +
    # rotation bound; profile_enabled: false turns the endpoint off
    # (404). Default root is <tmp>/zoo_profiles.
    profile_dir: Optional[str] = None
    profile_max_artifacts: int = 8
    profile_enabled: bool = True
    http_port: Optional[int] = None
    # secure block (`ClusterServingHelper.scala:121-134` — model_encrypted
    # gates the wait-for-secret/salt flow before weights load)
    model_encrypted: bool = False
    secret_timeout_s: float = 60.0
    scrub_secret: bool = False              # delete secret after first read
    # frontend hardening (`FrontEndApp.scala` tokenBucket/https arguments)
    tokens_per_second: Optional[float] = None
    token_acquire_timeout_ms: float = 100.0
    tls_certfile: Optional[str] = None
    tls_keyfile: Optional[str] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    # pre-consolidation field names (ZooConfig JSON / ZOO_SERVING_* env vars)
    LEGACY_FIELDS = {"core_number": "batch_size",
                     "redis_url": "broker_url",
                     "queue": "stream",
                     "max_latency_ms": "batch_timeout_ms"}

    @classmethod
    def load(cls, path: str, num_replicas=None,
             placement: Optional[str] = None,
             compile_cache_dir: Optional[str] = None,
             mesh: Optional[str] = None,
             device: Optional[str] = None) -> "ServingConfig":
        """`num_replicas`/`placement`/`compile_cache_dir`/`device` keyword
        overrides (the CLI flags) replace the file's values BEFORE
        validation, so an override can rescue a config authored for a
        bigger host (e.g. an 8-chip config started on a 2-device box
        with `--num-replicas 2`)."""
        raw = _load_yaml(path)
        model = raw.get("model", {}) or {}
        params = raw.get("params", {}) or {}
        redis = raw.get("redis", {}) or {}
        cfg = cls()
        cfg.model_path = model.get("path")
        cfg.model_class = model.get("class")
        cfg.model_quantize = model.get("quantize")
        if redis.get("host"):
            cfg.broker_url = \
                f"redis://{redis['host']}:{redis.get('port', 6379)}"
        if raw.get("broker"):
            cfg.broker_url = raw["broker"]
        cfg.batch_size = int(params.get("core_number",
                                        params.get("batch_size", 32)))
        cfg.batch_timeout_ms = int(params.get("batch_timeout_ms", 5))
        cfg.concurrent_num = int(params.get("concurrent_num", 1))
        cfg.num_replicas = num_replicas if num_replicas is not None \
            else params.get("num_replicas", 1)
        cfg.placement = placement if placement is not None \
            else str(params.get("placement", "replicated"))
        cfg.device = str(device if device is not None
                         else params.get("device", "cuda"))
        cfg.mesh_axes = _parse_mesh_axes(
            mesh if mesh is not None else params.get("mesh"))
        # fail HERE, not deep inside the dispatch stage: a bad placement
        # string or a replica count the host cannot satisfy is a config
        # error, and config errors belong at load time
        cfg._validate_placement()
        cfg.compile_cache_dir = compile_cache_dir if compile_cache_dir \
            is not None else params.get("compile_cache_dir")
        cfg.compile_cache_max_bytes = _parse_bytes(
            params.get("compile_cache_max_bytes"))
        cfg._validate_compile_cache()
        cfg.pipelined = bool(params.get("pipelined", True))
        cfg.decode_workers = int(params.get("decode_workers", 2))
        cfg.queue_depth = int(params.get("queue_depth", 8))
        cfg.supervise = bool(params.get("supervise", True))
        cfg.failure_threshold = int(params.get("failure_threshold", 3))
        cfg.probe_interval_s = float(params.get("probe_interval_s", 0.5))
        cfg.latency_factor = float(params.get("latency_factor", 8.0))
        cfg.breaker_failure_threshold = int(
            params.get("breaker_failure_threshold", 3))
        cfg.breaker_reset_s = float(params.get("breaker_reset_s", 1.0))
        cfg.sink_buffer_batches = int(
            params.get("sink_buffer_batches", 256))
        cfg._validate_fault_tolerance()
        engine_id = params.get("engine_id")
        if engine_id is not None:
            cfg.engine_id = str(engine_id)
        cfg.heartbeat_interval_s = float(
            params.get("heartbeat_interval_s", 2.0))
        cfg.engine_ttl_s = float(params.get("engine_ttl_s", 6.0))
        cfg.claim_min_idle_s = float(params.get("claim_min_idle_s", 30.0))
        cfg.claim_interval_s = float(params.get("claim_interval_s", 5.0))
        cfg._validate_fleet()
        cfg.partitions = int(params.get("partitions", 1))
        cfg.reshard = bool(params.get("reshard", False))
        cfg.partition_lease_ttl_s = float(
            params.get("partition_lease_ttl_s", 5.0))
        cfg._validate_partitions()
        rollout = params.get("rollout", {}) or {}
        if not isinstance(rollout, dict):
            raise ValueError(
                f"params.rollout={rollout!r} must be a map (model_dir, "
                "poll_interval_s, drain_timeout_s, canary_timeout_s, "
                "golden_tolerance, engine_timeout_s)")
        cfg.rollout_model_dir = rollout.get("model_dir")
        cfg.rollout_poll_interval_s = float(
            rollout.get("poll_interval_s", 2.0))
        cfg.rollout_drain_timeout_s = float(
            rollout.get("drain_timeout_s", 10.0))
        cfg.rollout_canary_timeout_s = float(
            rollout.get("canary_timeout_s", 10.0))
        if rollout.get("golden_tolerance") is not None:
            cfg.rollout_golden_tolerance = float(
                rollout["golden_tolerance"])
        cfg.rollout_engine_timeout_s = float(
            rollout.get("engine_timeout_s", 60.0))
        cfg._validate_rollout()
        batching = params.get("batching", {}) or {}
        if not isinstance(batching, dict):
            raise ValueError(
                f"params.batching={batching!r} must be a map (policy, "
                "deadline_ms, margin_ms)")
        cfg.batch_policy = str(batching.get("policy", "adaptive"))
        if batching.get("deadline_ms") is not None:
            cfg.deadline_ms = float(batching["deadline_ms"])
        cfg.batch_margin_ms = float(batching.get("margin_ms", 2.0))
        admission = params.get("admission", {}) or {}
        if not isinstance(admission, dict):
            raise ValueError(
                f"params.admission={admission!r} must be a map (tiers, "
                "header, field, max_backlog, shed_backlog)")
        cfg.admission_tiers = _parse_tiers(admission.get("tiers"))
        cfg.admission_header = str(admission.get("header", "X-Priority"))
        cfg.admission_field = str(admission.get("field", "tier"))
        cfg.admission_max_backlog = int(admission.get("max_backlog", 512))
        if admission.get("shed_backlog") is not None:
            cfg.shed_backlog = int(admission["shed_backlog"])
        elif cfg.admission_tiers:
            # default: the engine starts shedding at twice the gateway's
            # hard 429 line — admission throttles first, shed is the
            # backstop for producers that bypass the gateway
            cfg.shed_backlog = 2 * cfg.admission_max_backlog
        autoscale = params.get("autoscale", None)
        if autoscale is not None and not isinstance(autoscale, dict):
            raise ValueError(
                f"params.autoscale={autoscale!r} must be a map "
                "(min_engines, max_engines, backlog_high, backlog_low, "
                "up_stable_s, down_stable_s, cooldown_s, interval_s, "
                "burn_high)")
        if autoscale is not None:
            cfg.autoscale = {
                "min_engines": int(autoscale.get("min_engines", 1)),
                "max_engines": int(autoscale.get("max_engines", 4)),
                "backlog_high": float(autoscale.get("backlog_high", 64)),
                "backlog_low": float(autoscale.get("backlog_low", 8)),
                "burn_high": float(autoscale.get("burn_high", 1.0)),
                "up_stable_s": float(autoscale.get("up_stable_s", 2.0)),
                "down_stable_s": float(
                    autoscale.get("down_stable_s", 10.0)),
                "cooldown_s": float(autoscale.get("cooldown_s", 5.0)),
                "interval_s": float(autoscale.get("interval_s", 1.0)),
                "spawn_grace_s": float(
                    autoscale.get("spawn_grace_s", 30.0)),
            }
        cfg._validate_elastic()
        cfg.warmup_shapes = _parse_warmup_shapes(
            params.get("warmup_shapes"))
        cfg.warmup_dtype = str(params.get("warmup_dtype", "float32"))
        cfg.trace = bool(params.get("trace", False))
        cfg.trace_path = params.get("trace_path")
        cfg.trace_sample = float(params.get("trace_sample", 0.0))
        cfg.trace_buffer_spans = int(
            params.get("trace_buffer_spans", 20000))
        cfg.trace_export_interval_s = float(
            params.get("trace_export_interval_s", 0.5))
        cfg.fleet_metrics_interval_s = float(
            params.get("fleet_metrics_interval_s", 2.0))
        cfg._validate_observability()
        slo = params.get("slo", {}) or {}
        if not isinstance(slo, dict):
            raise ValueError(
                f"params.slo={slo!r} must be a map (latency_ms, "
                "latency_quantile, availability, window_s)")
        if slo.get("latency_ms") is not None:
            cfg.slo_latency_ms = float(slo["latency_ms"])
        if slo.get("latency_quantile") is not None:
            cfg.slo_latency_quantile = float(slo["latency_quantile"])
        if slo.get("availability") is not None:
            cfg.slo_availability = float(slo["availability"])
        if slo.get("window_s") is not None:
            cfg.slo_window_s = float(slo["window_s"])
        cfg.build_slo()          # objective errors fail the load, like
        #                          placement — not the supervisor thread
        gen = params.get("generative", None)
        if gen is not None and not isinstance(gen, dict):
            raise ValueError(
                f"params.generative={gen!r} must be a map (slots, "
                "max_kv_len, kv_buckets, prompt_buckets, max_new_tokens, "
                "eos_id, max_waiting, max_prefills)")
        if gen is not None:
            cfg.generative = True
            cfg.decode_slots = int(gen.get("slots", 8))
            cfg.decode_max_kv_len = int(gen.get("max_kv_len", 256))
            if gen.get("kv_buckets") is not None:
                cfg.decode_kv_buckets = [
                    int(b) for b in gen["kv_buckets"]]
            if gen.get("prompt_buckets") is not None:
                cfg.decode_prompt_buckets = [
                    int(b) for b in gen["prompt_buckets"]]
            cfg.decode_max_new_tokens = int(gen.get("max_new_tokens", 64))
            if gen.get("eos_id") is not None:
                cfg.decode_eos_id = int(gen["eos_id"])
            cfg.decode_max_waiting = int(gen.get("max_waiting", 256))
            cfg.decode_max_prefills = int(gen.get("max_prefills", 4))
            cfg.decode_paged = bool(gen.get("paged", False))
            cfg.decode_block_len = int(gen.get("block_len", 16))
            if gen.get("kv_blocks") is not None:
                cfg.decode_kv_blocks = int(gen["kv_blocks"])
            if gen.get("prefill_chunk") is not None:
                cfg.decode_prefill_chunk = int(gen["prefill_chunk"])
            cfg.decode_prefix_cache = bool(gen.get("prefix_cache", True))
            if gen.get("prefix_cache_blocks") is not None:
                cfg.decode_prefix_cache_blocks = int(
                    gen["prefix_cache_blocks"])
            if gen.get("max_seq_wall_s") is not None:
                cfg.decode_max_seq_wall_s = float(gen["max_seq_wall_s"])
            cfg.decode_preempt_max = int(gen.get("preempt_max", 3))
            cfg.decode_writeback_buffer = int(
                gen.get("writeback_buffer_rows", 512))
            cfg.decode_resume = bool(gen.get("resume", True))
            if gen.get("keepalive_s") is not None:
                cfg.decode_keepalive_s = float(gen["keepalive_s"])
            cfg._validate_generative()
        cfg.profile_dir = params.get("profile_dir")
        cfg.profile_enabled = bool(params.get("profile_enabled", True))
        cfg.profile_max_artifacts = int(
            params.get("profile_max_artifacts", 8))
        if cfg.profile_max_artifacts < 1:
            raise ValueError(
                f"params.profile_max_artifacts="
                f"{cfg.profile_max_artifacts} must be >= 1")
        if raw.get("http_port") is not None:
            cfg.http_port = int(raw["http_port"])
        secure = raw.get("secure", {}) or {}
        cfg.model_encrypted = bool(secure.get("model_encrypted", False))
        if cfg.model_encrypted:
            raise NotImplementedError(ENCRYPTED_NOT_PORTED)
        if secure.get("secret_timeout_s") is not None:
            cfg.secret_timeout_s = float(secure["secret_timeout_s"])
        cfg.scrub_secret = bool(secure.get("scrub_secret", False))
        frontend = raw.get("frontend", {}) or {}
        if frontend.get("tokens_per_second") is not None:
            cfg.tokens_per_second = float(frontend["tokens_per_second"])
        if frontend.get("token_acquire_timeout_ms") is not None:
            cfg.token_acquire_timeout_ms = float(
                frontend["token_acquire_timeout_ms"])
        cfg.tls_certfile = frontend.get("tls_certfile")
        cfg.tls_keyfile = frontend.get("tls_keyfile")
        cfg.extra = raw
        return cfg

    def _validate_placement(self):
        """Reject bad `placement`/`num_replicas`/`device` values with a
        clear error while still parsing the config. The sharded placement
        and its mesh are not ported (ROADMAP.md queue 1, item 7b): a mesh
        under the replicated placement is still the JAX package's
        ValueError, and a sharded config raises NotImplementedError."""
        from analytics_zoo_tpu_torch.serving.inference_model import \
            PLACEMENTS
        if self.placement not in PLACEMENTS:
            raise ValueError(
                f"params.placement={self.placement!r} is not one of "
                f"{'/'.join(PLACEMENTS)}")
        if self.mesh_axes is not None and self.placement != "sharded":
            raise ValueError(
                "params.mesh describes the sharded placement's "
                f"device-mesh factorization but placement is "
                f"{self.placement!r}; set params.placement: sharded "
                "(or drop the mesh block)")
        if self.placement == "sharded":
            raise NotImplementedError(
                "params.placement: sharded (and params.mesh) is not ported "
                "yet (ROADMAP.md queue 1, item 7b); serve replicated")
        try:
            dev = torch.device(self.device)
        except (RuntimeError, TypeError):
            raise ValueError(
                f"params.device={self.device!r} is not a torch device "
                "(cuda, cuda:<n> or cpu)") from None
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(
                f"params.device={self.device!r} must be cuda or cpu")
        n = self.num_replicas
        if n is None or n == "auto":   # bare `num_replicas:` == auto,
            return                     # matching InferenceModel(None)
        try:
            n = int(n)
        except (TypeError, ValueError):
            raise ValueError(
                f"params.num_replicas={n!r} must be an integer, "
                "'auto', or -1 (one replica per local device)") from None
        if n in (0, -1):           # auto spellings
            return
        if n < -1:
            raise ValueError(
                f"params.num_replicas={n} must be >= 1 (or 'auto'/-1)")
        if n == 1 or dev.type == "cpu":
            # one replica fits any host; CPU replicas are host copies
            return
        avail = torch.cuda.device_count()
        if n > avail:
            raise ValueError(
                f"params.num_replicas={n} exceeds the {avail} available "
                f"local device(s); lower it or use 'auto'")

    def _validate_fault_tolerance(self):
        """Supervision/breaker knobs fail at config load like placement:
        a zero threshold or a negative interval is a config error, not a
        runtime surprise inside the supervisor thread."""
        for name, value, minimum in (
                ("failure_threshold", self.failure_threshold, 1),
                ("breaker_failure_threshold",
                 self.breaker_failure_threshold, 1),
                ("sink_buffer_batches", self.sink_buffer_batches, 1)):
            if value < minimum:
                raise ValueError(
                    f"params.{name}={value} must be >= {minimum}")
        for name, value in (("probe_interval_s", self.probe_interval_s),
                            ("breaker_reset_s", self.breaker_reset_s),
                            ("latency_factor", self.latency_factor)):
            if value <= 0:
                raise ValueError(
                    f"params.{name}={value} must be > 0")

    def _validate_fleet(self):
        """Fleet knobs fail at config load like the rest: a zero TTL or
        a claim window shorter than the heartbeat cadence is an
        operator error, not a runtime surprise."""
        for name, value in (
                ("heartbeat_interval_s", self.heartbeat_interval_s),
                ("engine_ttl_s", self.engine_ttl_s),
                ("claim_min_idle_s", self.claim_min_idle_s),
                ("claim_interval_s", self.claim_interval_s)):
            if value <= 0:
                raise ValueError(f"params.{name}={value} must be > 0")
        if self.engine_ttl_s <= self.heartbeat_interval_s:
            raise ValueError(
                f"params.engine_ttl_s={self.engine_ttl_s} must exceed "
                f"heartbeat_interval_s={self.heartbeat_interval_s}: one "
                "delayed beat would flap every engine dead")
        if self.engine_id is not None and not str(self.engine_id).strip():
            raise ValueError("params.engine_id must be a non-empty "
                             "string, 'auto', or unset")

    def _validate_partitions(self):
        """Partition knobs fail at config load like the rest: a bad
        count, a partitioned engine without the pipelined
        path or a fleet identity, or a non-positive lease TTL are
        operator errors, not reader-loop surprises. (The count-change-
        under-a-live-fleet check is runtime state, not config: the
        broker's meta row enforces it when the engine starts —
        `partitions.PartitionLeaseTable.ensure_meta`.)"""
        from analytics_zoo_tpu_torch.serving.partitions import \
            validate_partitions
        try:
            validate_partitions(self.partitions)
        except ValueError as e:
            raise ValueError(f"params.partitions: {e}") from None
        if self.partition_lease_ttl_s <= 0:
            raise ValueError(
                f"params.partition_lease_ttl_s="
                f"{self.partition_lease_ttl_s:g} must be > 0")
        if self.partitions > 1 and not self.pipelined:
            raise ValueError(
                "params.partitions > 1 needs params.pipelined: true — "
                "the legacy single-threaded loop reads one stream")
        # engine_id is NOT required here: the fleet identity usually
        # arrives as the CLI --engine-id override — cmd_start enforces
        # the pairing after overrides land

    def _validate_observability(self):
        """Trace-plane knobs fail at config load like the rest: a
        sampling rate outside [0, 1] or a non-positive buffer /
        cadence is an operator error, not an exporter-thread surprise."""
        if not 0.0 <= self.trace_sample <= 1.0:
            raise ValueError(
                f"params.trace_sample={self.trace_sample:g} must be in "
                "[0, 1] (the head-sampling rate)")
        if self.trace_buffer_spans < 1:
            raise ValueError(
                f"params.trace_buffer_spans={self.trace_buffer_spans} "
                "must be >= 1")
        if self.trace_export_interval_s <= 0:
            raise ValueError(
                f"params.trace_export_interval_s="
                f"{self.trace_export_interval_s:g} must be > 0")
        if self.fleet_metrics_interval_s < 0:
            raise ValueError(
                f"params.fleet_metrics_interval_s="
                f"{self.fleet_metrics_interval_s:g} must be >= 0 "
                "(0 disables fleet metrics publishing)")

    def _validate_rollout(self):
        """Rollout knobs fail at config load like the rest:
        a bad dir spelling, non-positive cadence or negative tolerance
        is an operator error, not a control-loop surprise mid-swap."""
        d = self.rollout_model_dir
        if d is not None and (not isinstance(d, str) or not d.strip()):
            raise ValueError(
                f"params.rollout.model_dir={d!r} must be a non-empty "
                "path string (the trainer's checkpoint root)")
        for name, value in (
                ("poll_interval_s", self.rollout_poll_interval_s),
                ("drain_timeout_s", self.rollout_drain_timeout_s),
                ("canary_timeout_s", self.rollout_canary_timeout_s),
                ("engine_timeout_s", self.rollout_engine_timeout_s)):
            if value <= 0:
                raise ValueError(
                    f"params.rollout.{name}={value:g} must be > 0")
        tol = self.rollout_golden_tolerance
        if tol is not None and tol < 0:
            raise ValueError(
                f"params.rollout.golden_tolerance={tol:g} must be "
                ">= 0 (or unset for the finiteness-only gate)")
        # engine_id is NOT required here: the fleet identity usually
        # arrives as the CLI --engine-id override — cmd_start enforces
        # the pairing after overrides land

    def _validate_elastic(self):
        """Elastic knobs fail at config load like the rest:
        a bad policy string, a non-positive deadline, duplicate tiers,
        or inverted autoscaler thresholds are operator errors, not
        runtime surprises inside the reader or the control loop."""
        from analytics_zoo_tpu_torch.serving.elastic import (
            AdaptiveBatchController, TierTable)
        if self.batch_policy not in AdaptiveBatchController.POLICIES:
            raise ValueError(
                f"params.batching.policy={self.batch_policy!r} is not "
                f"one of {'/'.join(AdaptiveBatchController.POLICIES)}")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(
                f"params.batching.deadline_ms={self.deadline_ms} must "
                "be > 0")
        if self.batch_margin_ms < 0:
            raise ValueError(
                f"params.batching.margin_ms={self.batch_margin_ms} "
                "must be >= 0")
        if self.admission_tiers is not None:
            TierTable(self.admission_tiers)   # raises on empty/dupes
        if self.admission_max_backlog <= 0:
            raise ValueError(
                f"params.admission.max_backlog="
                f"{self.admission_max_backlog} must be > 0")
        if self.shed_backlog is not None and self.shed_backlog <= 0:
            raise ValueError(
                f"params.admission.shed_backlog={self.shed_backlog} "
                "must be > 0")
        if self.autoscale is not None:
            # ONE validator, shared with FleetAutoscaler.__init__ —
            # the bounds cannot drift between config load and the
            # gateway's construction
            from analytics_zoo_tpu_torch.serving.fleet import \
                validate_autoscale
            validate_autoscale(self.autoscale,
                               prefix="params.autoscale.")

    def build_admission(self, broker, registry=None):
        """The gateway-side `AdmissionController` this config declares
        (None when no tiers are configured)."""
        if not self.admission_tiers:
            return None
        from analytics_zoo_tpu_torch.serving.elastic import AdmissionController
        return AdmissionController(
            broker, self.stream, self.admission_tiers,
            max_backlog=self.admission_max_backlog, registry=registry)

    def resolve_engine_id(self) -> Optional[str]:
        """The engine id `cmd_start` hands to ClusterServing: None when
        fleet mode is off, a unique generated id for 'auto', the
        configured string otherwise."""
        if self.engine_id is None:
            return None
        if str(self.engine_id).lower() == "auto":
            import os
            import uuid
            return f"engine-{os.getpid()}-{uuid.uuid4().hex[:6]}"
        return str(self.engine_id)

    def _validate_generative(self):
        """Decode-mode sizing errors fail the load like placement: a KV
        bucket larger than the pool, or a slot count < 1, would only
        surface as a mid-warmup shape error otherwise."""
        if self.decode_slots < 1:
            raise ValueError(
                f"params.generative.slots={self.decode_slots} must be >= 1")
        if self.decode_max_kv_len < 2:
            raise ValueError(
                f"params.generative.max_kv_len={self.decode_max_kv_len} "
                "must be >= 2")
        for name, ladder in (("kv_buckets", self.decode_kv_buckets),
                             ("prompt_buckets", self.decode_prompt_buckets)):
            if ladder is None:
                continue
            if not ladder or any(int(b) < 1 for b in ladder):
                raise ValueError(
                    f"params.generative.{name}={ladder!r} must be a "
                    "non-empty list of positive ints")
            if max(ladder) > self.decode_max_kv_len:
                raise ValueError(
                    f"params.generative.{name} max {max(ladder)} exceeds "
                    f"max_kv_len={self.decode_max_kv_len}")
        if self.decode_max_new_tokens < 1:
            raise ValueError(
                f"params.generative.max_new_tokens="
                f"{self.decode_max_new_tokens} must be >= 1")
        if self.decode_max_prefills < 1:
            raise ValueError(
                f"params.generative.max_prefills="
                f"{self.decode_max_prefills} must be >= 1")
        if self.decode_paged:
            if self.decode_block_len < 1:
                raise ValueError(
                    f"params.generative.block_len={self.decode_block_len} "
                    "must be >= 1")
            if self.decode_max_kv_len % self.decode_block_len:
                raise ValueError(
                    f"params.generative.max_kv_len="
                    f"{self.decode_max_kv_len} must be a multiple of "
                    f"block_len={self.decode_block_len} (the block table "
                    "covers the pool in whole blocks)")
            if self.decode_kv_buckets is not None:
                bad = [b for b in self.decode_kv_buckets
                       if int(b) % self.decode_block_len]
                if bad:
                    raise ValueError(
                        f"params.generative.kv_buckets {bad} must be "
                        f"multiples of block_len={self.decode_block_len} "
                        "(a paged attention window reads whole blocks)")
            if (self.decode_kv_blocks is not None
                    and self.decode_kv_blocks < 2):
                raise ValueError(
                    f"params.generative.kv_blocks={self.decode_kv_blocks} "
                    "must be >= 2 (scratch + one usable block)")
            if (self.decode_prefill_chunk is not None
                    and self.decode_prefill_chunk < 1):
                raise ValueError(
                    f"params.generative.prefill_chunk="
                    f"{self.decode_prefill_chunk} must be >= 1")
            if (self.decode_prefix_cache_blocks is not None
                    and self.decode_prefix_cache_blocks < 1):
                raise ValueError(
                    f"params.generative.prefix_cache_blocks="
                    f"{self.decode_prefix_cache_blocks} must be >= 1")
        if (self.decode_max_seq_wall_s is not None
                and self.decode_max_seq_wall_s <= 0):
            raise ValueError(
                f"params.generative.max_seq_wall_s="
                f"{self.decode_max_seq_wall_s} must be > 0 (or null to "
                "disable the per-sequence watchdog)")
        if self.decode_preempt_max < 0:
            raise ValueError(
                f"params.generative.preempt_max={self.decode_preempt_max} "
                "must be >= 0 (0 disables KV-pressure preemption)")
        if self.decode_writeback_buffer < 1:
            raise ValueError(
                f"params.generative.writeback_buffer_rows="
                f"{self.decode_writeback_buffer} must be >= 1")
        if (self.decode_keepalive_s is not None
                and self.decode_keepalive_s <= 0):
            raise ValueError(
                f"params.generative.keepalive_s={self.decode_keepalive_s} "
                "must be > 0 (or null for no keepalive comments)")

    def _validate_compile_cache(self):
        """Cache-setting errors belong at config load, like placement:
        a bad path or a non-positive byte budget must fail the start
        command, not surface mid-warmup."""
        d = self.compile_cache_dir
        if d is not None:
            if not isinstance(d, str) or not d.strip():
                raise ValueError(
                    f"params.compile_cache_dir={d!r} must be a non-empty "
                    "path string")
            expanded = os.path.abspath(os.path.expanduser(d))
            if os.path.exists(expanded) and not os.path.isdir(expanded):
                raise ValueError(
                    f"params.compile_cache_dir={d!r} exists and is not a "
                    "directory")
        mb = self.compile_cache_max_bytes
        if mb is not None:
            if not isinstance(mb, int) or mb <= 0:
                raise ValueError(
                    f"params.compile_cache_max_bytes={mb!r} must be a "
                    'positive byte count (int, or "512M"/"2G")')
            if d is None:
                raise ValueError(
                    "params.compile_cache_max_bytes is set but "
                    "params.compile_cache_dir is not; the budget bounds "
                    "the cache directory")

    def build_slo(self):
        """The `SLOObjectives` this config declares, validated (None
        when no objective is set); `cmd_start` hands it to
        `ClusterServing(slo=...)`."""
        if self.slo_latency_ms is None and self.slo_availability is None:
            return None
        from analytics_zoo_tpu_torch.observability.slo import SLOObjectives
        return SLOObjectives(
            latency_ms=self.slo_latency_ms,
            latency_quantile=self.slo_latency_quantile,
            availability=self.slo_availability,
            window_s=self.slo_window_s).validate()

    def build_compile_cache(self, registry=None):
        """The `CompileCache` this config names (None when caching is
        off); `build_model` and `build_generative_model` wire it into the
        InferenceModel."""
        if not self.compile_cache_dir:
            return None
        from analytics_zoo_tpu_torch.compile_cache import CompileCache
        return CompileCache(self.compile_cache_dir,
                            max_bytes=self.compile_cache_max_bytes,
                            registry=registry)

    def build_generative_model(self):
        """Decode-mode model resolution: `model.class` must name a class
        exposing the generative contract (`init_params`/`init_kv`/
        `prefill_fn`/`step_fn` — see `models/generative.py`), built on
        `params.device`. Weights come from the instance's own
        `init_params()` (a model that loads from disk does so there);
        returns `(InferenceModel, instance)`."""
        from analytics_zoo_tpu_torch.serving.inference_model import \
            InferenceModel
        if not self.model_class:
            raise ValueError(
                "params.generative needs model.class naming a generative "
                "model (init_params/init_kv/prefill_fn/step_fn)")
        cls = _find_model_class(self.model_class)
        kwargs = (self.extra.get("model", {}) or {}).get("config") or {}
        inst = cls(**kwargs, device=self.device)
        needed = ["init_params", "init_kv", "prefill_fn", "step_fn"]
        if self.decode_paged:
            needed += ["init_kv_blocks", "paged_prefill_fn",
                       "paged_step_fn"]
        missing = [a for a in needed
                   if not callable(getattr(inst, a, None))]
        if missing:
            raise ValueError(
                f"model.class={self.model_class} lacks the "
                f"{'paged ' if self.decode_paged else ''}generative "
                f"contract: missing {', '.join(missing)}")
        im = InferenceModel(placement="replicated", num_replicas=1,
                            device=self.device,
                            compile_cache=self.build_compile_cache())
        im.load_generative(
            inst.prefill_fn, inst.step_fn, inst.init_params(),
            paged_prefill_fn=getattr(inst, "paged_prefill_fn", None)
            if self.decode_paged else None,
            paged_step_fn=getattr(inst, "paged_step_fn", None)
            if self.decode_paged else None)
        return im, inst

    def build_model(self, broker=None):
        """Model resolution (`ClusterServingHelper` model-type dispatch):
        a ZooModel dir (config.json names the class), or bare weights plus
        `model: {class: ..., config: {...constructor kwargs...}}` — a
        ZooModel's (`<path>/weights` is its net's artifact) or a
        Keras-style net's, such as the BERT task models (`<path>/weights`
        is the net's own artifact). Built on `params.device`.

        `secure.model_encrypted` (the wait for the secret/salt the
        frontend receives at POST /model-secure, then `weights.enc`) is
        refused at load (ROADMAP.md queue 1, item 8)."""
        import json
        from analytics_zoo_tpu_torch.keras.engine import KerasNet
        from analytics_zoo_tpu_torch.serving.inference_model import \
            InferenceModel
        if not self.model_path:
            raise ValueError("config has no model.path")
        self._validate_placement()
        if self.model_encrypted:
            raise NotImplementedError(ENCRYPTED_NOT_PORTED)
        try:
            n = int(self.num_replicas)   # accepts YAML-quoted "4" too
        except (TypeError, ValueError):
            n = "auto"                   # None / "auto" (just validated)
        if n in (0, -1):
            n = "auto"
        devices = None
        if torch.device(self.device).type == "cpu" and n != 1:
            # host replicas: one copy each, on threads of their own
            devices = ["cpu"] * (n if n != "auto" else 1)
        im = InferenceModel(concurrent_num=self.concurrent_num,
                            num_replicas=n, placement=self.placement,
                            device=self.device, devices=devices,
                            compile_cache=self.build_compile_cache())

        cfg_json = os.path.join(self.model_path, "config.json")
        if os.path.exists(cfg_json):
            with open(cfg_json) as fh:
                cls_name = json.load(fh)["class"]
            cls = _find_model_class(cls_name)
            return im.load_zoo_model(cls, self.model_path,
                                     quantize=self.model_quantize)
        if self.model_class:
            cls = _find_model_class(self.model_class)
            kwargs = (self.extra.get("model", {}) or {}).get("config") or {}
            inst = cls(**kwargs, device=im.device)
            int8_artifact = os.path.join(self.model_path, "weights_int8.npz")
            net = inst if isinstance(inst, KerasNet) else inst.model
            if os.path.exists(int8_artifact):
                # pre-quantized artifact beside the arch config: serve it
                # directly (serving/quantization.save_quantized output)
                return im.load_quantized(net, int8_artifact)
            net.load_weights(os.path.join(self.model_path, "weights"))
            return im.load_keras(net, quantize=self.model_quantize)
        raise ValueError(
            f"{self.model_path} is not a saved ZooModel directory "
            "(no config.json) and no model.class was given")


def _parse_bytes(raw) -> Optional[int]:
    """Byte counts from YAML: a plain int, or a "512K"/"128M"/"2G"
    string. Returns None for None; bad spellings raise at load time."""
    if raw is None:
        return None
    if isinstance(raw, bool):
        raise ValueError(f"byte count {raw!r} must be a number, "
                         'or a "512M"-style string')
    if isinstance(raw, int):
        return raw
    if isinstance(raw, float) and raw.is_integer():
        return int(raw)
    if isinstance(raw, str):
        s = raw.strip().upper()
        mult = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30}.get(s[-1:])
        try:
            if mult is not None:
                return int(float(s[:-1]) * mult)
            return int(s)
        except ValueError:
            pass
    raise ValueError(f"cannot parse byte count {raw!r} "
                     '(use an int, or "512K"/"128M"/"2G")')


def _parse_mesh_axes(raw) -> Optional[Dict[str, int]]:
    """Mesh factorization from config: a YAML map ``{data: 1, fsdp: 2,
    tensor: 4}`` or (bare-parser / CLI friendly) one "data=1,fsdp=2,
    tensor=4" string. Axis-name validation happens in
    `_validate_placement` (one vocabulary, one error site)."""
    if raw is None:
        return None
    if isinstance(raw, str):
        out: Dict[str, int] = {}
        for part in raw.split(","):
            part = part.strip()
            if not part:
                continue
            name, sep, value = part.partition("=")
            if not sep:
                raise ValueError(
                    f"params.mesh entry {part!r} must be axis=size "
                    '(e.g. "data=1,fsdp=2,tensor=4")')
            try:
                out[name.strip()] = int(value)
            except ValueError:
                raise ValueError(
                    f"params.mesh size {value!r} for axis "
                    f"{name.strip()!r} must be an integer") from None
        return out or None
    if isinstance(raw, dict):
        try:
            return {str(k): int(v) for k, v in raw.items()} or None
        except (TypeError, ValueError):
            raise ValueError(
                f"params.mesh sizes must be integers, got {raw!r}"
            ) from None
    raise ValueError(
        f"params.mesh={raw!r} must be a map of axis: size entries or "
        'one "data=1,fsdp=2,tensor=4" string')


def _parse_tiers(raw) -> Optional[list]:
    """Priority tiers from config, lowest first: a YAML list of names,
    or (bare-parser friendly) one comma-joined string "batch,standard,
    premium"."""
    if raw is None:
        return None
    if isinstance(raw, str):
        return [p.strip() for p in raw.split(",") if p.strip()] or None
    return [str(t) for t in raw] or None


def _parse_warmup_shapes(raw) -> Optional[list]:
    """Per-record warmup shapes from config: a YAML list of int lists or
    "32x32x3" strings, or (bare-parser friendly) one comma-joined string
    like "32x32x3,224x224x3"; "scalar" names the 0-d record shape ()."""
    def one(part: str) -> tuple:
        part = part.strip()
        return () if part == "scalar" else \
            tuple(int(d) for d in part.split("x"))

    if raw is None:
        return None
    if isinstance(raw, str):
        return [one(p) for p in raw.split(",") if p.strip()] or None
    if raw and all(isinstance(s, int) for s in raw):
        # flat int list `warmup_shapes: [32, 32, 3]` = ONE record shape
        return [tuple(int(d) for d in raw)]

    def elem(s) -> tuple:
        if isinstance(s, str):
            return one(s)
        if isinstance(s, int):
            raise ValueError(
                "warmup_shapes mixes bare ints with shapes — write one "
                'shape per element, e.g. [[32], [64, 64]] or "32,64x64"')
        return tuple(int(d) for d in s)

    return [elem(s) for s in raw] or None


def wait_model_secret(broker, timeout_s: float = 60.0,
                      poll_s: float = 0.2, scrub: bool = False):
    """Block until the frontend posts the model secret/salt to the broker
    (`ClusterServingHelper.scala:302-310` jedis.hget polling loop).

    The reference leaves the secret readable on the broker so serving
    restarts and extra replicas can pick it up without a fresh
    POST /model-secure; that is the default here too. Pass ``scrub=True``
    (config: ``secure.scrub_secret``) to delete it after the first read —
    then every serving (re)start needs the operator to re-POST."""
    import time as _time
    from analytics_zoo_tpu_torch.serving.http_frontend import (
        MODEL_SECURED_KEY, MODEL_SECURED_SALT, MODEL_SECURED_SECRET)
    deadline = _time.time() + timeout_s
    while _time.time() < deadline:
        secret = broker.hget(MODEL_SECURED_KEY, MODEL_SECURED_SECRET)
        salt = broker.hget(MODEL_SECURED_KEY, MODEL_SECURED_SALT)
        if secret and salt:
            if scrub:
                broker.hdel(MODEL_SECURED_KEY, MODEL_SECURED_SECRET)
                broker.hdel(MODEL_SECURED_KEY, MODEL_SECURED_SALT)
            return secret, salt
        _time.sleep(poll_s)
    raise TimeoutError(
        f"No model secret/salt appeared on the broker within {timeout_s}s; "
        "POST secret=...&salt=... to the frontend's /model-secure")


def _find_model_class(name: str):
    from analytics_zoo_tpu_torch.models import (anomalydetection, bert,
                                                generative, image,
                                                recommendation, seq2seq,
                                                textclassification,
                                                textmatching, textmodels)
    for mod in (recommendation, anomalydetection, textclassification,
                textmatching, seq2seq, image, bert, generative, textmodels):
        if hasattr(mod, name):
            return getattr(mod, name)
    raise ValueError(f"Unknown model class {name!r}")
