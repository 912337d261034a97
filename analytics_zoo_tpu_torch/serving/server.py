"""ClusterServing — the serving engine.

Copied from `analytics_zoo_tpu/serving/server.py` (L1-1940): `_Batch`
(L84), `ClusterServing` (L113) with its pipelined stages, the legacy
`serve_once` / `_process` loop, `start` / `stop` / `kill` / `quiesce` /
`pause_intake` / `resume_intake`, `health`, `metrics`, the claim sweep,
the batched writeback with its buffer, tiered admission and shed, and
partition leases. What differs in the port:

- the model is the port's `InferenceModel`, on the card unless it was
  built with ``device="cpu"``. `predict_async` uploads the batch and queues
  the forward on the dispatch thread's current CUDA stream (or routes it
  to a replica's stream) under ``torch.inference_mode`` inside the model,
  so no stage depends on its thread's grad mode or device context;
  `result()` in the sink waits on the batch's event. A record's dtype is
  kept from the codec header to the device (int64 ids stay int64). There
  is no CPU fallback: a failed launch degrades its batch to "NaN" and the
  error counters, as in the JAX package.

The fleet plane is the JAX package's: with `engine_id` set, a
`HeartbeatPublisher` (`serving/fleet.py`) beats into `engines:<stream>`
and a `FleetMetricsPublisher` (`serving/fleet_metrics.py`) publishes the
registry into `metrics:<stream>`; `trace_sample > 0` starts a
`SpanExporter` (`serving/trace_plane.py`) into `traces:<stream>`. Each
runs on a broker connection of its own.

Reference: Flink job `RedisSource -> inference map -> RedisSink`
(`ClusterServing.scala:55-68`), batching up to core count
(`ClusterServingInference.scala:152` batchInput), singleton model per task
manager (`FlinkInference.scala:41-52`), per-record failures degrade to "NaN"
(`:71-79`).

Pipelined (the default): the reference gets throughput from
Flink scheduling its source/map/sink operators concurrently; here the same
overlap comes from three explicit stages connected by bounded queues —

    reader ──▶ decode pool ──▶ dispatch ──▶ sink
         _decode_q        _dispatch_q   _sink_q

- **reader**: drains the broker stream (up to `batch_size` records within
  `batch_timeout_ms`) and hands raw record lists to the decode pool.
- **decode** (`decode_workers` threads): b64 → ndarray per record, grouped
  into shape-homogeneous host batches; a record that fails to decode turns
  into a "NaN" result batch without touching the device.
- **dispatch** (one thread): stacks each shape group straight to its
  power-of-two bucket (stacking to the bucket is free — the stack copies
  every record anyway) and calls `InferenceModel.predict_async`, which
  returns WITHOUT materializing: the device computes batch N while this
  thread stacks and dispatches batch N+1. With a multi-device model
  (`num_replicas>1`) this stage is the ROUTER: predict_async picks the
  least-outstanding-work replica under a per-replica in-flight bound, so
  N batches compute on N chips concurrently; per-replica dispatch counts
  land in `serving_replica_batches_total` and each dispatch span is
  tagged with its replica.
- **sink** (one thread): materializes completed results (the only blocking
  `np.asarray`) in COMPLETION order — a slow or poisoned replica never
  dams finished work from the others — encodes per-record values, and
  writes a whole batch back with ONE broker round trip (`hset_many`)
  plus one batched ack — instead of the old one `hset` per record.

Backpressure is the bounded queues: a slow device fills `_sink_q` and
stalls dispatch; a slow broker fills `_decode_q` and stalls the reader.
`stop()` drains: each stage is poisoned only after the previous stage has
joined, so in-flight work flows out before threads exit. Per-record
failure degradation ("NaN", batch survives) is preserved in every stage.

`pipelined=False` keeps the old single-thread drain→batch→predict→sink
loop — the baseline `bench_serving.py --concurrent` compares against.
"""

from __future__ import annotations

import collections
import json
import logging
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np

from analytics_zoo_tpu_torch.observability.registry import (MetricsRegistry,
                                                            get_registry)
from analytics_zoo_tpu_torch.observability.tracing import Tracer
from analytics_zoo_tpu_torch.serving.breaker import (BackoffPolicy,
                                                     CircuitBreaker,
                                                     ResilientBroker)
from analytics_zoo_tpu_torch.serving.broker import (Broker, connect_broker,
                                                    decode_ndarray,
                                                    encode_ndarray,
                                                    new_consumer_name)
from analytics_zoo_tpu_torch.serving.inference_model import (
    InferenceModel, NoHealthyReplicaError)
from analytics_zoo_tpu_torch.serving.timer import Timer

log = logging.getLogger("analytics_zoo_tpu_torch.serving")

GROUP = "serving_group"

_STOP = object()          # stage poison pill


def _record_uris(records) -> List[str]:
    """Request ids (the result-hash uris) for a raw read batch — the
    trace ids every stage span is tagged with. Malformed records fall
    back to the broker record id, matching `_decode_records`."""
    out = []
    for rid, rec in records:
        out.append(rec.get("uri", rid) if isinstance(rec, dict)
                   else str(rid))
    return out


class _Batch:
    """One shape-homogeneous unit of pipeline work."""

    __slots__ = ("ids", "uris", "arrays", "t0", "pending", "nan", "t_enq",
                 "stacked", "valid_n", "shed", "bucket", "t_dispatch",
                 "stream")

    def __init__(self, ids, uris, arrays, t0, nan=False, stacked=None,
                 valid_n=None, shed=False, stream=None):
        self.ids = ids            # broker record ids (for the batched ack)
        self.uris = uris          # result-hash fields
        self.arrays = arrays      # decoded host arrays (None once stacked)
        self.t0 = t0              # read timestamp: end-to-end latency base
        self.pending = None       # PendingPrediction after dispatch
        self.nan = nan            # failure batch: sink writes "NaN"
        self.t_enq = t0           # last enqueue timestamp (queue-wait spans)
        self.stacked = stacked    # bucket-shaped buffer (zero-copy decode)
        self.valid_n = valid_n    # real rows in `stacked` (rest is pad)
        self.shed = shed          # admission-shed batch: sink writes "SHED"
        self.bucket = None        # dispatched bucket (cost-model key)
        self.t_dispatch = None    # dispatch timestamp (cost-model base)
        self.stream = stream      # source partition stream (None = base)


class ClusterServing:
    def __init__(self, model: InferenceModel,
                 broker: Union[Broker, str, None] = None,
                 stream: str = "serving_stream",
                 batch_size: int = 32, batch_timeout_ms: int = 5,
                 output_filter: Optional[str] = None,
                 pipelined: bool = True, decode_workers: int = 2,
                 queue_depth: int = 8,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 supervise: bool = True,
                 failure_threshold: int = 3,
                 probe_interval_s: float = 0.5,
                 latency_factor: float = 8.0,
                 latency_floor_ms: float = 50.0,
                 breaker_failure_threshold: int = 3,
                 breaker_reset_s: float = 1.0,
                 sink_buffer_batches: int = 256,
                 slo=None, zero_copy_decode: bool = True,
                 engine_id: Optional[str] = None,
                 claim_min_idle_s: float = 30.0,
                 claim_interval_s: float = 5.0,
                 heartbeat_interval_s: float = 2.0,
                 batch_policy: str = "adaptive",
                 deadline_ms: Optional[float] = None,
                 batch_margin_ms: float = 2.0,
                 admission_tiers=None,
                 admission_field: str = "tier",
                 shed_backlog: Optional[int] = None,
                 model_version: Optional[int] = None,
                 partitions: int = 1,
                 reshard: bool = False,
                 partition_lease_ttl_s: float = 5.0,
                 trace_sample: float = 0.0,
                 trace_buffer_spans: int = 20000,
                 trace_export_interval_s: float = 0.5,
                 fleet_metrics_interval_s: float = 2.0):
        """Fault-tolerance knobs:
        `supervise` starts a `ReplicaSupervisor` over a replica pool
        (quarantine after `failure_threshold` consecutive failures or
        `failure_threshold` latency outliers past `latency_factor`× the
        pool median; canary-probe revival every `probe_interval_s`).
        The engine's reader/sink broker connections wear a circuit
        breaker (`breaker_*`), and failed sink writebacks buffer up to
        `sink_buffer_batches` before the oldest is shed (shed records
        stay unacked and redeliver).

        `slo`: declarative objectives — an
        `observability.slo.SLOObjectives` — evaluated over the engine's
        own latency/outcome metrics; the tracker feeds `health()` / the
        frontend's `/healthz` and publishes burn-rate gauges.

        `zero_copy_decode`: decode writes records straight
        into preallocated bucket-shaped batch buffers (no per-record
        ndarray allocation, no dispatch-stage np.stack). False restores
        the per-record decode + stack path — kept ONLY as the
        bench_serving A/B baseline.

        Fleet mode: `engine_id` names this engine as ONE of
        N co-consumers of the stream. It becomes the consumer-group
        consumer name, an `engine` label on the `serving_*` metric
        series and pipeline spans, and the heartbeat identity published
        to `engines:<stream>` every `heartbeat_interval_s` (the fleet
        gateway's liveness source; a clean stop deregisters). The
        reader additionally runs a stale-pending claim sweep every
        `claim_interval_s`: entries another consumer read but never
        acked — a killed peer's in-flight batches — become claimable
        after `claim_min_idle_s` and redeliver HERE (XAUTOCLAIM on
        Redis, window-parity on the in-process brokers), so an engine
        crash costs capacity, never accepted records. The sweep runs
        even with `engine_id=None` (single-engine redelivery after a
        restart is the same mechanism); heartbeats and metric labels
        are fleet-mode only, keeping the standalone metric schema
        byte-identical.

        Elastic serving: `batch_policy` selects the reader's
        micro-batching controller — "adaptive" (default) plans each
        dispatch from the live per-bucket cost model and the oldest
        queued record's `deadline_ms` budget (no deadline configured ⇒
        behaves exactly like the legacy policy; with `slo.latency_ms`
        set the deadline defaults to it), "fixed" is the legacy
        straggler sweep, "static" always pads to the largest reachable
        bucket (the bench A/B strawman). `admission_tiers` (lowest
        priority first) makes the reader tier-aware: records carry a
        tier name in `admission_field`, higher tiers dispatch first,
        and past `shed_backlog` stream depth the reader sheds
        lowest-tier records with an explicit "SHED" result (committed
        and acked — an answered rejection, never a silent drop; the
        top tier is never shed). The stack's own producers (frontend,
        `InputQueue`) always write the native "tier" record key;
        `admission_field` points the reader at a FOREIGN producer's
        spelling, with "tier" kept as the fallback so mixed traffic
        never inverts priorities.

        Partitioned request plane: `partitions` shards the
        stream N ways (`<stream>.p<i>`, records routed by uri hash —
        see serving/partitions.py). The engine owns a partition SET via
        a lease table in the broker; the reader renews/acquires/sheds
        leases inline (paced like the claim sweep) and round-robins
        reads across the streams it owns. Lease expiry generalizes the
        record claim sweep from records to whole partitions: a dead
        peer's partitions move here after `partition_lease_ttl_s` of
        silence, then its unacked records redeliver through the
        ordinary per-stream sweep. `partitions=1` (default) keeps the
        legacy single-stream behavior byte-identical. Changing the
        count against a live lease table is refused unless `reshard`
        is set (records already routed under the old count would
        strand).

        Fleet observability plane: `trace_sample` > 0 turns
        on cross-process tracing — the engine continues each stamped
        record's trace (a "wire" span from the client's ingest
        timestamp to the reader claim, then the existing stage spans
        plus "device"/"writeback"), embeds a compact per-hop timing
        summary in every result row, and a `SpanExporter` ships the
        head-sampled window (plus force-sampled failed / SLO-violating
        requests) into the `traces:<stream>` broker hash every
        `trace_export_interval_s` for gateway-side assembly. The local
        span ring is bounded at `trace_buffer_spans`. Independently,
        a fleet engine (`engine_id` set) publishes its full registry
        snapshot into `metrics:<stream>` every
        `fleet_metrics_interval_s` (0 disables) so a gateway scrape
        aggregates the whole fleet."""
        self.model = model
        self.broker = broker if isinstance(broker, Broker) \
            else connect_broker(broker)
        self.registry = registry if registry is not None else get_registry()
        # the reader sits in a blocking read for up to ~50ms per cycle
        # and the sink writes results concurrently: on single-socket
        # transports each needs its own connection, and the caller's
        # broker stays free for frontends/clients sharing it. Both wear
        # a circuit breaker: a dead broker fast-fails instead of paying
        # a connect timeout per pipeline cycle.
        if pipelined:
            # a caller may already hand us a ResilientBroker — wrap its
            # INNER transport rather than double-wrapping (two breakers
            # would fight and the broker.<op> fault points would fire
            # twice per call)
            base = self.broker.inner \
                if isinstance(self.broker, ResilientBroker) else self.broker
            self.reader_broker: Broker = ResilientBroker(
                base.clone(), role="reader",
                breaker=CircuitBreaker(
                    "reader", failure_threshold=breaker_failure_threshold,
                    reset_timeout_s=breaker_reset_s,
                    registry=self.registry))
            self.sink_broker: Broker = ResilientBroker(
                base.clone(), role="sink",
                breaker=CircuitBreaker(
                    "sink", failure_threshold=breaker_failure_threshold,
                    reset_timeout_s=breaker_reset_s,
                    registry=self.registry))
        else:
            self.reader_broker = self.broker
            self.sink_broker = self.broker
        self.stream = stream
        # e.g. "topN(5)" — the reference's PostProcessing filter grammar;
        # validated here so a bad spec fails at construction, not as
        # per-record NaNs mid-stream
        if output_filter is not None:
            from analytics_zoo_tpu_torch.serving.pre_post import apply_filter
            apply_filter(np.zeros(2, np.float32), output_filter)
        self.output_filter = output_filter
        self.result_key = f"result:{stream}"
        self.batch_size = batch_size
        self.batch_timeout_ms = batch_timeout_ms
        # fleet identity: the engine id doubles as the consumer-group
        # consumer name, so XPENDING/XAUTOCLAIM attribute in-flight work
        # to a nameable engine (a fresh uuid per restart would orphan
        # nothing — claims go by idle time — but operators read these)
        self.engine_id = engine_id
        self.consumer = engine_id or new_consumer_name()
        self._labels = {"engine": engine_id} if engine_id else {}
        # serving precision: a NON-default dtype (int8
        # quantized serving, bf16 weights) labels every serving_*
        # series and span this engine publishes, same convention as the
        # fleet `engine` label — the default-f32 schema stays
        # byte-identical, and an int8-vs-bf16 A/B separates by label
        self.serving_dtype = getattr(model, "serving_dtype", "float32")
        if self.serving_dtype != "float32":
            self._labels["serving_dtype"] = self.serving_dtype
        self.claim_min_idle_s = float(claim_min_idle_s)
        self.claim_interval_s = float(claim_interval_s)
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        # partitioned request plane
        from analytics_zoo_tpu_torch.serving.partitions import (
            PartitionLeaseTable, validate_partitions)
        self.partitions = validate_partitions(partitions)
        self.lease_table = None
        if self.partitions > 1:
            if not pipelined:
                raise ValueError(
                    "partitions > 1 needs the pipelined engine (the "
                    "legacy serve_once loop reads one stream)")
            if engine_id is None:
                raise ValueError(
                    "partitions > 1 needs an engine_id: partition "
                    "leases are owned by a nameable engine")
            # lease I/O rides the reader's broker connection: polls run
            # in the reader thread (paced like the claim sweep) and the
            # final release runs after the reader joins — never two
            # threads on one socket
            self.lease_table = PartitionLeaseTable(
                self.reader_broker, stream, self.partitions,
                owner=engine_id, ttl_s=partition_lease_ttl_s,
                registry=self.registry)
            # the resharding gate: refuse a partition count that
            # disagrees with the live lease table unless the operator
            # explicitly asked to reshard
            self.lease_table.ensure_meta(reshard=reshard)
        self._lease_poll_s = max(0.05, float(partition_lease_ttl_s) / 3.0)
        self._killed = False
        self.pipelined = pipelined
        self.zero_copy_decode = zero_copy_decode
        self.decode_workers = max(1, decode_workers)
        self.queue_depth = max(1, queue_depth)
        # versioned serving: which checkpoint version the
        # model currently serves (None = unversioned weights). The
        # rollout agent advances it AFTER a successful canary, and the
        # heartbeat row carries it — reporting the new version IS the
        # engine's "converted" signal to the rollout controller.
        self.model_version = model_version
        self._stop = threading.Event()
        # intake pause (rollout drain): while set, the reader neither
        # reads nor claim-sweeps — in-hand work flows out, the broker
        # queues (or peers drain) new work, and a swap sees no mixed-
        # version batches
        self._intake_paused = threading.Event()
        self._threads: List[threading.Thread] = []
        self._decode_q: "queue.Queue" = queue.Queue(maxsize=self.queue_depth)
        self._dispatch_q: "queue.Queue" = queue.Queue(
            maxsize=self.queue_depth)
        self._sink_q: "queue.Queue" = queue.Queue(maxsize=self.queue_depth)
        self.batch_timer = Timer("batch")          # end-to-end per batch
        self.decode_timer = Timer("decode")
        self.dispatch_timer = Timer("dispatch")
        self.sink_timer = Timer("sink")
        self.records_served = 0
        self.records_read = 0
        self._counter_lock = threading.Lock()
        self.tracer = tracer
        # reconnect backoff for the reader loop (capped exponential with
        # jitter — replaces the fixed 1s warn-loop)
        self.reader_backoff = BackoffPolicy()
        # failed sink writebacks, oldest first: (mapping, ids, t0, t_work)
        # entries awaiting a live broker. Sink-thread-only; the registry
        # gauge reads len() which is safe anywhere.
        self.sink_buffer_batches = max(1, int(sink_buffer_batches))
        self._wb_buffer: "collections.deque" = collections.deque()
        self._sink_down = False
        # record ids this engine has read/claimed but not yet acked:
        # the claim sweep (and the in-process brokers' redelivery
        # window) must not hand the engine its OWN in-flight work back
        # while a slow batch computes. Reader adds, sink removes on ack
        # — and on shed, where redelivery (to a peer) is the contract.
        self._inflight_ids: set = set()
        self._inflight_lock = threading.Lock()
        self.probe_interval_s = probe_interval_s
        self._wire_registry()
        self.slo = None
        if slo is not None:
            from analytics_zoo_tpu_torch.observability.slo import (
                SLOObjectives, SLOTracker)
            objectives = slo if isinstance(slo, SLOObjectives) \
                else SLOObjectives(**slo)
            if not objectives.empty:
                self.slo = SLOTracker(objectives, registry=self.registry)
        # adaptive micro-batching: the controller that
        # replaces the fixed batch_size/batch_timeout_ms policy. With no
        # explicit deadline the SLO latency objective (what the operator
        # already promised) is the natural budget.
        from analytics_zoo_tpu_torch.serving.elastic import (
            AdaptiveBatchController, TierTable)
        if deadline_ms is None and self.slo is not None \
                and self.slo.objectives.latency_ms is not None:
            deadline_ms = self.slo.objectives.latency_ms
        self.batcher = AdaptiveBatchController(
            self.model.buckets, self.batch_size, self.batch_timeout_ms,
            policy=batch_policy, deadline_ms=deadline_ms,
            margin_ms=batch_margin_ms, registry=self.registry,
            labels=self._labels)
        # tiered admission: reader-side tier ordering + shed
        self.admission_field = admission_field
        self.tier_table = None
        if admission_tiers:
            self.tier_table = admission_tiers \
                if isinstance(admission_tiers, TierTable) \
                else TierTable(admission_tiers)
        self.shed_backlog = int(shed_backlog) if shed_backlog else None
        self._admission_out = self.registry.counter(
            "serving_admission_total",
            "admission decisions by outcome (accepted, rejected, shed) "
            "and tier")
        # rate-limited backlog probe (reader thread only)
        self._backlog_cache: Optional[int] = None
        self._backlog_t = 0.0
        self.supervisor = None
        if supervise and self._multi_replica:
            from analytics_zoo_tpu_torch.serving.supervisor import \
                ReplicaSupervisor
            self.supervisor = ReplicaSupervisor(
                model, failure_threshold=failure_threshold,
                latency_factor=latency_factor,
                latency_floor_ms=latency_floor_ms,
                probe_interval_s=probe_interval_s,
                registry=self.registry)
        # fleet heartbeat: its own broker connection — the
        # reader sits in XREADGROUP block windows and the sink may be
        # mid-writeback; membership must never queue behind either
        self.heartbeat = None
        if engine_id is not None and self.heartbeat_interval_s > 0:
            from analytics_zoo_tpu_torch.serving.fleet import \
                HeartbeatPublisher
            base = self.broker.inner \
                if isinstance(self.broker, ResilientBroker) else self.broker
            self.heartbeat = HeartbeatPublisher(
                base.clone(), self.stream, engine_id,
                self._heartbeat_payload,
                interval_s=self.heartbeat_interval_s,
                registry=self.registry)
        # fleet observability plane: span exporter + fleet
        # metrics publisher, each on its OWN broker connection — the
        # reader blocks in XREADGROUP windows and the sink may be
        # mid-writeback; telemetry must never queue behind either
        if not 0.0 <= float(trace_sample) <= 1.0:
            raise ValueError(
                f"trace_sample must be in [0, 1], got {trace_sample}")
        self.trace_sample = float(trace_sample)
        self.trace_exporter = None
        self.fleet_metrics = None
        obs_base = self.broker.inner \
            if isinstance(self.broker, ResilientBroker) else self.broker
        if self.trace_sample > 0:
            if self.tracer is None:
                self.tracer = Tracer(max_spans=int(trace_buffer_spans),
                                     registry=self.registry,
                                     engine=self.consumer)
            elif self.tracer.engine is None:
                self.tracer.engine = self.consumer
            from analytics_zoo_tpu_torch.serving.trace_plane import \
                SpanExporter
            self.trace_exporter = SpanExporter(
                obs_base.clone(), self.stream, self.consumer,
                self.tracer, sample=self.trace_sample,
                interval_s=float(trace_export_interval_s),
                buffer_spans=int(trace_buffer_spans),
                registry=self.registry)
        if engine_id is not None and float(fleet_metrics_interval_s) > 0:
            from analytics_zoo_tpu_torch.serving.fleet_metrics import \
                FleetMetricsPublisher
            self.fleet_metrics = FleetMetricsPublisher(
                obs_base.clone(), self.stream, engine_id, self.registry,
                interval_s=float(fleet_metrics_interval_s))

    def _heartbeat_payload(self) -> dict:
        """What each beat tells the gateway: readiness (the same
        aggregation /healthz would compute locally) plus the throughput
        counters a fleet dashboard sums — and, with SLO objectives
        configured, the engine's current burn rate, which is the
        autoscaler's scale-up signal."""
        h = self.health()
        out = {"ready": bool(h.get("ready")),
               "healthy_replicas": h.get("healthy_replicas"),
               "records_served": self.records_served,
               "records_read": self.records_read}
        if self.model_version is not None:
            # the rollout controller's convergence signal:
            # an engine reports a new version ONLY after the swap's
            # canary passed — the beat is the commit
            out["model_version"] = self.model_version
        if self.lease_table is not None:
            # the gateway's partition-coverage view: which
            # partitions this engine reads right now — summed across
            # beats, an operator sees holes before clients do
            out["partitions_owned"] = self.lease_table.owned()
        slo = h.get("slo")
        if isinstance(slo, dict):
            burns = [v.get("burn_rate", 0.0) for v in slo.values()
                     if isinstance(v, dict) and "burn_rate" in v]
            if burns:
                out["slo_burn"] = max(burns)
            out["slo_met"] = bool(slo.get("met", True))
        return out

    def _wire_registry(self):
        """Mirror the engine's private Timers into the process-wide
        registry (the telemetry spine): per-stage histograms via Timer
        observers, record counters by outcome, and live queue-depth
        gauges evaluated at snapshot/scrape time."""
        reg = self.registry
        stage_hist = reg.histogram(
            "serving_stage_ms",
            "per-stage serving pipeline duration (decode, dispatch, sink, "
            "predict)")
        batch_hist = reg.histogram(
            "serving_batch_ms",
            "end-to-end latency per pipeline batch, broker read to result "
            "writeback")
        self._records_total = reg.counter(
            "serving_records_total",
            "records through the serving engine, by outcome (read, "
            "served, failed, duplicate, shed)")
        # multi-device router telemetry: families register unconditionally
        # (stable /metrics schema); series appear only when a replica pool
        # is actually routing, so single-replica output stays unchanged
        self._replica_batches = reg.counter(
            "serving_replica_batches_total",
            "batches dispatched to each model replica, by replica index")
        replica_gauge = reg.gauge(
            "serving_replica_inflight",
            "routed-but-unmaterialized batches per model replica (live)")
        # every closure this engine installs is remembered so stop() can
        # compare-and-release exactly these — never a newer engine's
        self._gauge_installs = []       # (gauge, fn, labels, freeze)
        self._multi_replica = getattr(self.model, "num_replicas", 1) > 1
        if self._multi_replica:
            for i in range(self.model.num_replicas):
                fn = (lambda _i=i: self.model.replica_inflight(_i))
                replica_gauge.set_function(fn, replica=str(i))
                self._gauge_installs.append(
                    (replica_gauge, fn, {"replica": str(i)}, False))
        # fleet mode threads the engine id through every serving series
        # (self._labels is {} standalone, so the default schema is
        # byte-identical); a fleet-aggregate view is the label-summed
        # family, a per-engine view is one series
        labels = self._labels
        for timer, stage in ((self.decode_timer, "decode"),
                             (self.dispatch_timer, "dispatch"),
                             (self.sink_timer, "sink")):
            timer.add_observer(
                lambda s, _st=stage: stage_hist.observe(
                    s * 1e3, stage=_st, **labels))
        self.batch_timer.add_observer(
            lambda s: batch_hist.observe(s * 1e3, **labels))
        # the model (and its predict Timer) may outlive/be shared across
        # ClusterServing instances — attach the mirror exactly once.
        # Fleet mode labels the predict series like every other stage
        # (the fleet aggregator needs per-engine attribution); the
        # standalone schema stays byte-identical.
        if not getattr(self.model.timer, "_registry_mirrored", False):
            self.model.timer.add_observer(
                lambda s, _l=dict(labels): stage_hist.observe(
                    s * 1e3, stage="predict", **_l))
            self.model.timer._registry_mirrored = True
        qd = reg.gauge("serving_queue_depth",
                       "live depth of each inter-stage pipeline queue")
        for q, fn in (("decode", self._decode_q.qsize),
                      ("dispatch", self._dispatch_q.qsize),
                      ("sink", self._sink_q.qsize)):
            qd.set_function(fn, queue=q)
            # frozen (not removed) on stop: post-run readers (the bench)
            # still see the drained depths
            self._gauge_installs.append((qd, fn, {"queue": q}, True))
        # fleet telemetry: cross-engine redelivery + the
        # idempotent-writeback duplicate ledger
        self._claimed_records = reg.counter(
            "serving_claimed_records_total",
            "stale pending records claimed from dead peer consumers by "
            "this engine's claim sweep")
        # fault-tolerance telemetry
        self._reconnects = reg.counter(
            "serving_broker_reconnects_total",
            "successful broker reconnects after an outage, by role")
        self._shed_records = reg.counter(
            "serving_sink_shed_records_total",
            "result records shed from the sink's writeback buffer at "
            "its bound (unacked; the broker redelivers them)")
        wb_gauge = reg.gauge(
            "serving_sink_buffered_batches",
            "writeback batches buffered while the broker is down (live)")
        wb_fn = (lambda buf=self._wb_buffer: len(buf))
        wb_gauge.set_function(wb_fn)
        self._gauge_installs.append((wb_gauge, wb_fn, {}, True))
        # quantized serving: the honest weight-byte price
        # per precision — an int8 model reads ~4x under its f32 source
        # here, which is the HBM-bandwidth story behind the speedup
        weight_fn = getattr(self.model, "weight_bytes", None)
        if callable(weight_fn):
            wtg = reg.gauge(
                "serving_weight_bytes",
                "logical bytes of the served model's weight leaves, "
                "labeled by serving dtype (int8 quantization prices "
                "weights at 1 byte/element)")
            # engine label included like every other serving_* series
            # (fleet aggregation must separate per-engine weight bytes)
            wlabels = dict(self._labels,
                           serving_dtype=self.serving_dtype)
            wtg.set_function(weight_fn, **wlabels)
            self._gauge_installs.append((wtg, weight_fn, wlabels, True))
        # versioned serving: the live checkpoint version.
        # Family registers unconditionally (stable schema); the series
        # appears only once a versioned model serves, value = version
        # number — a scrape sees the fleet converge as every engine's
        # series reaches the same value
        self._version_gauge = reg.gauge(
            "serving_model_version",
            "checkpoint version this engine currently serves (value is "
            "the version number; absent for unversioned weights)")
        if self.model_version is not None:
            self._version_gauge.set(float(self.model_version),
                                    **self._labels)

    def _enqueue(self, q: "queue.Queue", batch: _Batch):
        """Stamp the enqueue time (the consumer's queue-wait span starts
        here — a blocking put under backpressure counts as wait) and put.
        The put blocks in bounded slices (the backpressure contract is
        unchanged — drain still clears it) so a wedged consumer is a
        visible timed loop, never an unbounded block."""
        batch.t_enq = time.perf_counter()
        while True:
            try:
                q.put(batch, timeout=0.25)
                return
            except queue.Full:
                continue

    # -- health (frontend 503 gate + supervisor view) ----------------------
    def healthy_replicas(self) -> Optional[int]:
        """Replicas currently accepting work; None when the model has no
        notion of health (a duck-typed model without the pool API)."""
        fn = getattr(self.model, "healthy_replicas", None)
        return fn() if callable(fn) else None

    @property
    def retry_after_s(self) -> int:
        """What a 503 should tell clients: revival happens on the canary
        probe cadence, so retrying sooner than that is wasted."""
        return max(1, int(round(self.probe_interval_s + 0.5)))

    def health(self) -> dict:
        """Readiness aggregation for `/healthz`: the engine is
        READY when its stage threads run, at least one replica accepts
        work, and neither broker breaker is open. SLO status rides along
        in the payload (a burning error budget is an alarm, not a
        reason to eject the pod from rotation — operators page on
        `slo_burn_rate`, load balancers act on `ready`)."""
        healthy = self.healthy_replicas()
        replicas_ok = healthy is None or healthy > 0
        breakers = {}
        breakers_ok = True
        for role, br in (("reader", self.reader_broker),
                         ("sink", self.sink_broker)):
            breaker = getattr(br, "breaker", None)
            if breaker is not None:
                state = breaker.state
                breakers[role] = state
                breakers_ok = breakers_ok and state != "open"
        running = bool(self._threads) and not self._stop.is_set() \
            and self.is_alive()
        out = {
            "ready": bool(running and replicas_ok and breakers_ok),
            "running": running,
            "healthy_replicas": healthy,
            "breakers": breakers,
        }
        if self.model_version is not None:
            out["model_version"] = self.model_version
        if not running:
            out["reason"] = "engine not running"
        elif not replicas_ok:
            out["reason"] = "every model replica is quarantined"
        elif not breakers_ok:
            out["reason"] = "broker circuit open"
        if self.supervisor is not None:
            out["supervisor"] = self.supervisor.stats()
        if self.slo is not None:
            try:
                out["slo"] = self.slo.evaluate()
            except Exception:  # noqa: BLE001 — health must always answer
                out["slo"] = None
        return out

    # -- rollout hooks ------------
    def set_model_version(self, version: int):
        """Advance the served version (rollout agent, post-canary): the
        gauge and the next heartbeat both report it — the heartbeat is
        what tells the controller this engine converted."""
        self.model_version = int(version)
        self._version_gauge.set(float(version), **self._labels)

    def pause_intake(self):
        """Stop the reader pulling NEW work (reads and claim sweeps);
        everything already in hand keeps flowing to the sink. The
        broker buffers — or, in a fleet, live peers drain — what
        arrives meanwhile. The rollout agent's drain barrier."""
        self._intake_paused.set()

    def resume_intake(self):
        self._intake_paused.clear()

    def quiesce(self, timeout_s: float = 10.0) -> bool:
        """Block (bounded) until every record this engine has read is
        committed — in-flight set empty and the stage queues drained.
        Call after `pause_intake()`; True = the pipeline is empty and a
        swap sees no mixed-version batch. False (timeout / engine
        stopping) means the caller may still swap: a batch dispatched
        pre-swap holds its own params reference, so the tail of the
        old version simply finishes on the old weights."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        while time.monotonic() < deadline:
            with self._inflight_lock:
                inflight = len(self._inflight_ids)
            if inflight == 0 and self._decode_q.empty() \
                    and self._dispatch_q.empty() and self._sink_q.empty():
                return True
            if self._stop.wait(0.02):
                return False
        return False

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ClusterServing":
        if self.supervisor is not None:
            self.supervisor.start()
        if self.slo is not None:
            # self-driving evaluation: violation detection must not
            # depend on an external scrape happening more often than
            # the SLO window
            self.slo.start_auto()
        if self.pipelined:
            specs = [("serving-reader", self._reader_loop)]
            specs += [(f"serving-decode-{i}", self._decode_loop)
                      for i in range(self.decode_workers)]
            specs += [("serving-dispatch", self._dispatch_loop),
                      ("serving-sink", self._sink_loop)]
            for name, target in specs:
                t = threading.Thread(target=target, name=name, daemon=True)
                t.start()
                self._threads.append(t)
        else:
            t = threading.Thread(target=self.run, daemon=True)
            t.start()
            self._threads.append(t)
        if self.heartbeat is not None:
            # after the stage threads: the first beat already reports
            # ready=True instead of a one-interval false negative
            self.heartbeat.start()
        if self.trace_exporter is not None:
            self.trace_exporter.start()
        if self.fleet_metrics is not None:
            self.fleet_metrics.start()
        return self

    def is_alive(self) -> bool:
        """True while every stage thread is still running."""
        return bool(self._threads) and all(
            t.is_alive() for t in self._threads)

    def stop(self):
        """Drain and join: each stage is poisoned only after every thread
        feeding it has exited, so work already read from the broker flows
        through to the sink before shutdown."""
        self._stop.set()
        if self.heartbeat is not None:
            # first: deregister from the fleet so the gateway routes
            # around this engine before its drain even starts
            self.heartbeat.stop(deregister=True)
        if self.slo is not None:
            self.slo.stop_auto()
        if self.supervisor is not None:
            # first: a mid-drain revival would reshuffle routing under
            # the draining dispatcher for no benefit
            self.supervisor.stop()
        if not self.pipelined:
            for t in self._threads:
                t.join(timeout=10)
            self._threads = []
            self._unwire_gauges()
            return
        readers = [t for t in self._threads if "reader" in t.name]
        decoders = [t for t in self._threads if "decode" in t.name]
        dispatchers = [t for t in self._threads if "dispatch" in t.name]
        sinks = [t for t in self._threads if "sink" in t.name]
        for t in readers:
            t.join(timeout=10)
        if self.lease_table is not None:
            # after the reader joins (its thread owns the lease broker
            # connection): give the partitions back so peers rebalance
            # now instead of waiting out the ttl
            try:
                self.lease_table.release()
            except Exception:  # noqa: BLE001 — peers expire the leases
                pass
        self._poison(self._decode_q, len(decoders))
        for t in decoders:
            t.join(timeout=10)
        self._poison(self._dispatch_q, len(dispatchers))
        for t in dispatchers:
            t.join(timeout=10)
        self._poison(self._sink_q, len(sinks))
        for t in sinks:
            t.join(timeout=10)
        self._threads = []
        self._unwire_gauges()
        # observability plane: final flush AFTER the sink joined (the
        # last batch's spans and counters are in), BEFORE the broker
        # handles close
        if self.trace_exporter is not None:
            self.trace_exporter.stop(flush=True)
        if self.fleet_metrics is not None:
            self.fleet_metrics.stop(flush=True)
        hb_broker = self.heartbeat.broker if self.heartbeat else None
        te_broker = self.trace_exporter.broker \
            if self.trace_exporter else None
        fm_broker = self.fleet_metrics.broker \
            if self.fleet_metrics else None
        for br in (self.reader_broker, self.sink_broker, hb_broker,
                   te_broker, fm_broker):
            if br is not None and br is not self.broker \
                    and hasattr(br, "close"):
                try:
                    br.close()
                except Exception:  # noqa: BLE001 — shutdown best effort
                    pass

    def kill(self):
        """Crash analogue for chaos tests: stop every stage
        WITHOUT the drain, the heartbeat deregistration, or the lease
        release a clean `stop()` performs. Work in hand is abandoned
        uncommitted — its records stay in the broker PEL and this
        engine's partition leases sit in the table until they age out,
        exactly the state a SIGKILLed engine leaves behind for peer
        takeover (lease expiry + claim sweep) to recover."""
        self._killed = True
        self._stop.set()
        if self.heartbeat is not None:
            self.heartbeat.stop(deregister=False)
        # no flush: a SIGKILLed process publishes nothing on the way
        # out — whatever the last interval shipped is what survives
        if self.trace_exporter is not None:
            self.trace_exporter.stop(flush=False)
        if self.fleet_metrics is not None:
            self.fleet_metrics.stop(flush=False)
        if self.slo is not None:
            self.slo.stop_auto()
        if self.supervisor is not None:
            self.supervisor.stop()
        for q in (self._decode_q, self._dispatch_q, self._sink_q):
            self._poison(q, self.decode_workers + 2)
        for t in self._threads:
            t.join(timeout=10)
        self._threads = []
        if self.lease_table is not None:
            # unhook the local gauge only; the broker rows are the
            # corpse the takeover path must find
            self.lease_table.abandon()
        self._unwire_gauges()

    def _unwire_gauges(self):
        """Post-drain registry cleanup (runs AFTER the stage joins, so
        values reflect the drained engine, not a mid-drain snapshot):
        every closure this engine installed is compare-and-released —
        left in the process-wide registry they would pin this engine
        (the replica closures hold N device-resident param copies) for
        the process lifetime and keep exporting series that read a
        stopped engine, while a series a NEWER engine has since claimed
        is left alone. Replica series disappear; queue depths freeze at
        their drained values for post-run readers (the bench)."""
        installs, self._gauge_installs = self._gauge_installs, []
        for gauge, fn, labels, freeze in installs:
            gauge.release_function(fn, freeze=freeze, **labels)

    @staticmethod
    def _poison(q: "queue.Queue", n: int):
        """Deliver `n` stop pills without ever wedging stop(): if the
        queue stays full (its consumer is stuck, e.g. a stalled device
        under dispatch), drop queued work and keep trying for a bounded
        window — unacked records redeliver, and a bounded shutdown beats
        the drain guarantee once a stage is already wedged."""
        for _ in range(n):
            deadline = time.monotonic() + 5.0
            while True:
                try:
                    q.put(_STOP, timeout=0.25)
                    break
                except queue.Full:
                    if time.monotonic() > deadline:
                        break
                    try:
                        dropped = q.get_nowait()
                    except queue.Empty:
                        pass
                    else:
                        # a dropped batch may hold a routed pending whose
                        # replica permit only releases on consumption —
                        # abandon it (records redeliver; the permit must
                        # not leak into the engine-outliving model)
                        abandon = getattr(
                            getattr(dropped, "pending", None),
                            "abandon", None)
                        if abandon is not None:
                            abandon()

    def _filter_inflight(self, records, stream=None):
        """Drop records this engine already holds un-acked (its own
        slow in-flight work coming back through the claim sweep or a
        redelivery window) and register the rest. The sink releases ids
        on ack — and on shed, where redelivering (ideally to a peer)
        is exactly the contract. Ids key by (stream, rid): partition
        streams assign record ids independently, so a bare rid is not
        unique across the partition set."""
        if not records:
            return []
        stream = stream or self.stream
        out = []
        with self._inflight_lock:
            for rid, rec in records:
                if (stream, rid) in self._inflight_ids:
                    continue
                self._inflight_ids.add((stream, rid))
                out.append((rid, rec))
        return out

    def _release_inflight(self, ids, stream=None):
        stream = stream or self.stream
        with self._inflight_lock:
            self._inflight_ids.difference_update(
                (stream, rid) for rid in ids)

    def _read_streams(self) -> List[str]:
        """The streams this engine reads right now: the single base
        stream, or (partitioned) the set it currently holds leases on
        — possibly empty while a newcomer waits for incumbents to shed
        its fair share."""
        if self.lease_table is None:
            return [self.stream]
        return self.lease_table.owned_streams()

    def _stream_backlog(self) -> Optional[int]:
        """Rate-limited broker stream depth MINUS this engine's own
        in-flight records (the stream keeps a record until sink commit,
        so raw depth would read our own pipeline back as other
        people's load and misclassify a light trickle as heavy — the
        adaptive batcher would then re-add the padding wait it exists
        to remove). Partitioned engines sum across the streams they
        own — the load THIS engine must plan for. Reader-thread only.
        None = unknown (transport without XLEN, or a mid-outage read)
        — the controller then plans conservatively."""
        now = time.monotonic()
        if now - self._backlog_t >= 0.2:
            self._backlog_t = now
            try:
                depth = sum(int(self.reader_broker.stream_depth(s))
                            for s in self._read_streams())
            except Exception:  # noqa: BLE001 — load signal, not a fault
                depth = None
            self._backlog_cache = depth
        if self._backlog_cache is None:
            return None
        with self._inflight_lock:
            own = len(self._inflight_ids)
        return max(0, self._backlog_cache - own)

    def _tier_order_and_shed(self, records, t0, src=None):
        """Tiered scheduling in the reader: higher-tier
        records decode and dispatch first (a stable sort — FIFO within
        a tier), and under overload (stream depth past `shed_backlog`)
        the lowest-tier records in hand are shed with an explicit
        "SHED" result — committed and acked through the normal sink
        path, so the client gets an answer instead of a timeout and the
        record never redelivers to eat capacity twice. The top tier is
        never shed: a fleet drowning in premium traffic scales (the
        autoscaler's job), it does not drop."""
        levels = [self.tier_table.level(
            (rec.get(self.admission_field) or rec.get("tier"))
            if isinstance(rec, dict) else None)
            for _rid, rec in records]
        order = sorted(range(len(records)), key=lambda i: -levels[i])
        records = [records[i] for i in order]
        levels = [levels[i] for i in order]
        if self.shed_backlog is None:
            return records
        backlog = self._stream_backlog()
        if backlog is None or backlog <= self.shed_backlog:
            return records
        lowest = min(levels)
        if lowest >= self.tier_table.top:
            return records
        keep, shed = [], []
        for (rid, rec), lvl in zip(records, levels):
            (shed if lvl == lowest else keep).append((rid, rec))
        if shed:
            tier = self.tier_table.name(lowest)
            self._admission_out.inc(len(shed), outcome="shed",
                                    tier=tier, **self._labels)
            log.warning(
                "overload (backlog %d > %d): shedding %d %r-tier "
                "record(s) with SHED results", backlog,
                self.shed_backlog, len(shed), tier)
            self._enqueue(self._sink_q, _Batch(
                [rid for rid, _ in shed],
                [rec.get("uri", rid) if isinstance(rec, dict)
                 else str(rid) for rid, rec in shed],
                None, t0, shed=True, stream=src))
        return keep

    def _trace_wire(self, records):
        """Continue the client's trace context: a record
        stamped with ``{"trace": {"ts": <wall>}}`` gets a "wire" span
        from its client-side ingest to this reader's claim. Duration
        comes from wall-clock DELTA on both ends (skew-bounded by
        `max(0, ...)`); the collector re-anchors it against the
        engine's minimum observed delta, so cross-host skew cancels
        instead of corrupting the merged timeline."""
        t_read = time.perf_counter()
        wall = time.time()
        for rid, rec in records:
            if not isinstance(rec, dict):
                continue
            ctx = rec.get("trace")
            if not isinstance(ctx, dict):
                continue
            try:
                t_ing = float(ctx["ts"])
            except (KeyError, TypeError, ValueError):
                continue
            d = max(0.0, wall - t_ing)
            args: Dict[str, Any] = {"t_ingest": t_ing,
                                    "t_read_wall": wall}
            if ctx.get("parent"):
                args["parent"] = ctx["parent"]
            if self._labels:
                args.update(self._labels)
            self.tracer.add_span(
                "wire", t_read - d, t_read,
                trace_id=rec.get("uri", str(rid)),
                cat="serving.wire", args=args)

    # -- stage: reader -----------------------------------------------------
    def _reader_loop(self):
        # idle wait is LONG (an XADD wakes a blocked XREADGROUP
        # immediately, so latency doesn't suffer): a short block here
        # would hammer the broker with nil reads that contend with the
        # sink's writes and the clients' polls for the whole run
        idle_block = max(self.batch_timeout_ms, 50)
        failures = 0
        last_logged = None         # (breaker state) at last warning
        # claim pacing is PER STREAM: one global clock aliases against
        # the rotation when the rotation period divides the claim
        # interval (2 owned streams x half the idle block == exactly
        # claim_interval_s), and every sweep then lands on the SAME
        # partition — a dead peer's other partitions never drain
        next_claim: Dict[str, float] = {}
        first_claim = time.monotonic() + self.claim_interval_s
        next_lease = 0.0           # first pass acquires immediately
        rr = 0                     # round-robin cursor over owned streams
        while not self._stop.is_set():
            # partition lease upkeep, BEFORE the pause gate:
            # a rollout drain must keep renewing or the pause itself
            # would forfeit this engine's partitions to its peers
            if self.lease_table is not None \
                    and time.monotonic() >= next_lease:
                next_lease = time.monotonic() + self._lease_poll_s
                try:
                    self.lease_table.poll()
                except Exception as e:  # noqa: BLE001 — ttl absorbs it
                    log.warning(
                        "partition lease poll failed (%s: %s); "
                        "retrying next interval", type(e).__name__, e)
            if self._intake_paused.is_set():
                # rollout drain: no reads, no claim sweeps —
                # in-hand work flows out while the swap waits on
                # quiesce(); a timed wait so stop() still cuts through
                self._stop.wait(0.05)
                continue
            streams = self._read_streams()
            if not streams:
                # newcomer awaiting its fair share: the next lease poll
                # acquires what incumbents shed
                self._stop.wait(0.05)
                continue
            # one source stream per cycle (rotating): a read batch —
            # and every _Batch cut from it — belongs to exactly one
            # partition, so the sink acks against the right PEL. The
            # idle block splits across owned streams to keep worst-case
            # first-byte latency at one full block window.
            src = streams[rr % len(streams)]
            rr += 1
            block = idle_block if len(streams) == 1 \
                else max(5, idle_block // len(streams))
            try:
                records = self.reader_broker.read_group(
                    src, GROUP, self.consumer, self.batch_size,
                    block_ms=block)
                if failures:
                    # back from an outage: ONE info line + the counter,
                    # mirroring the one-warning-per-transition cap below
                    self._reconnects.inc(role="reader")
                    log.info("reader reconnected after %d failed "
                             "attempt(s)", failures)
                    failures = 0
                    last_logged = None
                if time.monotonic() >= next_claim.get(src, first_claim):
                    # stale-pending claim sweep: a killed
                    # peer's delivered-but-unacked entries become this
                    # engine's work once idle past the claim window.
                    # Paced by the read block above (never a busy loop)
                    # and its OWN failure domain, like the straggler
                    # sweep: brokers without the claim op, or a claim
                    # that dies mid-outage, must not cost the records
                    # already in hand.
                    # partitioned engines sweep the cycle's source
                    # stream (per-stream pacing covers the set; takeover
                    # of a dead peer's WHOLE partition is the lease
                    # table's job, after which this sweep drains its PEL)
                    next_claim[src] = time.monotonic() \
                        + self.claim_interval_s
                    try:
                        claimed = self.reader_broker.claim_stale(
                            src, GROUP, self.consumer,
                            int(self.claim_min_idle_s * 1000),
                            self.batch_size)
                    except NotImplementedError:
                        claimed = []
                    except Exception as e:  # noqa: BLE001 — keep batch
                        claimed = []
                        log.warning(
                            "claim sweep failed (%s: %s); retrying next "
                            "interval", type(e).__name__, e)
                    if claimed:
                        claimed = self._filter_inflight(claimed, src)
                    if claimed:
                        self._claimed_records.inc(len(claimed),
                                                  **self._labels)
                        log.info("claimed %d stale pending record(s) "
                                 "from dead peer consumer(s)",
                                 len(claimed))
                else:
                    claimed = []
                records = claimed + self._filter_inflight(records, src)
                if not records:
                    continue
                # adaptive accumulation: the controller plans how many records
                # this dispatch should carry and how long the reader may
                # keep collecting — under a tight deadline or an empty
                # backlog that is "none, dispatch now"; under load it is
                # "grow toward the throughput-optimal bucket". Collection
                # reads run in their OWN failure domain: a broker that
                # dies mid-sweep must not drop the records already in
                # hand into a redeliver loop.
                t_first = time.perf_counter()
                plan = self.batcher.plan(len(records), 0.0,
                                         self._stream_backlog())
                sweep_deadline = t_first + plan.wait_ms / 1e3
                while len(records) < plan.target:
                    remaining_ms = (sweep_deadline
                                    - time.perf_counter()) * 1e3
                    if remaining_ms <= 0:
                        break
                    try:
                        more = self._filter_inflight(
                            self.reader_broker.read_group(
                                src, GROUP, self.consumer,
                                plan.target - len(records),
                                block_ms=max(1, int(min(remaining_ms,
                                                        50)))), src)
                    except Exception as e:  # noqa: BLE001 — keep batch
                        log.warning(
                            "batch-collection read failed (%s: %s); "
                            "continuing with %d record(s) in hand",
                            type(e).__name__, e, len(records))
                        break
                    if more:
                        records += more
                        # replan: the budget shrinks as the oldest
                        # record ages, so this loop always terminates
                        age_ms = (time.perf_counter() - t_first) * 1e3
                        plan = self.batcher.plan(
                            len(records), age_ms, self._stream_backlog())
                        sweep_deadline = min(
                            sweep_deadline,
                            time.perf_counter() + plan.wait_ms / 1e3)
                with self._counter_lock:
                    self.records_read += len(records)
                self._records_total.inc(len(records), outcome="read",
                                        **self._labels)
                if self.tier_table is not None:
                    records = self._tier_order_and_shed(records, t_first,
                                                        src)
                    if not records:
                        continue
                if self.tracer is not None:
                    self._trace_wire(records)
                item = (t_first, records, src)
                while not self._stop.is_set():
                    try:
                        self._decode_q.put(item, timeout=0.25)
                        break
                    except queue.Full:
                        continue
                # stop while blocked: records stay unacked → redeliver
            except Exception as e:  # noqa: BLE001 — the Flink-restart role
                # transient broker failures (redis stall/restart) must
                # not kill the stage; the breaker owns fast-failing and
                # the backoff paces reconnect attempts. Log spam is
                # capped to one warning per breaker state transition.
                failures += 1
                breaker = getattr(self.reader_broker, "breaker", None)
                state = breaker.state if breaker is not None else None
                if state != last_logged:
                    log.warning(
                        "reader cycle failed (%s: %s); breaker %s, "
                        "backing off", type(e).__name__, e,
                        state or "n/a")
                    last_logged = state
                self._stop.wait(self.reader_backoff.delay(failures))

    # -- stage: decode -----------------------------------------------------
    def _decode_records(self, records):
        """Per-record decode straight into PREALLOCATED bucket-shaped
        batch buffers, shared by the pipelined decode stage and the
        legacy synchronous loop.

        Records group by (shape, dtype) read off the codec HEADER —
        no payload decode yet — then each group sizes ONE
        ``[bucket, *shape]`` buffer (`batcher.pad_bucket` — policy-aware;
        padding included)
        and every payload decodes directly into its row
        (`pre_post.decode_record_into`): the hot path allocates zero
        per-record ndarrays and the dispatch stage's separate np.stack
        pass is gone. Headerless codecs (arrow/image/list) decode
        first and pay one row copy — same cost as the old path.

        Returns ``(batches, failed)``: [(ids, uris, buf, n_real)] with
        rows [n_real:] pre-padded, plus the [(rid, uri)] records that
        failed to decode (degrade to "NaN")."""
        from analytics_zoo_tpu_torch.serving.pre_post import (
            decode_record_field, decode_record_into, record_meta)
        groups: dict = {}
        failed = []
        for rid, rec in records:
            try:
                data = rec["data"]
                # single-tensor fast path: field "t" or "image"
                field = "t" if "t" in data else (
                    "image" if "image" in data else next(iter(data)))
                value = data[field]
                meta = record_meta(value)
                if meta is None:
                    value = decode_record_field(value)
                    meta = (value.shape, value.dtype.str)
                groups.setdefault(meta, []).append((rid, rec["uri"],
                                                    value))
            except Exception as e:  # noqa: BLE001 — degrade per record
                # rec itself may be malformed (a foreign producer can
                # XADD any JSON): the failure path must not raise, or one
                # poison record would drop its whole read batch into a
                # redeliver loop
                uri = rec.get("uri", rid) if isinstance(rec, dict) \
                    else str(rid)
                log.warning("decode failure for %s: %s", uri, e)
                failed.append((rid, uri))
        batches = []
        for (shape, dtype), items in groups.items():
            bucket = self.batcher.pad_bucket(len(items))
            try:
                # header shape/dtype are UNTRUSTED producer input (a
                # foreign client can XADD shape [-1] or an absurd dim):
                # an allocation failure degrades THIS group to NaN —
                # well-formed records in other groups must still serve
                buf = np.empty((max(bucket, len(items)),) + tuple(shape),
                               np.dtype(dtype))
            except Exception as e:  # noqa: BLE001 — degrade per group
                for rid, uri, _ in items:
                    log.warning("decode failure for %s: %s", uri, e)
                    failed.append((rid, uri))
                continue
            ids, uris = [], []
            for rid, uri, value in items:
                try:
                    # rows compact on failure: the row cursor advances
                    # only when a payload lands
                    if isinstance(value, np.ndarray):
                        buf[len(ids)] = value
                    else:
                        decode_record_into(value, buf[len(ids)])
                except Exception as e:  # noqa: BLE001 — degrade per rec
                    log.warning("decode failure for %s: %s", uri, e)
                    failed.append((rid, uri))
                    continue
                ids.append(rid)
                uris.append(uri)
            if not ids:
                continue
            buf[len(ids):] = buf[len(ids) - 1]   # stack-free bucket pad
            batches.append((ids, uris, buf, len(ids)))
        return batches, failed

    def _decode_records_legacy(self, records):
        """The older per-record decode (one ndarray allocation per
        record; the dispatch stage stacks). Kept ONLY as the
        `zero_copy_decode=False` baseline the bench_serving decode A/B
        measures against. Returns ``(by_shape, failed)``."""
        from analytics_zoo_tpu_torch.serving.pre_post import \
            decode_record_field
        by_shape: dict = {}
        failed = []
        for rid, rec in records:
            try:
                data = rec["data"]
                field = "t" if "t" in data else (
                    "image" if "image" in data else next(iter(data)))
                arr = decode_record_field(data[field])
                by_shape.setdefault(arr.shape, []).append(
                    (rid, rec["uri"], arr))
            except Exception as e:  # noqa: BLE001 — degrade per record
                uri = rec.get("uri", rid) if isinstance(rec, dict) \
                    else str(rid)
                log.warning("decode failure for %s: %s", uri, e)
                failed.append((rid, uri))
        return by_shape, failed

    def _decode_loop(self):
        while True:
            try:
                item = self._decode_q.get(timeout=1.0)
            except queue.Empty:
                continue               # exit is by pill, not timeout
            if item is _STOP:
                return
            t0, records, src = item
            tr = self.tracer
            uris = _record_uris(records) if tr is not None else None
            if tr is not None:
                # queue wait: broker read (t0) -> this dequeue
                tr.add_span("decode_q_wait", t0, time.perf_counter(),
                            cat="serving.queue", trace_ids=uris)
            try:
                t_work = time.perf_counter()
                if self.zero_copy_decode:
                    batches, failed = self._decode_records(records)
                else:
                    by_shape, failed = self._decode_records_legacy(records)
                    batches = None
                if failed:
                    self._enqueue(self._sink_q, _Batch(
                        [rid for rid, _ in failed],
                        [uri for _, uri in failed], None, t0, nan=True,
                        stream=src))
                    if self.trace_exporter is not None:
                        # failures export their traces regardless of
                        # head sampling — the requests worth debugging
                        self.trace_exporter.force(
                            [uri for _, uri in failed])
                if batches is not None:
                    for ids, uris, buf, n in batches:
                        self._enqueue(self._dispatch_q, _Batch(
                            ids, uris, None, t0, stacked=buf, valid_n=n,
                            stream=src))
                else:
                    for items in by_shape.values():
                        self._enqueue(self._dispatch_q, _Batch(
                            [rid for rid, _, _ in items],
                            [uri for _, uri, _ in items],
                            [a for _, _, a in items], t0, stream=src))
                t_end = time.perf_counter()
                self.decode_timer.record(t_end - t_work)
                if tr is not None:
                    tr.add_span("decode", t_work, t_end, trace_ids=uris,
                                args=dict(self._labels) or None)
            except Exception as e:  # noqa: BLE001 — stage must survive
                # the dropped batch stays unacked, so the broker WILL
                # redeliver it — release its ids or _filter_inflight
                # would suppress that redelivery forever
                self._release_inflight([rid for rid, _ in records], src)
                log.error("decode stage failed for a read batch: %s", e)

    # -- stage: dispatch ---------------------------------------------------
    def _dispatch_loop(self):
        while True:
            try:
                batch = self._dispatch_q.get(timeout=1.0)
            except queue.Empty:
                continue               # exit is by pill, not timeout
            if batch is _STOP:
                return
            tr = self.tracer
            if tr is not None:
                tr.add_span("dispatch_q_wait", batch.t_enq,
                            time.perf_counter(), cat="serving.queue",
                            trace_ids=batch.uris)
            try:
                t_work = time.perf_counter()
                if batch.stacked is not None:
                    # zero-copy decode already assembled the
                    # bucket-shaped buffer — nothing to stack here
                    n = batch.valid_n
                    stacked = batch.stacked
                    batch.stacked = None
                else:
                    n = len(batch.arrays)
                    bucket = self.batcher.pad_bucket(n)
                    arrs = batch.arrays
                    if bucket > n:
                        # stack straight to the bucket: padding costs
                        # nothing extra (the stack copies anyway) and
                        # predict_async skips its device-side pad
                        arrs = arrs + [arrs[-1]] * (bucket - n)
                    stacked = np.stack(arrs)
                    batch.arrays = None
                # async: returns before the device finishes — the
                # sink materializes while we stack the next batch.
                # With EVERY replica quarantined the router fails fast;
                # the batch PARKS here (capacity loss, not correctness
                # loss) until a canary revival — or NaN-degrades if the
                # engine is stopping.
                while True:
                    try:
                        batch.pending = self.model.predict_async(
                            stacked, valid_n=n)
                        break
                    except NoHealthyReplicaError:
                        if self._stop.is_set():
                            raise
                        self._stop.wait(0.05)
                t_end = time.perf_counter()
                self.dispatch_timer.record(t_end - t_work)
                # elastic telemetry: the chosen bucket and
                # how much deadline budget queueing+batching consumed
                # before this dispatch — what the controller's next
                # plans and the bench's queue-age story read
                batch.bucket = int(stacked.shape[0])
                batch.t_dispatch = t_end
                self.batcher.record_dispatch(
                    batch.bucket, (t_end - batch.t0) * 1e3)
                replica = getattr(batch.pending, "replica", 0)
                if self._multi_replica and replica is not None:
                    self._replica_batches.inc(replica=str(replica))
                if tr is not None:
                    # replica tag only in multi-device mode, engine tag
                    # only in fleet mode: the default single-replica
                    # standalone trace schema stays unchanged
                    span_args = dict(self._labels)
                    if self._multi_replica and replica is not None:
                        span_args["replica"] = replica
                    tr.add_span("dispatch", t_work, t_end,
                                trace_ids=batch.uris,
                                args=span_args or None)
                self._enqueue(self._sink_q, batch)
            except Exception as e:  # noqa: BLE001 — stream must survive
                log.error("dispatch failure for batch of %d: %s",
                          len(batch.uris), e)
                batch.arrays = None
                batch.stacked = None
                batch.nan = True
                self._enqueue(self._sink_q, batch)

    # -- stage: sink -------------------------------------------------------
    def _sink_loop(self):
        """Materialize and write back in COMPLETION order, not dispatch
        order: with a replica pool, batch N+1 on an idle device finishes
        while batch N still computes elsewhere — FIFO materialization
        would park the sink on the slowest replica and stall every other
        chip's finished work (and one poisoned replica would dam the
        stream). Batches are pulled greedily off the queue into a waiting
        set; whichever `PendingPrediction` reports `done()` first is
        written first. Per-batch writeback, NaN degradation, and ack
        semantics are unchanged."""
        waiting: List[_Batch] = []
        stop_seen = False
        # the completion-scan window is bounded at queue_depth: past the
        # cap the sink stops pulling, _sink_q fills, and dispatch blocks
        # on its put — the documented sink backpressure survives the
        # completion-order rework (without the cap, a fast dispatcher on
        # an async backend would pile unbounded un-materialized device
        # results into this list). On stop the cap lifts to drain.
        cap = max(2, self.queue_depth)
        while True:
            batch = None
            try:
                if not (waiting or stop_seen):
                    # idle: block in bounded slices so buffered
                    # writebacks still get flush attempts while no new
                    # work arrives (a broker that comes back during a
                    # quiet period must not wait for the next request)
                    batch = self._sink_q.get(timeout=0.1)
                elif stop_seen or len(waiting) < cap:
                    batch = self._sink_q.get_nowait()
            except queue.Empty:
                if self._wb_buffer:
                    self._flush_writebacks()
                if not (waiting or stop_seen):
                    continue
            if batch is not None:
                if batch is _STOP:
                    stop_seen = True
                else:
                    if self.tracer is not None:
                        self.tracer.add_span(
                            "sink_q_wait", batch.t_enq,
                            time.perf_counter(), cat="serving.queue",
                            trace_ids=batch.uris)
                    # sink span base: from here on, time spent is the
                    # device wait + materialize + writeback for this
                    # batch
                    batch.t_enq = time.perf_counter()
                    waiting.append(batch)
                continue
            ready = [b for b in waiting
                     if b.nan or b.pending is None or b.pending.done()]
            if not ready and waiting and \
                    (stop_seen or not self._multi_replica
                     or (len(waiting) == 1 and self._sink_q.empty())):
                # block in result() on the oldest instead of polling:
                # on stop (drain), with a single device stream (one
                # replica / sharded — completion order IS dispatch
                # order, so this is exactly the pre-router sink, no
                # poll tax on the default path), or when only one
                # batch is in flight anyway
                ready = [waiting[0]]
            for b in ready:
                waiting.remove(b)
                self._sink_one(b)
            if stop_seen and not waiting:
                # one last flush: results computed during an outage
                # land if the broker is back; the rest stay unacked
                # for redelivery after restart
                if self._wb_buffer:
                    self._flush_writebacks()
                    if self._wb_buffer:
                        log.warning(
                            "stopping with %d writeback batch(es) "
                            "still unflushed; their records are "
                            "unacked and will redeliver",
                            len(self._wb_buffer))
                return
            if waiting and not ready:
                time.sleep(0.0005)     # all in flight; poll done() soon

    def _sink_one(self, batch: _Batch):
        """Materialize one batch, then write back — or buffer the
        writeback when the broker is down. Materialization errors
        degrade to "NaN" inside `_materialize`; from here on the only
        failure mode is the broker, and the buffer owns that."""
        if self._killed:
            # kill() (crash analogue): a dead process commits nothing —
            # the batch's records stay unacked for peer takeover. A
            # routed pending still holds a replica permit that only
            # consumption releases; abandon it like _poison does.
            abandon = getattr(batch.pending, "abandon", None)
            if abandon is not None:
                abandon()
            return
        t_work = batch.t_enq
        values = self._materialize(batch)
        if self.tracer is not None and not (batch.nan or batch.shed):
            # the device wait + readback half of the sink: what the
            # critical-path "device" column reads (dispatch only SUBMITS;
            # this is where the batch's result actually lands on host)
            self.tracer.add_span("device", t_work, time.perf_counter(),
                                 cat="serving.device",
                                 trace_ids=batch.uris,
                                 args=dict(self._labels) or None)
        if batch.bucket is not None and batch.t_dispatch is not None \
                and not (batch.nan or batch.shed):
            # feed the live cost model: dispatch → materialized is what
            # a queued record pays once it boards this bucket
            self.batcher.observe_service(
                batch.bucket,
                (time.perf_counter() - batch.t_dispatch) * 1e3)
        entry = (dict(zip(batch.uris, values)), list(batch.ids),
                 batch.t0, t_work, batch.shed,
                 batch.stream or self.stream)
        if self._wb_buffer:
            # keep writeback order: flush the backlog first, and if any
            # of it still can't go out, queue behind it
            self._flush_writebacks()
        if self._wb_buffer or not self._write_entry(entry):
            self._buffer_writeback(entry)

    def _write_entry(self, entry, own_retry: bool = False) -> bool:
        """One batched writeback + ack; False (no raise) on a broker
        failure. Counters/timers record only on success — a buffered
        batch records its FULL latency (outage included) when it
        finally lands. `own_retry` marks a flush of THIS engine's
        buffered entry: an ambiguous partial commit (HSET applied,
        reply lost, pipeline raised) leaves the fields present, so the
        retry's new-field count reads 0 — but the records were served
        exactly once by this engine's compute and must count as
        served, not duplicate."""
        mapping, ids, t0, t_work, shed = entry[:5]
        # pre-partition entries (tests, a buffer that survived an
        # upgrade) carry no stream element: they mean the base stream
        stream = entry[5] if len(entry) > 5 else self.stream
        t_wb = time.perf_counter()
        try:
            # the whole batch commits as ONE broker interaction —
            # results + ack in a single (pipelined) round trip, not
            # N+1, not even 3: round-trip latency is what caps sink
            # throughput when the broker host is loaded
            added = self.sink_broker.writeback(
                self.result_key, mapping, stream, GROUP, ids)
            self._release_inflight(ids, stream)
        except Exception as e:  # noqa: BLE001 — the buffer owns retries
            if not self._sink_down:
                # one warning per outage, not per batch (the breaker
                # logs its own transitions)
                log.warning(
                    "sink writeback failed for %d records (%s: %s); "
                    "buffering until the broker returns",
                    len(mapping), type(e).__name__, e)
                self._sink_down = True
            return False
        t_end = time.perf_counter()
        self.sink_timer.record(t_end - t_work)
        if self.tracer is not None:
            # includes the device wait inside _materialize — the
            # only blocking readback in the pipeline
            tr_ids = list(mapping)
            self.tracer.add_span("sink", t_work, t_end,
                                 trace_ids=tr_ids,
                                 args=dict(self._labels) or None)
            # the broker-commit tail on its own row: the critical-path
            # "writeback" column (results + ack round trip)
            self.tracer.add_span("writeback", t_wb, t_end,
                                 cat="serving.sink", trace_ids=tr_ids,
                                 args=dict(self._labels) or None)
        # idempotent writeback: HSET reports how many fields
        # were NEW. A redelivered record whose result another engine (or
        # an earlier life of this one) already wrote is an overwrite of
        # the same deterministic value — correct data, but it must not
        # double-count as served. The broker's own new-field count is
        # the only dedup that works ACROSS engines. An own-buffered
        # retry is the exception (see docstring): its records count as
        # served regardless of the overwrite count. (If a peer ALSO
        # claimed and wrote them during a long outage, the fleet sum
        # over-counts that overlap — a double fault traded for not
        # silently deflating every single-engine outage recovery.)
        if own_retry:
            added = len(mapping)
        n_new = added if isinstance(added, int) else len(mapping)
        n_dup = len(mapping) - n_new
        if shed:
            # an answered rejection is NOT service: counting
            # shed commits as "served" — and their near-zero commit
            # times into the batch timer — would read overload as
            # improved availability/latency and suppress the very SLO
            # burn the autoscaler scales up on. Distinct outcome, no
            # latency sample, no served count.
            if n_new:
                self._records_total.inc(n_new, outcome="shed",
                                        **self._labels)
            return True
        with self._counter_lock:
            self.records_served += n_new
        if n_new:
            self._records_total.inc(n_new, outcome="served",
                                    **self._labels)
        if n_dup:
            self._records_total.inc(n_dup, outcome="duplicate",
                                    **self._labels)
        # NaN-degraded records count as "failed" alongside (not instead
        # of) "served" — the SLO availability window reads
        # (served - failed) / served. A fully-duplicate batch (a
        # redelivery whose results were all already written) skips the
        # count: its NaNs were counted by the first writer, and
        # re-counting them would skew availability down on every
        # crash-redelivery. (A partially-new batch counts all its NaNs
        # — HSET's new-field total can't attribute WHICH fields were
        # new, and the mixed case needs a mid-batch crash to occur.)
        nan_n = sum(1 for v in mapping.values() if v == "NaN")
        if nan_n and n_new:
            self._records_total.inc(nan_n, outcome="failed",
                                    **self._labels)
        self.batch_timer.record(t_end - t0)
        if self.trace_exporter is not None:
            # forced sampling: failed and SLO-violating
            # requests always ship their spans — head sampling decides
            # the happy path, never the requests worth debugging
            if self.slo is not None \
                    and self.slo.objectives.latency_ms is not None \
                    and (t_end - t0) * 1e3 > self.slo.objectives.latency_ms:
                self.trace_exporter.force(list(mapping))
            elif nan_n:
                self.trace_exporter.force(
                    [u for u, v in mapping.items() if v == "NaN"])
        return True

    def _buffer_writeback(self, entry):
        """Bounded: past `sink_buffer_batches` the OLDEST entry is shed
        and counted — its records were never acked, so the broker
        redelivers them after its pending window (duplicate work, never
        loss)."""
        self._wb_buffer.append(entry)
        while len(self._wb_buffer) > self.sink_buffer_batches:
            shed = self._wb_buffer.popleft()
            self._shed_records.inc(len(shed[0]))
            # shed records must be re-readable: release their ids so a
            # redelivery (this engine or a claiming peer) isn't filtered
            # out as already-in-flight
            self._release_inflight(
                shed[1], shed[5] if len(shed) > 5 else None)
            log.warning(
                "sink buffer overflow: shed a writeback of %d records "
                "(unacked; the broker will redeliver)", len(shed[0]))

    def _flush_writebacks(self):
        """Drain the buffered writebacks in order; stops at the first
        entry the broker still refuses (the breaker makes that a fast
        fail while the circuit is open)."""
        flushed = False
        while self._wb_buffer:
            if not self._write_entry(self._wb_buffer[0], own_retry=True):
                return
            self._wb_buffer.popleft()
            flushed = True
        if flushed and self._sink_down:
            self._sink_down = False
            self._reconnects.inc(role="sink")
            log.info("sink reconnected; buffered writebacks flushed")

    def _materialize(self, batch) -> List[str]:
        """Per-record encoded result strings for a batch; inference
        failure degrades the whole batch to "NaN" (the per-shape batch is
        the reference's failure unit, `ClusterServingInference.scala:71`)."""
        if batch.shed:
            # admission shed: an answered rejection — the
            # client sees "SHED" (degrades like NaN in the decoders but
            # is distinguishable on the wire), the ack keeps the broker
            # from redelivering work the engine chose not to do
            return ["SHED"] * len(batch.uris)
        if batch.nan:
            if batch.pending is not None:
                # a batch can be marked nan AFTER routing succeeded (a
                # dispatch-stage failure past predict_async): the routed
                # pending still holds a replica permit that only
                # result() releases — drain it or the replica is
                # permanently down a slot
                try:
                    batch.pending.result()
                except Exception:  # noqa: BLE001 — already degrading
                    pass
            return ["NaN"] * len(batch.uris)
        try:
            preds = batch.pending.result()
        except Exception as e:  # noqa: BLE001 — stream must survive
            log.error("inference failure for batch of %d: %s",
                      len(batch.uris), e)
            return ["NaN"] * len(batch.uris)
        values = []
        hops = None
        if self.trace_exporter is not None:
            # per-hop timing summary riding the writeback row:
            # engine-internal MONOTONIC durations only — a client
            # on another host can attribute its e2e latency without any
            # cross-clock arithmetic (e2e - engine_ms = wire + broker)
            now = time.perf_counter()
            t_disp = batch.t_dispatch if batch.t_dispatch is not None \
                else now
            hops = {"engine": self._labels.get("engine", self.consumer),
                    "engine_ms": round((now - batch.t0) * 1e3, 3),
                    "queue_ms": round((t_disp - batch.t0) * 1e3, 3),
                    "device_ms": round((now - t_disp) * 1e3, 3)}
        for pred in list(preds)[:len(batch.uris)]:
            try:
                if self.output_filter:
                    from analytics_zoo_tpu_torch.serving.pre_post import \
                        apply_filter
                    values.append(apply_filter(np.asarray(pred),
                                               self.output_filter))
                else:
                    blob = encode_ndarray(np.asarray(pred))
                    if hops is not None:
                        blob["hops"] = hops
                    values.append(json.dumps(blob))
            except Exception as e:  # noqa: BLE001 — degrade per record
                log.warning("encode failure: %s", e)
                values.append("NaN")
        return values

    # -- legacy synchronous loop (pipelined=False, serve_once) -------------
    def run(self):
        while not self._stop.is_set():
            try:
                self.serve_once()
            except Exception as e:  # noqa: BLE001 — the Flink-restart role
                log.warning("serving cycle failed (%s: %s); retrying",
                            type(e).__name__, e)
                self._stop.wait(1.0)

    def serve_once(self) -> int:
        """One synchronous drain->batch->predict->sink cycle (the
        pre-pipeline behavior; also handy for tests and notebooks)."""
        records = self.broker.read_group(
            self.stream, GROUP, self.consumer, self.batch_size,
            block_ms=self.batch_timeout_ms)
        if not records:
            return 0
        with self._counter_lock:
            self.records_read += len(records)
        self._records_total.inc(len(records), outcome="read",
                                **self._labels)
        t0 = time.perf_counter()
        self._process(records)
        self.broker.ack(self.stream, GROUP, [rid for rid, _ in records])
        with self._counter_lock:
            self.records_served += len(records)
        self._records_total.inc(len(records), outcome="served",
                                **self._labels)
        t_end = time.perf_counter()
        self.batch_timer.record(t_end - t0)
        if self.tracer is not None:
            # the sync loop is one fused stage: a single span per cycle
            self.tracer.add_span("serve_once", t0, t_end,
                                 trace_ids=_record_uris(records))
        return len(records)

    def _process(self, records):
        # per-record decode failure -> NaN without killing the batch; one
        # forward per shape-homogeneous sub-batch
        if self.zero_copy_decode:
            batches, failed = self._decode_records(records)
        else:
            by_shape, failed = self._decode_records_legacy(records)
            batches = [([rid for rid, _, _ in items],
                        [uri for _, uri, _ in items],
                        np.stack([a for _, _, a in items]), len(items))
                       for items in by_shape.values()]
        for _rid, uri in failed:
            self.broker.hset(self.result_key, uri, "NaN")
        if failed:
            self._records_total.inc(len(failed), outcome="failed",
                                    **self._labels)
        for _ids, uris, buf, n in batches:
            try:
                preds = self.model.predict(buf[:n])
                for uri, pred in zip(uris, preds):
                    if self.output_filter:
                        from analytics_zoo_tpu_torch.serving.pre_post import \
                            apply_filter
                        value = apply_filter(np.asarray(pred),
                                             self.output_filter)
                    else:
                        value = json.dumps(encode_ndarray(np.asarray(pred)))
                    self.broker.hset(self.result_key, uri, value)
            except NoHealthyReplicaError:
                # transient whole-pool quarantine: park via redelivery
                # (serve_once never acks this read) — NaN-acking every
                # record through the outage would turn lost CAPACITY
                # into lost correctness, the opposite of the
                # quarantine contract
                raise
            except Exception as e:  # noqa: BLE001 — stream must survive
                log.error("inference failure for batch of %d (%s): %s",
                          n, tuple(buf.shape[1:]), e)
                for uri in uris:
                    self.broker.hset(self.result_key, uri, "NaN")
                self._records_total.inc(len(uris), outcome="failed",
                                        **self._labels)

    # -- metrics (`/metrics`, FrontEndApp.scala:241) -----------------------
    def metrics(self) -> dict:
        m = {
            "records_served": self.records_served,
            "records_read": self.records_read,
            "pipelined": self.pipelined,
            "serving_dtype": self.serving_dtype,
            "model_version": self.model_version,
            "batch": self.batch_timer.snapshot(),
            "predict": self.model.timer.snapshot(),
        }
        if self.engine_id is not None:
            m["engine_id"] = self.engine_id
            m["claimed_records"] = int(
                self._claimed_records.value(**self._labels))
        if self.lease_table is not None:
            m["partitions"] = {
                "total": self.partitions,
                "owned": self.lease_table.owned(),
            }
        if self.pipelined:
            m["stages"] = {
                "decode": self.decode_timer.snapshot(),
                "dispatch": self.dispatch_timer.snapshot(),
                "sink": self.sink_timer.snapshot(),
            }
            m["queue_depths"] = {
                "decode": self._decode_q.qsize(),
                "dispatch": self._dispatch_q.qsize(),
                "sink": self._sink_q.qsize(),
            }
        if self._multi_replica or getattr(self.model, "placement",
                                          "replicated") == "sharded":
            m["placement"] = self.model.placement_info()
            m["replicas"] = self.model.replica_stats()
        m["batching"] = {
            "policy": self.batcher.policy,
            "deadline_ms": self.batcher.deadline_ms,
            "bucket_cost_ms": {str(b): round(c, 3) for b, c in
                               self.batcher.cost.snapshot().items()},
            "backlog": self._backlog_cache,
        }
        if self.tier_table is not None:
            m["admission"] = {
                "tiers": list(self.tier_table.names),
                "shed_backlog": self.shed_backlog,
            }
        ft = {"sink_buffered_batches": len(self._wb_buffer)}
        for role, br in (("reader", self.reader_broker),
                         ("sink", self.sink_broker)):
            breaker = getattr(br, "breaker", None)
            if breaker is not None:
                ft[f"breaker_{role}"] = breaker.state
        if self.supervisor is not None:
            ft["supervisor"] = self.supervisor.stats()
        m["fault_tolerance"] = ft
        if self.slo is not None:
            try:
                m["slo"] = self.slo.evaluate()
            except Exception:  # noqa: BLE001 — metrics must always answer
                m["slo"] = None
        size_fn = getattr(self.model, "compile_cache_size", None)
        if size_fn is not None:
            # per-(replica, bucket) program count (captured CUDA graphs on
            # the card), plus persistent-cache traffic when the model is
            # cache-backed, and each replica's graph pool bytes
            cc_info = {"executables": size_fn()}
            pools = getattr(self.model, "graph_pool_bytes", dict)()
            if pools:
                cc_info["graph_pool_bytes"] = {
                    f"r{r}": b for r, b in sorted(pools.items())}
            cache = getattr(self.model, "compile_cache", None)
            if cache is not None:
                s = cache.stats()
                cc_info.update(hits=s["hits"], misses=s["misses"],
                               bytes=s["bytes"], entries=s["entries"])
            src = getattr(self.model, "warmup_source", None)
            if src:
                cc_info["warmup_source"] = dict(src)
            m["compile_cache"] = cc_info
        if self.trace_exporter is not None:
            m["trace"] = self.trace_exporter.stats()
        return m
