"""Cluster Serving CLI — `cluster-serving-start/stop/cli` analogue
(`scripts/cluster-serving/`).

    python -m analytics_zoo_tpu_torch.serving.cli start --config config.yaml
    python -m analytics_zoo_tpu_torch.serving.cli gateway --broker URL
    python -m analytics_zoo_tpu_torch.serving.cli broker --port 6380
    python -m analytics_zoo_tpu_torch.serving.cli redis --port 6379
    python -m analytics_zoo_tpu_torch.serving.cli metrics \
        --url http://host:http_port

`start` runs the serving loop (and HTTP frontend when http_port is set) in
the foreground; `gateway` runs an engine-less fleet front end; `broker`
runs a standalone TCP broker and `redis` the in-package RESP2 server, so
clients on other hosts/processes can enqueue.

Copied from `analytics_zoo_tpu/serving/cli.py` (L1-741): `cmd_start` (with
`_start_generative`), `_run_until_signal`, `cmd_gateway` (with
`--autoscale` and `--rollout-dir`), `cmd_broker`, `cmd_redis`,
`cmd_metrics` and `main`. What differs in the port:

- `start --device` (default: the config's `params.device`, else ``cuda``)
  says where the engine serves; without a GPU, ``cuda`` raises before the
  engine joins the consumer group, naming ``device='cpu'``;
- `--placement sharded`, `--mesh` and `--compile-cache-dir` are accepted
  and refused by the config's load (ROADMAP.md queue 1, items 7 and 1);
- a started engine prints its kernel launch counts (`kernels.LAUNCHES`)
  and kernel builds (`kernels._build.build_events()`) as one JSON line
  when it starts serving and again when it stops, so a program in another
  process can show that the requests it sent ran through the kernels and
  built none.
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import sys
import time


def cmd_start(args) -> int:
    from analytics_zoo_tpu_torch.serving.config import ServingConfig
    from analytics_zoo_tpu_torch.serving.http_frontend import FrontEnd
    from analytics_zoo_tpu_torch.serving.server import ClusterServing
    from analytics_zoo_tpu_torch.serving.broker import connect_broker
    replicas = getattr(args, "num_replicas", None)
    if replicas is not None:
        try:
            replicas = int(replicas)
        except ValueError:
            pass                    # 'auto' (load() validates spellings)
    # overrides go INTO load(): validation must see the effective values,
    # or a config authored for a bigger host could never be rescued here
    cfg = ServingConfig.load(args.config, num_replicas=replicas,
                             placement=getattr(args, "placement", None),
                             compile_cache_dir=getattr(
                                 args, "compile_cache_dir", None),
                             mesh=getattr(args, "mesh", None),
                             device=getattr(args, "device", None))
    if getattr(args, "engine_id", None):
        # fleet override: each process in a scale-out gets
        # its own identity at launch ("auto" generates one)
        cfg.engine_id = args.engine_id
        cfg._validate_fleet()
    if getattr(args, "partitions", None) is not None:
        cfg.partitions = args.partitions
    if getattr(args, "reshard", False):
        cfg.reshard = True
    cfg._validate_partitions()
    engine_id = cfg.resolve_engine_id()
    if cfg.partitions > 1 and engine_id is None:
        # same discipline as rollout below: a partitioned engine with
        # no fleet identity cannot lease partitions — fail before the
        # consumer group sees this process
        raise SystemExit(
            "params.partitions > 1 needs a fleet identity: pass "
            "--engine-id (or set params.engine_id) — the partition "
            "lease table keys ownership on it")
    if cfg.rollout_model_dir and engine_id is None:
        # fail BEFORE the engine joins the consumer group: dying on a
        # config error after reading records would strand them in the
        # PEL until a peer's claim sweep
        raise SystemExit(
            "params.rollout.model_dir needs a fleet identity: "
            "pass --engine-id (or set params.engine_id)")
    broker = connect_broker(cfg.broker_url)
    frontend = None
    if cfg.http_port is not None:
        # frontend first: with model_encrypted, build_model blocks until
        # someone POSTs the secret/salt to /model-secure
        frontend = FrontEnd(
            broker, None, port=cfg.http_port,
            tokens_per_second=cfg.tokens_per_second,
            token_acquire_timeout_ms=cfg.token_acquire_timeout_ms,
            tls_certfile=cfg.tls_certfile,
            tls_keyfile=cfg.tls_keyfile,
            profile_dir=cfg.profile_dir,
            profile_max_artifacts=cfg.profile_max_artifacts,
            profile_enabled=cfg.profile_enabled,
            # fleet mode: the frontend doubles as the fleet gateway
            # (engine heartbeats -> /healthz + serving_engines_* gauges)
            fleet_stream=cfg.stream if engine_id else None,
            engine_ttl_s=cfg.engine_ttl_s,
            # tiered admission: cheap early 429s per tier
            admission=cfg.build_admission(broker),
            admission_header=cfg.admission_header,
            # partitioned request plane: /predict enqueues
            # hash-route across the same partition streams the engines
            # lease
            partitions=cfg.partitions,
            # fleet trace plane: /trace/<request_id> serves
            # merged cross-process timelines; trace_sample>0 also stamps
            # trace context on enqueued records
            trace_sample=cfg.trace_sample,
            trace_buffer_spans=cfg.trace_buffer_spans,
            trace_export_interval_s=cfg.trace_export_interval_s,
            # streaming continuity: keepalive comments hold
            # proxies open; a stalled stream with flatlined engine
            # heartbeats closes with an explicit error event
            stream_keepalive_s=cfg.decode_keepalive_s,
            stream_stall_timeout_s=(cfg.engine_ttl_s * 2
                                    if cfg.generative else None)).start()
        scheme = "https" if frontend.tls else "http"
        print(f"{scheme} frontend on :{frontend.port}", flush=True)
    if cfg.generative:
        # continuous-batching decode engine: replaces the
        # request-batched dispatch path entirely — the frontend (if any)
        # keeps serving /predict, now with ?stream=1 SSE token relay
        return _start_generative(cfg, broker, frontend)
    model = cfg.build_model(broker=broker)
    print(f"placement={model.placement} replicas={model.num_replicas} "
          f"devices={len(model.devices)} device={model.device} "
          f"dtype={model.serving_dtype}", flush=True)
    if cfg.warmup_shapes:
        # run every REACHABLE shape bucket BEFORE the stream opens: no
        # kernel build or first-call cost ever lands on a request. The
        # reader never hands dispatch more than batch_size records, so
        # buckets past the one covering batch_size would pay warmup time
        # for batches that cannot occur
        import numpy as np

        from analytics_zoo_tpu_torch.serving.inference_model import \
            _next_bucket
        dtype = np.dtype(cfg.warmup_dtype)
        cap = _next_bucket(cfg.batch_size, model.buckets)
        buckets = [b for b in model.buckets if b <= cap]
        for shape in cfg.warmup_shapes:
            model.warmup(np.zeros(tuple(shape), dtype), buckets=buckets)
        print(f"warmed {len(model.warmed_buckets)} shape buckets: "
              f"{json.dumps(model.warmup_report)}", flush=True)
        # "cached" / "compiled" / "warm" per bucket with a compile cache
        print(f"warmup source: {json.dumps(model.warmup_source)}",
              flush=True)
    tracer = None
    if cfg.trace or cfg.trace_path or cfg.trace_sample > 0:
        from analytics_zoo_tpu_torch.observability import Tracer, get_registry
        tracer = Tracer(max_spans=cfg.trace_buffer_spans,
                        registry=get_registry())
    serving = ClusterServing(model, broker, stream=cfg.stream,
                             batch_size=cfg.batch_size,
                             batch_timeout_ms=cfg.batch_timeout_ms,
                             pipelined=cfg.pipelined,
                             decode_workers=cfg.decode_workers,
                             queue_depth=cfg.queue_depth,
                             tracer=tracer,
                             supervise=cfg.supervise,
                             failure_threshold=cfg.failure_threshold,
                             probe_interval_s=cfg.probe_interval_s,
                             latency_factor=cfg.latency_factor,
                             breaker_failure_threshold=cfg
                             .breaker_failure_threshold,
                             breaker_reset_s=cfg.breaker_reset_s,
                             sink_buffer_batches=cfg
                             .sink_buffer_batches,
                             slo=cfg.build_slo(),
                             engine_id=engine_id,
                             claim_min_idle_s=cfg.claim_min_idle_s,
                             claim_interval_s=cfg.claim_interval_s,
                             heartbeat_interval_s=cfg
                             .heartbeat_interval_s,
                             batch_policy=cfg.batch_policy,
                             deadline_ms=cfg.deadline_ms,
                             batch_margin_ms=cfg.batch_margin_ms,
                             admission_tiers=cfg.admission_tiers,
                             admission_field=cfg.admission_field,
                             shed_backlog=cfg.shed_backlog,
                             partitions=cfg.partitions,
                             reshard=cfg.reshard,
                             partition_lease_ttl_s=cfg
                             .partition_lease_ttl_s,
                             trace_sample=cfg.trace_sample,
                             trace_buffer_spans=cfg.trace_buffer_spans,
                             trace_export_interval_s=cfg
                             .trace_export_interval_s,
                             fleet_metrics_interval_s=cfg
                             .fleet_metrics_interval_s).start()
    if cfg.partitions > 1:
        print(f"partitioned request plane: {cfg.partitions} partition "
              f"streams, lease ttl {cfg.partition_lease_ttl_s:g}s "
              f"(owned set rebalances as engines join/leave)",
              flush=True)
    if cfg.batch_policy != "fixed":
        print(f"batching: policy={cfg.batch_policy}"
              + (f" deadline={cfg.deadline_ms:g}ms"
                 if cfg.deadline_ms is not None else
                 (f" deadline={cfg.slo_latency_ms:g}ms (from slo)"
                  if cfg.slo_latency_ms is not None else "")),
              flush=True)
    if cfg.admission_tiers:
        print(f"admission tiers (low->high): "
              f"{','.join(cfg.admission_tiers)} "
              f"(429 at {cfg.admission_max_backlog} backlog, shed at "
              f"{cfg.shed_backlog})", flush=True)
    if engine_id:
        print(f"engine id {engine_id} (fleet member; claim window "
              f"{cfg.claim_min_idle_s:g}s)", flush=True)
    if cfg.trace_sample > 0:
        print(f"fleet trace plane: sampling {cfg.trace_sample:g} of "
              f"requests (export every "
              f"{cfg.trace_export_interval_s:g}s, span ring "
              f"{cfg.trace_buffer_spans})", flush=True)
    rollout_agent = None
    if cfg.rollout_model_dir:
        # versioned rollout: this engine follows the
        # gateway controller's directives — hot-swap on command,
        # canary, report the new version in its heartbeat (engine_id
        # presence was enforced before the engine joined the group)
        from analytics_zoo_tpu_torch.serving.rollout import EngineRolloutAgent
        rollout_agent = EngineRolloutAgent(
            serving, broker.clone(), stream=cfg.stream,
            poll_interval_s=cfg.rollout_poll_interval_s,
            drain_timeout_s=cfg.rollout_drain_timeout_s,
            canary_timeout_s=cfg.rollout_canary_timeout_s,
            golden_tolerance=cfg.rollout_golden_tolerance).start()
        print(f"rollout agent watching directives for "
              f"{cfg.rollout_model_dir} (poll "
              f"{cfg.rollout_poll_interval_s:g}s)", flush=True)
    if frontend is not None:
        frontend._srv.serving = serving
        if rollout_agent is not None:
            frontend.set_rollout(rollout_agent)
    if serving.slo is not None:
        obj = serving.slo.objectives
        parts = []
        if obj.latency_ms is not None:
            parts.append(f"latency p{obj.latency_quantile * 100:g}"
                         f"<={obj.latency_ms:g}ms")
        if obj.availability is not None:
            parts.append(f"availability>={obj.availability:g}")
        print(f"slo: {' '.join(parts)} over {obj.window_s:g}s "
              "(watch slo_burn_rate; /healthz aggregates)", flush=True)
    _print_kernel_counts("started")
    print("cluster serving started", flush=True)

    def shutdown():
        if rollout_agent is not None:
            rollout_agent.stop()
        if frontend:
            frontend.stop()
        serving.stop()
        print(json.dumps(serving.metrics()), flush=True)
        _print_kernel_counts("stopped")
        if tracer is not None and cfg.trace_path:
            tracer.write_chrome_trace(cfg.trace_path)
            print(f"chrome trace written to {cfg.trace_path} "
                  "(open in ui.perfetto.dev)", flush=True)

    return _run_until_signal(shutdown)


def _start_generative(cfg, broker, frontend) -> int:
    """Decode-mode tail of `cmd_start`: build + warm the generative
    programs, start the continuous-batching engine, serve until
    signalled. Warmup runs every (prompt bucket, kv bucket) program
    once, so no kernel build ever lands on the request path."""
    from analytics_zoo_tpu_torch.serving.decode import (DecodeServing,
                                                        _pow2_ladder)
    model, inst = cfg.build_generative_model()
    kv_buckets = cfg.decode_kv_buckets or _pow2_ladder(
        8, cfg.decode_max_kv_len)
    prompt_buckets = cfg.decode_prompt_buckets or _pow2_ladder(
        4, max(4, cfg.decode_max_kv_len // 2))
    if cfg.decode_paged:
        bl = cfg.decode_block_len
        table_len = cfg.decode_max_kv_len // bl
        kv_blocks = cfg.decode_kv_blocks or (
            cfg.decode_slots * table_len + 1)
        if cfg.decode_prefill_chunk:
            chunk_buckets = [b for b in prompt_buckets
                             if b <= cfg.decode_prefill_chunk] \
                or [prompt_buckets[0]]
        else:
            chunk_buckets = list(prompt_buckets)
        model.warmup_generative_paged(
            inst.init_kv_blocks, num_blocks=kv_blocks, block_len=bl,
            lanes=cfg.decode_slots, table_len=table_len,
            chunk_buckets=chunk_buckets, kv_buckets=kv_buckets)
    else:
        model.warmup_generative(inst.init_kv, slots=cfg.decode_slots,
                                max_kv_len=cfg.decode_max_kv_len,
                                prompt_buckets=prompt_buckets,
                                kv_buckets=kv_buckets)
    print(f"generative warmup: {json.dumps(model.warmup_report)}",
          flush=True)
    print(f"warmup source: {json.dumps(model.warmup_source)}", flush=True)
    serving = DecodeServing(
        model, inst.init_kv, broker=broker, stream=cfg.stream,
        slots=cfg.decode_slots, max_kv_len=cfg.decode_max_kv_len,
        kv_buckets=kv_buckets, prompt_buckets=prompt_buckets,
        max_new_default=cfg.decode_max_new_tokens,
        eos_id=cfg.decode_eos_id, deadline_ms=cfg.deadline_ms,
        max_prefills_per_step=cfg.decode_max_prefills,
        max_waiting=cfg.decode_max_waiting,
        engine_id=cfg.resolve_engine_id(),
        paged=cfg.decode_paged,
        init_kv_blocks=getattr(inst, "init_kv_blocks", None),
        block_len=cfg.decode_block_len,
        kv_blocks=cfg.decode_kv_blocks,
        prefill_chunk=cfg.decode_prefill_chunk,
        prefix_cache=cfg.decode_prefix_cache,
        prefix_cache_blocks=cfg.decode_prefix_cache_blocks,
        # crash safety: claim/resume a dead peer's in-flight
        # generative records (resume: false opts out), heartbeat for the
        # peers' stall detection, watchdog + preemption + writeback
        # buffering knobs
        claim_min_idle_s=(cfg.claim_min_idle_s
                          if cfg.decode_resume else None),
        claim_interval_s=cfg.claim_interval_s,
        heartbeat_interval_s=cfg.heartbeat_interval_s,
        max_seq_wall_s=cfg.decode_max_seq_wall_s,
        preempt_max=cfg.decode_preempt_max,
        writeback_buffer_rows=cfg.decode_writeback_buffer).start()
    if cfg.decode_paged:
        print(f"decode engine {serving.engine_id} (paged): "
              f"{serving.kv_blocks} KV blocks x {cfg.decode_block_len} "
              f"tokens, {cfg.decode_slots} lanes, kv buckets "
              f"{kv_buckets}, chunk buckets {serving.chunk_buckets}, "
              f"prefix cache "
              f"{'on' if cfg.decode_prefix_cache else 'off'}", flush=True)
    else:
        print(f"decode engine {serving.engine_id}: {cfg.decode_slots} KV "
              f"slots x {cfg.decode_max_kv_len} positions, kv buckets "
              f"{kv_buckets}, prompt buckets {prompt_buckets}", flush=True)
    _print_kernel_counts("started")
    print("cluster serving started (generative)", flush=True)

    def shutdown():
        if frontend:
            frontend.stop()
        serving.stop()
        print(json.dumps(serving.stats), flush=True)
        _print_kernel_counts("stopped")

    return _run_until_signal(shutdown)


def _print_kernel_counts(when: str) -> None:
    """One JSON line: this process's kernel launch counts and builds."""
    from analytics_zoo_tpu_torch.kernels import LAUNCHES, _build
    print(json.dumps({"kernel_counts": when,
                      "launches": LAUNCHES.snapshot(),
                      "builds": _build.build_events()}), flush=True)


def _run_until_signal(stop_fn) -> int:
    stop = []
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    while not stop:
        time.sleep(0.5)
    stop_fn()
    return 0


def cmd_gateway(args) -> int:
    """Engine-less fleet gateway: an HTTP frontend that
    tracks engine heartbeats on the broker and answers `/healthz` /
    `/metrics` for the whole fleet — run it on the edge while N
    `start --engine-id auto` engine processes drain the stream.

    `--autoscale` additionally runs a `FleetAutoscaler`
    here: the gateway watches backlog depth and heartbeat-reported SLO
    burn and spawns/retires `start --engine-id auto` engine processes
    (children of this gateway) between `--min-engines` and
    `--max-engines`, with hysteresis so a spike can't flap the fleet.
    Retirement is a clean SIGTERM — the engine deregisters and drains,
    and the claim sweep moves anything left to peers. Requires
    `--engine-config`, the serving config the spawned engines run."""
    import subprocess

    from analytics_zoo_tpu_torch.serving.broker import connect_broker
    from analytics_zoo_tpu_torch.serving.config import ServingConfig
    from analytics_zoo_tpu_torch.serving.http_frontend import FrontEnd
    if args.engine_ttl <= 0:
        # same contract as the params path (_validate_fleet): a zero
        # TTL flaps every beating engine dead — fail at launch
        raise SystemExit(
            f"--engine-ttl {args.engine_ttl:g} must be > 0")
    if args.leader_ttl <= 0:
        raise SystemExit(
            f"--leader-ttl {args.leader_ttl:g} must be > 0")
    if args.partitions is not None:
        from analytics_zoo_tpu_torch.serving.partitions import \
            validate_partitions
        try:
            validate_partitions(args.partitions)
        except ValueError as e:
            raise SystemExit(f"--partitions: {e}")
    engine_cfg = ServingConfig.load(args.engine_config) \
        if args.engine_config else None
    admission = None
    admission_header = "X-Priority"
    broker = connect_broker(args.broker)
    if args.admission_tiers:
        # explicit CLI tiers win over the config block
        from analytics_zoo_tpu_torch.serving.elastic import AdmissionController
        tiers = [t.strip() for t in args.admission_tiers.split(",")
                 if t.strip()]
        admission = AdmissionController(
            broker.clone(), args.stream, tiers,
            max_backlog=args.admission_max_backlog)
    elif engine_cfg is not None and engine_cfg.admission_tiers:
        # the engine config's params.admission block IS the fleet's
        # admission policy — the gateway must enforce the same tiers
        # the engines schedule/shed by, or the documented early 429
        # silently never engages. Sampled on THIS gateway's --stream
        # (the stream the fleet actually drains).
        from analytics_zoo_tpu_torch.serving.elastic import AdmissionController
        admission = AdmissionController(
            broker.clone(), args.stream, engine_cfg.admission_tiers,
            max_backlog=engine_cfg.admission_max_backlog)
    if engine_cfg is not None:
        admission_header = engine_cfg.admission_header
    partitions = args.partitions if args.partitions is not None else (
        engine_cfg.partitions if engine_cfg else 1)
    gateway_id = args.gateway_id
    if gateway_id and gateway_id.lower() == "auto":
        import os as _os
        import uuid as _uuid
        gateway_id = f"gateway-{_os.getpid()}-{_uuid.uuid4().hex[:6]}"
    trace_sample = args.trace_sample if args.trace_sample is not None \
        else (engine_cfg.trace_sample if engine_cfg else 0.0)
    frontend = FrontEnd(
        broker, None, host=args.host,
        port=args.port, fleet_stream=args.stream,
        engine_ttl_s=args.engine_ttl,
        tokens_per_second=args.tokens_per_second,
        admission=admission,
        admission_header=admission_header,
        partitions=partitions,
        gateway_id=gateway_id,
        leader_ttl_s=args.leader_ttl,
        trace_sample=trace_sample,
        trace_buffer_spans=(engine_cfg.trace_buffer_spans
                            if engine_cfg else 20000),
        trace_export_interval_s=(engine_cfg.trace_export_interval_s
                                 if engine_cfg else 0.5),
        # streaming continuity: the gateway relays SSE for a
        # generative fleet — keepalives + heartbeat-aware stall cutoff
        stream_keepalive_s=(engine_cfg.decode_keepalive_s
                            if engine_cfg else None),
        stream_stall_timeout_s=(args.engine_ttl * 2
                                if engine_cfg is not None
                                and engine_cfg.generative
                                else None)).start()
    print(f"fleet gateway on :{frontend.port} "
          f"(stream {args.stream}, engine ttl {args.engine_ttl:g}s)",
          flush=True)
    if trace_sample > 0:
        print(f"fleet trace plane: sampling {trace_sample:g} of "
              "requests; GET /trace/<request_id> serves merged "
              "cross-process timelines", flush=True)
    if gateway_id:
        print(f"gateway replica {gateway_id} (leader lease ttl "
              f"{args.leader_ttl:g}s; control loops act only while "
              "this replica leads)", flush=True)
    rollout = None
    # versioned rollout: the controller converges the fleet
    # onto the newest PUBLISHED checkpoint version, one engine at a
    # time (POST /rollout pins a version; GET /rollout/status watches).
    # The engine config's params.rollout block seeds the knobs — ONE
    # block drives both sides of the protocol — and explicit gateway
    # flags override.
    rollout_dir = args.rollout_dir or (
        engine_cfg.rollout_model_dir if engine_cfg else None)
    if rollout_dir:
        rollout_interval = args.rollout_interval if args.rollout_interval \
            is not None else (engine_cfg.rollout_poll_interval_s
                              if engine_cfg else 1.0)
        rollout_timeout = args.rollout_engine_timeout \
            if args.rollout_engine_timeout is not None else (
                engine_cfg.rollout_engine_timeout_s if engine_cfg
                else 60.0)
        if rollout_timeout <= 0 or rollout_interval <= 0:
            raise SystemExit("--rollout-interval and "
                             "--rollout-engine-timeout must be > 0")
        from analytics_zoo_tpu_torch.serving.rollout import RolloutController
        rollout = RolloutController(
            broker.clone(), args.stream, rollout_dir,
            frontend.fleet,
            poll_interval_s=rollout_interval,
            engine_timeout_s=rollout_timeout,
            # replicated gateway: every replica accepts
            # POST /rollout (the pin persists in the control hash) but
            # only the leader's loop directs engines
            leader_fn=frontend.is_leader).start()
        frontend.set_rollout(rollout)
        print(f"rollout controller watching {rollout_dir} "
              f"(poll {rollout_interval:g}s, engine timeout "
              f"{rollout_timeout:g}s)", flush=True)
    import threading

    scaler = None
    children = []
    retired = []        # SIGTERMed, still draining: shutdown reaps them
    stopping = threading.Event()
    if args.autoscale:
        if engine_cfg is None:
            raise SystemExit("--autoscale needs --engine-config (the "
                             "serving config spawned engines run)")
        # config knobs (params.autoscale) seed the defaults; explicit
        # gateway flags override
        knobs = dict(engine_cfg.autoscale or {})
        knobs["min_engines"] = args.min_engines \
            if args.min_engines is not None \
            else knobs.get("min_engines", 1)
        knobs["max_engines"] = args.max_engines \
            if args.max_engines is not None \
            else knobs.get("max_engines", 4)

        def spawn():
            if stopping.is_set():
                # a tick wedged in broker I/O can outlive the 5 s join
                # in scaler.stop() and fire after shutdown reaped the
                # children — it must not orphan a fresh engine
                return None
            children.append(subprocess.Popen(
                [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.cli",
                 "start", "--config", args.engine_config,
                 "--engine-id", "auto"]))
            return children[-1]

        def retire() -> bool:
            # newest live child first: LIFO keeps long-lived engines'
            # warm OS caches; a clean SIGTERM drains + deregisters.
            # The retiree moves to `retired` (not dropped): shutdown
            # must still wait on — and, if it wedges draining, kill —
            # every child this gateway ever spawned
            for p in reversed(children):
                if p.poll() is None:
                    p.terminate()
                    children.remove(p)
                    retired.append(p)
                    return True
            return False

        from analytics_zoo_tpu_torch.serving.fleet import FleetAutoscaler
        scaler = FleetAutoscaler(
            frontend.fleet, broker.clone(), args.stream, spawn, retire,
            # an admission-enabled gateway already samples the stream
            # depth on its own cadence: share the probe instead of
            # running a second poller against the same stream (and
            # flapping the shared serving_backlog_depth gauge)
            backlog_fn=admission.backlog if admission is not None
            else None,
            # follower replicas observe but never spawn/retire — two
            # autoscalers holding min_engines would double-provision
            leader_fn=frontend.is_leader,
            **knobs).start()
        print(f"autoscaler: engines [{scaler.min_engines}, "
              f"{scaler.max_engines}], backlog "
              f"{scaler.backlog_low:g}/{scaler.backlog_high:g} per "
              f"engine, burn>={scaler.burn_high:g} scales up", flush=True)

    def shutdown():
        stopping.set()
        if rollout is not None:
            rollout.stop()
        if scaler is not None:
            scaler.stop()
        for p in children:
            if p.poll() is None:
                p.terminate()
        for p in children + retired:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
        frontend.stop()

    return _run_until_signal(shutdown)


def cmd_broker(args) -> int:
    from analytics_zoo_tpu_torch.serving.broker import TCPBrokerServer
    srv = TCPBrokerServer(host=args.host, port=args.port).start()
    print(f"broker listening on {srv.host}:{srv.port}", flush=True)
    return _run_until_signal(srv.stop)


def cmd_redis(args) -> int:
    """Standalone RESP2 stream/hash server (`redis://` brokers connect to
    it with the real wire protocol; swap in a production Redis freely)."""
    from analytics_zoo_tpu_torch.serving.redis_server import MiniRedisServer
    srv = MiniRedisServer(host=args.host, port=args.port).start()
    print(f"mini-redis listening on {srv.url}", flush=True)
    return _run_until_signal(srv.stop)


def cmd_metrics(args) -> int:
    import urllib.request
    url = args.url
    if not url.startswith(("http://", "https://")):
        raise SystemExit(
            f"metrics is served by the HTTP frontend; expected an http(s) "
            f"URL (host:http_port), got {url!r}")
    # --prometheus negotiates the text exposition (what a scraper sees);
    # default stays the JSON timer snapshot
    headers = {"Accept": "text/plain"} if getattr(
        args, "prometheus", False) else {}
    req = urllib.request.Request(url.rstrip("/") + "/metrics",
                                 headers=headers)
    print(urllib.request.urlopen(req, timeout=10).read().decode())
    return 0


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(prog="analytics-zoo-serving")
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("start", help="run the serving loop")
    ps.add_argument("--config", required=True)
    ps.add_argument("--num-replicas", default=None,
                    help="override params.num_replicas: an integer, or "
                         "'auto' for one replica per local device")
    ps.add_argument("--placement", choices=["replicated", "sharded"],
                    default=None,
                    help="override params.placement")
    ps.add_argument("--mesh", default=None,
                    help="override params.mesh: the sharded placement's "
                         'device-mesh factorization, e.g. '
                         '"data=1,fsdp=2,tensor=4" (not ported: raises '
                         "naming ROADMAP.md queue 1, item 7b)")
    ps.add_argument("--compile-cache-dir", default=None,
                    help="override params.compile_cache_dir: the "
                         "persistent compile cache (kernel libraries and "
                         "capture records) warmup reads and writes")
    ps.add_argument("--device", default=None,
                    help="override params.device: where the engine "
                         "serves (cuda, cuda:<n> or cpu; default cuda)")
    ps.add_argument("--engine-id", default=None,
                    help="fleet mode: this engine's identity as one of "
                         "N co-consumers ('auto' generates a unique id; "
                         "enables heartbeats + the claim sweep)")
    ps.add_argument("--partitions", type=int, default=None,
                    help="override params.partitions: split the request "
                         "stream into N hash-keyed partition streams "
                         "leased across the fleet (needs --engine-id; "
                         "1 = the legacy single stream)")
    ps.add_argument("--reshard", action="store_true",
                    help="acknowledge a partition-count change against "
                         "a live fleet's broker meta (in-flight records "
                         "on the old layout may strand until every "
                         "engine restarts on the new count)")
    ps.set_defaults(fn=cmd_start)
    pg = sub.add_parser("gateway", help="run an engine-less fleet "
                                        "gateway frontend")
    pg.add_argument("--broker", default="memory",
                    help="broker url the fleet shares "
                         "(tcp://h:p | redis://h:p)")
    pg.add_argument("--host", default="0.0.0.0")
    pg.add_argument("--port", type=int, default=10020)
    pg.add_argument("--stream", default="serving_stream")
    pg.add_argument("--engine-ttl", type=float, default=6.0,
                    help="seconds without a heartbeat before an engine "
                         "counts dead")
    pg.add_argument("--tokens-per-second", type=float, default=None)
    pg.add_argument("--autoscale", action="store_true",
                    help="run the SLO-driven engine autoscaler on this "
                         "gateway (spawns/retires 'start --engine-id "
                         "auto' children; needs --engine-config)")
    pg.add_argument("--engine-config", default=None,
                    help="serving config the autoscaler's spawned "
                         "engines run (its params.autoscale block "
                         "seeds the scaler's thresholds)")
    pg.add_argument("--min-engines", type=int, default=None,
                    help="autoscaler floor (default: config, else 1)")
    pg.add_argument("--max-engines", type=int, default=None,
                    help="autoscaler ceiling (default: config, else 4)")
    pg.add_argument("--admission-tiers", default=None,
                    help="comma-joined priority tiers, lowest first "
                         "(enables tiered 429 admission on /predict)")
    pg.add_argument("--admission-max-backlog", type=int, default=512,
                    help="backlog at which even the top tier gets 429s")
    pg.add_argument("--rollout-dir", default=None,
                    help="run the versioned-rollout controller on this "
                         "gateway, watching this checkpoint root for "
                         "PUBLISHED versions (default: the engine "
                         "config's params.rollout.model_dir — one "
                         "block drives both sides)")
    pg.add_argument("--rollout-interval", type=float, default=None,
                    help="rollout controller poll cadence in seconds "
                         "(default: engine config "
                         "params.rollout.poll_interval_s, else 1)")
    pg.add_argument("--rollout-engine-timeout", type=float, default=None,
                    help="seconds an alive engine may take to convert "
                         "before it is skipped as a straggler "
                         "(default: engine config "
                         "params.rollout.engine_timeout_s, else 60)")
    pg.add_argument("--partitions", type=int, default=None,
                    help="hash-route /predict enqueues across N "
                         "partition streams — must match the engines' "
                         "params.partitions (default: engine config, "
                         "else 1)")
    pg.add_argument("--gateway-id", default=None,
                    help="run as one REPLICA of a replicated gateway "
                         "('auto' generates an id): a leader lease on "
                         "the broker elects which replica's control "
                         "loops act; every replica serves reads and "
                         "accepts POST /rollout")
    pg.add_argument("--leader-ttl", type=float, default=3.0,
                    help="seconds without a renewal before the gateway "
                         "leader lease is up for takeover")
    pg.add_argument("--trace-sample", type=float, default=None,
                    help="fleet trace plane: head-sampling "
                         "rate in [0, 1] for cross-process request "
                         "traces (default: the engine config's "
                         "params.trace_sample, else 0 = off); "
                         "GET /trace/<request_id> works regardless")
    pg.set_defaults(fn=cmd_gateway)
    pb = sub.add_parser("broker", help="run a standalone TCP broker")
    pb.add_argument("--host", default="0.0.0.0")
    pb.add_argument("--port", type=int, default=6379)
    pb.set_defaults(fn=cmd_broker)
    pr = sub.add_parser("redis", help="run the in-package RESP2 server")
    pr.add_argument("--host", default="0.0.0.0")
    pr.add_argument("--port", type=int, default=6379)
    pr.set_defaults(fn=cmd_redis)
    pm = sub.add_parser("metrics", help="fetch frontend metrics")
    pm.add_argument("--url", required=True)
    pm.add_argument("--prometheus", action="store_true",
                    help="request Prometheus text exposition "
                         "(Accept: text/plain)")
    pm.set_defaults(fn=cmd_metrics)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
