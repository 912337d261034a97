"""Fleet membership over the broker — heartbeats out, tracking in.

Copied from `analytics_zoo_tpu/serving/fleet.py` as it is (L1-604):
`engines_key` (L54), `HeartbeatPublisher` (L59), `FleetTracker` (L147),
`validate_autoscale` (L334) and `FleetAutoscaler` (L360).

Horizontal scale-out runs N `ClusterServing` engine processes
as co-consumers of one stream. The broker that already carries the data
plane carries the control plane too: each engine HSETs a heartbeat row
into `engines:<stream>` every `interval_s`, and the HTTP frontend — now
a fleet gateway — reads that hash to answer `/healthz` for the whole
fleet (200 while >= 1 engine is alive and ready, 503 + Retry-After when
none are) and to export `serving_engines_alive` / `serving_engines_total`.

No extra infrastructure: the reference platform leaned on Flink's
jobmanager for this; here the same Redis that queues records is the
membership registry, so a gateway and a fleet agree on liveness through
the one component they both already depend on.

Heartbeat row (JSON):

    {"engine_id": ..., "ts": <epoch seconds>, "ready": bool,
     "records_served": n, "records_read": n, "pid": n}

Liveness = the row's `ts` was observed to CHANGE within the last
`ttl_s` on the gateway's own monotonic clock — heartbeat PROGRESS, not
wall-clock arithmetic, so cross-host clock skew between engines and
the gateway can neither kill a healthy fleet nor keep a dead engine
alive. The cost of clock independence: right after a gateway (re)start
a crashed engine's leftover row reads as fresh for at most one TTL,
then ages out like any silent engine — self-correcting, and far
cheaper than 503ing a healthy skewed fleet. A cleanly stopping engine
deletes its row (HDEL) so the gateway notices immediately; a SIGKILLed
engine simply stops refreshing, ages out within the TTL — the same
window after which its unacked records become claimable by live peers
— and its dead row is purged from the hash once it sits 10x past the
TTL, so crash/restart churn under `engine_id: auto` cannot grow the
registry without bound.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from typing import Callable, Dict, Optional

from analytics_zoo_tpu_torch.serving.broker import Broker

log = logging.getLogger("analytics_zoo_tpu_torch.serving.fleet")

ENGINES_KEY_PREFIX = "engines:"


def engines_key(stream: str) -> str:
    """The broker hash that holds one heartbeat row per engine."""
    return ENGINES_KEY_PREFIX + stream


class HeartbeatPublisher:
    """Periodic heartbeat HSET from one engine, on its own thread and
    its own broker connection (the reader blocks in XREADGROUP windows
    and the sink may be mid-writeback; a heartbeat must never queue
    behind either). Publish failures are survived and logged once per
    outage — a broker blip must not kill the engine's membership, the
    next beat re-registers it."""

    def __init__(self, broker: Broker, stream: str, engine_id: str,
                 payload_fn: Callable[[], Dict], interval_s: float = 2.0,
                 registry=None):
        self.broker = broker
        self.key = engines_key(stream)
        self.engine_id = engine_id
        self.payload_fn = payload_fn
        self.interval_s = max(0.05, float(interval_s))
        if registry is None:
            from analytics_zoo_tpu_torch.observability.registry import \
                get_registry
            registry = get_registry()
        self._beats = registry.counter(
            "serving_engine_heartbeats_total",
            "fleet heartbeats successfully published to the broker, "
            "by engine")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._down = False
        # last payload_fn fields that published cleanly: a transient
        # telemetry error must degrade to "not ready" WITHOUT dropping
        # slow-moving facts the gateway acts on (model_version,
        # slo_burn) — a beat that suddenly loses its model_version
        # would read at the rollout controller as a version regression
        self._last_good_fields: Dict = {}

    def _publish_once(self) -> bool:
        payload = {"engine_id": self.engine_id, "ts": time.time(),
                   "pid": os.getpid()}
        try:
            fields = self.payload_fn() or {}
            payload.update(fields)
            self._last_good_fields = dict(fields)
        except Exception as e:  # noqa: BLE001 — a beat must still go out
            payload.update(self._last_good_fields)
            payload["ready"] = False
            payload["error"] = f"{type(e).__name__}: {e}"
        try:
            self.broker.hset(self.key, self.engine_id,
                             json.dumps(payload))
        except Exception as e:  # noqa: BLE001 — outage: next beat retries
            if not self._down:
                log.warning("heartbeat publish failed for %s (%s: %s); "
                            "retrying each interval", self.engine_id,
                            type(e).__name__, e)
                self._down = True
            return False
        if self._down:
            log.info("heartbeat publishing recovered for %s",
                     self.engine_id)
            self._down = False
        self._beats.inc(engine=self.engine_id)
        return True

    def _loop(self):
        while not self._stop.is_set():
            self._publish_once()
            self._stop.wait(self.interval_s)

    def start(self) -> "HeartbeatPublisher":
        self._thread = threading.Thread(
            target=self._loop, name=f"serving-heartbeat-{self.engine_id}",
            daemon=True)
        self._thread.start()
        return self

    def stop(self, deregister: bool = True):
        """Stop beating; with `deregister` (clean shutdown) the row is
        deleted so the gateway drops this engine immediately instead of
        waiting out the TTL."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if deregister:
            try:
                self.broker.hdel(self.key, self.engine_id)
            except Exception:  # noqa: BLE001 — best-effort deregistration
                pass


class FleetTracker:
    """The gateway's view of the fleet: polls `engines:<stream>` (rate-
    limited — /healthz and /metrics scrapes share one poll per
    `poll_min_interval_s`), classifies rows by heartbeat age, and
    exports `serving_engines_alive` (gauge, live) plus
    `serving_engines_total` (counter: distinct engines ever seen by
    this gateway). `alive_count()` answers None when the broker itself
    is unreachable — the gateway then has no claim about fleet health
    and `/healthz` must say so (503), not guess."""

    def __init__(self, broker: Broker, stream: str = "serving_stream",
                 ttl_s: float = 6.0, registry=None,
                 poll_min_interval_s: float = 0.25):
        self.broker = broker
        self.stream = stream
        self.key = engines_key(stream)
        self.ttl_s = float(ttl_s)
        self.poll_min_interval_s = max(0.0, float(poll_min_interval_s))
        if registry is None:
            from analytics_zoo_tpu_torch.observability.registry import \
                get_registry
            registry = get_registry()
        self.registry = registry
        self._lock = threading.Lock()
        self._last_poll = 0.0
        self._engines: Dict[str, Dict] = {}
        # eid -> (last ts VALUE seen, local monotonic when it changed):
        # liveness is judged by locally-observed heartbeat progress, so
        # cross-host wall-clock skew between an engine and the gateway
        # can neither kill a healthy fleet nor keep a dead engine alive
        self._last_change: Dict[str, tuple] = {}
        self._broker_ok = True
        self._polling = False      # single-flight guard for broker I/O
        self._seen = set()
        self._total = registry.counter(
            "serving_engines_total",
            "distinct serving engines that have registered a heartbeat "
            "with this gateway")
        self._alive_gauge = registry.gauge(
            "serving_engines_alive",
            "serving engines with a fresh heartbeat (live fleet size)")
        self._alive_fn = self._alive_metric
        self._alive_gauge.set_function(self._alive_fn)

    # -- polling -----------------------------------------------------------
    def poll(self, force: bool = False) -> Optional[Dict[str, Dict]]:
        """Refresh (rate-limited) and return the engine table
        {engine_id: row} with an `alive` bool per row; None when the
        broker is unreachable.

        Broker I/O happens OUTSIDE the tracker lock, single-flight: one
        thread fetches while every concurrent /predict admission check,
        /healthz, and /metrics gauge read answers instantly from cached
        state — a stalled broker costs ONE thread a socket timeout, it
        must not dam the whole gateway behind a lock (the gateway's job
        at that moment is the fast 503)."""
        with self._lock:
            now = time.monotonic()
            due = force or now - self._last_poll >= self.poll_min_interval_s
            if due and not self._polling:
                self._polling = True
                self._last_poll = now
            else:
                return None if not self._broker_ok \
                    else dict(self._engines)
        try:
            raw = self.broker.hgetall(self.key)
        except Exception as e:  # noqa: BLE001 — report unknown
            with self._lock:
                if self._broker_ok:
                    log.warning(
                        "fleet poll failed (%s: %s); fleet state "
                        "unknown until the broker answers",
                        type(e).__name__, e)
                self._broker_ok = False
                self._polling = False
            return None
        purge = []
        with self._lock:
            self._broker_ok = True
            self._polling = False
            now = time.monotonic()
            engines: Dict[str, Dict] = {}
            wall = time.time()
            for eid, blob in raw.items():
                try:
                    row = json.loads(blob)
                except (TypeError, ValueError):
                    row = {}
                ts = row.get("ts", 0.0)
                prev = self._last_change.get(eid)
                if prev is None or prev[0] != ts:
                    self._last_change[eid] = (ts, now)
                    age = 0.0
                else:
                    age = now - prev[1]
                row["age_s"] = round(age, 3)
                # wall-clock age is informational only — liveness
                # must not depend on two hosts' clocks agreeing
                wall_age = wall - ts
                row["wall_age_s"] = round(wall_age, 3) \
                    if math.isfinite(wall_age) else None
                row["alive"] = bool(age <= self.ttl_s)
                if age > 10 * self.ttl_s:
                    # bound the hash: under crash/restart churn with
                    # engine_id=auto every crash strands a row forever,
                    # growing every later poll and /metrics payload
                    purge.append(eid)
                    self._last_change.pop(eid, None)
                    continue
                engines[eid] = row
                if eid not in self._seen:
                    self._seen.add(eid)
                    self._total.inc()
            # rows HDEL'd elsewhere (clean stops) leave the ledger
            for eid in list(self._last_change):
                if eid not in raw:
                    self._last_change.pop(eid, None)
            self._engines = engines
            out = dict(engines)
        for eid in purge:       # broker I/O outside the lock, as above
            try:
                self.broker.hdel(self.key, eid)
            except Exception:  # noqa: BLE001 — next poll retries
                pass
        if purge:
            log.info("purged %d dead engine heartbeat row(s): %s",
                     len(purge), sorted(purge)[:8])
        return out

    def alive_count(self) -> Optional[int]:
        """Engines alive AND ready (an engine beating with ready=False —
        every replica quarantined, breaker open — is present but not
        servable capacity); None when the broker is unreachable."""
        engines = self.poll()
        if engines is None:
            return None
        return sum(1 for row in engines.values()
                   if row.get("alive") and row.get("ready", True))

    def versions(self) -> Optional[Dict[str, object]]:
        """{engine_id: model_version} for every ALIVE engine (None per
        engine when it predates versioned serving, e.g. mid-rollout
        from an unversioned fleet); None when the broker is
        unreachable. The rollout controller's convergence view."""
        engines = self.poll()
        if engines is None:
            return None
        return {eid: row.get("model_version")
                for eid, row in engines.items() if row.get("alive")}

    def _alive_metric(self) -> float:
        n = self.alive_count()
        return float("nan") if n is None else float(n)

    @property
    def retry_after_s(self) -> int:
        """What a fleet-wide 503 tells clients: a replacement engine
        shows up within one heartbeat TTL."""
        return max(1, int(round(self.ttl_s)))

    def summary(self) -> Dict:
        """The /metrics JSON section."""
        engines = self.poll()
        if engines is None:
            return {"broker": "unreachable", "alive": None,
                    "engines_seen": len(self._seen)}
        return {
            "alive": sum(1 for r in engines.values() if r.get("alive")),
            "ready": sum(1 for r in engines.values()
                         if r.get("alive") and r.get("ready", True)),
            "engines_seen": len(self._seen),
            # the live version set: length 1 = converged
            # fleet; >1 = a rollout in flight (or wedged)
            "model_versions": sorted(
                {r.get("model_version") for r in engines.values()
                 if r.get("alive")
                 and r.get("model_version") is not None}),
            "engines": engines,
        }

    def close(self):
        """Release the gauge closure so a stopped gateway does not pin
        this tracker (and its broker connection) in the process-wide
        registry."""
        self._alive_gauge.release_function(self._alive_fn, freeze=True)


def validate_autoscale(knobs: Dict, prefix: str = "") -> None:
    """Shared validation for the autoscaler's knob set — called by
    `FleetAutoscaler.__init__` AND `ServingConfig._validate_elastic`
    so the bounds cannot drift between config load and construction
    (a config-accepted value the constructor rejects would crash
    `cmd_gateway` after the frontend is already up). `prefix` names
    the config spelling ("params.autoscale.") in load-time errors."""
    if knobs["min_engines"] < 1:
        raise ValueError(
            f"{prefix}min_engines={knobs['min_engines']} must be >= 1")
    if knobs["max_engines"] < knobs["min_engines"]:
        raise ValueError(
            f"{prefix}max_engines={knobs['max_engines']} must be >= "
            f"min_engines={knobs['min_engines']}")
    if knobs["backlog_low"] >= knobs["backlog_high"]:
        raise ValueError(
            f"{prefix}backlog_low={knobs['backlog_low']:g} must be "
            f"below backlog_high={knobs['backlog_high']:g}: equal "
            "thresholds flap")
    for name in ("up_stable_s", "down_stable_s", "cooldown_s",
                 "interval_s", "spawn_grace_s", "burn_high"):
        if knobs[name] <= 0:
            raise ValueError(
                f"{prefix}{name}={knobs[name]:g} must be > 0")


class FleetAutoscaler:
    """SLO-driven engine autoscaling on the gateway.

    A control loop that watches two signals and spawns/retires engine
    processes through caller-supplied hooks:

    - **backlog depth** — the broker's stream depth (undelivered plus
      in-flight records; the sink XDELs on commit, so this is exactly
      the unserved work). Scaling on queue depth instead of request
      rate is what makes the loop model-free: an expensive model backs
      the queue up at a request rate a cheap model would shrug off.
    - **SLO burn rate** — the worst ``slo_burn`` any alive engine
      reports in its heartbeat row (`ClusterServing._heartbeat_payload`
      publishes it when objectives are configured): latency already
      burning budget is a scale-up signal even while the backlog still
      looks shallow.

    Decisions are hysteretic: the overload signal must hold for
    ``up_stable_s`` before a spawn, the idle signal for
    ``down_stable_s`` before a retire, and any action starts a
    ``cooldown_s`` window in which no further action fires — a spike
    cannot flap the fleet, and scale-down is deliberately the slower
    direction. Bounds are hard: never below ``min_engines``, never
    above ``max_engines``.

    Scale-up is cheap by construction: every engine loads the kernel
    libraries the first build left in the package's build directory,
    so a new process compiles nothing. Scale-down is a CLEAN stop
    (`retire_fn` should SIGTERM): the engine deregisters, drains, and
    whatever it had in-flight redelivers to peers via the claim sweep —
    proven under SIGKILL, so the graceful path is strictly safer.

    `spawn_fn()` must start one engine; `retire_fn()` must stop one and
    return True (False = nothing retirable, e.g. every child already
    exited — the desired count is then reconciled downward). The
    decision core is `tick(now)`, a pure function of the observed state
    and the clock, so tests drive it without threads or sleeps; `start`
    runs it on a daemon thread every `interval_s` (a timed Event.wait —
    the control path never parks untimed, see
    scripts/check_blocking_calls.py)."""

    def __init__(self, tracker: FleetTracker, broker: Broker,
                 stream: str, spawn_fn: Callable[[], object],
                 retire_fn: Callable[[], bool],
                 min_engines: int = 1, max_engines: int = 4,
                 backlog_high: float = 64.0, backlog_low: float = 8.0,
                 burn_high: float = 1.0,
                 up_stable_s: float = 2.0, down_stable_s: float = 10.0,
                 cooldown_s: float = 5.0, interval_s: float = 1.0,
                 spawn_grace_s: float = 30.0, registry=None,
                 backlog_fn: Optional[Callable[[], Optional[int]]]
                 = None,
                 leader_fn: Optional[Callable[[], bool]] = None):
        validate_autoscale({
            "min_engines": min_engines, "max_engines": max_engines,
            "backlog_high": backlog_high, "backlog_low": backlog_low,
            "burn_high": burn_high, "up_stable_s": up_stable_s,
            "down_stable_s": down_stable_s, "cooldown_s": cooldown_s,
            "interval_s": interval_s, "spawn_grace_s": spawn_grace_s})
        self.tracker = tracker
        self.broker = broker
        self.stream = stream
        self.spawn_fn = spawn_fn
        self.retire_fn = retire_fn
        # a gateway that already samples the stream (the admission
        # controller) shares its rate-limited probe via backlog_fn
        # instead of this loop running a second poller on the same key
        self.backlog_fn = backlog_fn
        # replicated gateway: only the leader replica's
        # autoscaler acts — two replicas both holding min_engines would
        # double-provision every scale-up. Followers tick as no-ops and
        # pick up instantly when the lease moves here.
        self.leader_fn = leader_fn
        self.min_engines = int(min_engines)
        self.max_engines = int(max_engines)
        self.backlog_high = float(backlog_high)
        self.backlog_low = float(backlog_low)
        self.burn_high = float(burn_high)
        self.up_stable_s = float(up_stable_s)
        self.down_stable_s = float(down_stable_s)
        self.cooldown_s = float(cooldown_s)
        self.interval_s = float(interval_s)
        self.spawn_grace_s = float(spawn_grace_s)
        self.desired = 0            # engines this autoscaler has live
        self._over_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._last_action = -float("inf")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if registry is None:
            from analytics_zoo_tpu_torch.observability.registry import \
                get_registry
            registry = get_registry()
        self._target_gauge = registry.gauge(
            "serving_engines_target",
            "engine count the autoscaler is currently holding the "
            "fleet at")
        self._decisions = registry.counter(
            "serving_autoscaler_decisions_total",
            "autoscaler actions by kind (up, down, hold_min)")
        self._backlog_gauge = registry.gauge(
            "serving_backlog_depth",
            "broker stream depth (enqueued records not yet committed) "
            "as last sampled by the elastic layer")

    # -- observed state ----------------------------------------------------
    def _backlog(self) -> Optional[int]:
        if self.backlog_fn is not None:
            try:
                return self.backlog_fn()
            except Exception:  # noqa: BLE001 — unknown, not fatal
                return None
        try:
            depth = int(self.broker.stream_depth(self.stream))
        except Exception:  # noqa: BLE001 — unknown, not fatal
            return None
        self._backlog_gauge.set(float(depth))
        return depth

    def _fleet_view(self):
        """(alive_ready_count, max_burn) from the heartbeat table; both
        None when the broker is unreachable."""
        engines = self.tracker.poll()
        if engines is None:
            return None, None
        alive = [r for r in engines.values()
                 if r.get("alive") and r.get("ready", True)]
        burns = [r.get("slo_burn") for r in alive
                 if isinstance(r.get("slo_burn"), (int, float))]
        return len(alive), (max(burns) if burns else None)

    # -- decision core (pure; tests drive it directly) ---------------------
    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One control-loop pass; returns "up"/"down" when an action
        fired, else None."""
        if self.leader_fn is not None and not self.leader_fn():
            return None          # follower replica: observe, never act
        now = time.monotonic() if now is None else now
        alive, burn = self._fleet_view()
        backlog = self._backlog()
        # reconcile desired with reality: children that died (or were
        # retired out from under us) must not leave the controller
        # believing capacity exists that doesn't. Only after
        # `spawn_grace_s`, though: a just-spawned engine needs process
        # start + warmup + first heartbeat before its absence from the
        # table means death — clamping sooner re-arms the spawn path
        # and double-provisions every scale-up (observed: cooldown <
        # engine cold-start spawned 3 engines for a 2-engine spike)
        if alive is not None and alive < self.desired \
                and now - self._last_action >= self.spawn_grace_s:
            self.desired = alive
        if self.desired < self.min_engines:
            # floor: hold the fleet at min_engines unconditionally —
            # also the initial ramp (desired starts at 0)
            self.spawn_fn()
            self.desired += 1
            self._decisions.inc(kind="hold_min")
            self._target_gauge.set(float(self.desired))
            self._last_action = now
            return "up"
        self._target_gauge.set(float(self.desired))
        if backlog is None and burn is None:
            # blind: no broker, no heartbeats — hold, reset hysteresis
            self._over_since = self._idle_since = None
            return None
        capacity = max(1, alive if alive is not None else self.desired)
        overloaded = (backlog is not None
                      and backlog > self.backlog_high * capacity) \
            or (burn is not None and burn >= self.burn_high)
        idle = (backlog is not None
                and backlog <= self.backlog_low * capacity) \
            and (burn is None or burn < self.burn_high / 2.0)
        self._over_since = (self._over_since or now) if overloaded \
            else None
        self._idle_since = (self._idle_since or now) if idle else None
        if now - self._last_action < self.cooldown_s:
            return None
        # while a previous spawn is still materializing (absent from the
        # heartbeat table, within the grace window), don't stack another
        # on the same overload signal — the backlog it was spawned for
        # hasn't seen its capacity yet
        spawn_pending = (alive is not None and alive < self.desired
                         and now - self._last_action
                         < self.spawn_grace_s)
        if overloaded and not spawn_pending \
                and self.desired < self.max_engines \
                and now - self._over_since >= self.up_stable_s:
            self.spawn_fn()
            self.desired += 1
            self._last_action = now
            self._over_since = None
            self._decisions.inc(kind="up")
            self._target_gauge.set(float(self.desired))
            log.info("autoscaler: scale UP to %d (backlog=%s burn=%s)",
                     self.desired, backlog, burn)
            return "up"
        if idle and self.desired > self.min_engines \
                and now - self._idle_since >= self.down_stable_s:
            if not self.retire_fn():
                # nothing retirable (children already exited on their
                # own): no action happened — don't log/count a phantom
                # scale-down or burn a cooldown on a no-op; the
                # reconcile clamp above will square `desired` with the
                # heartbeat table
                self._idle_since = None
                return None
            self.desired -= 1
            self._last_action = now
            self._idle_since = None
            self._decisions.inc(kind="down")
            self._target_gauge.set(float(self.desired))
            log.info("autoscaler: scale DOWN to %d (backlog=%s burn=%s)",
                     self.desired, backlog, burn)
            return "down"
        return None

    # -- lifecycle ---------------------------------------------------------
    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — the loop must live
                log.warning("autoscaler tick failed (%s: %s); retrying "
                            "next interval", type(e).__name__, e)

    def start(self) -> "FleetAutoscaler":
        if self._thread is None:
            self._stop.clear()
            # first tick inline: the min-engine floor must not wait one
            # interval before the fleet exists
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — loop recovers
                log.warning("autoscaler initial tick failed (%s: %s)",
                            type(e).__name__, e)
            self._thread = threading.Thread(
                target=self._loop, name="serving-autoscaler",
                daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
