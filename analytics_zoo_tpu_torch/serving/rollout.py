"""Versioned zero-downtime model rollout.

Copied from `analytics_zoo_tpu/serving/rollout.py` (L1-896):
`rollout_key`, `default_params_loader` (L80), `EngineRolloutAgent` (L88)
and `RolloutController` (L430). What differs in the port:

- a checkpoint holds the JAX package's parameter tree
  (`learn/checkpoint.py`); `default_params_loader` maps it onto the served
  module's state dict (`convert.state_from_jax` after the net's
  `_remap_loaded`, for a Keras-style net) so that
  `InferenceModel.swap_params` takes it. A tree that already is a flat
  state dict of the module passes through;
- the JAX package counts XLA executables across the swap and canary; the
  port counts kernel builds (`kernels._build.build_events()`), with the
  same "0 on a same-structure swap" contract, and records whether the
  warmed buckets are the same after the swap as before;
- `jax.tree_util` becomes the port's `common/tree.py`.

The reference platform's whole point is models that keep serving while
the system around them changes (ClusterServing decouples model
artifacts from the always-on Flink/Redis data plane); until now this
fleet loaded params once at startup, so a new checkpoint meant
restarting engines and eating a serving gap. This module closes the
loop that auto-resume training opened — it continuously publishes
CRC-disciplined versioned checkpoints; the fleet now picks them up
live, one engine at a time, with the traffic never stopping.

Two halves over the broker that already carries the data plane:

- **`RolloutController`** (the gateway): watches a checkpoint dir
  through the PUBLISH-marker gate (`learn/checkpoint.py`: a version is
  visible only once params, opt_state and the int8 sidecar are ALL
  durable — a torn or mid-write version cannot be observed), and
  converges the fleet onto the newest published, non-quarantined
  version by directing ONE engine at a time through the
  `rollout:<stream>` control hash. Convergence is judged on the
  heartbeat rows: an engine reports `model_version` only after its
  swap's canary passed, so the beat is the commit. The controller's
  whole goal state is derivable from (published versions, quarantine
  set, heartbeat versions) — a controller killed mid-rollout and
  restarted simply re-observes a mixed fleet and resumes converging
  it, which is exactly the `--chaos-rollout` contract.

- **`EngineRolloutAgent`** (each engine): polls the control hash; when
  a directive targets this engine it drains dispatch
  (`pause_intake()` + `quiesce()` — no mixed-version batches), calls
  `InferenceModel.swap_params` (same tree structure ⇒ the new weights
  are written into the live tensors, which the captured CUDA graphs read
  — **zero kernel builds, zero captures**; changed structure ⇒ honest
  re-warmup, and recapture, through the existing bucket path; the agent
  keeps a copy of the old state for the rollback),
  canaries the new version with the supervisor's existing
  `probe_replica` machinery plus a golden-output delta gate, and only then reports the new version in
  its heartbeat. A failed canary swaps the old params back and VETOES
  the version — the controller quarantines it fleet-wide and walks
  every already-converted engine back.

Failure semantics ride the claim-sweep rails: an engine SIGKILLed mid-swap
never beats the new version, so the controller skips it and its unacked
backlog claim-sweeps to peers (zero accepted-record loss); a dead
gateway leaves the fleet serving whatever it serves until a new
controller converges it.

Control hash (`rollout:<stream>`):

    directive      {"version", "run_dir", "target"}
    quarantine     {"<version>": "<reason>", ...}
    veto:<engine>  {"version", "reason", "scope", "engine_id"}

Registry families: `serving_rollout_state` (0 idle / 1 rolling /
2 rolled_back), `serving_rollout_transitions_total{state,version}`,
`serving_rollout_rollbacks_total{version}`, and the engine-side
`serving_model_version` (server.py).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from analytics_zoo_tpu_torch.common.tree import tree_leaves, tree_map
from analytics_zoo_tpu_torch.kernels import _build

log = logging.getLogger("analytics_zoo_tpu_torch.serving.rollout")

ROLLOUT_KEY_PREFIX = "rollout:"
STATE_VALUES = {"idle": 0, "rolling": 1, "rolled_back": 2}


def rollout_key(stream: str) -> str:
    """The broker hash carrying the rollout control plane."""
    return ROLLOUT_KEY_PREFIX + stream


def default_params_loader(run_dir: str, version: int, module=None):
    """Load the param tree of one published checkpoint version — the
    engine agent's default way from a directive to weights. With the
    served `module` (`InferenceModel.current_params()`), the JAX-layout
    tree becomes its state dict: a Keras-style net's through
    `_remap_loaded` and `convert.state_from_jax`; a flat tree keyed like
    the module's state dict is returned as it is."""
    from analytics_zoo_tpu_torch.learn.checkpoint import load_checkpoint
    params, _, _ = load_checkpoint(run_dir, version)
    if module is None or not hasattr(module, "_remap_loaded"):
        return params
    if isinstance(params, dict) and set(params) == set(module.state_dict()):
        return params
    from analytics_zoo_tpu_torch import convert
    return convert.state_from_jax(module._remap_loaded(params), module)


class EngineRolloutAgent:
    """One engine's side of a rollout: watch the control hash, hot-swap
    on directive, canary, report (heartbeat) or veto (control hash).

    `params_loader(run_dir, version) -> params` maps a directive to a
    weight tree (default: `learn.checkpoint.load_checkpoint`; pass a
    wrapper applying `net._remap_loaded` for architectures that rename
    layers). `golden_tolerance` bounds how far the new version's output
    on the golden input may move from the old version's (relative
    max-abs delta; None = finiteness-only gate — versions legitimately
    change outputs, the gate exists to catch garbage)."""

    def __init__(self, serving, broker, stream: Optional[str] = None,
                 params_loader: Optional[Callable[[str, int], Any]] = None,
                 poll_interval_s: float = 0.5,
                 drain_timeout_s: float = 10.0,
                 canary_timeout_s: float = 10.0,
                 golden_tolerance: Optional[float] = None,
                 registry=None):
        if serving.engine_id is None:
            raise ValueError(
                "rollout needs a fleet identity: start the engine with "
                "engine_id set — the directive targeting and the "
                "heartbeat version report both key on it")
        self.serving = serving
        self.broker = broker
        self.stream = stream or serving.stream
        self.key = rollout_key(self.stream)
        self.engine_id = serving.engine_id
        self.params_loader = params_loader or (
            lambda run_dir, version: default_params_loader(
                run_dir, version, serving.model.current_params()))
        self.poll_interval_s = max(0.05, float(poll_interval_s))
        self.drain_timeout_s = float(drain_timeout_s)
        self.canary_timeout_s = float(canary_timeout_s)
        self.golden_tolerance = golden_tolerance
        self._vetoed: set = set()
        # engine-scope refusals (load failures) retry after a backoff
        # instead of joining the permanent veto set: the failure was a
        # fact about THIS HOST at that moment (mount down, replication
        # lag) — once the controller's straggler entry expires and the
        # directive returns, the repaired engine must be able to apply
        self._refused_until: Dict[int, float] = {}
        self.last_swap: Optional[Dict[str, Any]] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if registry is None:
            from analytics_zoo_tpu_torch.observability.registry import \
                get_registry
            registry = get_registry()
        self._transitions = registry.counter(
            "serving_rollout_transitions_total",
            "rollout state transitions, by state and model version")
        self._rollbacks = registry.counter(
            "serving_rollout_rollbacks_total",
            "rollouts rolled back after a failed canary or a "
            "fleet-wide version quarantine, by model version")

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "EngineRolloutAgent":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop,
                name=f"serving-rollout-{self.engine_id}", daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self):
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — the loop must live
                log.warning("rollout agent poll failed (%s: %s); "
                            "retrying next interval",
                            type(e).__name__, e)

    # -- control-plane poll ------------------------------------------------
    def poll_once(self) -> Optional[str]:
        """One control-hash check; applies at most one directive.
        Returns the outcome ("swapped"/"vetoed") when a swap ran."""
        raw = self.broker.hget(self.key, "directive")
        if not raw:
            return None
        try:
            d = json.loads(raw)
        except (TypeError, ValueError):
            return None
        if d.get("target") != self.engine_id:
            return None
        version = int(d["version"])
        if version == self.serving.model_version \
                or version in self._vetoed \
                or str(version) in self._quarantined():
            return None
        if time.monotonic() < self._refused_until.get(version, 0.0):
            return None          # load-failure backoff; retried after
        return self.apply(version, d.get("run_dir"))

    def _quarantined(self) -> Dict[str, str]:
        try:
            raw = self.broker.hget(self.key, "quarantine")
            return json.loads(raw) if raw else {}
        except Exception:  # noqa: BLE001 — treat unknown as empty
            return {}

    def _veto(self, version: int, reason: str,
              scope: str = "version"):
        """Publish a refusal. `scope="version"` is evidence AGAINST THE
        VERSION (a canary failed on healthy hardware) — the controller
        quarantines it fleet-wide. `scope="engine"` is evidence about
        THIS ENGINE only (its checkpoint mount is broken, the artifact
        hasn't replicated here yet) — the controller skips the engine
        as a straggler; one sick mount must never poison a version
        every other engine would serve happily."""
        if scope == "version":
            self._vetoed.add(version)
            # the engine really did roll its own swap back — counted
            # HERE, once; the controller's campaign abandonment shows
            # in serving_rollout_transitions_total{state="rolled_back"}
            self._rollbacks.inc(version=str(version))
        else:
            self._refused_until[version] = time.monotonic() \
                + max(5.0, 10 * self.poll_interval_s)
        try:
            self.broker.hset(self.key, f"veto:{self.engine_id}",
                             json.dumps({"version": version,
                                         "reason": reason,
                                         "scope": scope,
                                         "engine_id": self.engine_id}))
        except Exception as e:  # noqa: BLE001 — the rollback already
            # happened locally; the controller's engine-timeout is the
            # backstop for a veto that never lands
            log.warning("veto publish failed (%s: %s)",
                        type(e).__name__, e)
        log.warning("engine %s refused model version %d (%s scope): %s",
                    self.engine_id, version, scope, reason)

    # -- the swap ----------------------------------------------------------
    def _golden_input(self, model):
        """The canary batch: the most recent input any replica handled
        successfully (the supervisor's canary discipline), falling back
        to a batch built from the warmup sample when no traffic has
        flowed yet. None = nothing credible to probe with (the gate is
        then vacuous — there is also nothing the new version could
        corrupt an answer for)."""
        x = model._last_good_input
        if x is None:
            x = model._last_input
        if x is None and model._warmup_sample is not None:
            x = tree_map(
                lambda a: np.ascontiguousarray(
                    np.broadcast_to(a[None], (1,) + a.shape)),
                model._warmup_sample)
        return x

    def _canary(self, model, x, old_out):
        """The admission gate for a just-swapped version: every HEALTHY
        replica must answer the golden batch through the supervisor's
        existing probe machinery, the pooled output must be finite, and
        (with a tolerance configured) it must sit within the golden
        delta of the OLD version's output on the same input. Replicas
        the supervisor had already quarantined BEFORE the swap are not
        probed — a pre-existing sick chip is a fact about the chip, and
        letting it veto would poison every future version fleet-wide."""
        if model._replicas is not None:
            sick = set(model.quarantined_replicas())
            for rep in range(len(model._replicas)):
                if rep in sick:
                    continue
                if not model.probe_replica(
                        rep, x, timeout_s=self.canary_timeout_s):
                    return False, f"replica {rep} failed the canary probe"
        try:
            new_out = self._out_leaves(model.predict(x))
        except Exception as e:  # noqa: BLE001 — a failing canary IS
            return False, f"canary forward raised {type(e).__name__}: {e}"
        for leaf in new_out:
            if leaf.dtype.kind in "fc" and not np.all(np.isfinite(leaf)):
                return False, "canary output is not finite"
        if self.golden_tolerance is not None and old_out is not None \
                and len(old_out) == len(new_out):
            # relative delta PER LEAF, worst ratio wins: a shared
            # denominator would let a large-magnitude logits head mask
            # total corruption of a small-magnitude probability head
            delta = 0.0
            for o, n in zip(old_out, new_out):
                if o.shape != n.shape or o.dtype.kind not in "fc":
                    continue
                denom = max(float(np.max(np.abs(o))), 1e-6)
                delta = max(delta, float(np.max(np.abs(
                    n.astype(np.float64) - o.astype(np.float64))))
                    / denom)
            if not delta <= self.golden_tolerance:
                return False, (f"golden-output delta {delta:.4g} exceeds "
                               f"tolerance {self.golden_tolerance:g}")
        return True, None

    @staticmethod
    def _out_leaves(out) -> List[np.ndarray]:
        """Model outputs as flat ndarray leaves — multi-output models
        (dict/tuple predictions) gate per leaf instead of tripping
        np.isfinite on an object array."""
        return [np.asarray(leaf) for leaf in tree_leaves(out)]

    def apply(self, version: int, run_dir: str) -> str:
        """Drain → swap → canary → report-or-rollback, one version on
        this engine. Every exit path resumes intake and re-arms the
        supervisor; the heartbeat only ever carries a version whose
        canary passed."""
        from analytics_zoo_tpu_torch.learn.checkpoint import \
            verify_publish_marker
        t0 = time.perf_counter()
        try:
            if not verify_publish_marker(run_dir, version):
                raise RuntimeError("version is not intact-published "
                                   "on this host")
            params = self.params_loader(run_dir, version)
        except Exception as e:  # noqa: BLE001 — a bad artifact must
            # refuse, not kill the agent. ENGINE scope: failing to
            # read the checkpoint here says nothing about the version
            # (broken mount, replication lag) — the fleet's other
            # engines must still get to serve it
            self._veto(version,
                       f"load failed: {type(e).__name__}: {e}",
                       scope="engine")
            self.last_swap = {"version": version, "outcome": "vetoed",
                              "reason": "load failed"}
            return "vetoed"
        serving, model = self.serving, self.serving.model
        sup = getattr(serving, "supervisor", None)
        serving.pause_intake()
        if sup is not None:
            # a restructured swap's first batches pay honest re-warmup
            # latency; judged against the old model's baseline they
            # would read as outliers and cascade a quarantine
            sup.suspend()
        try:
            drained = serving.quiesce(self.drain_timeout_s)
            if not drained:
                log.warning(
                    "pipeline did not fully drain within %.1fs before "
                    "swapping to version %d; the old version's tail "
                    "finishes on its own captured params",
                    self.drain_timeout_s, version)
            x = self._golden_input(model)
            old_out = None
            if x is not None:
                try:
                    old_out = self._out_leaves(model.predict(x))
                except Exception:  # noqa: BLE001 — no golden baseline
                    old_out = None
            # a copy: a same-structure swap writes the new version into
            # the live module's tensors (where the captured graphs read),
            # so the rollback needs the old values of its own
            old_params = {k: v.detach().clone() for k, v in
                          model.current_params().state_dict().items()}
            # kernel builds across the swap+canary: the 0-builds
            # contract is about THIS window (a same-structure swap
            # keeps every loaded kernel and warmed bucket), not about
            # whatever unrelated traffic does around it
            n_before = _build.build_events()["compiles"]
            warmed_before = set(getattr(model, "warmed_buckets", ()))
            mode = None
            local_fault = False
            try:
                mode = model.swap_params(params)
                ok, reason = (True, None) if x is None \
                    else self._canary(model, x, old_out)
            except Exception as e:  # noqa: BLE001 — a raising swap
                # (device OOM mid-device_put, indivisible shard on a
                # restructure) must restore-and-veto like a failed
                # canary, never leave the engine model-less. A RAISE
                # is a fact about THIS HOST's resources, not about the
                # version's outputs — engine scope
                ok = False
                local_fault = True
                reason = f"swap raised {type(e).__name__}: {e}"
            if not ok and (self._stop.is_set()
                           or serving._stop.is_set()):
                # a dying engine's canary verdict is not evidence: its
                # replicas are being torn down under the probe — a
                # routine single-engine restart mid-rollout must not
                # quarantine the version and roll the whole fleet back
                local_fault = True
                reason = f"{reason} (engine stopping)"
            ms = round((time.perf_counter() - t0) * 1e3, 2)
            swap_compiles = _build.build_events()["compiles"] - n_before
            warmed_kept = set(getattr(model, "warmed_buckets", ())) \
                == warmed_before
            if ok:
                serving.set_model_version(version)
                self._transitions.inc(state="swapped",
                                      version=str(version))
                self.last_swap = {"version": version, "mode": mode,
                                  "outcome": "swapped", "ms": ms,
                                  "swap_executables_delta":
                                      swap_compiles,
                                  "warmed_buckets_kept": warmed_kept}
                if serving.tracer is not None:
                    serving.tracer.add_span(
                        "rollout_swap", t0, time.perf_counter(),
                        cat="serving.rollout",
                        args={"version": version, "mode": mode,
                              "engine": self.engine_id})
                log.info("engine %s now serves model version %d "
                         "(%s swap, %.1f ms, drained=%s)",
                         self.engine_id, version, mode, ms, drained)
                return "swapped"
            try:
                model.swap_params(old_params)
            except Exception as e:  # noqa: BLE001 — the engine is now
                # model-less; keep intake paused via the health story
                # (every dispatch fails → replicas quarantine → the
                # engine reads not-ready) and say so loudly
                log.error(
                    "restoring the previous params after a failed "
                    "swap to version %d ALSO failed (%s: %s); this "
                    "engine needs a model reload", version,
                    type(e).__name__, e)
            self._veto(version, reason,
                       scope="engine" if local_fault else "version")
            self.last_swap = {"version": version, "mode": mode,
                              "outcome": "vetoed", "reason": reason,
                              "ms": ms,
                              "swap_executables_delta": swap_compiles}
            return "vetoed"
        finally:
            if sup is not None:
                sup.resume()
            serving.resume_intake()

    def status(self) -> Dict[str, Any]:
        return {"engine_id": self.engine_id,
                "model_version": self.serving.model_version,
                "last_swap": self.last_swap,
                "vetoed_versions": sorted(self._vetoed)}


class RolloutController:
    """The gateway's rollout brain: one control loop converging the
    fleet onto the newest published, non-quarantined checkpoint
    version, one engine at a time.

    The decision core is `tick(now)` — a (locked) function of the
    observed state: published versions on disk, the quarantine set
    (mirrored into the broker control hash so it survives gateway
    restarts), and the heartbeat-reported per-engine versions. Tests
    drive it directly; `start()` runs it on a stop-event-paced daemon
    thread (no untimed waits — see scripts/check_blocking_calls.py).

    Because the goal state is fully derivable from those three inputs,
    a controller killed at ANY point and restarted resumes correctly:
    a half-converted fleet is just a fleet where some engines don't
    report the newest published version yet."""

    def __init__(self, broker, stream: str, model_dir: str,
                 tracker, poll_interval_s: float = 1.0,
                 engine_timeout_s: float = 60.0,
                 leader_fn: Optional[Callable[[], bool]] = None,
                 registry=None):
        if poll_interval_s <= 0 or engine_timeout_s <= 0:
            raise ValueError("poll_interval_s and engine_timeout_s "
                             "must be > 0")
        self.broker = broker
        # replicated-gateway gate: when set, only the
        # replica whose leader lease holds runs the convergence core —
        # followers' ticks are no-ops, but request()/status() stay
        # live everywhere because the pin and quarantine both persist
        # in the control hash and the goal state derives from it
        self.leader_fn = leader_fn
        self.stream = stream
        self.key = rollout_key(stream)
        self.model_dir = model_dir
        self.tracker = tracker
        self.poll_interval_s = float(poll_interval_s)
        self.engine_timeout_s = float(engine_timeout_s)
        self.state = "idle"
        self.active_version: Optional[int] = None
        self.target_version: Optional[int] = None
        self.target_run_dir: Optional[str] = None
        self.rolling_back = False
        self.pending_engine: Optional[str] = None
        self._directed_at: Optional[float] = None
        self.converted: List[str] = []
        self.quarantined: Dict[str, str] = {}
        # engine -> (version it failed to convert to, when): skipped
        # (NOT a version quarantine — an agent-less or wedged ENGINE
        # must not poison every future version for the healthy rest of
        # the fleet). Entries expire after 10x engine_timeout_s so an
        # engine fixed in place (agent enabled, mount repaired) gets
        # re-tried without waiting for a new publish; a different goal
        # version or a heartbeat gap (restart) re-tries immediately
        self.stragglers: Dict[str, tuple] = {}
        self.force_version: Optional[int] = None
        # memoized publish-verification verdicts (stat-keyed): idle
        # polls must not re-CRC a multi-GB artifact set every second
        self._verify_cache: Dict = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if registry is None:
            from analytics_zoo_tpu_torch.observability.registry import \
                get_registry
            registry = get_registry()
        self._state_gauge = registry.gauge(
            "serving_rollout_state",
            "rollout controller state (0 idle, 1 rolling, "
            "2 rolled_back)")
        self._state_fn = (lambda: float(STATE_VALUES.get(self.state, 0)))
        self._state_gauge.set_function(self._state_fn)
        self._transitions = registry.counter(
            "serving_rollout_transitions_total",
            "rollout state transitions, by state and model version")
        self._rollbacks = registry.counter(
            "serving_rollout_rollbacks_total",
            "rollouts rolled back after a failed canary or a "
            "fleet-wide version quarantine, by model version")
        self._load_quarantine()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "RolloutController":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="serving-rollout-controller",
                daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._state_gauge.release_function(self._state_fn, freeze=True)

    def _loop(self):
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — the loop must live
                log.warning("rollout tick failed (%s: %s); retrying "
                            "next interval", type(e).__name__, e)

    # -- quarantine persistence -------------------------------------------
    def _load_quarantine(self):
        try:
            raw = self.broker.hget(self.key, "quarantine")
            if raw:
                self.quarantined.update(json.loads(raw))
        except Exception:  # noqa: BLE001 — broker blip: local set rules
            pass

    def _quarantine(self, version: int, reason: str):
        """Quarantine a version FLEET-WIDE: persisted in the control
        hash so agents refuse it and a restarted controller (or a
        peer gateway) never re-targets it."""
        self.quarantined[str(version)] = reason
        try:
            self.broker.hset(self.key, "quarantine",
                             json.dumps(self.quarantined))
        except Exception as e:  # noqa: BLE001 — retried next write
            log.warning("quarantine publish failed (%s: %s)",
                        type(e).__name__, e)
        log.warning("model version %d quarantined fleet-wide: %s",
                    version, reason)

    def _read_vetoes(self) -> List[Dict[str, Any]]:
        try:
            rows = self.broker.hgetall(self.key)
        except Exception:  # noqa: BLE001 — broker blip
            return []
        out = []
        for field, blob in rows.items():
            if not field.startswith("veto:"):
                continue
            try:
                out.append((field, json.loads(blob)))
            except (TypeError, ValueError):
                out.append((field, {}))
        for field, _ in out:
            try:
                self.broker.hdel(self.key, field)
            except Exception:  # noqa: BLE001 — re-read next tick
                pass
        return [v for _, v in out]

    # -- decision core -----------------------------------------------------
    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One control pass; returns "direct"/"advance"/"converged"/
        "rollback" when something happened, else None."""
        if self.leader_fn is not None and not self.leader_fn():
            return None          # follower: reads only, never directs
        with self._lock:
            return self._tick_locked(
                time.monotonic() if now is None else now)

    def _sync_pin_locked(self):
        """Adopt the broker-persisted operator pin. Any gateway replica
        accepts POST /rollout by writing the `pin` field; the leader's
        tick reads it here, so a kill-the-leader handover converges the
        in-flight request without the operator re-issuing it. A broker
        blip keeps the last-synced local value (never silently unpins)."""
        try:
            raw = self.broker.hget(self.key, "pin")
        except Exception:  # noqa: BLE001 — broker blip: local pin rules
            return
        if raw:
            try:
                self.force_version = int(json.loads(raw))
            except (TypeError, ValueError):
                pass
        else:
            self.force_version = None

    def _tick_locked(self, now: float) -> Optional[str]:
        self._sync_pin_locked()
        # vetoes first: a failed canary anywhere quarantines the
        # version before any further engine is directed at it; an
        # ENGINE-scope refusal (load failure — a fact about that
        # engine's disk, not the version) only stragglers the engine
        for veto in self._read_vetoes():
            v = veto.get("version")
            if v is None:
                continue
            if veto.get("scope") == "engine":
                eid = veto.get("engine_id")
                if eid:
                    log.warning(
                        "engine %s cannot load version %s (%s); "
                        "skipping it, the campaign continues", eid, v,
                        veto.get("reason", "load failed"))
                    self.stragglers[eid] = (int(v), now)
                    self._transitions.inc(state="engine_skipped",
                                          version=str(v))
                    if self.pending_engine == eid \
                            and self.target_version == int(v):
                        self.pending_engine = None
                continue
            if str(v) not in self.quarantined:
                self._quarantine(int(v), veto.get("reason", "vetoed"))
                if self.target_version == int(v):
                    # abandon the campaign; the idle branch below
                    # immediately re-targets the newest GOOD version,
                    # walking every converted engine back (the
                    # rollback itself is counted once, by the engine
                    # that restored its params)
                    self._transitions.inc(state="rolled_back",
                                          version=str(v))
                    self._reset_campaign(rolled_back=True)
        versions = self.tracker.versions()
        if versions is None:
            return None          # broker unreachable: no claim to make
        if self.state in ("rolling", "rolled_back"):
            return self._step_campaign(now, versions)
        return self._idle_step(now, versions)

    def _published_target(self):
        """(run_dir, version) the fleet SHOULD serve: the forced
        version when an operator pinned one, else the newest published
        version outside the quarantine set. A pin whose version gets
        quarantined (its canary failed somewhere) releases itself with
        a warning — quarantine evidence outranks the pin, and holding
        it would re-target the poisoned version forever."""
        from analytics_zoo_tpu_torch.learn.checkpoint import (
            latest_published_checkpoint, published_intact,
            resolve_checkpoint)
        if self.force_version is not None \
                and str(self.force_version) in self.quarantined:
            log.warning(
                "pinned version %d was quarantined (%s); releasing "
                "the pin", self.force_version,
                self.quarantined[str(self.force_version)])
            self.force_version = None
            try:
                # clear the persisted pin too, or the next sync would
                # re-adopt the poisoned version forever
                self.broker.hdel(self.key, "pin")
            except Exception:  # noqa: BLE001 — quarantine outranks the
                pass           # pin on every future sync anyway
        if self.force_version is not None:
            run_dir, v = resolve_checkpoint(self.model_dir,
                                            self.force_version)
            # the SAME memoized verifier as the watcher path: a pin
            # is held indefinitely, and re-CRCing the pinned artifact
            # set every poll tick is exactly the cost the cache exists
            # to avoid
            if not published_intact(run_dir, v,
                                    verify_cache=self._verify_cache):
                raise FileNotFoundError(
                    f"version {v} under {self.model_dir} is not "
                    "published")
            return run_dir, v
        return latest_published_checkpoint(
            self.model_dir, skip_versions=self.quarantined,
            verify_cache=self._verify_cache)

    def _needers(self, versions: Dict[str, Any], target: int) -> List[str]:
        """Alive engines that should convert to `target` — excluding
        stragglers already skipped for exactly this version (an engine
        with no rollout agent, or one wedged mid-swap, must not hang
        the campaign or poison the VERSION for the healthy rest)."""
        return sorted(
            e for e, ev in versions.items()
            if ev != target
            and self.stragglers.get(e, (None,))[0] != target)

    def _idle_step(self, now: float, versions: Dict[str, Any]):
        try:
            pub = self._published_target()
        except (OSError, ValueError) as e:
            # transient (NFS blip, mid-GC listing): log and HOLD —
            # clearing the operator's pin here would let the next tick
            # re-roll the very version they backed out of
            log.warning("rollout target resolution failed: %s", e)
            return None
        if pub is None:
            return None
        run_dir, v = pub
        # an engine that vanished and returned (restart) gets a fresh
        # chance, and straggler entries expire on a 10x-timeout backoff
        # (an engine fixed IN PLACE — agent enabled, mount repaired —
        # must not stay skipped until the next publish); entries for
        # other versions are inert either way
        for eid in [e for e, (_, ts) in self.stragglers.items()
                    if e not in versions
                    or now - ts > 10 * self.engine_timeout_s]:
            self.stragglers.pop(eid, None)
        needers = self._needers(versions, v)
        if not needers:
            if versions and all(ev == v for ev in versions.values()):
                # every alive engine serves the goal version
                self.rolling_back = False
                if self.active_version != v:
                    self.active_version = v
            return None
        # begin (or resume, after a controller restart) a campaign
        self.state = "rolled_back" if self.rolling_back else "rolling"
        self.target_version = v
        self.target_run_dir = run_dir
        self.converted = sorted(e for e, ev in versions.items()
                                if ev == v)
        self._transitions.inc(state=self.state, version=str(v))
        log.info("rollout %s: fleet -> version %d (%d engine(s) to "
                 "convert: %s)", self.state, v, len(needers), needers)
        return self._direct(now, needers[0])

    def _direct(self, now: float, engine: str) -> str:
        self.pending_engine = engine
        self._directed_at = now
        self._publish_directive()
        return "direct"

    def _publish_directive(self):
        """Idempotent: re-published every tick while an engine is
        pending, so a broker blip (or an engine that restarted and
        lost the directive) cannot strand the campaign — the agent
        ignores directives for the version it already serves (and for
        versions it vetoed or sees quarantined), so no freshness token
        is needed."""
        try:
            self.broker.hset(self.key, "directive", json.dumps(
                {"version": self.target_version,
                 "run_dir": self.target_run_dir,
                 "target": self.pending_engine}))
        except Exception as e:  # noqa: BLE001 — re-issued next tick
            log.warning("directive publish failed (%s: %s)",
                        type(e).__name__, e)

    def _step_campaign(self, now: float, versions: Dict[str, Any]):
        target = self.target_version
        engine = self.pending_engine
        if engine is not None and engine not in versions:
            # engine died mid-swap (SIGKILL): it never beat the new
            # version, its unacked backlog claim-sweeps to peers, and
            # when it restarts the idle branch converges it. Skip.
            log.warning("engine %s vanished mid-rollout; skipping "
                        "(its backlog redelivers to peers)", engine)
            self.pending_engine = None
        elif engine is not None and versions.get(engine) == target:
            self.converted.append(engine)
            self.pending_engine = None
            self._transitions.inc(state="engine_converted",
                                  version=str(target))
            log.info("engine %s converted to version %s (%d/%d)",
                     engine, target, len(set(self.converted)),
                     len(versions))
        elif engine is not None and self._directed_at is not None \
                and now - self._directed_at > self.engine_timeout_s:
            # alive but never converted — and never VETOED, so this is
            # not evidence against the version (a canary failure vetoes
            # within canary_timeout_s): an engine with no rollout
            # agent, or one wedged mid-swap. Skip the ENGINE, not the
            # version — quarantining here would let one legacy engine
            # poison every future publish for the healthy fleet
            log.warning(
                "engine %s did not convert to version %s within %gs; "
                "skipping it (re-tried when a new version publishes "
                "or the engine restarts)", engine, target,
                self.engine_timeout_s)
            self.stragglers[engine] = (target, now)
            self._transitions.inc(state="engine_skipped",
                                  version=str(target))
            self.pending_engine = None
        if self.pending_engine is None:
            needers = self._needers(versions, target)
            if not needers:
                state = self.state
                stragglers = sorted(
                    e for e, (v, _) in self.stragglers.items()
                    if v == target and e in versions)
                if stragglers:
                    self._transitions.inc(state="partial",
                                          version=str(target))
                    log.warning(
                        "rollout to version %s is PARTIAL: %s never "
                        "converted (skipped); the rest of the fleet "
                        "serves it", target, stragglers)
                else:
                    self._transitions.inc(state="converged",
                                          version=str(target))
                    log.info("fleet converged on model version %s (%s)",
                             target, state)
                    self.active_version = target
                self._reset_campaign(rolled_back=False)
                try:
                    self.broker.hdel(self.key, "directive")
                except Exception:  # noqa: BLE001 — agents ignore a
                    pass           # stale directive for their version
                return "partial" if stragglers else "converged"
            return self._direct(now, needers[0])
        self._publish_directive()
        return None

    def _reset_campaign(self, rolled_back: bool):
        self.rolling_back = rolled_back
        self.state = "idle"
        self.pending_engine = None
        self._directed_at = None
        self.target_version = None
        self.target_run_dir = None
        self.converted = []

    # -- operator surface (POST /rollout, GET /rollout/status) -------------
    def request(self, version: Optional[int] = None,
                unpin: bool = False) -> Dict[str, Any]:
        """Operator ask: roll the fleet to `version` (must be published
        and not quarantined; also the manual-rollback path — an OLDER
        published version is a legal target), or just poke the watcher
        (version None). A pinned version is STICKY: the watcher holds
        the fleet there — newer publishes included — until another
        version is pinned or `unpin` releases it (an operator who
        rolled back does not want the next tick re-rolling the version
        they just backed out of; quarantine it, or stay pinned).
        Raises ValueError on a quarantined version, FileNotFoundError
        on an unpublished one."""
        if unpin:
            with self._lock:
                self.force_version = None
            self.broker.hdel(self.key, "pin")
        if version is not None:
            from analytics_zoo_tpu_torch.learn.checkpoint import (
                published_intact, resolve_checkpoint)
            if str(int(version)) in self.quarantined:
                raise ValueError(
                    f"version {version} is quarantined: "
                    f"{self.quarantined[str(int(version))]}")
            run_dir, v = resolve_checkpoint(self.model_dir, int(version))
            # memoized like every other verification this controller
            # runs — the HTTP handler must not block on a full CRC
            # read of a multi-GB artifact set
            if not published_intact(run_dir, v,
                                    verify_cache=self._verify_cache):
                raise FileNotFoundError(
                    f"version {v} exists but is not published")
            with self._lock:
                self.force_version = v
            # the pin lives in the control hash, not in this replica:
            # ANY gateway accepts the request, and whichever replica
            # holds (or inherits) the leader lease converges it
            self.broker.hset(self.key, "pin", json.dumps(v))
        self.tick()
        return self.status()

    def status(self) -> Dict[str, Any]:
        with self._lock:
            # followers never tick, so surface the broker-persisted pin
            # here — GET /rollout/status answers the same on every
            # gateway replica
            self._sync_pin_locked()
            out = {
                "state": self.state,
                "active_version": self.active_version,
                "target_version": self.target_version,
                "pending_engine": self.pending_engine,
                "converted": sorted(set(self.converted)),
                "rolling_back": self.rolling_back,
                "pinned_version": self.force_version,
                "stragglers": {e: v for e, (v, _)
                               in self.stragglers.items()},
                "quarantined": dict(self.quarantined),
                "model_dir": self.model_dir,
            }
        versions = self.tracker.versions()
        out["fleet_versions"] = versions
        return out
