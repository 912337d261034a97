"""Continuous-batching decode engine — pooled KV slots, per-step planning.

Copied from `analytics_zoo_tpu/serving/decode.py`: `_pow2_ladder` (L122),
`token_row_field` (L133, kept in `serving/client.py` and re-exported
here), `KVSlotPool` (L140), `StepPlan`, `PagedStepPlan`, `DecodeScheduler`
(L218), `_Sequence` and `DecodeServing` (L398), contiguous and paged, with
the prefix cache, chunked prefill, claim-sweep resume, preemption, the
watchdog and the writeback buffer. What differs in the port:

- the programs it calls run PyTorch on the card (`InferenceModel`'s
  generative half) and update the KV pools in place; the engine still
  rebinds ``pool.kv`` from each call's return, as the JAX engine does;
- each next token is an argmax on the device, and only the int ids are
  copied to the host (the JAX engine copies the whole logits, 6.4 MB a
  step at 32 slots of a 50257-token vocabulary); `torch.argmax` takes the
  first of tied maxima, as numpy's does;
- the JAX engine's "0 XLA compiles on the request path" becomes "0 kernel
  builds on the request path": `warmup_generative` builds and loads the
  decode-attention kernels before the engine starts, and captures every
  prefill and step program as a CUDA graph, which the engine's calls
  replay (`_run_step`, `_run_paged_step`, `_prefill_chunk_step`, and the
  crash-resume prefills of `_recover_record`'s sequences, through the same
  calls). The graphs write into the KV pool warmup allocated, so the
  engine serves from that pool (`InferenceModel.serving_kv`) where the
  JAX engine allocates its own: one engine at a time, from its
  construction (or `start`) to its `stop`; another engine on the same
  model meanwhile gets a pool of its own and runs eagerly.

`ClusterServing` serves fixed-shape forwards: plan ONE dispatch, run it,
write it back. Autoregressive generation breaks that shape — a request
is now a prompt plus up to `max_new` dependent steps, and padding every
sequence to the longest (then restarting the batch when all finish) is
the pad-to-max baseline vLLM/Orca showed 2-10x worse than iteration-
level scheduling. This module is that discipline on the existing rails:

- ``KVSlotPool`` — the KV cache is pre-allocated ONCE as
  ``[slots, heads, max_kv_len, head_dim]`` device buffers (one k/v pair
  per layer, built by the model's ``init_kv``). A sequence leases a
  slot row at admission and releases it at its final token — no
  allocation, no reshape, no copy ever happens on the request path.
  The ``serving_kv_slots_in_use`` gauge IS the admission signal: free
  slots are the only capacity that matters in decode mode.
- ``DecodeScheduler`` — generalizes the adaptive batch controller's
  "plan one dispatch" to "plan EVERY step": at each step boundary
  finished sequences free slots, queued prompts join (continuous
  batching), and prefill admissions are budgeted under the same
  deadline math — a prefill stalls every in-flight sequence for its
  duration, so the scheduler admits only as many prompts per step as
  the deadline budget covers (per-bucket EWMA costs, one cost model
  per phase).
- ``DecodeServing`` — the engine loop: intake from the serving stream
  (same record protocol — field ``t`` is the int32 prompt, plus
  ``max_new``/``eos``/``stream``), prefill admitted prompts one at a
  time, then ONE batched decode step for every leased slot at the kv
  bucket covering the longest live sequence. Steps run on the AOT
  executables `warmup_generative` pre-compiled — 0 XLA compiles on the
  request path, the same contract the forward path enforces.

Token streaming rides the existing result hash: each generated token of
a ``stream``-flagged request is written as a row ``<uri>#<index>``
(JSON ``{"i", "t", "ms"}``), and the FINAL row is the plain ``uri``
field holding the standard b64 ndarray of all generated ids (plus a
``gen`` summary) — so the non-streaming client path (exact-uri HMGET)
is oblivious to the extra rows, completion is the presence of the exact
uri field, and `OutputQueue.stream_tokens` polls rows incrementally.
Final rows commit through the fused ``writeback`` (HSET+ACK) like the
forward sink; a step's token rows and finals share ONE broker
interaction (`_flush`).

PAGED MODE. With ``paged=True`` the stripe pool is replaced
by `KVBlockPool` + per-sequence block tables (`serving/paged_kv.py`):
``slots`` becomes the fixed DECODE LANE count (the static step batch
shape) while capacity is bounded by live tokens in the block pool —
short sequences no longer reserve `max_kv_len` stripes. A `PrefixCache`
lets prompts sharing an instruction prefix adopt cached blocks copy-
free (skipping that span of prefill), and `prefill_chunk` splits long
prompts into bounded chunks interleaved between decode steps so one
giant prompt can't stall every live sequence for its full prefill
(`plan_paged_step` budgets chunks and admissions under the same
deadline math). Greedy outputs are bitwise-identical to the contiguous
path — the paged programs run the same numeric ops over relocated
bytes — and the request path still performs 0 XLA compiles
(`warmup_generative_paged` pre-compiles per (chunk bucket, kv bucket)).

CRASH SAFETY. Greedy decode is deterministic and every
streamed token is durably HSET per step, which makes a generative
record recoverable the same way the forward plane's records are:

- **Decode-session recovery** — the engine runs the forward plane's claim
  sweep over its own stream: a dead peer's pending records are claimed
  after `claim_min_idle_s`, the tokens it already committed are read
  back from the `uri#NNNNNN` rows, and the sequence re-boards with
  prompt ⊕ emitted-so-far as its prefill context — continuing from
  token i+1 with NO re-emit (`_Sequence.presented` suppresses every
  already-durable row), so surviving-engine output is bitwise-identical
  to an uninterrupted run. In paged mode the resume prefill rides the
  prefix cache and chunked prefill (warmed for every (chunk, ctx)
  bucket pair), so resume performs 0 compiles and often 0 KV copies.
- **KV-pressure preemption** — when block reservation fails even after
  cache eviction, the youngest/lowest-tier live sequence is preempted
  back to the waiting queue (blocks released, its full context
  published to the prefix cache so re-admission re-prefills copy-free)
  instead of wedging admission; an anti-thrash bound (`preempt_max`)
  guarantees a sequence preempted N times completes before any new
  admission.
- **Writeback resilience** — the engine broker wears the
  `ResilientBroker` breaker, and every flush goes through a bounded
  pending buffer: a broker blip buffers token rows (oldest-step shed
  per sequence keeps the final blob authoritative) while decode keeps
  stepping; the buffer drains on recovery. Intake failures pace on the
  stop event — a dead broker never hot-spins or kills the loop.
- **Watchdog** — `max_seq_wall_s` aborts a wedged sequence with an
  explicit NaN-degrade final (answered failure; slot/blocks released)
  so one stuck record can't hold KV forever.

Chaos tests drive these through `common.faults` points
``decode.prefill`` / ``decode.step`` / ``decode.writeback``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
import uuid
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

import torch

from analytics_zoo_tpu_torch.common import faults
from analytics_zoo_tpu_torch.observability.registry import get_registry
from analytics_zoo_tpu_torch.serving.breaker import ResilientBroker
from analytics_zoo_tpu_torch.serving.broker import (Broker, connect_broker,
                                                    encode_ndarray)
from analytics_zoo_tpu_torch.serving.client import (  # noqa: F401
    STREAM, token_row_field)
from analytics_zoo_tpu_torch.serving.elastic import BucketCostModel
from analytics_zoo_tpu_torch.serving.inference_model import (InferenceModel,
                                                             _next_bucket)
from analytics_zoo_tpu_torch.serving.paged_kv import KVBlockPool, PrefixCache
from analytics_zoo_tpu_torch.serving.pre_post import decode_record_field

log = logging.getLogger("analytics_zoo_tpu_torch.serving.decode")

GROUP = "serving_group"


def _pow2_ladder(lo: int, hi: int) -> List[int]:
    out, b = [], 1
    while b < lo:
        b *= 2
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return out


class KVSlotPool:
    """Fixed pool of KV slots over ONE pre-allocated device buffer set.

    The pytree in ``self.kv`` is threaded functionally through every
    prefill/step call (the engine rebinds it to each call's returned
    tree); the POOL object only tracks which rows are leased. Freed
    rows are not zeroed — attention masks by live length and the next
    prefill into the slot overwrites from position 0."""

    def __init__(self, init_kv: Callable[[int, int], Any], slots: int,
                 max_kv_len: int, registry=None,
                 labels: Optional[Dict[str, str]] = None):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.slots = int(slots)
        self.max_kv_len = int(max_kv_len)
        self.kv = init_kv(self.slots, self.max_kv_len)
        self._free = list(range(self.slots - 1, -1, -1))   # lease 0 first
        self._lock = threading.Lock()
        self._labels = dict(labels or {})
        if registry is None:
            registry = get_registry()
        self._gauge = registry.gauge(
            "serving_kv_slots_in_use",
            "KV-cache slots currently leased to in-flight sequences "
            "(out of the engine's fixed slot pool) — the decode "
            "engine's admission signal")
        self._gauge.set(0.0, **self._labels)

    def lease(self) -> Optional[int]:
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop()
            self._gauge.set(self.slots - len(self._free), **self._labels)
            return slot

    def release(self, slot: int) -> None:
        with self._lock:
            if slot in self._free or not 0 <= slot < self.slots:
                raise ValueError(f"release of unleased slot {slot}")
            self._free.append(slot)
            self._gauge.set(self.slots - len(self._free), **self._labels)

    @property
    def in_use(self) -> int:
        with self._lock:
            return self.slots - len(self._free)

    @property
    def free_count(self) -> int:
        with self._lock:
            return len(self._free)


@dataclasses.dataclass
class StepPlan:
    """One step's plan: how many waiting prompts board now, and the kv
    bucket the step executable runs at."""
    admit: int
    kv_bucket: int
    budget_ms: Optional[float]
    reason: str


@dataclasses.dataclass
class PagedStepPlan:
    """One PAGED step's plan: how many mid-prefill sequences advance one
    chunk, how many waiting prompts board (and run their first chunk),
    and the kv bucket of the decode step."""
    admit: int
    chunks: int
    kv_bucket: int
    budget_ms: Optional[float]
    reason: str


class DecodeScheduler:
    """Iteration-level planner — `AdaptiveBatchController` generalized
    from "plan one dispatch" to "plan each decode step".

    Two per-bucket EWMA cost models (`BucketCostModel`, one
    labelled phase each) track what a decode step at kv bucket B and a
    prefill at prompt bucket P actually cost on this host. With a
    `deadline_ms`, admissions are budgeted: every prefill delays every
    in-flight sequence's next token by its full cost, so the scheduler
    admits prompts only while (step cost + admitted prefill costs)
    stays inside the deadline — EXCEPT when no sequence is in flight,
    where there is nothing to stall and the pool is the only limit.
    Unknown costs (cold buckets) admit optimistically; the EWMA learns
    from the very first observed step."""

    def __init__(self, kv_buckets: Sequence[int],
                 prompt_buckets: Sequence[int],
                 registry=None, labels: Optional[Dict[str, str]] = None,
                 deadline_ms: Optional[float] = None,
                 margin_ms: float = 2.0, alpha: float = 0.2,
                 max_prefills_per_step: Optional[int] = None,
                 chunk_buckets: Optional[Sequence[int]] = None):
        labels = dict(labels or {})
        self.kv_buckets = sorted(int(b) for b in kv_buckets)
        self.prompt_buckets = sorted(int(b) for b in prompt_buckets)
        self.chunk_buckets = sorted(int(b) for b in chunk_buckets) \
            if chunk_buckets else list(self.prompt_buckets)
        self.deadline_ms = deadline_ms
        self.margin_ms = float(margin_ms)
        self.max_prefills_per_step = max_prefills_per_step
        self.step_cost = BucketCostModel(
            self.kv_buckets, registry, alpha=alpha,
            labels={**labels, "phase": "decode_step"})
        self.prefill_cost = BucketCostModel(
            sorted(set(self.prompt_buckets) | set(self.chunk_buckets)),
            registry, alpha=alpha,
            labels={**labels, "phase": "prefill"})

    def prompt_bucket(self, n: int) -> int:
        return _next_bucket(n, self.prompt_buckets)

    def chunk_bucket(self, n: int) -> int:
        return _next_bucket(n, self.chunk_buckets)

    def kv_bucket_for(self, needed: int) -> int:
        return _next_bucket(needed, self.kv_buckets)

    def plan_step(self, waiting_prompt_lens: Sequence[int],
                  free_slots: int, active_lengths: Sequence[int]
                  ) -> StepPlan:
        """`waiting_prompt_lens`: prompt length per queued request, in
        queue order. `active_lengths`: live KV length (pos + 1 of the
        NEXT step) per in-flight sequence."""
        cap = min(len(waiting_prompt_lens), int(free_slots))
        if self.max_prefills_per_step is not None:
            cap = min(cap, int(self.max_prefills_per_step))
        needed = max(active_lengths) if active_lengths else 1
        budget = None
        reason = "free-slots" if cap else (
            "pool-full" if waiting_prompt_lens else "no-waiting")
        admit = cap
        if cap and active_lengths and self.deadline_ms:
            bucket = self.kv_bucket_for(needed)
            step_ms = self.step_cost.cost_ms(bucket) or 0.0
            budget = self.deadline_ms - self.margin_ms - step_ms
            admit, spent = 0, 0.0
            for n in waiting_prompt_lens[:cap]:
                pb = self.prompt_bucket(n)
                c = self.prefill_cost.cost_ms(pb)
                spent += c if c is not None else 0.0
                if admit and spent > budget:
                    break
                admit += 1
            if admit < cap:
                reason = "deadline"
        for n in waiting_prompt_lens[:admit]:
            needed = max(needed, n + 1)
        return StepPlan(admit=admit,
                        kv_bucket=self.kv_bucket_for(needed),
                        budget_ms=budget, reason=reason)

    def plan_paged_step(self, waiting_prompt_lens: Sequence[int],
                        free_lanes: int,
                        prefilling_remaining: Sequence[int],
                        active_lengths: Sequence[int],
                        chunk_cap: int) -> PagedStepPlan:
        """The paged generalization of `plan_step`: prefill work is now
        CHUNKS (each `<= chunk_cap` tokens), and sequences already mid-
        prefill are budgeted BEFORE new admissions — a half-fed prompt
        holds blocks and a lane, so starving it in favor of fresh
        arrivals only grows held-but-idle memory. At least one chunk
        always advances per step when any prefill is pending (the
        starvation guard); the deadline budget trims everything beyond
        that, exactly like the contiguous planner."""
        cap = min(len(waiting_prompt_lens), int(free_lanes))
        total_cap = len(prefilling_remaining) + cap
        if self.max_prefills_per_step is not None:
            total_cap = min(total_cap,
                            max(1, int(self.max_prefills_per_step)))
        chunks = min(len(prefilling_remaining), total_cap)
        admit = min(cap, total_cap - chunks)
        needed = max(active_lengths) if active_lengths else 1
        budget = None
        reason = "free-lanes" if (admit or chunks) else (
            "pool-full" if waiting_prompt_lens else "no-waiting")
        if (chunks or admit) and active_lengths and self.deadline_ms:
            bucket = self.kv_bucket_for(needed)
            step_ms = self.step_cost.cost_ms(bucket) or 0.0
            budget = self.deadline_ms - self.margin_ms - step_ms
            spent, n_chunks, n_admit = 0.0, 0, 0
            for rem in prefilling_remaining[:chunks]:
                cb = self.chunk_bucket(min(int(rem), int(chunk_cap)))
                c = self.prefill_cost.cost_ms(cb)
                spent += c if c is not None else 0.0
                if n_chunks and spent > budget:
                    break
                n_chunks += 1
            for n in waiting_prompt_lens[:admit]:
                cb = self.chunk_bucket(min(int(n), int(chunk_cap)))
                c = self.prefill_cost.cost_ms(cb)
                spent += c if c is not None else 0.0
                if (n_chunks or n_admit) and spent > budget:
                    break
                n_admit += 1
            if n_chunks < chunks or n_admit < admit:
                reason = "deadline"
            chunks, admit = n_chunks, n_admit
        for n in waiting_prompt_lens[:admit]:
            needed = max(needed, int(n) + 1)
        return PagedStepPlan(admit=admit, chunks=chunks,
                             kv_bucket=self.kv_bucket_for(needed),
                             budget_ms=budget, reason=reason)

    def observe_step(self, kv_bucket: int, ms: float) -> None:
        self.step_cost.observe(kv_bucket, ms)

    def observe_prefill(self, prompt_bucket: int, ms: float) -> None:
        self.prefill_cost.observe(prompt_bucket, ms)


@dataclasses.dataclass
class _Sequence:
    uri: str
    rid: str                       # stream record id (acked at finish)
    prompt: np.ndarray             # int32 prompt ids
    max_new: int
    eos: Optional[int]
    stream: bool
    t_enqueue: float               # perf_counter at intake
    slot: int = -1
    pos: int = 0                   # live KV length
    gen: List[int] = dataclasses.field(default_factory=list)
    t_last: float = 0.0
    rows: int = 0                  # token rows written so far
    ttft_ms: Optional[float] = None
    finish: str = ""
    # paged-mode state (slot doubles as the decode LANE)
    blocks: List[int] = dataclasses.field(default_factory=list)
    cached: int = 0                # prompt tokens adopted from the cache
    filled: int = 0                # prompt tokens already in KV
    # crash-safety state
    tier: Optional[str] = None     # priority class (preemption ranking)
    presented: int = 0             # tokens already durable from a dead
                                   # peer — indices below this never
                                   # re-emit (no rows, no metrics)
    preempts: int = 0              # times preempted (anti-thrash bound)
    resumed: bool = False          # boarded via the claim sweep

    def ctx_len(self) -> int:
        """Prefill-context length: the prompt plus every token already
        generated (resume/preempt re-admission re-prefills both)."""
        return int(self.prompt.size) + len(self.gen)

    def context(self) -> np.ndarray:
        if not self.gen:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.gen, np.int32)])


class DecodeServing:
    """The decode-mode engine. The model must already be
    `load_generative()`-ed and `warmup_generative()`-ed with the SAME
    slots/max_kv_len/bucket ladders — the engine never compiles."""

    def __init__(self, model: InferenceModel,
                 init_kv: Callable[[int, int], Any],
                 broker: Optional[Broker] = None,
                 stream: str = STREAM,
                 slots: int = 8, max_kv_len: int = 128,
                 kv_buckets: Optional[Sequence[int]] = None,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 max_new_default: int = 32,
                 eos_id: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 max_prefills_per_step: Optional[int] = None,
                 max_waiting: int = 256,
                 engine_id: Optional[str] = None,
                 registry=None,
                 idle_block_ms: int = 50,
                 drain_timeout_s: float = 10.0,
                 paged: bool = False,
                 init_kv_blocks: Optional[Callable[[int, int], Any]] = None,
                 block_len: int = 16,
                 kv_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = True,
                 prefix_cache_blocks: Optional[int] = None,
                 chunk_buckets: Optional[Sequence[int]] = None,
                 claim_min_idle_s: Optional[float] = None,
                 claim_interval_s: float = 5.0,
                 max_seq_wall_s: Optional[float] = None,
                 preempt_max: int = 3,
                 writeback_buffer_rows: int = 512,
                 heartbeat_interval_s: Optional[float] = None,
                 resilient: bool = True):
        self.model = model
        if registry is None:
            registry = get_registry()
        inner = broker if isinstance(broker, Broker) \
            else connect_broker(broker)
        if resilient and not isinstance(inner, ResilientBroker):
            # the breaker discipline: a broker blip fast-fails
            # instead of stalling every live sequence's next token
            inner = ResilientBroker(inner, role="decode",
                                    registry=registry)
        self.broker = inner
        self.stream = stream
        self.result_key = f"result:{stream}"
        self.max_kv_len = int(max_kv_len)
        self.kv_buckets = sorted(kv_buckets) if kv_buckets \
            else _pow2_ladder(8, self.max_kv_len)
        self.prompt_buckets = sorted(prompt_buckets) if prompt_buckets \
            else _pow2_ladder(4, max(4, self.max_kv_len // 2))
        self.max_new_default = int(max_new_default)
        self.eos_id = eos_id
        self.max_waiting = int(max_waiting)
        self.engine_id = engine_id or f"decode-{uuid.uuid4().hex[:8]}"
        self.consumer = self.engine_id
        self.idle_block_ms = int(idle_block_ms)
        self.drain_timeout_s = float(drain_timeout_s)
        self.claim_min_idle_s = None if claim_min_idle_s is None \
            else float(claim_min_idle_s)
        self.claim_interval_s = float(claim_interval_s)
        self.max_seq_wall_s = None if max_seq_wall_s is None \
            else float(max_seq_wall_s)
        self.preempt_max = max(0, int(preempt_max))
        self.writeback_buffer_rows = max(1, int(writeback_buffer_rows))
        self.heartbeat_interval_s = heartbeat_interval_s
        self._heartbeat = None
        self.registry = registry
        labels = {"engine": self.engine_id}
        self.paged = bool(paged)
        self.block_len = int(block_len)
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk else None
        if self.paged:
            if init_kv_blocks is None:
                raise ValueError("paged mode needs init_kv_blocks")
            if self.max_kv_len % self.block_len:
                raise ValueError(
                    f"max_kv_len {self.max_kv_len} not a multiple of "
                    f"block_len {self.block_len}")
            bad = [b for b in self.kv_buckets if b % self.block_len]
            if bad:
                raise ValueError(
                    f"kv buckets {bad} not multiples of block_len "
                    f"{self.block_len}")
            self.table_len = self.max_kv_len // self.block_len
            # default: byte-parity with the stripe pool it replaces
            # (same KV bytes reachable, + the scratch block)
            self.kv_blocks = int(kv_blocks) if kv_blocks else (
                int(slots) * self.table_len + 1)
            self.lanes = int(slots)
            self._free_lanes = list(range(self.lanes - 1, -1, -1))
            self.pool = None
            self.block_pool = KVBlockPool(
                model.serving_kv(init_kv_blocks, self, paged=True),
                self.kv_blocks, self.block_len,
                registry=registry, labels=labels)
            self.prefix_cache = PrefixCache(
                self.block_pool, registry=registry, labels=labels,
                max_blocks=prefix_cache_blocks) if prefix_cache else None
            if chunk_buckets:
                self.chunk_buckets = sorted(int(b) for b in chunk_buckets)
            elif self.prefill_chunk:
                self.chunk_buckets = [
                    b for b in self.prompt_buckets
                    if b <= self.prefill_chunk] or [self.prompt_buckets[0]]
            else:
                self.chunk_buckets = list(self.prompt_buckets)
            # a chunk can never exceed the ladder's top bucket
            self.chunk_cap = min(self.prefill_chunk or
                                 self.chunk_buckets[-1],
                                 self.chunk_buckets[-1])
        else:
            self.pool = KVSlotPool(model.serving_kv(init_kv, self), slots,
                                   self.max_kv_len, registry=registry,
                                   labels=labels)
            self.block_pool = None
            self.prefix_cache = None
            self.chunk_buckets = list(self.prompt_buckets)
            self.chunk_cap = self.chunk_buckets[-1]
        self.scheduler = DecodeScheduler(
            self.kv_buckets, self.prompt_buckets, registry=registry,
            labels=labels, deadline_ms=deadline_ms,
            max_prefills_per_step=max_prefills_per_step,
            chunk_buckets=self.chunk_buckets)
        self._chunks_total = registry.counter(
            "serving_prefill_chunks_total",
            "prefill chunks executed by the paged decode engine (a "
            "prompt split across N chunks counts N) — chunking is what "
            "bounds ITL while long prompts join")
        self._tokens_total = registry.counter(
            "serving_tokens_total",
            "generated tokens written back by the decode engine")
        self._ttft_hist = registry.histogram(
            "serving_ttft_ms",
            "time to first token: record enqueue to the first generated "
            "token's writeback (prefill queue + prefill + first argmax) "
            "— the generative SLO's latency input")
        self._itl_hist = registry.histogram(
            "serving_itl_ms",
            "inter-token latency between consecutive generated tokens "
            "of one sequence — the streaming smoothness SLO input")
        self._resumes_total = registry.counter(
            "serving_decode_resumes_total",
            "generative decode sessions resumed from a dead peer's "
            "durable token rows (claim sweep + deterministic greedy "
            "re-prefill of prompt + emitted-so-far)")
        self._preempt_total = registry.counter(
            "serving_preemptions_total",
            "live sequences preempted back to the waiting queue under "
            "KV block pressure — blocks released, context published to "
            "the prefix cache so re-admission re-prefills copy-free")
        self._aborts_total = registry.counter(
            "serving_sequence_aborts_total",
            "sequences force-finished by the engine, by reason: wall = "
            "per-sequence watchdog expired (NaN-degrade final), "
            "blocks-full = KV pool exhausted beyond preemption's reach "
            "(answered with the tokens generated so far)")
        self._replays_total = registry.counter(
            "serving_token_replays_total",
            "token rows replayed instead of served fresh — surface="
            "engine: deterministic re-decode of already-durable tokens "
            "when a resume context outruns the prefill ladder; surface="
            "frontend: rows re-sent to a reconnecting SSE client "
            "honoring Last-Event-ID")
        self._claimed_total = registry.counter(
            "serving_claimed_records_total",
            "stale pending records claimed from dead consumers and "
            "re-dispatched by this engine")
        self._waiting: deque = deque()
        self._prefilling: deque = deque()           # paged: mid-prompt
        self._active: Dict[int, _Sequence] = {}     # slot/lane -> sequence
        self._stop = threading.Event()
        self._drain_deadline: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        # writeback pending buffer (flushed as ONE broker interaction;
        # retained across a broker outage so decode keeps stepping)
        self._pending_rows: Dict[str, str] = {}
        self._pending_finals: Dict[str, str] = {}
        self._pending_acks: List[str] = []
        self._flush_down = False
        self._intake_down = False
        self._next_claim = time.monotonic() + self.claim_interval_s
        # record ids this engine itself holds un-acked — the claim
        # sweep must never reclaim them (a decode longer than
        # claim_min_idle_s would otherwise fork itself)
        self._inflight: set = set()
        self.stats: Dict[str, int] = {
            "steps": 0, "slot_steps_active": 0, "slot_steps_total": 0,
            "tokens": 0, "prefills": 0, "finished": 0, "shed": 0,
            "failed": 0, "prefill_chunks": 0, "prefix_hit_tokens": 0,
            "resumed": 0, "recovered_tokens": 0, "replayed_tokens": 0,
            "preempted": 0, "aborted": 0, "duplicates": 0,
            "rows_shed": 0}

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "DecodeServing":
        kv = self.block_pool.kv if self.paged else self.pool.kv
        if not self.model.claim_kv(self, self.paged, kv):
            raise RuntimeError(
                f"engine {self.engine_id}: another engine serves from the "
                "model's warmed KV pool")
        self._stop.clear()
        self._drain_deadline = None
        if self.heartbeat_interval_s and self._heartbeat is None:
            # own broker connection: the engine loop may sit in an
            # XREADGROUP block window; a heartbeat must never queue
            # behind it (a stalled beat reads fleet-wide as a death)
            from analytics_zoo_tpu_torch.serving.fleet import \
                HeartbeatPublisher
            self._heartbeat = HeartbeatPublisher(
                self.broker.clone(), self.stream, self.engine_id,
                payload_fn=lambda: {
                    "ready": True, "role": "decode",
                    "records_served": self.stats["finished"],
                    "tokens": self.stats["tokens"]},
                interval_s=self.heartbeat_interval_s,
                registry=self.registry)
            self._heartbeat.start()
        self._thread = threading.Thread(target=self.run,
                                        name="decode-engine", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True):
        """Stop the loop; with `drain` (default) keep stepping until
        every in-flight sequence finishes or `drain_timeout_s` runs
        out. Un-drained records redeliver to a peer (at-least-once)."""
        self._drain_deadline = time.monotonic() + (
            self.drain_timeout_s if drain else 0.0)
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.drain_timeout_s + 10.0)
        self._thread = None
        if self._heartbeat is not None:
            self._heartbeat.stop(deregister=True)
            self._heartbeat = None
        self.model.release_kv(self)

    def is_alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    # -- record intake -----------------------------------------------------
    def _parse_record(self, rid, rec) -> Optional[_Sequence]:
        data = rec["data"]
        raw = data["t"] if "t" in data else data[next(iter(data))]
        prompt = np.asarray(decode_record_field(raw)).astype(np.int32)
        prompt = prompt.reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if prompt.size + 1 > self.max_kv_len:
            raise ValueError(
                f"prompt length {prompt.size} leaves no room to "
                f"generate under max_kv_len={self.max_kv_len}")
        if not self.paged and prompt.size > self.prompt_buckets[-1]:
            # the contiguous prefill executable pads to a prompt
            # bucket; a prompt beyond the ladder has no executable —
            # degrade the record instead of crashing the loop
            raise ValueError(
                f"prompt length {prompt.size} exceeds the prefill "
                f"ladder (max prompt bucket {self.prompt_buckets[-1]})")
        max_new = int(data.get("max_new", self.max_new_default))
        # a sequence can never outgrow its slot row
        max_new = max(1, min(max_new, self.max_kv_len - prompt.size))
        eos = data.get("eos", self.eos_id)
        tier = rec.get("tier") if isinstance(rec, dict) else None
        return _Sequence(
            uri=rec["uri"], rid=rid, prompt=prompt, max_new=max_new,
            eos=None if eos is None else int(eos),
            stream=str(data.get("stream", "")) in ("1", "true", "True"),
            t_enqueue=time.perf_counter(),
            tier=None if tier is None else str(tier))

    def _free_capacity(self) -> int:
        return len(self._free_lanes) if self.paged \
            else self.pool.free_count

    def _intake(self):
        if self._stop.is_set():
            return
        self._claim_sweep()
        idle = (not self._active and not self._waiting
                and not self._prefilling)
        count = max(1, self._free_capacity() + self.max_waiting
                    - len(self._waiting))
        try:
            records = self.broker.read_group(
                self.stream, GROUP, self.consumer, count,
                block_ms=self.idle_block_ms if idle else 0)
        except (ConnectionError, OSError) as e:
            if not self._intake_down:
                self._intake_down = True
                log.warning("decode intake unavailable "
                            "(decode keeps stepping): %s", e)
            if not self._active and not self._prefilling:
                # idle + dead broker: timed pause so the loop can't
                # hot-spin; with live sequences, keep stepping at full
                # speed — the breaker makes the failed read instant
                self._stop.wait(self.idle_block_ms / 1e3)
            return
        if self._intake_down:
            self._intake_down = False
            log.info("decode intake recovered")
        for rid, rec in records:
            self._inflight.add(rid)
            try:
                self._waiting.append(self._parse_record(rid, rec))
            except Exception as e:  # noqa: BLE001 — degrade per record
                uri = rec.get("uri", str(rid)) if isinstance(rec, dict) \
                    else str(rid)
                log.warning("decode intake failure for %s: %s", uri, e)
                self.stats["failed"] += 1
                self._queue_final(uri, "NaN", rid)
        # overload: answer the newest arrivals with SHED (the oldest
        # queued are closest to boarding — shedding them wastes wait).
        # Resumed sequences are exempt: a dead peer already accepted
        # (and partially decoded) them, so a claim sweep that lands on
        # a full queue must not convert recovery into rejection —
        # the queue briefly exceeds max_waiting instead
        while len(self._waiting) > self.max_waiting:
            seq = next((s for s in reversed(self._waiting)
                        if not s.resumed), None)
            if seq is None:
                break
            self._waiting.remove(seq)
            self.stats["shed"] += 1
            self._queue_final(seq.uri, "SHED", seq.rid)
        if self._pending_finals or self._pending_acks:
            self._flush_pending()

    # -- decode-session recovery -------------------------------------------
    def _claim_sweep(self):
        """Adopt a dead peer's pending generative records — the PR
        10/15 claim discipline on the decode stream. `claim_min_idle_s`
        guards live peers (their PEL entries stay young while they
        step); the in-flight filter stops this engine from reclaiming
        records it itself holds (one decode can out-idle the min-idle
        window: idle is measured from DELIVERY, and rows don't reset
        it); each claimed record resumes from its durable token rows."""
        if self.claim_min_idle_s is None or self._stop.is_set():
            return
        now = time.monotonic()
        if now < self._next_claim:
            return
        self._next_claim = now + self.claim_interval_s
        try:
            claimed = self.broker.claim_stale(
                self.stream, GROUP, self.consumer,
                int(self.claim_min_idle_s * 1000),
                max(1, self._free_capacity() + 4))
        except NotImplementedError:
            self.claim_min_idle_s = None   # transport can't claim
            return
        except Exception as e:  # noqa: BLE001 — sweep is best-effort
            log.warning("decode claim sweep failed: %s", e)
            return
        claimed = [(rid, rec) for rid, rec in claimed
                   if rid not in self._inflight]
        if not claimed:
            return
        self._claimed_total.inc(len(claimed), engine=self.engine_id)
        log.info("decode engine %s claimed %d stale record(s)",
                 self.engine_id, len(claimed))
        for rid, rec in claimed:
            self._recover_record(rid, rec)
        if self._pending_finals or self._pending_acks:
            self._flush_pending()

    def _recover_record(self, rid, rec):
        """Board one claimed record, resuming from whatever the dead
        peer durably committed. Greedy decode is deterministic, so
        re-prefilling prompt ⊕ emitted-so-far continues the EXACT
        sequence from token i+1; `presented` pins the already-durable
        prefix so nothing re-emits."""
        try:
            seq = self._parse_record(rid, rec)
        except Exception as e:  # noqa: BLE001 — degrade per record
            uri = rec.get("uri", str(rid)) if isinstance(rec, dict) \
                else str(rid)
            log.warning("decode claim parse failure for %s: %s", uri, e)
            self.stats["failed"] += 1
            self._queue_final(uri, "NaN", rid)
            return
        self._inflight.add(rid)
        try:
            (final,) = self.broker.hmget(self.result_key, [seq.uri])
            recovered: List[int] = []
            if final is None:
                while True:
                    fields = [token_row_field(seq.uri,
                                              len(recovered) + j)
                              for j in range(16)]
                    raws = self.broker.hmget(self.result_key, fields)
                    for raw in raws:
                        if raw is None:
                            break
                        recovered.append(int(json.loads(raw)["t"]))
                    if any(r is None for r in raws):
                        break
        except (ConnectionError, OSError) as e:
            # can't read the durable state — hand the record back to a
            # future sweep rather than risk re-emitting rows
            self._inflight.discard(rid)
            log.warning("decode recovery read failed for %s: %s",
                        seq.uri, e)
            return
        if final is not None:
            # the peer committed the final but its ack was lost (or the
            # record was re-enqueued): idempotent — ack, never redo
            self.stats["duplicates"] += 1
            self._pending_acks.append(rid)
            return
        k = len(recovered)
        seq.gen = list(recovered)
        seq.presented = k
        seq.rows = k if seq.stream else 0
        seq.resumed = True
        self.stats["resumed"] += 1
        self.stats["recovered_tokens"] += k
        self._resumes_total.inc(engine=self.engine_id)
        # finals commit in the SAME fused writeback as their finishing
        # row, so rows-without-final implies unfinished — re-derive the
        # finish anyway as defense against a torn transport
        if k and seq.eos is not None and recovered[-1] == seq.eos:
            seq.finish = "eos"
        elif k >= seq.max_new:
            seq.finish = "length"
        elif k and int(seq.prompt.size) + k - 1 >= self.max_kv_len:
            seq.finish = "kv-full"
        if seq.finish:
            self.stats["finished"] += 1
            self._queue_final(seq.uri, self._final_blob(seq), rid)
            return
        log.info("decode engine %s resuming %s at token %d",
                 self.engine_id, seq.uri, k)
        self._waiting.appendleft(seq)   # it already earned its wait

    # -- token emission ----------------------------------------------------
    def _emit(self, seq: _Sequence, token: int, now: float,
              token_rows: Dict[str, str]):
        idx = len(seq.gen)
        seq.gen.append(int(token))
        if seq.eos is not None and int(token) == seq.eos:
            seq.finish = "eos"
        elif len(seq.gen) >= seq.max_new:
            seq.finish = "length"
        elif seq.pos >= self.max_kv_len:
            seq.finish = "kv-full"
        if idx < seq.presented:
            # replaying an already-durable token (recovery fallback
            # re-decode): the row is committed, the peer observed its
            # latency — nothing to write, count, or observe
            return
        if seq.ttft_ms is None:
            # first token THIS engine produced; for a resumed sequence
            # this is the resume latency (claim to first fresh token)
            seq.ttft_ms = (now - seq.t_enqueue) * 1e3
            self._ttft_hist.observe(seq.ttft_ms, engine=self.engine_id)
        else:
            self._itl_hist.observe((now - seq.t_last) * 1e3,
                                   engine=self.engine_id)
        seq.t_last = now
        if seq.stream:
            token_rows[token_row_field(seq.uri, idx)] = json.dumps(
                {"i": idx, "t": int(token),
                 "ms": round((now - seq.t_enqueue) * 1e3, 3)})
            seq.rows = idx + 1
        self.stats["tokens"] += 1

    def _final_blob(self, seq: _Sequence) -> str:
        blob = encode_ndarray(np.asarray(seq.gen, np.int32))
        blob["gen"] = {"n": len(seq.gen), "rows": seq.rows,
                       "finish": seq.finish,
                       "ttft_ms": round(seq.ttft_ms or 0.0, 3)}
        return json.dumps(blob)

    # -- the step loop -----------------------------------------------------
    def _run_step(self):
        plan = self.scheduler.plan_step(
            [s.ctx_len() for s in self._waiting],
            self.pool.free_count,
            [s.pos + 1 for s in self._active.values()])
        token_rows: Dict[str, str] = {}
        finished: List[_Sequence] = []
        for _ in range(plan.admit):
            seq = self._waiting.popleft()
            slot = self.pool.lease()
            if slot is None:       # raced with nothing — defensive only
                self._waiting.appendleft(seq)
                break
            ctx = seq.context()
            if int(ctx.size) > self.prompt_buckets[-1]:
                # a resume context can outrun the warmed prefill ladder
                # (the original prompt never does — parse rejects it):
                # replay the whole decode from the prompt instead.
                # Greedy is deterministic, and `presented` suppresses
                # every already-durable row on the way back up.
                if seq.gen:
                    self._replays_total.inc(len(seq.gen),
                                            engine=self.engine_id,
                                            surface="engine")
                    self.stats["replayed_tokens"] += len(seq.gen)
                seq.gen = []
                ctx = seq.prompt
            pb = self.scheduler.prompt_bucket(int(ctx.size))
            padded = np.zeros(pb, np.int32)
            padded[:ctx.size] = ctx
            t0 = time.perf_counter()
            faults.fire("decode.prefill", engine=self.engine_id,
                        uri=seq.uri)
            self.pool.kv, logits = self.model.generative_prefill(
                self.pool.kv, padded, int(ctx.size), slot)
            first = int(torch.argmax(logits))   # forces the sync
            dt = time.perf_counter() - t0
            self.scheduler.observe_prefill(pb, dt * 1e3)
            self.model.account_generative("prefill", pb, dt)
            seq.slot, seq.pos = slot, int(ctx.size)
            self._active[slot] = seq
            self.stats["prefills"] += 1
            self._emit(seq, first, time.perf_counter(), token_rows)
            if seq.finish:
                finished.append(seq)
        for seq in finished:       # finished straight out of prefill
            del self._active[seq.slot]
        if self._active:
            faults.fire("decode.step", engine=self.engine_id)
            slots_arr = np.zeros(self.pool.slots, np.int32)
            pos_arr = np.zeros(self.pool.slots, np.int32)
            for slot, seq in self._active.items():
                slots_arr[slot] = seq.gen[-1]
                pos_arr[slot] = seq.pos
            bucket = self.scheduler.kv_bucket_for(
                max(s.pos + 1 for s in self._active.values()))
            t0 = time.perf_counter()
            self.pool.kv, logits = self.model.generative_step(
                self.pool.kv, slots_arr, pos_arr, bucket)
            nxt = logits.argmax(dim=-1).cpu().numpy()   # forces the sync
            dt = time.perf_counter() - t0
            self.scheduler.observe_step(bucket, dt * 1e3)
            self.model.account_generative("step", bucket, dt)
            now = time.perf_counter()
            self.stats["steps"] += 1
            self.stats["slot_steps_total"] += self.pool.slots
            self.stats["slot_steps_active"] += len(self._active)
            for slot, seq in list(self._active.items()):
                seq.pos += 1
                self._emit(seq, int(nxt[slot]), now, token_rows)
                if seq.finish:
                    finished.append(seq)
                    del self._active[slot]
        self._flush(token_rows, finished)
        for seq in finished:
            self.pool.release(seq.slot)

    def _flush(self, token_rows: Dict[str, str],
               finished: List[_Sequence]):
        """ONE broker interaction per step: every sequence's token rows
        AND any finals land in the same fused ``writeback`` (HSET +
        XACK), so a step's host-side bookkeeping cost is flat in the
        number of tokens emitted, with no HSET per row. Steps with no
        finals stay a single
        ``hset_many``; the shared HSET keeps the final-commits-with-rows
        ordering (a streaming client can never see the final field
        before the rows it summarizes).

        Everything routes through the PENDING BUFFER: on a broker
        failure the step's rows/finals/acks are retained (bounded per
        sequence) and the decode loop keeps stepping — the next flush
        attempt drains the backlog in the same single interaction."""
        for s in finished:
            self._queue_final(s.uri, self._final_blob(s), s.rid)
        self._queue_rows(token_rows)
        self._flush_pending()
        self.stats["finished"] += len(finished)

    def _queue_final(self, uri: str, blob: str, rid) -> None:
        self._pending_finals[uri] = blob
        self._pending_acks.append(rid)

    def _queue_rows(self, token_rows: Dict[str, str]) -> None:
        if not token_rows:
            return
        self._pending_rows.update(token_rows)
        for uri in {f.rsplit("#", 1)[0] for f in token_rows}:
            pre = uri + "#"
            fields = sorted(f for f in self._pending_rows
                            if f.startswith(pre))
            over = len(fields) - self.writeback_buffer_rows
            if over > 0:
                # oldest-step shed: early rows go first; the final blob
                # stays authoritative for the whole sequence, and the
                # streaming client's final drain fills any gap from it
                for f in fields[:over]:
                    del self._pending_rows[f]
                self.stats["rows_shed"] += over

    def _flush_pending(self) -> bool:
        """Attempt ONE fused send of everything buffered. Returns False
        (keeping the buffer) on a broker failure — the caller's loop
        retries next iteration; logs once per outage."""
        if not (self._pending_rows or self._pending_finals
                or self._pending_acks):
            return True
        try:
            faults.fire("decode.writeback", engine=self.engine_id)
            mapping = {**self._pending_rows, **self._pending_finals}
            if self._pending_acks:
                if mapping:
                    self.broker.writeback(self.result_key, mapping,
                                          self.stream, GROUP,
                                          list(self._pending_acks))
                else:
                    self.broker.ack(self.stream, GROUP,
                                    list(self._pending_acks))
            else:
                self.broker.hset_many(self.result_key, mapping)
        except (ConnectionError, OSError) as e:
            if not self._flush_down:
                self._flush_down = True
                log.warning(
                    "decode writeback unavailable — buffering (%d rows,"
                    " %d finals, %d acks): %s", len(self._pending_rows),
                    len(self._pending_finals), len(self._pending_acks),
                    e)
            return False
        if self._flush_down:
            self._flush_down = False
            log.info("decode writeback recovered — flushed %d rows, "
                     "%d finals, %d acks", len(self._pending_rows),
                     len(self._pending_finals), len(self._pending_acks))
        self._inflight.difference_update(self._pending_acks)
        self._pending_rows.clear()
        self._pending_finals.clear()
        self._pending_acks.clear()
        return True

    @property
    def _pending(self) -> bool:
        return bool(self._pending_rows or self._pending_finals
                    or self._pending_acks)

    # -- per-sequence watchdog ---------------------------------------------
    def _watchdog(self):
        """Abort any sequence older than `max_seq_wall_s` with an
        explicit NaN-degrade final: an answered failure that releases
        its slot/blocks, instead of a wedged record holding KV forever.
        Covers stuck steps too — a stalled prefill/step/flush surfaces
        here the moment the loop breathes again."""
        if self.max_seq_wall_s is None:
            return
        now = time.perf_counter()
        doomed: List[_Sequence] = []
        for seq in list(self._active.values()):
            if now - seq.t_enqueue > self.max_seq_wall_s:
                del self._active[seq.slot]
                if self.paged:
                    self._release_paged(seq)
                else:
                    self.pool.release(seq.slot)
                    seq.slot = -1
                doomed.append(seq)
        for dq in (self._prefilling, self._waiting):
            for seq in [s for s in dq
                        if now - s.t_enqueue > self.max_seq_wall_s]:
                dq.remove(seq)
                if self.paged:
                    self._release_paged(seq)
                doomed.append(seq)
        for seq in doomed:
            log.warning("decode watchdog aborting %s after %.1fs "
                        "(%d tokens generated)", seq.uri,
                        now - seq.t_enqueue, len(seq.gen))
            self._aborts_total.inc(engine=self.engine_id, reason="wall")
            self.stats["aborted"] += 1
            self._queue_final(seq.uri, "NaN", seq.rid)
        if doomed:
            self._flush_pending()

    # -- the paged step loop -----------------------------------------------
    def _alloc_block(self) -> Optional[int]:
        """One pool block, evicting cold cached prefixes if needed."""
        b = self.block_pool.alloc()
        if b is None and self.prefix_cache is not None:
            self.prefix_cache.evict_for(1)
            b = self.block_pool.alloc()
        return b

    def _release_paged(self, seq: _Sequence):
        for b in seq.blocks:
            self.block_pool.release(b)
        seq.blocks = []
        if seq.slot >= 0:
            self._free_lanes.append(seq.slot)
            seq.slot = -1

    def _admit_paged(self, seq: _Sequence) -> bool:
        """Lease a lane and the context's blocks; adopt every fully-
        matching prefix-cache block copy-free (that span of prefill is
        skipped). The CONTEXT is prompt ⊕ generated-so-far — for a
        fresh sequence that's just the prompt, while a resumed or
        preempted sequence re-boards with its own published prefix
        (usually a full cache hit, making resume/re-admission nearly
        copy-free). On block exhaustion everything is rolled back and
        the caller requeues the sequence — admission is all-or-nothing."""
        bl = self.block_len
        ctx = seq.context()
        adopted = self.prefix_cache.match(ctx.tolist()) \
            if self.prefix_cache is not None else []
        cached = len(adopted) * bl
        need = -(-(int(ctx.size) - cached) // bl)
        got: List[int] = []
        for _ in range(need):
            b = self._alloc_block()
            if b is None:
                for x in got + adopted:
                    self.block_pool.release(x)
                return False
            got.append(b)
        if not self._free_lanes:      # raced with nothing — defensive
            for x in got + adopted:
                self.block_pool.release(x)
            return False
        seq.slot = self._free_lanes.pop()
        seq.blocks = adopted + got
        seq.cached = seq.filled = cached
        if cached:
            self.stats["prefix_hit_tokens"] += cached
        return True

    def _prefill_chunk_step(self, seq: _Sequence,
                            token_rows: Dict[str, str]) -> bool:
        """Run ONE chunk of `seq`'s remaining CONTEXT (prompt, plus any
        tokens recovered/kept across a resume or preemption) through
        the warmed paged-prefill executable for its (chunk bucket,
        context bucket). The final chunk produces the next generated
        token and publishes the context's full blocks to the prefix
        cache — a full block is immutable from here on (decode writes
        land strictly beyond it), so publishing generated spans is as
        safe as publishing prompt spans and makes the NEXT resume or
        re-admission of this very sequence copy-free."""
        bl = self.block_len
        ctx = seq.context()
        remaining = int(ctx.size) - seq.filled
        chunk = min(remaining, self.chunk_cap)
        cb = self.scheduler.chunk_bucket(chunk)
        padded = np.zeros(cb, np.int32)
        padded[:chunk] = ctx[seq.filled:seq.filled + chunk]
        kvb = 0 if seq.filled == 0 \
            else self.scheduler.kv_bucket_for(seq.filled)
        table = np.zeros(self.table_len, np.int32)
        table[:len(seq.blocks)] = seq.blocks
        t0 = time.perf_counter()
        faults.fire("decode.prefill", engine=self.engine_id,
                    uri=seq.uri)
        self.block_pool.kv, logits = self.model.generative_prefill_paged(
            self.block_pool.kv, padded, table, seq.filled, chunk, kvb)
        done = seq.filled + chunk >= int(ctx.size)
        nxt = int(torch.argmax(logits))      # forces the sync
        dt = time.perf_counter() - t0
        self.scheduler.observe_prefill(cb, dt * 1e3)
        self.model.account_generative("paged_prefill", (cb, kvb), dt)
        self._chunks_total.inc(engine=self.engine_id)
        self.stats["prefill_chunks"] += 1
        seq.filled += chunk
        if done:
            seq.pos = int(ctx.size)
            self.stats["prefills"] += 1
            if self.prefix_cache is not None:
                n_full = int(ctx.size) // bl
                if n_full:
                    self.prefix_cache.insert(ctx.tolist(),
                                             seq.blocks[:n_full])
            self._emit(seq, nxt, time.perf_counter(), token_rows)
        return done

    def _ensure_block(self, seq: _Sequence) -> bool:
        """Grow the sequence's table to cover its next write position
        (block-by-block, the paged discipline's whole point)."""
        while seq.pos // self.block_len >= len(seq.blocks):
            b = self._alloc_block()
            if b is None:
                return False
            seq.blocks.append(b)
        return True

    def _settle_prefill(self, seq: _Sequence, done: bool,
                        finished: List[_Sequence]):
        # `done` comes from the chunk step itself: the final chunk's
        # emit grows ctx_len() by one, so comparing filled against it
        # here would misread a completed prefill as still in flight
        if not done:
            self._prefilling.append(seq)
        elif seq.finish:
            finished.append(seq)
        else:
            self._active[seq.slot] = seq

    # -- KV-pressure preemption --------------------------------------------
    def _preempt_victim(self, exclude: Optional[_Sequence] = None
                        ) -> Optional[_Sequence]:
        """The live sequence that loses the least by being backed out:
        untiered before tiered, then the youngest arrival. Sequences at
        the anti-thrash bound are never victims — after `preempt_max`
        preemptions a sequence runs to completion."""
        cands = [s for s in self._active.values()
                 if s is not exclude and s.preempts < self.preempt_max]
        if not cands:
            return None
        return min(cands, key=lambda s: (s.tier is not None,
                                         -s.t_enqueue))

    def _preempt(self, seq: _Sequence):
        """Back one live sequence out to the waiting queue under KV
        pressure. Its full context blocks are published to the prefix
        cache FIRST (they're fully written and immutable — decode was
        writing beyond them), so its re-admission adopts them copy-free
        while the pool reclaims them via normal cache eviction if the
        pressure persists. Requeued at the FRONT: it already earned its
        wait, and its generated tokens ride along (`gen` is kept, so
        the re-admission prefill continues at the exact next token)."""
        if self.prefix_cache is not None and seq.blocks:
            n_full = min(seq.pos // self.block_len, len(seq.blocks))
            if n_full:
                self.prefix_cache.insert(seq.context().tolist(),
                                         seq.blocks[:n_full])
        self._release_paged(seq)
        seq.filled = seq.cached = 0
        seq.pos = 0
        seq.preempts += 1
        self._preempt_total.inc(engine=self.engine_id)
        self.stats["preempted"] += 1
        log.info("decode engine %s preempted %s (%d tokens kept, "
                 "preempt %d/%d)", self.engine_id, seq.uri,
                 len(seq.gen), seq.preempts, self.preempt_max)
        self._waiting.appendleft(seq)

    def _run_paged_step(self):
        plan = self.scheduler.plan_paged_step(
            [s.ctx_len() for s in self._waiting],
            len(self._free_lanes),
            [s.ctx_len() - s.filled for s in self._prefilling],
            [s.pos + 1 for s in self._active.values()],
            self.chunk_cap)
        token_rows: Dict[str, str] = {}
        finished: List[_Sequence] = []
        # mid-prefill sequences advance first (they hold blocks + lanes)
        for _ in range(plan.chunks):
            seq = self._prefilling.popleft()
            done = self._prefill_chunk_step(seq, token_rows)
            self._settle_prefill(seq, done, finished)
        # anti-thrash gate: while any waiting sequence has hit the
        # preemption bound, ONLY such sequences may board — they run
        # to completion before fresh admissions compete for blocks
        thrash_waiting = any(s.preempts >= self.preempt_max
                             for s in self._waiting)
        for _ in range(plan.admit):
            seq = self._waiting.popleft()
            if (thrash_waiting and self.preempt_max
                    and seq.preempts < self.preempt_max):
                self._waiting.appendleft(seq)
                break
            if not self._admit_paged(seq):
                # admission-time preemption: only a strictly younger
                # victim may be displaced (never trade places with an
                # older sequence — that's how admission livelocks)
                victim = self._preempt_victim()
                admitted = False
                if victim is not None \
                        and victim.t_enqueue > seq.t_enqueue:
                    del self._active[victim.slot]
                    self._preempt(victim)
                    admitted = self._admit_paged(seq)
                if not admitted:
                    if (victim is None and not self._active
                            and not self._prefilling):
                        # nothing live will ever free more blocks:
                        # this context alone outgrows the pool —
                        # answer with what it has instead of an
                        # admission deadlock
                        seq.finish = "blocks-full"
                        self._aborts_total.inc(engine=self.engine_id,
                                               reason="blocks-full")
                        self.stats["aborted"] += 1
                        finished.append(seq)
                        continue
                    self._waiting.appendleft(seq)
                    break
            done = self._prefill_chunk_step(seq, token_rows)
            self._settle_prefill(seq, done, finished)
        if self._active:
            # a lane whose next write position has no block left (pool
            # exhausted even after cache eviction) preempts the
            # youngest/lowest-tier live sequence instead of wedging;
            # only when every live sequence is at the thrash bound does
            # it answer with what it generated (blocks-full)
            for lane, seq in list(self._active.items()):
                if self._active.get(lane) is not seq:
                    continue           # already preempted as a victim
                while not self._ensure_block(seq):
                    victim = self._preempt_victim()
                    if victim is None:
                        seq.finish = "blocks-full"
                        self._aborts_total.inc(engine=self.engine_id,
                                               reason="blocks-full")
                        self.stats["aborted"] += 1
                        finished.append(seq)
                        del self._active[lane]
                        break
                    del self._active[victim.slot]
                    self._preempt(victim)
                    if victim is seq:
                        break
        if self._active:
            faults.fire("decode.step", engine=self.engine_id)
            tokens_arr = np.zeros(self.lanes, np.int32)
            pos_arr = np.zeros(self.lanes, np.int32)
            tables = np.zeros((self.lanes, self.table_len), np.int32)
            for lane, seq in self._active.items():
                tokens_arr[lane] = seq.gen[-1]
                pos_arr[lane] = seq.pos
                tables[lane, :len(seq.blocks)] = seq.blocks
            bucket = self.scheduler.kv_bucket_for(
                max(s.pos + 1 for s in self._active.values()))
            t0 = time.perf_counter()
            self.block_pool.kv, logits = self.model.generative_step_paged(
                self.block_pool.kv, tokens_arr, pos_arr, tables, bucket)
            nxt = logits.argmax(dim=-1).cpu().numpy()   # forces the sync
            dt = time.perf_counter() - t0
            self.scheduler.observe_step(bucket, dt * 1e3)
            self.model.account_generative("paged_step", bucket, dt)
            now = time.perf_counter()
            self.stats["steps"] += 1
            self.stats["slot_steps_total"] += self.lanes
            self.stats["slot_steps_active"] += len(self._active)
            for lane, seq in list(self._active.items()):
                seq.pos += 1
                self._emit(seq, int(nxt[lane]), now, token_rows)
                if seq.finish:
                    finished.append(seq)
                    del self._active[lane]
        self._flush(token_rows, finished)
        for seq in finished:
            self._release_paged(seq)

    def run(self):
        """The engine loop (inline-callable for tests; `start()` wraps
        it in a thread). Every iteration: watchdog → intake (claim
        sweep rides along) → plan → prefill admissions → one batched
        decode step → writebacks (buffered across broker outages)."""
        emitted_before = self.stats["tokens"]
        step = self._run_paged_step if self.paged else self._run_step
        while True:
            if self._stop.is_set():
                drained = (not self._active and not self._waiting
                           and not self._prefilling and not self._pending)
                if drained or (self._drain_deadline is not None
                               and time.monotonic() > self._drain_deadline):
                    break
            self._watchdog()
            self._intake()
            before = self.stats["tokens"]
            step()
            delta = self.stats["tokens"] - before
            if delta:
                self._tokens_total.inc(delta, engine=self.engine_id)
            if self._pending:
                # a failed flush left rows/finals buffered: retry each
                # iteration (the idle intake block paces this loop)
                self._flush_pending()
        if self._pending:
            self._flush_pending()     # one last drain attempt
        if self._pending:
            log.warning("decode engine %s stopping with %d rows / %d "
                        "finals unflushed (records will redeliver)",
                        self.engine_id, len(self._pending_rows),
                        len(self._pending_finals))
        if self.stats["tokens"] != emitted_before:
            log.info("decode engine %s: %s", self.engine_id, self.stats)

    def utilization(self) -> float:
        """Useful slot-steps over total slot-steps — the bench's
        headline ratio vs the pad-to-max baseline."""
        total = self.stats["slot_steps_total"]
        return self.stats["slot_steps_active"] / total if total else 0.0
