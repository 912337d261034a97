"""Serving client — `InputQueue` / `OutputQueue`.

Copied from `analytics_zoo_tpu/serving/client.py`: `STREAM` (L40), the
reconnect harness `_Reconnecting` (L44), `InputQueue` (L79: `enqueue`)
and `OutputQueue` (L340: `query`, `query_many`, `stream_tokens`).
`enqueue` XADDs a b64-encoded ndarray to the serving stream (routed by
uri hash when `partitions > 1`); results arrive in the
``result:<stream>`` hash as b64 ndarrays, the literal "NaN" for a
per-record failure or "SHED" for an admission shed. A generative request's
streamed tokens are ``<uri>#<index>`` rows beside its final row, which
`stream_tokens` reads incrementally. Every broker op retries through a
jittered exponential backoff when the connection drops.

Not ported yet (ROADMAP.md queue 1, item 4): batched ingest
(`enqueue_batch`), `dequeue`, trace-context stamping and per-hop timings,
image payloads, the synchronous `predict` / `predict_batch` and
`StreamingSession`.
"""

from __future__ import annotations

import json
import logging
import time
import uuid
from typing import Dict, List, Optional, Union

import numpy as np

from analytics_zoo_tpu_torch.serving.breaker import BackoffPolicy
from analytics_zoo_tpu_torch.serving.broker import (Broker, connect_broker,
                                                    decode_ndarray,
                                                    encode_ndarray)
from analytics_zoo_tpu_torch.serving.partitions import (stream_for,
                                                        validate_partitions)

log = logging.getLogger("analytics_zoo_tpu_torch.serving.client")

STREAM = "serving_stream"          # reference stream name
RESULT_KEY = "result:serving_stream"
ENGINES_KEY_PREFIX = "engines:"


def engines_key(stream: str) -> str:
    """The broker hash that holds one heartbeat row per engine (the fleet's
    `engines_key`, `serving/fleet.py:54` of the JAX package)."""
    return ENGINES_KEY_PREFIX + stream


def token_row_field(uri: str, index: int) -> str:
    """Result-hash field name of one streamed token row (the decode
    engine's `token_row_field`, `serving/decode.py:133`). '#' never
    appears in generated uris, so the exact-uri poll can never collide
    with a token row."""
    return f"{uri}#{index:06d}"


class _Reconnecting:
    """Shared retry harness: run a broker op, and on a dropped
    connection (broker restart, network blip) back off with jitter and
    try again instead of failing the caller's in-flight request. The
    transports reconnect lazily — their next command redials — so the
    retry IS the reconnect. Jitter matters: a fleet of clients hitting
    a restarting broker in lockstep is its own outage."""

    def __init__(self, reconnect_attempts: int = 8,
                 backoff: Optional[BackoffPolicy] = None):
        self.reconnect_attempts = max(1, int(reconnect_attempts))
        self.backoff = backoff or BackoffPolicy(initial_s=0.02, max_s=1.0)

    def _call(self, fn, *args, deadline: Optional[float] = None):
        attempt = 0
        while True:
            try:
                return fn(*args)
            except (ConnectionError, OSError) as e:
                attempt += 1
                if attempt >= self.reconnect_attempts:
                    raise
                delay = self.backoff.delay(attempt)
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise
                    delay = min(delay, remaining)
                if attempt == 1:
                    log.warning(
                        "broker call failed (%s: %s); reconnecting with "
                        "backoff", type(e).__name__, e)
                time.sleep(delay)



class InputQueue(_Reconnecting):
    def __init__(self, broker: Union[Broker, str, None] = None,
                 stream: str = STREAM, partitions: int = 1,
                 reconnect_attempts: int = 8):
        """`partitions` must match the serving fleet's count — both
        sides compute the same uri hash."""
        super().__init__(reconnect_attempts=reconnect_attempts)
        self.broker = broker if isinstance(broker, Broker) \
            else connect_broker(broker)
        self.stream = stream
        self.partitions = validate_partitions(partitions)

    def _record(self, uri: Optional[str], tier: Optional[str],
                data: Dict) -> tuple:
        uri = uri or uuid.uuid4().hex
        payload: Dict = {}
        for name, value in data.items():
            if isinstance(value, np.ndarray):
                payload[name] = encode_ndarray(value)
            elif name == "image":
                raise NotImplementedError(
                    "image payloads are not ported yet (ROADMAP.md queue "
                    "1, item 4: serving plane)")
            else:
                payload[name] = value
        record = {"uri": uri, "data": payload}
        if tier is not None:
            record["tier"] = str(tier)
        return uri, stream_for(self.stream, uri, self.partitions), record

    def enqueue(self, uri: Optional[str] = None, tier: Optional[str] = None,
                **data) -> str:
        """`enqueue("uuid", t=ndarray)` or path/bytes via `image=`.
        `tier` names the record's priority class — the
        engine's tiered scheduler dispatches higher tiers first and
        sheds the lowest tier first under overload; records without one
        rank lowest."""
        uri, stream, record = self._record(uri, tier, data)
        self._call(self.broker.xadd, stream, record)
        return uri


class OutputQueue(_Reconnecting):
    def __init__(self, broker: Union[Broker, str, None] = None,
                 stream: str = STREAM, reconnect_attempts: int = 8):
        super().__init__(reconnect_attempts=reconnect_attempts)
        self.broker = broker if isinstance(broker, Broker) \
            else connect_broker(broker)
        self.stream = stream
        self.result_key = f"result:{stream}"

    @staticmethod
    def _token_row_fields(uri: str, raw: str) -> List[str]:
        """Token rows a generative final result leaves behind
        (decode-engine streaming): the final blob's
        ``gen.rows`` counts its ``<uri>#<index>`` siblings, so a
        deleting poll can clean them up in the same batched HDEL
        instead of leaking them in the result hash."""
        if not raw or raw[0] != "{":
            return []
        try:
            rows = int(json.loads(raw).get("gen", {}).get("rows", 0))
        except Exception:  # noqa: BLE001 — cleanup is best effort
            return []
        return [token_row_field(uri, i) for i in range(rows)]

    def query(self, uri: str, delete: bool = False):
        raw = self._call(self.broker.hget, self.result_key, uri)
        if raw is None:
            return None
        if delete:
            self._call(self.broker.hdel_many, self.result_key,
                       [uri] + self._token_row_fields(uri, raw))
        return self._decode(raw)

    def query_many(self, uris, delete: bool = False,
                   deadline: Optional[float] = None) -> Dict[str, object]:
        """Fused poll: ONE HMGET answers every uri in the sweep (the
        read analogue of the batched multi-XADD), plus one batched
        delete for whatever landed. Missing fields simply aren't in
        the returned dict."""
        uris = list(uris)
        if not uris:
            return {}
        raws = self._call(self.broker.hmget, self.result_key, uris,
                          deadline=deadline)
        found = {u: raw for u, raw in zip(uris, raws) if raw is not None}
        if delete and found:
            fields = list(found)
            for u, raw in found.items():
                fields += self._token_row_fields(u, raw)
            self._call(self.broker.hdel_many, self.result_key,
                       fields, deadline=deadline)
        return {u: self._decode(raw) for u, raw in found.items()}

    def stream_tokens(self, uri: str, timeout_s: float = 30.0,
                      delete: bool = True, start: int = 0,
                      keepalive_s: Optional[float] = None,
                      stall_timeout_s: Optional[float] = None):
        """Incrementally consume one generative request's token stream.

        Yields each token row ``{"i", "t", "ms"}`` as the decode engine
        writes it, then one final ``{"done": True, "tokens": ndarray,
        "gen": {...}}`` once the final row lands. Each poll sweep is ONE
        HMGET asking for a WINDOW of upcoming token rows plus the final
        row, so tokens that accumulated while the client slept (or
        between fused per-step writebacks) drain in a single sweep
        instead of one round trip each. Idle sweeps back off
        exponentially (1 ms → 50 ms) like `predict_batch`; ANY sweep
        that returns new tokens resets the backoff to the floor, so an
        idle pause never inflates client-observed inter-token latency
        once the stream resumes. With `delete` (default) the final row
        and every token row are removed in one batched HDEL at
        completion. Raises TimeoutError if the final row hasn't landed
        inside `timeout_s`.

        Crash-safe streaming: the cursor only ever moves
        forward, so every token index is yielded EXACTLY once per call
        — and `start` skips rows a previous (disconnected) call already
        delivered, which is how the frontend honors ``Last-Event-ID``
        (replay only the missing rows; the rows are durable in the
        result hash until the final is consumed). `keepalive_s` yields
        ``{"keepalive": True}`` markers during idle gaps so an SSE
        writer can emit comment frames that hold proxies open.
        `stall_timeout_s` arms heartbeat-aware death detection: when no
        row lands for that long AND the fleet's heartbeat rows
        (`engines:<stream>`) show zero timestamp progress between two
        consecutive checks, the stream ends with ``{"done": True,
        "error": "engine-dead"}`` instead of hanging until the
        deadline — a live-but-slow engine keeps beating and is given
        the full `timeout_s`."""
        deadline = time.monotonic() + timeout_s
        nxt = max(0, int(start))
        backoff = 0.001
        window = 8
        t_progress = time.monotonic()
        last_keep = time.monotonic()
        last_beats: Optional[Dict[str, str]] = None
        while True:
            fields = [token_row_field(uri, nxt + j)
                      for j in range(window)] + [uri]
            raws = self._call(self.broker.hmget, self.result_key, fields,
                              deadline=deadline)
            final = raws[window]
            progressed = False
            for raw in raws[:window]:
                if raw is None:
                    break
                progressed = True
                nxt += 1
                yield json.loads(raw)
            if progressed:
                backoff = 0.001
                t_progress = time.monotonic()
                last_beats = None
                continue
            if final is not None:
                if final in ("NaN", "SHED"):
                    if delete:
                        self._call(self.broker.hdel, self.result_key, uri)
                    yield {"done": True, "error": final, "tokens": None,
                           "gen": {}}
                    return
                blob = json.loads(final)
                gen = blob.get("gen", {})
                # rows the engine wrote after our last sweep: the final
                # row commits last, so any remaining token rows are
                # already present — drain them in order before done
                total = int(gen.get("rows", nxt))
                if nxt < total:
                    raws = self._call(
                        self.broker.hmget, self.result_key,
                        [token_row_field(uri, i)
                         for i in range(nxt, total)], deadline=deadline)
                    for raw in raws:
                        if raw is None:  # non-streamed request: no rows
                            break
                        nxt += 1
                        yield json.loads(raw)
                if delete:
                    self._call(
                        self.broker.hdel_many, self.result_key,
                        [uri] + [token_row_field(uri, i)
                                 for i in range(total)])
                yield {"done": True, "tokens": decode_ndarray(blob),
                       "gen": gen}
                return
            now = time.monotonic()
            if keepalive_s is not None and now - last_keep >= keepalive_s:
                last_keep = now
                yield {"keepalive": True}
            if (stall_timeout_s is not None
                    and now - t_progress >= stall_timeout_s):
                try:
                    beats = self._call(self.broker.hgetall,
                                       engines_key(self.stream),
                                       deadline=deadline)
                except (ConnectionError, OSError):
                    beats = None      # can't tell: keep waiting
                if beats is not None:
                    if last_beats is not None and beats == last_beats:
                        # one full stall window with zero heartbeat
                        # progress (ts values are inside the row JSON,
                        # so ANY beat changes its row): the fleet is
                        # dead, not slow — answered failure, no hang
                        yield {"done": True, "error": "engine-dead",
                               "tokens": None, "gen": {}}
                        return
                    # first check (or progress seen): baseline and give
                    # the fleet one more full stall window
                    last_beats = beats
                    t_progress = now
            remaining = deadline - now
            if remaining <= 0:
                raise TimeoutError(
                    f"no completed result for {uri} within {timeout_s}s "
                    f"({nxt} token rows seen)")
            time.sleep(min(backoff, remaining))
            backoff = min(backoff * 2, 0.05)

    @staticmethod
    def _decode(raw: str):
        if raw == "NaN":   # per-record failure marker
            return float("nan")
        if raw == "SHED":  # admission shed: an answered
            return raw     # rejection — distinguishable from a failure
        if raw.startswith("["):  # filtered result string, e.g. topN(5)
            return raw
        return decode_ndarray(json.loads(raw))
