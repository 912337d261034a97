"""Serving client — `InputQueue` / `OutputQueue`.

Copied from `analytics_zoo_tpu/serving/client.py` (L1-568) as it is, with
`token_row_field` (the decode engine's, `serving/decode.py:133`) kept here
so that the client needs no decode module; `engines_key` comes from
`serving/fleet.py`, as in the JAX client. Image payloads (`_encode_image`,
L170) decode through the port's `data/image.py` `load_image`.

Protocol preserved from the reference: `enqueue` XADDs a b64-encoded ndarray
to the serving stream (`client.py:114`), `predict` is the
sync round-trip (`client.py:199` via the HTTP frontend there; here it polls
the result hash), `OutputQueue.query/dequeue` read results back
(`client.py:203`). Results arrive as b64 ndarrays, the literal "NaN" for
per-record failures (`ClusterServingInference.scala:71-79` degradation) or
"SHED" for an admission shed.

Wire-speed ingest: with `partitions > 1` every record routes to
the partition stream its uri hashes to (serving/partitions.py — the same
map every gateway and engine computes); results still land in the ONE
``result:<stream>`` hash, so polling is unchanged. The sync paths fuse
their RESP round trips the way the engine fuses its sink commit: a
`predict_batch` burst is ONE pipelined multi-XADD in, ONE `HMGET` per poll
sweep out (`pipelined=False` keeps the per-record wire pattern as the
bench A/B baseline). `StreamingSession` holds the pattern open across
bursts on one persistent connection. Every broker op retries through a
jittered exponential backoff when the connection drops (a restarted
broker costs the in-flight request a reconnect, not a failure)."""

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
                 pipelined: bool = True,
                 reconnect_attempts: int = 8,
                 trace_sample: float = 0.0,
                 trace_parent: Optional[str] = None):
        """`partitions` must match the serving fleet's count — both
        sides compute the same uri hash, so a mismatch strands records
        on streams nobody reads (the engine's lease-table meta guard
        exists to catch exactly that drift at engine startup).
        `pipelined=False` restores the per-record XADD + per-uri HGET
        wire pattern — kept ONLY as the bench_serving ingest A/B
        baseline.

        `trace_sample` > 0 turns on trace-context propagation:
        every record is stamped with its ingest wall timestamp
        (the record uri IS the trace id), so engines can continue the
        trace with a "wire" span and export it for fleet assembly.
        Sampling itself is decided deterministically from the uri in
        every process — the stamp carries context, not the decision.
        `trace_parent` names the span the engine-side trace should hang
        under (the gateway sets "gateway_request")."""
        super().__init__(reconnect_attempts=reconnect_attempts)
        self.broker = broker if isinstance(broker, Broker) \
            else connect_broker(broker)
        self.stream = stream
        self.partitions = validate_partitions(partitions)
        self.pipelined = pipelined
        if not 0.0 <= float(trace_sample) <= 1.0:
            raise ValueError(
                f"trace_sample must be in [0, 1], got {trace_sample}")
        self.trace_sample = float(trace_sample)
        self.trace_parent = trace_parent
        # per-hop engine timing summaries from the most recent
        # predict_batch (uri -> hop dict), populated by the OutputQueue
        self.last_hops: Dict[str, Dict] = {}

    def _record(self, uri: Optional[str], tier: Optional[str],
                data: Dict) -> tuple:
        uri = uri or uuid.uuid4().hex
        payload: Dict = {}
        for name, value in data.items():
            if isinstance(value, np.ndarray):
                payload[name] = encode_ndarray(value)
            elif name == "image":
                payload[name] = self._encode_image(value)
            else:
                payload[name] = value
        record = {"uri": uri, "data": payload}
        if tier is not None:
            record["tier"] = str(tier)
        if self.trace_sample > 0:
            ctx: Dict = {"ts": time.time()}
            if self.trace_parent:
                ctx["parent"] = self.trace_parent
            record["trace"] = ctx
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

    def enqueue_batch(self, samples, tier: Optional[str] = None,
                      uris: Optional[List[str]] = None) -> List[str]:
        """Batched ingest: the whole burst goes out as ONE pipelined
        multi-XADD (entries spanning partition streams), so N records
        cost one round trip instead of N. Falls back to per-record XADDs when
        the queue was built `pipelined=False`."""
        entries, out = [], []
        for i, s in enumerate(samples):
            uri, stream, record = self._record(
                uris[i] if uris else None, tier, {"t": np.asarray(s)})
            entries.append((stream, record))
            out.append(uri)
        if self.pipelined:
            self._call(self.broker.xadd_many, entries)
        else:
            for stream, record in entries:
                self._call(self.broker.xadd, stream, record)
        return out

    @staticmethod
    def _encode_image(value) -> Dict:
        """Image path/bytes -> decoded float ndarray record (the reference
        ships b64 JPEG and decodes OpenCV-side; decode client-side here so
        the server stays shape-generic)."""
        from analytics_zoo_tpu_torch.data.image import load_image
        arr = load_image(value)
        return encode_ndarray(arr.astype(np.float32))

    def predict(self, data: np.ndarray, timeout_s: float = 30.0,
                tier: Optional[str] = None,
                uri: Optional[str] = None) -> np.ndarray:
        """Sync path (`client.py:199`): enqueue then poll the result."""
        return self.predict_batch([np.asarray(data)], timeout_s,
                                  tier=tier,
                                  uris=[uri] if uri else None)[0]

    def predict_batch(self, samples, timeout_s: float = 30.0,
                      tier: Optional[str] = None,
                      uris: Optional[List[str]] = None) -> list:
        """Sync multi-record path: each sample is ONE serving record (the
        per-instance contract of the reference frontend — records batch up
        inside the serving loop, not inside one record). Results return in
        input order; a failed record yields float('nan').

        Deadlines use `time.monotonic()` (a wall-clock step — NTP slew,
        suspend/resume — must not shrink or blow the budget), and idle
        polls back off exponentially from 1 ms to a 50 ms cap instead of
        hammering the broker at a fixed tight interval; any progress
        resets the backoff so a streaming burst is drained promptly.

        Pipelined (default), the burst enqueues as one multi-XADD and
        each poll sweep reads EVERY outstanding uri in one HMGET — the
        round-trip count per poll is 1, not len(missing). The legacy
        per-record pattern survives under `pipelined=False` for the
        bench A/B."""
        deadline = time.monotonic() + timeout_s
        out = OutputQueue(self.broker, self.stream,
                          reconnect_attempts=self.reconnect_attempts)
        if self.pipelined:
            uris = self.enqueue_batch(samples, tier=tier, uris=uris)
        else:
            uris = [self.enqueue(uris[i] if uris else None, tier=tier,
                                 t=np.asarray(s))
                    for i, s in enumerate(samples)]
        results: dict = {}
        backoff = 0.001
        while len(results) < len(uris):
            # deadline checked every pass, progress or not: trickling
            # results must tighten the remaining budget, not renew it
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            progress = False
            missing = [u for u in uris if u not in results]
            if self.pipelined:
                found = out.query_many(missing, delete=True,
                                       deadline=deadline)
                if found:
                    results.update(found)
                    progress = True
            else:
                for uri in missing:
                    res = out.query(uri, delete=True)
                    if res is not None:
                        results[uri] = res
                        progress = True
            if progress:
                backoff = 0.001
                continue
            time.sleep(min(backoff, max(0.0, remaining)))
            backoff = min(backoff * 2, 0.05)
        missing = [u for u in uris if u not in results]
        if missing:
            raise TimeoutError(
                f"No prediction for {len(missing)}/{len(uris)} records "
                f"within {timeout_s}s")
        self.last_hops = dict(out.last_hops)
        return [results[u] for u in uris]

    def stream_session(self, max_inflight: int = 256) -> "StreamingSession":
        """A persistent-connection streaming mode over this queue."""
        return StreamingSession(self, max_inflight=max_inflight)


class StreamingSession:
    """Persistent-connection streaming client: many requests
    in flight over ONE broker connection, with the fused wire pattern
    held open across bursts — `submit()` buffers locally, `flush()`
    ships everything buffered as one multi-XADD, `drain()` collects
    outstanding results with one HMGET per poll sweep. Usable as a
    context manager; exiting drains what was submitted.

        with inq.stream_session() as s:
            for x in arrays:
                s.submit(x)
            results = s.drain()          # {uri: ndarray}

    `max_inflight` bounds the unflushed + unanswered window: submit
    past it triggers an implicit flush (backpressure lives at the
    broker, not in this buffer)."""

    def __init__(self, inq: InputQueue, max_inflight: int = 256):
        self.inq = inq
        self.out = OutputQueue(inq.broker, inq.stream,
                               reconnect_attempts=inq.reconnect_attempts)
        self.max_inflight = max(1, int(max_inflight))
        self._buffered: List[tuple] = []     # (stream, record)
        self._outstanding: List[str] = []    # uris awaiting results
        self._order: List[str] = []          # submission order (stable)

    def __enter__(self) -> "StreamingSession":
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.drain()
        return False

    def submit(self, data, uri: Optional[str] = None,
               tier: Optional[str] = None) -> str:
        uri, stream, record = self.inq._record(
            uri, tier, {"t": np.asarray(data)})
        self._buffered.append((stream, record))
        self._outstanding.append(uri)
        self._order.append(uri)
        if len(self._buffered) >= self.max_inflight:
            self.flush()
        return uri

    def flush(self):
        """Ship the buffered records: one pipelined multi-XADD no
        matter how many partitions the burst fans out across."""
        if not self._buffered:
            return
        entries, self._buffered = self._buffered, []
        self.inq._call(self.inq.broker.xadd_many, entries)

    def drain(self, timeout_s: float = 30.0) -> Dict[str, object]:
        """Flush, then collect every outstanding result (submission
        order). One HMGET round trip per poll sweep regardless of how
        many records are outstanding."""
        self.flush()
        deadline = time.monotonic() + timeout_s
        results: dict = {}
        backoff = 0.001
        while len(results) < len(self._outstanding):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            missing = [u for u in self._outstanding if u not in results]
            found = self.out.query_many(missing, delete=True,
                                        deadline=deadline)
            if found:
                results.update(found)
                backoff = 0.001
                continue
            time.sleep(min(backoff, max(0.0, remaining)))
            backoff = min(backoff * 2, 0.05)
        missing = [u for u in self._outstanding if u not in results]
        if missing:
            raise TimeoutError(
                f"No prediction for {len(missing)}/"
                f"{len(self._outstanding)} streamed records within "
                f"{timeout_s}s")
        ordered = {u: results[u] for u in self._order if u in results}
        self._outstanding = []
        self._order = []
        return ordered


class OutputQueue(_Reconnecting):
    _MAX_HOPS = 1024

    def __init__(self, broker: Union[Broker, str, None] = None,
                 stream: str = STREAM, reconnect_attempts: int = 8):
        super().__init__(reconnect_attempts=reconnect_attempts)
        self.broker = broker if isinstance(broker, Broker) \
            else connect_broker(broker)
        self.stream = stream
        self.result_key = f"result:{stream}"
        # per-hop engine timing summaries: when tracing is
        # on, each writeback row carries a compact "hops" dict —
        # stripped from the decoded result and kept here (bounded,
        # most-recent window) so the client can attribute its own e2e
        # latency: e2e minus hops["engine_ms"] = wire + broker time
        self.last_hops: Dict[str, Dict] = {}

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
        return self._decode(raw, uri=uri)

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
        return {u: self._decode(raw, uri=u) for u, raw in found.items()}

    def dequeue(self) -> Dict[str, np.ndarray]:
        """Drain all COMPLETED results (`client.py:203` semantics): one
        read plus one batched delete, not one round trip per field.

        Generative streaming writes extra ``<uri>#<index>``
        token rows before the final ``uri`` row lands; a result exists
        only once its exact uri field does. Token rows whose final row
        is present are consumed (deleted) with it; token rows of a
        STILL-DECODING sequence are left in place — draining them would
        misread a partial stream as a completed result."""
        allr = self._call(self.broker.hgetall, self.result_key)
        out, drop = {}, []
        for uri, raw in allr.items():
            if "#" in uri:
                base = uri.rsplit("#", 1)[0]
                if base in allr:      # finished: consumed with its final
                    drop.append(uri)
                continue
            out[uri] = self._decode(raw, uri=uri)
            drop.append(uri)
        if drop:
            self._call(self.broker.hdel_many, self.result_key, drop)
        return out

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
        from analytics_zoo_tpu_torch.serving.fleet import engines_key
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
                blob.pop("hops", None)
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

    def _decode(self, raw: str, uri: Optional[str] = None):
        if raw == "NaN":   # per-record failure marker
            return float("nan")
        if raw == "SHED":  # admission shed: an answered
            return raw     # rejection — distinguishable from a failure
        if raw.startswith("["):  # filtered result string, e.g. topN(5)
            return raw
        blob = json.loads(raw)
        if isinstance(blob, dict) and "hops" in blob:
            hops = blob.pop("hops")
            if uri is not None and isinstance(hops, dict):
                if len(self.last_hops) >= self._MAX_HOPS:
                    self.last_hops.pop(next(iter(self.last_hops)))
                self.last_hops[uri] = hops
        return decode_ndarray(blob)
