"""Paged KV memory — block pool, per-sequence block tables, prefix cache.

Copied from `analytics_zoo_tpu/serving/paged_kv.py` as it is
(`KVBlockPool` L41, `PrefixCache` L147). In the port the engine's
block pool holds torch tensors that the paged programs update in
place.

The contiguous `KVSlotPool` reserves a full ``max_kv_len`` stripe
per sequence, so a 10-token request on a 128-position pool idles ~90%
of its bytes and concurrent capacity is capped at ``pool_bytes /
stripe_bytes`` however short the traffic runs. This module is the
PagedAttention discipline (vLLM, Kwon et al. 2023) on the same rails:

- ``KVBlockPool`` — the KV cache is ONE device buffer set of shape
  ``[num_blocks, heads, block_len, head_dim]`` per layer (built by the
  model's ``init_kv_blocks``). Sequences own an ordered list of block
  ids (their *block table*) and grow block-by-block; capacity is
  bounded by live TOKENS, not live sequences × max length. Blocks are
  ref-counted so the prefix cache can share one physical block across
  every sequence that opens with the same tokens. Block 0 is a
  reserved scratch row: dead decode lanes write their (discarded)
  KV there so a fixed-shape step executable never corrupts live
  blocks.
- ``PrefixCache`` — a trie keyed on token-id chunks of one block each
  (RadixAttention's structure at block granularity): a finished
  prefill publishes its FULL prompt blocks under their token path, and
  a new prompt walks the trie and adopts every matching block
  copy-free — that whole span of prefill compute is skipped, which is
  the TTFT win on instruction-prefix-heavy traffic. The cache holds
  one reference per published block; eviction is LRU over trie leaves
  and only actually frees a block when its refcount reaches zero (a
  block adopted by a live sequence survives eviction from the trie
  untouched).

Both structures are bookkeeping only: the device buffers are threaded
functionally through prefill/step calls by the engine (`decode.py`),
exactly like the slot pool before them.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


class KVBlockPool:
    """Fixed pool of ref-counted KV blocks over ONE device buffer set.

    ``init_kv_blocks(num_blocks, block_len)`` builds the per-layer
    ``{"k","v"}: [num_blocks, heads, block_len, head_dim]`` pytree held
    in ``self.kv`` (rebound by the engine after every call, like the
    slot pool). The pool itself only tracks which blocks are leased and
    how many owners each has; block 0 is reserved as the scratch row
    for dead decode lanes and is never allocated."""

    SCRATCH = 0

    def __init__(self, init_kv_blocks: Callable[[int, int], Any],
                 num_blocks: int, block_len: int, registry=None,
                 labels: Optional[Dict[str, str]] = None):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (scratch + one usable block), "
                f"got {num_blocks}")
        if block_len < 1:
            raise ValueError(f"block_len must be >= 1, got {block_len}")
        self.num_blocks = int(num_blocks)
        self.block_len = int(block_len)
        self.kv = init_kv_blocks(self.num_blocks, self.block_len)
        # allocate low ids first (stable layouts in tests/benchmarks)
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._labels = dict(labels or {})
        if registry is None:
            from analytics_zoo_tpu_torch.observability.registry import \
                get_registry
            registry = get_registry()
        self._gauge = registry.gauge(
            "serving_kv_blocks_in_use",
            "KV-cache blocks currently referenced by in-flight sequences "
            "or the prefix cache (out of the engine's fixed block pool) "
            "— the paged decode engine's capacity signal")
        self._gauge.set(0.0, **self._labels)

    # -- allocation --------------------------------------------------------
    def alloc(self) -> Optional[int]:
        """Lease one free block (refcount 1), or None when exhausted —
        the caller decides whether to evict from the prefix cache and
        retry or to stop admitting."""
        with self._lock:
            if not self._free:
                return None
            block = self._free.pop()
            self._ref[block] = 1
            self._gauge.set(self.num_blocks - 1 - len(self._free),
                            **self._labels)
            return block

    def retain(self, block: int) -> None:
        """Add one owner to a live block (prefix-cache publish/adopt)."""
        with self._lock:
            if self._ref.get(block, 0) < 1:
                raise ValueError(f"retain of unleased block {block}")
            self._ref[block] += 1

    def release(self, block: int) -> None:
        """Drop one owner; the block returns to the free list only at
        refcount zero (shared prefix blocks survive their adopters)."""
        with self._lock:
            refs = self._ref.get(block, 0)
            if refs < 1:
                raise ValueError(f"release of unleased block {block}")
            if refs == 1:
                del self._ref[block]
                self._free.append(block)
                self._gauge.set(self.num_blocks - 1 - len(self._free),
                                **self._labels)
            else:
                self._ref[block] = refs - 1

    def refcount(self, block: int) -> int:
        with self._lock:
            return self._ref.get(block, 0)

    @property
    def capacity(self) -> int:
        """Usable blocks (the scratch row is not capacity)."""
        return self.num_blocks - 1

    @property
    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def in_use(self) -> int:
        with self._lock:
            return self.num_blocks - 1 - len(self._free)


class _TrieNode:
    __slots__ = ("key", "block", "children", "parent", "last_use")

    def __init__(self, key, block, parent):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_TrieNode"] = {}
        self.last_use = 0


class PrefixCache:
    """Ref-counted shared-prefix block cache over a `KVBlockPool`.

    Keys are tuples of ``block_len`` token ids — one trie edge per full
    prompt block — so a lookup is pure token-id comparison and a hit
    adopts the PHYSICAL blocks an earlier identical prefix already
    computed (copy-free: the adopter only gains references). Only fully
    written blocks are ever published — prompt spans at prefill
    completion, and full CONTEXT spans (prompt ⊕ generated)
    when a sequence is preempted or resumes, since decode writes land
    strictly beyond a full block; a block that could still receive
    writes never enters the trie, so shared blocks are immutable by
    construction.

    Eviction (`evict_for`) is LRU over leaves, preferring blocks whose
    only owner is the cache itself — evicting a block a live sequence
    adopted removes it from future matching but frees no bytes until
    that sequence finishes."""

    def __init__(self, pool: KVBlockPool, registry=None,
                 labels: Optional[Dict[str, str]] = None,
                 max_blocks: Optional[int] = None):
        self.pool = pool
        self.block_len = pool.block_len
        self.max_blocks = int(max_blocks) if max_blocks else None
        self._root = _TrieNode((), None, None)
        self._nodes: List[_TrieNode] = []
        self._clock = 0
        self._lock = threading.Lock()
        labels = dict(labels or {})
        if registry is None:
            from analytics_zoo_tpu_torch.observability.registry import \
                get_registry
            registry = get_registry()
        self._hits = registry.counter(
            "serving_prefix_cache_hits_total",
            "prompts that adopted at least one cached prefix block "
            "(that span of prefill compute was skipped entirely)")
        self._misses = registry.counter(
            "serving_prefix_cache_misses_total",
            "prompts that adopted no cached prefix block and ran full "
            "prefill")
        self._blocks_gauge = registry.gauge(
            "serving_prefix_cache_blocks",
            "KV blocks currently published in the prefix-cache trie")
        self._pressure_evictions = registry.counter(
            "serving_kv_pressure_evictions_total",
            "prefix-cache blocks evicted under allocation pressure "
            "(`evict_for`: the pool ran dry and cold cached prefixes "
            "were dropped to make room for live sequences) — sustained "
            "growth means the block pool is undersized for the offered "
            "load")
        self._labels = labels
        self._blocks_gauge.set(0.0, **labels)

    def __len__(self) -> int:
        with self._lock:
            return len(self._nodes)

    def _key(self, tokens, i: int) -> Tuple[int, ...]:
        bl = self.block_len
        return tuple(int(t) for t in tokens[i * bl:(i + 1) * bl])

    def match(self, tokens: Sequence[int]) -> List[int]:
        """Longest cached prefix of `tokens`, as adopted block ids (one
        pool reference taken per block, owned by the caller). At most
        ``(len(tokens) - 1) // block_len`` blocks match — at least one
        prompt token must remain un-cached so prefill still has a real
        query to produce the first generated token."""
        out: List[int] = []
        with self._lock:
            node = self._root
            for i in range((len(tokens) - 1) // self.block_len):
                child = node.children.get(self._key(tokens, i))
                if child is None:
                    break
                self._clock += 1
                child.last_use = self._clock
                out.append(child.block)
                node = child
            for b in out:
                self.pool.retain(b)
        (self._hits if out else self._misses).inc(**self._labels)
        return out

    def insert(self, tokens: Sequence[int], blocks: Sequence[int]) -> int:
        """Publish a prompt's full blocks under their token path (the
        caller passes exactly its fully-written prompt blocks, in
        order). Existing path nodes are kept (first writer wins — the
        adopters already share them); each NEWLY published block gains
        one cache-owned reference. Returns the number of new nodes."""
        n = min(len(blocks), len(tokens) // self.block_len)
        added = 0
        with self._lock:
            node = self._root
            for i in range(n):
                key = self._key(tokens, i)
                child = node.children.get(key)
                if child is None:
                    if (self.max_blocks is not None
                            and len(self._nodes) >= self.max_blocks
                            and not self._evict_locked(1)):
                        break
                    child = _TrieNode(key, int(blocks[i]), node)
                    self.pool.retain(child.block)
                    node.children[key] = child
                    self._nodes.append(child)
                    added += 1
                self._clock += 1
                child.last_use = self._clock
                node = child
            self._blocks_gauge.set(float(len(self._nodes)), **self._labels)
        return added

    # -- eviction ----------------------------------------------------------
    def _leaves(self) -> List[_TrieNode]:
        return [n for n in self._nodes if not n.children]

    def _drop_locked(self, node: _TrieNode) -> None:
        del node.parent.children[node.key]
        self._nodes.remove(node)
        self.pool.release(node.block)

    def _evict_locked(self, want: int) -> int:
        """Drop up to `want` LRU leaves that would actually free bytes
        (cache is the sole owner); falls back to still-shared leaves
        only when nothing else is evictable, so pressure trims dead
        prefixes before it forgets live ones."""
        evicted = 0
        while evicted < want:
            leaves = self._leaves()
            if not leaves:
                break
            sole = [n for n in leaves if self.pool.refcount(n.block) == 1]
            pick = min(sole or leaves, key=lambda n: n.last_use)
            self._drop_locked(pick)
            evicted += 1
        self._blocks_gauge.set(float(len(self._nodes)), **self._labels)
        return evicted

    def evict_for(self, blocks_needed: int = 1) -> int:
        """Evict LRU sole-owner leaves until the pool has
        `blocks_needed` free blocks or none remain; returns nodes
        dropped. Shared leaves are left alone here — dropping a block a
        live sequence still references frees no bytes now, and it would
        only erase a prefix that is demonstrably hot."""
        dropped = 0
        with self._lock:
            while self.pool.free_count < blocks_needed:
                sole = [n for n in self._leaves()
                        if self.pool.refcount(n.block) == 1]
                if not sole:
                    break
                self._drop_locked(min(sole, key=lambda n: n.last_use))
                dropped += 1
            self._blocks_gauge.set(float(len(self._nodes)), **self._labels)
        if dropped:
            self._pressure_evictions.inc(dropped, **self._labels)
        return dropped
