"""Partition routing of the request plane.

Copied from `analytics_zoo_tpu/serving/partitions.py` (L61-110): the
stable uri → partition map and the partition stream names that
`InputQueue` routes records by. ``partitions=1`` keeps the single
unsuffixed stream. `PartitionLeaseTable` and `GatewayLeaderLease` wait for
the serving plane (ROADMAP.md queue 1, item 4).
"""

from __future__ import annotations

import zlib
from typing import List

PARTITIONS_KEY_PREFIX = "partitions:"
GATEWAY_KEY_PREFIX = "gateway:"
MAX_PARTITIONS = 1024


def partitions_key(stream: str) -> str:
    """The broker hash carrying the partition lease table."""
    return PARTITIONS_KEY_PREFIX + stream


def gateway_key(stream: str) -> str:
    """The broker hash carrying the gateway leader lease."""
    return GATEWAY_KEY_PREFIX + stream


def validate_partitions(n) -> int:
    n = int(n)
    if not 1 <= n <= MAX_PARTITIONS:
        raise ValueError(
            f"partitions={n} must be in [1, {MAX_PARTITIONS}]")
    return n


def partition_of(uri: str, partitions: int) -> int:
    """Stable uri -> partition map (CRC32 mod N): every client, gateway
    and engine computes the same route with no shared state. CRC32 is
    deterministic across processes and platforms — `hash()` is salted
    per interpreter and would split one uri across the fleet."""
    if partitions <= 1:
        return 0
    return zlib.crc32(str(uri).encode()) % partitions


def partition_stream(stream: str, index: int, partitions: int) -> str:
    """Partition `index`'s stream name. One partition keeps the legacy
    unsuffixed name so ``partitions=1`` deployments are byte-identical
    with every earlier release (same stream, same PEL, same bench)."""
    if partitions <= 1:
        return stream
    return f"{stream}.p{index}"


def partition_streams(stream: str, partitions: int) -> List[str]:
    return [partition_stream(stream, i, partitions)
            for i in range(max(1, int(partitions)))]


def stream_for(stream: str, uri: str, partitions: int) -> str:
    return partition_stream(stream, partition_of(uri, partitions),
                            partitions)
