"""ShardBits: uint32 bitmask of held EC shard ids.

The port's copy of seaweedfs_tpu/ec/shard_bits.py. Wire form + algebra of the reference's ShardBits
(weed/storage/erasure_coding/ec_volume_info.go:61-113): each bit i set
means shard i is held; Plus/Minus merge holdings, MinusParityShards drops
the parity tail for data-only views.
"""

from __future__ import annotations

from typing import Iterable


def from_ids(ids: Iterable[int]) -> int:
    bits = 0
    for sid in ids:
        bits |= 1 << sid
    return bits


def to_ids(bits: int) -> list[int]:
    out = []
    i = 0
    while bits >> i:
        if bits & (1 << i):
            out.append(i)
        i += 1
    return out


def plus(bits: int, other: int) -> int:
    return bits | other


def minus(bits: int, other: int) -> int:
    return bits & ~other


def minus_parity_shards(bits: int, data_shards: int) -> int:
    """Keep only data-shard bits (MinusParityShards)."""
    return bits & ((1 << data_shards) - 1)


def count(bits: int) -> int:
    return bin(bits).count("1")
