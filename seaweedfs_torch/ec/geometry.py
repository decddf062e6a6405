"""EC geometry: RS(k,m) plus the two-tier striping block sizes.

The port's copy of seaweedfs_tpu/ec/geometry.py. Upstream hard-codes
RS(10,4) with 1 GiB large and 1 MiB small blocks
(weed/storage/erasure_coding/ec_encoder.go:17-23); here geometry is a
value, so 6+3, 12+4 and 20+4 are first-class and tests shrink the block
sizes.

The per-collection policy ``WEED_EC_GEOMETRY`` maps collections to
RS(k,m), e.g. ``default=10+4,archive=20+4,media=12+4``. A bad spec raises
ValueError. The geometry a volume was encoded under is stamped into its
``.ecm`` (striping.write_layout_marker), so rebuild, mount and decode
read it from there, never from the live policy.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

# shard holdings travel as a uint32 bitmask, and the kernel takes at
# most 32 rows: k+m must fit 32
MAX_TOTAL_SHARDS = 32


@dataclass(frozen=True)
class Geometry:
    data_shards: int = 10
    parity_shards: int = 4
    large_block_size: int = 1024 * 1024 * 1024  # 1GB
    small_block_size: int = 1024 * 1024         # 1MB

    @property
    def total_shards(self) -> int:
        return self.data_shards + self.parity_shards

    @property
    def large_row_size(self) -> int:
        return self.large_block_size * self.data_shards

    @property
    def small_row_size(self) -> int:
        return self.small_block_size * self.data_shards

    def __post_init__(self):
        if self.data_shards < 1 or self.parity_shards < 1:
            raise ValueError(f"bad geometry {self}: k and m must be >= 1")
        if self.total_shards > MAX_TOTAL_SHARDS:
            raise ValueError(f"bad geometry {self}: k+m exceeds "
                             f"{MAX_TOTAL_SHARDS}")
        if self.large_block_size % self.small_block_size:
            raise ValueError(f"bad geometry {self}: the large block must "
                             "be a multiple of the small block")


DEFAULT = Geometry()


def to_ext(shard_id: int) -> str:
    """Shard file extension: .ec00 ... .ec13 (ec_encoder.go ToExt)."""
    return f".ec{shard_id:02d}"


def parse_geometry(spec: str) -> Geometry:
    """'k+m' (or 'k,m') -> Geometry with the default block sizes.
    Raises ValueError on anything a cluster must refuse to run with."""
    s = spec.strip().replace(",", "+")
    parts = s.split("+")
    if len(parts) != 2:
        raise ValueError(f"bad EC geometry {spec!r} (want 'k+m')")
    try:
        k, m = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(f"bad EC geometry {spec!r} (want 'k+m')")
    if k < 1 or m < 1:
        raise ValueError(
            f"EC geometry {spec!r}: k and m must both be >= 1")
    if k + m > MAX_TOTAL_SHARDS:
        raise ValueError(
            f"EC geometry {spec!r}: k+m = {k + m} exceeds "
            f"{MAX_TOTAL_SHARDS}")
    return Geometry(data_shards=k, parity_shards=m)


class GeometryPolicy:
    """Per-collection RS(k,m) mapping with a default. Immutable after
    parse; lookups never fail (unknown collections get the default)."""

    def __init__(self, per_collection: "dict[str, Geometry] | None" = None,
                 default: Geometry = DEFAULT):
        self.default = default
        self.per_collection = dict(per_collection or {})

    @classmethod
    def parse(cls, spec: str) -> "GeometryPolicy":
        """'default=10+4,archive=20+4' (a bare 'k+m' sets the default).
        Raises ValueError."""
        default = DEFAULT
        mapping: dict[str, Geometry] = {}
        for entry in (spec or "").split(","):
            entry = entry.strip()
            if not entry:
                continue
            if "=" in entry:
                name, _, geo = entry.partition("=")
                name = name.strip()
            else:
                name, geo = "default", entry
            g = parse_geometry(geo)
            if name in ("default", "*", ""):
                default = g
            elif name in mapping:
                raise ValueError(
                    f"EC geometry policy names collection {name!r} twice")
            else:
                mapping[name] = g
        return cls(mapping, default)

    # what an unset WEED_EC_GEOMETRY ships: RS(10,4) for everything but
    # the archive collection, which takes RS(20,4) (parity overhead 20%,
    # any 4 of 24 shards may be lost)
    DEFAULT_SPEC = "default=10+4,archive=20+4"

    @classmethod
    def from_env(cls) -> "GeometryPolicy":
        return cls.parse(os.environ.get("WEED_EC_GEOMETRY",
                                        cls.DEFAULT_SPEC))

    def for_collection(self, collection: str = "") -> Geometry:
        return self.per_collection.get(collection or "", self.default)

    def to_dict(self) -> dict:
        """{'default': 'k+m', collections...}: the policy's wire form."""
        out = {"default":
               f"{self.default.data_shards}+{self.default.parity_shards}"}
        for name, g in sorted(self.per_collection.items()):
            out[name] = f"{g.data_shards}+{g.parity_shards}"
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "GeometryPolicy":
        default = DEFAULT
        mapping: dict[str, Geometry] = {}
        for name, geo in (d or {}).items():
            g = parse_geometry(str(geo))
            if name == "default":
                default = g
            else:
                mapping[name] = g
        return cls(mapping, default)
