"""Needle maps: in-memory id -> (offset, size) index with .idx journaling.

The port's copy of the two maps the EC slice needs from
seaweedfs_tpu/storage/needle_map.py: ``NeedleMap``, the live per-volume
map (a dict, journaling every mutation to the .idx file), and
``SortedNeedleMap``, the offline sorted map (upstream's MemDb,
weed/storage/needle_map/memdb.go) that builds .ecx files; and the two
helpers crash recovery and compaction use, ``_truncate_torn_tail`` and
``remove_sidecars``. The compact, disk-backed and LevelDB-style kinds are
not ported.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional

from . import idx as idx_mod
from . import types as t


@dataclass(frozen=True)
class NeedleValue:
    key: int
    offset: int  # stored units (multiply by 8 for byte offset)
    size: int    # signed


def _truncate_torn_tail(index_path: str, offset_size: int) -> None:
    """Align-truncate an .idx journal whose last record was torn by a
    power loss mid-append. The partial entry carries no usable data
    (iter_index_* already skip it) but appending AFTER it would corrupt
    the journal's alignment for every later record — so the torn bytes
    are cut before the journal is reopened for append."""
    if not os.path.exists(index_path):
        return
    entry = t.needle_map_entry_size(offset_size)
    size = os.path.getsize(index_path)
    torn = size % entry
    if torn:
        import logging
        logging.getLogger("needle_map").warning(
            "%s: truncating %d torn tail bytes (crash recovery)",
            index_path, torn)
        with open(index_path, "r+b") as f:
            f.truncate(size - torn)


class NeedleMap:
    """Live per-volume map, journaling every mutation to the .idx file.

    Mirrors baseNeedleMapper metrics semantics (weed/storage/needle_map.go,
    needle_map_metric.go): file_count / deleted_count only ever grow with
    journal entries; *_size track bytes.
    """

    def __init__(self, index_path: Optional[str] = None,
                 offset_size: int = t.OFFSET_SIZE):
        self.offset_size = offset_size
        self._map: dict[int, NeedleValue] = {}
        self._index_file = None
        self.file_count = 0
        self.deleted_count = 0
        self.file_byte_count = 0
        self.deleted_byte_count = 0
        self.maximum_key = 0
        if index_path is not None:
            _truncate_torn_tail(index_path, offset_size)
            self._load(index_path)
            self._index_file = open(index_path, "ab")

    def _load(self, index_path: str) -> None:
        if not os.path.exists(index_path):
            open(index_path, "wb").close()
            return
        for key, offset, size in idx_mod.iter_index_file(
                index_path, offset_size=self.offset_size):
            self.maximum_key = max(self.maximum_key, key)
            if offset > 0 and size != t.TOMBSTONE_FILE_SIZE:
                existing = self._map.get(key)
                # a put over a TOMBSTONE is not a deletion — only a live
                # overwrite orphans bytes (matches put() and the
                # reference's oldSize.IsValid() check)
                if existing is not None and existing.size > 0:
                    self.deleted_count += 1
                    self.deleted_byte_count += existing.size
                self._map[key] = NeedleValue(key, offset, size)
                self.file_count += 1
                self.file_byte_count += max(size, 0)
            else:
                existing = self._map.get(key)
                if existing is not None and existing.size > 0:
                    self._map[key] = NeedleValue(key, existing.offset,
                                                 -existing.size)
                    self.deleted_count += 1
                    self.deleted_byte_count += max(existing.size, 0)

    # --- mutation ---
    def put(self, key: int, stored_offset: int, size: int) -> None:
        existing = self._map.get(key)
        if existing is not None and existing.size > 0:
            # overwriting a live entry orphans its old bytes
            self.deleted_count += 1
            self.deleted_byte_count += existing.size
        self._map[key] = NeedleValue(key, stored_offset, size)
        self.file_count += 1
        self.file_byte_count += max(size, 0)
        self.maximum_key = max(self.maximum_key, key)
        if self._index_file is not None:
            self._index_file.write(idx_mod.pack_entry(
                key, stored_offset, size, offset_size=self.offset_size))
            self._index_file.flush()

    def delete(self, key: int, tombstone_offset: int = 0) -> bool:
        """Mark deleted. The entry stays with a negated size so reads can
        distinguish deleted from never-existed (CompactMap.Delete semantics,
        weed/storage/needle_map/compact_map.go)."""
        existing = self._map.get(key)
        if existing is None or existing.size < 0:
            return False
        self._map[key] = NeedleValue(key, existing.offset, -existing.size)
        self.deleted_count += 1
        self.deleted_byte_count += max(existing.size, 0)
        if self._index_file is not None:
            self._index_file.write(idx_mod.pack_entry(
                key, tombstone_offset, t.TOMBSTONE_FILE_SIZE,
                offset_size=self.offset_size))
            self._index_file.flush()
        return True

    # --- query ---
    def get(self, key: int) -> Optional[NeedleValue]:
        """Returns the entry, with size < 0 when the needle was deleted."""
        return self._map.get(key)

    def __len__(self) -> int:
        # list() copies the values in one step: the heartbeat counts on
        # the event loop while executor threads write
        return sum(1 for nv in list(self._map.values()) if nv.size > 0)

    def __contains__(self, key: int) -> bool:
        nv = self._map.get(key)
        return nv is not None and nv.size > 0

    def content_size(self) -> int:
        return self.file_byte_count

    def values(self) -> list[NeedleValue]:
        """All current entries (live and tombstoned), unordered."""
        return list(self._map.values())

    def live_entries(self) -> list[tuple[int, int]]:
        """Live (needle_id, size) pairs — the fsck/needle-status
        inventory."""
        return [(key, nv.size) for key, nv in sorted(self._map.items())
                if nv.size > 0]

    def sync(self) -> None:
        """Durability barrier: flush + fsync the .idx journal. Entries
        journaled before this call survive power loss (the .dat record
        they point at must be synced FIRST — Volume.sync orders the
        two)."""
        if self._index_file is not None:
            self._index_file.flush()
            os.fsync(self._index_file.fileno())

    def close(self) -> None:
        if self._index_file is not None:
            self._index_file.close()
            self._index_file = None


def remove_sidecars(index_path: str) -> None:
    """Drop any derived index sidecars (.sdx) of an .idx that is being
    replaced wholesale (vacuum commit, crash recovery): the port builds
    none, but a directory written by the reference's disk-backed map may
    hold them, and a stale one must never outlive its journal."""
    base = (index_path[:-4] if index_path.endswith(".idx")
            else index_path)
    for suffix in (".sdx", ".sdx.tmp"):
        try:
            os.remove(base + suffix)
        except FileNotFoundError:
            pass


class SortedNeedleMap:
    """Offline sorted map (MemDb equivalent) used to build .ecx files.

    Load an .idx journal (folding deletes), then emit entries ascending by
    needle id — the invariant the EC index binary search depends on
    (reference WriteSortedFileFromIdx, ec_encoder.go:27-54).
    """

    def __init__(self) -> None:
        self._map: dict[int, NeedleValue] = {}
        self.offset_size = t.OFFSET_SIZE

    @classmethod
    def from_idx_file(cls, index_path: str,
                      offset_size: int = t.OFFSET_SIZE) -> "SortedNeedleMap":
        db = cls()
        db.offset_size = offset_size
        for key, offset, size in idx_mod.iter_index_file(
                index_path, offset_size=offset_size):
            if offset > 0 and size != t.TOMBSTONE_FILE_SIZE:
                db.set(key, offset, size)
            else:
                db.delete(key)
        return db

    def set(self, key: int, stored_offset: int, size: int) -> None:
        self._map[key] = NeedleValue(key, stored_offset, size)

    def delete(self, key: int) -> None:
        self._map.pop(key, None)

    def get(self, key: int) -> Optional[NeedleValue]:
        return self._map.get(key)

    def ascending(self) -> Iterator[NeedleValue]:
        for key in sorted(self._map):
            yield self._map[key]

    def write_sorted_index(self, path: str) -> None:
        with open(path, "wb") as f:
            for nv in self.ascending():
                f.write(idx_mod.pack_entry(nv.key, nv.offset, nv.size,
                                           offset_size=self.offset_size))
