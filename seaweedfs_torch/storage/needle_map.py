"""Needle maps: id -> (offset, size) indexes with .idx journaling.

The port's copy of seaweedfs_tpu/storage/needle_map.py, every kind of
upstream's NeedleMapType (weed/storage/needle_map.go:14-19) that the
reference has:

- ``NeedleMap``, "memory": a dict, journaling every mutation to the .idx;
- ``CompactNeedleMap``, "compact": sorted numpy arrays (u64 key, u32
  offset, i32 size: 16 bytes an entry) plus a dict overflow merged every
  100k entries (upstream's sectioned CompactMap,
  needle_map/compact_map.go);
- ``DiskNeedleMap``, "leveldb" / "leveldbMedium" / "leveldbLarge": a
  memmapped sorted segment in a ``.sdx`` sidecar plus an in-memory delta
  that is merged into a new segment at ``FLUSH_THRESHOLD`` entries
  (100k / 400k / 1M), so the resident set stays bounded at any volume
  size. The ``.sdx`` is byte for byte the reference's, so either package
  adopts the other's sidecar without a rebuild;

``create_needle_map`` picks one by name. ``SortedNeedleMap`` is the
offline sorted map (upstream's MemDb, needle_map/memdb.go) that builds
.ecx files; ``_truncate_torn_tail`` and ``remove_sidecars`` serve crash
recovery and every wholesale replacement of an .idx.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

from . import idx as idx_mod
from . import types as t
from ..utils import durable


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

    def flush_imminent(self, incoming: int = 1) -> bool:
        """Whether `incoming` more puts would trigger an expensive segment
        merge (disk-backed kinds only); event-loop callers use this to
        route such batches off the loop."""
        return False

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

    def ascending_visit(self, fn: Callable[[NeedleValue], None]) -> None:
        for key in sorted(self._map):
            if self._map[key].size > 0:
                fn(self._map[key])

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


class CompactNeedleMap(NeedleMap):
    """Sectioned numpy needle map — 16 bytes/entry at any scale.

    The reference's CompactMap keeps 100k-entry sorted sections plus an
    overflow area (weed/storage/needle_map/compact_map.go:10-40) precisely
    to hold 100M+ needles at 16B each; a Python dict of NeedleValues costs
    ~10x that. Here the settled entries live in parallel numpy arrays
    (u64 key / u32 offset / i32 size = 16B), binary-searched per lookup,
    with a small dict overflow for recent writes that merges in batches.

    Same public surface and .idx journaling as NeedleMap (selected with
    needle_map_kind="compact").
    """

    MERGE_THRESHOLD = 100_000

    def __init__(self, index_path: Optional[str] = None,
                 offset_size: int = t.OFFSET_SIZE):
        import numpy as np
        self._np = np
        self._keys = np.empty(0, dtype=np.uint64)
        # 5-byte offsets need the u64 column (20B/entry instead of 16)
        odt = np.uint32 if offset_size == 4 else np.uint64
        self._offsets = np.empty(0, dtype=odt)
        self._sizes = np.empty(0, dtype=np.int32)
        super().__init__(index_path, offset_size)
        self._merge()

    def _load(self, index_path: str) -> None:
        """Replay the .idx journal folding into the arrays in
        MERGE_THRESHOLD batches — peak memory stays at the 16B/entry
        budget even for 100M-entry volumes (the dict-based parent _load
        would momentarily cost ~10x that)."""
        if not os.path.exists(index_path):
            open(index_path, "wb").close()
            return
        for key, offset, size in idx_mod.iter_index_file(
                index_path, offset_size=self.offset_size):
            self.maximum_key = max(self.maximum_key, key)
            if offset > 0 and size != t.TOMBSTONE_FILE_SIZE:
                existing = self._store_get(key)
                # put-over-tombstone is not a deletion (see NeedleMap._load)
                if existing is not None and existing.size > 0:
                    self.deleted_count += 1
                    self.deleted_byte_count += existing.size
                self._store_set(NeedleValue(key, offset, size))
                self.file_count += 1
                self.file_byte_count += max(size, 0)
            else:
                existing = self._store_get(key)
                if existing is not None and existing.size > 0:
                    self._store_set(NeedleValue(key, existing.offset,
                                                -existing.size))
                    self.deleted_count += 1
                    self.deleted_byte_count += max(existing.size, 0)

    # storage primitives -------------------------------------------------
    def _array_index(self, key: int) -> int:
        i = int(self._np.searchsorted(self._keys, self._np.uint64(key)))
        if i < len(self._keys) and int(self._keys[i]) == key:
            return i
        return -1

    def _store_get(self, key: int) -> Optional[NeedleValue]:
        nv = self._map.get(key)
        if nv is not None:
            return nv
        i = self._array_index(key)
        if i < 0:
            return None
        return NeedleValue(key, int(self._offsets[i]), int(self._sizes[i]))

    def _store_set(self, nv: NeedleValue) -> None:
        if nv.key not in self._map:
            i = self._array_index(nv.key)
            if i >= 0:
                # in-place update keeps the arrays sorted and allocation-free
                self._offsets[i] = nv.offset
                self._sizes[i] = nv.size
                return
        self._map[nv.key] = nv
        if len(self._map) >= self.MERGE_THRESHOLD:
            self._merge()

    def _merge(self) -> None:
        if not self._map:
            return
        np = self._np
        new_keys = np.fromiter(self._map.keys(), dtype=np.uint64,
                               count=len(self._map))
        order = np.argsort(new_keys, kind="stable")
        new_keys = new_keys[order]
        vals = list(self._map.values())
        new_offsets = np.fromiter((vals[i].offset for i in order),
                                  dtype=self._offsets.dtype, count=len(vals))
        new_sizes = np.fromiter((vals[i].size for i in order),
                                dtype=np.int32, count=len(vals))
        # drop array entries shadowed by the overflow, then merge-sort
        keep = ~np.isin(self._keys, new_keys)
        keys = np.concatenate([self._keys[keep], new_keys])
        offsets = np.concatenate([self._offsets[keep], new_offsets])
        sizes = np.concatenate([self._sizes[keep], new_sizes])
        order = np.argsort(keys, kind="stable")
        self._keys = keys[order]
        self._offsets = offsets[order]
        self._sizes = sizes[order]
        self._map.clear()

    # public surface (counters ride the NeedleMap implementations) -------
    def put(self, key: int, stored_offset: int, size: int) -> None:
        existing = self._store_get(key)
        if existing is not None and existing.size > 0:
            self.deleted_count += 1
            self.deleted_byte_count += existing.size
        self._store_set(NeedleValue(key, stored_offset, size))
        self.file_count += 1
        self.file_byte_count += max(size, 0)
        self.maximum_key = max(self.maximum_key, key)
        if self._index_file is not None:
            self._index_file.write(idx_mod.pack_entry(
                key, stored_offset, size, offset_size=self.offset_size))
            self._index_file.flush()

    def delete(self, key: int, tombstone_offset: int = 0) -> bool:
        existing = self._store_get(key)
        if existing is None or existing.size < 0:
            return False
        self._store_set(NeedleValue(key, existing.offset, -existing.size))
        self.deleted_count += 1
        self.deleted_byte_count += max(existing.size, 0)
        if self._index_file is not None:
            self._index_file.write(idx_mod.pack_entry(
                key, tombstone_offset, t.TOMBSTONE_FILE_SIZE,
                offset_size=self.offset_size))
            self._index_file.flush()
        return True

    def get(self, key: int) -> Optional[NeedleValue]:
        return self._store_get(key)

    def __len__(self) -> int:
        # overflow and arrays are disjoint (in-place array updates), so
        # no merge is needed — heartbeats stay O(overflow); list() copies
        # the overflow in one step, as the heartbeat counts on the event
        # loop while executor threads write
        return int((self._sizes > 0).sum()) + \
            sum(1 for nv in list(self._map.values()) if nv.size > 0)

    def __contains__(self, key: int) -> bool:
        nv = self._store_get(key)
        return nv is not None and nv.size > 0

    def ascending_visit(self, fn: Callable[[NeedleValue], None]) -> None:
        self._merge()
        for i in range(len(self._keys)):
            if self._sizes[i] > 0:
                fn(NeedleValue(int(self._keys[i]), int(self._offsets[i]),
                               int(self._sizes[i])))

    def live_entries(self) -> list[tuple[int, int]]:
        self._merge()
        live = self._sizes > 0
        return list(zip((int(k) for k in self._keys[live]),
                        (int(s) for s in self._sizes[live])))

    def values(self):
        self._merge()
        return [NeedleValue(int(self._keys[i]), int(self._offsets[i]),
                            int(self._sizes[i]))
                for i in range(len(self._keys))]


class DiskNeedleMap(NeedleMap):
    """Disk-resident needle map: RAM stays bounded at any volume scale.

    The reference ships three LevelDB-backed kinds for volumes whose
    needle count exceeds what RAM should hold
    (weed/storage/needle_map.go:14-19, needle_map/needle_map_leveldb.go).
    This build keeps the same two-structure LSM shape but leans on what
    the volume already has: the .idx journal IS the write-ahead log, so
    the only extra state is a single sorted-segment sidecar:

      <base>.sdx   96B header (counters, journal bytes covered, and the
                   raw final journal entry as an adoption fingerprint)
                   + three sections: keys u64[n] asc, offsets u64[n],
                   sizes i32[n] (tombstones negative)

    Lookups hit a small in-memory delta dict first, then binary-search
    the memmapped key section — O(log n) page touches, zero resident
    copies. When the delta outgrows FLUSH_THRESHOLD it merges into a new
    .sdx (temp file + fsync + one atomic rename; header and sections
    travel together so no crash can pair stale counters with new data).
    On open the .sdx is adopted only when the journal still matches its
    fingerprint — a wholesale .idx replacement (vacuum commit, volume
    copy, weed fix) is detected and triggers a full rebuild — and only
    the journal tail written after the last flush is replayed: startup
    cost is O(tail), not O(volume).
    """

    MAGIC = b"SWSDX2\x00\x00"
    HEADER_SIZE = 96
    FLUSH_THRESHOLD = 100_000

    def __init__(self, index_path: Optional[str] = None,
                 offset_size: int = t.OFFSET_SIZE):
        import numpy as np
        self._np = np
        self._keys = None     # np.memmap u64, ascending
        self._offsets = None  # np.memmap u64 (width-agnostic on disk)
        self._sizes = None    # np.memmap i32
        self._count = 0
        self._index_path = index_path
        # what the open did and what the map has written since, for the
        # operator's view of a large volume's start-up: whether the .sdx
        # was adopted, how many journal entries were folded, how many
        # segments were written
        self.adopted = False
        self.replayed = 0
        self.flushes = 0
        super().__init__(index_path, offset_size)

    # --- sidecar file ---
    def _sdx_path(self) -> str:
        base = self._index_path
        return (base[:-4] if base.endswith(".idx") else base) + ".sdx"

    def _header_bytes(self, count: int) -> bytes:
        """96B header; the fingerprint is the raw final journal entry the
        segment folds, so a replaced .idx can never be mistaken for an
        appended one."""
        covered = 0
        tail = b""
        if self._index_path and os.path.exists(self._index_path):
            entry = t.needle_map_entry_size(self.offset_size)
            size = os.path.getsize(self._index_path)
            covered = size - size % entry
            if covered:
                with open(self._index_path, "rb") as f:
                    f.seek(covered - entry)
                    tail = f.read(entry)
        head = bytearray(self.HEADER_SIZE)
        head[0:8] = self.MAGIC
        for i, v in enumerate((count, covered, self.file_count,
                               self.deleted_count, self.file_byte_count,
                               self.deleted_byte_count, self.maximum_key)):
            head[8 + 8 * i:16 + 8 * i] = v.to_bytes(8, "little")
        head[64] = len(tail)
        head[65:65 + len(tail)] = tail
        return bytes(head)

    def _parse_header(self, head: bytes) -> Optional[dict]:
        if len(head) < self.HEADER_SIZE or head[0:8] != self.MAGIC:
            return None
        vals = [int.from_bytes(head[8 + 8 * i:16 + 8 * i], "little")
                for i in range(7)]
        tail_len = head[64]
        return {"count": vals[0], "idx_covered": vals[1],
                "file_count": vals[2], "deleted_count": vals[3],
                "file_byte_count": vals[4], "deleted_byte_count": vals[5],
                "maximum_key": vals[6],
                "tail": bytes(head[65:65 + tail_len])}

    def _open_sdx(self, path: str) -> Optional[dict]:
        np = self._np
        try:
            with open(path, "rb") as f:
                head = f.read(self.HEADER_SIZE)
            meta = self._parse_header(head)
            if meta is None:
                return None
            n = meta["count"]
            if os.path.getsize(path) != self.HEADER_SIZE + n * 20:
                return None
            hs = self.HEADER_SIZE
            if n:
                self._keys = np.memmap(path, dtype=np.uint64, mode="r",
                                       offset=hs, shape=(n,))
                self._offsets = np.memmap(path, dtype=np.uint64, mode="r",
                                          offset=hs + 8 * n, shape=(n,))
                self._sizes = np.memmap(path, dtype=np.int32, mode="r",
                                        offset=hs + 16 * n, shape=(n,))
            else:
                self._keys = self._offsets = self._sizes = None
            self._count = n
            return meta
        except (OSError, ValueError):
            return None

    def _load(self, index_path: str) -> None:
        if not os.path.exists(index_path):
            open(index_path, "wb").close()
        sdx = self._sdx_path()
        replay_from = 0
        if os.path.exists(sdx):
            meta = self._open_sdx(sdx)
            if meta is not None and self._adoptable(index_path, meta):
                self.adopted = True
                replay_from = meta["idx_covered"]
                self.file_count = meta["file_count"]
                self.deleted_count = meta["deleted_count"]
                self.file_byte_count = meta["file_byte_count"]
                self.deleted_byte_count = meta["deleted_byte_count"]
                self.maximum_key = meta["maximum_key"]
            else:
                # stale/corrupt sidecar (e.g. .idx replaced wholesale by
                # vacuum commit or volume copy): rebuild from the journal
                self._keys = self._offsets = self._sizes = None
                self._count = 0
        if (replay_from == 0 and self.offset_size == t.OFFSET_SIZE
                and self._bulk_load(index_path)):
            return
        for key, offset, size in idx_mod.iter_index_file(
                index_path, start=replay_from,
                offset_size=self.offset_size):
            self._fold(key, offset, size)
            self.replayed += 1
        if len(self._map) >= self.FLUSH_THRESHOLD:
            self._flush()

    def _adoptable(self, index_path: str, meta: dict) -> bool:
        entry = t.needle_map_entry_size(self.offset_size)
        covered = meta["idx_covered"]
        idx_size = os.path.getsize(index_path)
        if covered > idx_size or covered % entry:
            return False
        if covered == 0:
            return True
        with open(index_path, "rb") as f:
            f.seek(covered - entry)
            return f.read(entry) == meta["tail"]

    def _bulk_load(self, index_path: str) -> bool:
        """Vectorized cold rebuild for the common journal shape (unique
        keys, no tombstones): decode the whole .idx with numpy and write
        the .sdx directly — 10M entries land in seconds without a 10M-entry
        Python dict ever existing. Journals with overwrites/deletes fall
        back to the exact streaming fold (returns False)."""
        np = self._np
        n_bytes = os.path.getsize(index_path)
        n = n_bytes // 16
        if n < self.FLUSH_THRESHOLD:
            return False  # small journals: the plain fold is fine
        rec = np.fromfile(index_path,
                          dtype=np.dtype([("k", ">u8"), ("o", ">u4"),
                                          ("s", ">u4")]), count=n)
        # tombstone = size 0xFFFFFFFF / offset 0; any negative-size or
        # zero-offset entry means deletes happened -> exact fold
        if ((rec["o"] == 0).any() or (rec["s"] == 0).any()
                or (rec["s"] >= np.uint32(1 << 31)).any()):
            return False
        keys = rec["k"].astype(np.uint64)
        order = np.argsort(keys, kind="stable")
        skeys = keys[order]
        del keys  # peak-RSS discipline: 10M entries -> 80MB each
        if (skeys[1:] == skeys[:-1]).any():
            return False  # overwrites present: exact fold required
        self.file_count = int(n)
        self.file_byte_count = int(np.sum(rec["s"], dtype=np.uint64))
        self.maximum_key = int(skeys[-1]) if n else 0
        sdx = self._sdx_path()
        tmp = sdx + ".tmp"
        with open(tmp, "wb") as f:
            f.write(self._header_bytes(n))
            f.write(memoryview(skeys))
            # gather offsets/sizes in bounded chunks instead of whole-array
            # permuted copies — the cold build of a 100M-entry volume must
            # not transiently cost 3x the index size in RAM
            step = 2_000_000
            for lo in range(0, n, step):
                f.write(memoryview(
                    rec["o"][order[lo:lo + step]].astype(np.uint64)))
            for lo in range(0, n, step):
                f.write(memoryview(
                    rec["s"][order[lo:lo + step]].astype(np.int32)))
            f.flush()
            os.fsync(f.fileno())
        del rec, order, skeys
        durable.replace_atomic(tmp, sdx, sync_file=False)
        self._open_sdx(sdx)
        self.replayed = int(n)
        self.flushes += 1
        return True

    def _fold(self, key: int, offset: int, size: int) -> None:
        self.maximum_key = max(self.maximum_key, key)
        if offset > 0 and size != t.TOMBSTONE_FILE_SIZE:
            existing = self._lookup(key)
            # put-over-tombstone is not a deletion (see NeedleMap._load)
            if existing is not None and existing.size > 0:
                self.deleted_count += 1
                self.deleted_byte_count += existing.size
            self._map[key] = NeedleValue(key, offset, size)
            self.file_count += 1
            self.file_byte_count += max(size, 0)
        else:
            existing = self._lookup(key)
            if existing is not None and existing.size > 0:
                self._map[key] = NeedleValue(key, existing.offset,
                                             -existing.size)
                self.deleted_count += 1
                self.deleted_byte_count += max(existing.size, 0)

    def _lookup(self, key: int) -> Optional[NeedleValue]:
        nv = self._map.get(key)
        if nv is not None:
            return nv
        if self._count:
            i = int(self._np.searchsorted(self._keys,
                                          self._np.uint64(key)))
            if i < self._count and int(self._keys[i]) == key:
                return NeedleValue(key, int(self._offsets[i]),
                                   int(self._sizes[i]))
        return None

    def flush_imminent(self, incoming: int = 1) -> bool:
        """True when `incoming` more puts would trigger the delta->segment
        merge — event-loop callers (WriteBatcher's inline path) route such
        batches to the executor instead of paying an O(n) sort + rewrite
        on the loop."""
        return len(self._map) + incoming >= self.FLUSH_THRESHOLD

    def _flush(self) -> None:
        """Merge the delta into a new .sdx (one atomic rename)."""
        if self._index_path is None:
            return  # ephemeral map: nothing to persist
        if not self._map and (self._keys is not None
                              or not os.path.exists(self._sdx_path())):
            return  # nothing new since the last segment (or truly empty)
        np = self._np
        if self._map:
            dk = np.fromiter(self._map.keys(), dtype=np.uint64,
                             count=len(self._map))
            order = np.argsort(dk, kind="stable")
            dk = dk[order]
            vals = list(self._map.values())
            do = np.fromiter((vals[i].offset for i in order),
                             dtype=np.uint64, count=len(vals))
            ds = np.fromiter((vals[i].size for i in order),
                             dtype=np.int32, count=len(vals))
            if self._count:
                keep = ~np.isin(np.asarray(self._keys), dk)
                keys = np.concatenate([np.asarray(self._keys)[keep], dk])
                offs = np.concatenate([np.asarray(self._offsets)[keep], do])
                sizes = np.concatenate([np.asarray(self._sizes)[keep], ds])
                order = np.argsort(keys, kind="stable")
                keys, offs, sizes = keys[order], offs[order], sizes[order]
            else:
                keys, offs, sizes = dk, do, ds
        else:
            keys = np.empty(0, np.uint64)
            offs = np.empty(0, np.uint64)
            sizes = np.empty(0, np.int32)
        if self._index_file is not None:
            self._index_file.flush()
        # write the replacement fully before touching in-memory state: a
        # failed write leaves the old (still-mmapped) segment serving
        sdx = self._sdx_path()
        tmp = sdx + ".tmp"
        with open(tmp, "wb") as f:
            f.write(self._header_bytes(len(keys)))
            f.write(memoryview(keys))
            f.write(memoryview(offs))
            f.write(memoryview(sizes))
            f.flush()
            os.fsync(f.fileno())
        # replacing a live memmap's backing file is safe on linux: the old
        # inode stays until unmapped, and _open_sdx re-points us at the new
        durable.replace_atomic(tmp, sdx, sync_file=False)
        self._map.clear()
        self._open_sdx(sdx)
        self.flushes += 1

    # --- public surface ---
    def put(self, key: int, stored_offset: int, size: int) -> None:
        existing = self._lookup(key)
        if existing is not None and existing.size > 0:
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
        if len(self._map) >= self.FLUSH_THRESHOLD:
            self._flush()

    def delete(self, key: int, tombstone_offset: int = 0) -> bool:
        existing = self._lookup(key)
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
        if len(self._map) >= self.FLUSH_THRESHOLD:
            self._flush()
        return True

    def get(self, key: int) -> Optional[NeedleValue]:
        return self._lookup(key)

    def __len__(self) -> int:
        # every put/overwrite/delete bumps exactly one of the two
        # counters per liveness transition, so live = files - deletions
        return self.file_count - self.deleted_count

    def __contains__(self, key: int) -> bool:
        nv = self._lookup(key)
        return nv is not None and nv.size > 0

    def ascending_visit(self, fn: Callable[[NeedleValue], None]) -> None:
        if self._index_path is None:
            return super().ascending_visit(fn)
        self._flush()
        for i in range(self._count):
            if int(self._sizes[i]) > 0:
                fn(NeedleValue(int(self._keys[i]), int(self._offsets[i]),
                               int(self._sizes[i])))

    def live_entries(self) -> list[tuple[int, int]]:
        if self._index_path is None:
            return super().live_entries()
        self._flush()
        if not self._count:
            return []
        live = self._np.asarray(self._sizes) > 0
        keys = self._np.asarray(self._keys)[live]
        sizes = self._np.asarray(self._sizes)[live]
        return list(zip((int(k) for k in keys), (int(s) for s in sizes)))

    def values(self):
        if self._index_path is None:
            return super().values()
        self._flush()
        return [NeedleValue(int(self._keys[i]), int(self._offsets[i]),
                            int(self._sizes[i]))
                for i in range(self._count)]

    def close(self) -> None:
        self._flush()
        super().close()


def remove_sidecars(index_path: str) -> None:
    """Drop any derived index sidecars (.sdx) of an .idx that is being
    replaced wholesale (vacuum commit, volume copy, `weed fix`, crash
    recovery, a fresh .dat): the fingerprint check would reject them
    anyway, but removing them keeps a later crash window from ever
    re-presenting stale data."""
    base = (index_path[:-4] if index_path.endswith(".idx")
            else index_path)
    for suffix in (".sdx", ".sdx.tmp"):
        try:
            os.remove(base + suffix)
        except FileNotFoundError:
            pass


def create_needle_map(kind: str, index_path: Optional[str] = None,
                      offset_size: int = t.OFFSET_SIZE):
    """Needle map factory (NeedleMapType selection,
    weed/storage/needle_map.go:14-19; the three leveldb footprints map to
    delta-flush thresholds here)."""
    if kind in ("memory", ""):
        return NeedleMap(index_path, offset_size)
    if kind == "compact":
        return CompactNeedleMap(index_path, offset_size)
    if kind in ("leveldb", "leveldbMedium", "leveldbLarge", "disk"):
        m = DiskNeedleMap(index_path, offset_size)
        m.FLUSH_THRESHOLD = {"leveldb": 100_000,
                             "leveldbMedium": 400_000,
                             "leveldbLarge": 1_000_000}.get(kind, 100_000)
        return m
    raise KeyError(f"unknown needle map kind {kind!r}")


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
