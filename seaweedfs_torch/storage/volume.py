"""Append-only volume engine: one .dat file + .idx journal + in-memory map.

The port's reduced copy of seaweedfs_tpu/storage/volume.py (upstream
weed/storage/volume.go, volume_read_write.go): create or open a volume,
append needles, tombstone deletes, positioned reads, and the sync/close
durability barriers. Same bytes on disk as the reference for the same
needle sequence. Only the in-memory needle map (``needle_map_kind``
"memory") is ported. Not ported: compaction (the fused warm-down,
ec/fused.py, compacts into its own output), tiering to object stores,
replication tails, batched and group-committed writes, and the open-time
crash-recovery scan (a volume opened here is trusted as its .idx says).
"""

from __future__ import annotations

import os
import struct
import threading
import time
from typing import Optional

from ..utils import durable
from . import types as t
from .needle import FLAG_HAS_LAST_MODIFIED, FLAG_HAS_TTL, Needle
from .needle_map import NeedleMap, NeedleValue
from .superblock import SUPER_BLOCK_SIZE, SuperBlock


class NeedleNotFound(KeyError):
    pass


class NeedleExpired(NeedleNotFound):
    """TTL expiry, distinct from a lost write."""


class NeedleDeleted(KeyError):
    pass


class VolumeReadOnly(RuntimeError):
    pass


class Volume:
    def __init__(self, directory: str, collection: str, vid: int,
                 superblock: Optional[SuperBlock] = None,
                 create: bool = False, needle_map_kind: str = "memory"):
        if needle_map_kind != "memory":
            raise NotImplementedError(
                f"needle map kind {needle_map_kind!r}: only 'memory' is "
                "ported")
        self.dir = directory
        self.collection = collection
        self.vid = vid
        self.read_only = False
        self.last_append_at_ns = 0
        self.last_modified_ts = 0
        self._lock = threading.RLock()

        base = self.base_file_name()
        dat_path = base + ".dat"
        if create or not os.path.exists(dat_path):
            self.super_block = superblock or SuperBlock()
            self._dat = open(dat_path, "w+b")
            os.pwrite(self._dat.fileno(), self.super_block.to_bytes(), 0)
            # a fresh .dat invalidates any journal of an earlier volume
            for ext in (".idx", ".swm"):
                try:
                    os.remove(base + ext)
                except FileNotFoundError:
                    pass
        else:
            self._dat = open(dat_path, "r+b")
            head = os.pread(self._dat.fileno(), SUPER_BLOCK_SIZE, 0)
            self.super_block = SuperBlock.from_bytes(head)
            extra_size = t.get_u16(head, 6)
            if extra_size:
                self.super_block.extra = os.pread(
                    self._dat.fileno(), extra_size, SUPER_BLOCK_SIZE)
            self.last_modified_ts = int(os.path.getmtime(dat_path))
        self.nm = NeedleMap(base + ".idx", offset_size=self.offset_size)
        self._append_offset = os.fstat(self._dat.fileno()).st_size

    @property
    def offset_size(self) -> int:
        return self.super_block.offset_size

    @property
    def version(self) -> int:
        return self.super_block.version

    def base_file_name(self) -> str:
        prefix = f"{self.collection}_" if self.collection else ""
        return os.path.join(self.dir, f"{prefix}{self.vid}")

    def data_file_size(self) -> int:
        return self._append_offset

    def file_count(self) -> int:
        """Live needles (the net count the heartbeat reports)."""
        return len(self.nm)

    def needle_cookie(self, needle_id: int) -> Optional[int]:
        """The cookie of a live needle's record, None when the needle is
        absent or deleted."""
        with self._lock:
            nv = self.nm.get(needle_id)
            if nv is None or not t.size_is_valid(nv.size):
                return None
            head = self._read_header_at(t.stored_to_offset(nv.offset))
        return None if head is None else head.cookie

    # --- write path ---
    def write_needle(self, n: Needle,
                     preserve_append_at_ns: bool = False
                     ) -> tuple[int, int, bool]:
        """Append a needle; returns (byte_offset, size, is_unchanged).

        Upstream doWriteRequest (volume_read_write.go:145-186): dedupe on
        unchanged content, the cookie must match any existing entry, then
        append and update the map only if the new offset is larger.
        preserve_append_at_ns keeps the needle's own timestamp instead of
        stamping the local clock."""
        with self._lock:
            if self.read_only:
                raise VolumeReadOnly(f"volume {self.vid} is read-only")
            if self.super_block.ttl.minutes() and not n.ttl.minutes():
                n.set_flag(FLAG_HAS_TTL)
                n.ttl = self.super_block.ttl
            nv = self.nm.get(n.id)
            if nv is not None and self._is_unchanged(n, nv):
                return t.stored_to_offset(nv.offset), nv.size, True
            if nv is not None:
                existing = self._read_header_at(t.stored_to_offset(nv.offset))
                if existing is not None and existing.cookie != n.cookie:
                    raise ValueError(
                        f"needle {n.id:x}: cookie mismatch "
                        f"{existing.cookie:#x} != {n.cookie:#x}")
            if not (preserve_append_at_ns and n.append_at_ns):
                n.append_at_ns = time.time_ns()
            offset = self._append(n)
            self.last_append_at_ns = n.append_at_ns
            if nv is None or t.stored_to_offset(nv.offset) < offset:
                self.nm.put(n.id, t.offset_to_stored(offset,
                                                     self.offset_size),
                            n.size)
            if n.last_modified > self.last_modified_ts:
                self.last_modified_ts = n.last_modified
            return offset, n.size, False

    def delete_needle(self, n: Needle,
                      preserve_append_at_ns: bool = False) -> int:
        """Tombstone delete; returns the freed size (0 if absent). Appends
        an empty needle recording the delete, then journals a tombstone
        index entry (syncDelete, volume_read_write.go:188-216)."""
        with self._lock:
            if self.read_only:
                raise VolumeReadOnly(f"volume {self.vid} is read-only")
            nv = self.nm.get(n.id)
            if nv is None or not t.size_is_valid(nv.size):
                return 0
            tomb = Needle(cookie=n.cookie, id=n.id)
            tomb.append_at_ns = (n.append_at_ns
                                 if preserve_append_at_ns and n.append_at_ns
                                 else time.time_ns())
            offset = self._append(tomb)
            self.last_append_at_ns = tomb.append_at_ns
            self.nm.delete(n.id, t.offset_to_stored(offset,
                                                    self.offset_size))
            return nv.size

    def _append(self, n: Needle) -> int:
        offset = self._append_offset
        offset += (-offset) % t.NEEDLE_PADDING_SIZE
        record = n.to_bytes(self.version)
        # the record reaches the kernel before the .idx entry is appended,
        # so the index never references bytes that were not written
        os.pwrite(self._dat.fileno(), record, offset)
        self._append_offset = offset + len(record)
        return offset

    def _is_unchanged(self, n: Needle, nv: NeedleValue) -> bool:
        if not t.size_is_valid(nv.size):
            return False
        try:
            old = self.read_needle_at(t.stored_to_offset(nv.offset), nv.size)
        except (ValueError, IndexError, OSError, struct.error):
            return False
        return old.cookie == n.cookie and old.data == n.data

    # --- read path ---
    def read_needle(self, needle_id: int, cookie: Optional[int] = None,
                    now: Optional[float] = None) -> Needle:
        with self._lock:
            nv = self.nm.get(needle_id)
            if nv is None or nv.offset == 0:
                raise NeedleNotFound(f"needle {needle_id:x} not found")
            if t.size_is_deleted(nv.size):
                raise NeedleDeleted(f"needle {needle_id:x} deleted")
            n = self.read_needle_at(t.stored_to_offset(nv.offset), nv.size)
        if cookie is not None and n.cookie != cookie:
            raise NeedleNotFound(f"needle {needle_id:x} cookie mismatch")
        if n.ttl.minutes() and n.has(FLAG_HAS_LAST_MODIFIED):
            deadline = n.last_modified + n.ttl.minutes() * 60
            if (now if now is not None else time.time()) >= deadline:
                raise NeedleExpired(f"needle {needle_id:x} expired")
        return n

    def read_needle_at(self, byte_offset: int, size: int) -> Needle:
        length = t.get_actual_size(size, self.version)
        record = os.pread(self._dat.fileno(), length, byte_offset)
        return Needle.from_bytes(record, self.version)

    def _read_header_at(self, byte_offset: int) -> Optional[Needle]:
        head = os.pread(self._dat.fileno(), t.NEEDLE_HEADER_SIZE,
                        byte_offset)
        if len(head) < t.NEEDLE_HEADER_SIZE:
            return None
        return Needle.parse_header(head)

    # --- durability ---
    def sync(self) -> None:
        """Durability barrier: .dat pages first, then the .idx journal,
        then the `.swm` watermark that the reference's recovery trusts
        (the watermark must never claim bytes still in flight)."""
        with self._lock:
            self._sync_locked()

    def _sync_locked(self) -> None:
        os.fsync(self._dat.fileno())
        self.nm.sync()
        base = self.base_file_name()
        durable.write_json_atomic(
            base + ".swm", {"synced_size": self._append_offset,
                            "idx_synced_size": os.path.getsize(
                                base + ".idx")})

    def close(self) -> None:
        with self._lock:
            if self._dat.closed:
                return
            if not self.read_only:
                self._sync_locked()
            self.nm.close()
            self._dat.close()
