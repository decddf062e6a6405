"""Append-only volume engine: one .dat file + .idx journal + in-memory map.

The port's reduced copy of seaweedfs_tpu/storage/volume.py (upstream
weed/storage/volume.go, volume_read_write.go, volume_vacuum.go,
volume_checking.go): create or open a volume, append needles, tombstone
deletes, positioned reads through a ``DiskFile`` (storage/backend.py),
the sync/close durability barriers with the ``.swm`` sync watermark, the
open-time crash recovery of a torn ``.dat``/``.idx`` pair, the integrity
check, two-phase compaction (``begin_compact`` copies the live needles
without blocking writers, ``commit_compact`` replays what landed
meanwhile and swaps the files), batched writes
(``write_needles_batch``), group commit (one gathered ``pwritev`` and one
fsync for a batch, then its index entries) and the event loop's
non-blocking writes and reads (``write_needles_batch_nowait``,
``read_needle_nowait``). Same bytes on disk as the reference for the
same needle sequence.

The needle map is any kind of storage/needle_map.py
(``needle_map_kind``: "memory", "compact", "leveldb", "leveldbMedium",
"leveldbLarge"), at every open, a compaction's commit included; the
nowait write declines a batch that would trigger a disk map's segment
merge (``flush_imminent``). A new volume may reserve its space
(``preallocate`` bytes). A volume whose .dat was moved to an object store
(``Store.tier_upload``) opens from its ``.vif`` with a ``RemoteFile``
backend: read-only, read through the store, with no file descriptor
(``is_remote``). A TTL volume expires as a whole (``is_expired``,
``is_expired_long_enough``). The compaction's copy may be held to a byte
rate (``begin_compact(compaction_bytes_per_second)``), sleeping outside
the lock. ``watchdog_sealed`` marks a seal the free-space watchdog set
(``watchdog_seal``); only such a seal is lifted when space comes back
(``lift_watchdog_seal``), and every other seal or unseal clears it.
Not ported: ``needle_sendfile_extent``.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import threading
import time
from typing import Optional

from ..utils import durable
from . import backend as backend_mod
from . import idx as idx_mod
from . import types as t
from .backend import DiskFile
from .needle import FLAG_HAS_LAST_MODIFIED, FLAG_HAS_TTL, Needle
from .needle_map import (NeedleValue, _truncate_torn_tail,
                         create_needle_map, remove_sidecars)
from .superblock import SUPER_BLOCK_SIZE, SuperBlock

log = logging.getLogger("volume")


def _remove_quiet(path: str) -> None:
    try:
        os.remove(path)
    except FileNotFoundError:
        pass


class NeedleNotFound(KeyError):
    pass


class NeedleExpired(NeedleNotFound):
    """TTL expiry, distinct from a lost write."""


class NeedleDeleted(KeyError):
    pass


class VolumeReadOnly(RuntimeError):
    pass


class VolumeCompacting(RuntimeError):
    """A seal refused: the volume has an open compaction."""


class Volume:
    def __init__(self, directory: str, collection: str, vid: int,
                 superblock: Optional[SuperBlock] = None,
                 create: bool = False, needle_map_kind: str = "memory",
                 preallocate: int = 0):
        self.dir = directory
        self.collection = collection
        self.vid = vid
        self.needle_map_kind = needle_map_kind
        self.read_only = False
        self.watchdog_sealed = False  # set only by the free-space watchdog
        self.last_append_at_ns = 0
        self.last_modified_ts = 0
        self._lock = threading.RLock()
        # the local .dat a tier upload replaced, kept open until close so
        # that a read which took it before the swap never meets a closed
        # descriptor
        self._retired_dat = None
        self._compacting = False
        self._compact_sb: Optional[SuperBlock] = None
        self._compact_idx_entries = 0

        base = self.base_file_name()
        dat_path = base + ".dat"
        has_local = os.path.exists(dat_path)
        has_vif = backend_mod.load_volume_info(base) is not None
        if create or (not has_local and not has_vif):
            self.super_block = superblock or SuperBlock()
            self._dat = DiskFile(dat_path, create=True,
                                 preallocate=preallocate)
            self._dat.write_at(self.super_block.to_bytes(), 0)
            self._dat.flush()
            # a fresh .dat invalidates any journal of an earlier volume
            _remove_quiet(base + ".idx")
            remove_sidecars(base + ".idx")
            _remove_quiet(base + ".swm")
            self.nm = self._open_map(base)
        elif not has_local:
            # a tiered volume: the .dat lives in an object store and the
            # .idx stays local (volume_tier.go:15-50); reads go through
            # the store, writes are refused
            self._dat = backend_mod.open_remote_dat(base)
            self.read_only = True
            self.super_block = self._read_superblock()
            self.nm = self._open_map(base)
        else:
            self._dat = DiskFile(dat_path)
            self.super_block = self._read_superblock()
            # crash recovery BEFORE the map loads: reconcile a torn .dat
            # tail and a torn or stale .idx, so that the map is built
            # from a consistent pair
            self._crash_recover(base)
            self.nm = self._open_map(base)
            # the .dat mtime bounds the last write even when the index
            # tail is a tombstone and carries no timestamp
            self.last_modified_ts = int(os.path.getmtime(dat_path))
            self.check_integrity()
        self._append_offset = self._dat.size()

    def _open_map(self, base: str):
        return create_needle_map(self.needle_map_kind, base + ".idx",
                                 offset_size=self.offset_size)

    @property
    def offset_size(self) -> int:
        return self.super_block.offset_size

    @property
    def is_remote(self) -> bool:
        """Whether the .dat lives in an object store (tiered)."""
        return not self._dat.writable

    @property
    def version(self) -> int:
        return self.super_block.version

    def _read_superblock(self) -> SuperBlock:
        head = self._dat.read_at(SUPER_BLOCK_SIZE, 0)
        sb = SuperBlock.from_bytes(head)
        extra_size = t.get_u16(head, 6)
        if extra_size:
            sb.extra = self._dat.read_at(extra_size, SUPER_BLOCK_SIZE)
        return sb

    def base_file_name(self) -> str:
        prefix = f"{self.collection}_" if self.collection else ""
        return os.path.join(self.dir, f"{prefix}{self.vid}")

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
            unchanged, nv = self._admit(n)
            if unchanged is not None:
                return unchanged
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

    def _admit(self, n: Needle) -> tuple:
        """The checks a write passes before its append, under the lock:
        the read-only gate, the volume's TTL on a needle without one,
        unchanged content (its result), and the cookie of an existing
        entry. Returns (the unchanged result or None, the prior map
        entry or None)."""
        if self.read_only:
            raise VolumeReadOnly(f"volume {self.vid} is read-only")
        if self.super_block.ttl.minutes() and not n.ttl.minutes():
            n.set_flag(FLAG_HAS_TTL)
            n.ttl = self.super_block.ttl
        nv = self.nm.get(n.id)
        if nv is not None and self._is_unchanged(n, nv):
            return (t.stored_to_offset(nv.offset), nv.size, True), nv
        if nv is not None:
            existing = self._read_header_at(t.stored_to_offset(nv.offset))
            if existing is not None and existing.cookie != n.cookie:
                raise ValueError(
                    f"needle {n.id:x}: cookie mismatch "
                    f"{existing.cookie:#x} != {n.cookie:#x}")
        return None, nv

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
        # an unbuffered pwrite: the record reaches the kernel before the
        # .idx entry is appended, so the index never references bytes
        # that were not written
        self._dat.write_at(record, offset)
        self._append_offset = offset + len(record)
        return offset

    def write_needles_batch(self, needles: list[Needle],
                            group_commit: bool = False) -> list:
        """Append many needles under one lock acquisition (upstream's
        write batching, volume_read_write.go:297-327); each needle's
        result is (offset, size, unchanged) or its exception, in place.
        ``group_commit=True`` is ``_write_needles_group``: a successful
        result then means the needle's bytes are durable."""
        if group_commit:
            return self._write_needles_group(needles)
        out: list = []
        with self._lock:
            for n in needles:
                try:
                    out.append(self.write_needle(n))
                except Exception as e:
                    out.append(e)
        return out

    def _write_needles_group(self, needles: list[Needle]) -> list:
        """Group commit: stage every record, one pwritev, one fsync, then
        the index entries. The .dat bytes are durable before any index
        entry names them; a crash after the barrier but before (or
        during) the index appends is repaired at open, where the crash
        recovery re-derives the entries from the .dat past the sync
        watermark. Padding between records is written as zero bytes so
        the gathered buffers stay contiguous. A failed write or fsync
        fails the whole group: none of it may be acknowledged or
        indexed."""
        out: list = [None] * len(needles)
        with self._lock:
            staged: list = []      # (result slot, needle, offset, old nv)
            bufs: list = []
            base = self._append_offset
            cur = base
            for i, n in enumerate(needles):
                try:
                    unchanged, nv = self._admit(n)
                    if unchanged is not None:
                        out[i] = unchanged
                        continue
                    n.append_at_ns = time.time_ns()
                    pad = (-cur) % t.NEEDLE_PADDING_SIZE
                    if pad:
                        bufs.append(b"\x00" * pad)
                        cur += pad
                    record = n.to_bytes(self.version)
                    staged.append((i, n, cur, nv))
                    bufs.append(record)
                    cur += len(record)
                except Exception as e:
                    out[i] = e
            if not staged:
                return out
            try:
                self._dat.writev_at(bufs, base)
                self._append_offset = cur
                self._dat.sync()           # the group barrier
            except Exception as e:
                for i, _n, _off, _nv in staged:
                    out[i] = e
                return out
            for i, n, offset, nv in staged:
                self.last_append_at_ns = n.append_at_ns
                if nv is None or t.stored_to_offset(nv.offset) < offset:
                    self.nm.put(n.id, t.offset_to_stored(
                        offset, self.offset_size), n.size)
                if n.last_modified > self.last_modified_ts:
                    self.last_modified_ts = n.last_modified
                out[i] = (offset, n.size, False)
        return out

    def write_needles_batch_nowait(self, needles: list[Needle]
                                   ) -> Optional[list]:
        """write_needles_batch for event-loop callers, or None ("use the
        executor") unless the file is on local disk, the lock is free
        (a compaction holds it for seconds), the batch does not bring a
        disk map to its segment merge, and no needle overwrites an entry
        over 64 KiB (whose unchanged-content check would re-read it from
        disk)."""
        if not self._lock.acquire(blocking=False):
            return None
        try:
            if not self._dat.is_local:
                return None
            if self.nm.flush_imminent(len(needles)):
                # a disk map merges its delta into a new segment at the
                # threshold: an O(n) sort and rewrite that must not run
                # on the event loop
                return None
            for n in needles:
                nv = self.nm.get(n.id)
                if (nv is not None and t.size_is_valid(nv.size)
                        and nv.size > 64 * 1024):
                    return None
            return self.write_needles_batch(needles)
        finally:
            self._lock.release()

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
            nv = self._lookup(needle_id)
            n = self.read_needle_at(t.stored_to_offset(nv.offset), nv.size)
        return self._check_read(n, needle_id, cookie, now)

    def _lookup(self, needle_id: int) -> NeedleValue:
        """A live needle's map entry, under the lock; raises not-found
        and deleted."""
        nv = self.nm.get(needle_id)
        if nv is None or nv.offset == 0:
            raise NeedleNotFound(f"needle {needle_id:x} not found")
        if t.size_is_deleted(nv.size):
            raise NeedleDeleted(f"needle {needle_id:x} deleted")
        return nv

    def _check_read(self, n: Needle, needle_id: int,
                    cookie: Optional[int], now: Optional[float]) -> Needle:
        if cookie is not None and n.cookie != cookie:
            raise NeedleNotFound(f"needle {needle_id:x} cookie mismatch")
        if n.ttl.minutes() and n.has(FLAG_HAS_LAST_MODIFIED):
            deadline = n.last_modified + n.ttl.minutes() * 60
            if (now if now is not None else time.time()) >= deadline:
                raise NeedleExpired(f"needle {needle_id:x} expired")
        return n

    def read_needle_nowait(self, needle_id: int,
                           cookie: Optional[int] = None,
                           max_size: int = 64 * 1024) -> Optional[Needle]:
        """read_needle for event-loop callers, or None ("use the
        executor") unless the file is on local disk, the lock is free
        and the stored needle is at most `max_size` bytes, so a
        page-cache pread cannot stall the loop. Raises read_needle's
        not-found, deleted and expired errors."""
        if not self._lock.acquire(blocking=False):
            return None
        try:
            # under the lock: a tier upload swaps the backend under it
            if not self._dat.is_local:
                return None
            nv = self._lookup(needle_id)
            if nv.size > max_size:
                return None
            n = self.read_needle_at(t.stored_to_offset(nv.offset), nv.size)
        finally:
            self._lock.release()
        return self._check_read(n, needle_id, cookie, None)

    def read_needle_at(self, byte_offset: int, size: int) -> Needle:
        length = t.get_actual_size(size, self.version)
        record = self._dat.read_at(length, byte_offset)
        return Needle.from_bytes(record, self.version)

    def _read_header_at(self, byte_offset: int) -> Optional[Needle]:
        head = self._dat.read_at(t.NEEDLE_HEADER_SIZE, byte_offset)
        if len(head) < t.NEEDLE_HEADER_SIZE:
            return None
        return Needle.parse_header(head)

    # --- stats ---
    def content_size(self) -> int:
        return self.nm.content_size()

    def deleted_size(self) -> int:
        return self.nm.deleted_byte_count

    def file_count(self) -> int:
        """Live needles (the net count the heartbeat reports)."""
        return len(self.nm)

    def data_file_size(self) -> int:
        return self._append_offset

    def garbage_level(self) -> float:
        """Fraction of the .dat file occupied by deleted needles
        (volume_vacuum.go:20-26)."""
        if self._append_offset == 0:
            return 0.0
        return self.nm.deleted_byte_count / self._append_offset

    def configure_replication(self, rp) -> None:
        """Rewrite the superblock's replica-placement byte in place
        (VolumeConfigure; superblock byte 1, super_block.go:12-31),
        durably: the byte is fsynced before the call returns."""
        with self._lock:
            self.super_block.replica_placement = rp
            self._dat.write_at(bytes([rp.to_byte()]), 1)
            self._dat.sync()

    # --- crash recovery (power-loss consistency) ---
    def _load_sync_watermark(self, base: str) -> Optional[dict]:
        """The durable checkpoint `.swm` written by sync(): every .dat
        byte below synced_size and every .idx byte below idx_synced_size
        was fsynced BEFORE the checkpoint committed, so recovery only
        scans and validates past them. None: no checkpoint (a first
        boot, or a volume written before watermarks)."""
        try:
            with open(base + ".swm") as f:
                d = json.load(f)
            v = d.get("synced_size")
            if not isinstance(v, int) or v < 0:
                return None
            iv = d.get("idx_synced_size")
            return {"synced_size": v,
                    "idx_synced_size": iv if isinstance(iv, int)
                    and iv >= 0 else 0}
        except (OSError, ValueError):
            return None

    def _save_sync_watermark(self, base: str, synced_size: int,
                             idx_synced_size: int) -> None:
        durable.write_json_atomic(
            base + ".swm", {"synced_size": synced_size,
                            "idx_synced_size": idx_synced_size})

    def _scan_valid_records(self, start: int, end: int) -> tuple[int, list]:
        """Walk .dat records in [start, end); returns (cut_offset,
        records), where cut_offset is `end` when every record parses and
        CRC-checks, else the offset of the first torn or invalid record.
        records are (needle, byte_offset) for the valid prefix."""
        offset = start
        records = []
        while offset + t.NEEDLE_HEADER_SIZE <= end:
            try:
                head = self._read_header_at(offset)
                if head is None:
                    return offset, records
                # a dropped un-synced page reads back as zeros: an
                # all-zero "record" is a hole, not a needle (real ids
                # are never 0)
                if head.id == 0 and head.cookie == 0 and head.size == 0:
                    return offset, records
                size = head.size if head.size > 0 else 0
                length = t.get_actual_size(size, self.version)
                if offset + length > end:
                    return offset, records
                record = self._dat.read_at(length, offset)
                if len(record) < length:
                    return offset, records
                n = Needle.from_bytes(record, self.version)
                records.append((n, offset))
                offset += length
            except Exception:
                # any record that does not parse or fails its CRC is
                # where the torn tail starts
                return offset, records
        # the loop leaves `offset` at the clean end, or at a torn partial
        # header (under 16 bytes of tail), which the caller truncates
        return offset, records

    def _crash_recover(self, base: str) -> None:
        """Reconcile .dat <-> .idx after a potential power loss:

        1. align-truncate a torn .idx tail;
        2. CRC-scan the un-synced .dat suffix (from the `.swm` durable
           watermark, or from the last .idx-referenced record when there
           is none) and truncate the first torn record and everything
           after it;
        3. drop .idx entries referencing truncated bytes (durable
           rewrite);
        4. re-derive .idx entries for valid .dat records the journal
           never recorded (the .dat is written first, so the journal can
           trail it).

        Acked data is never touched: sync() fsyncs the .dat BEFORE the
        watermark commits, so everything below the watermark is durable
        and the torn region can only hold un-acked appends."""
        idx_path = base + ".idx"
        # an interrupted compaction commit: a surviving .cpd means the
        # swap never reached its point of no return, so roll back (the
        # old pair is intact); a lone .cpx means the .dat swap landed
        # but the .idx swap did not, so roll forward
        if os.path.exists(base + ".cpd"):
            log.warning("volume %d: discarding interrupted compaction "
                        "(crash recovery)", self.vid)
            _remove_quiet(base + ".cpx")
            _remove_quiet(base + ".cpd")
        elif os.path.exists(base + ".cpx"):
            log.warning("volume %d: completing interrupted compaction "
                        "commit (crash recovery)", self.vid)
            remove_sidecars(idx_path)
            durable.replace_atomic(base + ".cpx", idx_path,
                                   sync_file=False)
        if not os.path.exists(idx_path):
            open(idx_path, "wb").close()
        _truncate_torn_tail(idx_path, self.offset_size)
        dat_size = self._dat.size()
        entry_w = t.needle_map_entry_size(self.offset_size)
        idx_size = os.path.getsize(idx_path)

        wm = self._load_sync_watermark(base)
        if wm is not None:
            scan_start = min(wm["synced_size"], dat_size)
            idx_wm = min(wm["idx_synced_size"], idx_size)
        else:
            # no watermark: anchor the scan at the last journal-referenced
            # record, in one streaming pass
            last_ref = self.super_block.block_size()
            for _key, stored_offset, _size in idx_mod.iter_index_file(
                    idx_path, offset_size=self.offset_size):
                if stored_offset > 0:
                    last_ref = max(last_ref,
                                   t.stored_to_offset(stored_offset))
            scan_start = min(last_ref, dat_size)
            idx_wm = 0
        idx_wm -= idx_wm % entry_w
        scan_start = max(scan_start, self.super_block.block_size())
        cut, records = self._scan_valid_records(scan_start, dat_size)
        rec_map = {off: n for n, off in records}

        if cut < dat_size:
            log.warning(
                "volume %d: torn .dat tail, truncating %d -> %d (crash "
                "recovery; %d valid records after watermark %s)",
                self.vid, dat_size, cut, len(records), wm)
            self._dat.truncate(cut)
            self._dat.sync()

        # entries below the idx watermark were fsynced and (by sync()'s
        # order) reference only synced .dat bytes: trusted. Entries past
        # it must check out against the scanned records or, on a
        # watermarked volume, against the on-disk header of a synced-
        # region reference
        def entry_ok(key: int, stored_offset: int, size: int) -> bool:
            if stored_offset == 0:
                # an offset-less tombstone references no .dat bytes
                return size == t.TOMBSTONE_FILE_SIZE
            off = t.stored_to_offset(stored_offset)
            if off >= cut:
                return False
            if off >= scan_start:
                n = rec_map.get(off)
                return (n is not None and n.id == key and
                        (n.size == size or
                         (size == t.TOMBSTONE_FILE_SIZE
                          and len(n.data) == 0)))
            if wm is None:
                # without a watermark references below the anchor were
                # always trusted
                return True
            head = self._read_header_at(off)
            return head is not None and head.id == key

        tail_offsets: set[int] = set()
        dropped = 0
        for key, stored_offset, size in idx_mod.iter_index_file(
                idx_path, start=idx_wm, offset_size=self.offset_size):
            if entry_ok(key, stored_offset, size):
                if stored_offset > 0:
                    off = t.stored_to_offset(stored_offset)
                    if off >= scan_start:
                        tail_offsets.add(off)
            else:
                dropped += 1
        if dropped:
            log.warning("volume %d: dropping %d un-synced .idx entries "
                        "that reference torn or absent data (crash "
                        "recovery)", self.vid, dropped)
            remove_sidecars(idx_path)
            tmp = idx_path + ".tmp"
            with open(tmp, "wb") as out, open(idx_path, "rb") as src:
                remaining = idx_wm
                while remaining > 0:
                    chunk = src.read(min(1 << 20, remaining))
                    if not chunk:
                        break
                    out.write(chunk)
                    remaining -= len(chunk)
                for key, stored_offset, size in idx_mod.iter_index_file(
                        idx_path, start=idx_wm,
                        offset_size=self.offset_size):
                    if entry_ok(key, stored_offset, size):
                        out.write(idx_mod.pack_entry(
                            key, stored_offset, size,
                            offset_size=self.offset_size))
                out.flush()
                os.fsync(out.fileno())
            durable.replace_atomic(tmp, idx_path, sync_file=False)

        # re-derive entries the crash dropped: valid records past the
        # journal's coverage. Zero-length records are skipped: a
        # tombstone and an empty-body overwrite look the same on disk,
        # both are un-acked here, and applying the wrong one could
        # tombstone an acked value, while not applying an un-acked
        # mutation is always a legal post-crash state
        missing = [(n, off) for n, off in records
                   if off not in tail_offsets and off < cut
                   and len(n.data) > 0]
        if missing:
            log.warning("volume %d: re-deriving %d .idx entries from the "
                        ".dat tail (crash recovery)", self.vid,
                        len(missing))
            with open(idx_path, "ab") as f:
                for n, off in missing:
                    f.write(idx_mod.pack_entry(
                        n.id, t.offset_to_stored(off, self.offset_size),
                        n.size, offset_size=self.offset_size))

    def check_integrity(self) -> None:
        """Verify that the last .idx entry points at a valid needle and
        take the volume's last append time from it
        (CheckVolumeDataIntegrity, volume_checking.go:14). A tombstone
        entry that names its record (a delete's empty needle) gives its
        append time too, as upstream's verifyDeletedNeedleIntegrity does:
        the reference skips it and leaves the time at 0, so a backup whose
        last record is a delete pulls the whole volume again at its next
        run (ROADMAP Queue 3, D10)."""
        idx_path = self.base_file_name() + ".idx"
        idx_size = os.path.getsize(idx_path)
        if idx_size == 0:
            return
        entry = t.needle_map_entry_size(self.offset_size)
        if idx_size % entry != 0:
            raise IOError(f"index {idx_path} size {idx_size} not aligned")
        with open(idx_path, "rb") as f:
            f.seek(idx_size - entry)
            key, stored_offset, size = idx_mod.unpack_entry(
                f.read(entry), offset_size=self.offset_size)
        if stored_offset == 0:
            return
        if size == t.TOMBSTONE_FILE_SIZE:
            # a decoded EC volume's .idx keeps a deleted needle's own
            # offset, where no delete record lies: only a record that is
            # this key's empty needle gives the time, and nothing else
            # fails the open
            try:
                n = self.read_needle_at(t.stored_to_offset(stored_offset), 0)
            except (ValueError, IndexError, OSError, struct.error):
                return
            if n.id == key and not n.data and self.version == t.VERSION3:
                self.last_append_at_ns = n.append_at_ns
            return
        n = self.read_needle_at(t.stored_to_offset(stored_offset),
                                max(size, 0))
        if n.id != key:
            raise IOError(f"volume {self.vid}: index tail key {key:x} != "
                          f"needle {n.id:x}")
        if self.version == t.VERSION3:
            self.last_append_at_ns = n.append_at_ns

    def scan(self, visit) -> None:
        """Walk every needle record in the .dat file in offset order:
        visit(needle, byte_offset), tombstones (empty bodies) included,
        under the engine lock for a consistent snapshot."""
        with self._lock:
            offset = self.super_block.block_size()
            end = self.data_file_size()
            while offset + t.NEEDLE_HEADER_SIZE <= end:
                head = self._read_header_at(offset)
                if head is None:
                    return
                size = head.size if head.size > 0 else 0
                visit(self.read_needle_at(offset, size), offset)
                offset += t.get_actual_size(size, self.version)

    # --- compaction (volume_vacuum.go) ---
    def compact(self) -> None:
        """A whole vacuum cycle: the snapshot copy, then the commit with
        the replay of concurrent writes (Compact2 + CommitCompact,
        volume_vacuum.go:37-120)."""
        self.begin_compact()
        self.commit_compact()

    def begin_compact(self, compaction_bytes_per_second: int = 0) -> None:
        """Phase 1 (Compact2, volume_vacuum.go:66-89): copy the live
        needles of a map snapshot to .cpd/.cpx WITHOUT blocking writers.
        Appends that land meanwhile go to the old .dat and are folded in
        by commit_compact's makeup-diff replay; the copy preads records
        below the snapshot's offsets, which appends never touch. A
        positive `compaction_bytes_per_second` holds the copy to that
        rate (upstream's WriteThrottler, weed/util/throttler.go): it
        sleeps between records, never under the lock, so reads and
        writes go on meanwhile."""
        base = self.base_file_name()
        with self._lock:
            if self.is_remote:
                raise VolumeReadOnly(
                    f"volume {self.vid} is tiered remote; download first")
            if self._compacting:
                raise RuntimeError(f"volume {self.vid} already compacting")
            if self.read_only:
                # a sealed volume's files are being read as they stand
                # (an EC encode): the commit must never swap them
                raise VolumeReadOnly(f"volume {self.vid} is read-only")
            self._compacting = True
            # journal high-water mark: entries after it were written
            # during the copy and are replayed at commit
            self._compact_idx_entries = (
                os.path.getsize(base + ".idx")
                // t.needle_map_entry_size(self.offset_size))
            snapshot = [nv for nv in self.nm.values()
                        if t.size_is_valid(nv.size)]
            new_sb = SuperBlock(
                version=self.super_block.version,
                replica_placement=self.super_block.replica_placement,
                ttl=self.super_block.ttl,
                compaction_revision=self.super_block.compaction_revision + 1,
                extra=self.super_block.extra,
                offset_size=self.super_block.offset_size,
            )
        snapshot.sort(key=lambda nv: nv.offset)
        throttle_t0 = time.monotonic()
        copied = 0
        try:
            with open(base + ".cpd", "w+b") as cpd, \
                    open(base + ".cpx", "wb") as cpx:
                head = new_sb.to_bytes()
                cpd.write(head)
                offset = len(head)
                for nv in snapshot:
                    n = self.read_needle_at(t.stored_to_offset(nv.offset),
                                            nv.size)
                    record = n.to_bytes(self.version)
                    cpd.write(record)
                    cpx.write(idx_mod.pack_entry(
                        nv.key, t.offset_to_stored(offset,
                                                   self.offset_size),
                        nv.size, offset_size=self.offset_size))
                    offset += len(record)
                    copied += len(record)
                    if compaction_bytes_per_second > 0:
                        ahead = (copied / compaction_bytes_per_second
                                 - (time.monotonic() - throttle_t0))
                        if ahead > 0:
                            time.sleep(ahead)
            self._compact_sb = new_sb
        except BaseException:
            self.cleanup_compact()
            raise

    def commit_compact(self) -> None:
        """Phase 2 (CommitCompact + makeupDiff, volume_vacuum.go:91-240):
        under the engine lock, replay every .idx entry appended since
        begin_compact onto the compacted files, make them durable, then
        swap .cpd/.cpx into place and reload. Readers take the same lock
        for each pread, so none reads the old descriptor after the swap
        closes it. A volume made read-only since begin_compact is
        refused, its compaction left open for cleanup_compact."""
        base = self.base_file_name()
        with self._lock:
            if not self._compacting:
                raise RuntimeError(
                    f"volume {self.vid} has no open compaction")
            if self.read_only:
                raise VolumeReadOnly(f"volume {self.vid} became read-only "
                                     "during its compaction")
            new_sb = self._compact_sb
            idx_size = os.path.getsize(base + ".idx")
            start = (self._compact_idx_entries
                     * t.needle_map_entry_size(self.offset_size))
            with open(base + ".cpd", "r+b") as cpd, \
                    open(base + ".cpx", "ab") as cpx:
                cpd.seek(0, os.SEEK_END)
                offset = cpd.tell()
                if start < idx_size:
                    with open(base + ".idx", "rb") as f:
                        f.seek(start)
                        delta = f.read(idx_size - start)
                    for key, stored_offset, size in \
                            idx_mod.iter_index_bytes(
                                delta, offset_size=self.offset_size):
                        if stored_offset > 0 and \
                                size != t.TOMBSTONE_FILE_SIZE:
                            n = self.read_needle_at(
                                t.stored_to_offset(stored_offset),
                                max(size, 0))
                            record = n.to_bytes(self.version)
                            cpd.write(record)
                            cpx.write(idx_mod.pack_entry(
                                key, t.offset_to_stored(offset,
                                                        self.offset_size),
                                size, offset_size=self.offset_size))
                            offset += len(record)
                        else:
                            # the .cpx journal folds tombstones on load
                            cpx.write(idx_mod.pack_entry(
                                key, 0, t.TOMBSTONE_FILE_SIZE,
                                offset_size=self.offset_size))
                # the swap replaces the only copy of every live needle:
                # both files are on the platter before a rename makes
                # them load-bearing
                cpd.flush()
                os.fsync(cpd.fileno())
                cpx.flush()
                os.fsync(cpx.fileno())
            self._dat.close()
            self.nm.close()
            # the old watermark describes the old layout; it must not
            # vouch for the new file's offsets in a crash window
            _remove_quiet(base + ".swm")
            durable.replace_atomic(base + ".cpd", base + ".dat",
                                   sync_file=False)
            remove_sidecars(base + ".idx")
            durable.replace_atomic(base + ".cpx", base + ".idx",
                                   sync_file=False)
            self._dat = DiskFile(base + ".dat")
            self.super_block = new_sb
            self.nm = self._open_map(base)
            self._append_offset = self._dat.size()
            # everything in the compacted pair is already fsynced: a
            # fresh watermark lets the next open scan nothing
            self._save_sync_watermark(base, self._append_offset,
                                      os.path.getsize(base + ".idx"))
            self._compacting = False

    def cleanup_compact(self) -> None:
        """Abort: remove the leftovers (VacuumVolumeCleanup,
        volume_vacuum.go:155-165)."""
        base = self.base_file_name()
        with self._lock:
            self._compacting = False
            _remove_quiet(base + ".cpd")
            _remove_quiet(base + ".cpx")

    def set_read_only(self, read_only: bool) -> None:
        """Flip the write gate under the lock: a write in flight lands
        first, so a reader of the files after this returns sees every
        write the volume accepted. A seal or unseal that is not the
        watchdog's supersedes the watchdog's: space coming back must
        never lift it."""
        with self._lock:
            self.read_only = read_only
            self.watchdog_sealed = False

    def seal(self) -> None:
        """Make the volume read-only and durable for a reader of its
        files as they stand (an EC encode, a tier upload, a move). Refused
        while a compaction is open: its commit would swap the .dat and
        .idx under the reader. Like set_read_only it supersedes a
        watchdog seal, so the files' reader keeps the volume sealed when
        space comes back."""
        with self._lock:
            if self._compacting:
                raise VolumeCompacting(f"volume {self.vid} is compacting")
            self.read_only = True
            self.watchdog_sealed = False
            self._sync_locked()

    def watchdog_seal(self) -> bool:
        """The free-space watchdog's seal (disk_location.go:304): a
        writable volume turns read-only and remembers who sealed it.
        Returns whether it sealed."""
        with self._lock:
            if self.read_only:
                return False
            self.read_only = True
            self.watchdog_sealed = True
            return True

    def lift_watchdog_seal(self) -> bool:
        """Space is back: lift the seal only if the watchdog set it and
        nothing sealed the volume since. Returns whether it lifted."""
        with self._lock:
            lift = self.watchdog_sealed and not self.is_remote
            if lift:
                self.read_only = False
            self.watchdog_sealed = False
            return lift

    # --- TTL expiry of the whole volume (volume.go expired()) ---
    def _freshness_ts(self) -> float:
        return self.last_modified_ts or (self.last_append_at_ns / 1e9)

    def is_expired(self, now: Optional[float] = None) -> bool:
        """A TTL volume whose last write is older than its TTL is garbage
        as a whole. A volume of unknown age never expires: deleting live
        data on a guess is worse than keeping an empty volume."""
        minutes = self.super_block.ttl.minutes()
        ref_ts = self._freshness_ts()
        if not minutes or ref_ts == 0:
            return False
        return (now if now is not None else time.time()) >= \
            ref_ts + minutes * 60

    def is_expired_long_enough(self, max_delay_minutes: int,
                               now: Optional[float] = None) -> bool:
        """The grace before an expired TTL volume is removed
        (volume.go expiredLongEnough): a tenth of the TTL, at least a
        minute and at most `max_delay_minutes`."""
        minutes = self.super_block.ttl.minutes()
        ref_ts = self._freshness_ts()
        if not minutes or ref_ts == 0:
            return False
        removal_delay = min(max(minutes // 10, 1), max_delay_minutes)
        return (now if now is not None else time.time()) >= \
            ref_ts + (minutes + removal_delay) * 60

    # --- durability ---
    def sync(self) -> None:
        """Durability barrier: .dat pages first, then the .idx journal,
        then the `.swm` watermark that recovery trusts (the watermark
        must never claim bytes still in flight)."""
        with self._lock:
            self._sync_locked()

    def _sync_locked(self) -> None:
        self._dat.sync()
        self.nm.sync()
        if self._dat.writable:
            # a tiered .dat has no local bytes for a watermark to vouch for
            base = self.base_file_name()
            self._save_sync_watermark(base, self._append_offset,
                                      os.path.getsize(base + ".idx"))

    def close(self) -> None:
        with self._lock:
            if self._dat.closed:
                return
            # a clean shutdown is a barrier too: the watermark lets the
            # next open skip the recovery scan
            if not self.read_only:
                self._sync_locked()
            self.nm.close()
            if self._retired_dat is not None:
                self._retired_dat.close()
                self._retired_dat = None
            self._dat.close()
