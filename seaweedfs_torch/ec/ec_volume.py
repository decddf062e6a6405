"""EC volume serving: read needles straight out of local shard files.

The port's reduced copy of seaweedfs_tpu/ec/ec_volume.py (upstream
weed/storage/erasure_coding/ec_volume.go, ec_shard.go,
ec_volume_delete.go):

- .ecx is binary-searched on disk per lookup (entries sorted by needle id);
- a needle decomposes into intervals (locate.py); each interval is read
  from its shard file when that shard is present, else reconstructed on
  line from k other shards through the coder;
- an interval on a shard that is not local is fetched through the
  caller's ``shard_reader`` (the volume server's peer read over HTTP);
  failing that, it is reconstructed from any k other shards, local ones
  read inline and remote survivors fetched in parallel;
- deletes tombstone the .ecx entry in place and append the id to .ecj.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np

from ..cache.singleflight import Singleflight
from ..storage import idx as idx_mod
from ..storage import types as t
from ..storage.needle import Needle
from ..storage.superblock import SuperBlock
from .coder import ErasureCoder
from .geometry import DEFAULT, Geometry, to_ext
from .locate import Interval, locate_data
from .striping import check_layout_marker

# remote survivor fetches of online reconstruction run here, one per
# candidate shard (upstream recoverOneRemoteEcShardInterval fans out
# goroutines, store_ec.go:322-376)
_SURVIVOR_POOL = ThreadPoolExecutor(max_workers=14,
                                    thread_name_prefix="ec-survivor")

# (shard_id, offset, size) -> the bytes, or None when no peer has them
ShardReader = Callable[[int, int, int], Optional[bytes]]


class Pinned:
    """Closes a resource only once its last in-flight user has let go.

    A shard or a volume is dropped (``delete_shard``, an unmount, a
    decode) while reads run on it; closing its descriptor under a read
    would fail that read or, once the OS hands the number to another
    open, read another file's bytes. ``enter`` refuses once a close has
    begun, so a late reader sees the resource as gone."""

    def __init__(self, closer: Callable[[], None]):
        self._lock = threading.Lock()
        self._users = 0
        self._closing = False
        self._closer = closer

    def enter(self) -> bool:
        with self._lock:
            if self._closing:
                return False
            self._users += 1
            return True

    def exit(self) -> None:
        with self._lock:
            self._users -= 1
            last = self._closing and self._users == 0
        if last:
            self._closer()

    def close(self) -> None:
        with self._lock:
            if self._closing:
                return
            self._closing = True
            idle = self._users == 0
        if idle:
            self._closer()


class EcVolumeClosed(KeyError):
    """A read found its EC volume closed: dropped, or swapped for the
    normal volume a decode made of it."""


class EcShard:
    """One local .ecNN file (EcVolumeShard, ec_shard.go:16-95)."""

    def __init__(self, base_file_name: str, shard_id: int):
        self.shard_id = shard_id
        self.path = base_file_name + to_ext(shard_id)
        self._fd = os.open(self.path, os.O_RDONLY)
        self.size = os.fstat(self._fd).st_size
        self._pin = Pinned(lambda: os.close(self._fd))

    def read_at(self, offset: int, size: int) -> bytes:
        """Positioned read (no shared seek state, safe under
        concurrency); b"" once the shard is closed, which every caller
        takes as a missing shard."""
        if not self._pin.enter():
            return b""
        try:
            return os.pread(self._fd, size, offset)
        finally:
            self._pin.exit()

    def close(self) -> None:
        self._pin.close()


class EcVolume:
    def __init__(self, directory: str, collection: str, vid: int,
                 geometry: Geometry = DEFAULT,
                 coder: Optional[ErasureCoder] = None):
        self.dir = directory
        self.collection = collection
        self.vid = vid
        self.g = geometry
        self.coder = coder
        self.shards: dict[int, EcShard] = {}
        self._layout_checked = False
        self._lock = threading.RLock()
        # concurrent cold reads of one missing interval share a single
        # reconstruction (k shard reads and a kernel run)
        self.read_flight = Singleflight("ec.read")

        base = self.base_file_name()
        if not os.path.exists(base + ".ecx"):
            raise FileNotFoundError(base + ".ecx")
        self._ecx = open(base + ".ecx", "r+b")
        self.ecx_size = os.path.getsize(base + ".ecx")
        self._ecj = open(base + ".ecj", "a+b")
        # reads search .ecx and read shards outside the lock: a close of
        # the whole volume waits for them
        self._pin = Pinned(self._close_files)
        # the volume version comes from the superblock at the head of
        # .ec00 (readEcVolumeVersion, ec_decoder.go:73-90); v3 if absent
        self.version = t.CURRENT_VERSION
        self.offset_size = t.OFFSET_SIZE
        ec00 = base + to_ext(0)
        if os.path.exists(ec00):
            with open(ec00, "rb") as f:
                head = f.read(8)
            if len(head) == 8:
                sb = SuperBlock.from_bytes(head)
                self.version = sb.version
                self.offset_size = sb.offset_size
        self._entry_size = t.needle_map_entry_size(self.offset_size)

    def base_file_name(self) -> str:
        prefix = f"{self.collection}_" if self.collection else ""
        return os.path.join(self.dir, f"{prefix}{self.vid}")

    # --- shard management ---
    def add_shard(self, shard_id: int) -> bool:
        with self._lock:
            if shard_id in self.shards:
                return False
            self.shards[shard_id] = EcShard(self.base_file_name(), shard_id)
            return True

    def delete_shard(self, shard_id: int) -> bool:
        with self._lock:
            shard = self.shards.pop(shard_id, None)
            if shard is None:
                return False
            shard.close()
            return True

    def shard_ids(self) -> list[int]:
        return sorted(self.shards)

    def shard_size(self) -> int:
        # a copy: shards are dropped while reads run
        for s in list(self.shards.values()):
            return s.size
        return 0

    def live_entries(self) -> list[tuple[int, int]]:
        """Live (needle_id, size) pairs from the sorted .ecx, tombstones
        skipped."""
        out = []
        with self._lock:
            for i in range(self.ecx_size // self._entry_size):
                entry = os.pread(self._ecx.fileno(), self._entry_size,
                                 i * self._entry_size)
                key, _offset, size = idx_mod.unpack_entry(
                    entry, offset_size=self.offset_size)
                if not t.size_is_deleted(size):
                    out.append((key, size))
        return out

    # --- index lookup ---
    def find_needle(self, needle_id: int) -> tuple[int, int]:
        """(stored_offset, size) via on-disk binary search
        (SearchNeedleFromSortedIndex, ec_volume.go:210-235)."""
        return self._search(needle_id)

    def _search(self, needle_id: int,
                on_found: Optional[Callable[[int], None]] = None
                ) -> tuple[int, int]:
        lo, hi = 0, self.ecx_size // self._entry_size
        while lo < hi:
            mid = (lo + hi) // 2
            entry = os.pread(self._ecx.fileno(), self._entry_size,
                             mid * self._entry_size)
            key, offset, size = idx_mod.unpack_entry(
                entry, offset_size=self.offset_size)
            if key == needle_id:
                if on_found is not None:
                    on_found(mid * self._entry_size)
                return offset, size
            if key < needle_id:
                lo = mid + 1
            else:
                hi = mid
        raise KeyError(f"needle {needle_id:x} not in ec volume {self.vid}")

    def locate(self, needle_id: int) -> tuple[int, int, list[Interval]]:
        """(offset, size, intervals) for a needle
        (LocateEcShardNeedle, ec_volume.go:190-204)."""
        offset, size = self.find_needle(needle_id)
        if t.size_is_deleted(size):
            return offset, size, []
        shard_size = self.shard_size()
        if shard_size == 0:
            raise IOError(f"ec volume {self.vid}: no local shards")
        if not self._layout_checked:
            check_layout_marker(self.base_file_name(), shard_size,
                                self.g)
            self._layout_checked = True
        intervals = locate_data(
            self.g, self.g.data_shards * shard_size,
            t.stored_to_offset(offset),
            t.get_actual_size(size, self.version))
        return offset, size, intervals

    # --- read path ---
    def read_needle(self, needle_id: int, cookie: Optional[int] = None,
                    shard_reader: Optional[ShardReader] = None) -> Needle:
        if not self._pin.enter():
            raise EcVolumeClosed(f"ec volume {self.vid} closed")
        try:
            offset, size, intervals = self.locate(needle_id)
            if t.size_is_deleted(size):
                raise KeyError(f"needle {needle_id:x} deleted")
            record = b"".join(self._read_interval(iv, shard_reader)
                              for iv in intervals)
        finally:
            self._pin.exit()
        n = Needle.from_bytes(record, self.version)
        if cookie is not None and n.cookie != cookie:
            raise KeyError(f"needle {needle_id:x} cookie mismatch")
        return n

    def _read_interval(self, iv: Interval,
                       shard_reader: Optional[ShardReader] = None) -> bytes:
        shard_id, offset = iv.to_shard_id_and_offset(self.g)
        shard = self.shards.get(shard_id)
        if shard is not None:
            data = shard.read_at(offset, iv.size)
            if len(data) == iv.size:
                return data

        # not local: a peer's copy, else an online reconstruction; N
        # concurrent readers of one cold interval share one flight
        def fetch() -> bytes:
            if shard_reader is not None:
                data = shard_reader(shard_id, offset, iv.size)
                if data is not None and len(data) == iv.size:
                    return data
            return self._reconstruct_interval(shard_id, offset, iv.size,
                                              shard_reader)

        return self.read_flight.do((shard_id, offset, iv.size), fetch)

    def _reconstruct_interval(self, missing_shard: int, offset: int,
                              size: int,
                              shard_reader: Optional[ShardReader] = None
                              ) -> bytes:
        """Online reconstruction of one interval from any k other shards:
        local shards read inline, remote survivors fetched in parallel."""
        if self.coder is None:
            raise IOError(
                f"shard {missing_shard} missing and no coder to reconstruct")
        shards: list[Optional[np.ndarray]] = [None] * self.g.total_shards
        have = 0
        remote_candidates: list[int] = []
        for sid in range(self.g.total_shards):
            if sid == missing_shard:
                continue
            local = self.shards.get(sid)
            if local is not None and have < self.g.data_shards:
                b = local.read_at(offset, size)
                if len(b) == size:
                    shards[sid] = np.frombuffer(b, dtype=np.uint8)
                    have += 1
                    continue
            remote_candidates.append(sid)
        need = self.g.data_shards - have
        if need > 0 and shard_reader is not None and remote_candidates:
            futs = {sid: _SURVIVOR_POOL.submit(shard_reader, sid, offset,
                                               size)
                    for sid in remote_candidates}
            for sid, fut in futs.items():
                if have >= self.g.data_shards:
                    fut.cancel()
                    continue
                try:
                    b = fut.result()
                except Exception:
                    continue
                if b is not None and len(b) == size:
                    shards[sid] = np.frombuffer(b, dtype=np.uint8)
                    have += 1
        if have < self.g.data_shards:
            raise IOError(
                f"cannot reconstruct shard {missing_shard}: "
                f"only {have} of {self.g.data_shards} shards reachable")
        rebuilt = self.coder.reconstruct(shards, targets=(missing_shard,))
        return np.asarray(rebuilt[missing_shard]).tobytes()

    # --- delete path ---
    def delete_needle(self, needle_id: int) -> None:
        """Tombstone in .ecx + journal to .ecj
        (DeleteNeedleFromEcx, ec_volume_delete.go:27-49)."""
        with self._lock:
            def mark(entry_offset: int) -> None:
                os.pwrite(self._ecx.fileno(),
                          t.put_u32(t.size_to_u32(t.TOMBSTONE_FILE_SIZE)),
                          entry_offset + t.NEEDLE_ID_SIZE
                          + self.offset_size)

            try:
                self._search(needle_id, on_found=mark)
            except KeyError:
                return
            self._ecj.seek(0, os.SEEK_END)
            self._ecj.write(t.put_u64(needle_id))
            self._ecj.flush()

    def close(self) -> None:
        self._pin.close()

    def _close_files(self) -> None:
        with self._lock:
            for shard in self.shards.values():
                shard.close()
            self.shards.clear()
            self._ecx.close()
            self._ecj.close()


def rebuild_ecx_file(base_file_name: str,
                     offset_size: int = t.OFFSET_SIZE) -> None:
    """Re-apply .ecj tombstones into .ecx after a rebuild, then drop .ecj
    (RebuildEcxFile, ec_volume_delete.go:51-97)."""
    ecj_path = base_file_name + ".ecj"
    if not os.path.exists(ecj_path):
        return
    entry_size = t.needle_map_entry_size(offset_size)
    ecx_size = os.path.getsize(base_file_name + ".ecx")
    with open(base_file_name + ".ecx", "r+b") as ecx, \
            open(ecj_path, "rb") as ecj:
        while True:
            b = ecj.read(t.NEEDLE_ID_SIZE)
            if len(b) != t.NEEDLE_ID_SIZE:
                break
            needle_id = t.get_u64(b)
            lo, hi = 0, ecx_size // entry_size
            while lo < hi:
                mid = (lo + hi) // 2
                ecx.seek(mid * entry_size)
                key, _, _ = idx_mod.unpack_entry(
                    ecx.read(entry_size), offset_size=offset_size)
                if key == needle_id:
                    ecx.seek(mid * entry_size
                             + t.NEEDLE_ID_SIZE + offset_size)
                    ecx.write(t.put_u32(t.size_to_u32(t.TOMBSTONE_FILE_SIZE)))
                    break
                if key < needle_id:
                    lo = mid + 1
                else:
                    hi = mid
    os.remove(ecj_path)
