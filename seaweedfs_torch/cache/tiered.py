"""Tiered chunk cache: size-class-accounted memory LRU + on-disk tier.

The reference keeps hot chunks in a tiered util/chunk_cache (three
size-classed memory caches in front of leveldb-indexed disk segments,
chunk_cache/chunk_cache.go); the filer/mount read paths consult it before
any volume-server round trip. Same shape here:

- memory front: byte-budgeted LRU; every entry is accounted to a size
  class (<=64KB / <=1MB / >1MB) so stats expose *what kind* of chunks
  occupy the budget, like the reference's per-tier counters;
- disk tier (optional): memory evictions demote to files under a bounded
  directory; a disk hit promotes back to memory — repeated reads of a
  working set bigger than RAM still skip the volume server;
- TTL (optional): entries expire so an invalidation that never arrives
  (crashed peer, missed event) cannot serve stale bytes forever;
  overwrite/delete drop entries immediately via drop()/drop_prefix().

Every get() emits a ``cache.lookup`` span tagged with the tier that
answered, and hit/miss/eviction counters flow into an optional
utils.metrics Registry — a warm GET is visible in both /metrics and
/debug/trace.

Thread-safe: the filer serves from an asyncio loop plus executor
threads, the mount from arbitrary caller threads.

The port's copy of seaweedfs_tpu/cache/tiered.py. Left out: the
``cache_hit`` / ``cache_miss`` annotations of the ambient request's wide
event, which the port's wide events do not carry (ROADMAP A.9). In the
port only the mount reads through it; the filer server's own chunk
cache waits for A.9 too.
"""

from __future__ import annotations

import collections
import hashlib
import os
import threading
import time
from typing import Optional

from .. import observe

# size-class boundaries (bytes): chunks are accounted to the first class
# whose cap they fit — mirrors the reference's small/medium/large split
SIZE_CLASSES = ((64 * 1024, "64K"), (1024 * 1024, "1M"),
                (float("inf"), "big"))


def _size_class(n: int) -> str:
    for cap, name in SIZE_CLASSES:
        if n <= cap:
            return name
    return SIZE_CLASSES[-1][1]


class _DiskTier:
    """Bounded directory of demoted chunks, LRU by access order.

    Files are named by key hash (keys are fids/fid@offset strings which
    are filename-safe already, but hashing also bounds name length).
    The in-memory index is authoritative; leftovers from a previous
    process are swept at startup — the cache is disposable, and
    unindexed files would otherwise never count against the budget and
    leak disk without bound across restarts."""

    def __init__(self, directory: str, max_bytes: int):
        self.dir = directory
        self.max_bytes = max_bytes
        os.makedirs(directory, exist_ok=True)
        for name in os.listdir(directory):
            try:
                os.unlink(os.path.join(directory, name))
            except OSError:
                pass
        # own lock: disk I/O must never run under the memory tier's
        # lock, or every pure-memory hit queues behind a file read
        self._lock = threading.Lock()
        # key -> (size, expires_at_monotonic | 0-for-never)
        self._index: "collections.OrderedDict[str, tuple[int, float]]" = \
            collections.OrderedDict()
        self._bytes = 0

    def _path(self, key: str) -> str:
        return os.path.join(self.dir,
                            hashlib.sha1(key.encode()).hexdigest())

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            hit = self._index.get(key)
            if hit is None:
                return None
            size, expires = hit
            if expires and expires <= time.monotonic():
                self._drop_locked(key)
                return None
            try:
                with open(self._path(key), "rb") as f:
                    data = f.read()
            except OSError:
                self._index.pop(key, None)
                self._bytes -= size
                return None
            self._index.move_to_end(key)
            return data

    def put(self, key: str, data: bytes, expires: float = 0.0) -> int:
        """Returns the number of entries evicted to make room."""
        if len(data) > self.max_bytes:
            return 0
        with self._lock:
            old = self._index.pop(key, None)
            if old is not None:
                self._bytes -= old[0]
            evicted = 0
            while self._bytes + len(data) > self.max_bytes and self._index:
                victim, (vsize, _) = self._index.popitem(last=False)
                self._bytes -= vsize
                self._unlink(victim)
                evicted += 1
            try:
                tmp = self._path(key) + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(data)
                # cache tier: losing an entry to power loss just means a
                # re-fetch — fsync here would serialize every put on the
                # platter for data that is a COPY by definition
                os.replace(tmp, self._path(key))
            except OSError:
                return evicted
            self._index[key] = (len(data), expires)
            self._bytes += len(data)
            return evicted

    def drop(self, key: str) -> None:
        with self._lock:
            self._drop_locked(key)

    def _drop_locked(self, key: str) -> None:
        hit = self._index.pop(key, None)
        if hit is not None:
            self._bytes -= hit[0]
            self._unlink(key)

    def _unlink(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except OSError:
            pass

    def keys(self) -> list[str]:
        with self._lock:
            return list(self._index)

    def stats(self) -> dict:
        with self._lock:
            return {"bytes": self._bytes, "chunks": len(self._index)}


class TieredChunkCache:
    def __init__(self, max_bytes: int = 64 * 1024 * 1024,
                 max_chunk_bytes: int = 8 * 1024 * 1024,
                 disk_dir: str = "",
                 disk_max_bytes: int = 1024 * 1024 * 1024,
                 ttl: float = 0.0,
                 metrics=None):
        self.max_bytes = max_bytes
        # chunks bigger than this aren't worth caching (they'd evict
        # everything else); the reference tiers by chunk size similarly
        self.max_chunk_bytes = max_chunk_bytes
        self.ttl = ttl  # 0 = no expiry (invalidation-only)
        self.metrics = metrics
        self._lock = threading.Lock()
        # key -> (data, expires_at, size_class)
        self._data: "collections.OrderedDict[str, tuple]" = \
            collections.OrderedDict()
        self._bytes = 0
        self._class_bytes: dict[str, int] = \
            {name: 0 for _, name in SIZE_CLASSES}
        self._class_chunks: dict[str, int] = \
            {name: 0 for _, name in SIZE_CLASSES}
        self._disk = (_DiskTier(disk_dir, disk_max_bytes)
                      if disk_dir else None)
        # bumped by every invalidation: a disk->memory promotion that
        # overlapped a drop must not resurrect the entry
        self._gen = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # --- env-tuned construction (the serving stack's knobs) ---
    @classmethod
    def from_env(cls, metrics=None, prefix: str = "WEED_CHUNK_CACHE"
                 ) -> "TieredChunkCache":
        def _f(name: str, default: float) -> float:
            try:
                return float(os.environ.get(f"{prefix}_{name}", default))
            except ValueError:
                return default

        return cls(
            max_bytes=int(_f("MB", 64) * 1024 * 1024),
            disk_dir=os.environ.get(f"{prefix}_DIR", ""),
            disk_max_bytes=int(_f("DISK_MB", 1024) * 1024 * 1024),
            ttl=_f("TTL", 0.0),
            metrics=metrics)

    def _count(self, name: str, tier: str) -> None:
        if self.metrics is not None:
            self.metrics.count(f"chunk_cache_{name}",
                               labels={"tier": tier})

    # --- read path ---
    def get(self, key: str) -> Optional[bytes]:
        with observe.span("cache.lookup", tags={"key": key}) as sp:
            data, tier = self._get_inner(key)
            sp.tags["tier"] = tier
            if data is None:
                self.misses += 1
                self._count("miss", tier="-")
            else:
                self.hits += 1
                self._count("hit", tier=tier)
            return data

    def _get_inner(self, key: str) -> tuple[Optional[bytes], str]:
        now = time.monotonic()
        with self._lock:
            hit = self._data.get(key)
            if hit is not None:
                data, expires, _cls = hit
                if expires and expires <= now:
                    self._evict_key(key)
                else:
                    self._data.move_to_end(key)
                    return data, "memory"
            gen = self._gen
        if self._disk is None:
            return None, "-"
        # disk I/O runs OUTSIDE the memory lock so pure-memory hits in
        # other threads never queue behind a file read
        data = self._disk.get(key)
        if data is None:
            return None, "-"
        demoted: list = []
        with self._lock:
            if self._gen == gen:
                # promote: disk hit means the chunk is hot again; skip
                # if an invalidation ran while we were reading the file
                # (the data may belong to a freed fid)
                demoted = self._put_memory(key, data)
        self._demote(demoted)
        return data, "disk"

    # --- write path ---
    def put(self, key: str, data: bytes) -> None:
        if len(data) > self.max_chunk_bytes:
            return
        with self._lock:
            demoted = self._put_memory(key, data)
        self._demote(demoted)

    def _put_memory(self, key: str, data: bytes) -> list:
        """Insert under the held memory lock; returns the entries the
        eviction displaced so the caller can demote them to disk after
        releasing the lock."""
        old = self._data.pop(key, None)
        if old is not None:
            self._account(old[2], -len(old[0]), -1)
        cls = _size_class(len(data))
        expires = time.monotonic() + self.ttl if self.ttl else 0.0
        self._data[key] = (data, expires, cls)
        self._account(cls, len(data), +1)
        demoted = []
        while self._bytes > self.max_bytes and self._data:
            victim, (vdata, vexpires, vcls) = self._data.popitem(last=False)
            self._account(vcls, -len(vdata), -1)
            self.evictions += 1
            self._count("eviction", tier="memory")
            if self._disk is not None:
                demoted.append((victim, vdata, vexpires))
        return demoted

    def _demote(self, items: list) -> None:
        """Write displaced chunks to the disk tier (no memory lock held):
        the disk keeps the working set one cheap pread away from warm,
        each entry's TTL riding along."""
        if self._disk is None or not items:
            return
        disk_evictions = 0
        for victim, vdata, vexpires in items:
            disk_evictions += self._disk.put(victim, vdata, vexpires)
        if disk_evictions:
            with self._lock:
                self.evictions += disk_evictions
            for _ in range(disk_evictions):
                self._count("eviction", tier="disk")

    def _account(self, cls: str, delta_bytes: int,
                 delta_chunks: int) -> None:
        # chunk delta is explicit: zero-length chunks are legal cache
        # entries, so sign-of-bytes cannot stand in for add/remove
        self._bytes += delta_bytes
        self._class_bytes[cls] += delta_bytes
        self._class_chunks[cls] += delta_chunks

    def _evict_key(self, key: str) -> None:
        old = self._data.pop(key, None)
        if old is not None:
            self._account(old[2], -len(old[0]), -1)

    # --- invalidation (overwrite/delete) ---
    def drop(self, key: str) -> None:
        with self._lock:
            self._gen += 1  # cancels any in-flight disk promotion
            self._evict_key(key)
        if self._disk is not None:
            self._disk.drop(key)

    def drop_prefix(self, prefix: str) -> None:
        """Drop every entry whose key starts with `prefix` — the fid of
        an overwritten/deleted chunk invalidates all its cached views."""
        with self._lock:
            self._gen += 1
            for key in [k for k in self._data if k.startswith(prefix)]:
                self._evict_key(key)
        if self._disk is not None:
            for key in self._disk.keys():
                if key.startswith(prefix):
                    self._disk.drop(key)

    def stats(self) -> dict:
        with self._lock:
            out = {"bytes": self._bytes, "chunks": len(self._data),
                   "hits": self.hits, "misses": self.misses,
                   "evictions": self.evictions,
                   "classes": {
                       name: {"bytes": self._class_bytes[name],
                              "chunks": self._class_chunks[name]}
                       for _, name in SIZE_CLASSES}}
        if self._disk is not None:
            out["disk"] = self._disk.stats()
        return out

