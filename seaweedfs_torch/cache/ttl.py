"""Bounded TTL lookup cache with pinned entries.

The port's reduced copy of seaweedfs_tpu/cache/ttl.py, to what the
filer and its ring use (``is_pinned``, ``__len__`` and ``stats`` are left
out). The wdclient vid-location cache
shape (weed/wdclient/vid_map.go): polled lookups expire after a TTL;
entries fed by the master's watch stream are *pinned*, authoritative
until the stream says otherwise. Used for the filer's volume locations
and its entry metadata.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Optional

_MISS = object()


class TTLCache:
    def __init__(self, ttl: float = 60.0, max_entries: int = 4096,
                 metrics=None, name: str = ""):
        self.ttl = ttl
        self.max_entries = max_entries
        self.metrics = metrics
        self.name = name
        self._lock = threading.Lock()
        # key -> (value, expires_at_monotonic | None-for-pinned)
        self._data: "OrderedDict" = OrderedDict()
        # bumped by every invalidation: read-through callers snapshot it
        # before the backing read and put_if_fresh after, so a value read
        # concurrently with a mutation is never cached stale
        self.generation = 0

    def _count(self, which: str) -> None:
        if self.metrics is not None:
            labels = {"cache": self.name} if self.name else None
            self.metrics.count(f"lookup_cache_{which}", labels=labels)

    def get(self, key, default=None):
        with self._lock:
            hit = self._data.get(key, _MISS)
            if hit is not _MISS:
                value, expires = hit
                if expires is None or expires > time.monotonic():
                    self._data.move_to_end(key)
                    self._count("hit")
                    return value
                del self._data[key]
            self._count("miss")
            return default

    def put(self, key, value, ttl: Optional[float] = None,
            pin: bool = False) -> None:
        expires = None if pin else \
            time.monotonic() + (self.ttl if ttl is None else ttl)
        with self._lock:
            self._insert(key, value, expires)

    def put_if_fresh(self, key, value, generation: int,
                     ttl: Optional[float] = None) -> bool:
        """Cache `value` only if no invalidation ran since `generation`
        was snapshotted — the read-through race guard: a backing-store
        read that overlapped a mutation is discarded, not cached."""
        with self._lock:
            if self.generation != generation:
                return False
            self._insert(key, value, time.monotonic()
                         + (self.ttl if ttl is None else ttl))
            return True

    def _insert(self, key, value, expires: Optional[float]) -> None:
        """Under the lock: store, then evict TTL'd entries before pinned
        ones (pinned means "authoritative until the push stream says
        otherwise": dropping one turns push-fed lookups back into
        polling), never the key just inserted (it may be the only TTL'd
        entry among the pins); only when everything else is pinned does
        the oldest pin go."""
        self._data.pop(key, None)
        self._data[key] = (value, expires)
        while len(self._data) > self.max_entries:
            victim = next((k for k, (_, exp) in self._data.items()
                           if exp is not None and k != key), None)
            if victim is None:
                self._data.popitem(last=False)
            else:
                del self._data[victim]

    def __contains__(self, key) -> bool:
        """A live entry, without touching the hit and miss counters or
        the LRU order."""
        with self._lock:
            hit = self._data.get(key, _MISS)
            if hit is _MISS:
                return False
            return hit[1] is None or hit[1] > time.monotonic()

    def pop(self, key, default=None):
        """Drop `key`; returns its live value or `default` (dict.pop
        shape — call sites treat this cache like the dict it replaced)."""
        with self._lock:
            self.generation += 1
            hit = self._data.pop(key, _MISS)
            if hit is _MISS:
                return default
            value, expires = hit
            if expires is not None and expires <= time.monotonic():
                return default
            return value

    def drop_paths(self, keys) -> None:
        """Invalidate a batch of keys under ONE generation bump: the ring's
        cross-peer sweep drops both sides of a remote mutation at once, so
        a fill that raced it is discarded whichever key it filled."""
        with self._lock:
            self.generation += 1
            for k in keys:
                self._data.pop(k, None)

    def drop_prefix(self, prefix: str) -> None:
        """Invalidate every string key under `prefix` (recursive
        directory delete: cached child entries must not outlive it)."""
        with self._lock:
            self.generation += 1
            for k in [k for k in self._data
                      if isinstance(k, str) and k.startswith(prefix)]:
                del self._data[k]

    def clear(self) -> None:
        with self._lock:
            self.generation += 1
            self._data.clear()
