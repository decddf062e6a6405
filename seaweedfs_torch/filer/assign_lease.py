"""Bulk fid leasing: amortize master ``/dir/assign`` round trips.

The port's copy of seaweedfs_tpu/filer/assign_lease.py: the synchronous
pool of the mount (``AssignLeasePool``) and the event-loop pool of the
filer (``AsyncAssignLeasePool``) over one bookkeeping core
(``_PoolCore``). The synchronous pool reads the reference's knobs
(``WEED_ASSIGN_LEASE``, ``_TTL``, ``_MAX``, ``_START``); the filer's
pool keeps the reference's defaults as constants (``LEASE_TTL``,
``LEASE_MAX``, always on), as the port's filer has no knob for them.

The Haystack-shape write path pays one master round trip per chunk: the
serial assign dominates small-chunk upload latency once the volume POST
itself is pipelined. The reference amortizes this with bulk assignment
(``/dir/assign?count=N``, weed/operation/assign_file_id.go): the master
reserves N consecutive needle keys on one writable volume and returns a
single fid; derivatives ``fid_1`` .. ``fid_{N-1}`` address key+delta with
the same cookie.

Both pools keep one active lease per (collection, replication, ttl) and
hand out per-fid assign dicts until the lease is exhausted or its short
TTL expires: steady-state chunk uploads then cost **zero** master round
trips.

Design constraints honored here:

* **Short TTL** (10 s): a lease never pins a retired/sealed volume for
  long; expiry abandons unused keys (harmless: cookies gate reads and
  the sequencer never re-mints them).
* **Adaptive N**: a lease drained before expiry doubles the next request
  (up to 128); one that expires mostly unused halves it, so N tracks
  recent demand instead of a fixed batch.
* **Invalidation**: volume-read-only (409), 404 and breaker-open upload
  failures call ``invalidate``, dropping every lease on that volume so
  the next fid comes from a fresh assignment.
* **No new failure discipline**: refills go through the caller-provided
  ``fetch`` (the existing master-rotation / RetryPolicy / deadline-budget
  machinery); the pool never retries or sleeps on its own.

Counters land in the caller's metrics registry as ``assign_lease_hit`` /
``assign_lease_miss`` / ``assign_lease_invalidate``; refills emit an
``assign.lease`` observe span tagged with the requested count.
"""

from __future__ import annotations

import asyncio
import os
import threading
import time
from typing import Awaitable, Callable, Optional

from .. import observe
from ..storage.file_id import FileId

# the filer pool's lease lifetime and the cap on its adaptive size (the
# reference's defaults of WEED_ASSIGN_LEASE_TTL / _MAX)
LEASE_TTL = 10.0
LEASE_MAX = 128


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def lease_enabled() -> bool:
    """``WEED_ASSIGN_LEASE=0`` turns leasing off process-wide (every get
    becomes a count=1 master round trip)."""
    return os.environ.get("WEED_ASSIGN_LEASE", "1") not in ("0", "false")


LeaseKey = tuple  # (collection, replication, ttl)


class _Lease:
    __slots__ = ("resp", "count", "next_i", "born", "vid", "_base")

    def __init__(self, resp: dict, born: float):
        self.resp = resp
        self.count = int(resp.get("count", 1))
        self.next_i = 0
        self.born = born
        self._base = FileId.parse(resp["fid"])
        self.vid = self._base.volume_id

    def remaining(self, now: float, ttl: float) -> int:
        if now - self.born >= ttl:
            return 0
        return self.count - self.next_i

    def take(self) -> dict:
        d = self.next_i
        self.next_i += 1
        auths = self.resp.get("auths")
        auth = (auths[d] if auths and d < len(auths)
                else (self.resp.get("auth", "") if d == 0 else ""))
        # hand out the RESOLVED canonical form of the d-th derivative
        # (fid_d = key+d, shared cookie) rather than the "fid_d" wire
        # shorthand: the volume server accepts both, but plenty of
        # callers slice fid strings and must never see a _suffix
        out = {"fid": str(FileId(self.vid, self._base.key + d,
                                 self._base.cookie)),
               "url": self.resp["url"],
               "publicUrl": self.resp.get("publicUrl",
                                          self.resp["url"]),
               "replicas": self.resp.get("replicas", []),
               "count": 1}
        if auth:
            out["auth"] = auth
        return out


class _PoolCore:
    """Lease bookkeeping shared by the sync and async frontends. All
    methods must be called under the frontend's lock."""

    def __init__(self, ttl: Optional[float] = None,
                 max_count: Optional[int] = None,
                 start_count: int = 0, metrics=None,
                 enabled: Optional[bool] = None):
        self.ttl = ttl if ttl is not None else \
            _env_float("WEED_ASSIGN_LEASE_TTL", 10.0)
        self.max_count = max_count if max_count is not None else \
            _env_int("WEED_ASSIGN_LEASE_MAX", 128)
        self.start_count = max(1, start_count or
                               _env_int("WEED_ASSIGN_LEASE_START", 4))
        self.enabled = lease_enabled() if enabled is None else enabled
        self.metrics = metrics
        self._leases: dict[LeaseKey, _Lease] = {}
        # per-key size of the next lease (adaptive from recent demand)
        self._next_count: dict[LeaseKey, int] = {}

    def _count(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.count(name)

    def take(self, key: LeaseKey, now: float) -> Optional[dict]:
        lease = self._leases.get(key)
        if lease is None:
            return None
        if lease.remaining(now, self.ttl) <= 0:
            self._retire(key, lease, now)
            return None
        self._count("assign_lease_hit")
        return lease.take()

    def _retire(self, key: LeaseKey, lease: _Lease, now: float) -> None:
        """Adapt the next batch to observed demand: a lease drained before
        its TTL means demand outruns the batch (double it); one that
        expired mostly unused over-reserved (halve it)."""
        del self._leases[key]
        if lease.next_i >= lease.count:
            self._next_count[key] = min(self.max_count, lease.count * 2)
        else:
            unused = lease.count - lease.next_i
            if unused * 2 >= lease.count:
                # floor 2, not 1: a count-1 lease is never stored, so a
                # later demand surge would have no drain signal to grow on
                self._next_count[key] = max(2, lease.count // 2)

    def want_count(self, key: LeaseKey) -> int:
        return min(self.max_count,
                   self._next_count.get(key, self.start_count))

    def fill(self, key: LeaseKey, resp: dict, now: float) -> dict:
        """Install a fresh lease and serve its first fid."""
        self._count("assign_lease_miss")
        lease = _Lease(resp, now)
        if lease.count > 1:
            self._leases[key] = lease
        return lease.take()

    def invalidate_vid(self, vid: int) -> int:
        dead = [k for k, lease in self._leases.items() if lease.vid == vid]
        for k in dead:
            del self._leases[k]
            # demand estimate is stale too: restart small
            self._next_count.pop(k, None)
        if dead:
            self._count("assign_lease_invalidate")
        return len(dead)

    def clear(self) -> None:
        self._leases.clear()


def _params(key: LeaseKey) -> dict:
    collection, replication, ttl = key
    return {k: v for k, v in (("collection", collection),
                              ("replication", replication),
                              ("ttl", ttl)) if v}


class AssignLeasePool:
    """Synchronous lease pool (client.py, mount). ``fetch(params, count)``
    performs one master assignment — the caller's existing rotation/retry
    machinery — and returns the parsed response dict.

    Locking: core state rides a fast mutex that is NEVER held across the
    network; refills serialize on a per-key lock, so concurrent misses of
    one key coalesce into a single master round trip while hits (and
    other keys) stay non-blocking behind a slow refill."""

    def __init__(self, fetch: Callable[[dict, int], dict], **kwargs):
        self._fetch = fetch
        self._core = _PoolCore(**kwargs)
        self._state = threading.Lock()
        self._refill: dict[LeaseKey, threading.Lock] = {}

    @property
    def core(self) -> _PoolCore:
        return self._core

    def get(self, collection: str = "", replication: str = "",
            ttl: str = "") -> dict:
        key = (collection, replication, ttl)
        if not self._core.enabled:
            self._core._count("assign_lease_miss")
            return self._fetch(_params(key), 1)
        with self._state:
            served = self._core.take(key, time.monotonic())
            if served is not None:
                return served
            klock = self._refill.setdefault(key, threading.Lock())
        with klock:
            with self._state:
                # another caller may have refilled while we waited
                served = self._core.take(key, time.monotonic())
                if served is not None:
                    return served
                want = self._core.want_count(key)
            with observe.span("assign.lease", tags={"count": want}):
                resp = self._fetch(_params(key), want)
            with self._state:
                return self._core.fill(key, resp, time.monotonic())

    def invalidate(self, fid: str) -> int:
        """Drop every lease on `fid`'s volume (read-only/404/breaker-open
        upload outcome: the volume is no longer a good write target)."""
        try:
            vid = int(str(fid).split(",")[0])
        except ValueError:
            return 0
        with self._state:
            return self._core.invalidate_vid(vid)


class AsyncAssignLeasePool:
    """Event-loop variant (the filer). ``fetch(params, count)`` is a
    coroutine hitting the master through the filer's HA rotation. Core
    state is only touched from the loop (no awaits inside), so it needs
    no lock; refills coalesce on a per-key asyncio.Lock without blocking
    hits or other keys. Always on, with ``LEASE_TTL`` and ``LEASE_MAX``
    unless the caller passes others."""

    def __init__(self, fetch: Callable[[dict, int], Awaitable[dict]],
                 start_count: int, ttl: float = LEASE_TTL,
                 max_count: int = LEASE_MAX, metrics=None):
        self._fetch = fetch
        self._core = _PoolCore(ttl=ttl, max_count=max_count,
                               start_count=start_count, metrics=metrics,
                               enabled=True)
        self._refill: dict[LeaseKey, asyncio.Lock] = {}

    @property
    def core(self) -> _PoolCore:
        return self._core

    async def get(self, collection: str = "", replication: str = "",
                  ttl: str = "") -> dict:
        key = (collection, replication, ttl)
        served = self._core.take(key, time.monotonic())
        if served is not None:
            return served
        klock = self._refill.setdefault(key, asyncio.Lock())
        async with klock:
            served = self._core.take(key, time.monotonic())
            if served is not None:
                return served
            want = self._core.want_count(key)
            with observe.span("assign.lease", tags={"count": want}):
                resp = await self._fetch(_params(key), want)
            return self._core.fill(key, resp, time.monotonic())

    def invalidate(self, fid: str) -> int:
        """Drop every lease on ``fid``'s volume; returns how many."""
        try:
            vid = int(str(fid).split(",")[0])
        except ValueError:
            return 0
        return self._core.invalidate_vid(vid)
