"""Singleflight: collapse N concurrent fetches of one key into one.

The port's copy of seaweedfs_tpu/cache/singleflight.py. The shape of
golang.org/x/sync/singleflight as the reference uses it on its read
paths: the first caller of a key becomes the leader and runs
the fetch; callers that arrive while it is in flight wait and share the
leader's result (or exception). The flight is forgotten as soon as it
completes — this is request coalescing, not caching.

Two variants:

- ``Singleflight``      : thread-based (Event), for the sync read paths
                          (mount chunk reads, EC shard reads running in
                          executor threads);
- ``AsyncSingleflight`` : asyncio-based (Future), for the filer's
                          aiohttp chunk fetches.

Waiters emit a ``singleflight.wait`` span so a coalesced read is visible
in /debug/trace, and both variants keep leader/shared counters (exported
via an optional utils.metrics Registry).
"""

from __future__ import annotations

import asyncio
import threading
from typing import Awaitable, Callable, Optional, TypeVar

from .. import observe

T = TypeVar("T")


class _Flight:
    __slots__ = ("event", "result", "exc")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.exc: Optional[BaseException] = None


class Singleflight:
    def __init__(self, name: str = "", metrics=None):
        self.name = name
        self.metrics = metrics
        self._lock = threading.Lock()
        self._flights: dict = {}
        self.leaders = 0
        self.shared = 0

    def _count(self, which: str) -> None:
        if self.metrics is not None:
            labels = {"group": self.name} if self.name else None
            self.metrics.count(f"singleflight_{which}", labels=labels)

    def do(self, key, fn: Callable[[], T]) -> T:
        with self._lock:
            flight = self._flights.get(key)
            if flight is None:
                flight = _Flight()
                self._flights[key] = flight
                leader = True
                self.leaders += 1
            else:
                leader = False
                self.shared += 1
        if leader:
            self._count("leader")
            try:
                flight.result = fn()
            except BaseException as e:
                flight.exc = e
                raise
            finally:
                with self._lock:
                    self._flights.pop(key, None)
                flight.event.set()
            return flight.result
        self._count("shared")
        with observe.span("singleflight.wait",
                          tags={"key": str(key), "group": self.name}):
            flight.event.wait()
        if flight.exc is not None:
            raise flight.exc
        return flight.result

    def stats(self) -> dict:
        with self._lock:
            return {"leaders": self.leaders, "shared": self.shared}


class AsyncSingleflight:
    """Same contract on one asyncio loop: followers await the leader's
    future. Cancellation of the leader propagates CancelledError to the
    followers (the flight is forgotten, so a retry starts fresh)."""

    def __init__(self, name: str = "", metrics=None):
        self.name = name
        self.metrics = metrics
        self._flights: dict = {}
        self.leaders = 0
        self.shared = 0

    def _count(self, which: str) -> None:
        if self.metrics is not None:
            labels = {"group": self.name} if self.name else None
            self.metrics.count(f"singleflight_{which}", labels=labels)

    async def do(self, key, fn: Callable[[], Awaitable[T]]) -> T:
        fut = self._flights.get(key)
        if fut is None:
            fut = asyncio.get_running_loop().create_future()
            self._flights[key] = fut
            self.leaders += 1
            self._count("leader")
            try:
                result = await fn()
            except BaseException as e:
                if not fut.cancelled():
                    fut.set_exception(e)
                    # retrieved here, so an exception nobody awaited is
                    # never reported as unretrieved
                    fut.exception()
                raise
            else:
                if not fut.cancelled():
                    fut.set_result(result)
                return result
            finally:
                self._flights.pop(key, None)
        self.shared += 1
        self._count("shared")
        with observe.span("singleflight.wait",
                          tags={"key": str(key), "group": self.name}):
            return await asyncio.shield(fut)

    def stats(self) -> dict:
        return {"leaders": self.leaders, "shared": self.shared}
