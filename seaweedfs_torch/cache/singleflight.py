"""Singleflight: collapse N concurrent fetches of one key into one.

The port's reduced copy of seaweedfs_tpu/cache/singleflight.py (the
asyncio variant; the threaded one is left out), the shape of
golang.org/x/sync/singleflight as upstream's read paths use it: the
first caller of a key becomes the leader and runs the fetch; callers
that arrive while it is in flight await the leader's result (or
exception). The flight is forgotten as soon as it completes: this is
request coalescing, not caching. Waiters emit a ``singleflight.wait``
span, and leader/shared counts go to an optional metrics registry.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, TypeVar

from .. import observe

T = TypeVar("T")


class AsyncSingleflight:
    """Followers await the leader's future on one asyncio loop.
    Cancellation of the leader propagates CancelledError to the
    followers (the flight is forgotten, so a retry starts fresh)."""

    def __init__(self, name: str = "", metrics=None):
        self.name = name
        self.metrics = metrics
        self._flights: dict = {}

    def _count(self, which: str) -> None:
        if self.metrics is not None:
            labels = {"group": self.name} if self.name else None
            self.metrics.count(f"singleflight_{which}", labels=labels)

    async def do(self, key, fn: Callable[[], Awaitable[T]]) -> T:
        fut = self._flights.get(key)
        if fut is None:
            fut = asyncio.get_running_loop().create_future()
            self._flights[key] = fut
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
        self._count("shared")
        with observe.span("singleflight.wait",
                          tags={"key": str(key), "group": self.name}):
            return await asyncio.shield(fut)
