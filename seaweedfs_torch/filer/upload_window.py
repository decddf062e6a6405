"""Bounded in-flight window for pipelined chunk uploads.

The port's copy of seaweedfs_tpu/filer/upload_window.py, whole.

The filer's autochunk PUT used to be strictly serial: read one chunk from
the request body, assign, encrypt, POST it to a volume server, await the
reply, then read the next chunk — every per-chunk latency (master RTT,
cipher CPU, volume write + replication fan-out) added end to end. The
reference overlaps these with concurrent upload workers
(weed/filer/filechunk_section.go); this window is the asyncio analog.

Usage (one window per request)::

    window = UploadWindow(upload_fn, concurrency)
    while body_has_data:
        await window.submit(data, offset)   # blocks when window is full
    chunks = await window.drain()           # raises the first failure

``submit`` applies backpressure: once ``concurrency`` uploads are in
flight the request body stops being read until a slot frees, so memory
stays bounded at ``concurrency * chunk_size``. Completions may land out
of order — each chunk carries its own logical offset, and the caller
sorts the drained list. A failed upload poisons the window: the next
``submit``/``drain`` raises, and :meth:`abort` cancels whatever is still
in flight so the caller can queue deletes for every chunk that may have
landed.

Telemetry: an inflight gauge (``upload_window_inflight``) and the
cumulative seconds ``submit`` spent blocked on a full window
(``upload_window_stall_s``) — the number that says whether the window,
the body stream, or the backend is the bottleneck.
"""

from __future__ import annotations

import asyncio
import time
from typing import Awaitable, Callable, Optional


class UploadWindow:
    def __init__(self, upload: Callable[[int, bytes, int], Awaitable],
                 concurrency: int, metrics=None):
        self._upload = upload  # async (index, data, offset) -> chunk
        self._concurrency = max(1, int(concurrency))
        self._sem = asyncio.Semaphore(self._concurrency)
        self._tasks: list[asyncio.Task] = []
        self._inflight = 0
        self._failed: Optional[BaseException] = None
        self.stall_s = 0.0
        self.metrics = metrics

    def _gauge(self) -> None:
        if self.metrics is not None:
            self.metrics.gauge("upload_window_inflight", self._inflight)

    async def submit(self, data: bytes, offset: int) -> None:
        """Queue one chunk; blocks while the window is full. Raises the
        first in-flight failure instead of accepting more work."""
        if self._failed is not None:
            raise self._failed
        t0 = time.monotonic()
        await self._sem.acquire()
        stall = time.monotonic() - t0
        if stall >= 0.001:  # a free-slot acquire is sub-microsecond
            self.stall_s += stall
            if self.metrics is not None:
                self.metrics.count("upload_window_stall_s", stall)
        if self._failed is not None:
            self._sem.release()
            raise self._failed
        self._inflight += 1
        self._gauge()
        self._tasks.append(asyncio.create_task(
            self._run(len(self._tasks), data, offset)))

    async def _run(self, index: int, data: bytes, offset: int):
        try:
            return await self._upload(index, data, offset)
        except BaseException as e:
            if self._failed is None:
                self._failed = e
            raise
        finally:
            self._inflight -= 1
            self._gauge()
            self._sem.release()

    async def drain(self) -> list:
        """Await every in-flight upload; returns their chunks in submit
        order (the caller re-sorts by offset) or raises the first
        failure."""
        if not self._tasks:
            return []
        results = await asyncio.gather(*self._tasks,
                                       return_exceptions=True)
        for r in results:
            if isinstance(r, BaseException):
                raise r
        return list(results)

    async def abort(self) -> None:
        """Cancel whatever is still in flight and wait it out. A chunk
        cancelled mid-POST may or may not have landed — the caller must
        delete every *attempted* fid (a delete of a never-landed fid is a
        benign 404)."""
        for t in self._tasks:
            t.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)
