"""Parallel event applier pool with per-directory ordering.

The port's copy of seaweedfs_tpu/geo/applier.py. The sync replicator
(replication/replicator.py) applies one event at a time; cross-cluster
links have enough latency that serial apply caps throughput at ~1/RTT.
This pool fans events across N workers while keeping the one ordering
that matters: events for the same directory (and therefore the same
path: a path's events always share a parent) are hashed to the same
worker and applied FIFO, so create/overwrite/delete of one object can
never land out of order. Cross-directory ordering is relaxed: the sink
re-fetches object bytes from the source BY PATH, so late applies
converge to current content.

Offset semantics are the sync replicator's low-watermark: the committed
offset only advances past an event once IT AND EVERY EVENT BEFORE IT
have completed (applied, skipped, or loudly poisoned), so a crash or
restart re-applies at most the in-flight window and loses nothing.
Poison events (failures that survive ``max_retries`` attempts) are
skipped with a log error and a ``geo_events_poisoned`` count instead of
wedging the whole stream behind one bad event.
"""

from __future__ import annotations

import asyncio
import logging
from collections import OrderedDict
from typing import Awaitable, Callable, Optional

import aiohttp

from .. import faults, observe, overload
from ..filer.filer import MetaEvent
from .cluster_sink import SinkBusy

log = logging.getLogger("geo")

# the sink couldn't reach the remote cluster at all, or the remote
# answered busy (shed/5xx): nothing event-specific about either, so
# these never count toward poison — the stream tears down, reconnects
# with backoff, and resumes from the committed offset (zero loss
# however long the replica stays dead or overloaded)
_TRANSPORT_ERRORS = (aiohttp.ClientError, asyncio.TimeoutError, OSError,
                     SinkBusy)


class ApplierPool:
    def __init__(self, apply_fn: Callable[[MetaEvent], Awaitable[None]],
                 workers: int = 4, queue_depth: int = 128,
                 max_retries: int = 3, metrics=None, bucket: str = "",
                 on_commit: Optional[Callable[[int], None]] = None,
                 fail_counts: Optional[dict] = None):
        self.apply_fn = apply_fn
        self.workers = max(1, workers)
        self.max_retries = max(1, max_retries)
        self.metrics = metrics
        self.bucket = bucket
        self.on_commit = on_commit
        # tsns -> consecutive failures, owned by the CALLER so counts
        # survive stream teardowns: the same event failing
        # max_retries times across reconnects is what poisons, exactly
        # the sync replicator's fail_tsns/fail_count bookkeeping
        self.fail_counts = fail_counts if fail_counts is not None else {}
        # a failure that should tear the stream down (transport error,
        # or a not-yet-poisoned event failure): the stream reader races
        # abort_event against the (possibly idle) stream and reconnects
        # from the committed offset
        self.aborted: Optional[Exception] = None
        self.abort_event = asyncio.Event()
        self._queues = [asyncio.Queue(maxsize=max(1, queue_depth))
                        for _ in range(self.workers)]
        self._tasks: list[asyncio.Task] = []
        # tsns -> done, in arrival (= stream) order; the committed
        # offset is the largest contiguous done prefix
        self._pending: "OrderedDict[int, bool]" = OrderedDict()
        self.committed = 0
        self.applied = 0
        self.skipped = 0
        self.poisoned = 0

    def start(self) -> None:
        if self._tasks:
            return
        self._tasks = [asyncio.create_task(self._worker_loop(i))
                       for i in range(self.workers)]

    async def submit(self, event: MetaEvent) -> None:
        """Enqueue one stream event; blocks (backpressures the stream
        reader) when the target worker's queue is full.

        Ordering: events hash on their directory, so one path's
        create/overwrite/delete serialize on one worker.  A RENAME
        touches TWO directories (old_entry's parent and the event
        directory) — no single hash serializes with both, so
        cross-directory events are applied under a full barrier:
        drain, apply alone, drain.  Renames are rare; correctness
        beats the lost parallelism."""
        old, new = event.old_entry, event.new_entry
        cross_dir = (old is not None and new is not None
                     and old.parent != new.parent)
        self._pending[event.tsns] = False
        if cross_dir:
            await self.drain()
            await self._queues[0].put(event)
            await self.drain()
            return
        idx = hash(event.directory) % self.workers
        await self._queues[idx].put(event)

    def count_skipped(self, tsns: int = 0) -> None:
        """Record an event the caller filtered before submit (outside
        the replicated prefix, already-applied replay) — it still
        advances the offset watermark when it carries a tsns."""
        self.skipped += 1
        self._count("geo_events_skipped")
        if tsns:
            self._pending[tsns] = True
            self._advance()

    async def drain(self) -> None:
        """Wait until every submitted event has completed."""
        for q in self._queues:
            await q.join()

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        # return_exceptions folds the workers' CancelledErrors into the
        # result list; OUR own cancellation still propagates
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []

    # --- internals ---

    async def _worker_loop(self, idx: int) -> None:
        # replication traffic is background by definition: every write
        # this worker fans out to the remote cluster sheds first there
        overload.set_priority(overload.CLASS_BG)
        q = self._queues[idx]
        while True:
            event = await q.get()
            try:
                await self._apply_one(event)
            finally:
                q.task_done()

    async def _apply_one(self, event: MetaEvent) -> None:
        if self.aborted is not None:
            # the stream is tearing down: leave the event UN-done so
            # the watermark stays put and the reconnect re-delivers it
            return
        try:
            if await faults.fire_async("geo.apply"):
                # injected drop: the chaos suite's "applier lost the
                # event mid-flight" — it must surface as a failure,
                # never a silent skip
                raise faults.FaultError("injected drop at geo.apply")
            with observe.span("geo.apply",
                              tags={"bucket": self.bucket,
                                    "dir": event.directory}):
                await self.apply_fn(event)
        except asyncio.CancelledError:
            raise
        except _TRANSPORT_ERRORS as e:
            self._abort(e)
            return
        except Exception as e:
            n = self.fail_counts.get(event.tsns, 0) + 1
            self.fail_counts[event.tsns] = n
            if n < self.max_retries:
                # not poison YET: tear down and retry from the
                # committed offset (exactly processEventFnWithOffset's
                # only-advance-past-success contract)
                log.error("geo: event at %d (dir %s) failed: %s "
                           "(retry %d/%d from last good offset)",
                           event.tsns, event.directory, e, n,
                           self.max_retries)
                self._abort(e)
                return
            # poison: the SAME event failed max_retries times across
            # reconnects — a transient sink outage never looks like
            # this (transport errors don't count) — skip LOUDLY rather
            # than livelock every event behind it
            self.fail_counts.pop(event.tsns, None)
            self.poisoned += 1
            self._count("geo_events_poisoned")
            log.error("geo: event at %d (dir %s) failed %d times: %s "
                       "— SKIPPING (entry may be missing at the "
                       "replica)", event.tsns, event.directory,
                       self.max_retries, e)
            self._mark_done(event.tsns)
            return
        self.fail_counts.pop(event.tsns, None)
        self.applied += 1
        self._count("geo_events_applied")
        self._mark_done(event.tsns)

    def _abort(self, e: Exception) -> None:
        if self.aborted is None:
            self.aborted = e
        self.abort_event.set()

    def _count(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.count(name, labels={"bucket": self.bucket})

    def _mark_done(self, tsns: int) -> None:
        if tsns in self._pending:
            self._pending[tsns] = True
        self._advance()

    def _advance(self) -> None:
        moved = False
        while self._pending:
            tsns, done = next(iter(self._pending.items()))
            if not done:
                break
            self._pending.popitem(last=False)
            self.committed = tsns
            moved = True
        if moved and self.on_commit is not None:
            self.on_commit(self.committed)
