"""BucketReplicator: one cluster-to-cluster replication job.

The port's copy of seaweedfs_tpu/geo/replicate.py. Tails the source
filer's ``/__meta__/subscribe`` stream for one bucket and applies every
mutation to the remote cluster through a
:class:`~seaweedfs_torch.geo.cluster_sink.ClusterSink`, fanned across an
:class:`~seaweedfs_torch.geo.applier.ApplierPool`.

Durability contract (the sync replicator's): the resume offset, kept as
a chunkless filer entry under ``/buckets/.geo/`` on the SOURCE filer so
it survives master restarts and filer failovers with the filer store,
only advances past events whose apply completed (a low-watermark over
the parallel pool). Kill the job, the replica, or the whole master at
any point: the next connect resumes from the last committed offset and
re-applies at most the in-flight window; applies are idempotent upserts,
so convergence is byte-exact with zero loss and bounded re-apply.

A bucket whose rule appears with no stored offset is *backfilled* first:
the job walks the source tree and upserts every entry, then starts the
live tail from a timestamp taken BEFORE the walk, so events raced during
the backfill replay afterwards and converge.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Optional

import aiohttp

from .. import faults, observe, overload
from ..filer.filer import MetaEvent
from ..filer.netutil import iter_ndjson as _netutil_iter_ndjson
from ..lifecycle import jittered
from . import OFFSET_DIR, GeoConfig
from .applier import ApplierPool
from .cluster_sink import ClusterSink, entry_from_dict

log = logging.getLogger("geo")


class BucketReplicator:
    def __init__(self, source_filer: str, bucket: str, rule: dict,
                 cfg: GeoConfig, metrics=None, leader_check=None):
        self.source_filer = source_filer
        self.bucket = bucket
        self.rule = rule
        self.cfg = cfg
        self.metrics = metrics
        self.leader_check = leader_check or (lambda: True)
        self.endpoint = rule.get("endpoint") or cfg.peer
        self.dest_bucket = rule.get("dest_bucket") or bucket
        self.state = "pending"
        self.last_error = ""
        self.offset = 0
        self.applied = 0
        self.skipped = 0
        self.poisoned = 0
        self.backfilled = 0
        # stream teardown/reconnect count (transport failures, retried
        # events) — the denominator behind "bounded re-apply"
        self.restarts = 0
        # seconds behind the source at the last applied event; 0.0
        # when fully drained
        self.lag_s = 0.0
        self._last_tsns = 0
        self._task: Optional[asyncio.Task] = None
        self._stopped = False
        self._last_save = 0.0
        # tsns -> consecutive event-specific failures, surviving stream
        # teardowns (the pool's poison bookkeeping lives here so a
        # reconnect can't reset the count)
        self._fail_counts: dict[int, int] = {}
        # the live applier pool while a stream is up — status() reads
        # its counters directly so in-flight applies aren't invisible
        self._pool: Optional[ApplierPool] = None

    # --- lifecycle ---

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._stopped = False
            self._task = asyncio.create_task(self.run_job_loop())

    async def stop(self) -> None:
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None
        self.state = "stopped"

    @property
    def running(self) -> bool:
        return self._task is not None and not self._task.done()

    def status(self) -> dict:
        pool = self._pool
        if pool is not None:
            self.applied, self.skipped, self.poisoned = \
                pool.applied, pool.skipped, pool.poisoned
        return {
            "bucket": self.bucket,
            "endpoint": self.endpoint,
            "dest_bucket": self.dest_bucket,
            "prefix": self.rule.get("prefix", ""),
            "state": self.state,
            "offset": self.offset,
            "applied": self.applied,
            "skipped": self.skipped,
            "poisoned": self.poisoned,
            "backfilled": self.backfilled,
            "restarts": self.restarts,
            "lag_s": round(self.lag_s, 3),
            "last_error": self.last_error,
        }

    # --- the job loop ---

    async def run_job_loop(self) -> None:
        # replication is background by definition: every source fetch
        # and remote write sheds first under load, and the priority
        # header rides each hop
        overload.set_priority(overload.CLASS_BG)
        failures = 0
        while not self._stopped and self.leader_check():
            try:
                await self._connect_and_stream()
                failures = 0
            except asyncio.CancelledError:
                raise
            except Exception as e:
                failures += 1
                self.restarts += 1
                self.last_error = str(e)
                self.state = "reconnecting"
            await asyncio.sleep(jittered(
                min(0.2 * (2 ** min(failures, 6)), 15.0)))
        self.state = "stopped"

    async def _connect_and_stream(self) -> None:
        if not self.endpoint:
            self.state = "misconfigured"
            raise RuntimeError(
                f"bucket {self.bucket}: replication rule has no "
                f"Destination/Endpoint and WEED_GEO_PEER is unset")
        self.state = "connecting"
        session = aiohttp.ClientSession(
            # streaming tail: inactivity-bounded, never total-bounded
            timeout=aiohttp.ClientTimeout(total=None, sock_connect=10,
                                          sock_read=self.cfg.stream_idle_s),
            trace_configs=[observe.client_trace_config()])
        try:
            sink = ClusterSink(session, self.endpoint, self.dest_bucket,
                               self.source_filer, self.bucket,
                               prefix=self.rule.get("prefix", ""))
            remote_sig = await sink.signature()
            source_sig = await self._source_signature(session)
            self.offset = await self._load_offset(session)
            if self.offset == 0 and self.cfg.backfill:
                await self._backfill(session, sink, source_sig)
            pool = ApplierPool(sink.apply, workers=self.cfg.appliers,
                               queue_depth=self.cfg.queue_depth,
                               max_retries=self.cfg.max_event_retries,
                               metrics=self.metrics, bucket=self.bucket,
                               fail_counts=self._fail_counts)
            pool.applied, pool.skipped, pool.poisoned = \
                self.applied, self.skipped, self.poisoned
            pool.committed = self.offset
            pool.on_commit = lambda tsns: setattr(self, "offset", tsns)
            pool.start()
            self._pool = pool
            try:
                await self._stream_into(session, sink, pool, remote_sig)
            finally:
                try:
                    await pool.drain()
                except asyncio.CancelledError:
                    raise
                except Exception:
                    pass
                await pool.stop()
                self.applied, self.skipped, self.poisoned = \
                    pool.applied, pool.skipped, pool.poisoned
                self._pool = None
                await self._save_offset(session, self.offset, force=True)
        finally:
            await session.close()

    async def _stream_into(self, session, sink: ClusterSink,
                           pool: ApplierPool, remote_sig: int) -> None:
        if await faults.fire_async("geo.stream"):
            raise ConnectionResetError("injected drop at geo.stream")
        params = {"since": str(self.offset),
                  "prefix": f"/buckets/{self.bucket}",
                  "exclude_sig": str(remote_sig)}
        async with session.get(
                f"http://{self.source_filer}/__meta__/subscribe",
                params=params) as r:
            if r.status != 200:
                raise RuntimeError(f"subscribe: HTTP {r.status}")
            self.state = "streaming"
            # race the (possibly idle for minutes) line reader against
            # applier aborts: an apply failure must tear the stream
            # down NOW, not at the next event / idle timeout
            reader = asyncio.create_task(
                self._read_lines(session, r, sink, pool))
            abort = asyncio.create_task(pool.abort_event.wait())
            done, pending = await asyncio.wait(
                {reader, abort}, return_when=asyncio.FIRST_COMPLETED)
            for t in pending:
                t.cancel()
            # collect both (return_exceptions folds the cancelled
            # loser in; OUR own cancellation still propagates)
            await asyncio.gather(reader, abort,
                                 return_exceptions=True)
            if pool.aborted is not None:
                # an applier hit a transport/retriable failure (or a
                # not-yet-poisoned event failure): tear the whole
                # stream down and resume from the committed offset
                raise RuntimeError(f"applier abort: {pool.aborted}")
            if reader in done:
                exc = reader.exception()
                if exc is not None and \
                        not isinstance(exc, asyncio.CancelledError):
                    raise exc

    # manual line split: aiohttp's line iterator raises
    # ValueError('Chunk too big') past ~128KB, and a meta event for a
    # many-chunk entry easily exceeds that — the stream would tear
    # down, reconnect at the same offset, and redeliver the same
    # oversized line forever (a livelock the poison machinery never
    # sees, since it only counts APPLY failures)
    _iter_ndjson = staticmethod(_netutil_iter_ndjson)

    async def _read_lines(self, session, r, sink: ClusterSink,
                          pool: ApplierPool) -> None:
        async for line in self._iter_ndjson(r.content):
            line = line.strip()
            if not line:
                continue
            if self._stopped or not self.leader_check():
                return
            try:
                e = MetaEvent.from_dict(json.loads(line))
            except Exception as ex:
                # a malformed line can't be skipped by offset (no
                # tsns to advance past) — skip it loudly and keep the
                # connect's forward progress; a reconnect may redeliver
                # it, which the log makes visible instead of silent
                log.error("geo: bucket %s: corrupt subscribe line "
                           "(%d bytes): %s — SKIPPING one event",
                           self.bucket, len(line), ex)
                pool.count_skipped()
                continue
            self._observe_lag(e.tsns, pool)
            admitted = any(
                ent is not None and sink.admits(ent.full_path,
                                                ent.is_directory)
                for ent in (e.old_entry, e.new_entry))
            if not admitted:
                # subscribe prefixes are directory-string matches:
                # bucket "b" sees bucket "b2" too — count + advance
                # the watermark, never apply
                pool.count_skipped(e.tsns)
            else:
                await pool.submit(e)
            self.applied, self.skipped, self.poisoned = \
                pool.applied, pool.skipped, pool.poisoned
            await self._save_offset(session, self.offset)

    def _observe_lag(self, tsns: int, pool: ApplierPool) -> None:
        now = time.time_ns()
        self.lag_s = max(0.0, (now - tsns) / 1e9)
        self._last_tsns = max(self._last_tsns, tsns)
        if self.metrics is not None:
            self.metrics.gauge("geo_replication_lag_s", self.lag_s,
                               labels={"bucket": self.bucket})

    def current_lag_s(self) -> float:
        """Seconds the replica trails the source: the age of the last
        seen event, 0 when every seen event has committed."""
        if self.state == "streaming" and self.offset >= self._last_tsns:
            return 0.0
        return self.lag_s

    # --- offsets (filer-entry persistence) ---

    def _offset_path(self) -> str:
        # keyed on the FULL job identity — endpoint, destination, and
        # the rule's key prefix: widening Prefix must start a fresh
        # offset (and therefore a backfill of the newly-included keys),
        # not resume past them
        safe = (f"{self.bucket}@{self.endpoint}_{self.dest_bucket}"
                f"_{self.rule.get('prefix', '')}") \
            .replace(":", "_").replace("/", "_")
        return f"{OFFSET_DIR}/{safe}"

    async def _load_offset(self, session) -> int:
        async with session.get(
                f"http://{self.source_filer}/__meta__/lookup",
                params={"path": self._offset_path()}) as r:
            if r.status != 200:
                return 0
            entry = await r.json()
        try:
            return int((entry.get("extended") or {}).get("offset", "0"))
        except ValueError:
            return 0

    async def _save_offset(self, session, tsns: int,
                           force: bool = False) -> None:
        """Throttled durable offset (at most ~1/s on the hot path, the
        same cadence the sync replicator persists at)."""
        if not tsns:
            return
        now = time.monotonic()
        if not force and now - self._last_save < 1.0:
            return
        self._last_save = now
        entry = {"path": self._offset_path(),
                 "attr": {"mode": 0o600, "mtime": time.time(),
                          "crtime": time.time()},
                 "chunks": [],
                 "extended": {"offset": str(tsns)}}
        async with session.post(
                f"http://{self.source_filer}/__meta__/create_entry",
                json={"entry": entry}) as r:
            await r.read()

    async def _source_signature(self, session) -> int:
        async with session.get(
                f"http://{self.source_filer}/__meta__/info") as r:
            return int((await r.json())["signature"])

    # --- backfill (rule created over an existing bucket) ---

    async def _backfill(self, session, sink: ClusterSink,
                        source_sig: int) -> None:
        """Copy the pre-rule tree, then tail from a timestamp taken
        BEFORE the walk so mutations raced during it replay after.
        Upserts carry the source filer's signature, so an active/active
        peer's subscription filters the resulting remote events instead
        of replaying them back."""
        self.state = "backfilling"
        t0 = time.time_ns()
        base = f"/buckets/{self.bucket}"
        if await sink.lookup_source(base) is None:
            # rule on a bucket that doesn't exist yet: nothing to copy
            self.offset = t0
            await self._save_offset(session, t0, force=True)
            return
        sem = asyncio.Semaphore(self.cfg.appliers)

        async def copy_one(entry_dict: dict) -> None:
            async with sem:
                with observe.span("geo.apply",
                                  tags={"bucket": self.bucket,
                                        "backfill": 1}):
                    await sink.upsert_entry(entry_from_dict(entry_dict),
                                            signatures=(source_sig,))
            self.backfilled += 1

        async def walk(dir_path: str) -> None:
            start = ""
            while True:
                entries = await sink.list_source(dir_path, start)
                files, dirs = [], []
                for e in entries:
                    is_dir = bool(
                        e.get("attr", {}).get("mode", 0) & 0o40000)
                    # the rule's key prefix bounds the backfill too
                    if not sink.admits(e["path"], is_dir):
                        continue
                    if is_dir:
                        dirs.append(e)
                    else:
                        files.append(e)
                # dirs upsert before their children (mkdir is cheap and
                # the remote filer auto-creates parents anyway)
                for e in dirs:
                    await copy_one(e)
                    await walk(e["path"])
                await asyncio.gather(*(copy_one(e) for e in files))
                if len(entries) < 512:
                    return
                start = entries[-1]["path"].rsplit("/", 1)[-1]

        await walk(base)
        self.offset = t0
        await self._save_offset(session, t0, force=True)
