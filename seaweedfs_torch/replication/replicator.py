"""Replicator: consume filer metadata events and apply them to a sink.

The port's copy of seaweedfs_tpu/replication/replicator.py (upstream
weed/replication/replicator.go): the engine behind both `filer.replicate`
(events from a queue, here the FileQueue spool, or a live subscribe
stream) and `filer.sync` (direct peer subscription with signature-based
loop prevention, weed/command/filer_sync.go:81-330). The source filer is
read through the pooled client (cache/http_pool.py). Logging goes
through ``logging``.
"""

from __future__ import annotations

import json
import logging
import os
import time
import urllib.parse
from typing import Iterator, Optional

from .. import faults
from ..cache.http_pool import shared_pool
from ..filer.entry import Entry
from ..filer.filer import MetaEvent
from ..utils import durable
from ..utils import metrics as metrics_mod
from ..utils.retry import RetryPolicy
from .sink import ReplicationSink

log = logging.getLogger("replication")


class SourceGone(RuntimeError):
    """The source filer answered 404 for an entry's body: the path was
    deleted (or moved) at the source after the event was made."""


class Replicator:
    # transient sink failures are retried from the last good offset; after
    # this many consecutive failures of the SAME event it is treated as
    # poisoned (e.g. create of a path already deleted at the source) and
    # skipped with a loud error, so head-of-line livelock is bounded
    MAX_EVENT_RETRIES = 3

    def __init__(self, source_filer: str, sink: ReplicationSink,
                 source_path_prefix: str = "/",
                 offset_path: str = ""):
        self.source = source_filer.rstrip("/")
        self.sink = sink
        self.prefix = source_path_prefix
        # persisted resume offset so restarts don't replay the whole
        # meta log (reference persists per-source sync offsets,
        # weed/command/filer_sync.go setOffset/getOffset)
        self.offset_path = offset_path

    def load_offset(self) -> int:
        if self.offset_path and os.path.exists(self.offset_path):
            try:
                with open(self.offset_path, encoding="utf-8") as f:
                    return int(json.load(f)["since"])
            except Exception:
                return 0
        return 0

    def save_offset(self, tsns: int) -> None:
        if not self.offset_path:
            return
        durable.write_json_atomic(self.offset_path, {"since": tsns})
        self._last_save = time.monotonic()

    def _maybe_save_offset(self, tsns: int) -> None:
        """Throttled persist: at most ~1/s on the hot path (the reference
        persists offsets periodically too, filer_sync.go setOffset)."""
        if not self.offset_path:
            return
        now = time.monotonic()
        if now - getattr(self, "_last_save", 0.0) >= 1.0:
            self.save_offset(tsns)

    def _fetch_entry_data(self, entry: Entry) -> bytes:
        """Read the file body from the source filer (repl_util chunk fetch
        helpers in the reference; we read through the filer's HTTP API so
        chunk/manifest resolution stays server-side). Chunkless entries
        (empty files, metadata-only events off a queue) have no body to
        fetch.  Rides the shared pool, so the fetch gets keep-alive,
        breaker protection, deadline budgets and priority propagation
        like every other intra-cluster client."""
        if not entry.chunks:
            return b""
        url = f"http://{self.source}" + urllib.parse.quote(entry.full_path)
        r = shared_pool().request("GET", url, timeout=300)
        if r.status == 404:
            raise SourceGone(f"source fetch {entry.full_path}: HTTP 404")
        if r.status != 200:
            raise RuntimeError(f"source fetch {entry.full_path}: "
                               f"HTTP {r.status}")
        return r.data

    def apply(self, event: MetaEvent) -> None:
        if faults.fire("geo.apply"):
            # injected drop: the event vanished mid-apply — surface as
            # a failure so the offset/poison machinery sees it, never a
            # silent skip
            raise faults.FaultError("injected drop at geo.apply")
        old, new = event.old_entry, event.new_entry
        if new is not None and not new.full_path.startswith(self.prefix):
            new = None
        if old is not None and not old.full_path.startswith(self.prefix):
            old = None
        if old is None and new is None:
            return
        sigs = event.signatures
        if new is not None and old is not None:
            self.sink.update_entry(old, new,
                                   lambda: self._fetch_entry_data(new), sigs)
        elif new is not None:
            self.sink.create_entry(new,
                                   lambda: self._fetch_entry_data(new), sigs)
        else:
            self.sink.delete_entry(old, sigs)

    # reconnect backoff for a lost subscribe stream: jittered
    # exponential up to ~15s, reset by any successfully-delivered
    # event — a dead source filer is probed politely instead of at a
    # flat 1 Hz forever, and a fleet of replicators never redials in
    # lockstep
    RECONNECT_POLICY = RetryPolicy(max_attempts=1, base_delay=0.5,
                                   max_delay=15.0, jitter=0.5)

    # --- event sources ---
    def subscribe_events(self, since: int = 0,
                         reconnect: bool = True,
                         exclude_sig: int = 0) -> Iterator[MetaEvent]:
        """Live ndjson stream from the source filer's /__meta__/subscribe.

        Rides the shared pool's streaming face (cache/http_pool.stream):
        breaker-gated, priority/deadline-propagating, and BOUNDED — the
        dial and each idle read have socket timeouts, so a wedged filer
        surfaces as a reconnect instead of a socket parked forever."""
        failures = 0
        while True:
            params = {"since": str(since)}
            if exclude_sig:
                params["exclude_sig"] = str(exclude_sig)
            url = (f"http://{self.source}/__meta__/subscribe?"
                   + urllib.parse.urlencode(params))
            try:
                if faults.fire("geo.stream"):
                    raise ConnectionResetError(
                        "injected drop at geo.stream")
                with shared_pool().stream("GET", url) as r:
                    if r.status != 200:
                        # urlopen raised HTTPError here; the pooled
                        # stream hands back the status — an error body
                        # must never be iterated as ndjson
                        raise RuntimeError(f"subscribe: HTTP {r.status}")
                    for line in r:
                        line = line.strip()
                        if not line:
                            continue
                        e = MetaEvent.from_dict(json.loads(line))
                        since = e.tsns
                        failures = 0
                        yield e
            except Exception as ex:
                if not reconnect:
                    return
                delay = self.RECONNECT_POLICY.backoff(min(failures, 5))
                failures += 1
                log.warning("subscribe to %s lost: %s (retrying in "
                             "%.1fs)", self.source, ex, delay)
                time.sleep(delay)

    def run(self, since: int = 0, max_events: Optional[int] = None,
            stop_check=None, exclude_sig: int = 0) -> int:
        """Consume the live stream and apply each event. Returns the count
        applied (bounded runs are for tests). Resumes from the persisted
        offset when one exists and no explicit `since` is given.

        The offset only advances past events that applied successfully;
        on a sink failure the subscription is torn down and re-established
        from the last good offset after a backoff, so a transiently
        unreachable sink never loses events (the reference likewise only
        advances after the event fn succeeds, filer_sync.go
        processEventFnWithOffset)."""
        applied = 0
        if since == 0:
            since = self.load_offset()
        reconnect = max_events is None
        fail_tsns, fail_count = 0, 0
        while True:
            resubscribe = False
            for e in self.subscribe_events(since, reconnect=reconnect,
                                           exclude_sig=exclude_sig):
                if stop_check is not None and stop_check():
                    break
                try:
                    self.apply(e)
                except Exception as ex:
                    fail_count = fail_count + 1 if e.tsns == fail_tsns else 1
                    fail_tsns = e.tsns
                    if fail_count >= self.MAX_EVENT_RETRIES:
                        # poison event: a transient sink outage would have
                        # recovered by now — skip it (loudly) rather than
                        # livelock every event behind it
                        log.error(
                            "replicate event at %d failed %d times: %s — "
                            "SKIPPING (entry may be missing at sink)",
                            e.tsns, fail_count, ex)
                        since = e.tsns
                        self._maybe_save_offset(e.tsns)
                        continue
                    log.error("replicate event at %d failed: %s "
                               "(retry %d/%d from last good offset)",
                               e.tsns, ex, fail_count,
                               self.MAX_EVENT_RETRIES)
                    resubscribe = True
                    break
                applied += 1
                since = e.tsns
                self._maybe_save_offset(e.tsns)
                if max_events is not None and applied >= max_events:
                    break
            self.save_offset(since)
            if not resubscribe or not reconnect:
                break
            if stop_check is not None and stop_check():
                break
            time.sleep(1.0)
        return applied


def run_from_queue(replicator: "Replicator", inp,
                   idle_timeout: float = 1.0, stop_check=None) -> int:
    """Apply queued filer events to the replicator's sink until the queue
    idles — the queue-fed `filer.replicate` mode (upstream consumes
    Kafka/SQS via weed/replication/sub; here the file spool via
    replication.sub).

    An event whose body the source no longer has (``SourceGone``: a
    queued create whose path was deleted since) is skipped at once,
    loudly: no retry brings it back, and the event that deleted or moved
    the path is further down the queue. Any other failure is retried as
    live mode retries it, 1 s apart, and skipped loudly after
    ``MAX_EVENT_RETRIES`` failures. The reference raises out of the loop
    on the first failure and never gets past the event (ROADMAP Queue 3,
    D27)."""
    from .sub import iter_queue
    applied = 0
    for ev in iter_queue(inp, idle_timeout=idle_timeout,
                         stop_check=stop_check):
        for attempt in range(1, replicator.MAX_EVENT_RETRIES + 1):
            try:
                # apply() prefix-filters on full_path exactly like live
                # mode
                replicator.apply(ev)
            except Exception as ex:
                if isinstance(ex, SourceGone) or \
                        attempt == replicator.MAX_EVENT_RETRIES:
                    metrics_mod.shared("replication").count(
                        "replication_skipped_queue_events")
                    log.error("queued event at %d failed %d times: %s — "
                              "SKIPPING (entry may be missing at sink)",
                              ev.tsns, attempt, ex)
                    break
                log.error("queued event at %d failed: %s (retry %d/%d)",
                          ev.tsns, ex, attempt,
                          replicator.MAX_EVENT_RETRIES)
                time.sleep(1.0)
                continue
            applied += 1
            break
    return applied


def consume_spool_file(path: str) -> Iterator[MetaEvent]:
    """Read a FileQueue spool file (the queue-consumer side of
    weed/replication/sub/ for the local 'file' queue).  A corrupt line
    is SKIPPED LOUDLY — log.error + a replication_corrupt_events
    count — never swallowed: a torn spool write that silently dropped
    mutations would surface as replica divergence weeks later."""
    with open(path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                yield MetaEvent.from_dict(json.loads(line))
            except Exception as e:
                metrics_mod.shared("replication").count(
                    "replication_corrupt_events")
                log.error("spool %s line %d: corrupt event (%s) — "
                           "SKIPPING one mutation", path, lineno, e)
