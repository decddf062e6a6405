"""Needle-key sequencers (upstream weed/sequence/).

The port's copy of seaweedfs_tpu/topology/sequence.py:

- ``LogSequencer``, the master's: a face over the replicated metadata log
  (metaring/masterlog.py). Keys are minted by raft log entries
  (``{"assign_batch": ...}``) whose apply computes the first key from
  the replicated counter, so a newly elected leader resumes exactly
  after the last committed batch. Heartbeats' ``max_file_key`` reach it
  as replicated floors (``seq_floor``), proposed by the master.
- ``MemorySequencer`` (memory_sequencer.go): keys from memory, raised by
  ``set_max``, for one process that needs no replication; the master no
  longer uses it.
- ``KvSequencer`` (upstream etcd_sequencer.go's role): key ranges leased
  from an external KV's atomic counter (``INCRBY`` over the redis
  protocol), so masters without raft mint unique keys. Its calls are KV
  round trips (``blocking``): the master makes them in its executor.
"""

from __future__ import annotations

import threading


class MemorySequencer:
    blocking = False

    def __init__(self, start: int = 1):
        self._next = max(start, 1)
        self._lock = threading.Lock()

    def next_file_id(self, count: int = 1) -> int:
        """Returns the first id of a batch of `count` consecutive ids."""
        with self._lock:
            first = self._next
            self._next += count
            return first

    def set_max(self, seen: int) -> None:
        with self._lock:
            if seen >= self._next:
                self._next = seen + 1

    def peek(self) -> int:
        return self._next


class LogSequencer:
    """The sequencer's surface over ``MasterMetaLog``: ``peek`` for the
    status pages, ``set_max`` a no-op (floors ride the log). It mints
    nothing itself: a key minted outside the log would fork the
    replicated counter."""

    blocking = False
    replicated = True   # the master mints through the raft log

    def __init__(self, metalog):
        self._log = metalog

    def next_file_id(self, count: int = 1) -> int:
        raise RuntimeError(
            "LogSequencer mints through the raft metadata log "
            "(assign_batch); a direct next_file_id would fork the "
            "replicated counter")

    def set_max(self, seen: int) -> None:
        # the master proposes floors (seq_floor); changing the applied
        # state outside raft's apply would make the replicas diverge
        return

    def peek(self) -> int:
        return self._log.next_key


class KvSequencer:
    """Keys from ranges leased off a shared atomic counter: the local
    range [current, lease_end) serves allocations, and a dry range
    leases the next batch in one ``INCRBY``. One socket, opened at the
    first call and opened again once if it breaks (a KV restart or an
    idle reset must not wedge minting)."""

    BATCH = 500  # DefaultEtcdSteps upstream
    blocking = True

    def __init__(self, host: str, port: int,
                 key: str = "master/sequence", batch: int = 0):
        self._addr = (host, port)
        self._client = None
        self._key = key
        self._batch = batch or self.BATCH
        self._lock = threading.Lock()
        self._current = 0
        self._lease_end = 0

    def _cmd(self, *parts):
        from ..filer.redis_store import _RespClient
        for attempt in (0, 1):
            try:
                if self._client is None:
                    self._client = _RespClient(*self._addr)
                return self._client.command(*parts)
            except (ConnectionError, OSError):
                if self._client is not None:
                    self._client.close()
                self._client = None
                if attempt:
                    raise

    def _lease(self, at_least: int = 1) -> None:
        step = max(self._batch, at_least)
        end = int(self._cmd("INCRBY", self._key, step))
        self._current = end - step + 1
        self._lease_end = end + 1

    def next_file_id(self, count: int = 1) -> int:
        with self._lock:
            if self._current + count > self._lease_end:
                self._lease(count)
            first = self._current
            self._current += count
            return first

    def set_max(self, seen: int) -> None:
        """No future lease mints at or below `seen` (a cold start against
        a reset counter). The current lease stays, as the reference's
        does: leased ranges are disjoint while the counter only grows,
        but after a reset another sequencer raised to `seen` can lease
        keys this one still holds (ROADMAP Queue 3, D20)."""
        with self._lock:
            if seen < self._lease_end:
                if seen >= self._current:
                    self._current = seen + 1
                return
            cur = int(self._cmd("GET", self._key) or b"0")
            if seen > cur:
                self._cmd("INCRBY", self._key, seen - cur)

    def peek(self) -> int:
        return self._current

    def close(self) -> None:
        client, self._client = self._client, None
        if client is not None:
            client.close()
