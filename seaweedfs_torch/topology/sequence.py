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

``KvSequencer`` (an external KV's atomic counter, upstream's
etcd_sequencer.go) needs the filer's RESP client and waits for the filer
slice.
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
