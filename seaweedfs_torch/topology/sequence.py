"""Needle-key sequencer (upstream weed/sequence/memory_sequencer.go).

The port's copy of ``MemorySequencer`` from
seaweedfs_tpu/topology/sequence.py. The port runs a single master with no
raft, so its keys come from memory: monotonically increasing, handed out
in batches, and raised by ``set_max`` with the ``max_file_key`` of every
volume server heartbeat. A restarted master therefore never hands out a
key that a volume already holds, once the volumes have reported in.
"""

from __future__ import annotations

import threading


class MemorySequencer:
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
