"""In-memory message log with time-based offsets, subscriber fanout, and
segment flush: the role of weed/util/log_buffer/log_buffer.go:41. The
port's copy of seaweedfs_tpu/utils/log_buffer.py.

Entries are (ts_ns, key, value, headers). A flush callback receives full
segments (list of entries) when the buffer exceeds its size threshold or
on explicit flush; readers replay memory since a timestamp and register
for live fanout. The filer's meta log and the messaging broker's topic
partitions both sit on this structure in the reference.

A segment handed to the flush callback stays readable through
``read_since`` until ``persisted(segment)`` says it landed, so a flush
callback calls ``persisted`` once its segment is written (or given up
on): a reader between the two would find it neither in memory nor where
it is persisted otherwise (the reference's broker loses it so, ROADMAP
Queue 3, D31). Entries cut into a segment and those still in memory are
read under one lock, so a reader sees every entry once, in order.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class LogEntry:
    ts_ns: int
    key: bytes
    value: bytes
    headers: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        import base64
        return {"ts": self.ts_ns,
                "key": base64.b64encode(self.key).decode(),
                "value": base64.b64encode(self.value).decode(),
                "headers": self.headers}

    @classmethod
    def from_dict(cls, d: dict) -> "LogEntry":
        import base64
        return cls(ts_ns=int(d["ts"]),
                   key=base64.b64decode(d.get("key", "")),
                   value=base64.b64decode(d.get("value", "")),
                   headers=d.get("headers", {}))


class LogBuffer:
    def __init__(self,
                 flush_fn: Optional[Callable[[list[LogEntry]], None]] = None,
                 flush_bytes: int = 4 * 1024 * 1024,
                 retention: int = 65536):
        self._entries: list[LogEntry] = []
        # segments handed to flush_fn whose persistence is not confirmed
        self._unpersisted: list[list[LogEntry]] = []
        self._bytes = 0
        self._lock = threading.Lock()
        self._subscribers: list[Callable[[LogEntry], None]] = []
        self.flush_fn = flush_fn
        self.flush_bytes = flush_bytes
        self.retention = retention
        self.last_ts_ns = 0

    def add(self, key: bytes, value: bytes,
            headers: Optional[dict] = None,
            ts_ns: int = 0) -> LogEntry:
        with self._lock:
            ts = ts_ns or time.time_ns()
            # strictly monotonic so a timestamp is a unique offset
            if ts <= self.last_ts_ns:
                ts = self.last_ts_ns + 1
            self.last_ts_ns = ts
            e = LogEntry(ts, key, value, headers or {})
            self._entries.append(e)
            self._bytes += len(key) + len(value) + 32
            flush_now = (self.flush_fn is not None
                         and self._bytes >= self.flush_bytes)
            if flush_now:
                segment, self._entries = self._entries, []
                self._bytes = 0
                self._unpersisted.append(segment)
            if len(self._entries) > self.retention:
                self._entries = self._entries[-self.retention:]
            subs = list(self._subscribers)
        if flush_now:
            self.flush_fn(segment)
        for fn in subs:
            try:
                fn(e)
            except Exception:
                pass
        return e

    def flush(self) -> None:
        with self._lock:
            if self.flush_fn is None or not self._entries:
                return
            segment, self._entries = self._entries, []
            self._bytes = 0
            self._unpersisted.append(segment)
        self.flush_fn(segment)

    def persisted(self, segment: list[LogEntry]) -> None:
        """A segment handed to flush_fn landed (or was given up on)."""
        with self._lock:
            self._unpersisted = [s for s in self._unpersisted
                                 if s is not segment]

    def read_since(self, ts_ns: int) -> list[LogEntry]:
        with self._lock:
            return [e for seg in self._unpersisted + [self._entries]
                    for e in seg if e.ts_ns > ts_ns]

    def subscribe(self, fn: Callable[[LogEntry], None]) -> None:
        with self._lock:
            self._subscribers.append(fn)

    def unsubscribe(self, fn: Callable[[LogEntry], None]) -> None:
        with self._lock:
            if fn in self._subscribers:
                self._subscribers.remove(fn)
