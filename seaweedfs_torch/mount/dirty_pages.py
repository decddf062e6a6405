"""Write-back cache intervals for the mount layer.

The port's copy of seaweedfs_tpu/mount/dirty_pages.py, with
``truncate`` added for the mount's truncate of an open file (ROADMAP
Queue 3, D22). Mirrors weed/filesys/dirty_page_interval.go: written byte ranges are kept
as a list of non-overlapping intervals where NEWER writes win over older
overlapping data; contiguous runs are flushed as chunks. The interval
algebra here is the pure-logic core the reference unit-tests heavily
(dirty_page_interval_test.go) — kernel FUSE glue stays thin above it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class Interval:
    start: int          # inclusive byte offset
    data: bytes

    @property
    def stop(self) -> int:
        return self.start + len(self.data)


class ContinuousIntervals:
    """Non-overlapping, sorted intervals; AddInterval semantics of
    weed/filesys/dirty_page_interval.go:60 (new data overwrites old)."""

    def __init__(self):
        self.intervals: list[Interval] = []

    def add_interval(self, data: bytes, offset: int) -> None:
        if not data:
            return
        new = Interval(offset, bytes(data))
        out: list[Interval] = []
        for iv in self.intervals:
            if iv.stop <= new.start or iv.start >= new.stop:
                out.append(iv)
                continue
            # overlap: keep the non-overlapped parts of the OLD interval
            if iv.start < new.start:
                out.append(Interval(iv.start,
                                    iv.data[:new.start - iv.start]))
            if iv.stop > new.stop:
                out.append(Interval(new.stop,
                                    iv.data[new.stop - iv.start:]))
        out.append(new)
        out.sort(key=lambda i: i.start)
        # coalesce adjacent runs so flushes produce few large chunks
        merged: list[Interval] = []
        for iv in out:
            if merged and merged[-1].stop == iv.start:
                merged[-1] = Interval(merged[-1].start,
                                      merged[-1].data + iv.data)
            else:
                merged.append(iv)
        self.intervals = merged

    def total_size(self) -> int:
        return max((iv.stop for iv in self.intervals), default=0)

    def buffered_bytes(self) -> int:
        return sum(len(iv.data) for iv in self.intervals)

    def read_data_at(self, size: int, offset: int) -> tuple[bytes, bytes]:
        """Assemble dirty data over [offset, offset+size); gaps are zeroes
        only where some later interval exists (reads merge with remote
        content above this layer)."""
        buf = bytearray(size)
        mask = bytearray(size)
        for iv in self.intervals:
            lo = max(iv.start, offset)
            hi = min(iv.stop, offset + size)
            if lo >= hi:
                continue
            buf[lo - offset:hi - offset] = iv.data[lo - iv.start:
                                                   hi - iv.start]
            for i in range(lo - offset, hi - offset):
                mask[i] = 1
        return bytes(buf), bytes(mask)

    def pop_largest_contiguous(self) -> Optional[Interval]:
        """Remove and return the largest interval (saveExistingLargestPage
        in dirty_page.go — flushed as one chunk when memory pressure
        demands)."""
        if not self.intervals:
            return None
        largest = max(self.intervals, key=lambda i: len(i.data))
        self.intervals.remove(largest)
        return largest

    def truncate(self, length: int) -> None:
        """Drop every buffered byte at or past `length`."""
        self.intervals = [
            iv if iv.stop <= length else Interval(iv.start,
                                                  iv.data[:length - iv.start])
            for iv in self.intervals if iv.start < length]

    def pop_all(self) -> list[Interval]:
        out, self.intervals = self.intervals, []
        return out
