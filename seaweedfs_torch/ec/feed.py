"""Host feed for the EC pipeline (ec/pipeline.py): [k, width] batches.

The port's reduced copy of seaweedfs_tpu/ec/feed.py. ``PreadvFeed``
assembles stripe batches from a .dat file with one ``os.preadv`` per
contiguous k-row run, straight into staging rows; ``ShardFeed`` reads the
rebuild path's k survivor shard files, one row each. Batches are
assembled serially on the pipeline's reader thread.

Staging buffers come from a bounded ``BufferPool`` so the pipeline
double-buffers: batch N+1 assembles while batch N is copied to the card
and encoded, and memory stays at pool_size * k * width bytes however long
the volume is. With ``pinned=True`` the pool's buffers are page-locked
(numpy views of PyTorch pinned tensors), so the coder's host-to-device
copy runs asynchronously on its stream. The pipeline recycles a buffer
once its batch is fully consumed (result materialized and every row
written). Feeds with ``pooled=False`` hand out a fresh buffer per batch
and recycling is a no-op: the device sinks use that mode, because a whole
window of batches stays referenced until its one dispatch, and they ask
``batches(..., pad_final=True)`` so that every batch of a window has one
shape.

Not ported: the mmap zero-copy feed, O_DIRECT reads and the reader-thread
pool that assembles several batches at once.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

# Segment = (k file offsets, width); produced by striping.stripe_segments
Segment = "tuple[list[int], int]"


class BufferPool:
    """Bounded free-list of [k, width] uint8 staging buffers;
    ``pinned=True`` allocates page-locked memory. ``pooled=False`` turns
    the pool into an allocator: acquire returns a fresh buffer and release
    is a no-op."""

    def __init__(self, k: int, width: int, count: int,
                 pinned: bool = False, pooled: bool = True):
        self.shape = (k, width)
        self.pinned = pinned
        self.pooled = pooled
        self._closed = threading.Event()
        self._q: queue.Queue = queue.Queue()
        if pooled:
            for _ in range(max(count, 2)):
                self._q.put(self._alloc())

    def _alloc(self) -> np.ndarray:
        if self.pinned:
            # the numpy view keeps the pinned tensor alive
            return torch.empty(self.shape, dtype=torch.uint8,
                               pin_memory=True).numpy()
        return np.empty(self.shape, dtype=np.uint8)

    def acquire(self) -> np.ndarray:
        if not self.pooled:
            return self._alloc()
        # poll so a consumer that stops recycling (error paths) can never
        # wedge the reader thread: close() unblocks us
        while True:
            if self._closed.is_set():
                raise RuntimeError("feed closed while awaiting a buffer")
            try:
                return self._q.get(timeout=0.1)
            except queue.Empty:
                continue

    def release(self, buf: np.ndarray) -> None:
        if self.pooled:
            self._q.put(buf)

    def close(self) -> None:
        self._closed.set()


def _readinto(fd: int, dest: np.ndarray, offset: int) -> int:
    """preadv straight into a contiguous numpy row; loops on short reads,
    zero-fills past EOF. Returns the bytes actually read."""
    done = 0
    n = dest.shape[0]
    while done < n:
        got = os.preadv(fd, [dest[done:]], offset + done)
        if got <= 0:
            dest[done:] = 0
            break
        done += got
    return done


class _FeedBase:
    """Lent-buffer tracking and recycling shared by the feeds."""

    def __init__(self, k: int, width: int, pool_buffers: int, pinned: bool,
                 pooled: bool):
        self.k = k
        self.width = width
        self.pool = BufferPool(k, width, pool_buffers, pinned, pooled)
        self._lent: dict[int, np.ndarray] = {}
        self._lent_lock = threading.Lock()

    def _lend(self, buf: np.ndarray, out: np.ndarray) -> np.ndarray:
        """Register `out` (a view of pool buffer `buf`) as lent."""
        if self.pool.pooled:
            with self._lent_lock:
                self._lent[id(out)] = buf
        return out

    def recycle(self, batch: np.ndarray) -> None:
        """Return a batch's staging buffer to the pool (a no-op for a
        batch already returned, or an unpooled one: always safe to
        call)."""
        with self._lent_lock:
            buf = self._lent.pop(id(batch), None)
        if buf is not None:
            self.pool.release(buf)

    def close(self) -> None:
        self.pool.close()


class PreadvFeed(_FeedBase):
    """Stripe feed over one .dat file: one preadv per contiguous k-row
    run, scattered straight into the staging rows."""

    def __init__(self, path: str, k: int, width: int,
                 pool_buffers: int = 4, pinned: bool = False,
                 pooled: bool = True):
        super().__init__(k, width, pool_buffers, pinned, pooled)
        self.size = os.path.getsize(path)
        self._fd = os.open(path, os.O_RDONLY)

    def batches(self, segments: Iterator[Segment],
                pad_final: bool = False) -> Iterator[np.ndarray]:
        """Aggregate stripe segments into [k, width] batches: consecutive
        segments append to the same shard files, so the batch width never
        changes the layout. The last batch may be narrower; pad_final
        yields it at full width, zero-padded."""
        buf: Optional[np.ndarray] = None
        col = 0
        for offsets, w in segments:
            if buf is None:
                buf = self.pool.acquire()
            if col + w > self.width:
                yield self._lend(buf, buf[:, :col])
                buf = self.pool.acquire()
                col = 0
            self._fill_segment(buf, col, offsets, w)
            col += w
        if buf is not None and col:
            if col < self.width and pad_final:
                buf[:, col:] = 0
                yield self._lend(buf, buf)
            else:
                yield self._lend(buf, buf[:, :col] if col < self.width
                                 else buf)

    def _fill_segment(self, buf: np.ndarray, col: int,
                      offsets: Sequence[int], w: int) -> None:
        k = len(offsets)
        if (k > 1 and all(offsets[i + 1] - offsets[i] == w
                          for i in range(k - 1))
                and offsets[0] + k * w <= self.size):
            # contiguous k-row run (small-block rows): one preadv scatters
            # the whole run across the k staging rows
            rows = [buf[i, col:col + w] for i in range(k)]
            done = 0
            total = k * w
            while done < total:
                row, sub = divmod(done, w)
                got = os.preadv(self._fd, [rows[row][sub:]] + rows[row + 1:],
                                offsets[0] + done)
                if got <= 0:
                    break
                done += got
            if done < total:  # unexpected EOF: zero the remainder
                row, sub = divmod(done, w)
                rows[row][sub:] = 0
                for r in rows[row + 1:]:
                    r[:] = 0
            return
        for i, off in enumerate(offsets):
            if off >= self.size:
                buf[i, col:col + w] = 0
            else:
                _readinto(self._fd, buf[i, col:col + w], off)

    def close(self) -> None:
        super().close()
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1


class ShardFeed(_FeedBase):
    """[k, n] batches whose row i comes from survivor shard file i: the
    rebuild path's feed. A short survivor file raises IOError (a
    truncated shard must fail the rebuild, not feed zeros)."""

    def __init__(self, paths: Sequence[str], width: int,
                 pool_buffers: int = 4, pinned: bool = False,
                 pooled: bool = True):
        super().__init__(len(paths), width, pool_buffers, pinned, pooled)
        self.shard_size = os.path.getsize(paths[0])
        self._paths = list(paths)
        self._fds: list[int] = []
        try:  # all or nothing: close what opened if one open fails
            for p in paths:
                self._fds.append(os.open(p, os.O_RDONLY))
        except BaseException:
            self.close()
            raise

    def batches(self, batch_size: int,
                pad_final: bool = False) -> Iterator[np.ndarray]:
        """[k, n] batches of the survivors, n = batch_size but the last;
        pad_final yields the last at full width, zero-padded."""
        offset = 0
        while offset < self.shard_size:
            n = min(batch_size, self.shard_size - offset)
            buf = self.pool.acquire()
            for i, fd in enumerate(self._fds):
                got = _readinto(fd, buf[i, :n], offset)
                if got != n:
                    self.pool.release(buf)
                    raise IOError(f"shard file {self._paths[i]} short read "
                                  f"{got} != {n}")
            if n < batch_size and pad_final:
                buf[:, n:] = 0
                yield self._lend(buf, buf)
            else:
                yield self._lend(buf, buf[:, :n] if n < batch_size else buf)
            offset += n

    def close(self) -> None:
        super().close()
        for fd in self._fds:
            os.close(fd)
        self._fds = []

