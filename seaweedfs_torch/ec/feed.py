"""Host feed for the EC pipeline (ec/pipeline.py): [k, width] batches.

The port's copy of seaweedfs_tpu/ec/feed.py:

- ``MmapFeed`` maps the .dat once; a batch whose k rows sit at one
  uniform stride is yielded as an ``as_strided`` view of the page cache
  (zero host copies), other batches are assembled with one vectorized
  copy per contiguous k-row run into a staging buffer;
- ``PreadvFeed`` (``WEED_EC_MMAP=0``, or where mmap is refused) scatters
  each contiguous k-row run into the staging rows with one ``os.preadv``;
- ``ShardFeed`` reads the rebuild path's k survivor shard files, one row
  each (mapped where possible).

``open_feed`` chooses by the reference's rules: mmap by default,
``WEED_EC_MMAP=0`` for preadv, ``WEED_EC_ODIRECT=1`` for O_DIRECT reads
(``_DirectReader``: direct where offset, length and destination are
4096-aligned, buffered otherwise; a filesystem that refuses O_DIRECT
degrades to buffered reads). ``WEED_EC_READERS`` > 1 (or ``readers=``)
assembles batches on a pool of reader threads (``_ReaderPool``) while
yielding them strictly in order; readers=1 is the serial path, byte-
identical.

Staging buffers come from a bounded ``BufferPool``, so memory stays at
pool_size * k * width bytes; the pipeline recycles a buffer once its
batch is consumed. ``pinned=True`` (the pipeline asks for it when the
coder runs on a card) makes them page-locked: numpy views of PyTorch
pinned tensors, so the coder's host-to-device copy is asynchronous; with
O_DIRECT each is cut at a 4096-byte boundary of a larger pinned tensor
and its alignment is asserted. The mmap feed's zero-copy views are not
page-locked. The pool counts its up-front allocation in the shared "ec"
metrics registry (``feed_pool_alloc_seconds``, ``feed_pool_alloc_bytes``).
``pooled=False`` hands out a fresh buffer per batch (the device sinks
hold a whole window of batches).

Fault points: ``ec.feed.read`` fires on every stripe/survivor read (a
drop fails the read: a feed must never feed zeros), ``ec.feed.stall``
when the feed waits on a staging buffer. The mmap feed's zero-copy
batches read nothing themselves, so the serial path passes no hook for
them.
"""

from __future__ import annotations

import errno
import mmap
import os
import queue
import threading
import time
from collections import deque
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from .. import faults
from ..utils import metrics as metrics_mod

# Segment = (k file offsets, width); produced by striping.stripe_segments
Segment = "tuple[list[int], int]"

# O_DIRECT alignment: 4096 covers 512e and 4Kn sectors and the page size
_ALIGN = 4096


def use_mmap_default() -> bool:
    """WEED_EC_MMAP=0 forces the preadv path."""
    return os.environ.get("WEED_EC_MMAP", "1") not in ("0", "false", "no")


def use_odirect_default() -> bool:
    """WEED_EC_ODIRECT=1 opts bulk volume scans out of the page cache."""
    return os.environ.get("WEED_EC_ODIRECT", "0") in ("1", "true", "yes")


def env_thread_count(name: str, cap: int) -> int:
    """Env -> thread count for the feed-tier pools: a positive value is
    clamped to `cap`; unset/0/garbage means one per core, at most 4."""
    try:
        n = int(os.environ.get(name, "0"))
    except ValueError:
        n = 0
    if n > 0:
        return min(n, cap)
    return max(1, min(4, os.cpu_count() or 1))


def reader_count_default() -> int:
    """WEED_EC_READERS: reader-pool width (1 = serial assembly)."""
    return env_thread_count("WEED_EC_READERS", 64)


def _aligned_empty(shape: tuple) -> np.ndarray:
    """A [k, w] uint8 buffer whose data pointer is page-aligned, so
    O_DIRECT reads can land in it directly."""
    n = int(shape[0]) * int(shape[1])
    raw = np.empty(n + _ALIGN, dtype=np.uint8)
    off = (-raw.ctypes.data) % _ALIGN
    return raw[off:off + n].reshape(shape)


def _pinned_empty(shape: tuple, aligned: bool) -> np.ndarray:
    """A page-locked [k, w] uint8 buffer (a numpy view that keeps its
    pinned tensor alive); aligned=True cuts it at a 4096-byte boundary.
    PyTorch's pinned allocator does not promise that alignment."""
    n = int(shape[0]) * int(shape[1])
    raw = torch.empty(n + (_ALIGN if aligned else 0), dtype=torch.uint8,
                      pin_memory=True).numpy()
    off = (-raw.ctypes.data) % _ALIGN if aligned else 0
    buf = raw[off:off + n].reshape(shape)
    if aligned and buf.ctypes.data % _ALIGN:
        raise RuntimeError("pinned staging buffer is not page-aligned")
    return buf


class BufferPool:
    """Bounded free-list of [k, width] uint8 staging buffers.

    ``pooled=False`` turns the pool into an allocator: acquire returns a
    fresh buffer, release is a no-op. ``aligned=True`` allocates
    page-aligned buffers (O_DIRECT destinations), ``pinned=True``
    page-locked ones.
    """

    def __init__(self, k: int, width: int, count: int, pooled: bool = True,
                 aligned: bool = False, pinned: bool = False):
        self.shape = (k, width)
        self.pooled = pooled
        self.aligned = aligned
        self.pinned = pinned
        self._closed = threading.Event()
        self._q: queue.Queue = queue.Queue()
        if pooled:
            t0 = time.perf_counter()
            count = max(count, 2)
            for _ in range(count):
                self._q.put(self._alloc())
            reg = metrics_mod.shared("ec")
            reg.count("feed_pool_alloc_seconds", time.perf_counter() - t0)
            reg.count("feed_pool_alloc_bytes", count * k * width)

    def _alloc(self) -> np.ndarray:
        if self.pinned:
            return _pinned_empty(self.shape, self.aligned)
        if self.aligned:
            return _aligned_empty(self.shape)
        return np.empty(self.shape, dtype=np.uint8)

    def acquire(self) -> np.ndarray:
        if not self.pooled:
            return self._alloc()
        # poll so a consumer that stops recycling (error paths) can never
        # wedge the reader thread: close() unblocks us
        stalled = False
        while True:
            if self._closed.is_set():
                raise RuntimeError("feed closed while awaiting a buffer")
            try:
                return self._q.get(timeout=0.1)
            except queue.Empty:
                if not stalled:
                    stalled = True
                    if faults.fire("ec.feed.stall"):
                        raise RuntimeError(
                            "injected abort at ec.feed.stall")
                continue

    def try_acquire(self) -> Optional[np.ndarray]:
        """Non-blocking acquire (reader-pool lookahead must never block
        behind buffers the consumer has not recycled yet)."""
        if not self.pooled:
            return self._alloc()
        if self._closed.is_set():
            raise RuntimeError("feed closed while awaiting a buffer")
        try:
            return self._q.get_nowait()
        except queue.Empty:
            return None

    def release(self, buf: np.ndarray) -> None:
        if self.pooled:
            self._q.put(buf)

    def close(self) -> None:
        self._closed.set()


class _Pending:
    """One in-flight batch on the reader pool: its outstanding job count,
    completion event and any job errors."""

    __slots__ = ("out", "buf", "errors", "event", "_left", "_lock")

    def __init__(self, out: np.ndarray, buf: Optional[np.ndarray],
                 jobs: int):
        self.out = out
        self.buf = buf
        self.errors: list[BaseException] = []
        self.event = threading.Event()
        self._left = jobs
        self._lock = threading.Lock()
        if jobs == 0:
            self.event.set()

    def job_done(self, err: Optional[BaseException] = None) -> None:
        with self._lock:
            if err is not None:
                self.errors.append(err)
            self._left -= 1
            done = self._left <= 0
        if done:
            self.event.set()


class _ReaderPool:
    """N daemon threads running (fn, pending) fill jobs for one feed.

    close() makes every worker exit after its current job and fails any
    job that never ran, so a close mid-read neither wedges a worker nor
    leaves a _Pending waiter blocked."""

    def __init__(self, n: int):
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._threads: list[threading.Thread] = []
        for i in range(n):
            th = threading.Thread(target=self._worker, daemon=True,
                                  name=f"ec-feed-reader-{i}")
            th.start()
            self._threads.append(th)

    def submit(self, fn: Callable[[], None], pending: _Pending) -> None:
        if self._closed:
            pending.job_done(RuntimeError("feed closed"))
            return
        self._q.put((fn, pending))

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, pending = item
            try:
                fn()
            except BaseException as e:
                pending.job_done(e)
            else:
                pending.job_done()

    def close(self) -> None:
        self._closed = True
        for _ in self._threads:
            self._q.put(None)
        for th in self._threads:
            th.join()
        # fail whatever never ran (jobs queued behind the sentinels)
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                item[1].job_done(RuntimeError("feed closed"))


def ordered_pool_map(pool: "_ReaderPool", fns: "Iterator[Callable]",
                     lookahead: int):
    """Run zero-arg callables on a reader pool, yielding their results in
    submission order while up to ``lookahead`` later calls run
    concurrently. The first job error is raised at its in-order position;
    the ``finally`` waits the in-flight tail out."""
    window: deque = deque()
    it = iter(fns)
    exhausted = False
    try:
        while True:
            while not exhausted and len(window) <= max(int(lookahead), 0):
                fn = next(it, None)
                if fn is None:
                    exhausted = True
                    break
                slot: list = [None]
                pend = _Pending(None, None, 1)

                def job(fn=fn, slot=slot):
                    slot[0] = fn()

                pool.submit(job, pend)
                window.append((slot, pend))
            if not window:
                return
            slot, pend = window.popleft()
            pend.event.wait()
            if pend.errors:
                raise pend.errors[0]
            yield slot[0]
    finally:
        while window:
            _, pend = window.popleft()
            pend.event.wait()


_PLANS_DONE = object()


class _FeedBase:
    """Lent-buffer tracking, recycling and the ordered reader-pool window
    shared by the feeds."""

    def __init__(self, k: int, width: int, pool_buffers: int, pooled: bool,
                 readers: Optional[int] = None, aligned: bool = False,
                 pinned: bool = False):
        self.k = k
        self.width = width
        self.readers = (reader_count_default() if readers is None
                        else max(1, int(readers)))
        self.pool = BufferPool(k, width, pool_buffers, pooled,
                               aligned=aligned, pinned=pinned)
        self._rpool: Optional[_ReaderPool] = None
        self._lent: dict[int, np.ndarray] = {}
        self._lent_lock = threading.Lock()

    def _lend(self, buf: np.ndarray, out: np.ndarray) -> np.ndarray:
        """Register `out` (a view of pool buffer `buf`) as lent."""
        if self.pool.pooled:
            with self._lent_lock:
                self._lent[id(out)] = buf
        return out

    def recycle(self, batch: np.ndarray) -> None:
        """Return a batch's staging buffer to the pool. A no-op for
        zero-copy views and unpooled buffers: always safe to call."""
        with self._lent_lock:
            buf = self._lent.pop(id(batch), None)
        if buf is not None:
            self.pool.release(buf)

    def _read_hook(self) -> None:
        """Fault hook on every stripe/survivor read. A drop FAILS the
        read: a feed that skipped one would feed zeros to the parity."""
        if faults.fire("ec.feed.read"):
            raise IOError("injected drop at ec.feed.read")

    def _reader_pool(self) -> _ReaderPool:
        if self._rpool is None:
            self._rpool = _ReaderPool(self.readers)
        return self._rpool

    def _zero_copy(self, offsets: Sequence[int],
                   w: int) -> Optional[np.ndarray]:
        return None  # only the mmap feed can avoid the staging copy

    def _fill_segment(self, buf: np.ndarray, col: int,
                      offsets: Sequence[int], w: int) -> None:
        raise NotImplementedError

    def _fill_rows(self, buf: np.ndarray, col: int, offsets: Sequence[int],
                   w: int, lo: int, hi: int) -> None:
        """Fill rows lo..hi of one segment: the reader-pool work unit."""
        for i in range(lo, hi):
            self._fill_one(buf, i, col, offsets[i], w)

    def _fill_one(self, buf: np.ndarray, row: int, col: int, off: int,
                  w: int) -> None:
        raise NotImplementedError

    def _prefault_jobs(self, view: np.ndarray, offsets: Sequence[int],
                       w: int) -> list:
        """Jobs that fault a zero-copy view's pages in on the reader pool
        (non-mmap feeds have no views and return [])."""
        return []

    # --- batch aggregation ---

    def batches(self, segments: Iterator[Segment],
                pad_final: bool = False) -> Iterator[np.ndarray]:
        """Aggregate stripe segments into [k, width] batches: consecutive
        segments append to the same shard files, so the batch width never
        changes the layout. pad_final yields the last batch at full width,
        zero-padded. readers > 1 assembles on the reader pool (ordered
        yield); readers == 1 is the serial path, byte-identical."""
        if self.readers <= 1:
            yield from self._batches_serial(segments, pad_final)
        else:
            yield from self._ordered_parallel(
                self._stripe_plans(segments, pad_final))

    def _batches_serial(self, segments: Iterator[Segment],
                        pad_final: bool) -> Iterator[np.ndarray]:
        buf: Optional[np.ndarray] = None
        col = 0
        for offsets, w in segments:
            if col == 0 and w == self.width:
                zc = self._zero_copy(offsets, w)
                if zc is not None:
                    yield zc
                    continue
            if buf is None:
                buf = self.pool.acquire()
            if col + w > self.width:
                yield self._lend(buf, buf[:, :col])
                buf = self.pool.acquire()
                col = 0
            self._read_hook()
            self._fill_segment(buf, col, offsets, w)
            col += w
        if buf is not None and col:
            if col < self.width and pad_final:
                buf[:, col:] = 0
                yield self._lend(buf, buf)
            else:
                yield self._lend(buf, buf[:, :col] if col < self.width
                                 else buf)

    def _stripe_plans(self, segments: Iterator[Segment],
                      pad_final: bool) -> Iterator[tuple]:
        """("view", view, offsets, w) | ("fill", fills, used_cols, pad):
        the serial path's aggregation, decisions only."""
        fills: list[tuple[int, Sequence[int], int]] = []
        col = 0
        for offsets, w in segments:
            if col == 0 and w == self.width:
                zc = self._zero_copy(offsets, w)
                if zc is not None:
                    yield ("view", zc, offsets, w)
                    continue
            if col + w > self.width:
                yield ("fill", fills, col, False)
                fills = []
                col = 0
            fills.append((col, offsets, w))
            col += w
        if fills:
            yield ("fill", fills, col, pad_final)

    def _submit_plan(self, plan: tuple,
                     block: bool) -> Optional[_Pending]:
        """Turn one plan into reader-pool jobs. block=False returns None
        instead of waiting for a staging buffer (ordered lookahead must
        not deadlock against buffers the consumer still holds)."""
        rpool = self._reader_pool()
        if plan[0] == "view":
            _, view, offsets, w = plan
            jobs = self._prefault_jobs(view, offsets, w)
            pend = _Pending(view, None, len(jobs))
            for fn in jobs:
                rpool.submit(fn, pend)
            return pend
        _, fills, used, pad = plan
        buf = self.pool.acquire() if block else self.pool.try_acquire()
        if buf is None:
            return None
        if used < self.width:
            out = buf if pad else buf[:, :used]
        else:
            out = buf
        self._lend(buf, out)
        # many small fills parallelize as they are; a single wide fill
        # (a large-block stripe) splits across its k rows
        jobs: list[Callable[[], None]] = []
        per_fill = max(1, self.readers // max(len(fills), 1))
        for (c, offsets, w) in fills:
            k = len(offsets)
            step = max(1, -(-k // per_fill))
            for lo in range(0, k, step):
                hi = min(lo + step, k)

                def job(c=c, offsets=offsets, w=w, lo=lo, hi=hi):
                    self._read_hook()
                    self._fill_rows(buf, c, offsets, w, lo, hi)

                jobs.append(job)
        if pad and used < self.width:
            def pad_job(used=used):
                buf[:, used:] = 0

            jobs.append(pad_job)
        pend = _Pending(out, buf, len(jobs))
        for fn in jobs:
            rpool.submit(fn, pend)
        return pend

    def _await_pending(self, pend: _Pending) -> np.ndarray:
        while not pend.event.wait(0.05):
            if self.pool._closed.is_set():
                raise RuntimeError("feed closed while assembling a batch")
        if pend.errors:
            self.recycle(pend.out)
            raise pend.errors[0]
        return pend.out

    def _ordered_parallel(self, plans: Iterator[tuple]
                          ) -> Iterator[np.ndarray]:
        """Yield plan results strictly in order while up to readers+1
        later plans assemble concurrently on the reader pool."""
        window: deque[_Pending] = deque()
        it = iter(plans)
        next_plan: object = None
        exhausted = False
        lookahead = self.readers + 1
        try:
            while True:
                while not exhausted and len(window) <= lookahead:
                    if next_plan is None:
                        next_plan = next(it, _PLANS_DONE)
                        if next_plan is _PLANS_DONE:
                            exhausted = True
                            break
                    pend = self._submit_plan(next_plan,
                                             block=not window)
                    if pend is None:
                        break  # no free buffer: yield one first
                    next_plan = None
                    window.append(pend)
                if not window:
                    return
                yield self._await_pending(window.popleft())
        finally:
            # error/early-close path: wait the in-flight jobs out (or until
            # close() fails them) and recycle their buffers
            while window:
                pend = window.popleft()
                while not pend.event.wait(0.05):
                    if self.pool._closed.is_set():
                        break
                self.recycle(pend.out)

    def close(self) -> None:
        self.pool.close()
        if self._rpool is not None:
            self._rpool.close()
            self._rpool = None


class _DirectReader:
    """The O_DIRECT read discipline of the pread-based feeds: a direct
    pread when offset, length and destination address are all aligned,
    the buffered fd otherwise; EINVAL from a filesystem that refuses
    O_DIRECT downgrades to buffered for good."""

    def __init__(self, path: str, odirect: bool):
        self.fd = os.open(path, os.O_RDONLY)
        self.fd_direct = -1
        self.use_direct = False
        if odirect and hasattr(os, "O_DIRECT"):
            try:
                self.fd_direct = os.open(path, os.O_RDONLY | os.O_DIRECT)
                self.use_direct = True
            except OSError:
                self.fd_direct = -1  # fs refuses O_DIRECT: buffered only

    def read_row(self, dest: np.ndarray, offset: int) -> int:
        """pread `dest` bytes at `offset`, zero-filling past EOF; O_DIRECT
        when the span allows it."""
        if (self.use_direct and offset % _ALIGN == 0
                and dest.nbytes % _ALIGN == 0
                and dest.ctypes.data % _ALIGN == 0):
            try:
                return _readinto(self.fd_direct, dest, offset)
            except OSError as e:
                if e.errno != errno.EINVAL:
                    raise
                # flag only: reader-pool threads share this object, and
                # closing fd_direct here would race their preadvs; it
                # stays open until close()
                self.use_direct = False
        return _readinto(self.fd, dest, offset)

    @property
    def direct(self) -> bool:
        return self.use_direct

    def close(self) -> None:
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1
        if self.fd_direct >= 0:
            os.close(self.fd_direct)
            self.fd_direct = -1


class MmapFeed(_FeedBase):
    """Page-cache-mapped stripe feed over one .dat file."""

    def __init__(self, path: str, k: int, width: int,
                 pool_buffers: int = 4, pooled: bool = True,
                 readers: Optional[int] = None, pinned: bool = False):
        super().__init__(k, width, pool_buffers, pooled, readers=readers,
                         pinned=pinned)
        self.size = os.path.getsize(path)
        self._fd = os.open(path, os.O_RDONLY)
        self._mm: Optional[mmap.mmap] = None
        self._view: Optional[np.ndarray] = None
        if self.size:
            try:
                self._mm = mmap.mmap(self._fd, self.size, mmap.MAP_SHARED,
                                     mmap.PROT_READ)
            except (OSError, ValueError):
                os.close(self._fd)  # open_feed falls back to PreadvFeed
                self._fd = -1
                raise
            # sequential advice keeps readahead ahead of the feed
            try:
                self._mm.madvise(mmap.MADV_SEQUENTIAL)
            except (AttributeError, OSError):
                pass
            self._view = np.frombuffer(self._mm, dtype=np.uint8)

    def _zero_copy(self, offsets: Sequence[int], w: int
                   ) -> Optional[np.ndarray]:
        """[k, w] as_strided view when the segment's rows are uniformly
        strided and fully inside the file: no bytes move at all."""
        if self._view is None or offsets[-1] + w > self.size:
            return None
        if self.k == 1:
            return self._view[offsets[0]:offsets[0] + w].reshape(1, w)
        stride = offsets[1] - offsets[0]
        if any(offsets[i + 1] - offsets[i] != stride
               for i in range(self.k - 1)):
            return None
        return np.lib.stride_tricks.as_strided(
            self._view[offsets[0]:], shape=(self.k, w),
            strides=(stride, 1))

    def _prefault_jobs(self, view: np.ndarray, offsets: Sequence[int],
                       w: int) -> list:
        """Touch one byte per page of each row's span: the reader pool
        faults the pages in concurrently, so the consumer's gather never
        stalls single-threaded on major faults."""
        if self._view is None:
            return []
        src = self._view
        jobs = []
        k = len(offsets)
        step = max(1, -(-k // self.readers))
        page = mmap.PAGESIZE or _ALIGN
        for lo in range(0, k, step):
            rows = list(offsets[lo:lo + step])

            def job(rows=rows):
                self._read_hook()
                for off in rows:
                    stop = min(off + w, src.shape[0])
                    if off < stop:
                        # reading every page-th byte faults the pages in
                        int(np.sum(src[off:stop:page], dtype=np.uint64))

            jobs.append(job)
        return jobs

    def _fill_segment(self, buf: np.ndarray, col: int,
                      offsets: Sequence[int], w: int) -> None:
        view, size = self._view, self.size
        if (view is not None and len(offsets) > 1
                and all(offsets[i + 1] - offsets[i] == w
                        for i in range(len(offsets) - 1))
                and offsets[0] + len(offsets) * w <= size):
            # contiguous k-row run (small-block rows): one vectorized copy
            start = offsets[0]
            src = view[start:start + len(offsets) * w]
            np.copyto(buf[:, col:col + w], src.reshape(len(offsets), w))
            return
        for i, off in enumerate(offsets):
            self._fill_one(buf, i, col, off, w)

    def _fill_one(self, buf: np.ndarray, row: int, col: int, off: int,
                  w: int) -> None:
        view, size = self._view, self.size
        n = min(w, size - off) if off < size else 0
        if n > 0:
            np.copyto(buf[row, col:col + n], view[off:off + n])
        if n < w:
            buf[row, col + n:col + w] = 0

    def close(self) -> None:
        super().close()
        self._view = None
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                # live views (queued batches on an error path) still
                # reference the map; the GC closes it when they die
                pass
            self._mm = None
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1


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


class PreadvFeed(_FeedBase):
    """preadv into staging buffers (no mmap): one syscall per contiguous
    k-row run (serial) or one pread per row range (reader pool,
    O_DIRECT)."""

    def __init__(self, path: str, k: int, width: int,
                 pool_buffers: int = 4, pooled: bool = True,
                 readers: Optional[int] = None,
                 odirect: Optional[bool] = None, pinned: bool = False):
        if odirect is None:
            odirect = use_odirect_default()
        super().__init__(k, width, pool_buffers, pooled, readers=readers,
                         aligned=odirect, pinned=pinned)
        self.size = os.path.getsize(path)
        self._rd = _DirectReader(path, odirect)

    def _fill_segment(self, buf: np.ndarray, col: int,
                      offsets: Sequence[int], w: int) -> None:
        k = len(offsets)
        if (not self._rd.direct and k > 1
                and all(offsets[i + 1] - offsets[i] == w
                        for i in range(k - 1))
                and offsets[0] + k * w <= self.size):
            # contiguous k-row run: one preadv scatters the whole run
            # across the k staging rows
            rows = [buf[i, col:col + w] for i in range(k)]
            done = 0
            total = k * w
            while done < total:
                row, sub = divmod(done, w)
                iov = [rows[row][sub:]] + rows[row + 1:]
                got = os.preadv(self._rd.fd, iov, offsets[0] + done)
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
            self._fill_one(buf, i, col, off, w)

    def _fill_one(self, buf: np.ndarray, row: int, col: int, off: int,
                  w: int) -> None:
        if off >= self.size:
            buf[row, col:col + w] = 0
        else:
            self._rd.read_row(buf[row, col:col + w], off)

    def close(self) -> None:
        super().close()
        self._rd.close()


class ShardFeed(_FeedBase):
    """[k, n] batches whose row i comes from survivor shard file i: the
    rebuild path's feed. A short survivor file raises IOError (a truncated
    shard must fail the rebuild, not feed zeros). Runs on the same reader
    pool: each batch's k row reads split across the pool threads."""

    def __init__(self, paths: Sequence[str], width: int,
                 pool_buffers: int = 4, pooled: bool = True,
                 use_mmap: Optional[bool] = None,
                 readers: Optional[int] = None,
                 odirect: Optional[bool] = None, pinned: bool = False):
        if odirect is None:
            odirect = use_odirect_default()
        if use_mmap is None:
            use_mmap = use_mmap_default() and not odirect
        super().__init__(len(paths), width, pool_buffers, pooled,
                         readers=readers, aligned=odirect, pinned=pinned)
        self.shard_size = os.path.getsize(paths[0])
        # all or nothing: a failed open closes the readers already opened
        self._rds: list[_DirectReader] = []
        try:
            for p in paths:
                self._rds.append(_DirectReader(p, odirect))
            self._sizes = [os.path.getsize(p) for p in paths]
        except BaseException:
            for rd in self._rds:
                rd.close()
            raise
        self._paths = list(paths)
        self._mms: list[Optional[mmap.mmap]] = [None] * self.k
        self._views: list[Optional[np.ndarray]] = [None] * self.k
        if use_mmap:
            for i, rd in enumerate(self._rds):
                if not self._sizes[i]:
                    continue
                try:
                    mm = mmap.mmap(rd.fd, self._sizes[i], mmap.MAP_SHARED,
                                   mmap.PROT_READ)
                except (OSError, ValueError):
                    continue  # this file reads via preadv instead
                try:
                    mm.madvise(mmap.MADV_SEQUENTIAL)
                except (AttributeError, OSError):
                    pass
                self._mms[i] = mm
                self._views[i] = np.frombuffer(mm, dtype=np.uint8)

    def _fill_row(self, buf: np.ndarray, i: int, offset: int,
                  n: int) -> None:
        if offset + n > self._sizes[i]:
            raise IOError(
                f"shard file {self._paths[i]} short read "
                f"{max(self._sizes[i] - offset, 0)} != {n}")
        view = self._views[i]
        if view is not None:
            np.copyto(buf[i, :n], view[offset:offset + n])
        else:
            got = self._rds[i].read_row(buf[i, :n], offset)
            if got != n:
                raise IOError(
                    f"shard file {self._paths[i]} short read "
                    f"{got} != {n}")

    def _shard_plans(self, batch_size: int,
                     pad_final: bool) -> Iterator[tuple]:
        """("fill", ...) plans of one segment whose k rows all read the
        same shard offset (row i = survivor file i), so _submit_plan's
        machinery serves as it is; only _fill_one differs."""
        offset = 0
        while offset < self.shard_size:
            n = min(batch_size, self.shard_size - offset)
            yield ("fill", [(0, [offset] * self.k, n)], n, pad_final)
            offset += n

    def _fill_one(self, buf: np.ndarray, row: int, col: int, off: int,
                  w: int) -> None:
        self._fill_row(buf, row, off, w)

    def batches(self, batch_size: int,
                pad_final: bool = False) -> Iterator[np.ndarray]:
        if self.readers > 1:
            yield from self._ordered_parallel(
                self._shard_plans(batch_size, pad_final))
            return
        offset = 0
        while offset < self.shard_size:
            n = min(batch_size, self.shard_size - offset)
            buf = self.pool.acquire()
            try:
                self._read_hook()
                for i in range(self.k):
                    self._fill_row(buf, i, offset, n)
            except BaseException:
                self.pool.release(buf)
                raise
            if n < batch_size:
                if pad_final:
                    buf[:, n:] = 0
                    yield self._lend(buf, buf)
                else:
                    yield self._lend(buf, buf[:, :n])
            else:
                yield self._lend(buf, buf)
            offset += n

    def close(self) -> None:
        super().close()
        for i, mm in enumerate(self._mms):
            self._views[i] = None
            if mm is not None:
                try:
                    mm.close()
                except BufferError:
                    pass
                self._mms[i] = None
        for rd in self._rds:
            rd.close()


def open_feed(path: str, k: int, width: int, pool_buffers: int = 4,
              pooled: bool = True,
              use_mmap: Optional[bool] = None,
              readers: Optional[int] = None,
              odirect: Optional[bool] = None,
              pinned: bool = False) -> "_FeedBase":
    """The stripe feed for <base>.dat: mmap when possible, preadv
    otherwise. width must equal the pipeline batch size. O_DIRECT
    (``WEED_EC_ODIRECT=1`` or odirect=True) forces the pread path: cache
    bypass and mmap exclude each other."""
    if odirect is None:
        odirect = use_odirect_default()
    if odirect:
        return PreadvFeed(path, k, width, pool_buffers, pooled,
                          readers=readers, odirect=True, pinned=pinned)
    if use_mmap is None:
        use_mmap = use_mmap_default()
    if use_mmap:
        try:
            return MmapFeed(path, k, width, pool_buffers, pooled,
                            readers=readers, pinned=pinned)
        except (OSError, ValueError):
            pass  # e.g. filesystems that refuse MAP_SHARED; fall through
    return PreadvFeed(path, k, width, pool_buffers, pooled,
                      readers=readers, odirect=False, pinned=pinned)
