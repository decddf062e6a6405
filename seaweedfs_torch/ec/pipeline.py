"""Streaming EC pipeline: disk -> host buffer -> card -> kernel -> shard files.

The port's copy of seaweedfs_tpu/ec/pipeline.py. Multi-MB batches with
disk read, host-to-device copy, kernel, device-to-host copy and shard
write-back all overlapped:

  reader thread   -- assemble [k, B] batches through the host feed
                     (ec/feed.py: page-cache views of the mmap'd .dat where
                     the stripe allows, else page-locked staging buffers
                     when the coder runs on a card), push to a
                     depth-bounded queue
  main thread     -- pop a batch, dispatch coder.encode_async (the copies,
                     the kernel and the copy back are enqueued on the
                     coder's CUDA stream and the call returns at once)
  materializer    -- wait for the batch's parity (only this thread waits
                     on the card), then fan rows out to the per-file
                     queues; data rows go straight from the host batch
  k+m writers     -- one thread per shard file, coalescing queued rows into
                     single writev appends

Batch size, queue depths and the reader-pool width default to the
adaptive governor's operating point (ec/governor.py), tuned between runs
from the per-stage spans this module records (``ec.read``,
``ec.dispatch``, ``ec.kernel``, ``ec.digest``, ``ec.write``; on the card
the dispatch and the materialize wait also carry the NVTX ranges
``ec_pipeline_dispatch`` and ``ec_pipeline_kernel_wait``). Each run emits
one wide event with its stage totals. Explicit ``batch_size``/``depth``
pin the plan and skip retuning. The governor's formulation axis steers
only coders with a ``retune_formulation`` hook; ``TorchCoder`` has none
(its formulation is its argument or the ``WEED_EC_FORMULATION`` pin), as
the reference's ``PallasCoder`` has none. Layout semantics are identical
to striping.write_ec_files: row-major two-tier striping, final batch
zero-padded and written full length.

The device sinks (``stream_encode_device_sink``,
``stream_rebuild_device_sink``) run the same reads but keep the results
on the card: batches are staged into device memory window by window, each
window runs its kernels at once (an ``ec.dispatch_window`` span), and only
a per-row uint32 byte-sum digest comes back, to be held against
``shard_file_digest`` of the real shard files and the .ecm's stamped
digests (``read_stamped_digests``).
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import threading
import time
from typing import Iterator, Optional, Sequence

import numpy as np

from .. import observe
from ..observe import wideevents
from ..observe.profiler import trace_annotation
from ..utils import durable
from ..utils import metrics as metrics_mod
from . import feed as feed_mod
from . import governor
from .coder import ErasureCoder
from .geometry import DEFAULT, Geometry, to_ext
from .striping import check_coder, stripe_segments, write_layout_marker

# the operating point when the governor is bypassed (explicit args):
# 8 MiB per shard-row batch = 80 MiB host buffer per batch at RS(10,4)
DEFAULT_BATCH_SIZE = 8 * 1024 * 1024
DEFAULT_DEPTH = 4

_SENTINEL = None


def _resolve_op(batch_size: Optional[int], depth: Optional[int],
                nbytes: int, k: int,
                chips: int = 1) -> tuple["governor.OperatingPoint", bool]:
    """(operating point, governed?): explicit args pin the plan and opt
    the run out of the governor entirely, with no retuning from this
    run's shapes and no export of a plan the run is not using."""
    if batch_size is None and depth is None:
        return governor.get().plan(nbytes, k, chips=chips), True
    b = batch_size if batch_size is not None else DEFAULT_BATCH_SIZE
    d = depth if depth is not None else DEFAULT_DEPTH
    return governor.OperatingPoint(b, d, d,
                                   feed_mod.reader_count_default(),
                                   max(chips, 1)), False


def coder_chips(coder: ErasureCoder) -> int:
    """The number of devices a coder spreads each batch over (1 for every
    single-card coder)."""
    return int(getattr(coder, "mesh_devices", 1) or 1)


def _steer_formulation(coder: ErasureCoder,
                       op: "governor.OperatingPoint"
                       ) -> "governor.OperatingPoint":
    """Apply the governor's planned kernel formulation to the coder
    before the run starts. The coder reports the formulation it actually
    runs, and the returned op carries that, so finish_run never
    attributes one kernel's spans to another. Coders without the hook
    (NumpyCoder, TorchCoder) report "", which opts the run out of the
    formulation model."""
    retune = getattr(coder, "retune_formulation", None)
    if retune is None:
        return op._replace(formulation="")
    return op._replace(formulation=retune(op.formulation))


class _FanOut:
    """One writer thread per output file, each with a bounded row queue;
    writers drain their queue greedily and append every waiting row in
    ONE os.writev call, straight from the row memory."""

    MAX_COALESCE = 16  # rows per writev: bounds latency and iov count

    def __init__(self, paths: Sequence[str], depth: int):
        self.queues = [queue.Queue(maxsize=depth) for _ in paths]
        self.errors: list[BaseException] = []
        self.threads = []
        for q, path in zip(self.queues, paths):
            th = threading.Thread(target=self._writer, args=(q, path),
                                  daemon=True)
            th.start()
            self.threads.append(th)

    @staticmethod
    def _writev_all(fd: int, rows: list) -> None:
        bufs = [memoryview(r) for r in rows]
        while bufs:
            n = os.writev(fd, bufs)
            if n <= 0:
                raise IOError("writev wrote nothing")
            while bufs and n >= bufs[0].nbytes:
                n -= bufs[0].nbytes
                bufs.pop(0)
            if n:
                bufs[0] = bufs[0][n:]

    def _writer(self, q: queue.Queue, path: str) -> None:
        batch: list = []
        stop = False  # close()'s sentinel already consumed
        try:
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
            try:
                while True:
                    item = q.get()
                    if item is _SENTINEL:
                        # taken: a failed fsync must not drain for it
                        stop = True
                        # sync before the .ecm marker commits the set
                        os.fsync(fd)
                        return
                    batch = [item]
                    while len(batch) < self.MAX_COALESCE and not q.empty():
                        nxt = q.get_nowait()
                        if nxt is _SENTINEL:
                            stop = True
                            break
                        batch.append(nxt)
                    self._writev_all(fd, [row for row, _ in batch])
                    for _, cb in batch:
                        if cb is not None:
                            cb()
                    batch = []
                    if stop:
                        os.fsync(fd)
                        return
            finally:
                os.close(fd)
        except BaseException as e:
            self.errors.append(e)
            # rows popped when the write failed still owe their callbacks:
            # a skipped one strands that batch's pooled staging buffer
            for _, cb in batch:
                if cb is not None:
                    cb()
            while not stop:  # drain so the producer never deadlocks
                item = q.get()
                if item is _SENTINEL:
                    return
                _, cb = item
                if cb is not None:
                    cb()

    def put_rows(self, rows: Iterator[np.ndarray], on_done=None) -> None:
        """Enqueue one batch's rows; on_done fires once after EVERY row of
        this call has been written (the host batch may be a pooled
        staging buffer that must not be reused earlier)."""
        rows = [np.ascontiguousarray(r) for r in rows]
        cb = None
        if on_done is not None:
            state = {"left": len(rows)}
            lock = threading.Lock()

            def cb() -> None:
                with lock:
                    state["left"] -= 1
                    done = state["left"] == 0
                if done:
                    on_done()

        for q, row in zip(self.queues, rows):
            q.put((row, cb))

    def close(self) -> None:
        for q in self.queues:
            q.put(_SENTINEL)
        for th in self.threads:
            th.join()


def _traced_batches(batches: Iterator[np.ndarray],
                    ctx: "observe.TraceCtx") -> Iterator[np.ndarray]:
    """One ec.read span per batch, recorded in the reader thread against
    the captured context. The final pull learns it was the end only after
    its timing window, so it records no span."""
    it = iter(batches)
    i = 0
    while True:
        start_us = int(time.time() * 1e6)
        t0 = time.perf_counter()
        item = next(it, None)
        if item is None:
            return
        observe.record_span(
            "ec.read", ctx, start_us,
            int((time.perf_counter() - t0) * 1e6),
            tags={"batch": i, "bytes": int(item.nbytes)})
        yield item
        i += 1


def _run_pipeline(batches: Iterator[np.ndarray], dispatch, consume,
                  depth: int, recycle=None, settle=None,
                  trace_ctx: "observe.TraceCtx | None" = None) -> None:
    """reader thread -> main dispatch -> materializer thread. recycle
    (optional) is called on batches drained without being consumed on
    error paths, so pooled feed buffers keep circulating. settle (the
    coder's materialize) first waits out a drained batch's dispatched
    work, so its buffer is not refilled while a copy still reads it.
    With trace_ctx each dispatch is an ec.dispatch span; every dispatch
    is an ec_pipeline_dispatch NVTX range on the card. The coder enqueues
    each batch's copy back to the host in the dispatch itself, so the
    reference's separate copy_to_host_async kick has no counterpart."""
    read_q: queue.Queue = queue.Queue(maxsize=depth)
    mat_q: queue.Queue = queue.Queue(maxsize=depth)
    errors: list[BaseException] = []

    def _recycle(batch) -> None:
        if recycle is not None:
            recycle(batch)

    def reader_main() -> None:
        try:
            for item in batches:
                read_q.put(item)
        except BaseException as e:
            errors.append(e)
        finally:
            read_q.put(_SENTINEL)

    def mat_main() -> None:
        try:
            while True:
                item = mat_q.get()
                if item is _SENTINEL:
                    return
                consume(*item)
        except BaseException as e:
            errors.append(e)
            while True:
                item = mat_q.get()
                if item is _SENTINEL:
                    return
                batch, handle = item
                if settle is not None:
                    try:
                        settle(handle)
                    except BaseException:
                        pass  # the run has already failed with errors[0]
                _recycle(batch)

    reader = threading.Thread(target=reader_main, daemon=True)
    mat = threading.Thread(target=mat_main, daemon=True)
    mat.start()
    reader.start()
    drained = False
    batch_i = 0
    try:
        while True:
            batch = read_q.get()
            if batch is _SENTINEL:
                drained = True
                break
            with contextlib.ExitStack() as stack:
                if trace_ctx is not None:
                    stack.enter_context(observe.stage(
                        "ec.dispatch", trace_ctx, tags={"batch": batch_i}))
                stack.enter_context(trace_annotation("ec_pipeline_dispatch"))
                try:
                    handle = dispatch(batch)
                except BaseException:
                    # the in-flight batch is nobody else's to recycle
                    _recycle(batch)
                    raise
            batch_i += 1
            mat_q.put((batch, handle))
    finally:
        mat_q.put(_SENTINEL)
        # drain read_q so a reader blocked on a full queue can finish
        while not drained:
            item = read_q.get()
            if item is _SENTINEL:
                break
            _recycle(item)
        reader.join()
        mat.join()
    if errors:
        raise errors[0]


def host_row_digests(rows: Sequence[np.ndarray]) -> np.ndarray:
    """Each row's byte sum (uint64): the digest of a batch whose coder
    computed none."""
    return np.array([np.sum(row, dtype=np.uint64) for row in rows],
                    dtype=np.uint64)


def _stream_encode_core(batches: Iterator[np.ndarray], coder: ErasureCoder,
                        shard_paths: Sequence[str],
                        op: "governor.OperatingPoint",
                        tctx: "observe.TraceCtx",
                        recycle=None,
                        digests: "np.ndarray | None" = None) -> None:
    """Host batches -> async dispatch -> materialize -> one writer thread
    per shard file. Returns with every shard file written and fsynced;
    writes no .ecm marker. `digests` (uint64[total_shards]) accumulates
    each shard row's byte sum while the rows stream through, so the
    marker's digests come out of the encode pass itself: from the coder's
    kernels (``row_digests``, the fused digest epilogue on the card) where
    it gives them, else summed here on the host (``host_row_digests``)."""
    fan = _FanOut(list(shard_paths), op.write_depth)

    def consume(data: np.ndarray, handle) -> None:
        with observe.stage("ec.kernel", tctx), \
                trace_annotation("ec_pipeline_kernel_wait"):
            parity = coder.materialize(handle)
        rows = [*data, *parity]
        if digests is not None:
            with observe.stage("ec.digest", tctx):
                sums = coder.row_digests(handle)
                digests[:] += (host_row_digests(rows) if sums is None
                               else sums)
        with observe.stage("ec.write", tctx):
            # data rows go straight from the host batch (a page-cache view
            # or a pooled staging buffer), which recycles only after every
            # row has been written
            cb = None
            if recycle is not None:
                cb = (lambda b=data: recycle(b))
            fan.put_rows(iter(rows), on_done=cb)

    try:
        _run_pipeline(_traced_batches(batches, tctx), coder.encode_async,
                      consume, op.depth, recycle=recycle,
                      settle=coder.materialize, trace_ctx=tctx)
    finally:
        fan.close()
    if fan.errors:
        raise fan.errors[0]


def stream_encode(base_file_name: str, coder: ErasureCoder,
                  geometry: Geometry = DEFAULT,
                  batch_size: Optional[int] = None,
                  depth: Optional[int] = None,
                  _op: "governor.OperatingPoint | None" = None) -> None:
    """Encode <base>.dat into shard files with the overlapped pipeline and
    commit them with a .ecm marker carrying each shard's digest.

    Byte-identical output to striping.write_ec_files (WriteEcFiles,
    ec_encoder.go:57); only the schedule differs. batch_size/depth
    default to the governor's operating point; passing either pins the
    schedule and skips retuning. _op pins a whole operating point
    (stream_encode_many shares one across its volumes and does the
    window's finish_run itself)."""
    g = geometry
    check_coder(coder, g)
    run_t0 = time.perf_counter()
    dat_size = os.path.getsize(base_file_name + ".dat")
    if _op is not None:
        op, governed = _op, False
    else:
        op, governed = _resolve_op(batch_size, depth, dat_size,
                                   g.data_shards, coder_chips(coder))
        if governed:
            op = _steer_formulation(coder, op)
    src = feed_mod.open_feed(base_file_name + ".dat", g.data_shards,
                             op.batch_size, pool_buffers=op.depth + 2,
                             readers=op.readers, pinned=coder.pinned_host)
    # the stage spans share the caller's trace (stream_encode_many binds
    # its own); a fresh root is minted when none is active
    tctx = observe.ensure_ctx("ec")
    digests = np.zeros(g.total_shards, dtype=np.uint64)
    try:
        _stream_encode_core(
            src.batches(stripe_segments(dat_size, g, op.batch_size)),
            coder, [base_file_name + to_ext(i)
                    for i in range(g.total_shards)],
            op, tctx, recycle=src.recycle, digests=digests)
    finally:
        src.close()
    write_layout_marker(base_file_name, dat_size, g,
                        shard_digests={i: int(digests[i]) & 0xFFFFFFFF
                                       for i in range(g.total_shards)})
    if governed:
        governor.get().finish_run(tctx.trace_id, op, dat_size,
                                  g.data_shards)
    wideevents.emit_stages(
        "ec", f"ec.encode {os.path.basename(base_file_name)}",
        tctx.trace_id, int((time.perf_counter() - run_t0) * 1e6),
        observe.stage_totals(tctx.trace_id, prefix="ec."))


def stream_encode_many(base_file_names: Sequence[str], coder: ErasureCoder,
                       geometry: Geometry = DEFAULT,
                       batch_size: Optional[int] = None,
                       depth: Optional[int] = None) -> int:
    """Encode N volumes back to back through ONE operating point, planned
    once for the whole window (every volume feeds the same [k, B] batch
    shape); the governor retunes once from the window's aggregate spans.
    Returns the number of volumes encoded."""
    g = geometry
    bases = list(base_file_names)
    if not bases:
        return 0
    total = sum(os.path.getsize(b + ".dat") for b in bases)
    op, governed = _resolve_op(batch_size, depth, total, g.data_shards,
                               coder_chips(coder))
    if governed:
        op = _steer_formulation(coder, op)
    tctx = observe.ensure_ctx("ec")
    for base in bases:
        with observe.stage("ec.volume", tctx, tags={"base": base}):
            observe.run_with(tctx, stream_encode, base, coder, g, _op=op)
    if governed:
        governor.get().finish_run(tctx.trace_id, op, total, g.data_shards)
    return len(bases)


def stream_rebuild(base_file_name: str, coder: ErasureCoder,
                   geometry: Geometry = DEFAULT,
                   batch_size: Optional[int] = None,
                   depth: Optional[int] = None) -> list[int]:
    """Regenerate missing shard files from k survivors, overlapped
    (RebuildEcFiles, ec_encoder.go:233-287, with multi-MB strides and
    read/compute/write overlap). Returns the rebuilt shard ids. Runs on
    the governed operating point as stream_encode does."""
    g = geometry
    check_coder(coder, g)
    run_t0 = time.perf_counter()
    present = [i for i in range(g.total_shards)
               if os.path.exists(base_file_name + to_ext(i))]
    missing = [i for i in range(g.total_shards) if i not in present]
    if not missing:
        return []
    if len(present) < g.data_shards:
        raise ValueError(
            f"need {g.data_shards} shards to rebuild, have {len(present)}")
    survivors_ids = tuple(present[:g.data_shards])
    shard_size = os.path.getsize(base_file_name + to_ext(survivors_ids[0]))
    op, governed = _resolve_op(batch_size, depth,
                               g.data_shards * shard_size, g.data_shards,
                               coder_chips(coder))
    if governed:
        # steer before rec_apply_async binds the reconstruction operand
        op = _steer_formulation(coder, op)
    fn = coder.rec_apply_async(survivors_ids, tuple(missing))
    src = feed_mod.ShardFeed(
        [base_file_name + to_ext(i) for i in survivors_ids],
        op.batch_size, pool_buffers=op.depth + 2, readers=op.readers,
        pinned=coder.pinned_host)
    fan = _FanOut([base_file_name + to_ext(i) for i in missing],
                  op.write_depth)
    tctx = observe.ensure_ctx("ec")

    def consume(survivors: np.ndarray, handle) -> None:
        with observe.stage("ec.kernel", tctx), \
                trace_annotation("ec_pipeline_kernel_wait"):
            rebuilt = coder.materialize(handle)
        # the kernel has consumed the survivor batch: recycle it now (the
        # rebuilt rows are the coder's own host memory)
        src.recycle(survivors)
        with observe.stage("ec.write", tctx):
            fan.put_rows(iter(rebuilt))

    try:
        _run_pipeline(_traced_batches(src.batches(op.batch_size), tctx),
                      fn, consume, op.depth, recycle=src.recycle,
                      settle=coder.materialize, trace_ctx=tctx)
    finally:
        fan.close()
        src.close()
    if fan.errors:
        raise fan.errors[0]
    if governed:
        governor.get().finish_run(tctx.trace_id, op,
                                  g.data_shards * shard_size,
                                  g.data_shards)
    wideevents.emit_stages(
        "ec", f"ec.rebuild {os.path.basename(base_file_name)}",
        tctx.trace_id, int((time.perf_counter() - run_t0) * 1e6),
        observe.stage_totals(tctx.trace_id, prefix="ec."))
    return missing


# staged window default: bounded so a volume larger than device memory
# streams in windows; one window still holds a 1 GiB volume
DEFAULT_WINDOW_BYTES = 2 * 1024 * 1024 * 1024


def _windowed_digest_sink(batches: Iterator[np.ndarray], dispatch_window,
                          stage, depth: int, window_bytes: int,
                          stats: dict | None):
    """The staged-window schedule of the device sinks:

      reader thread -> host batches (bounded queue; disk overlaps staging)
      this thread   -> stage each batch (H2D only) and wait for its copy
      window full   -> dispatch_window(staged, acc): the window's kernels
                       and digests, enqueued at once (an
                       ec.dispatch_window span)

    The reference stages on a pool of threads because ``jax.device_put``
    blocks; a copy enqueued on a CUDA stream does not block, so this one
    thread keeps the copies going while the reader reads ahead. Waiting
    for each copy makes ``stage_s`` the copies' real time and lets the
    host batch go at once.

    Fills `stats` (when given) with the measured ledger: read-wait, stage
    seconds and bytes, dispatch seconds, batch and window counts.
    """
    read_q: queue.Queue = queue.Queue(maxsize=depth)
    errors: list[BaseException] = []
    tctx = observe.ensure_ctx("ec")

    def reader_main() -> None:
        try:
            for item in batches:
                read_q.put(item)
        except BaseException as e:
            errors.append(e)
        finally:
            read_q.put(_SENTINEL)

    reader = threading.Thread(target=reader_main, daemon=True)
    reader.start()

    acc = None
    staged: list = []
    staged_bytes = total_bytes = 0
    t_read = t_stage = t_dispatch = 0.0
    n_batches = n_windows = 0

    def flush_window() -> None:
        nonlocal acc, staged, staged_bytes, n_windows, t_dispatch
        if not staged:
            return
        t0 = time.perf_counter()
        with observe.stage("ec.dispatch_window", tctx,
                           tags={"batches": len(staged)}):
            acc = dispatch_window(staged, acc)
        t_dispatch += time.perf_counter() - t0
        n_windows += 1
        staged = []
        staged_bytes = 0

    drained = False
    try:
        while True:
            t0 = time.perf_counter()
            batch = read_q.get()
            t_read += time.perf_counter() - t0
            if batch is _SENTINEL:
                drained = True
                break
            t0 = time.perf_counter()
            handle = stage(batch)
            block = getattr(handle, "block_until_ready", None)
            if block is not None:
                block()
            staged.append(handle)
            t_stage += time.perf_counter() - t0
            staged_bytes += batch.nbytes
            total_bytes += batch.nbytes
            n_batches += 1
            if staged_bytes >= window_bytes:
                flush_window()
        flush_window()
    finally:
        while not drained and read_q.get() is not _SENTINEL:
            pass  # unblock a reader stuck on a full queue after an error
        reader.join()
    if errors:
        raise errors[0]
    if stats is not None:
        stats.update({
            "staged_bytes": total_bytes, "n_batches": n_batches,
            "n_windows": n_windows, "read_wait_s": t_read,
            "stage_s": t_stage,
            "stage_gbps": (total_bytes / t_stage / 1e9
                           if t_stage > 1e-9 else None),
            "dispatch_s": t_dispatch,
        })
    return acc


def _finish_sink(coder: ErasureCoder, acc, rows: int, materialize: bool,
                 stats: dict | None, t_all: float, size_key: str,
                 size: int):
    """The sink's result: the uint32 digest, or with materialize=False the
    coder's unmaterialized handle (coder.materialize makes it real), so a
    caller can run several volumes before it waits once."""
    if acc is None:
        out = np.zeros(rows, dtype=np.uint32)
    elif not materialize:
        out = acc
    else:
        t0 = time.perf_counter()
        out = np.asarray(coder.materialize(acc), dtype=np.uint32)
        if stats is not None:
            stats["wait_s"] = time.perf_counter() - t0
    if stats is not None:
        stats["total_s"] = time.perf_counter() - t_all
        stats[size_key] = size
    return out


def stream_encode_device_sink(base_file_name: str, coder: ErasureCoder,
                              geometry: Geometry = DEFAULT,
                              batch_size: int = DEFAULT_BATCH_SIZE,
                              depth: int = DEFAULT_DEPTH,
                              window_bytes: int = DEFAULT_WINDOW_BYTES,
                              stats: dict | None = None,
                              materialize: bool = True):
    """stream_encode with the parity landing in an on-device sink.

    Reads <base>.dat in stream_encode's batches, stages them onto the
    device and reduces each window's parity to an [m] uint32 wrapping
    byte-sum digest (_windowed_digest_sink): only the digest crosses back
    and no shard file is written. The digest equals parity_file_digest()
    of the shards stream_encode writes (the padding encodes to zeros), so
    the sink does the full encode, not a shortcut. `stats` gets the
    measured ledger."""
    g = geometry
    check_coder(coder, g)
    dat_size = os.path.getsize(base_file_name + ".dat")
    # unpooled: a whole window of batches stays referenced until its
    # one dispatch; padded: every batch of a window has one shape
    src = feed_mod.open_feed(base_file_name + ".dat", g.data_shards,
                             batch_size, pooled=False,
                             pinned=coder.pinned_host)
    t_all = time.perf_counter()
    try:
        acc = _windowed_digest_sink(
            src.batches(stripe_segments(dat_size, g, batch_size),
                        pad_final=True),
            coder.encode_digest_window_async, coder.stage_async, depth,
            window_bytes, stats)
    finally:
        src.close()
    return _finish_sink(coder, acc, g.parity_shards, materialize, stats,
                        t_all, "volume_bytes", dat_size)


def stream_rebuild_device_sink(base_file_name: str, coder: ErasureCoder,
                               victims: Sequence[int],
                               geometry: Geometry = DEFAULT,
                               batch_size: int = DEFAULT_BATCH_SIZE,
                               depth: int = DEFAULT_DEPTH,
                               window_bytes: int = DEFAULT_WINDOW_BYTES,
                               stats: dict | None = None,
                               materialize: bool = True):
    """stream_rebuild with the reconstructed shards landing in an
    on-device digest sink.

    Treats `victims` as missing, streams k survivor shard files through
    the staged-window schedule, reconstructs the victim rows on the device
    and digests them to [len(victims)] uint32 wrapping byte sums, in the
    caller's order of `victims`: comparable with shard_file_digest() of
    the real shard files. The survivors are the first k present shards
    that are not victims, as RebuildEcFiles (ec_encoder.go:233-287)
    chooses them."""
    g = geometry
    check_coder(coder, g)
    victims = tuple(victims)
    present = [i for i in range(g.total_shards)
               if i not in victims
               and os.path.exists(base_file_name + to_ext(i))]
    if len(present) < g.data_shards:
        raise ValueError(
            f"need {g.data_shards} survivors, have {len(present)}")
    survivors_ids = tuple(present[:g.data_shards])
    src = feed_mod.ShardFeed(
        [base_file_name + to_ext(i) for i in survivors_ids], batch_size,
        pooled=False, pinned=coder.pinned_host)
    shard_size = src.shard_size
    t_all = time.perf_counter()

    def dispatch_window(staged, acc):
        return coder.rec_digest_window_async(survivors_ids, victims,
                                             staged, acc)

    try:
        acc = _windowed_digest_sink(
            src.batches(batch_size, pad_final=True), dispatch_window,
            coder.stage_async, depth, window_bytes, stats)
    finally:
        src.close()
    return _finish_sink(coder, acc, len(victims), materialize, stats,
                        t_all, "shard_bytes", shard_size)


def shard_file_digest(base_file_name: str,
                      shard_ids: Sequence[int]) -> np.ndarray:
    """[len(ids)] uint32 wrapping byte sum of each shard file: the
    host-side cross-check of the device sinks. Accumulates in uint64 and
    masks once at the end."""
    out = []
    for i in shard_ids:
        total = np.uint64(0)
        with open(base_file_name + to_ext(i), "rb") as f:
            while True:
                chunk = f.read(1 << 24)
                if not chunk:
                    break
                total += np.sum(np.frombuffer(chunk, dtype=np.uint8),
                                dtype=np.uint64)
        out.append(int(total) & 0xFFFFFFFF)
    return np.asarray(out, dtype=np.uint32)


def read_stamped_digests(base_file_name: str) -> dict[int, int]:
    """shard id -> stamped uint32 byte-sum digest from the .ecm sidecar
    ({} when the marker is absent or carries no digests)."""
    try:
        with open(base_file_name + ".ecm") as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return {}
    return {int(k): int(v)
            for k, v in (meta.get("shard_digests") or {}).items()}


def stamp_shard_digests(base_file_name: str,
                        geometry: Geometry = DEFAULT) -> dict[int, int]:
    """Record each local shard file's digest into the .ecm sidecar.
    Merge-only: a shard id already stamped keeps its value (recomputing
    over a shard that has since rotted would launder the corruption into
    the record), so the truth is set once, when the bytes are known to be
    good. No-op without a marker: a digests-only .ecm would not name a
    layout. Recomputed digests count in the shared "ec" registry
    (``ec_digest_host_recompute``): encode passes that stamp inline leave
    nothing to recompute."""
    path = base_file_name + ".ecm"
    try:
        with open(path) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return {}
    digests = {int(k): int(v)
               for k, v in (meta.get("shard_digests") or {}).items()}
    recomputed = 0
    for sid in range(geometry.total_shards):
        if sid in digests or not os.path.exists(
                base_file_name + to_ext(sid)):
            continue
        digests[sid] = int(shard_file_digest(base_file_name, [sid])[0])
        recomputed += 1
    if recomputed:
        metrics_mod.shared("ec").count("ec_digest_host_recompute",
                                       recomputed)
    meta["shard_digests"] = {str(k): v
                             for k, v in sorted(digests.items())}
    durable.write_json_atomic(path, meta)
    return digests


def parity_file_digest(base_file_name: str,
                       geometry: Geometry = DEFAULT) -> np.ndarray:
    """[m] uint32 wrapping byte sum of each parity shard file: the
    host-side cross-check of stream_encode_device_sink."""
    g = geometry
    return shard_file_digest(
        base_file_name, range(g.data_shards, g.total_shards))
