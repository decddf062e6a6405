"""One-pass warm-down: fused compaction + gzip + RS encode + digest.

The port's copy of seaweedfs_tpu/ec/fused.py. One call takes a live
volume with deleted space straight to erasure-coded shards: live needles
are copied out (compaction, the Compact2 snapshot walk,
weed/storage/volume_vacuum.go:66-89), payloads gzipped where it pays
(weed/util/compression.go), the compacted ``.dat`` stream feeds the
overlapped encode pipeline (ec/pipeline.py), and the scrubber's reference
digests fall out of the same pass into ``.ecm``. The phases overlap: the
card encodes the head of the compacted volume while the host is still
compacting its tail.

- Live-needle extents become per-chunk jobs on the feed's reader pool
  (ec/feed.py): each job preads its coalesced source extents, checks
  their CRC and gzip-splices records on a pool thread, while an ordered
  consumer appends them to ``<dst>.dat``/``.idx`` in snapshot order. The
  pool width is the governor's ``gzip_workers`` axis
  (``WEED_EC_GZIP_WORKERS``); pread, crc32c (through ctypes on the card's
  host) and deflate all release the GIL, so workers scale with cores.
- Records move as raw bytes: a needle that declines gzip is copied
  verbatim (after its CRC check), and a needle that takes it has the
  compressed payload spliced into the stored record (size, data_size,
  flags and checksum rewritten, the optionals tail and the v3 timestamp
  kept byte for byte). No needle object is built.
- ``_gated_segments`` reproduces striping.stripe_segments over a file
  still being written. The live-needle size sum from the in-memory needle
  map (an upper bound: gzip only shrinks records) sizes the feed up
  front, a flushed-bytes watermark proves each large-row decision before
  the final size is known, and every segment waits only until its own
  bytes are flushed, so the encode starts after the first chunk lands.
  The feed is always ``PreadvFeed``: the mmap feed maps a file's size
  once and cannot follow a growing file.
- Shard-row digests accumulate inside the encode pass
  (pipeline._stream_encode_core: on the card the kernels' digest
  epilogue) and land in the ``.ecm`` marker.

Durability: shard files are fsynced by their writers, then ``.dat`` and
``.idx`` are fsynced and ``.ecx`` written and fsynced, and only then is
the ``.ecm`` marker committed (an atomic durable write). Any exception
mid-pass deletes every partial destination file, leaving the source
volume as the only copy. Fault points: ``ec.fused.read`` (a drop fails
the chunk read), ``ec.fused.gzip`` (a drop fails the transform),
``ec.fused.commit`` (a drop aborts just before the marker). Spans:
``ec.compact`` and ``ec.gzip`` per chunk job, the pipeline's ``ec.*``
stages, and ``ec.volume`` per volume of a window.

v1 volumes are compacted verbatim without gzip: a v1 record has no flags
byte, so compression is not representable.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Iterator, Optional

import numpy as np

from .. import faults, observe
from ..observe import wideevents
from ..storage import idx as idx_mod
from ..storage import types as t
from ..storage.needle import (FLAG_IS_COMPRESSED, CrcError, crc32c_update,
                              crc_value)
from ..storage.superblock import SuperBlock
from ..utils import compression
from . import feed as feed_mod
from . import governor, striping
from .coder import ErasureCoder
from .geometry import DEFAULT, Geometry, to_ext
from .pipeline import (_resolve_op, _steer_formulation, _stream_encode_core,
                       coder_chips)

# stored extent per compaction chunk job: big enough that pread/deflate
# dominate the per-job overhead, small enough that the ordered window
# (gzip_workers + 2 chunks in flight) stays tens of MB
_CHUNK_BYTES = 4 * 1024 * 1024
_CHUNK_NEEDLES = 1024


class _Watermark:
    """Flushed-byte watermark of the growing compacted .dat: the
    handshake between the compaction consumer (advances it after each
    flushed chunk) and the gated segment generator (waits on it)."""

    def __init__(self) -> None:
        self._cv = threading.Condition()
        self.flushed = 0
        self.total: Optional[int] = None
        self.error: Optional[BaseException] = None

    def advance(self, flushed: int) -> None:
        with self._cv:
            self.flushed = flushed
            self._cv.notify_all()

    def finish(self, total: int) -> None:
        with self._cv:
            self.total = total
            self.flushed = total
            self._cv.notify_all()

    def fail(self, exc: BaseException) -> None:
        with self._cv:
            self.error = exc
            self._cv.notify_all()

    def _check(self) -> None:
        if self.error is not None:
            raise RuntimeError("fused compaction failed") from self.error

    def wait_decidable(self, processed: int,
                       threshold: int) -> Optional[int]:
        """Block until the next stripe row's tier is decidable. Returns
        the exact total once compaction finished; None means the
        watermark already proves the remainder exceeds `threshold` (the
        row is large: flushed is a lower bound on the final size)."""
        with self._cv:
            while True:
                self._check()
                if self.total is not None:
                    return self.total
                if self.flushed - processed > threshold:
                    return None
                self._cv.wait(0.05)

    def wait_cover(self, end: int) -> None:
        """Block until the compacted file covers [0, end), or is final
        (reads past the real EOF are layout padding and zero-fill)."""
        with self._cv:
            while True:
                self._check()
                if self.total is not None or self.flushed >= end:
                    return
                self._cv.wait(0.05)


def _gated_segments(g: Geometry, batch_size: int,
                    wm: _Watermark) -> Iterator[tuple[list[int], int]]:
    """striping.stripe_segments over a file still being written.

    The same sequence as stripe_segments(final_size, g, batch_size): a
    large row is emitted only when total - processed > large_row -
    small_row, which wait_decidable either proves early from the
    watermark (flushed <= total) or answers from the final total; the
    small regime and the end always use the exact total. Each segment
    also waits for its own byte coverage, so the feed never preads bytes
    compaction has not flushed."""
    threshold = g.large_row_size - g.small_row_size
    processed = 0
    while True:
        total = wm.wait_decidable(processed, threshold)
        if total is None or total - processed > threshold:
            block, row = g.large_block_size, g.large_row_size
        elif total - processed > 0:
            block, row = g.small_block_size, g.small_row_size
        else:
            return
        b = striping.clamp_batch(batch_size, block)
        for batch_start in range(0, block, b):
            offsets = [processed + block * i + batch_start
                       for i in range(g.data_shards)]
            wm.wait_cover(offsets[-1] + b)
            yield (offsets, b)
        processed += row


def _transform_record(raw, size: int, version: int,
                      gzip_level: int) -> tuple:
    """CRC-check one stored record and splice in a gzipped payload when
    it pays. Returns (record_bytes, body_size, gzip_seconds, adopted).

    The passthrough record is the raw stored extent; the spliced record
    is byte-identical to Needle.to_bytes of the compressed needle: header
    cookie and id kept, size and data_size rewritten, FLAG_IS_COMPRESSED
    set, the optionals tail (name/mime/lm/ttl/pairs) and the v3
    append_at_ns copied verbatim, the CRC recomputed over the compressed
    payload, zero padding to the 8-byte grain."""
    if version == t.VERSION1:
        # no flags byte in a v1 body: copy verbatim (still CRC-checked)
        data = raw[t.NEEDLE_HEADER_SIZE:t.NEEDLE_HEADER_SIZE + size]
        if size > 0 and t.get_u32(raw, t.NEEDLE_HEADER_SIZE + size) != \
                crc_value(crc32c_update(0, data)):
            raise CrcError(f"needle {t.get_u64(raw, 4):x} CRC mismatch "
                           "during fused compaction")
        return raw, size, 0.0, False
    if size <= 0:
        return raw, size, 0.0, False
    data_size = t.get_u32(raw, 16)
    data = bytes(raw[20:20 + data_size])
    stored_crc = t.get_u32(raw, 16 + size)
    if stored_crc != crc_value(crc32c_update(0, data)):
        raise CrcError(f"needle {t.get_u64(raw, 4):x} CRC mismatch "
                       "during fused compaction")
    flags = raw[20 + data_size]
    if (flags & FLAG_IS_COMPRESSED) or not data:
        return raw, size, 0.0, False
    gz0 = time.perf_counter()
    # sniff a 4 KiB prefix first: gzipping incompressible payloads
    # (media, ciphertext) is the largest waste in a mixed-content vacuum
    head = data[:4096]
    trial = compression.compress(head, level=gzip_level)
    if len(trial) * 10 >= len(head) * 9:
        return raw, size, time.perf_counter() - gz0, False
    comp = compression.compress(data, level=gzip_level)
    if len(comp) * 10 >= len(data) * 9:
        return raw, size, time.perf_counter() - gz0, False
    tail = bytes(raw[21 + data_size:16 + size])
    new_size = 4 + len(comp) + 1 + len(tail)
    parts = [bytes(raw[0:12]), t.put_u32(t.size_to_u32(new_size)),
             t.put_u32(len(comp)), comp,
             bytes([(flags | FLAG_IS_COMPRESSED) & 0xFF]), tail,
             t.put_u32(crc_value(crc32c_update(0, comp)))]
    if version == t.VERSION3:
        parts.append(bytes(raw[20 + size:28 + size]))  # append_at_ns
    parts.append(bytes(t.padding_length(new_size, version)))
    return b"".join(parts), new_size, time.perf_counter() - gz0, True


def _transform_chunk(read_at, entries: list, version: int, gzip_level: int,
                     tctx) -> tuple[list, int, float]:
    """One reader-pool job: pread a chunk's live extents (adjacent
    extents coalesced into single positioned reads), check and
    gzip-splice each record. Returns ([(key, body_size, record)],
    gzipped, gzip_s). Records one ec.compact and one ec.gzip span
    against the captured context (this runs on a pool thread)."""
    start_us = int(time.time() * 1e6)
    t0 = time.perf_counter()
    if faults.fire("ec.fused.read"):
        # a drop must fail the read: skipping live extents would compact
        # acknowledged needles out of existence
        raise IOError("injected drop at ec.fused.read")
    raws: list = []
    i, n_e = 0, len(entries)
    while i < n_e:
        lo = entries[i][1]
        end, j = lo, i
        while j < n_e and entries[j][1] == end:
            end += entries[j][3]
            j += 1
        blob = read_at(end - lo, lo)
        if len(blob) != end - lo:
            raise IOError(f"fused compaction short read at {lo}: "
                          f"{len(blob)} != {end - lo}")
        mv = memoryview(blob)
        pos = 0
        for kk in range(i, j):
            ln = entries[kk][3]
            raws.append(mv[pos:pos + ln])
            pos += ln
        i = j
    if faults.fire("ec.fused.gzip"):
        raise IOError("injected drop at ec.fused.gzip")
    out: list = []
    gzipped = 0
    gzip_s = 0.0
    for (key, _off, size, _ln), raw in zip(entries, raws):
        rec, body_size, gz, adopted = _transform_record(
            raw, size, version, gzip_level)
        gzip_s += gz
        gzipped += 1 if adopted else 0
        out.append((key, body_size, rec))
    dur_us = int((time.perf_counter() - t0) * 1e6)
    gzip_us = int(gzip_s * 1e6)
    observe.record_span("ec.gzip", tctx, start_us, gzip_us,
                        tags={"needles": len(entries)})
    observe.record_span("ec.compact", tctx, start_us,
                        max(dur_us - gzip_us, 0),
                        tags={"needles": len(entries)})
    return out, gzipped, gzip_s


def _cleanup_dst(dst_base: str, g: Geometry) -> None:
    """Fail closed: remove every partial destination file, so an aborted
    pass leaves only the intact source volume."""
    paths = [dst_base + ext for ext in (".dat", ".idx", ".ecx", ".ecm")]
    paths += [dst_base + to_ext(i) for i in range(g.total_shards)]
    for p in paths:
        try:
            os.remove(p)
        except OSError:
            pass


def fused_vacuum_gzip_encode(volume, dst_base: str, coder: ErasureCoder,
                             geometry: Geometry = DEFAULT,
                             batch_size: Optional[int] = None,
                             gzip_level: int = 1,
                             depth: Optional[int] = None,
                             _op: "governor.OperatingPoint | None" = None
                             ) -> dict:
    """Compact `volume` into <dst_base>.dat (gzipping payloads where it
    pays) while erasure-coding the growing result through the overlapped
    pipeline: one pass, byte-identical output to sequential vacuum ->
    gzip -> encode. The source volume is untouched.

    batch_size/depth default to the governor's operating point (which
    also sets the compaction pool width, `gzip_workers`); passing either
    pins the schedule. _op pins a whole operating point (the window of
    fused_vacuum_gzip_encode_many). Returns {live_needles, src_bytes,
    compacted_bytes, shard_files, gzipped_needles, gzip_s,
    shard_digests, batch_size, readers, gzip_workers, wall_s,
    commit_s}."""
    g = geometry
    striping.check_coder(coder, g)
    run_t0 = time.perf_counter()
    src_size = volume.data_file_size()
    version = volume.version
    offset_size = volume.offset_size
    with volume._lock:
        snapshot = [(nv.key, t.stored_to_offset(nv.offset), nv.size)
                    for nv in volume.nm.values()
                    if t.size_is_valid(nv.size)]
        sb = SuperBlock(
            version=volume.super_block.version,
            replica_placement=volume.super_block.replica_placement,
            ttl=volume.super_block.ttl,
            compaction_revision=volume.super_block.compaction_revision + 1,
            extra=volume.super_block.extra)
        # a descriptor of this .dat of the pass's own: a vacuum commit
        # that swaps the volume's files closes the volume's descriptor,
        # never this one, and the offsets above stay this file's. A
        # tiered .dat has no descriptor: it is read through its object
        # store, as the reference reads it (and it is never compacted)
        src_fd = (os.dup(volume._dat.fileno()) if volume._dat.is_local
                  else None)
        remote_read_at = volume._dat.read_at
    try:
        snapshot.sort(key=lambda e: e[1])
        entries = [(key, off, size, t.get_actual_size(size, version))
                   for key, off, size in snapshot]
        sb_bytes = sb.to_bytes()
        head_len = len(sb_bytes) + ((-len(sb_bytes)) % t.NEEDLE_PADDING_SIZE)
        # upper bound on the compacted size, known before any byte moves:
        # gzip only ever shrinks a record and the 8-byte grain is kept
        upper = head_len + sum(e[3] for e in entries)
        if _op is not None:
            op, governed = _op, False
        else:
            op, governed = _resolve_op(batch_size, depth, upper, g.data_shards,
                                       coder_chips(coder))
            if governed:
                op = _steer_formulation(coder, op)
        tctx = observe.ensure_ctx("ec")
        wm = _Watermark()

        def read_at(n: int, offset: int) -> bytes:
            if src_fd is None:
                return remote_read_at(n, offset)
            return os.pread(src_fd, n, offset)

        counters = {"gzipped": 0, "gzip_s": 0.0}

        chunks: list[list] = []
        cur: list = []
        cur_bytes = 0
        for e in entries:
            cur.append(e)
            cur_bytes += e[3]
            if cur_bytes >= _CHUNK_BYTES or len(cur) >= _CHUNK_NEEDLES:
                chunks.append(cur)
                cur, cur_bytes = [], 0
        if cur:
            chunks.append(cur)

        pool = feed_mod._ReaderPool(max(1, op.gzip_workers))
        dat_f, idx_f = striping._open_all(
            [dst_base + ".dat", dst_base + ".idx"], "wb")
        shard_paths = [dst_base + to_ext(i) for i in range(g.total_shards)]
        digests = np.zeros(g.total_shards, dtype=np.uint64)

        def compactor() -> None:
            try:
                dat_f.write(sb_bytes)
                offset = len(sb_bytes)
                jobs = (
                    (lambda chunk=chunk: _transform_chunk(
                        read_at, chunk, version, gzip_level, tctx))
                    for chunk in chunks)
                for results, gzipped, gzip_s in feed_mod.ordered_pool_map(
                        pool, jobs, op.gzip_workers + 2):
                    counters["gzipped"] += gzipped
                    counters["gzip_s"] += gzip_s
                    buf: list = []
                    for key, body_size, rec in results:
                        pad = (-offset) % t.NEEDLE_PADDING_SIZE
                        if pad:
                            buf.append(bytes(pad))
                            offset += pad
                        buf.append(rec)
                        idx_f.write(idx_mod.pack_entry(
                            key, t.offset_to_stored(offset, offset_size),
                            body_size, offset_size=offset_size))
                        offset += len(rec)
                    dat_f.writelines(buf)
                    # flush before advancing: the feed preads this range
                    # through its own fd as soon as the watermark covers it
                    dat_f.flush()
                    wm.advance(offset)
                dat_f.flush()
                wm.finish(offset)
            except BaseException as e:
                wm.fail(e)

        try:
            try:
                feed = feed_mod.PreadvFeed(
                    dst_base + ".dat", g.data_shards, op.batch_size,
                    pool_buffers=op.depth + 2, readers=op.readers,
                    odirect=False, pinned=coder.pinned_host)
                # the file grows under the feed: the gated segments gate the
                # reads, and this size only bounds the feed's zero-fill of
                # offsets past the end (the final size is at most `upper`;
                # reads between it and `upper` find EOF and zero-fill too)
                feed.size = upper
                compact_th = threading.Thread(target=compactor, daemon=True,
                                              name="ec-fused-compact")
                compact_th.start()
                try:
                    _stream_encode_core(
                        feed.batches(_gated_segments(g, op.batch_size, wm)),
                        coder, shard_paths, op, tctx,
                        recycle=feed.recycle, digests=digests)
                finally:
                    compact_th.join()
                    feed.close()
                if wm.error is not None:
                    raise RuntimeError(
                        "fused compaction failed") from wm.error
                total = wm.total or 0
                # the shards are fsynced (fan writers); now the volume pair
                dat_f.flush()
                os.fsync(dat_f.fileno())
                idx_f.flush()
                os.fsync(idx_f.fileno())
            finally:
                pool.close()
                dat_f.close()
                idx_f.close()
            commit_t0 = time.perf_counter()
            striping.write_sorted_ecx_from_idx(dst_base,
                                               offset_size=offset_size)
            fd = os.open(dst_base + ".ecx", os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
            if faults.fire("ec.fused.commit"):
                raise IOError("injected abort at ec.fused.commit")
            # the durable commit point: everything above is on disk before
            # the marker makes the shard set reachable
            shard_digests = {i: int(digests[i]) & 0xFFFFFFFF
                             for i in range(g.total_shards)}
            striping.write_layout_marker(dst_base, total, g,
                                         shard_digests=shard_digests)
            commit_s = time.perf_counter() - commit_t0
        except BaseException:
            _cleanup_dst(dst_base, g)
            raise
        if governed:
            governor.get().finish_run(tctx.trace_id, op, upper, g.data_shards)
        wall_s = time.perf_counter() - run_t0
        wideevents.emit_stages(
            "ec", f"ec.fused {os.path.basename(dst_base)}", tctx.trace_id,
            int(wall_s * 1e6), observe.stage_totals(tctx.trace_id,
                                                    prefix="ec."))
        return {
            "live_needles": len(entries),
            "src_bytes": src_size,
            "compacted_bytes": total,
            "shard_files": g.total_shards,
            "gzipped_needles": counters["gzipped"],
            "gzip_s": round(counters["gzip_s"], 3),
            "shard_digests": shard_digests,
            "batch_size": op.batch_size,
            "readers": op.readers,
            "gzip_workers": op.gzip_workers,
            "wall_s": round(wall_s, 3),
            "commit_s": round(commit_s, 3),
        }
    finally:
        if src_fd is not None:
            os.close(src_fd)


def fused_vacuum_gzip_encode_many(volumes, dst_bases, coder: ErasureCoder,
                                  geometry: Geometry = DEFAULT,
                                  gzip_level: int = 1) -> list[dict]:
    """Warm-down a window of volumes through one governed operating
    point, planned once for the window (every volume feeds the same
    [k, B] batch shape and the same reader and gzip pool widths); the
    governor retunes once from the window's aggregate spans."""
    vols = list(volumes)
    bases = list(dst_bases)
    if not vols:
        return []
    total = sum(v.data_file_size() for v in vols)
    op, governed = _resolve_op(None, None, total, geometry.data_shards,
                               coder_chips(coder))
    op = _steer_formulation(coder, op)
    tctx = observe.ensure_ctx("ec")
    out = []
    for v, base in zip(vols, bases):
        with observe.stage("ec.volume", tctx, tags={"base": base}):
            out.append(observe.run_with(
                tctx, fused_vacuum_gzip_encode, v, base, coder, geometry,
                gzip_level=gzip_level, _op=op))
    if governed:
        governor.get().finish_run(tctx.trace_id, op, total,
                                  geometry.data_shards)
    return out
