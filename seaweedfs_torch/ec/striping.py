"""File-level EC operations: .dat <-> .ec00..ec13 (+ .ecx/.ecj/.ecm/.idx).

The port's reduced copy of seaweedfs_tpu/ec/striping.py (upstream
weed/storage/erasure_coding/ec_encoder.go:57-306, ec_decoder.go). On-disk
artifacts are byte-identical to the reference for the same input:

- shard files are written row-major: while more than one large row of data
  remains, a row is k large blocks RS-encoded batch by batch; the tail is
  striped in small-block rows; the final row is zero-padded but written
  full-length, so shard sizes are whole multiples of the block sizes;
- .ecx is the .idx journal folded and sorted ascending by needle id;
- .ecj is a flat journal of deleted needle ids (8 bytes each);
- .ecm records the layout version, the geometry and the shard digests.

The bulk encode and rebuild are ec/pipeline.py's ``stream_encode`` and
``stream_rebuild``; ``write_ec_files`` / ``rebuild_ec_files`` here are the
simple synchronous loops kept as their reference shape.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Iterator, Optional

import numpy as np

from ..storage import idx as idx_mod
from ..storage import types as t
from ..storage.needle_map import SortedNeedleMap
from ..utils import durable
from .coder import ErasureCoder
from .geometry import DEFAULT, Geometry, to_ext

DEFAULT_BUFFER_SIZE = 256 * 1024


def clamp_batch(batch_size: int, block_size: int) -> int:
    """Largest usable stripe-batch width: divides block_size, <= batch_size."""
    b = min(batch_size, block_size)
    while block_size % b:
        b -= 1
    return b


def _open_all(paths: list, mode: str) -> list:
    """Open every path or none: a failure mid-way (EMFILE, ENOSPC, a
    permission wall on shard 7 of 14) closes the handles already opened
    before re-raising."""
    files: list = []
    try:
        for p in paths:
            files.append(open(p, mode))
    except BaseException:
        for f in files:
            try:
                f.close()
            except OSError:
                pass
        raise
    return files


def stripe_segments(dat_size: int, g: Geometry,
                    batch_size: int) -> Iterator[tuple[list[int], int]]:
    """(k strided .dat offsets, width) per stripe batch, in shard-file
    append order (row-major two-tier striping, ec_encoder.go:194-231).

    This is THE layout iteration: write_ec_files' row loop, the streaming
    pipeline and the feed (ec/feed.py) all derive shard bytes from these
    segments, which is what keeps their outputs byte-identical.
    Offsets within one segment are uniformly strided by the block size;
    offsets at or past dat_size read as zeros (final-row padding).
    """
    def rows(start: int, block_size: int) -> Iterator[tuple[list[int], int]]:
        b = clamp_batch(batch_size, block_size)
        for batch_start in range(0, block_size, b):
            yield ([start + block_size * i + batch_start
                    for i in range(g.data_shards)], b)

    remaining = dat_size
    processed = 0
    # same large-row rule as write_ec_files: a tail needing a full
    # large_block worth of small rows would make the shard size ambiguous
    # for locate; pad the final large row instead
    while remaining > g.large_row_size - g.small_row_size:
        yield from rows(processed, g.large_block_size)
        remaining -= g.large_row_size
        processed += g.large_row_size
    while remaining > 0:
        yield from rows(processed, g.small_block_size)
        remaining -= g.small_row_size
        processed += g.small_row_size


def write_sorted_ecx_from_idx(base_file_name: str, ext: str = ".ecx",
                              offset_size: int = t.OFFSET_SIZE) -> None:
    """Generate the sorted EC index from the .idx journal
    (WriteSortedFileFromIdx, ec_encoder.go:27-54)."""
    db = SortedNeedleMap.from_idx_file(base_file_name + ".idx", offset_size)
    db.write_sorted_index(base_file_name + ext)


def write_ec_files(base_file_name: str, coder: ErasureCoder,
                   geometry: Geometry = DEFAULT,
                   buffer_size: int = DEFAULT_BUFFER_SIZE) -> None:
    """Encode <base>.dat into <base>.ec00 .. (WriteEcFiles,
    ec_encoder.go:57)."""
    g = geometry
    check_coder(coder, g)
    dat_size = os.path.getsize(base_file_name + ".dat")
    outputs = _open_all([base_file_name + to_ext(i)
                         for i in range(g.total_shards)], "wb")
    try:
        with open(base_file_name + ".dat", "rb") as dat:
            remaining = dat_size
            processed = 0
            # large rows while the tail does not fit in fewer than
            # large/small small rows; otherwise the final large row is
            # zero-padded (layout version 2, see ec/locate.py)
            while remaining > g.large_row_size - g.small_row_size:
                _encode_row(dat, coder, processed, g.large_block_size,
                            min(buffer_size, g.large_block_size), outputs, g)
                remaining -= g.large_row_size
                processed += g.large_row_size
            while remaining > 0:
                _encode_row(dat, coder, processed, g.small_block_size,
                            min(buffer_size, g.small_block_size), outputs, g)
                remaining -= g.small_row_size
                processed += g.small_row_size
        # shard bytes reach the platter before the .ecm marker commits
        # the set
        for f in outputs:
            f.flush()
            os.fsync(f.fileno())
    finally:
        for f in outputs:
            f.close()
    write_layout_marker(base_file_name, dat_size, g)


LAYOUT_VERSION = 2  # padded-final-large-row tail rule (see write_ec_files)


def check_coder(coder: ErasureCoder, g: Geometry) -> None:
    if (coder.k, coder.m) != (g.data_shards, g.parity_shards):
        raise ValueError(f"coder RS({coder.k},{coder.m}) does not match "
                         f"geometry RS({g.data_shards},{g.parity_shards})")


def write_layout_marker(base_file_name: str, dat_size: int,
                        geometry: Optional[Geometry] = None,
                        shard_digests: "Optional[dict[int, int]]" = None
                        ) -> None:
    """Commit the shard set: a .ecm sidecar with the striping layout
    version, the .dat size, the RS geometry the shards were encoded
    under and, when given, each shard's uint32 wrapping byte-sum digest
    ({shard id: digest}), all in one durable write."""
    meta: dict = {"layout_version": LAYOUT_VERSION, "dat_size": dat_size}
    if geometry is not None:
        meta["geometry"] = {
            "data_shards": geometry.data_shards,
            "parity_shards": geometry.parity_shards,
            "large_block_size": geometry.large_block_size,
            "small_block_size": geometry.small_block_size,
        }
    if shard_digests:
        meta["shard_digests"] = {str(k): int(v) & 0xFFFFFFFF
                                 for k, v in sorted(shard_digests.items())}
    durable.write_json_atomic(base_file_name + ".ecm", meta)


def read_marker_geometry(base_file_name: str) -> Optional[Geometry]:
    """The RS geometry stamped into the .ecm sidecar, or None (a marker
    without one, or no marker). Rebuild, mount and decode prefer it to
    any policy: it is the record of what the bytes are."""
    try:
        with open(base_file_name + ".ecm") as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return None
    g = meta.get("geometry")
    if not isinstance(g, dict):
        return None
    try:
        return Geometry(
            data_shards=int(g["data_shards"]),
            parity_shards=int(g["parity_shards"]),
            large_block_size=int(g.get("large_block_size",
                                       DEFAULT.large_block_size)),
            small_block_size=int(g.get("small_block_size",
                                       DEFAULT.small_block_size)))
    except (KeyError, ValueError):
        return None


def check_layout_marker(base_file_name: str, shard_size: int,
                        g: Geometry) -> None:
    """Detect stale striping layouts at serve time. A marker with another
    layout version is a hard error (the set was encoded under another
    tail rule and would misaddress). An absent marker on a shard size
    that is a whole number of large blocks is only a warning: every
    healthy set of whole large rows has that size too, and a missing
    sidecar must not take valid data offline."""
    path = base_file_name + ".ecm"
    if os.path.exists(path):
        with open(path) as f:
            meta = json.load(f)
        if meta.get("layout_version") != LAYOUT_VERSION:
            raise IOError(
                f"{base_file_name}: EC layout version "
                f"{meta.get('layout_version')} != {LAYOUT_VERSION}; "
                "re-encode this volume")
        return
    if (shard_size and shard_size >= g.large_block_size
            and shard_size % g.large_block_size == 0):
        logging.getLogger("ec").warning(
            "%s: unmarked EC shard set whose size (%d) is a whole number "
            "of large blocks; if it was encoded before the v2 tail rule "
            "it will misaddress — re-encode it to stamp a .ecm",
            base_file_name, shard_size)


def _encode_row(dat, coder: ErasureCoder, start_offset: int, block_size: int,
                buffer_size: int, outputs, g: Geometry) -> None:
    """One stripe row: k blocks of block_size, encoded in buffer_size batches
    (encodeData + encodeDataOneBatch, ec_encoder.go:120-231)."""
    for batch_start in range(0, block_size, buffer_size):
        data = np.zeros((g.data_shards, buffer_size), dtype=np.uint8)
        for i in range(g.data_shards):
            dat.seek(start_offset + block_size * i + batch_start)
            chunk = dat.read(buffer_size)
            if chunk:
                data[i, :len(chunk)] = np.frombuffer(chunk, dtype=np.uint8)
        parity = coder.encode(data)
        for i in range(g.data_shards):
            outputs[i].write(data[i].tobytes())
        for j in range(g.parity_shards):
            outputs[g.data_shards + j].write(parity[j].tobytes())


def rebuild_ec_files(base_file_name: str, coder: ErasureCoder,
                     geometry: Geometry = DEFAULT,
                     buffer_size: Optional[int] = None) -> list[int]:
    """Regenerate missing shard files from >=k survivors
    (RebuildEcFiles, ec_encoder.go:61,89-118,233-287). Returns rebuilt ids."""
    g = geometry
    stride = buffer_size or g.small_block_size
    present = [i for i in range(g.total_shards)
               if os.path.exists(base_file_name + to_ext(i))]
    missing = [i for i in range(g.total_shards) if i not in present]
    if not missing:
        return []
    if len(present) < g.data_shards:
        raise ValueError(
            f"need {g.data_shards} shards to rebuild, have {len(present)}")

    inputs = dict(zip(present, _open_all(
        [base_file_name + to_ext(i) for i in present], "rb")))
    try:
        outputs = dict(zip(missing, _open_all(
            [base_file_name + to_ext(i) for i in missing], "wb")))
    except BaseException:
        for f in inputs.values():
            f.close()
        raise
    try:
        shard_size = os.path.getsize(base_file_name + to_ext(present[0]))
        offset = 0
        while offset < shard_size:
            n = min(stride, shard_size - offset)
            shards: list[Optional[np.ndarray]] = [None] * g.total_shards
            for i in present:
                inputs[i].seek(offset)
                chunk = inputs[i].read(n)
                if len(chunk) != n:
                    raise IOError(
                        f"shard {i} short read {len(chunk)} != {n}")
                shards[i] = np.frombuffer(chunk, dtype=np.uint8)
            rebuilt = coder.reconstruct(shards)
            for i in missing:
                outputs[i].write(np.asarray(rebuilt[i]).tobytes())
            offset += n
    finally:
        for f in inputs.values():
            f.close()
        for f in outputs.values():
            f.close()
    return missing


def iterate_ecx_file(base_file_name: str,
                     offset_size: int = t.OFFSET_SIZE
                     ) -> Iterator[tuple[int, int, int]]:
    yield from idx_mod.iter_index_file(base_file_name + ".ecx",
                                       offset_size=offset_size)


def iterate_ecj_file(base_file_name: str) -> Iterator[int]:
    path = base_file_name + ".ecj"
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        while True:
            b = f.read(t.NEEDLE_ID_SIZE)
            if len(b) != t.NEEDLE_ID_SIZE:
                return
            yield t.get_u64(b)


def find_dat_file_size(base_file_name: str, version: int,
                       offset_size: int = t.OFFSET_SIZE) -> int:
    """Infer the original .dat size from the furthest live .ecx entry
    (FindDatFileSize, ec_decoder.go:48-71)."""
    dat_size = 0
    for key, stored_offset, size in iterate_ecx_file(base_file_name,
                                                     offset_size):
        if t.size_is_deleted(size):
            continue
        stop = (t.stored_to_offset(stored_offset)
                + t.get_actual_size(size, version))
        dat_size = max(dat_size, stop)
    return dat_size


def write_dat_file(base_file_name: str, dat_size: int,
                   geometry: Geometry = DEFAULT) -> None:
    """Reassemble .dat from data shards .ec00..ec09 by de-interleaving rows
    (WriteDatFile, ec_decoder.go:154-195)."""
    g = geometry
    inputs = _open_all([base_file_name + to_ext(i)
                        for i in range(g.data_shards)], "rb")
    try:
        with open(base_file_name + ".dat", "wb") as dat:
            remaining = dat_size
            # inverse of write_ec_files' large-row rule (the final large
            # row may be zero-padded, so clamp to the live remainder)
            while remaining > g.large_row_size - g.small_row_size:
                for f in inputs:
                    n = min(remaining, g.large_block_size)
                    _copy_n(f, dat, n)
                    remaining -= n
                    if remaining <= 0:
                        break
            while remaining > 0:
                for f in inputs:
                    n = min(remaining, g.small_block_size)
                    _copy_n(f, dat, n)
                    remaining -= n
                    if remaining <= 0:
                        break
    finally:
        for f in inputs:
            f.close()


def _copy_n(src, dst, n: int) -> None:
    while n > 0:
        chunk = src.read(min(n, 1 << 20))
        if not chunk:
            raise IOError("short shard file during decode")
        dst.write(chunk)
        n -= len(chunk)


def write_idx_file_from_ec_index(base_file_name: str,
                                 offset_size: int = t.OFFSET_SIZE) -> None:
    """.idx = .ecx copied verbatim + tombstones for every .ecj entry
    (WriteIdxFileFromEcIndex, ec_decoder.go:18-44)."""
    with open(base_file_name + ".ecx", "rb") as ecx, \
            open(base_file_name + ".idx", "wb") as out:
        while True:
            chunk = ecx.read(1 << 20)
            if not chunk:
                break
            out.write(chunk)
        for key in iterate_ecj_file(base_file_name):
            out.write(idx_mod.pack_entry(key, 0, t.TOMBSTONE_FILE_SIZE,
                                         offset_size=offset_size))
