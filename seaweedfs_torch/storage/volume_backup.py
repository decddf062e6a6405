"""Incremental volume backup and tailing by append timestamp.

The port's copy of seaweedfs_tpu/storage/volume_backup.py (upstream
weed/storage/volume_backup.go, weed/server/volume_grpc_tail.go): every
v3 needle record carries its append timestamp and the .idx journal is in
append order, so "what changed since T" is a binary search over the
journal followed by a linear stream of records. The volume server's
``GET /admin/tail`` streams them, CLI ``backup`` pulls a volume into a
local replica with them, and CLI ``fix`` rebuilds a lost .idx from the
.dat (``rebuild_idx``).

Tombstones stream as the empty needles the delete path appended, so a
receiver replays deletes as deletes.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, Optional

from ..utils import durable
from . import idx as idx_mod
from . import types as t
from .needle import Needle
from .needle_map import remove_sidecars
from .volume import Volume


def _entry_append_ns(volume: Volume, stored_offset: int,
                     size: int) -> Optional[int]:
    """Append timestamp of the needle a journal entry points at."""
    if stored_offset == 0:
        return None
    try:
        n = volume.read_needle_at(t.stored_to_offset(stored_offset),
                                  max(size, 0))
    except Exception:
        return None
    return n.append_at_ns


def binary_search_by_append_at_ns(volume: Volume,
                                  since_ns: int) -> int:
    """Index of the first .idx journal entry appended strictly after
    since_ns (BinarySearchByAppendAtNs, volume_backup.go:170-218).

    Journal order == append order, so append_at_ns is non-decreasing over
    entries; entries whose timestamp can't be read (offset 0) are resolved
    by scanning to a readable neighbour.
    """
    idx_path = volume.base_file_name() + ".idx"
    entry = t.needle_map_entry_size(volume.offset_size)
    n_entries = os.path.getsize(idx_path) // entry
    with open(idx_path, "rb") as f:
        def ts_at(i: int) -> Optional[int]:
            f.seek(i * entry)
            _, off, size = idx_mod.unpack_entry(
                f.read(entry), offset_size=volume.offset_size)
            return _entry_append_ns(volume, off, size)

        lo, hi = 0, n_entries
        while lo < hi:
            mid = (lo + hi) // 2
            ts = ts_at(mid)
            probe = mid
            # unreadable timestamp: walk forward for a readable one; if the
            # rest of the window is unreadable, treat as "after"
            while ts is None and probe + 1 < hi:
                probe += 1
                ts = ts_at(probe)
            if ts is None or ts > since_ns:
                hi = mid
            else:
                lo = probe + 1
        return lo


def iter_entries_since(volume: Volume, since_ns: int,
                       ) -> Iterator[tuple[int, int, int]]:
    """(key, stored_offset, size) journal entries appended after since_ns."""
    idx_path = volume.base_file_name() + ".idx"
    entry = t.needle_map_entry_size(volume.offset_size)
    start = binary_search_by_append_at_ns(volume, since_ns)
    with open(idx_path, "rb") as f:
        f.seek(start * entry)
        while True:
            chunk = f.read(entry * 1024)
            if not chunk:
                return
            yield from idx_mod.iter_index_bytes(
                chunk, offset_size=volume.offset_size)


def iter_needles_since(volume: Volume, since_ns: int) -> Iterator[Needle]:
    """Stream full needle records (writes AND tombstones) appended after
    since_ns, in append order (SendVolumeTail semantics,
    volume_grpc_tail.go:16-79)."""
    for key, stored_offset, size in iter_entries_since(volume, since_ns):
        if stored_offset == 0:
            # journal-only tombstone (e.g. post-compaction): synthesize an
            # empty needle so the receiver still applies the delete
            n = Needle(cookie=0, id=key)
            n.append_at_ns = volume.last_append_at_ns
            yield n
            continue
        try:
            yield volume.read_needle_at(t.stored_to_offset(stored_offset),
                                        max(size, 0))
        except Exception:
            continue


def apply_tailed_needle(volume: Volume, n: Needle) -> None:
    """Replay one streamed record onto a local replica: empty body = delete,
    else write (the receiver side of volume tailing,
    volume_backup.go IncrementalBackup / volume_grpc_tail.go:81-126)."""
    if len(n.data) == 0:
        volume.delete_needle(n, preserve_append_at_ns=True)
    else:
        volume.write_needle(n, preserve_append_at_ns=True)


def incremental_backup(volume: Volume, since_ns: int,
                       fetch: Callable[[int], Iterator[Needle]]) -> int:
    """Pull everything appended after our high-water mark from a source.

    fetch(since_ns) yields needles (typically from a remote tail stream);
    returns the number of records applied.
    """
    applied = 0
    for n in fetch(since_ns or volume.last_append_at_ns):
        apply_tailed_needle(volume, n)
        applied += 1
    return applied


def rebuild_idx(volume_dir: str, collection: str, vid: int) -> int:
    """Rebuild a lost/corrupt .idx by scanning the .dat file
    (`weed fix`, weed/command/fix.go:61). Returns live-needle count."""
    prefix = f"{collection}_" if collection else ""
    base = os.path.join(volume_dir, f"{prefix}{vid}")
    tmp = base + ".idx.tmp"
    if os.path.exists(base + ".idx"):
        os.remove(base + ".idx")
    v = Volume(volume_dir, collection, vid)  # opens with empty index
    count = 0
    with open(tmp, "wb") as out:
        def visit(n: Needle, byte_offset: int) -> None:
            nonlocal count
            w = v.offset_size
            if len(n.data) == 0:
                out.write(idx_mod.pack_entry(
                    n.id, t.offset_to_stored(byte_offset, w),
                    t.TOMBSTONE_FILE_SIZE, offset_size=w))
            else:
                out.write(idx_mod.pack_entry(
                    n.id, t.offset_to_stored(byte_offset, w), n.size,
                    offset_size=w))
                count += 1
        v.scan(visit)
        out.flush()
        os.fsync(out.fileno())
    v.close()
    remove_sidecars(base + ".idx")
    # the rebuilt index replaces the only copy — a revoked rename after
    # a crash must yield the (deleted) old state loudly, never a torn mix
    durable.replace_atomic(tmp, base + ".idx", sync_file=False)
    return count
