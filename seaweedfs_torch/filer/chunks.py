"""Chunk interval algebra: which bytes of which chunk are visible.

The port's copy of seaweedfs_tpu/filer/chunks.py, whole: upstream's
semantics (weed/filer/filechunks.go:119-266): a file is a list of FileChunks, each
covering [offset, offset+size) of the logical file; later writes (higher
mtime) shadow earlier ones. Reads resolve the chunk list into
non-overlapping VisibleIntervals, then into ChunkViews (sub-ranges of
chunks to fetch).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional


@dataclass(frozen=True)
class FileChunk:
    fid: str
    offset: int          # position in the logical file
    size: int
    mtime: int = 0       # nanoseconds; later wins
    etag: str = ""
    is_chunk_manifest: bool = False
    cipher_key: str = ""  # base64 AES-256 key when server-side encrypted

    def to_dict(self) -> dict:
        d = {"fid": self.fid, "offset": self.offset, "size": self.size,
             "mtime": self.mtime, "etag": self.etag}
        if self.is_chunk_manifest:
            d["is_chunk_manifest"] = True
        if self.cipher_key:
            d["cipher_key"] = self.cipher_key
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FileChunk":
        return cls(fid=d["fid"], offset=d["offset"], size=d["size"],
                   mtime=d.get("mtime", 0), etag=d.get("etag", ""),
                   is_chunk_manifest=d.get("is_chunk_manifest", False),
                   cipher_key=d.get("cipher_key", ""))


@dataclass
class VisibleInterval:
    start: int
    stop: int
    fid: str
    mtime: int
    chunk_offset: int    # what logical offset the chunk itself starts at


@dataclass(frozen=True)
class ChunkView:
    fid: str
    offset_in_chunk: int  # where in the chunk's data to start
    size: int
    logic_offset: int     # where these bytes land in the file


def non_overlapping_visible_intervals(
        chunks: Iterable[FileChunk]) -> list[VisibleInterval]:
    """Resolve overlaps: sort by mtime (ties broken by offset) and let each
    newer chunk punch its range into the view list
    (ReadAllChunks -> NonOverlappingVisibleIntervals, filechunks.go:184-266)."""
    visibles: list[VisibleInterval] = []
    for chunk in sorted(chunks, key=lambda c: (c.mtime, c.offset)):
        new_v = VisibleInterval(chunk.offset, chunk.offset + chunk.size,
                                chunk.fid, chunk.mtime, chunk.offset)
        out: list[VisibleInterval] = []
        for v in visibles:
            if v.start < new_v.start and new_v.start < v.stop:
                # left part of v survives
                out.append(VisibleInterval(v.start, new_v.start, v.fid,
                                           v.mtime, v.chunk_offset))
            if new_v.stop < v.stop and v.start < new_v.stop:
                # right part of v survives
                out.append(VisibleInterval(new_v.stop, v.stop, v.fid,
                                           v.mtime, v.chunk_offset))
            if v.stop <= new_v.start or new_v.stop <= v.start:
                # no overlap: v survives whole
                out.append(v)
        out.append(new_v)
        out.sort(key=lambda v: v.start)
        visibles = out
    return [v for v in visibles if v.stop > v.start]


def view_from_visibles(visibles: list[VisibleInterval], offset: int,
                       size: int) -> list[ChunkView]:
    """Slice the visible intervals into fetchable chunk views
    (ViewFromVisibleIntervals, filechunks.go:119-150)."""
    views: list[ChunkView] = []
    stop = offset + size
    for v in visibles:
        start = max(offset, v.start)
        end = min(stop, v.stop)
        if start < end:
            views.append(ChunkView(
                fid=v.fid,
                offset_in_chunk=start - v.chunk_offset,
                size=end - start,
                logic_offset=start,
            ))
    return views


def read_plan(chunks: Iterable[FileChunk], offset: int,
              size: int) -> list[ChunkView]:
    return view_from_visibles(non_overlapping_visible_intervals(chunks),
                              offset, size)


def total_size(chunks: Iterable[FileChunk]) -> int:
    """Logical file size = max chunk stop (FileSize, filechunks.go:24)."""
    return max((c.offset + c.size for c in chunks), default=0)


def compact_chunks(chunks: Iterable[FileChunk]
                   ) -> tuple[list[FileChunk], list[FileChunk]]:
    """(live, garbage): chunks fully shadowed by newer writes are garbage
    (CompactFileChunks, filechunks.go:62-76)."""
    chunks = list(chunks)
    visibles = non_overlapping_visible_intervals(chunks)
    used_fids = {v.fid for v in visibles}
    live = [c for c in chunks if c.fid in used_fids]
    garbage = [c for c in chunks if c.fid not in used_fids]
    return live, garbage


def etag(chunks: list[FileChunk]) -> str:
    """Aggregate etag (ETagChunks, filechunks.go:34-46)."""
    if len(chunks) == 1:
        return chunks[0].etag
    import hashlib
    h = hashlib.md5()
    for c in chunks:
        h.update(c.etag.encode())
    return f"{h.hexdigest()}-{len(chunks)}"
