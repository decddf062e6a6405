"""Chunk manifests: chunks-of-chunk-lists for super-large files.

The port's copy of seaweedfs_tpu/filer/manifest.py, whole, byte for
byte the same blobs. Counterpart of weed/filer/filechunk_manifest.go:41-120: when a file
accumulates more than MANIFEST_BATCH chunks, groups of chunks are
serialized into manifest blobs stored like any other chunk and replaced by
a single FileChunk flagged is_chunk_manifest covering the group's byte
range. Resolution is recursive, so manifests can nest
(manifest-of-manifests) and file size is unbounded by entry size.

Blob format: JSON {"chunks": [chunk dicts]} (the reference uses the
FileChunkManifest protobuf; content is identical).
"""

from __future__ import annotations

import json
from typing import Awaitable, Callable, Iterable

from .chunks import FileChunk

MANIFEST_BATCH = 1000  # filechunk_manifest.go ManifestBatch


def pack_manifest(chunks: list[FileChunk]) -> bytes:
    return json.dumps({"chunks": [c.to_dict() for c in chunks]},
                      separators=(",", ":")).encode()


def unpack_manifest(data: bytes) -> list[FileChunk]:
    return [FileChunk.from_dict(d) for d in json.loads(data)["chunks"]]


def covering_chunk(fid: str, group: list[FileChunk], etag: str = "",
                   cipher_key: str = "") -> FileChunk:
    """The manifest FileChunk spanning its group's byte range."""
    lo = min(c.offset for c in group)
    hi = max(c.offset + c.size for c in group)
    return FileChunk(fid=fid, offset=lo, size=hi - lo,
                     mtime=max(c.mtime for c in group), etag=etag,
                     is_chunk_manifest=True, cipher_key=cipher_key)


async def maybe_manifestize(
        chunks: list[FileChunk],
        save_fn: Callable[[bytes, int], Awaitable[FileChunk]],
        batch: int = MANIFEST_BATCH) -> list[FileChunk]:
    """Fold data chunks into manifest blobs while more than `batch` remain
    (maybeManifestize + doMaybeManifestize): existing manifest chunks pass
    through, and the fold repeats so the top-level list stays <= batch
    even for manifest-of-manifests scale."""
    out = list(chunks)
    while True:
        manifests = [c for c in out if c.is_chunk_manifest]
        data = [c for c in out if not c.is_chunk_manifest]
        if len(data) <= batch:
            return manifests + data
        folded: list[FileChunk] = []
        for i in range(0, len(data) // batch * batch, batch):
            group = data[i:i + batch]
            blob = pack_manifest(group)
            saved = await save_fn(blob, group[0].offset)
            folded.append(covering_chunk(saved.fid, group, etag=saved.etag,
                                         cipher_key=saved.cipher_key))
        out = manifests + folded + data[len(data) // batch * batch:]


async def resolve_manifests(
        chunks: Iterable[FileChunk],
        fetch_fn: Callable[[FileChunk], Awaitable[bytes]],
        depth: int = 0) -> list[FileChunk]:
    """Recursively expand manifest chunks into their data chunks
    (ResolveChunkManifest, filechunk_manifest.go:41-77)."""
    if depth > 16:
        raise ValueError("chunk manifest nesting too deep")
    out: list[FileChunk] = []
    for c in chunks:
        if not c.is_chunk_manifest:
            out.append(c)
            continue
        nested = unpack_manifest(await fetch_fn(c))
        out.extend(await resolve_manifests(nested, fetch_fn, depth + 1))
    return out
