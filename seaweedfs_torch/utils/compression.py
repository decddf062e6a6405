"""Gzip helpers for needle payloads (weed/util/compression.go).

The port's copy of seaweedfs_tpu/utils/compression.py, reduced to what
the fused warm-down (ec/fused.py), its readers and the volume server's
write path use: ``compress``, ``decompress``, ``is_gzipped`` and
``maybe_compress`` (with ``is_compressable``). zlib is the C
implementation.
"""

from __future__ import annotations

import gzip
import struct
import zlib

MIN_COMPRESS_SIZE = 128          # don't bother below this
GOOD_RATIO_NUM, GOOD_RATIO_DEN = 9, 10   # keep only if <90% of original

_COMPRESSABLE_EXT = {
    ".txt", ".htm", ".html", ".css", ".js", ".json", ".xml", ".csv",
    ".svg", ".md", ".log", ".conf", ".yaml", ".yml", ".toml", ".sql",
    ".go", ".py", ".java", ".c", ".h", ".cpp", ".ts", ".tsx", ".bin",
    ".dat", ".idx",
}
_UNCOMPRESSABLE_EXT = {
    ".jpg", ".jpeg", ".png", ".gif", ".webp", ".zip", ".gz", ".tgz",
    ".bz2", ".xz", ".zst", ".7z", ".rar", ".mp3", ".mp4", ".mkv", ".avi",
    ".mov", ".woff", ".woff2",
}


def is_gzipped(data: bytes) -> bool:
    return len(data) >= 2 and data[0] == 0x1F and data[1] == 0x8B


def is_compressable(ext: str, mime: str) -> bool:
    """Mirror of util.IsCompressableFileType (compression.go): compress
    text-ish content, never re-compress packed formats."""
    ext = ext.lower()
    if ext in _UNCOMPRESSABLE_EXT:
        return False
    if ext in _COMPRESSABLE_EXT:
        return True
    mime = (mime or "").split(";")[0].strip().lower()
    if mime.startswith("text/"):
        return True
    if mime in ("application/json", "application/xml",
                "application/javascript", "application/x-javascript",
                "application/wasm"):
        return True
    if mime.startswith(("image/", "video/", "audio/")):
        return False
    if mime in ("application/zip", "application/gzip",
                "application/x-gzip", "application/pdf"):
        return False
    return False


def compress(data: bytes, level: int = 3) -> bytes:
    """Gzip-container compress (GzipData).

    The container is built by hand rather than through gzip.compress (a
    BytesIO and a GzipFile per call, which costs more than the deflate
    on small payloads, one call per needle). The bytes equal the
    stdlib's with mtime 0: the fixed 10-byte header (mtime 0, XFL from
    the level, OS unknown), the raw deflate stream, then the CRC-32 and
    ISIZE trailer. They are deterministic, so records compressed here
    and by the reference match byte for byte."""
    co = zlib.compressobj(level, zlib.DEFLATED, -zlib.MAX_WBITS,
                          zlib.DEF_MEM_LEVEL, 0)
    xfl = 2 if level == 9 else (4 if level == 1 else 0)
    return (b"\x1f\x8b\x08\x00\x00\x00\x00\x00" + bytes([xfl]) + b"\xff"
            + co.compress(data) + co.flush()
            + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF,
                          len(data) & 0xFFFFFFFF))


def decompress(data: bytes) -> bytes:
    """UnCompressData: gzip or raw deflate."""
    if is_gzipped(data):
        return gzip.decompress(data)
    return zlib.decompress(data)


def maybe_compress(data: bytes, ext: str = "", mime: str = "") -> tuple[bytes, bool]:
    """Compress when worth it; returns (payload, is_compressed)."""
    if len(data) < MIN_COMPRESS_SIZE or is_gzipped(data):
        return data, False
    if not is_compressable(ext, mime):
        return data, False
    comp = compress(data)
    if len(comp) * GOOD_RATIO_DEN < len(data) * GOOD_RATIO_NUM:
        return comp, True
    return data, False
