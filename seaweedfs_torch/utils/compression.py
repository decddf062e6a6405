"""Gzip helpers for needle payloads (weed/util/compression.go).

The port's copy of seaweedfs_tpu/utils/compression.py, reduced to what
the fused warm-down (ec/fused.py) and its readers use: ``compress``,
``decompress`` and ``is_gzipped``. zlib is the C implementation.
"""

from __future__ import annotations

import gzip
import struct
import zlib


def is_gzipped(data: bytes) -> bool:
    return len(data) >= 2 and data[0] == 0x1F and data[1] == 0x8B


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
