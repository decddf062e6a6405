"""The BSON subset the mongodb filer store and its fake exchange.

The port's copy of seaweedfs_tpu/filer/bson_lite.py: strings, binary,
bool, null, int32/int64, double, embedded documents and arrays, laid
out as the public BSON spec says, so either package's bytes decode in
the other (there is no mongo driver to lean on).
"""

from __future__ import annotations

import struct
from typing import Any


def encode_doc(doc: dict) -> bytes:
    body = b"".join(_encode_elem(k, v) for k, v in doc.items())
    return struct.pack("<i", len(body) + 5) + body + b"\x00"


def _cstr(s: str) -> bytes:
    return s.encode("utf-8") + b"\x00"


def _encode_elem(key: str, v: Any) -> bytes:
    k = _cstr(key)
    if isinstance(v, bool):  # before int: a bool is an int
        return b"\x08" + k + (b"\x01" if v else b"\x00")
    if isinstance(v, str):
        b = v.encode("utf-8") + b"\x00"
        return b"\x02" + k + struct.pack("<i", len(b)) + b
    if isinstance(v, (bytes, bytearray)):
        return (b"\x05" + k + struct.pack("<i", len(v)) + b"\x00"
                + bytes(v))
    if isinstance(v, int):
        if -(1 << 31) <= v < (1 << 31):
            return b"\x10" + k + struct.pack("<i", v)
        return b"\x12" + k + struct.pack("<q", v)
    if isinstance(v, float):
        return b"\x01" + k + struct.pack("<d", v)
    if v is None:
        return b"\x0a" + k
    if isinstance(v, dict):
        return b"\x03" + k + encode_doc(v)
    if isinstance(v, (list, tuple)):
        return b"\x04" + k + encode_doc(
            {str(i): item for i, item in enumerate(v)})
    raise TypeError(f"bson_lite cannot encode {type(v)}")


def decode_doc(data: bytes, offset: int = 0) -> tuple[dict, int]:
    """The document at `offset` and the bytes it takes."""
    (length,) = struct.unpack_from("<i", data, offset)
    end = offset + length - 1  # before the trailing NUL
    pos = offset + 4
    out: dict = {}
    while pos < end:
        kind = data[pos]
        pos += 1
        key_end = data.index(b"\x00", pos)
        key = data[pos:key_end].decode("utf-8")
        pos = key_end + 1
        if kind == 0x02:
            (ln,) = struct.unpack_from("<i", data, pos)
            out[key] = data[pos + 4:pos + 4 + ln - 1].decode("utf-8")
            pos += 4 + ln
        elif kind == 0x05:
            (ln,) = struct.unpack_from("<i", data, pos)
            out[key] = bytes(data[pos + 5:pos + 5 + ln])
            pos += 5 + ln
        elif kind == 0x08:
            out[key] = data[pos] != 0
            pos += 1
        elif kind == 0x10:
            (out[key],) = struct.unpack_from("<i", data, pos)
            pos += 4
        elif kind == 0x12:
            (out[key],) = struct.unpack_from("<q", data, pos)
            pos += 8
        elif kind == 0x01:
            (out[key],) = struct.unpack_from("<d", data, pos)
            pos += 8
        elif kind == 0x0A:
            out[key] = None
        elif kind in (0x03, 0x04):
            sub, used = decode_doc(data, pos)
            out[key] = (sub if kind == 0x03
                        else [sub[str(i)] for i in range(len(sub))])
            pos += used
        else:
            raise ValueError(f"bson_lite: unsupported element type "
                             f"{kind:#x} for key {key!r}")
    return out, length
