"""Multipart/form-data parsing for the needle write path.

The port's copy of seaweedfs_tpu/utils/fast_multipart.py (upstream's
hand-rolled reader is weed/storage/needle/needle_parse_upload.go:79-139).
Uploads are overwhelmingly a single part: ``parse_single_part`` parses
that shape with plain ``bytes.find`` and returns None for anything
irregular, and ``parse_upload`` then falls back to ``email.parser`` on the
buffered body, as the reference's volume server does
(seaweedfs_tpu/server/volume_server.py:966-983).
"""

from __future__ import annotations

import email.parser
from typing import NamedTuple, Optional


class Part(NamedTuple):
    data: bytes
    filename: str
    content_type: str
    content_encoding: str


def _header_params(value: str) -> dict:
    """name="x"; filename="y" -> {'name': 'x', 'filename': 'y'} (unquoting
    only the plain quoted form; irregular escapes punt to the caller)."""
    out = {}
    for seg in value.split(";")[1:]:
        if "=" not in seg:
            continue
        k, v = seg.split("=", 1)
        v = v.strip()
        if v.startswith('"'):
            if not v.endswith('"') or "\\" in v:
                raise ValueError(v)
            v = v[1:-1]
        out[k.strip().lower()] = v
    return out


def parse_single_part(body: bytes, content_type: str) -> Optional[Part]:
    """Parse a one-part multipart/form-data body; None = use the slow path
    (multi-part bodies, irregular quoting, missing terminal boundary)."""
    ct = content_type.split(";", 1)
    if ct[0].strip().lower() != "multipart/form-data" or len(ct) != 2:
        return None
    try:
        params = _header_params(content_type)
    except ValueError:
        return None
    boundary = params.get("boundary", "")
    if not boundary:
        return None
    delim = b"--" + boundary.encode("utf-8", "strict")
    # RFC 2046: body = delim CRLF part-headers CRLF CRLF part-data CRLF
    #           delim "--" (optional preamble/epilogue around them)
    start = body.find(delim)
    if start == -1:
        return None
    hdr_start = start + len(delim)
    if body[hdr_start:hdr_start + 2] != b"\r\n":
        return None
    hdr_start += 2
    hdr_end = body.find(b"\r\n\r\n", hdr_start)
    if hdr_end == -1:
        return None
    data_start = hdr_end + 4
    close = body.find(b"\r\n" + delim, data_start)
    if close == -1:
        return None
    # a second part means the body isn't single-part: slow path
    after = body[close + 2 + len(delim):close + 4 + len(delim)]
    if after != b"--":
        return None
    filename = ""
    part_ct = ""
    encoding = ""
    try:
        headers = body[hdr_start:hdr_end].decode("utf-8")
    except UnicodeDecodeError:
        return None
    for line in headers.split("\r\n"):
        name, _, value = line.partition(":")
        lname = name.strip().lower()
        if lname == "content-disposition":
            try:
                filename = _header_params(value).get("filename", "")
            except ValueError:
                return None
        elif lname == "content-type":
            part_ct = value.strip()
        elif lname == "content-transfer-encoding":
            # base64/quoted-printable parts need real decoding: slow path
            if value.strip().lower() not in ("", "binary", "7bit", "8bit"):
                return None
        elif lname == "content-encoding":
            encoding = value.strip()
    return Part(body[data_start:close], filename, part_ct, encoding)


def parse_upload(body: bytes, content_type: str) -> Optional[Part]:
    """The first part of a multipart body: the fast single-part parse,
    else the full mime parse of the buffered body; None when the body
    holds no part."""
    part = parse_single_part(body, content_type)
    if part is not None:
        return part
    msg = email.parser.BytesParser().parsebytes(
        b"Content-Type: " + content_type.encode("utf-8", "replace")
        + b"\r\n\r\n" + body)
    subs = msg.get_payload()
    if not msg.is_multipart() or not subs:
        return None
    first = subs[0]
    return Part(first.get_payload(decode=True) or b"",
                first.get_filename() or "",
                first.get("Content-Type", ""),
                first.get("Content-Encoding", ""))
