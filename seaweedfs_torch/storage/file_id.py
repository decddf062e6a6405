"""File ids: "<volumeId>,<needle-key-hex><cookie-8-hex>[_<delta>]".

The port's copy of seaweedfs_tpu/storage/file_id.py, whole. Same
textual format as upstream (weed/storage/needle/file_id.go): the last 8
hex chars are the cookie, the rest the needle key; the volume id precedes
the comma. E.g. "3,01637037d6" -> vid=3, key=0x016370, cookie low.

A ``_<delta>`` suffix is the bulk-assignment derivative form
(needle.ParsePath, weed/storage/needle/needle.go): ``/dir/assign?count=N``
reserves N consecutive keys but returns one fid; ``fid_d`` addresses key+d
with the same cookie, so a client leases a batch of write targets from a
single master round trip.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass


@dataclass(frozen=True)
class FileId:
    volume_id: int
    key: int
    cookie: int

    @classmethod
    def parse(cls, fid: str) -> "FileId":
        fid = fid.strip()
        if "," not in fid:
            raise ValueError(f"invalid fid {fid!r}")
        vid_str, rest = fid.split(",", 1)
        # drop any extension (e.g. "3,0163.jpg")
        if "." in rest:
            rest = rest.split(".", 1)[0]
        # "_<delta>": derivative key from a count=N assignment — the key
        # advances by delta, the cookie is shared (needle.ParsePath)
        delta = 0
        if "_" in rest:
            rest, _, delta_str = rest.rpartition("_")
            try:
                delta = int(delta_str)
            except ValueError:
                raise ValueError(f"invalid fid {fid!r}: bad _delta")
            if delta < 0:
                raise ValueError(f"invalid fid {fid!r}: negative _delta")
        if len(rest) <= 8:
            raise ValueError(f"invalid fid {fid!r}: key+cookie too short")
        key = int(rest[:-8], 16)
        cookie = int(rest[-8:], 16)
        return cls(int(vid_str), key + delta, cookie)

    def __str__(self) -> str:
        return f"{self.volume_id},{self.key:x}{self.cookie:08x}"


def derive_fid(fid: str, delta: int) -> str:
    """The d-th derivative of a bulk-assigned fid: same volume and cookie,
    key+delta — "fid_1".."fid_{count-1}" (weed/operation/assign_file_id.go
    hands these to upload workers)."""
    return fid if delta == 0 else f"{fid}_{delta}"


def new_cookie() -> int:
    return secrets.randbits(32)
