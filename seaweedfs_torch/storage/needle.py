"""Needle codec: one stored blob record, byte-identical to the reference
(the port's copy of seaweedfs_tpu/storage/needle.py, with its own CRC-32C).

Layout (reference: weed/storage/needle/needle.go:24-44 and
needle_read_write.go:31-122):

  header : cookie u32 | id u64 | size u32            (16 bytes)
  body v2/v3 (when DataSize > 0):
      data_size u32 | data | flags u8
      [name_size u8 | name]        if FLAG_HAS_NAME
      [mime_size u8 | mime]        if FLAG_HAS_MIME
      [last_modified 5 bytes]      if FLAG_HAS_LAST_MODIFIED
      [ttl 2 bytes]                if FLAG_HAS_TTL
      [pairs_size u16 | pairs]     if FLAG_HAS_PAIRS
  trailer: checksum u32 (masked CRC32C) | [append_at_ns u64 in v3] | pad to 8

`size` in the header counts the body only. The checksum covers Data and is
the Castagnoli CRC32 with the reference's rotate-add mask
(weed/storage/needle/crc.go:24: value = rotl(c,17) + 0xa282ead8).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import types as t
# re-exported under the reference's names (ec/fused.py imports them here)
from .crc import crc32c_update, crc_value

FLAG_IS_COMPRESSED = 0x01
FLAG_HAS_NAME = 0x02
FLAG_HAS_MIME = 0x04
FLAG_HAS_LAST_MODIFIED = 0x08
FLAG_HAS_TTL = 0x10
FLAG_HAS_PAIRS = 0x20
FLAG_IS_CHUNK_MANIFEST = 0x80

LAST_MODIFIED_BYTES = 5
TTL_BYTES = 2

PAIR_NAME_PREFIX = "Seaweed-"


class CrcError(ValueError):
    """Stored needle bytes fail their CRC — bit-rot or a torn write.
    Typed so the read path can distinguish on-disk corruption (trigger
    read-repair from a healthy replica) from a malformed request."""


@dataclass
class Needle:
    cookie: int = 0
    id: int = 0
    size: int = 0            # body size (populated by to_bytes / parse)

    data: bytes = b""
    flags: int = 0
    name: bytes = b""
    mime: bytes = b""
    pairs: bytes = b""       # json-encoded extra name/value pairs
    last_modified: int = 0   # unix seconds, 5 bytes stored
    ttl: t.TTL = field(default_factory=lambda: t.EMPTY_TTL)

    checksum: int = 0        # raw CRC32C of data (unmasked)
    append_at_ns: int = 0    # v3 only

    # --- flag helpers ---
    def has(self, flag: int) -> bool:
        return bool(self.flags & flag)

    def set_flag(self, flag: int, on: bool = True) -> None:
        if on:
            self.flags |= flag
        else:
            self.flags &= ~flag

    @property
    def is_compressed(self) -> bool:
        return self.has(FLAG_IS_COMPRESSED)

    @property
    def is_chunk_manifest(self) -> bool:
        return self.has(FLAG_IS_CHUNK_MANIFEST)

    def update_checksum(self) -> None:
        self.checksum = crc32c_update(0, self.data)

    def etag(self) -> str:
        return t.put_u32(crc_value(self.checksum)).hex()

    # --- serialization ---
    def body_size(self, version: int) -> int:
        if version == t.VERSION1:
            return len(self.data)
        if not self.data:
            return 0
        size = 4 + len(self.data) + 1
        if self.has(FLAG_HAS_NAME):
            size += 1 + min(len(self.name), 255)
        if self.has(FLAG_HAS_MIME):
            size += 1 + len(self.mime)
        if self.has(FLAG_HAS_LAST_MODIFIED):
            size += LAST_MODIFIED_BYTES
        if self.has(FLAG_HAS_TTL):
            size += TTL_BYTES
        if self.has(FLAG_HAS_PAIRS):
            size += 2 + len(self.pairs)
        return size

    def to_bytes(self, version: int = t.CURRENT_VERSION) -> bytes:
        """Serialize the full on-disk record including trailer padding."""
        self.update_checksum()
        out = bytearray()
        if version == t.VERSION1:
            self.size = len(self.data)
            out += t.put_u32(self.cookie)
            out += t.put_u64(self.id)
            out += t.put_u32(self.size)
            out += self.data
            out += t.put_u32(crc_value(self.checksum))
            out += bytes(t.padding_length(self.size, version))
            return bytes(out)
        if version not in (t.VERSION2, t.VERSION3):
            raise ValueError(f"unsupported needle version {version}")

        if len(self.mime) > 255:
            raise ValueError(f"mime too long ({len(self.mime)} > 255)")
        if len(self.pairs) > 0xFFFF:
            raise ValueError(f"pairs too long ({len(self.pairs)} > 65535)")
        self.size = self.body_size(version)
        out += t.put_u32(self.cookie)
        out += t.put_u64(self.id)
        out += t.put_u32(t.size_to_u32(self.size))
        if self.data:
            out += t.put_u32(len(self.data))
            out += self.data
            out += bytes([self.flags & 0xFF])
            if self.has(FLAG_HAS_NAME):
                name = self.name[:255]
                out += bytes([len(name)])
                out += name
            if self.has(FLAG_HAS_MIME):
                out += bytes([len(self.mime) & 0xFF])
                out += self.mime
            if self.has(FLAG_HAS_LAST_MODIFIED):
                out += t.put_u64(self.last_modified)[8 - LAST_MODIFIED_BYTES:]
            if self.has(FLAG_HAS_TTL):
                out += self.ttl.to_bytes()
            if self.has(FLAG_HAS_PAIRS):
                out += t.put_u16(len(self.pairs))
                out += self.pairs
        out += t.put_u32(crc_value(self.checksum))
        if version == t.VERSION3:
            out += t.put_u64(self.append_at_ns)
        out += bytes(t.padding_length(self.size, version))
        return bytes(out)

    @classmethod
    def parse_header(cls, b: bytes) -> "Needle":
        n = cls()
        n.cookie = t.get_u32(b, 0)
        n.id = t.get_u64(b, 4)
        n.size = t.u32_to_size(t.get_u32(b, 12))
        return n

    def parse_body(self, body: bytes, version: int) -> None:
        """Parse `size` bytes of body (everything between header and trailer)."""
        if version == t.VERSION1:
            self.data = body
            return
        if self.size == 0:
            self.data = b""
            return
        idx = 0
        data_size = t.get_u32(body, idx)
        idx += 4
        self.data = body[idx:idx + data_size]
        idx += data_size
        self.flags = body[idx]
        idx += 1
        if self.has(FLAG_HAS_NAME):
            ln = body[idx]
            idx += 1
            self.name = body[idx:idx + ln]
            idx += ln
        if self.has(FLAG_HAS_MIME):
            ln = body[idx]
            idx += 1
            self.mime = body[idx:idx + ln]
            idx += ln
        if self.has(FLAG_HAS_LAST_MODIFIED):
            raw = bytes(3) + body[idx:idx + LAST_MODIFIED_BYTES]
            self.last_modified = t.get_u64(raw)
            idx += LAST_MODIFIED_BYTES
        if self.has(FLAG_HAS_TTL):
            self.ttl = t.TTL.from_bytes(body[idx:idx + TTL_BYTES])
            idx += TTL_BYTES
        if self.has(FLAG_HAS_PAIRS):
            ln = t.get_u16(body, idx)
            idx += 2
            self.pairs = body[idx:idx + ln]
            idx += ln

    @classmethod
    def from_bytes(cls, record: bytes, version: int = t.CURRENT_VERSION,
                   verify: bool = True) -> "Needle":
        """Parse one full on-disk record (as produced by to_bytes)."""
        n = cls.parse_header(record)
        size = n.size if n.size > 0 else 0
        body = record[t.NEEDLE_HEADER_SIZE:t.NEEDLE_HEADER_SIZE + size]
        n.parse_body(body, version)
        trailer = t.NEEDLE_HEADER_SIZE + size
        stored_checksum = t.get_u32(record, trailer)
        n.checksum = crc32c_update(0, n.data)
        if verify and size > 0 and stored_checksum != crc_value(n.checksum):
            raise CrcError(
                f"needle {n.id:x} CRC mismatch: stored {stored_checksum:#x} "
                f"computed {crc_value(n.checksum):#x}")
        if version == t.VERSION3:
            n.append_at_ns = t.get_u64(record, trailer + 4)
        return n
