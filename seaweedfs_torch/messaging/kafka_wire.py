"""Minimal Kafka wire-protocol client: Metadata, Produce, Fetch.

The port's copy of seaweedfs_tpu/messaging/kafka_wire.py.

The reference feeds notifications and cross-cluster replication through
Kafka via the sarama SDK (weed/notification/kafka/kafka_queue.go:1-70,
weed/replication/sub/notification_kafka.go:22-117). This module speaks
the actual Kafka binary protocol instead of wrapping an SDK — enough of
it to produce to and fetch from any broker that accepts the v0 era APIs
(every Kafka since 0.8, plus this repo's fake_kafka for CI):

  frame       := INT32 size | payload
  request     := INT16 api_key | INT16 api_version | INT32 correlation
                 | STRING client_id | body
  STRING      := INT16 len | bytes     (len -1 => null)
  BYTES       := INT32 len | bytes     (len -1 => null)

APIs used (all version 0):
  Metadata(3)  [topics]                    -> brokers + topic/partition map
  Produce(0)   acks timeout [topic [partition message_set]]
  Fetch(1)     replica(-1) max_wait min_bytes [topic [partition offset
               max_bytes]]

MessageSet v0 (magic 0):
  INT64 offset | INT32 size | INT32 crc | INT8 magic | INT8 attrs
  | BYTES key | BYTES value          (crc = CRC32/IEEE of magic..value)

Synchronous, one connection per client, no compression — the queue use
case is a strictly ordered single-partition event stream.
"""

from __future__ import annotations

import socket
import struct
import threading
import zlib
from typing import Optional

API_PRODUCE = 0
API_FETCH = 1
API_METADATA = 3


class KafkaError(Exception):
    def __init__(self, code: int, where: str = ""):
        super().__init__(f"kafka error {code} {where}")
        self.code = code


def _str(s: Optional[str]) -> bytes:
    if s is None:
        return struct.pack(">h", -1)
    b = s.encode()
    return struct.pack(">h", len(b)) + b


def _bytes(b: Optional[bytes]) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise KafkaError(-1, "short response")
        self.pos += n
        return out

    def i8(self) -> int:
        return struct.unpack(">b", self.take(1))[0]

    def i16(self) -> int:
        return struct.unpack(">h", self.take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self.take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self.take(8))[0]

    def string(self) -> Optional[str]:
        n = self.i16()
        return None if n < 0 else self.take(n).decode()

    def bytes_(self) -> Optional[bytes]:
        n = self.i32()
        return None if n < 0 else self.take(n)


def encode_message(key: Optional[bytes], value: Optional[bytes]) -> bytes:
    """One v0 message, offset slot 0 (the broker assigns real offsets)."""
    body = struct.pack(">bb", 0, 0) + _bytes(key) + _bytes(value)
    crc = zlib.crc32(body) & 0xFFFFFFFF
    msg = struct.pack(">I", crc) + body
    return struct.pack(">qi", 0, len(msg)) + msg


def decode_message_set(raw: bytes) -> list[tuple[int, Optional[bytes],
                                                 Optional[bytes]]]:
    """[(offset, key, value)] — a trailing partial message (normal at the
    end of a fetch window) is dropped."""
    out = []
    r = _Reader(raw)
    while r.pos + 12 <= len(raw):
        offset = r.i64()
        size = r.i32()
        if r.pos + size > len(raw):
            break
        m = _Reader(r.take(size))
        crc = m.i32() & 0xFFFFFFFF
        body = m.buf[m.pos:]
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            raise KafkaError(-2, "message crc mismatch")
        m.i8()  # magic
        m.i8()  # attributes
        key = m.bytes_()
        value = m.bytes_()
        out.append((offset, key, value))
    return out


class KafkaClient:
    """One broker connection; thread-safe request/response."""

    def __init__(self, host: str, port: int, client_id: str = "swfs",
                 timeout: float = 10.0):
        self.host, self.port = host, port
        self.client_id = client_id
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._corr = 0
        self._lock = threading.Lock()

    @classmethod
    def from_addr(cls, addr: str, **kw) -> "KafkaClient":
        host, _, port = addr.rpartition(":")
        return cls(host or "127.0.0.1", int(port), **kw)

    def _conn(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout)
        return self._sock

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def _roundtrip(self, api_key: int, body: bytes,
                   wait: bool = True) -> Optional[_Reader]:
        with self._lock:
            self._corr += 1
            corr = self._corr
            payload = (struct.pack(">hhi", api_key, 0, corr)
                       + _str(self.client_id) + body)
            frame = struct.pack(">i", len(payload)) + payload
            try:
                s = self._conn()
                s.sendall(frame)
                if not wait:
                    # acks=0 produce: the broker sends NO response
                    return None
                hdr = self._recvn(s, 4)
                size = struct.unpack(">i", hdr)[0]
                resp = self._recvn(s, size)
            except OSError:
                self.close()
                raise
            r = _Reader(resp)
            got = r.i32()
            if got != corr:
                self.close()
                raise KafkaError(-3, f"correlation {got} != {corr}")
            return r

    @staticmethod
    def _recvn(s: socket.socket, n: int) -> bytes:
        parts = []
        while n:
            chunk = s.recv(n)
            if not chunk:
                raise OSError("kafka connection closed")
            parts.append(chunk)
            n -= len(chunk)
        return b"".join(parts)

    # --- Metadata v0 ---
    def metadata(self, topics: Optional[list[str]] = None) -> dict:
        body = struct.pack(">i", len(topics or []))
        for t in topics or []:
            body += _str(t)
        r = self._roundtrip(API_METADATA, body)
        brokers = {}
        for _ in range(r.i32()):
            node = r.i32()
            host = r.string()
            port = r.i32()
            brokers[node] = (host, port)
        out = {"brokers": brokers, "topics": {}}
        for _ in range(r.i32()):
            terr = r.i16()
            name = r.string()
            parts = {}
            for _ in range(r.i32()):
                perr = r.i16()
                pid = r.i32()
                leader = r.i32()
                for _ in range(r.i32()):  # replicas
                    r.i32()
                for _ in range(r.i32()):  # isr
                    r.i32()
                parts[pid] = {"error": perr, "leader": leader}
            out["topics"][name] = {"error": terr, "partitions": parts}
        return out

    # --- Produce v0 ---
    def produce(self, topic: str, partition: int, key: Optional[bytes],
                value: Optional[bytes], acks: int = 1,
                timeout_ms: int = 10000) -> int:
        """Send one message; returns the assigned base offset."""
        mset = encode_message(key, value)
        body = (struct.pack(">hi", acks, timeout_ms)
                + struct.pack(">i", 1) + _str(topic)
                + struct.pack(">i", 1) + struct.pack(">i", partition)
                + struct.pack(">i", len(mset)) + mset)
        r = self._roundtrip(API_PRODUCE, body, wait=(acks != 0))
        if r is None:
            return -1  # fire-and-forget: no offset assigned
        for _ in range(r.i32()):
            r.string()  # topic
            for _ in range(r.i32()):
                r.i32()  # partition
                err = r.i16()
                offset = r.i64()
                if err:
                    raise KafkaError(err, f"produce {topic}/{partition}")
                return offset
        raise KafkaError(-4, "empty produce response")

    # --- Fetch v0 ---
    def fetch(self, topic: str, partition: int, offset: int,
              max_bytes: int = 1 << 20, max_wait_ms: int = 500,
              min_bytes: int = 1) -> list[tuple[int, Optional[bytes],
                                                Optional[bytes]]]:
        """[(offset, key, value)] at/after `offset` (empty when caught
        up)."""
        body = (struct.pack(">iii", -1, max_wait_ms, min_bytes)
                + struct.pack(">i", 1) + _str(topic)
                + struct.pack(">i", 1)
                + struct.pack(">iqi", partition, offset, max_bytes))
        r = self._roundtrip(API_FETCH, body)
        msgs = []
        for _ in range(r.i32()):
            r.string()  # topic
            for _ in range(r.i32()):
                r.i32()  # partition
                err = r.i16()
                r.i64()  # high watermark
                raw = r.take(r.i32())
                if err:
                    raise KafkaError(err, f"fetch {topic}/{partition}")
                msgs.extend(m for m in decode_message_set(raw)
                            if m[0] >= offset)
        return msgs
