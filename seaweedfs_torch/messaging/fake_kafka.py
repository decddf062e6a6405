"""Minimal in-repo Kafka-protocol broker for tests and the smoke.

The port's copy of seaweedfs_tpu/messaging/fake_kafka.py.

The environment cannot host a real Kafka, so the wire client
(messaging/kafka_wire.py — the counterpart of the reference's sarama
use in weed/notification/kafka/kafka_queue.go) is proven against this
fake: a threaded socket server speaking the v0 Metadata/Produce/Fetch
APIs with in-memory topics, broker-assigned offsets, CRC-checked v0
MessageSets, and auto-created single-partition topics. Same pattern as
filer/fake_redis.py (RESP), fake_cassandra.py (CQL), fake_mongo.py
(OP_MSG): the wire contract matters, not the persistence.
"""

from __future__ import annotations

import socketserver
import struct
import threading
from typing import Optional

from .kafka_wire import (API_FETCH, API_METADATA, API_PRODUCE, _Reader,
                         _bytes, _str, decode_message_set)

ERR_OFFSET_OUT_OF_RANGE = 1
ERR_UNKNOWN_TOPIC_OR_PARTITION = 3


def _encode_stored(offset: int, key: Optional[bytes],
                   value: Optional[bytes]) -> bytes:
    import zlib
    body = struct.pack(">bb", 0, 0) + _bytes(key) + _bytes(value)
    crc = zlib.crc32(body) & 0xFFFFFFFF
    msg = struct.pack(">I", crc) + body
    return struct.pack(">qi", offset, len(msg)) + msg


class _Handler(socketserver.BaseRequestHandler):
    def setup(self) -> None:
        self.server.owner._conns.add(self.request)  # type: ignore

    def finish(self) -> None:
        self.server.owner._conns.discard(self.request)  # type: ignore

    def handle(self) -> None:
        srv: "FakeKafkaServer" = self.server.owner  # type: ignore
        while True:
            try:
                hdr = self._recvn(4)
                if hdr is None:
                    return
                size = struct.unpack(">i", hdr)[0]
                payload = self._recvn(size)
                if payload is None:
                    return
            except OSError:
                return
            r = _Reader(payload)
            api_key = r.i16()
            r.i16()  # api_version (v0 assumed)
            corr = r.i32()
            r.string()  # client_id
            if api_key == API_METADATA:
                body = srv.handle_metadata(r)
            elif api_key == API_PRODUCE:
                body = srv.handle_produce(r)
                if body is None:
                    continue  # acks=0: no response on the wire
            elif api_key == API_FETCH:
                body = srv.handle_fetch(r)
            else:
                return
            resp = struct.pack(">i", corr) + body
            try:
                self.request.sendall(struct.pack(">i", len(resp)) + resp)
            except OSError:
                return

    def _recvn(self, n: int) -> Optional[bytes]:
        parts = []
        while n:
            chunk = self.request.recv(n)
            if not chunk:
                return None
            parts.append(chunk)
            n -= len(chunk)
        return b"".join(parts)


class _Server(socketserver.ThreadingTCPServer):
    # reuse lets a restarted broker rebind its old port immediately —
    # the crash/restart contract tests depend on it
    allow_reuse_address = True
    daemon_threads = True


class FakeKafkaServer:
    """topics: {name: [(key, value), ...]} — offset == list index."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 auto_create: bool = True):
        self.auto_create = auto_create
        self.topics: dict[str, list] = {}
        self._lock = threading.Lock()
        self._conns: set = set()
        self._tcp = _Server((host, port), _Handler,
                            bind_and_activate=True)
        self._tcp.owner = self  # type: ignore
        self.host, self.port = self._tcp.server_address
        self._thread = threading.Thread(target=self._tcp.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def close(self) -> None:
        self._tcp.shutdown()
        self._tcp.server_close()

    def kill(self) -> None:
        """Crash simulation: stop accepting AND sever every established
        connection (close() alone leaves accepted sockets served by
        their handler threads — a client holding one would still get
        answers from the 'dead' broker)."""
        self.close()
        for sock in list(self._conns):
            try:
                sock.shutdown(2)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        self._conns.clear()

    # --- API handlers (each returns the response body) ---
    def handle_metadata(self, r: _Reader) -> bytes:
        n = r.i32()
        names = [r.string() for _ in range(n)]
        with self._lock:
            if not names:
                names = sorted(self.topics)
            elif self.auto_create:
                for t in names:
                    self.topics.setdefault(t, [])
            known = {t for t in names if t in self.topics}
        out = struct.pack(">i", 1)  # one broker: us
        out += struct.pack(">i", 0) + _str(self.host) \
            + struct.pack(">i", self.port)
        out += struct.pack(">i", len(names))
        for t in names:
            if t in known:
                out += struct.pack(">h", 0) + _str(t)
                out += struct.pack(">i", 1)  # one partition
                out += struct.pack(">hii", 0, 0, 0)  # err, id 0, leader 0
                out += struct.pack(">i", 0)  # replicas
                out += struct.pack(">i", 0)  # isr
            else:
                out += struct.pack(">h",
                                   ERR_UNKNOWN_TOPIC_OR_PARTITION) + _str(t)
                out += struct.pack(">i", 0)
        return out

    def handle_produce(self, r: _Reader) -> Optional[bytes]:
        acks = r.i16()
        r.i32()  # timeout
        results = []
        for _ in range(r.i32()):
            topic = r.string() or ""
            parts = []
            for _ in range(r.i32()):
                pid = r.i32()
                mset = r.take(r.i32())
                msgs = decode_message_set(mset)
                with self._lock:
                    if topic not in self.topics and not self.auto_create:
                        parts.append((pid,
                                      ERR_UNKNOWN_TOPIC_OR_PARTITION, -1))
                        continue
                    log = self.topics.setdefault(topic, [])
                    base = len(log)
                    log.extend((k, v) for _, k, v in msgs)
                parts.append((pid, 0, base))
            results.append((topic, parts))
        if acks == 0:
            return None  # fire-and-forget: broker stays silent
        out = struct.pack(">i", len(results))
        for topic, parts in results:
            out += _str(topic) + struct.pack(">i", len(parts))
            for pid, err, base in parts:
                out += struct.pack(">ihq", pid, err, base)
        return out

    def handle_fetch(self, r: _Reader) -> bytes:
        r.i32()  # replica_id
        r.i32()  # max_wait
        r.i32()  # min_bytes
        results = []
        for _ in range(r.i32()):
            topic = r.string() or ""
            parts = []
            for _ in range(r.i32()):
                pid = r.i32()
                offset = r.i64()
                max_bytes = r.i32()
                with self._lock:
                    log = list(self.topics.get(topic, []))
                if topic not in self.topics and not self.auto_create:
                    parts.append((pid, ERR_UNKNOWN_TOPIC_OR_PARTITION,
                                  0, b""))
                    continue
                if offset < 0:
                    # the -1 "latest" sentinel (and any negative offset)
                    # is not a fetchable position: answering it by
                    # slicing from the end duplicated messages under
                    # wrong offsets. Real brokers answer
                    # OFFSET_OUT_OF_RANGE and let the client reset.
                    parts.append((pid, ERR_OFFSET_OUT_OF_RANGE,
                                  len(log), b""))
                    continue
                mset = bytearray()
                for off in range(offset, len(log)):
                    k, v = log[off]
                    enc = _encode_stored(off, k, v)
                    if mset and len(mset) + len(enc) > max_bytes:
                        break
                    mset += enc
                parts.append((pid, 0, len(log), bytes(mset)))
            results.append((topic, parts))
        out = struct.pack(">i", len(results))
        for topic, parts in results:
            out += _str(topic) + struct.pack(">i", len(parts))
            for pid, err, hw, mset in parts:
                out += struct.pack(">ihq", pid, err, hw)
                out += struct.pack(">i", len(mset)) + mset
        return out
