"""A cassandra in the repo, for the cassandra store.

The port's copy of seaweedfs_tpu/filer/fake_cassandra.py: STARTUP/READY
and the statements cassandra_store.py sends (the upsert INSERT, the
point SELECT, the clustering-range SELECT with a LIMIT, the point and
partition DELETEs, the DISTINCT partition scan, USE) in CQL v4 frames,
over partitions (directory) of name-keyed rows in memory.
"""

from __future__ import annotations

import re
import socketserver
import struct
import threading

from .netutil import read_exact

_RESP = 0x84
_STARTUP, _READY, _QUERY, _RESULT, _ERROR = 0x01, 0x02, 0x07, 0x08, 0x00
_VOID = struct.pack(">i", 0x0001)
_BLOB = 0x0003

_INSERT = re.compile(
    r"INSERT INTO filemeta \(directory,name,meta\) VALUES\(\?,\?,\?\)",
    re.I)
_SELECT_ONE = re.compile(
    r"SELECT meta FROM filemeta WHERE directory=\? AND name=\?", re.I)
_SELECT_RANGE = re.compile(
    r"SELECT name, meta FROM filemeta WHERE directory=\? AND "
    r"name(>=|>)\? ORDER BY name ASC LIMIT \?", re.I)
_DELETE_ONE = re.compile(
    r"DELETE FROM filemeta WHERE directory=\? AND name=\?", re.I)
_DELETE_PART = re.compile(r"DELETE FROM filemeta WHERE directory=\?$",
                          re.I)
_DISTINCT = re.compile(r"SELECT DISTINCT directory FROM filemeta", re.I)


def _string(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">H", len(b)) + b


def _rows_frame(cols: list[str], rows: list[list[bytes]]) -> bytes:
    body = struct.pack(">i", 0x0002)                  # Rows
    body += struct.pack(">ii", 0x0001, len(cols))     # global_tables_spec
    body += _string("ks") + _string("filemeta")
    for c in cols:
        body += _string(c) + struct.pack(">H", _BLOB)
    body += struct.pack(">i", len(rows))
    for row in rows:
        for v in row:
            body += struct.pack(">i", len(v)) + v
    return body


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        # partition (directory) -> {clustering key (name) -> meta}
        self.parts: dict[bytes, dict[bytes, bytes]] = {}


class _Handler(socketserver.BaseRequestHandler):
    def _send(self, stream: int, opcode: int, body: bytes) -> None:
        self.request.sendall(
            struct.pack(">BBhBi", _RESP, 0, stream, opcode, len(body))
            + body)

    def handle(self):
        state: _State = self.server.state  # type: ignore[attr-defined]
        recv = self.request.recv
        try:
            while True:
                _ver, _flags, stream, opcode, length = struct.unpack(
                    ">BBhBi", read_exact(recv, 9))
                payload = read_exact(recv, length)
                if opcode == _STARTUP:
                    self._send(stream, _READY, b"")
                    continue
                if opcode != _QUERY:
                    self._send(stream, _ERROR, struct.pack(">i", 0x000A)
                               + _string("unsupported opcode"))
                    continue
                try:
                    self._send(stream, _RESULT, _execute(state, payload))
                except Exception as e:  # a CQL error frame
                    self._send(stream, _ERROR, struct.pack(">i", 0x2200)
                               + _string(str(e)[:200]))
        except (ConnectionError, OSError):
            return


def _execute(state: _State, payload: bytes) -> bytes:
    (qlen,) = struct.unpack_from(">i", payload)
    cql = payload[4:4 + qlen].decode("utf-8").strip()
    pos = 4 + qlen + 2  # past the consistency
    flags = payload[pos]
    pos += 1
    values: list[bytes] = []
    if flags & 0x01:
        (n,) = struct.unpack_from(">H", payload, pos)
        pos += 2
        for _ in range(n):
            (ln,) = struct.unpack_from(">i", payload, pos)
            pos += 4
            values.append(payload[pos:pos + ln] if ln >= 0 else b"")
            pos += max(ln, 0)
    with state.lock:
        if cql.upper().startswith("USE "):
            return struct.pack(">i", 0x0003) + _string(
                cql[4:].strip().strip('\'"'))  # SetKeyspace
        if _INSERT.search(cql):
            d, name, meta = values
            state.parts.setdefault(d, {})[name] = meta
            return _VOID
        m = _SELECT_RANGE.search(cql)
        if m:
            d, start, limit_b = values
            # LIMIT is a bound int: 4 bytes, big-endian
            (limit,) = struct.unpack(">i", limit_b)
            part = state.parts.get(d, {})
            after = ((lambda nm: nm >= start) if m.group(1) == ">="
                     else (lambda nm: nm > start))
            names = [nm for nm in sorted(part) if after(nm)][:limit]
            return _rows_frame(["name", "meta"],
                               [[nm, part[nm]] for nm in names])
        if _SELECT_ONE.search(cql):
            d, name = values
            part = state.parts.get(d, {})
            return _rows_frame(["meta"],
                               [[part[name]]] if name in part else [])
        if _DELETE_ONE.search(cql):
            d, name = values
            state.parts.get(d, {}).pop(name, None)
            return _VOID
        if _DELETE_PART.search(cql):
            state.parts.pop(values[0], None)
            return _VOID
        if _DISTINCT.search(cql):
            return _rows_frame(["directory"],
                               [[d] for d in sorted(state.parts)])
    raise ValueError(f"fake_cassandra: unsupported CQL {cql!r}")


class FakeCassandraServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.state = _State()
        self._tcp = socketserver.ThreadingTCPServer((host, port), _Handler)
        self._tcp.daemon_threads = True
        self._tcp.state = self.state  # type: ignore[attr-defined]
        self.host = host
        self.port = self._tcp.server_address[1]
        self._thread = threading.Thread(target=self._tcp.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._tcp.shutdown()
        self._tcp.server_close()
