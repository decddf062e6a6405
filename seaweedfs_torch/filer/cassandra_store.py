"""The cassandra filer store: a wide row per directory.

The port's copy of seaweedfs_tpu/filer/cassandra_store.py (upstream
weed/filer/cassandra/cassandra_store.go:20-130): a ``filemeta`` table
whose partition key is the directory and whose clustering column is the
name, so a listing is one range scan of one partition ("SELECT name,
meta FROM filemeta WHERE directory=? AND name>? ORDER BY name ASC LIMIT
?") and an entry's CRUD touches one partition. It speaks CQL's v4 binary
protocol (STARTUP/READY, QUERY with bound values, RESULT Rows and Void)
over one socket; the tests and the smoke run it against
fake_cassandra.py.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Optional

from .entry import Entry
from .netutil import read_exact
from .stores import FilerStore, _split

_REQ = 0x04   # a protocol v4 request
_STARTUP, _READY, _QUERY, _RESULT, _ERROR = 0x01, 0x02, 0x07, 0x08, 0x00
_CONSISTENCY_ONE = 0x0001
_ROWS = 0x0002
_KV_DIR = "\x01kv"
# column types a row may not carry here: custom, list, map, set, UDT,
# tuple
_UNSUPPORTED_TYPES = (0x0000, 0x0020, 0x0021, 0x0022, 0x0030, 0x0031)
_INSERT = "INSERT INTO filemeta (directory,name,meta) VALUES(?,?,?)"
_SELECT_ONE = "SELECT meta FROM filemeta WHERE directory=? AND name=?"


def _string(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack(">H", len(b)) + b


def _long_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack(">i", len(b)) + b


def _value(v: Optional[bytes]) -> bytes:
    if v is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(v)) + v


class _CqlClient:
    """A CQL v4 client: one socket, one query in flight."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()
        opcode, _ = self._request(_STARTUP, struct.pack(">H", 1)
                                  + _string("CQL_VERSION")
                                  + _string("3.0.0"))
        if opcode != _READY:
            raise ConnectionError("cassandra STARTUP not READY")

    def _request(self, opcode: int, body: bytes) -> tuple[int, bytes]:
        with self._lock:
            self.sock.sendall(struct.pack(">BBhBi", _REQ, 0, 0, opcode,
                                          len(body)) + body)
            _ver, _flags, _stream, r_opcode, length = struct.unpack(
                ">BBhBi", read_exact(self.sock.recv, 9))
            payload = read_exact(self.sock.recv, length)
        if r_opcode == _ERROR:
            code, msg_len = struct.unpack_from(">iH", payload)
            msg = payload[6:6 + msg_len].decode("utf-8", "replace")
            raise RuntimeError(f"cassandra error {code:#x}: {msg}")
        return r_opcode, payload

    def query(self, cql: str,
              values: tuple[bytes, ...] = ()) -> list[list[bytes]]:
        body = _long_string(cql) + struct.pack(">H", _CONSISTENCY_ONE)
        if values:
            body += bytes([0x01]) + struct.pack(">H", len(values))
            body += b"".join(_value(v) for v in values)
        else:
            body += bytes([0x00])
        opcode, payload = self._request(_QUERY, body)
        if opcode != _RESULT:
            raise ConnectionError(f"unexpected opcode {opcode}")
        (kind,) = struct.unpack_from(">i", payload)
        if kind != _ROWS:  # Void, SetKeyspace, ...
            return []
        return self._parse_rows(payload)

    @staticmethod
    def _parse_rows(payload: bytes) -> list[list[bytes]]:
        pos = 4
        flags, col_count = struct.unpack_from(">ii", payload, pos)
        pos += 8

        def skip_strings(n: int) -> int:
            p = pos
            for _ in range(n):
                (ln,) = struct.unpack_from(">H", payload, p)
                p += 2 + ln
            return p

        global_spec = flags & 0x0001
        if global_spec:  # the keyspace and table, once
            pos = skip_strings(2)
        for _ in range(col_count):
            # [keyspace, table,] name, then the type
            pos = skip_strings(1 if global_spec else 3)
            (type_id,) = struct.unpack_from(">H", payload, pos)
            pos += 2
            if type_id in _UNSUPPORTED_TYPES:
                raise ConnectionError(
                    f"unsupported column type {type_id:#x}")
        (rows_count,) = struct.unpack_from(">i", payload, pos)
        pos += 4
        out: list[list[bytes]] = []
        for _ in range(rows_count):
            row: list[bytes] = []
            for _ in range(col_count):
                (ln,) = struct.unpack_from(">i", payload, pos)
                pos += 4
                if ln < 0:
                    row.append(b"")
                else:
                    row.append(payload[pos:pos + ln])
                    pos += ln
            out.append(row)
        return out

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class CassandraStore(FilerStore):
    name = "cassandra"

    def __init__(self, host: str = "127.0.0.1", port: int = 9042,
                 keyspace: str = "seaweedfs", **_):
        self._c = _CqlClient(host, port)
        # the operator makes the keyspace and the filemeta table (as
        # upstream's scaffold says); the session still selects the
        # keyspace, or a cluster refuses every unqualified statement
        if keyspace:
            safe = keyspace.replace('"', '""')
            self._c.query(f'USE "{safe}"')

    def insert_entry(self, entry: Entry) -> None:
        d, name = _split(entry.full_path)
        self._c.query(_INSERT, (d.encode(), name.encode(),
                                entry.to_json().encode()))

    def update_entry(self, entry: Entry) -> None:
        self.insert_entry(entry)  # a CQL INSERT is an upsert

    def find_entry(self, path: str) -> Optional[Entry]:
        d, name = _split(path)
        rows = self._c.query(_SELECT_ONE, (d.encode(), name.encode()))
        if not rows or not rows[0][0]:
            return None
        return Entry.from_json(rows[0][0].decode())

    def delete_entry(self, path: str) -> None:
        d, name = _split(path)
        self._c.query("DELETE FROM filemeta WHERE directory=? AND name=?",
                      (d.encode(), name.encode()))

    def delete_folder_children(self, path: str) -> None:
        # the children are one partition; the deeper directories are
        # found among the partition keys (every one is under the root)
        base = path.rstrip("/") or "/"
        deep_prefix = "/" if base == "/" else base + "/"
        self._c.query("DELETE FROM filemeta WHERE directory=?",
                      (base.encode(),))
        for (d,) in self._c.query("SELECT DISTINCT directory FROM filemeta"):
            ds = d.decode()
            if ds.startswith(deep_prefix) and ds != _KV_DIR:
                self._c.query("DELETE FROM filemeta WHERE directory=?",
                              (d,))

    def list_directory_entries(self, dir_path: str, start_file_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        op = ">=" if include_start else ">"
        start = start_file_name
        if prefix and (not start or prefix > start):
            start, op = prefix, ">="
        rows = self._c.query(
            f"SELECT name, meta FROM filemeta WHERE directory=? "
            f"AND name{op}? ORDER BY name ASC LIMIT ?",
            (dir_path.encode(), start.encode(),
             struct.pack(">i", limit + (64 if prefix else 0))))
        out: list[Entry] = []
        for name_b, meta in rows:
            name = name_b.decode()
            if prefix and not name.startswith(prefix):
                if name > prefix:
                    break
                continue
            if not meta:
                continue
            out.append(Entry.from_json(meta.decode()))
            if len(out) >= limit:
                break
        return out

    def kv_put(self, key: str, value: bytes) -> None:
        self._c.query(_INSERT, (_KV_DIR.encode(), key.encode(), value))

    def kv_get(self, key: str) -> Optional[bytes]:
        rows = self._c.query(_SELECT_ONE, (_KV_DIR.encode(), key.encode()))
        return rows[0][0] if rows else None

    def close(self) -> None:
        self._c.close()
