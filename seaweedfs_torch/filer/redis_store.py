"""The redis filer store: entries by full path, one SET per directory.

The port's copy of seaweedfs_tpu/filer/redis_store.py (upstream
weed/filer/redis/universal_redis_store.go): an entry's JSON lives at the
key of its full path (SET/GET/DEL), and each directory keeps its
children's names in a redis SET at ``dir + "\\x00"`` (SADD on insert,
SREM on delete, SMEMBERS and a sort on the client for a listing). There
are no transactions, so a rename is not atomic on this store, as
upstream. The keys and values are the reference's, so either package's
store reads what the other's wrote to one server.

``_RespClient`` speaks RESP2 over one socket (no redis library is
needed); ``KvSequencer`` (topology/sequence.py) and ``redis2`` use it
too. The tests and the smoke run it against fake_redis.py.
"""

from __future__ import annotations

import socket
import threading
from typing import Optional

from .entry import Entry
from .stores import FilerStore, _split

DIR_LIST_MARKER = "\x00"  # universal_redis_store.go:19
_KV_PREFIX = "kv\x01"


class _RespClient:
    """A RESP2 client: one socket, one command at a time."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._buf = b""
        self._lock = threading.Lock()

    def command(self, *parts):
        items = [p if isinstance(p, bytes) else str(p).encode()
                 for p in parts]
        req = b"*" + str(len(items)).encode() + b"\r\n" + b"".join(
            b"$" + str(len(i)).encode() + b"\r\n" + i + b"\r\n"
            for i in items)
        with self._lock:
            self.sock.sendall(req)
            return self._read_reply()

    def _fill(self) -> None:
        chunk = self.sock.recv(65536)
        if not chunk:
            raise ConnectionError("redis server closed connection")
        self._buf += chunk

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            self._fill()
        line, _, self._buf = self._buf.partition(b"\r\n")
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:
            self._fill()
        out, self._buf = self._buf[:n], self._buf[n + 2:]
        return out

    def _read_reply(self):
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RuntimeError(f"redis error: {rest.decode()}")
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            return None if n == -1 else self._read_exact(n)
        if kind == b"*":
            return [self._read_reply() for _ in range(int(rest))]
        raise ConnectionError(f"bad RESP reply {line!r}")

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def _dir_list_key(dir_path: str) -> str:
    return dir_path + DIR_LIST_MARKER


class RedisStore(FilerStore):
    name = "redis"

    def __init__(self, host: str = "127.0.0.1", port: int = 6379, **_):
        self._client = _RespClient(host, port)
        self._client.command("PING")

    def insert_entry(self, entry: Entry) -> None:
        c = self._client
        c.command("SET", entry.full_path, entry.to_json())
        d, name = _split(entry.full_path)
        if name:
            c.command("SADD", _dir_list_key(d), name)

    def update_entry(self, entry: Entry) -> None:
        self.insert_entry(entry)

    def find_entry(self, path: str) -> Optional[Entry]:
        data = self._client.command("GET", path)
        if data is None:
            return None
        return Entry.from_json(data.decode())

    def delete_entry(self, path: str) -> None:
        c = self._client
        c.command("DEL", path, _dir_list_key(path))
        d, name = _split(path)
        if name:
            c.command("SREM", _dir_list_key(d), name)

    def delete_folder_children(self, path: str) -> None:
        c = self._client
        for raw in c.command("SMEMBERS", _dir_list_key(path)):
            child = f"{path.rstrip('/')}/{raw.decode()}"
            self.delete_folder_children(child)
            c.command("DEL", child, _dir_list_key(child))
        c.command("DEL", _dir_list_key(path))

    def list_directory_entries(self, dir_path: str, start_file_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        names = sorted(raw.decode() for raw in self._client.command(
            "SMEMBERS", _dir_list_key(dir_path)))
        out: list[Entry] = []
        base = dir_path.rstrip("/")
        for name in names:
            if prefix and not name.startswith(prefix):
                continue
            if start_file_name:
                if include_start:
                    if name < start_file_name:
                        continue
                elif name <= start_file_name:
                    continue
            e = self.find_entry(f"{base}/{name}")
            if e is None:
                # a member whose entry is gone (a racing delete): skipped,
                # as the reference does
                continue
            out.append(e)
            if len(out) >= limit:
                break
        return out

    def kv_put(self, key: str, value: bytes) -> None:
        self._client.command("SET", _KV_PREFIX + key, value)

    def kv_get(self, key: str) -> Optional[bytes]:
        return self._client.command("GET", _KV_PREFIX + key)

    def close(self) -> None:
        self._client.close()
