"""A redis-protocol server in the repo, for the redis stores and the
``KvSequencer``.

The port's copy of seaweedfs_tpu/filer/fake_redis.py: a threaded socket
server that speaks enough RESP2 for the command set of redis_store.py,
redis2_store.py and topology/sequence.py (GET/SET/DEL/EXISTS/SADD/SREM/
SMEMBERS/INCRBY/ZADD/ZREM/ZCARD/ZRANK/ZRANGE/PING/FLUSHALL), in memory.
It answers what a redis would, byte for byte, so the tests run either
package's store against either package's fake.
"""

from __future__ import annotations

import socketserver
import threading


def _encode(obj) -> bytes:
    """A Python value as a RESP2 reply."""
    if obj is None:
        return b"$-1\r\n"
    if isinstance(obj, int):
        return f":{obj}\r\n".encode()
    if isinstance(obj, bytes):
        return b"$" + str(len(obj)).encode() + b"\r\n" + obj + b"\r\n"
    if isinstance(obj, str):
        return _encode(obj.encode())
    if isinstance(obj, (list, tuple, set)):
        items = sorted(obj) if isinstance(obj, set) else list(obj)
        return (b"*" + str(len(items)).encode() + b"\r\n"
                + b"".join(_encode(i) for i in items))
    raise TypeError(type(obj))


def _parse(buf: bytes):
    """(command, rest) for one RESP array of bulk strings at the head of
    `buf`; (None, buf) while it is incomplete; (None, None) on garbage."""
    if not buf:
        return None, buf
    if buf[0:1] != b"*":
        return None, None
    head, sep, rest = buf.partition(b"\r\n")
    if not sep:
        return None, buf
    items = []
    for _ in range(int(head[1:])):
        if rest[0:1] != b"$":
            return None, buf if b"\r\n" not in rest else None
        line, sep, rest2 = rest.partition(b"\r\n")
        if not sep:
            return None, buf
        ln = int(line[1:])
        if len(rest2) < ln + 2:
            return None, buf
        items.append(rest2[:ln])
        rest = rest2[ln + 2:]
    return items, rest


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        srv: "FakeRedisServer" = self.server.owner  # type: ignore
        buf = b""
        while True:
            cmd, rest = _parse(buf)
            if rest is None:
                return
            if cmd is None:
                try:
                    chunk = self.request.recv(65536)
                except OSError:
                    return
                if not chunk:
                    return
                buf += chunk
                continue
            buf = rest
            try:
                self.request.sendall(srv.execute(cmd))
            except OSError:
                return


def _zorder(z: dict) -> list:
    return [m for m, _s in sorted(z.items(), key=lambda kv: (kv[1], kv[0]))]


class FakeRedisServer:
    """``with FakeRedisServer() as (host, port): ...``"""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._strings: dict[bytes, bytes] = {}
        self._sets: dict[bytes, set] = {}
        self._zsets: dict[bytes, dict] = {}  # key -> {member: score}
        self._lock = threading.Lock()
        self._tcp = socketserver.ThreadingTCPServer((host, port), _Handler)
        self._tcp.daemon_threads = True
        self._tcp.owner = self
        self.host, self.port = self._tcp.server_address
        self._thread = threading.Thread(target=self._tcp.serve_forever,
                                        daemon=True)
        self._thread.start()

    def execute(self, cmd: list[bytes]) -> bytes:
        name = cmd[0].upper().decode()
        args = cmd[1:]
        with self._lock:
            if name == "PING":
                return b"+PONG\r\n"
            if name == "SET":
                self._strings[args[0]] = args[1]
                self._sets.pop(args[0], None)
                return b"+OK\r\n"
            if name == "GET":
                return _encode(self._strings.get(args[0]))
            if name == "DEL":
                n = 0
                for key in args:
                    n += (self._strings.pop(key, None) is not None) or \
                         (self._sets.pop(key, None) is not None) or \
                         (self._zsets.pop(key, None) is not None)
                return _encode(int(n))
            if name == "EXISTS":
                return _encode(sum(1 for key in args
                                   if key in self._strings
                                   or key in self._sets
                                   or key in self._zsets))
            if name == "SADD":
                s = self._sets.setdefault(args[0], set())
                before = len(s)
                s.update(args[1:])
                return _encode(len(s) - before)
            if name == "SREM":
                s = self._sets.get(args[0], set())
                before = len(s)
                s.difference_update(args[1:])
                if not s:
                    self._sets.pop(args[0], None)
                return _encode(before - len(s))
            if name == "SMEMBERS":
                return _encode(self._sets.get(args[0], set()))
            if name == "INCRBY":
                cur = int(self._strings.get(args[0], b"0")) + int(args[1])
                self._strings[args[0]] = str(cur).encode()
                return _encode(cur)
            if name == "ZADD":
                # ZADD key [NX] score member [score member ...]
                rest = args[1:]
                nx = bool(rest) and rest[0].upper() == b"NX"
                if nx:
                    rest = rest[1:]
                z = self._zsets.setdefault(args[0], {})
                added = 0
                for i in range(0, len(rest) - 1, 2):
                    score, member = float(rest[i]), rest[i + 1]
                    if member not in z:
                        added += 1
                        z[member] = score
                    elif not nx:
                        z[member] = score
                return _encode(added)
            if name == "ZREM":
                z = self._zsets.get(args[0], {})
                n = sum(z.pop(m, None) is not None for m in args[1:])
                if not z:
                    self._zsets.pop(args[0], None)
                return _encode(n)
            if name == "ZCARD":
                return _encode(len(self._zsets.get(args[0], {})))
            if name == "ZRANK":
                members = _zorder(self._zsets.get(args[0], {}))
                try:
                    return _encode(members.index(args[1]))
                except ValueError:
                    return b"$-1\r\n"
            if name == "ZRANGE":
                members = _zorder(self._zsets.get(args[0], {}))
                start, stop = int(args[1]), int(args[2])
                n = len(members)
                if start < 0:
                    start += n
                if stop < 0:
                    stop += n
                return _encode(members[max(start, 0):stop + 1])
            if name == "FLUSHALL":
                self._strings.clear()
                self._sets.clear()
                self._zsets.clear()
                return b"+OK\r\n"
            return f"-ERR unknown command '{name}'\r\n".encode()

    def close(self) -> None:
        self._tcp.shutdown()
        self._tcp.server_close()

    def __enter__(self):
        return self.host, self.port

    def __exit__(self, *exc):
        self.close()
