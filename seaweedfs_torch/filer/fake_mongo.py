"""A mongod in the repo, for the mongodb store.

The port's copy of seaweedfs_tpu/filer/fake_mongo.py: the OP_MSG
commands mongodb_store.py sends (ping; find with equality and
$gt/$gte/$lt/$lte on fields, a sort and a limit; upsert updates;
deletes of one or all matches; insert) over mongo's frames and the BSON
subset of bson_lite.py, on one in-memory ``filemeta`` collection keyed
by (directory, name).
"""

from __future__ import annotations

import socketserver
import struct
import threading

from . import bson_lite as bson
from .netutil import read_exact

OP_MSG = 2013
_OPS = {"$gt": lambda a, b: a > b, "$gte": lambda a, b: a >= b,
        "$lt": lambda a, b: a < b, "$lte": lambda a, b: a <= b}


def _match_cond(value, cond) -> bool:
    if isinstance(cond, dict):
        for op, rhs in cond.items():
            if op not in _OPS:
                raise ValueError(f"fake_mongo: unsupported operator {op}")
            if not _OPS[op](value, rhs):
                return False
        return True
    return value == cond


def _match(doc: dict, flt: dict) -> bool:
    return all(_match_cond(doc.get(k), cond) for k, cond in flt.items())


def _point(q: dict):
    """The (directory, name) key a query names exactly, else None."""
    d, n = q.get("directory"), q.get("name")
    if len(q) == 2 and isinstance(d, str) and isinstance(n, str):
        return d, n
    return None


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.docs: dict[tuple[str, str], dict] = {}

    def _select(self, q: dict) -> list:
        key = _point(q)
        if key is not None:
            return [key] if key in self.docs else []
        return [k for k, d in self.docs.items() if _match(d, q)]

    def find(self, flt: dict, sort: dict | None, limit: int) -> list[dict]:
        with self.lock:
            rows = [self.docs[k] for k in self._select(flt)]
        if sort:
            key, direction = next(iter(sort.items()))
            rows.sort(key=lambda d: d.get(key) or "", reverse=direction < 0)
        else:
            rows.sort(key=lambda d: (d.get("directory", ""),
                                     d.get("name", "")))
        return rows[:limit] if limit else rows

    def upsert(self, q: dict, u: dict) -> int:
        with self.lock:
            hit = self._select(q)
            key = hit[0] if hit else (u.get("directory", ""),
                                      u.get("name", ""))
            self.docs[key] = dict(u)
            return 1

    def delete(self, q: dict, limit: int) -> int:
        with self.lock:
            victims = self._select(q)
            if limit:
                victims = victims[:limit]
            for k in victims:
                del self.docs[k]
            return len(victims)


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        state: _State = self.server.state  # type: ignore[attr-defined]
        recv = self.request.recv
        try:
            while True:
                header = read_exact(recv, 16)
                length, req_id, _resp, opcode = struct.unpack("<iiii",
                                                              header)
                payload = read_exact(recv, length - 16)
                if opcode != OP_MSG or payload[4] != 0:
                    return
                cmd, _ = bson.decode_doc(payload, 5)
                body = (struct.pack("<I", 0) + b"\x00"
                        + bson.encode_doc(_execute(state, cmd)))
                self.request.sendall(
                    struct.pack("<iiii", 16 + len(body), 1, req_id,
                                OP_MSG) + body)
        except (ConnectionError, OSError):
            return


def _execute(state: _State, cmd: dict) -> dict:
    if "ping" in cmd or "ismaster" in cmd or "hello" in cmd:
        return {"ok": 1.0}
    if "find" in cmd:
        rows = state.find(cmd.get("filter", {}), cmd.get("sort"),
                          int(cmd.get("limit", 0)))
        ns = f"{cmd.get('$db', 'db')}.{cmd['find']}"
        return {"cursor": {"id": 0, "ns": ns, "firstBatch": rows},
                "ok": 1.0}
    if "update" in cmd:
        n = 0
        for upd in cmd.get("updates", []):
            if not upd.get("upsert"):
                raise ValueError("fake_mongo: only upsert updates")
            n += state.upsert(upd.get("q", {}), upd.get("u", {}))
        return {"n": n, "ok": 1.0}
    if "delete" in cmd:
        n = sum(state.delete(dl.get("q", {}), int(dl.get("limit", 0)))
                for dl in cmd.get("deletes", []))
        return {"n": n, "ok": 1.0}
    if "insert" in cmd:
        docs = cmd.get("documents", [])
        with state.lock:
            for d in docs:
                state.docs[(d.get("directory", ""),
                            d.get("name", ""))] = dict(d)
        return {"n": len(docs), "ok": 1.0}
    return {"ok": 0.0, "errmsg": f"unknown command {list(cmd)[:1]}"}


class FakeMongoServer:
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
