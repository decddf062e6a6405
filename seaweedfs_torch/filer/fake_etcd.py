"""An etcd v3 HTTP/JSON gateway in the repo, for the etcd store.

The port's copy of seaweedfs_tpu/filer/fake_etcd.py: ``/v3/kv/put``,
``/v3/kv/range`` (a point get, or a half-open [key, range_end) range in
key order with ``limit`` and ``more``) and ``/v3/kv/deleterange`` (with
its ``deleted`` count) over a sorted keyspace in memory, on a threaded
HTTP server. Only what etcd_store.py sends is served.
"""

from __future__ import annotations

import base64
import bisect
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.keys: list[bytes] = []      # sorted
        self.data: dict[bytes, bytes] = {}

    def put(self, k: bytes, v: bytes) -> None:
        with self.lock:
            if k not in self.data:
                bisect.insort(self.keys, k)
            self.data[k] = v

    def range(self, k: bytes, end: bytes | None, limit: int):
        with self.lock:
            if end is None:
                v = self.data.get(k)
                return ([(k, v)] if v is not None else []), False
            lo = bisect.bisect_left(self.keys, k)
            hi = bisect.bisect_left(self.keys, end)
            sel = self.keys[lo:hi]
            more = bool(limit) and len(sel) > limit
            if limit:
                sel = sel[:limit]
            return [(key, self.data[key]) for key in sel], more

    def delete(self, k: bytes, end: bytes | None) -> int:
        with self.lock:
            if end is None:
                if k in self.data:
                    del self.data[k]
                    self.keys.remove(k)
                    return 1
                return 0
            lo = bisect.bisect_left(self.keys, k)
            hi = bisect.bisect_left(self.keys, end)
            victims = self.keys[lo:hi]
            for key in victims:
                del self.data[key]
            del self.keys[lo:hi]
            return len(victims)


def _make_handler(state: _State):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            ln = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(ln) or b"{}")
            except ValueError:
                self.send_error(400)
                return
            k = base64.b64decode(body.get("key", ""))
            end_s = body.get("range_end")
            end = base64.b64decode(end_s) if end_s else None
            if self.path == "/v3/kv/put":
                state.put(k, base64.b64decode(body.get("value", "")))
                out = {"header": {}}
            elif self.path == "/v3/kv/range":
                kvs, more = state.range(k, end,
                                        int(body.get("limit", 0) or 0))
                out = {"header": {}, "more": more, "count": len(kvs),
                       "kvs": [{"key": base64.b64encode(key).decode(),
                                "value": base64.b64encode(val).decode()}
                               for key, val in kvs]}
            elif self.path == "/v3/kv/deleterange":
                out = {"header": {}, "deleted": state.delete(k, end)}
            else:
                self.send_error(404)
                return
            payload = json.dumps(out).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

    return Handler


class FakeEtcdServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.state = _State()
        self._srv = ThreadingHTTPServer((host, port),
                                        _make_handler(self.state))
        self.host = host
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def servers(self) -> str:
        return f"{self.host}:{self.port}"

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
