"""In-repo fake GCS: the JSON/media REST subset GcsSink speaks — media
upload, object delete, plus media download for test verification.

The port's copy of seaweedfs_tpu/replication/fake_gcs.py, whole: a
threaded HTTP server (as filer/fake_redis.py and filer/fake_etcd.py are),
so the sink is proved over real sockets without cloud access. Optionally
enforces a bearer token to prove the auth header plumbing.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlparse

_UPLOAD = re.compile(r"^/upload/storage/v1/b/([^/]+)/o$")
_OBJECT = re.compile(r"^/storage/v1/b/([^/]+)/o/(.+)$")


def _make_handler(state: dict, lock: threading.Lock, token: str):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _reply(self, status: int, body: bytes = b"{}",
                   ctype: str = "application/json") -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _authed(self) -> bool:
            if not token:
                return True
            return self.headers.get("Authorization") == f"Bearer {token}"

        def do_POST(self):
            if not self._authed():
                self._reply(401)
                return
            u = urlparse(self.path)
            m = _UPLOAD.match(u.path)
            if not m:
                self._reply(404)
                return
            q = parse_qs(u.query)
            name = unquote(q.get("name", [""])[0])
            ln = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(ln)
            with lock:
                state.setdefault(m.group(1), {})[name] = data
            self._reply(200, json.dumps(
                {"bucket": m.group(1), "name": name,
                 "size": str(len(data))}).encode())

        def do_DELETE(self):
            if not self._authed():
                self._reply(401)
                return
            m = _OBJECT.match(urlparse(self.path).path)
            if not m:
                self._reply(404)
                return
            name = unquote(m.group(2))
            with lock:
                objs = state.get(m.group(1), {})
                if name not in objs:
                    self._reply(404, b'{"error": {"code": 404}}')
                    return
                del objs[name]
            self._reply(204, b"")

        def do_GET(self):
            if not self._authed():
                self._reply(401)
                return
            u = urlparse(self.path)
            m = _OBJECT.match(u.path)
            if not m:
                self._reply(404)
                return
            name = unquote(m.group(2))
            with lock:
                data = state.get(m.group(1), {}).get(name)
            if data is None:
                self._reply(404, b'{"error": {"code": 404}}')
                return
            if "alt=media" in (u.query or ""):
                self._reply(200, data, "application/octet-stream")
            else:
                self._reply(200, json.dumps(
                    {"name": name, "size": str(len(data))}).encode())

    return Handler


class FakeGcsServer:
    def __init__(self, host: str = "127.0.0.1", token: str = ""):
        self.buckets: dict[str, dict[str, bytes]] = {}
        self._lock = threading.Lock()
        self._srv = ThreadingHTTPServer(
            (host, 0), _make_handler(self.buckets, self._lock, token))
        self.host = host
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def endpoint(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
