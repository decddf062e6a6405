"""HTTP on the standard library: the routing layer of the port's servers.

The reference's master and volume server are aiohttp apps
(seaweedfs_tpu/server/master.py, volume_server.py). The port's servers
keep their wire (the same paths, query parameters, JSON keys and status
codes) on ``http.server.ThreadingHTTPServer`` instead, with no asyncio:
each connection has a thread, and a handler calls the store directly on
it, as the reference's executors do.

Server side:

- ``App`` routes a method and an exact path to a handler, with one
  catch-all route for ``/{fid}`` (the volume server's data path);
- a handler takes a ``Request`` (method, path, first value of each query
  parameter, headers, the body read whole) and returns a ``Response``,
  ``json_response(obj)`` or a ``FileResponse`` (a file streamed with
  ``socket.sendfile``, never read into one ``bytes``);
- HTTP/1.1 with keep-alive: every response carries a Content-Length;
- a request body over ``MAX_BODY``, sent with a Content-Length or in
  chunks, answers 413 and closes the connection;
- an exception in a handler answers 500 with ``{"error": ...}``;
- ``serve(app, host, port)`` binds (port 0 picks a free port, reported in
  ``Server.port``) and serves on a thread; ``Server.shutdown()`` stops
  it, closes every open connection and joins the serving thread.

Client side: ``request()`` keeps one keep-alive connection per thread and
host and retries once on a fresh connection when a kept one went stale;
``get_json`` / ``post_json``; ``download_to`` streams a response body
into a file in chunks.
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import socket
import sys
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

log = logging.getLogger("http")

JSON_TYPE = "application/json; charset=utf-8"
MAX_BODY = 256 * 1024 * 1024


class Request:
    def __init__(self, method: str, path: str, query: dict, headers,
                 body: bytes):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.body = body
        self.match: dict = {}

    def json(self) -> dict:
        return json.loads(self.body or b"{}")


class Response:
    """A body with no content type is application/octet-stream, and an
    empty one has none, as in aiohttp."""

    def __init__(self, body: bytes = b"", status: int = 200,
                 headers: Optional[dict] = None,
                 content_type: Optional[str] = None):
        self.body = body
        self.status = status
        self.headers = dict(headers or {})
        if content_type is None and body:
            content_type = "application/octet-stream"
        if content_type is not None and "Content-Type" not in self.headers:
            self.headers["Content-Type"] = content_type


def json_response(obj, status: int = 200) -> Response:
    """The body aiohttp's json_response writes: json.dumps with its
    default separators, UTF-8."""
    return Response(json.dumps(obj).encode(), status,
                    content_type=JSON_TYPE)


class FileResponse(Response):
    """A whole file, streamed from its descriptor."""

    def __init__(self, path: str, status: int = 200):
        super().__init__(b"", status,
                         content_type="application/octet-stream")
        self.path = path
        self.headers["Content-Length"] = str(os.path.getsize(path))


Handler = Callable[[Request], Response]


class App:
    def __init__(self):
        self._routes: dict[str, dict[str, Handler]] = {}
        self._catch_all: Optional[tuple[str, Handler]] = None

    def route(self, method: str, path: str, handler: Handler) -> None:
        """Route a method and an exact path to `handler`; a GET route
        answers HEAD too, as aiohttp's add_get does."""
        by_method = self._routes.setdefault(path, {})
        by_method[method] = handler
        if method == "GET":
            by_method["HEAD"] = handler

    def catch_all(self, name: str, handler: Handler) -> None:
        """Every other path, any method: request.match[name] is the path
        without its leading slash."""
        self._catch_all = (name, handler)

    def dispatch(self, req: Request) -> Response:
        by_method = self._routes.get(req.path)
        if by_method is not None:
            handler = by_method.get(req.method)
            if handler is None:
                return Response(b"405: Method Not Allowed", 405,
                                content_type="text/plain; charset=utf-8")
        elif self._catch_all is not None:
            name, handler = self._catch_all
            req.match[name] = req.path[1:]
        else:
            return Response(b"404: Not Found", 404,
                            content_type="text/plain; charset=utf-8")
        try:
            return handler(req)
        except Exception as e:
            log.exception("%s %s failed", req.method, req.path)
            return json_response({"error": f"{type(e).__name__}: {e}"},
                                 status=500)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # an idle keep-alive connection is dropped after this many seconds
    timeout = 300
    # headers and body go out in separate writes: without TCP_NODELAY
    # the peer's delayed ACK holds each response for tens of ms
    disable_nagle_algorithm = True
    server: "_HTTPServer"

    def log_message(self, format, *args) -> None:
        log.debug("%s " + format, self.address_string(), *args)

    def _read_body(self) -> Optional[bytes]:
        if "chunked" in self.headers.get("Transfer-Encoding", "").lower():
            parts, total = [], 0
            while True:
                size = int(self.rfile.readline().split(b";")[0].strip(), 16)
                if size == 0:
                    while self.rfile.readline() not in (b"\r\n", b"\n", b""):
                        pass
                    return b"".join(parts)
                total += size
                if total > MAX_BODY:
                    return None
                parts.append(self.rfile.read(size))
                self.rfile.readline()
        length = int(self.headers.get("Content-Length") or 0)
        if length > MAX_BODY:
            return None
        return self.rfile.read(length) if length else b""

    def _handle(self) -> None:
        split = urllib.parse.urlsplit(self.path)
        query: dict = {}
        for k, v in urllib.parse.parse_qsl(split.query,
                                           keep_blank_values=True):
            query.setdefault(k, v)
        body = self._read_body()
        if body is None:
            self.close_connection = True
            resp = json_response({"error": "request body too large"}, 413)
        else:
            req = Request(self.command, urllib.parse.unquote(split.path),
                          query, self.headers, body)
            resp = self.server.app.dispatch(req)
        self._send(resp)

    def _send(self, resp: Response) -> None:
        self.send_response(resp.status)
        headers = dict(resp.headers)
        length = int(headers.pop("Content-Length", len(resp.body)))
        for k, v in headers.items():
            self.send_header(k, v)
        if resp.status != 304:
            self.send_header("Content-Length", str(length))
        self.end_headers()
        if self.command == "HEAD" or resp.status in (204, 304):
            return
        if isinstance(resp, FileResponse):
            if length:
                with open(resp.path, "rb") as f:
                    self.connection.sendfile(f, 0, length)
        elif resp.body:
            self.wfile.write(resp.body)

    do_GET = do_POST = do_PUT = do_DELETE = do_HEAD = _handle


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr, app: App):
        self.app = app
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        super().__init__(addr, _Handler)

    def process_request(self, request, client_address):
        with self._conns_lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def handle_error(self, request, client_address):
        # a peer that hangs up mid-exchange (or a shutdown closing kept
        # connections) is not the server's error
        log.debug("connection from %s ended: %s", client_address,
                  sys.exc_info()[1])

    def shutdown_request(self, request):
        with self._conns_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def close_connections(self) -> None:
        with self._conns_lock:
            conns, self._conns = list(self._conns), set()
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class Server:
    """One app served on a thread."""

    def __init__(self, app: App, host: str = "127.0.0.1", port: int = 0):
        self._httpd = _HTTPServer((host, port), app)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name=f"http-{self.port}", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"

    def shutdown(self) -> None:
        """Stop accepting, drop every open connection, join the serving
        thread."""
        self._httpd.shutdown()
        self._httpd.close_connections()
        self._httpd.server_close()
        self._thread.join()


def serve(app: App, host: str = "127.0.0.1", port: int = 0) -> Server:
    return Server(app, host, port)


# --- client side ---------------------------------------------------------

class ClientResponse:
    def __init__(self, status: int, headers, data: bytes):
        self.status = status
        self.headers = headers
        self.data = data

    def json(self) -> dict:
        return json.loads(self.data)


_local = threading.local()
_STALE = (http.client.RemoteDisconnected, http.client.BadStatusLine,
          http.client.CannotSendRequest, ConnectionResetError,
          BrokenPipeError, ConnectionAbortedError)


def _split(url: str) -> tuple[str, str]:
    """('host:port', '/path?query') of an http:// URL."""
    rest = url[len("http://"):] if url.startswith("http://") else url
    host, sep, path = rest.partition("/")
    return host, "/" + path if sep else "/"


def request(method: str, url: str, body: Optional[bytes] = None,
            headers: Optional[dict] = None,
            timeout: float = 30.0) -> ClientResponse:
    """One request on this thread's keep-alive connection to the host; a
    kept connection that went stale is retried once on a fresh one."""
    host, path = _split(url)
    pool = getattr(_local, "conns", None)
    if pool is None:
        pool = _local.conns = {}
    for attempt in (0, 1):
        conn = pool.get(host)
        reused = conn is not None
        if conn is None:
            conn = pool[host] = http.client.HTTPConnection(host,
                                                           timeout=timeout)
        else:
            conn.timeout = timeout
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            r = conn.getresponse()
            data = r.read()
            if r.will_close:
                conn.close()
                pool.pop(host, None)
            return ClientResponse(r.status, r.headers, data)
        except _STALE:
            conn.close()
            pool.pop(host, None)
            if not reused or attempt:
                raise
        except BaseException:
            conn.close()
            pool.pop(host, None)
            raise
    raise AssertionError("unreachable")


def get_json(url: str, timeout: float = 30.0) -> tuple[int, dict]:
    r = request("GET", url, timeout=timeout)
    return r.status, r.json()


def post_json(url: str, body: dict,
              timeout: float = 300.0) -> tuple[int, dict]:
    r = request("POST", url, json.dumps(body).encode(),
                {"Content-Type": "application/json"}, timeout)
    try:
        return r.status, r.json()
    except ValueError:
        return r.status, {"error": f"HTTP {r.status}"}


def download_to(url: str, path: str, timeout: float = 60.0,
                chunk: int = 1 << 20) -> int:
    """GET url into the file at path, chunk by chunk, on a connection of
    its own; returns the status (the file is written only on 200)."""
    host, target = _split(url)
    conn = http.client.HTTPConnection(host, timeout=timeout)
    try:
        conn.request("GET", target)
        r = conn.getresponse()
        if r.status != 200:
            r.read()
            return r.status
        with open(path, "wb") as f:
            while True:
                buf = r.read(chunk)
                if not buf:
                    break
                f.write(buf)
        return r.status
    finally:
        conn.close()
