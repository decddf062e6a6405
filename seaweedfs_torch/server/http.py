"""HTTP helpers of the port's servers, shell and client.

The servers themselves are aiohttp applications (server/master.py,
server/volume_server.py), as the reference's are. This module has what
they share with the synchronous side:

- ``listen_socket(host, port)`` binds a listening socket (port 0 picks a
  free port, which the caller reads before the app starts, so that a
  server knows its own address before its first heartbeat), and
  ``start_app(app, sock)`` serves an app on it on the running loop;
- ``errors_as_json``, the apps' middleware that answers an exception a
  handler raised with 500 and ``{"error": "<type>: <message>"}``, so the
  reason (a coder that cannot run here, say) reaches the client;
- the synchronous client that the client, the shell, the CLI and the EC
  read path's peer shard reads use: ``request()`` keeps one keep-alive
  connection per thread and host and retries once on a fresh connection
  when a kept one went stale (a server that stopped closes its kept
  connections); ``get_json`` / ``post_json``.
"""

from __future__ import annotations

import http.client
import json
import logging
import socket
import threading
from typing import Optional

from aiohttp import web

log = logging.getLogger("http")

# how long a stopping server waits for requests in flight
SHUTDOWN_TIMEOUT = 1.0


@web.middleware
async def errors_as_json(request: web.Request, handler):
    try:
        return await handler(request)
    except web.HTTPException:
        raise
    except Exception as e:
        log.exception("%s %s failed", request.method, request.path)
        return web.json_response({"error": f"{type(e).__name__}: {e}"},
                                 status=500)


def listen_socket(host: str, port: int) -> socket.socket:
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        sock.bind((host, port))
    except OSError:
        sock.close()
        raise
    return sock


def listen_socket_with_grpc_twin(host: str = "127.0.0.1",
                                 tries: int = 64) -> socket.socket:
    """A socket bound to a free port whose gRPC twin (port + 10000, the
    convention peers derive each other's gRPC address by) is free too
    and a valid port."""
    for _ in range(tries):
        sock = listen_socket(host, 0)
        twin = sock.getsockname()[1] + 10000
        if twin <= 65535:
            with socket.socket() as probe:
                try:
                    probe.bind((host, twin))
                    return sock
                except OSError:
                    pass
        sock.close()
    raise OSError("no free port with a free gRPC twin")


def free_port_with_grpc_twin(host: str = "127.0.0.1") -> int:
    """A free port whose +10000 twin is free, for a server that binds
    both itself (a CLI process)."""
    sock = listen_socket_with_grpc_twin(host)
    port = sock.getsockname()[1]
    sock.close()
    return port


async def start_app(app: web.Application,
                    sock: socket.socket) -> web.AppRunner:
    """Serve `app` on the bound socket; ``await runner.cleanup()`` stops
    it (the listener, then every kept connection, then the app's
    cleanup hooks)."""
    runner = web.AppRunner(app, access_log=None,
                           shutdown_timeout=SHUTDOWN_TIMEOUT)
    await runner.setup()
    try:
        await web.SockSite(runner, sock).start()
    except BaseException:
        await runner.cleanup()
        raise
    return runner


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


def post_json(url: str, body: dict, timeout: float = 300.0,
              headers: Optional[dict] = None) -> tuple[int, dict]:
    r = request("POST", url, json.dumps(body).encode(),
                {**(headers or {}), "Content-Type": "application/json"},
                timeout)
    try:
        return r.status, r.json()
    except ValueError:
        return r.status, {"error": f"HTTP {r.status}"}
