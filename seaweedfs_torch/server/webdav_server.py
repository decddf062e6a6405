"""WebDAV gateway over the filer (weed webdav equivalent,
weed/server/webdav_server.go:101 — golang.org/x/net/webdav FileSystem
backed by filer gRPC; here the same protocol surface over the filer's
HTTP API).

The port's copy of seaweedfs_tpu/server/webdav_server.py, an aiohttp
application with the reference's wire. Implements the RFC 4918 subset
real clients (davfs2, macOS Finder, Windows explorer, cadaver) use:
OPTIONS, PROPFIND (depth 0/1), GET/HEAD, PUT, DELETE, MKCOL, MOVE, COPY,
and class-2 LOCK / UNLOCK with PROPPATCH. The admission middleware
(overload/) meters every request, and ``/healthz`` and ``/metrics`` are
reserved through ``overload.reserve_ops``.

Left out, as in the port's S3 gateway (ROADMAP A.9): the trace
middleware and the ``/debug/trace``, ``/debug/profile``,
``/debug/pprof`` and ``/debug/events`` handlers, whose names stay
reserved and answer 405; ``/admin/faults``, which the port's ``faults``
does not serve.
"""

from __future__ import annotations

import logging
from typing import Optional
from urllib.parse import quote, unquote, urlparse
from xml.sax.saxutils import escape

import aiohttp
from aiohttp import web

from .. import overload
from ..utils import metrics as metrics_mod
from . import http

log = logging.getLogger("webdav")

_DAV_HEADERS = {
    "DAV": "1,2",
    "MS-Author-Via": "DAV",
    "Allow": ("OPTIONS, PROPFIND, GET, HEAD, PUT, DELETE, MKCOL, "
              "MOVE, COPY, LOCK, UNLOCK, PROPPATCH"),
}


def _rfc1123(ts: float) -> str:
    import time
    return time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime(ts))


def _is_dir(entry: dict) -> bool:
    """Directory-ness lives in the mode bits of the filer's entry JSON
    (S_IFDIR, like os.stat)."""
    mode = entry.get("attr", {}).get("mode", 0)
    return (int(mode) & 0o170000) == 0o040000


_DEFAULT_LOCK_SECONDS = 3600.0
_MAX_LOCK_SECONDS = 4 * 3600.0  # memLS's infiniteTimeout stand-in


class _Lock:
    __slots__ = ("path", "token", "expires", "depth_infinity")

    def __init__(self, path: str, token: str, expires: float,
                 depth_infinity: bool):
        self.path = path
        self.token = token
        self.expires = expires
        self.depth_infinity = depth_infinity

    @property
    def depth(self) -> str:
        return "infinity" if self.depth_infinity else "0"


class LockManager:
    """Exclusive write locks with expiry — the role of x/net/webdav's
    memLS (the lock system the reference inherits,
    weed/server/webdav_server.go:101). An infinite-depth lock covers the
    whole subtree; acquiring conflicts with locks on the path, any
    ancestor with depth infinity, or (for an infinite lock) any
    descendant. Expired locks are collected lazily."""

    def __init__(self):
        self._locks: dict[str, _Lock] = {}

    def _gc(self) -> None:
        import time
        now = time.monotonic()
        for p in [p for p, lk in self._locks.items()
                  if lk.expires <= now]:
            del self._locks[p]

    def holder(self, path: str) -> Optional[_Lock]:
        """The live lock governing `path` (own or covering ancestor)."""
        self._gc()
        lk = self._locks.get(path)
        if lk is not None:
            return lk
        parts = path.rstrip("/").split("/")
        for i in range(len(parts) - 1, 0, -1):
            anc = "/".join(parts[:i]) or "/"
            lk = self._locks.get(anc)
            if lk is not None and lk.depth_infinity:
                return lk
        return None

    def descendant_holder(self, path: str) -> Optional[_Lock]:
        """A live lock held BELOW `path` — deleting/moving the ancestor
        would destroy that locked resource (RFC 4918: 423 without its
        token)."""
        self._gc()
        prefix = path.rstrip("/") + "/"
        for p, lk in self._locks.items():
            if p.startswith(prefix):
                return lk
        return None

    def acquire(self, path: str, timeout: float,
                depth_infinity: bool = True) -> Optional[_Lock]:
        import time
        import uuid
        self._gc()
        if self.holder(path) is not None:
            return None
        if depth_infinity:
            prefix = path.rstrip("/") + "/"
            if any(p.startswith(prefix) for p in self._locks):
                return None
        lk = _Lock(path, f"opaquelocktoken:{uuid.uuid4()}",
                   time.monotonic() + timeout, depth_infinity)
        self._locks[path] = lk
        return lk

    def refresh(self, path: str, tokens: set,
                timeout: float) -> Optional[_Lock]:
        import time
        lk = self.holder(path)
        if lk is None or lk.token not in tokens:
            return None
        lk.expires = time.monotonic() + timeout
        return lk

    def release(self, path: str, token: str) -> bool:
        self._gc()
        lk = self.holder(path)
        if lk is None or lk.token != token:
            return False
        del self._locks[lk.path]
        return True

    def release_subtree(self, path: str) -> None:
        """Drop every lock at `path` and below. A successful DELETE/MOVE
        destroys those resources; RFC 4918 (9.6/7.5) says their locks go
        with them — leaving them registered would 423 the recreated path
        until expiry."""
        prefix = path.rstrip("/") + "/"
        for p in [p for p in self._locks
                  if p == path or p.startswith(prefix)]:
            del self._locks[p]


class WebDavServer:
    def __init__(self, filer_url: str, url: str = ""):
        self.filer = filer_url.rstrip("/")
        self.url = url  # own host:port
        self._session: Optional[aiohttp.ClientSession] = None
        self.locks = LockManager()
        self.metrics = metrics_mod.Registry("webdav")
        # gateway system set: only the reserved ops routes — user files
        # named like control-plane paths stay metered
        self.admission = overload.AdmissionController(
            "webdav", metrics=self.metrics,
            system_paths=(overload.GATEWAY_SYSTEM_PATHS
                          | overload.faults_admin_paths()))
        self.app = self._build_app()

    def _build_app(self) -> web.Application:
        app = web.Application(
            client_max_size=1024 * 1024 * 1024,
            middlewares=[overload.admission_middleware(self.admission)])
        # ops surface before the catch-all (exact routes win), via
        # overload.reserve_ops so every other method answers 405 and a
        # PUT can't create a file that GET then shadows. Like the rest
        # of the webdav protocol surface, these carry no auth — deploy
        # this gateway on trusted networks only. The debug routes are
        # not ported: their names stay reserved with no handler, so
        # each method answers 405 there
        for path, handler in (
                ("/healthz", overload.healthz_handler(self.admission)),
                ("/metrics", self.metrics_handler),
                ("/debug/trace", None),
                ("/debug/profile", None),
                ("/debug/pprof", None),
                ("/debug/events", None)):
            overload.reserve_ops(app, path, handler)
        app.router.add_route("*", "/{path:.*}", self.dispatch)
        app.on_startup.append(self._on_startup)
        app.on_cleanup.append(self._on_cleanup)
        return app

    async def metrics_handler(self, request: web.Request) -> web.Response:
        return web.Response(
            text=self.metrics.render() + metrics_mod.render_shared(),
            content_type="text/plain")

    async def _on_startup(self, app) -> None:
        await self.admission.start()
        self._session = aiohttp.ClientSession(
            # inactivity-bounded, no total cap (large file streams)
            timeout=aiohttp.ClientTimeout(total=None, sock_connect=10,
                                          sock_read=60))

    async def _on_cleanup(self, app) -> None:
        self.admission.stop()
        if self._session:
            await self._session.close()

    # --- filer meta helpers ---
    async def _lookup(self, path: str) -> Optional[dict]:
        async with self._session.get(
                f"http://{self.filer}/__meta__/lookup",
                params={"path": path or "/"}) as r:
            if r.status != 200:
                return None
            return await r.json()

    async def _list(self, path: str) -> list[dict]:
        async with self._session.get(
                f"http://{self.filer}/__meta__/list",
                params={"dir": path or "/"}) as r:
            if r.status != 200:
                return []
            return (await r.json()).get("entries", [])

    # --- dispatch ---
    async def dispatch(self, request: web.Request) -> web.StreamResponse:
        path = "/" + unquote(request.match_info["path"]).strip("/")
        method = request.method.upper()
        handler = {
            "OPTIONS": self.handle_options,
            "PROPFIND": self.handle_propfind,
            "GET": self.handle_get,
            "HEAD": self.handle_get,
            "PUT": self.handle_put,
            "DELETE": self.handle_delete,
            "MKCOL": self.handle_mkcol,
            "MOVE": self.handle_move,
            "COPY": self.handle_copy,
            "LOCK": self.handle_lock,
            "UNLOCK": self.handle_unlock,
            "PROPPATCH": self.handle_proppatch,
        }.get(method)
        if handler is None:
            return web.Response(status=405, headers=_DAV_HEADERS)
        # counted only for recognized methods: a client-chosen label
        # value would grow the registry without bound
        self.metrics.count("request", labels={"method": method})
        return await handler(request, path)

    async def handle_options(self, request, path) -> web.Response:
        return web.Response(status=200, headers=_DAV_HEADERS)

    # --- PROPFIND ---
    def _prop_xml(self, href: str, entry: dict) -> str:
        is_dir = _is_dir(entry)
        attr = entry.get("attr", {})
        size = sum(c.get("size", 0) for c in entry.get("chunks", []))
        mtime = attr.get("mtime", 0)
        ctype = attr.get("mime") or "application/octet-stream"
        if is_dir and not href.endswith("/"):
            href += "/"
        res_type = "<D:collection/>" if is_dir else ""
        length = ("" if is_dir else
                  f"<D:getcontentlength>{size}</D:getcontentlength>")
        return (
            "<D:response>"
            f"<D:href>{escape(quote(href))}</D:href>"
            "<D:propstat><D:prop>"
            f"<D:resourcetype>{res_type}</D:resourcetype>"
            f"{length}"
            f"<D:getlastmodified>{_rfc1123(mtime)}</D:getlastmodified>"
            f"<D:getcontenttype>{escape(ctype)}</D:getcontenttype>"
            f"<D:displayname>{escape(href.rstrip('/').rsplit('/', 1)[-1])}"
            "</D:displayname>"
            "</D:prop><D:status>HTTP/1.1 200 OK</D:status></D:propstat>"
            "</D:response>")

    async def handle_propfind(self, request, path) -> web.Response:
        depth = request.headers.get("Depth", "1")
        entry = await self._lookup(path)
        if entry is None:
            return web.Response(status=404)
        body = ['<?xml version="1.0" encoding="utf-8"?>',
                '<D:multistatus xmlns:D="DAV:">',
                self._prop_xml(path, entry)]
        if depth != "0" and _is_dir(entry):
            for child in await self._list(path):
                child_path = child.get("path", "")
                body.append(self._prop_xml(child_path, child))
        body.append("</D:multistatus>")
        return web.Response(status=207, text="".join(body),
                            content_type="application/xml",
                            headers={"DAV": "1,2"})

    # --- data ---
    async def handle_get(self, request, path) -> web.StreamResponse:
        entry = await self._lookup(path)
        if entry is None:
            return web.Response(status=404)
        if _is_dir(entry):
            return web.Response(status=403, text="is a collection")
        headers = {}
        if "Range" in request.headers:
            headers["Range"] = request.headers["Range"]
        async with self._session.get(
                f"http://{self.filer}{quote(path)}", headers=headers) as r:
            resp = web.StreamResponse(status=r.status)
            for h in ("Content-Type", "Content-Range", "ETag",
                      "Accept-Ranges"):
                if h in r.headers:
                    resp.headers[h] = r.headers[h]
            await resp.prepare(request)
            if request.method != "HEAD":
                async for chunk in r.content.iter_chunked(64 * 1024):
                    await resp.write(chunk)
            await resp.write_eof()
            return resp

    async def handle_put(self, request, path) -> web.Response:
        denied = self._lock_conflict(request, path)
        if denied is not None:
            return denied
        data = await request.read()
        async with self._session.put(
                f"http://{self.filer}{quote(path)}", data=data,
                headers={"Content-Type":
                         request.content_type
                         or "application/octet-stream"}) as r:
            return web.Response(status=201 if r.status < 300 else r.status)

    async def handle_delete(self, request, path) -> web.Response:
        denied = self._lock_conflict(request, path, subtree=True)
        if denied is not None:
            return denied
        async with self._session.delete(
                f"http://{self.filer}{quote(path)}",
                params={"recursive": "true"}) as r:
            if r.status == 404:
                return web.Response(status=404)
            if r.status >= 300:
                # the resource still exists: its locks must survive
                return web.Response(status=502)
            # the subtree is gone; its locks must not outlive it
            self.locks.release_subtree(path)
            return web.Response(status=204)

    async def handle_mkcol(self, request, path) -> web.Response:
        denied = self._lock_conflict(request, path)
        if denied is not None:
            return denied
        if await self._lookup(path) is not None:
            return web.Response(status=405)
        async with self._session.post(
                f"http://{self.filer}{quote(path)}",
                params={"op": "mkdir"}) as r:
            return web.Response(status=201 if r.status < 300 else r.status)

    def _dest_path(self, request) -> Optional[str]:
        dest = request.headers.get("Destination", "")
        if not dest:
            return None
        return "/" + unquote(urlparse(dest).path).strip("/")

    async def handle_move(self, request, path) -> web.Response:
        dest = self._dest_path(request)
        if dest is None:
            return web.Response(status=400, text="missing Destination")
        denied = self._lock_conflict(request, path, dest, subtree=True)
        if denied is not None:
            return denied
        existed = await self._lookup(dest) is not None
        if existed and request.headers.get("Overwrite", "T") == "F":
            return web.Response(status=412)
        async with self._session.post(
                f"http://{self.filer}{quote(path)}",
                params={"mv.to": dest}) as r:
            if r.status == 404:
                return web.Response(status=404)
            if r.status >= 300:
                # the move didn't happen: source locks must survive
                return web.Response(status=502)
            # nothing exists at the source anymore, and an overwritten
            # destination went through an implicit DELETE (RFC 4918
            # 9.9.4) — locks on either side die with the old resources
            self.locks.release_subtree(path)
            self.locks.release_subtree(dest)
            return web.Response(status=204 if existed else 201)

    async def handle_copy(self, request, path) -> web.Response:
        dest = self._dest_path(request)
        if dest is None:
            return web.Response(status=400, text="missing Destination")
        denied = self._lock_conflict(request, dest, subtree=True)
        if denied is not None:
            return denied
        entry = await self._lookup(path)
        if entry is None:
            return web.Response(status=404)
        if _is_dir(entry):
            return await self._copy_tree(request, path, dest)
        existed = await self._lookup(dest) is not None
        if existed and request.headers.get("Overwrite", "T") == "F":
            return web.Response(status=412)
        async with self._session.get(
                f"http://{self.filer}{quote(path)}") as r:
            data = await r.read()
        async with self._session.put(
                f"http://{self.filer}{quote(dest)}", data=data) as r:
            return web.Response(status=204 if existed else 201)

    async def _copy_tree(self, request, path, dest) -> web.Response:
        await self._session.post(f"http://{self.filer}{quote(dest)}",
                                 params={"op": "mkdir"})
        for child in await self._list(path):
            cp = child.get("path", "")
            name = cp.rsplit("/", 1)[-1]
            if _is_dir(child):
                await self._copy_tree(request, cp, f"{dest}/{name}")
            else:
                async with self._session.get(
                        f"http://{self.filer}{quote(cp)}") as r:
                    data = await r.read()
                await self._session.put(
                    f"http://{self.filer}{quote(dest + '/' + name)}",
                    data=data)
        return web.Response(status=201)

    # --- locks (class 2: real exclusive write locks with expiry, the
    # role x/net/webdav's memLS plays for the reference,
    # weed/server/webdav_server.go:101) ---
    def _submitted_tokens(self, request) -> set:
        """Tokens from the If header: (<opaquelocktoken:...>) groups."""
        import re
        return set(re.findall(r"<(opaquelocktoken:[^>]+)>",
                              request.headers.get("If", "")))

    def _lock_conflict(self, request, *paths,
                       subtree: bool = False) -> Optional[web.Response]:
        """423 unless every locked path among `paths` has its token in
        the request's If header. subtree=True also requires tokens for
        locks held on descendants (DELETE/MOVE of an ancestor destroys
        them)."""
        tokens = self._submitted_tokens(request)
        for p in paths:
            holders = [self.locks.holder(p)]
            if subtree:
                holders.append(self.locks.descendant_holder(p))
            for holder in holders:
                if holder is not None and holder.token not in tokens:
                    return web.Response(
                        status=423, content_type="application/xml",
                        text=('<?xml version="1.0" encoding="utf-8"?>'
                              '<D:error xmlns:D="DAV:">'
                              "<D:lock-token-submitted><D:href>"
                              f"{escape(quote(holder.path))}</D:href>"
                              "</D:lock-token-submitted></D:error>"))
        return None

    @staticmethod
    def _parse_timeout(request) -> float:
        """Timeout: Second-N | Infinite (capped like memLS's max)."""
        raw = request.headers.get("Timeout", "")
        for part in raw.split(","):
            part = part.strip()
            if part.lower().startswith("second-"):
                try:
                    return min(float(part[7:]), _MAX_LOCK_SECONDS)
                except ValueError:
                    pass
            if part.lower() == "infinite":
                return _MAX_LOCK_SECONDS
        return _DEFAULT_LOCK_SECONDS

    @staticmethod
    def _lock_body(lock: "_Lock") -> str:
        import time as time_mod
        remain = max(0, int(lock.expires - time_mod.monotonic()))
        return ('<?xml version="1.0" encoding="utf-8"?>'
                '<D:prop xmlns:D="DAV:"><D:lockdiscovery><D:activelock>'
                '<D:locktype><D:write/></D:locktype>'
                '<D:lockscope><D:exclusive/></D:lockscope>'
                f"<D:depth>{lock.depth}</D:depth>"
                f"<D:timeout>Second-{remain}</D:timeout>"
                f"<D:locktoken><D:href>{lock.token}</D:href></D:locktoken>"
                f"<D:lockroot><D:href>{escape(quote(lock.path))}</D:href>"
                "</D:lockroot></D:activelock></D:lockdiscovery></D:prop>")

    async def handle_lock(self, request, path) -> web.Response:
        timeout = self._parse_timeout(request)
        depth = request.headers.get("Depth", "infinity")
        body = await request.read()
        if not body:
            # empty body = refresh of the lock named in the If header
            tokens = self._submitted_tokens(request)
            lock = self.locks.refresh(path, tokens, timeout)
            if lock is None:
                return web.Response(status=412)  # precondition failed
            return web.Response(status=200, text=self._lock_body(lock),
                                content_type="application/xml")
        lock = self.locks.acquire(path, timeout,
                                  depth_infinity=(depth != "0"))
        if lock is None:
            return web.Response(status=423)
        return web.Response(status=200, text=self._lock_body(lock),
                            content_type="application/xml",
                            headers={"Lock-Token": f"<{lock.token}>"})

    async def handle_unlock(self, request, path) -> web.Response:
        raw = request.headers.get("Lock-Token", "").strip()
        token = raw[1:-1] if raw.startswith("<") else raw
        if not token:
            return web.Response(status=400)
        ok = self.locks.release(path, token)
        if not ok:
            # RFC 4918 9.11.1: wrong token on a locked resource
            return web.Response(status=409 if self.locks.holder(path)
                                is None else 403)
        return web.Response(status=204)

    async def handle_proppatch(self, request, path) -> web.Response:
        denied = self._lock_conflict(request, path)
        if denied is not None:
            return denied
        body = ('<?xml version="1.0" encoding="utf-8"?>'
                '<D:multistatus xmlns:D="DAV:"><D:response>'
                f"<D:href>{escape(quote(path))}</D:href>"
                "<D:propstat><D:status>HTTP/1.1 200 OK</D:status>"
                "</D:propstat></D:response></D:multistatus>")
        return web.Response(status=207, text=body,
                            content_type="application/xml")


async def run_webdav(host: str, port: int, filer_url: str,
                     **kwargs) -> tuple["WebDavServer", web.AppRunner]:
    """Serve a gateway in front of `filer_url` on host:port (0 picks a
    free port) on the running loop; returns the gateway (``server.url``
    is host:port) and its runner, as run_s3 does.
    ``await runner.cleanup()`` stops it."""
    sock = http.listen_socket(host, port)
    kwargs.setdefault("url", f"{host}:{sock.getsockname()[1]}")
    server = WebDavServer(filer_url, **kwargs)
    runner = await http.start_app(server.app, sock)
    log.info("webdav on %s -> filer %s", server.url, filer_url)
    return server, runner
