"""Pooled keep-alive HTTP for the sync intra-cluster clients.

urllib.request opens a fresh TCP connection per call and closes it on
exit — on the hot GET path that is a 3-way handshake plus slow-start per
chunk fetch. The reference keeps one shared keep-alive transport for all
intra-cluster HTTP (weed/util/http_util.go's global client); this is
that shape for the sync callers (client.py, mount, EC shard fallback):
a bounded per-host stack of live ``http.client.HTTPConnection``s, reused
across requests, with one transparent retry when a pooled connection
turns out to have gone stale (server closed it between requests).

Responses are read fully before the connection returns to the pool —
callers get a ``PoolResponse`` (status/headers/data), never a live
socket, so a forgotten response can't poison the pool. Streaming
endpoints (watch/subscribe/tail) stay on urllib by design.

The port's copy of seaweedfs_tpu/cache/http_pool.py. Left out: the trace
context (``observe.inject``), which the port's ``observe`` does not
propagate yet (ROADMAP A.9); the priority class (``overload.inject``)
and the deadline budget ride along as in the reference. In the port the
mount uses the pool; the client and the filer keep their own
connections until A.9.
"""

from __future__ import annotations

import http.client
import threading
import time
import urllib.parse
from typing import Optional

_RETRYABLE = (http.client.BadStatusLine, http.client.CannotSendRequest,
              http.client.ImproperConnectionState, BrokenPipeError,
              ConnectionResetError, ConnectionAbortedError)

# only these methods ride pooled connections: a stale keep-alive socket
# can die after the server processed the request, and transparently
# re-sending a POST/DELETE would execute the write twice. Non-idempotent
# methods always dial fresh (exactly the old urllib behavior) — their
# response connection still joins the pool for the read path to reuse.
_POOLED_METHODS = frozenset({"GET", "HEAD", "OPTIONS"})


class PoolResponse:
    __slots__ = ("status", "headers", "data")

    def __init__(self, status: int, headers: dict, data: bytes):
        self.status = status
        self.headers = headers  # lower-cased header names
        self.data = data

    def json(self):
        import json
        return json.loads(self.data)


class StreamResponse:
    """A live streaming response from :meth:`HttpPool.stream` — iterate
    for raw lines, close when done (a context manager for both)."""

    def __init__(self, conn, resp):
        self._conn = conn
        self.resp = resp
        self.status = resp.status
        self.headers = {k.lower(): v for k, v in resp.getheaders()}

    def __iter__(self):
        return iter(self.resp)

    def readline(self) -> bytes:
        return self.resp.readline()

    def close(self) -> None:
        try:
            self.resp.close()
        finally:
            self._conn.close()

    def __enter__(self) -> "StreamResponse":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class HttpPool:
    def __init__(self, max_idle_per_host: int = 8,
                 timeout: float = 30.0, metrics=None, breaker=None,
                 shed_retries: int = 1):
        self.max_idle_per_host = max_idle_per_host
        self.default_timeout = timeout
        self.metrics = metrics
        # how many times one request() call backs off and re-sends after
        # a shed (X-Seaweed-Shed) 429/503 — the cooperative-client half
        # of the overload plane; a shed answer means the server refused
        # the request BEFORE doing any work, so even non-idempotent
        # methods are safe to re-send
        self.shed_retries = max(0, shed_retries)
        # per-host circuit breaker (utils/retry.py): a peer that failed
        # failure_threshold dials in a row fails fast — BreakerOpen is a
        # ConnectionError, so replica/master rotation handles it like any
        # refused dial, just without paying the connect timeout
        self.breaker = breaker
        self._lock = threading.Lock()
        self._idle: dict[tuple[str, int], list] = {}
        self._closed = False

    def _count(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.count(f"http_pool_{name}")

    def _checkout(self, host: str, port: int, timeout: float):
        """(connection, was_reused)"""
        with self._lock:
            stack = self._idle.get((host, port))
            if stack:
                conn = stack.pop()
                conn.timeout = timeout
                if conn.sock is not None:
                    conn.sock.settimeout(timeout)
                self._count("reuse")
                return conn, True
        self._count("dial")
        return http.client.HTTPConnection(host, port, timeout=timeout), False

    def _checkin(self, host: str, port: int, conn) -> None:
        with self._lock:
            if not self._closed:
                stack = self._idle.setdefault((host, port), [])
                if len(stack) < self.max_idle_per_host:
                    stack.append(conn)
                    return
        conn.close()

    def _flush_host(self, host: str, port: int) -> None:
        """Drop every idle connection to one host — when a pooled socket
        turns out stale (server restarted), its siblings in the stack
        are from the same dead server; the retry must dial fresh, not
        draw the next corpse."""
        with self._lock:
            stale = self._idle.pop((host, port), [])
        for c in stale:
            c.close()

    def request(self, method: str, url: str,
                body: Optional[bytes] = None,
                headers: Optional[dict] = None,
                timeout: Optional[float] = None,
                idempotent: bool = False) -> PoolResponse:
        """One full request/response. `url` may carry or omit the
        http:// scheme; HTTP error statuses are returned, not raised.

        ``idempotent=True`` lets a non-GET ride pooled keep-alive
        connections (and the transparent stale-socket retry): the
        caller asserts that re-executing the request is safe — the
        metaring mirror/proxy upserts are exactly this shape, and
        dialing a fresh TCP connection per mirrored create was the
        dominant cost of ring writes.

        A shed 429/503 (``X-Seaweed-Shed: 1``) is honored, not fought:
        sleep the server's ``Retry-After`` (bounded by the remaining
        deadline budget) and re-send, up to ``shed_retries`` times.  A
        still-shed response after that is returned to the caller."""
        if "://" not in url:
            url = "http://" + url
        parts = urllib.parse.urlsplit(url)
        host, port = parts.hostname or "", parts.port or 80
        path = parts.path or "/"
        if parts.query:
            path += "?" + parts.query
        base_timeout = self.default_timeout if timeout is None else timeout
        from ..utils import retry as retry_mod
        shed_left = self.shed_retries
        while True:
            resp = self._request_once(method, host, port, path, body,
                                      headers, base_timeout,
                                      idempotent=idempotent)
            if shed_left <= 0 or not retry_mod.is_shed(resp.status,
                                                       resp.headers):
                return resp
            delay = retry_mod.parse_retry_after(
                resp.headers.get("retry-after"))
            delay = min(delay if delay is not None else 0.25, 5.0)
            left = retry_mod.remaining_budget()
            if left is not None and left <= delay:
                # not enough budget to be polite: hand the shed up so
                # the caller's own policy (rotation, error) decides
                return resp
            if base_timeout is not None and delay >= base_timeout:
                # same when the caller's own per-request timeout is
                # tighter than the server's requested pause: a caller
                # expecting a verdict in 0.5s must not block 5s here
                return resp
            self._count("shed_backoff")
            shed_left -= 1
            time.sleep(delay)

    def _request_once(self, method: str, host: str, port: int, path: str,
                      body: Optional[bytes],
                      headers: Optional[dict],
                      timeout: Optional[float],
                      idempotent: bool = False) -> PoolResponse:
        hdrs = dict(headers or {})
        from .. import faults, overload
        from ..utils import retry as retry_mod
        # the ambient priority class rides along like the trace id, so
        # background daemons' fetches shed first at the receiver
        overload.inject(hdrs)
        # propagate the caller's remaining deadline budget and never wait
        # on the socket longer than it (utils/retry.py); raises
        # DeadlineExceeded when the budget is already gone
        retry_mod.inject_deadline(hdrs)
        timeout = retry_mod.cap_timeout(timeout)
        hostkey = f"{host}:{port}"
        breaker = self.breaker
        if breaker is not None:
            breaker.check(hostkey)  # fail fast on an open host
        try:
            dropped = faults.fire("http_pool.request")
        except faults.FaultError:
            # injected error counts as a host failure so chaos tests can
            # drive the breaker through its whole open/half-open cycle
            if breaker is not None:
                breaker.record_failure(hostkey)
            raise
        if dropped:
            # injected wire-level drop: indistinguishable from a peer
            # that vanished mid-request
            if breaker is not None:
                breaker.record_failure(hostkey)
            raise ConnectionResetError(
                f"injected drop for {hostkey}")
        poolable = idempotent or method.upper() in _POOLED_METHODS
        last: Optional[Exception] = None
        for attempt in range(2):
            if poolable:
                conn, reused = self._checkout(host, port, timeout)
            else:
                self._count("dial")
                conn, reused = http.client.HTTPConnection(
                    host, port, timeout=timeout), False
            try:
                conn.request(method, path, body=body, headers=hdrs)
                resp = conn.getresponse()
                data = resp.read()
            except _RETRYABLE as e:
                conn.close()
                last = e
                if reused:
                    # stale keep-alive connection: its idle siblings are
                    # just as dead — flush them so the retry dials fresh
                    self._flush_host(host, port)
                    continue
                if breaker is not None:
                    breaker.record_failure(hostkey)
                raise
            except Exception as e:
                conn.close()
                # record any wire-level failure class (OSError AND
                # http.client exceptions like IncompleteRead) so a
                # half-open probe ending here always reports back
                if breaker is not None and isinstance(
                        e, (OSError, http.client.HTTPException)):
                    breaker.record_failure(hostkey)
                raise
            if resp.will_close:
                conn.close()
            else:
                self._checkin(host, port, conn)
            if breaker is not None:
                breaker.record_success(hostkey)
            return PoolResponse(
                resp.status,
                {k.lower(): v for k, v in resp.getheaders()},
                faults.corrupt("http_pool.response", data))
        # both attempts hit a stale/broken connection: the host itself is
        # suspect, not just one idle socket
        if breaker is not None:
            breaker.record_failure(hostkey)
        raise last

    def stream(self, method: str, url: str,
               headers: Optional[dict] = None,
               connect_timeout: float = 10.0,
               read_timeout: float = 300.0) -> "StreamResponse":
        """A streaming request (watch/subscribe/tail): the response
        body is consumed incrementally by the caller, line by line.

        Unlike :meth:`request`, the connection is DEDICATED — it never
        joins the pool (a half-read stream would poison it) and the
        caller must ``close()`` (or exhaust) the response.  What the
        caller does get is the rest of the intra-cluster client
        discipline that bare ``urllib.request.urlopen(url,
        timeout=None)`` lacked: priority/deadline header
        injection, breaker gating + failure accounting for the host,
        the http_pool.request fault point, and a BOUNDED socket — the
        dial pays ``connect_timeout`` and each read at most
        ``read_timeout`` of idle, so a wedged peer surfaces as an
        exception the caller's reconnect loop handles instead of a
        socket parked forever."""
        if "://" not in url:
            url = "http://" + url
        parts = urllib.parse.urlsplit(url)
        host, port = parts.hostname or "", parts.port or 80
        path = parts.path or "/"
        if parts.query:
            path += "?" + parts.query
        hdrs = dict(headers or {})
        from .. import faults, overload
        from ..utils import retry as retry_mod
        overload.inject(hdrs)
        retry_mod.inject_deadline(hdrs)
        hostkey = f"{host}:{port}"
        breaker = self.breaker
        if breaker is not None:
            breaker.check(hostkey)
        try:
            dropped = faults.fire("http_pool.request")
        except faults.FaultError:
            if breaker is not None:
                breaker.record_failure(hostkey)
            raise
        if dropped:
            if breaker is not None:
                breaker.record_failure(hostkey)
            raise ConnectionResetError(f"injected drop for {hostkey}")
        conn = http.client.HTTPConnection(
            host, port, timeout=retry_mod.cap_timeout(connect_timeout))
        try:
            conn.request(method, path, headers=hdrs)
            resp = conn.getresponse()
        except Exception as e:
            conn.close()
            if breaker is not None and isinstance(
                    e, (OSError, http.client.HTTPException)):
                breaker.record_failure(hostkey)
            raise
        if breaker is not None:
            breaker.record_success(hostkey)
        # connected: reads are idle-bounded from here on
        if conn.sock is not None:
            conn.sock.settimeout(read_timeout)
        return StreamResponse(conn, resp)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            conns = [c for stack in self._idle.values() for c in stack]
            self._idle.clear()
        for c in conns:
            c.close()

    def idle_count(self) -> int:
        with self._lock:
            return sum(len(s) for s in self._idle.values())


_shared: Optional[HttpPool] = None
_shared_lock = threading.Lock()


def shared_pool() -> HttpPool:
    """Process-wide pool (the reference's global http client), breaker
    included — dead-peer evidence is shared by every sync caller."""
    global _shared
    with _shared_lock:
        if _shared is None:
            from ..utils.retry import shared_breaker
            _shared = HttpPool(breaker=shared_breaker())
        return _shared
