"""Pub/sub message broker (weed msg.broker).

The port's copy of seaweedfs_tpu/messaging/broker.py. Mirrors
weed/messaging/broker/: topics are split into partitions; each
partition is a LogBuffer whose overflow segments persist as log files in
the filer under /topics/<namespace>/<topic>/<partition>/ (the reference
stores broker segments in SeaweedFS itself, broker/topic_manager.go:42-116).
Publish/subscribe are HTTP streams rather than gRPC bidi:

  POST /publish/{ns}/{topic}/{partition}        body: ndjson messages
  GET  /subscribe/{ns}/{topic}/{partition}?since=  ndjson replay + tail
  GET  /topics                                  list known topics
  GET  /healthz

Brokers are stateless over the filer: restart replays nothing into memory
but subscribers transparently read persisted segments first.

Multi-broker distribution (weed/messaging/broker/consistent_distribution.go,
topic_manager.go:42-116): each broker registers with the filer over the
SeaweedFiler KeepConnected gRPC stream (name "broker@host:port"); every
broker polls the registry and computes the same rendezvous-hash ownership
of each topic-partition. A request landing on a non-owner answers 307 to
the owner; when the owner dies its stream drops, the registry shrinks,
and ownership re-converges on the survivors (segments live in the filer,
so the new owner serves history transparently).

Ack levels: publish?ack=memory (default) acks once the messages are in
the owner's in-memory log (segment flush is async — a crash inside the
flush window can lose acked messages, exactly the reference's posture);
publish?ack=flush forces the segment out to the filer before acking.

With ``grpc_port`` (``run_broker``'s default: the HTTP port + 10000) the
broker also serves the SeaweedMessaging gRPC service
(messaging/broker_grpc.py). Left out (ROADMAP Queue 1 A.3): TLS on both
faces.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Optional

import aiohttp
from aiohttp import web

from .. import observe, overload
from ..server import http
from ..utils.log_buffer import LogBuffer, LogEntry

log = logging.getLogger("broker")


class TopicPartition:
    def __init__(self, ns: str, topic: str, partition: int,
                 persist: Optional["FilerSegmentStore"] = None):
        self.ns = ns
        self.topic = topic
        self.partition = partition
        self.persist = persist
        self.buffer = LogBuffer(
            flush_fn=self._flush_segment if persist else None,
            flush_bytes=1024 * 1024)

    @property
    def dir(self) -> str:
        return f"/topics/{self.ns}/{self.topic}/{self.partition:04d}"

    def _flush_segment(self, segment: list[LogEntry]) -> None:
        try:
            fut = self.persist.write_segment(self.dir, segment)
        except Exception as e:
            log.warning("segment flush %s failed: %s", self.dir, e)
            self.buffer.persisted(segment)
            return
        # readable from memory until the filer has it
        fut.add_done_callback(lambda _: self.buffer.persisted(segment))

    async def replay(self, session, since: int) -> list[LogEntry]:
        """Every entry after `since`, once each and in order: the
        memory's (unpersisted segments included) taken first, then the
        filer's segments, then what of the memory came after them. A
        segment that lands meanwhile is in both and counts once; the
        persist pool writes in order, so a listing never holds a later
        segment without an earlier one."""
        memory = self.buffer.read_since(since)
        out = []
        if self.persist is not None:
            out = await self.persist.read_segments(session, self.dir, since)
        last = max([since] + [e.ts_ns for e in out])
        return out + [e for e in memory if e.ts_ns > last]


class FilerSegmentStore:
    """Persist partition segments as ndjson files in the filer."""

    def __init__(self, filer_url: str):
        import concurrent.futures
        self.filer = filer_url.rstrip("/")
        # single-thread pool: flushes must not block the broker's event
        # loop (the filer may share it in-process) and must stay ordered
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: list = []

    def write_segment(self, dir_path: str, segment: list[LogEntry]):
        """Queue the segment's write; returns its future."""
        fut = self._pool.submit(self._write_segment_sync, dir_path, segment)
        self._pending.append(fut)
        return fut

    def _write_segment_sync(self, dir_path: str,
                            segment: list[LogEntry]) -> None:
        import urllib.request
        name = f"{segment[0].ts_ns:020d}.log"
        body = "\n".join(json.dumps(e.to_dict(), separators=(",", ":"))
                         for e in segment).encode() + b"\n"
        from ..utils import retry
        req = urllib.request.Request(
            f"http://{self.filer}{dir_path}/{name}", data=body, method="PUT",
            headers=retry.inject_deadline(
                {"Content-Type": "application/x-ndjson"}))
        urllib.request.urlopen(req, timeout=retry.cap_timeout(60)).close()

    def drain(self) -> None:
        """Block until every segment write queued so far has landed.
        Waits on a snapshot WITHOUT popping: concurrent ack=flush
        publishes each need their own segment awaited, and popping would
        let one request steal another's future and ack early."""
        for fut in list(self._pending):
            try:
                fut.result(timeout=60)
            except Exception as e:
                log.warning("segment write failed: %s", e)
        self._pending = [f for f in self._pending if not f.done()]

    async def read_segments(self, session: aiohttp.ClientSession,
                            dir_path: str, since_ns: int) -> list[LogEntry]:
        out: list[LogEntry] = []
        try:
            async with session.get(
                    f"http://{self.filer}/__meta__/list",
                    params={"dir": dir_path}) as r:
                if r.status != 200:
                    return out
                entries = (await r.json()).get("entries", [])
        except aiohttp.ClientError:
            return out
        names = sorted(
            e["path"].rsplit("/", 1)[-1] for e in entries
            # directory-ness is in the mode bits of the entry JSON
            if (int(e.get("attr", {}).get("mode", 0)) & 0o170000)
            != 0o040000)
        for name in names:
            try:
                async with session.get(
                        f"http://{self.filer}{dir_path}/{name}") as r:
                    if r.status != 200:
                        continue
                    text = await r.text()
            except aiohttp.ClientError:
                continue
            for line in text.splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    e = LogEntry.from_dict(json.loads(line))
                except Exception:
                    continue
                if e.ts_ns > since_ns:
                    out.append(e)
        return out


class BrokerServer:
    def __init__(self, filer_url: str = "", advertise_url: str = "",
                 register: bool = False, grpc_port: int = 0):
        self.persist = FilerSegmentStore(filer_url) if filer_url else None
        self.filer_url = filer_url
        self.advertise_url = advertise_url
        self.register = register and bool(filer_url and advertise_url)
        # known brokers for ownership; alone until the registry answers
        self.peer_brokers: list[str] = (
            [advertise_url] if advertise_url else [])
        self.partitions: dict[tuple[str, str, int], TopicPartition] = {}
        self.topic_configs: dict[tuple[str, str], int] = {}
        self.grpc_port = grpc_port
        self._grpc_server = None
        self._session: Optional[aiohttp.ClientSession] = None
        self._register_task: Optional[asyncio.Task] = None
        self._poll_task: Optional[asyncio.Task] = None
        self.app = self._build_app()

    def _build_app(self) -> web.Application:
        # the broker is a serving surface like the other five: meter
        # publish through the admission plane (a pub/sub client storm
        # must shed predictably, not collapse the process). Subscribe
        # streams hold their request open for hours — counting them
        # against a concurrency cap would wedge the class exactly like
        # the filer's /__meta__ streams would; the broker has no user
        # catch-all, so the route prefix can't shadow user data.
        self.admission = overload.AdmissionController(
            "broker", system_paths=frozenset({"/healthz"}),
            system_prefixes=("/subscribe/",))
        app = web.Application(
            client_max_size=64 * 1024 * 1024,
            middlewares=[overload.admission_middleware(self.admission)])
        app.router.add_post(
            "/publish/{ns}/{topic}/{partition:\\d+}", self.publish)
        app.router.add_get(
            "/subscribe/{ns}/{topic}/{partition:\\d+}", self.subscribe)
        app.router.add_get("/topics", self.topics)
        app.router.add_get("/healthz",
                           overload.healthz_handler(self.admission))
        app.on_startup.append(self._on_startup)
        app.on_cleanup.append(self._on_cleanup)
        return app

    async def _on_startup(self, app) -> None:
        await self.admission.start()
        self._session = aiohttp.ClientSession(
            # connect/inactivity bounds, no total cap: publish
            # fan-out must not hang on a dead peer, long streams ok
            timeout=aiohttp.ClientTimeout(total=None, sock_connect=10,
                                          sock_read=60),
            # peer fan-out and filer segment flushes join the ambient
            # trace like every other intra-cluster hop
            trace_configs=[observe.client_trace_config()])
        if self.grpc_port:
            from .broker_grpc import serve_messaging_grpc
            host = (self.advertise_url.rsplit(":", 1)[0]
                    if self.advertise_url else "127.0.0.1")
            self._grpc_server = await serve_messaging_grpc(
                self, host, self.grpc_port)
        if self.register:
            self._register_task = asyncio.create_task(self._register_loop())
            self._poll_task = asyncio.create_task(self._poll_brokers_loop())

    async def _on_cleanup(self, app) -> None:
        self.admission.stop()
        if self._grpc_server is not None:
            await self._grpc_server.stop(grace=0.5)
        for task in (self._register_task, self._poll_task):
            if task:
                task.cancel()
        for tp in self.partitions.values():
            tp.buffer.flush()
        if self.persist is not None:
            await asyncio.get_event_loop().run_in_executor(
                None, self.persist.drain)
        if self._session:
            await self._session.close()

    # --- membership (KeepConnected registration + registry polling) ---
    async def _register_loop(self) -> None:
        """Hold a KeepConnected stream to the filer announcing this
        broker; the filer drops us from the registry when it breaks."""
        from ..pb import filer_pb2 as fpb
        from ..pb.rpc import FilerStub, aio_dial, grpc_address
        target = grpc_address(self.filer_url)
        while True:
            try:
                async with aio_dial(target) as channel:
                    stub = FilerStub(channel)

                    async def beats():
                        while True:
                            yield fpb.KeepConnectedRequest(
                                name=f"broker@{self.advertise_url}",
                                resources=[
                                    f"{ns}/{topic}/{p}" for (ns, topic, p)
                                    in self.partitions])
                            await asyncio.sleep(1.0)

                    async for _ in stub.KeepConnected(beats()):
                        pass
            except asyncio.CancelledError:
                return
            except Exception as e:
                log.debug("broker registration retry: %s", e)
            await asyncio.sleep(1.0)

    async def _poll_brokers_loop(self) -> None:
        while True:
            try:
                async with self._session.get(
                        f"http://{self.filer_url}/__meta__/brokers",
                        timeout=aiohttp.ClientTimeout(total=5)) as r:
                    if r.status == 200:
                        brokers = (await r.json()).get("brokers", [])
                        if self.advertise_url not in brokers:
                            brokers = brokers + [self.advertise_url]
                        self.peer_brokers = sorted(brokers)
            except asyncio.CancelledError:
                return
            except Exception:
                pass
            await asyncio.sleep(1.0)

    def _owner(self, ns: str, topic: str, p: int) -> str:
        from .client import pick_broker
        if not self.peer_brokers:
            return self.advertise_url
        return pick_broker(self.peer_brokers, ns, topic, p)

    def _maybe_redirect(self, request: web.Request):
        """307 to the owning broker unless we own it (or were already
        redirected — a one-hop guard against registry disagreement)."""
        if not self.register or "redirected" in request.query:
            return None
        ns = request.match_info["ns"]
        topic = request.match_info["topic"]
        p = int(request.match_info["partition"])
        owner = self._owner(ns, topic, p)
        if owner == self.advertise_url:
            return None
        q = dict(request.query)
        q["redirected"] = "1"
        import urllib.parse as _up
        raise web.HTTPTemporaryRedirect(
            f"http://{owner}{request.path}?{_up.urlencode(q)}")

    def _partition(self, ns: str, topic: str, p: int) -> TopicPartition:
        key = (ns, topic, p)
        if key not in self.partitions:
            self.partitions[key] = TopicPartition(ns, topic, p, self.persist)
        return self.partitions[key]

    # --- handlers ---
    async def publish(self, request: web.Request) -> web.Response:
        self._maybe_redirect(request)
        tp = self._partition(request.match_info["ns"],
                             request.match_info["topic"],
                             int(request.match_info["partition"]))
        n = 0
        last_ts = 0
        async for line in request.content:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            e = LogEntry.from_dict(d)
            added = tp.buffer.add(e.key, e.value, e.headers)
            last_ts = added.ts_ns
            n += 1
        if request.query.get("ack") == "flush" and self.persist is not None:
            # durable ack: segment written to the filer before the reply
            tp.buffer.flush()
            await asyncio.get_event_loop().run_in_executor(
                None, self.persist.drain)
        return web.json_response({"published": n, "last_ts": last_ts})

    async def subscribe(self, request: web.Request) -> web.StreamResponse:
        self._maybe_redirect(request)
        tp = self._partition(request.match_info["ns"],
                             request.match_info["topic"],
                             int(request.match_info["partition"]))
        since = int(request.query.get("since", 0))
        resp = web.StreamResponse()
        resp.headers["Content-Type"] = "application/x-ndjson"
        await resp.prepare(request)

        queue: asyncio.Queue = asyncio.Queue()
        loop = asyncio.get_event_loop()

        def on_entry(e: LogEntry) -> None:
            loop.call_soon_threadsafe(queue.put_nowait, e)

        tp.buffer.subscribe(on_entry)
        try:
            last = since
            # the persisted segments and memory, then the live tail
            for e in await tp.replay(self._session, since):
                last = max(last, e.ts_ns)
                await resp.write(
                    json.dumps(e.to_dict(), separators=(",", ":"))
                    .encode() + b"\n")
            while True:
                e = await queue.get()
                if e.ts_ns <= last:
                    continue
                await resp.write(
                    json.dumps(e.to_dict(), separators=(",", ":"))
                    .encode() + b"\n")
        except (ConnectionResetError, asyncio.CancelledError):
            pass
        finally:
            tp.buffer.unsubscribe(on_entry)
        return resp

    async def topics(self, request: web.Request) -> web.Response:
        out: dict[str, list[int]] = {}
        for (ns, topic, p) in self.partitions:
            out.setdefault(f"{ns}/{topic}", []).append(p)
        return web.json_response({"topics": out,
                                  "brokers": self.peer_brokers,
                                  "url": self.advertise_url})


async def run_broker(host: str, port: int, filer_url: str = "",
                     **kwargs) -> tuple[BrokerServer, web.AppRunner]:
    """Serve a broker on host:port, registered with the filer at
    `filer_url` (when given) and its segments kept there; returns the
    broker and its runner (``await runner.cleanup()`` stops it)."""
    kwargs.setdefault("advertise_url", f"{host}:{port}")
    kwargs.setdefault("register", bool(filer_url))
    kwargs.setdefault("grpc_port", port + 10000)
    server = BrokerServer(filer_url=filer_url, **kwargs)
    runner = await http.start_app(server.app, http.listen_socket(host, port))
    log.info("msg broker on %s:%d (filer=%s)", host, port, filer_url or "-")
    return server, runner
