"""Volume server: the HTTP data path, replication, the admin API, the
heartbeat.

The port's reduced copy of seaweedfs_tpu/server/volume_server.py
(upstream weed/server/volume_server_handlers_read.go / _write.go,
weed/topology/store_replicate.go, and the admin RPCs of
volume_grpc_*.go as JSON over HTTP), an aiohttp application with the
reference's wire:

  data:   GET/HEAD/POST/PUT/DELETE /<vid>,<fid>
  admin:  POST /admin/assign_volume       (AllocateVolume)
          POST /admin/vacuum              (a whole compaction)
          GET  /admin/vacuum/check?volume_id=
          POST /admin/vacuum/compact, /commit, /cleanup
          POST /admin/volume/delete, /readonly, /mount, /unmount
          POST /admin/volume/configure_replication
          GET  /admin/volume/needle_ids?volume_id=
          GET  /admin/needle_raw?fid=      (a needle's record, for read
                                            repair)
          POST /admin/volume/copy         (VolumeCopy, pull model)
          POST /admin/tier/upload, /admin/tier/download
                                          (VolumeTierMoveDatToRemote /
                                           FromRemote)
          GET  /admin/tail?volume_id=&since_ns=
                                          (VolumeTailSender: needle
                                           records appended after since_ns,
                                           each framed by a u32 big-endian
                                           length)
          POST /admin/ec/generate, /admin/ec/fused (VolumeEcShardsGenerate)
          POST /admin/ec/mount, /unmount, /rebuild
          POST /admin/ec/copy             (VolumeEcShardsCopy, pull model)
          POST /admin/ec/delete_shards, /blob_delete, /to_volume
          POST /admin/ec/scrub            (one scrub pass now)
          GET  /admin/ec/shard_read?volume=&shard=&offset=&size=
          GET  /admin/ec/mesh_status      (the multi-card coder's state)
          GET  /admin/file_copy?volume_id=&collection=&ext=
          POST /admin/query               (Query: {"fids", "filter",
                                           "projections"} -> NDJSON)
          GET  /status, /healthz, /metrics

Writes go through a per-volume ``WriteBatcher``: up to 128 requests or
4 MB land in one engine call (small batches write on the loop, the rest
in an executor thread); with ``WEED_VOLUME_GROUP_COMMIT_US`` > 0 the
batch stays open that many microseconds and is written with one
gathered pwritev and one fsync before any of its writes is
acknowledged. Reads of needles up to 64 KiB are served on the loop when
the volume's lock is free. A read of a hosted volume that misses the
needle (a lost local write) or finds it corrupt (a CRC error) repairs it
from a replica: the needle's raw record is fetched over ``GET
/admin/needle_raw`` and appended here, behind a negative cache (10 s)
and a cap of 8 repairs at once, with the shared circuit breaker
skipping a replica that keeps refusing; the ``read_repair`` and
``read_crc_repair`` counters count them. An expired needle is never
repaired. A read of an EC volume whose shards cannot be reached answers
404, so a client goes on to another holder (upstream's read handler;
the reference answers 500, ROADMAP Queue 3, D7). A request's
``X-Seaweed-Deadline`` bounds the calls it makes.

A write to a replicated volume is stored here, then POSTed with
``?type=replicate`` to every other holder the master lists; it is
acknowledged with 201 only when every replica answered below 300, and
answers 500 otherwise (the local copy stays, as upstream's does). When
the master lists fewer holders than the volume's placement asks for,
the write is refused with 500 before anything is stored, as upstream
refuses it (the reference stores and acknowledges it). A DELETE is
propagated the same way.

Blocking Store calls run in the loop's executor threads; every call to
another server (replication, heartbeats, shard and volume copies, the
EC delete's shard lookup) is an awaited aiohttp client call, so that
many servers can share one event loop (server/local_cluster.py). The
one synchronous client is the EC read path's peer shard reader, which
runs in executor threads. The EC steps run the store's coder, the CUDA
kernel coder under "auto" (which raises on a host without a card: the
error reaches the client as an HTTP 500, never as a success). Every
handler that changes what the node holds sends its heartbeat before it
answers, so the master's view is current when the shell's next call
lands.

Every read, write and delete is sampled into a ``HeatTracker``
(lifecycle/heat.py, half-life ``WEED_LIFECYCLE_HEAT_HALFLIFE``), whose
deltas ride the heartbeat (changed volumes only; put back when the beat
fails). The EC scrubber re-digests every mounted shard against the
digest stamped into its ``.ecm`` at encode, every
``WEED_EC_SCRUB_INTERVAL`` seconds (3600; 0 disables) or on ``POST
/admin/ec/scrub``, and reports mismatches to the master's
``/ec/scrub_report``, whose repair daemon drops and rebuilds them.

The master may be an HA group: ``master_url`` is a comma list (``volume
-mserver a,b,c``). Heartbeats go to ``master_url``, the current one,
which follows the ``leader`` a reply names (a follower proxies the beat
to its leader, whose reply names itself) and moves to the next master of
the list when a beat fails (weed/server/volume_grpc_client_to_master.go:
50-86). Lookups, ``/col/lookup/ec`` and scrub reports go to the current
master too; a follower proxies them.

Before each heartbeat the server runs its storage maintenance: TTL
volumes past their grace are deleted, then the free-space watchdog seals
the volumes of a disk with less than the store's
``min_free_space_percent`` free, and lifts only its own seals when space
is back. ``/admin/vacuum/compact`` takes the reference's
``compaction_byte_per_second`` and holds the copy to that rate.

``/admin/query`` filters and projects the JSON documents of the fids it
is given (query/), in the order of the fids; a fid it cannot read is
skipped, as the reference skips it. Its reads run one after another in
one executor call, through the store, so a fid on an EC volume with
lost shards is reconstructed on the card. A read that misses a shard
asks the master for a fresh shard map only when the one it holds is
older than a second (D24).

With ``grpc_port`` the server also serves the VolumeServer gRPC service
(server/volume_grpc.py; the CLI's ``-grpc_port``, HTTP port + 10000 by
default), and a degraded read fetches each survivor interval from its
holder over ``VolumeEcShardRead`` first, through one sync channel per
peer; a peer whose gRPC port refuses or times out is read over
``/admin/ec/shard_read`` for a minute. ``ec_shard_fetch{route=}``
counts which route served. With ``use_grpc_heartbeat`` (``-grpc_heartbeat``)
the beats ride the master's gRPC Heartbeat stream; its heat deltas,
which the message cannot carry, go to ``/vol/heat/report``; a broken
stream falls back to one HTTP beat and is redialled the next pulse, and
a leader it names is redialled at once.

Left out: image resizing, read redirects, the UI, guard/JWT and gRPC
over TLS, the fastpath listener (with ``needle_sendfile_extent``) and
shard fleets.
"""

from __future__ import annotations

import asyncio
import functools
import json
import logging
import os
import time
import uuid
from typing import Optional

import aiohttp
from aiohttp import web

from .. import faults, observe
from ..ec import pipeline as ec_pipeline
from ..ec.geometry import to_ext
from ..lifecycle.heat import HeatTracker
from ..parallel import mesh_coder
from ..storage import types as t
from ..storage import volume_backup
from ..storage.file_id import FileId
from ..storage.needle import (FLAG_HAS_LAST_MODIFIED, FLAG_HAS_MIME,
                              FLAG_HAS_NAME, FLAG_HAS_TTL,
                              FLAG_IS_COMPRESSED, CrcError, Needle)
from ..storage.needle_map import remove_sidecars
from ..storage.store import Store, safe_collection
from ..storage.volume import (NeedleDeleted, NeedleExpired, NeedleNotFound,
                              Volume, VolumeCompacting, VolumeReadOnly)
from ..utils import compression, durable, multipart, retry
from ..utils import metrics as metrics_mod
from . import http

log = logging.getLogger("volume")

MAX_NEEDLE_BYTES = 32 * 1024 * 1024
# the largest request body (aiohttp's default is 1 MiB)
MAX_BODY = 256 * 1024 * 1024
COPY_CHUNK = 1 << 20


def _error(msg: str, status: int) -> web.Response:
    return web.json_response({"error": msg}, status=status)


async def _run(fn, *args):
    """A blocking call on the loop's executor threads."""
    return await asyncio.get_running_loop().run_in_executor(None, fn, *args)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class WriteBatcher:
    """Per-volume write coalescing, the server half of upstream's
    batching worker (volume_read_write.go:297-327): up to 128 requests
    or 4 MB land in one engine call, so concurrent small writes stop
    paying a thread hop each. Batches up to 256 KiB write on the loop
    (``write_needles_batch_nowait``, which declines when the volume's
    lock is taken). Group commit (``group_commit_us`` > 0, else
    ``WEED_VOLUME_GROUP_COMMIT_US``, default 0: off) holds a batch open
    that long so concurrent writes share one gathered pwritev and one
    fsync; its acks come only after that barrier. A worker exits after
    30 s without writes."""

    MAX_BATCH = 128
    MAX_BYTES = 4 * 1024 * 1024
    INLINE_BYTES = 256 * 1024
    IDLE_SECONDS = 30.0

    def __init__(self, store: Store, group_commit_us: Optional[int] = None):
        self.store = store
        self._queues: dict[int, asyncio.Queue] = {}
        self._workers: dict[int, asyncio.Task] = {}
        if group_commit_us is None:
            try:
                group_commit_us = int(os.environ.get(
                    "WEED_VOLUME_GROUP_COMMIT_US", "0") or 0)
            except ValueError:
                group_commit_us = 0
        self.group_commit_us = max(0, group_commit_us)

    async def write(self, vid: int, needle) -> tuple[int, int, bool]:
        q = self._queues.get(vid)
        if q is None:
            q = self._queues[vid] = asyncio.Queue()
            self._workers[vid] = asyncio.create_task(self._worker(vid, q))
        fut = asyncio.get_running_loop().create_future()
        q.put_nowait((needle, fut))
        result = await fut
        if isinstance(result, Exception):
            raise result
        return result

    def _retire(self, vid: int) -> None:
        self._queues.pop(vid, None)
        self._workers.pop(vid, None)

    async def _worker(self, vid: int, q: asyncio.Queue) -> None:
        loop = asyncio.get_running_loop()
        while True:
            try:
                needle, fut = await asyncio.wait_for(
                    q.get(), timeout=self.IDLE_SECONDS)
            except asyncio.TimeoutError:
                # write() puts with no await after its lookup, so an
                # empty queue here means no writer can still be headed
                # to this worker
                if q.empty():
                    self._retire(vid)
                    return
                continue
            batch = [(needle, fut)]
            size = len(needle.data)
            while (len(batch) < self.MAX_BATCH and size < self.MAX_BYTES
                   and not q.empty()):
                n2, f2 = q.get_nowait()
                batch.append((n2, f2))
                size += len(n2.data)
            if self.group_commit_us > 0:
                # hold the commit window open: what arrives before the
                # deadline rides this group's one fsync
                deadline = loop.time() + self.group_commit_us / 1e6
                while (len(batch) < self.MAX_BATCH
                       and size < self.MAX_BYTES):
                    remaining = deadline - loop.time()
                    if remaining <= 0:
                        break
                    try:
                        n2, f2 = await asyncio.wait_for(q.get(), remaining)
                    except asyncio.TimeoutError:
                        break
                    batch.append((n2, f2))
                    size += len(n2.data)
                    while (len(batch) < self.MAX_BATCH
                           and size < self.MAX_BYTES and not q.empty()):
                        n3, f3 = q.get_nowait()
                        batch.append((n3, f3))
                        size += len(n3.data)
            v = self.store.find_volume(vid)
            if v is None:
                # a deleted or unmounted volume: fail the batch, and
                # retire the worker once nothing more is queued
                err = KeyError(f"volume {vid} not found")
                for _, f in batch:
                    if not f.done():
                        f.set_exception(err)
                if q.empty():
                    self._retire(vid)
                    return
                continue
            try:
                ns = [n for n, _ in batch]
                results = None
                if self.group_commit_us > 0:
                    # the group ends in an fsync: never on the loop
                    results = await loop.run_in_executor(
                        None, functools.partial(
                            v.write_needles_batch, ns, group_commit=True))
                elif size <= self.INLINE_BYTES:
                    results = v.write_needles_batch_nowait(ns)
                if results is None:
                    results = await loop.run_in_executor(
                        None, v.write_needles_batch, ns)
            except Exception as e:
                results = [e] * len(batch)
            for (_, f), res in zip(batch, results):
                if not f.done():
                    # engine errors come back in place, one per request
                    f.set_result(res)

    async def stop(self) -> None:
        tasks = list(self._workers.values())
        for task in tasks:
            task.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)


class VolumeServer:
    # read repair: a fid whose repair found no replica is not tried
    # again for this long; at most this many repairs run at once
    _REPAIR_NEG_TTL = 10.0
    _REPAIR_MAX_INFLIGHT = 8

    def __init__(self, store: Store, master_url: str, url: str = "",
                 data_center: str = "", rack: str = "",
                 pulse_seconds: float = 5.0,
                 scrub_interval_seconds: Optional[float] = None,
                 grpc_port: int = 0,
                 use_grpc_heartbeat: bool = False,
                 master_grpc_target: str = ""):
        self.store = store
        # the VolumeServer gRPC service's port (0: none)
        self.grpc_port = grpc_port
        self._grpc_server = None
        # beats ride the master's gRPC Heartbeat stream, at the master's
        # HTTP port + 10000 unless a target is given
        self.use_grpc_heartbeat = use_grpc_heartbeat
        self.master_grpc_target = master_grpc_target
        # the degraded reads' survivor fetches: one sync channel a peer,
        # and peers whose gRPC port failed, skipped until a time
        self._peer_grpc_channels: dict = {}
        self._peer_grpc_dead: dict[str, float] = {}
        # the HA list; master_url is the current master
        self.masters = [m.strip() for m in master_url.split(",")
                        if m.strip()]
        self.master_url = self.masters[0]
        self.url = url
        self.data_center = data_center
        self.rack = rack
        self.pulse_seconds = pulse_seconds
        self.volume_size_limit = 30 * 1024 * 1024 * 1024
        self.metrics = metrics_mod.Registry("volume")
        self._replica_cache: dict[int, tuple[list[str], float]] = {}
        self._shard_loc_cache: dict[int, tuple[dict, float]] = {}
        self._session: Optional[aiohttp.ClientSession] = None
        self._hb_task: Optional[asyncio.Task] = None
        # one heartbeat at a time: a payload built before another must
        # not land after it
        self._hb_lock: Optional[asyncio.Lock] = None
        # the EC scrubber's period (WEED_EC_SCRUB_INTERVAL; 0 disables)
        if scrub_interval_seconds is None:
            scrub_interval_seconds = _env_float("WEED_EC_SCRUB_INTERVAL",
                                                3600.0)
        self.scrub_interval_seconds = scrub_interval_seconds
        self._scrub_task: Optional[asyncio.Task] = None
        # per-volume access heat, drained as deltas into heartbeats;
        # WEED_LIFECYCLE_HEAT_HALFLIFE shrinks the EWMA window so that
        # tests and aggressive un-EC policies see rate changes quickly
        halflife = _env_float("WEED_LIFECYCLE_HEAT_HALFLIFE", 0.0)
        self.heat = (HeatTracker(halflife=halflife) if halflife > 0
                     else HeatTracker())
        self._batcher: Optional[WriteBatcher] = None
        # read repair's negative cache (fid -> monotonic time of a
        # repair that found no replica) and its in-flight count
        self._repair_neg: dict[str, float] = {}
        self._repair_inflight = 0
        self.app = self._build_app()
        # the EC read path fetches missing shards from peers through this
        store._remote_shard_reader = self._make_shard_reader

    def _build_app(self) -> web.Application:
        app = web.Application(client_max_size=MAX_BODY,
                              middlewares=[http.errors_as_json])
        admin_posts = [
            ("assign_volume", self.admin_assign_volume),
            ("vacuum", self.admin_vacuum),
            ("vacuum/compact", self.admin_vacuum_compact),
            ("vacuum/commit", self.admin_vacuum_commit),
            ("vacuum/cleanup", self.admin_vacuum_cleanup),
            ("volume/delete", self.admin_volume_delete),
            ("volume/readonly", self.admin_readonly),
            ("volume/mount", self.admin_volume_mount),
            ("volume/unmount", self.admin_volume_unmount),
            ("volume/configure_replication", self.admin_volume_configure),
            ("volume/copy", self.admin_volume_copy),
            ("tier/upload", self.admin_tier_upload),
            ("tier/download", self.admin_tier_download),
            ("ec/generate", self.admin_ec_generate),
            ("ec/fused", self.admin_ec_fused),
            ("ec/mount", self.admin_ec_mount),
            ("ec/unmount", self.admin_ec_unmount),
            ("ec/rebuild", self.admin_ec_rebuild),
            ("ec/copy", self.admin_ec_copy),
            ("ec/delete_shards", self.admin_ec_delete_shards),
            ("ec/blob_delete", self.admin_ec_blob_delete),
            ("ec/to_volume", self.admin_ec_to_volume),
            ("ec/scrub", self.admin_ec_scrub),
        ]
        for path, handler in admin_posts:
            app.router.add_post(f"/admin/{path}", handler)
        app.router.add_get("/admin/vacuum/check", self.admin_vacuum_check)
        app.router.add_get("/admin/volume/needle_ids",
                           self.admin_needle_ids)
        app.router.add_get("/admin/needle_raw", self.admin_needle_raw)
        app.router.add_get("/admin/ec/shard_read", self.admin_ec_shard_read)
        app.router.add_get("/admin/ec/mesh_status",
                           self.admin_ec_mesh_status)
        app.router.add_get("/admin/file_copy", self.admin_file_copy)
        app.router.add_get("/admin/tail", self.admin_tail)
        app.router.add_post("/admin/query", self.admin_query)
        app.router.add_get("/status", self.status)
        app.router.add_get("/metrics", self.metrics_handler)
        app.router.add_get("/healthz", self.healthz)
        app.router.add_route("*", "/{fid:[^{}]*}", self.data_handler)
        app.on_startup.append(self._on_startup)
        app.on_cleanup.append(self._on_cleanup)
        return app

    async def _on_startup(self, app) -> None:
        # connect and inactivity bounds with no total cap: the fan-out
        # and heartbeats never hang on a dead peer, while volume and
        # shard copies stream as long as bytes keep flowing
        self._session = aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=None, sock_connect=10,
                                          sock_read=60))
        self._hb_lock = asyncio.Lock()
        self._batcher = WriteBatcher(self.store)
        self._hb_task = asyncio.create_task(self._heartbeat_loop())
        if self.scrub_interval_seconds > 0:
            self._scrub_task = asyncio.create_task(self._scrub_loop())
        if self.grpc_port:
            from .volume_grpc import serve_volume_grpc
            self._grpc_server = await serve_volume_grpc(
                self, self.url.rsplit(":", 1)[0], self.grpc_port)

    async def _on_cleanup(self, app) -> None:
        for ch in self._peer_grpc_channels.values():
            ch.close()
        self._peer_grpc_channels.clear()
        if self._grpc_server is not None:
            await self._grpc_server.stop(grace=0.5)
            self._grpc_server = None
        for task in (self._hb_task, self._scrub_task):
            if task is not None:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
        if self._batcher is not None:
            await self._batcher.stop()
        if self._session is not None:
            await self._session.close()
        await _run(self.store.close)

    # --- heartbeat (weed/server/volume_grpc_client_to_master.go) ---
    async def _heartbeat_loop(self) -> None:
        while True:
            try:
                await self._periodic_maintenance()
                if self.use_grpc_heartbeat:
                    # the stream carries the beats until it breaks; the
                    # HTTP beat below stands in for that round
                    await self._grpc_heartbeat_stream()
                await self.send_heartbeat()
            except Exception as e:
                log.warning("heartbeat to %s failed: %s", self.master_url,
                            e)
            await asyncio.sleep(self.pulse_seconds)

    async def _grpc_heartbeat_stream(self) -> None:
        """Hold the master's bidirectional Heartbeat stream
        (volume_grpc_client_to_master.go:50-222): a full-state beat up
        every pulse, the size limit and the leader down. Returns when the
        stream breaks, or to redial a leader it names."""
        import grpc

        from ..pb import rpc
        from .master_grpc import heartbeat_to_pb

        target = self.master_grpc_target or rpc.grpc_address(self.master_url)
        stop = asyncio.Event()

        async def beats():
            while not stop.is_set():
                await self._periodic_maintenance()
                # the message has no heat field: the deltas go to
                # /vol/heat/report right after the beat
                yield heartbeat_to_pb(self._hb_payload(include_heat=False))
                await self._report_heat()
                try:
                    await asyncio.wait_for(stop.wait(), self.pulse_seconds)
                except asyncio.TimeoutError:
                    pass

        async with rpc.aio_dial(target) as channel:
            call = rpc.MasterStub(channel).Heartbeat(beats())
            try:
                async for resp in call:
                    self.volume_size_limit = (resp.volume_size_limit
                                              or self.volume_size_limit)
                    leader = resp.leader
                    if leader and leader not in ("self", self.master_url):
                        log.info("grpc heartbeat: following leader %s",
                                 leader)
                        self.master_url = leader
                        # an explicit target named the old master; the
                        # leader is reached by the port convention
                        self.master_grpc_target = ""
                        return
            except grpc.RpcError as e:
                log.warning("grpc heartbeat to %s broke: %s", target,
                            e.code())
                self._rotate_master()
            finally:
                stop.set()

    async def _report_heat(self) -> None:
        """Deliver the heat deltas of a node whose beats ride the gRPC
        stream. A failure puts the window back and never breaks the
        stream: heat is advisory, the heartbeat is not."""
        deltas = self.heat.deltas()
        if not deltas:
            return
        try:
            async with self._session.post(
                    f"http://{self.master_url}/vol/heat/report",
                    json={"node_id": self.url, "heat": deltas},
                    timeout=aiohttp.ClientTimeout(total=5)) as r:
                if r.status != 200:
                    raise RuntimeError(f"status {r.status}")
        except asyncio.CancelledError:
            self.heat.requeue(deltas)
            raise
        except Exception as e:
            self.heat.requeue(deltas)
            log.debug("heat report to %s failed: %s", self.master_url, e)

    def _rotate_master(self) -> None:
        """The next master of the list, after a failed beat."""
        if len(self.masters) > 1:
            i = (self.masters.index(self.master_url)
                 if self.master_url in self.masters else -1)
            self.master_url = self.masters[(i + 1) % len(self.masters)]

    async def _periodic_maintenance(self) -> None:
        """TTL expiry, then the free-space watchdog: volumes on a filling
        disk seal before it is full (disk_location.go:304), so the beat
        that follows reports them read-only."""
        expired = await _run(self.store.delete_expired_volumes)
        if expired:
            log.info("deleted expired TTL volumes %s", expired)
        was_low = self.store.low_disk_space
        low = await _run(self.store.check_free_space)
        if low != was_low:
            log.warning("low disk space: %s", low)

    def _hb_payload(self, include_heat: bool = True) -> dict:
        payload = self.store.heartbeat()
        payload.update({
            "node_id": self.url,
            "url": self.url,
            "public_url": self.url,
            "data_center": self.data_center,
            "rack": self.rack,
        })
        if not include_heat:
            return payload
        # changed-volumes-only deltas: an idle node's heartbeat carries
        # no heat entries at all; draining also prunes tracker state for
        # volumes that left the node
        held = ({v["id"] for v in payload["volumes"]}
                | {s["id"] for s in payload["ec_shards"]})
        deltas = self.heat.deltas(known_vids=held)
        if deltas:
            payload["heat"] = deltas
        return payload

    async def send_heartbeat(self) -> None:
        """One beat to the current master; on a failure the next masters
        of the list are tried, once each, before it raises."""
        async with self._hb_lock:
            payload = self._hb_payload()
            try:
                for attempt in range(len(self.masters)):
                    try:
                        body = await self._post_heartbeat(payload)
                        break
                    except (aiohttp.ClientError, asyncio.TimeoutError,
                            RuntimeError, ValueError, OSError):
                        if attempt == len(self.masters) - 1:
                            raise
                        self._rotate_master()
            except BaseException:
                # the heat deltas were drained into this payload: a
                # failed delivery must not lose the window's accesses
                # (a lost last_access makes an active volume look idle)
                if payload.get("heat"):
                    self.heat.requeue(payload["heat"])
                raise
        self.volume_size_limit = body.get("volume_size_limit",
                                          self.volume_size_limit)
        # follow the leader, which owns the topology
        leader = body.get("leader", "")
        if leader and leader != self.master_url:
            log.info("heartbeat: following master leader %s", leader)
            self.master_url = leader

    async def _post_heartbeat(self, payload: dict) -> dict:
        async with self._session.post(
                f"http://{self.master_url}/heartbeat", json=payload,
                timeout=aiohttp.ClientTimeout(total=10)) as r:
            body = await r.json()
            if r.status != 200:
                raise RuntimeError(f"heartbeat to {self.master_url}: "
                                   f"HTTP {r.status} {body}")
            return body

    # --- data path ---
    async def data_handler(self, request: web.Request) -> web.Response:
        fid_str = request.match_info["fid"].lstrip("/")
        if not fid_str or "," not in fid_str:
            return _error("missing file id", 400)
        try:
            fid = FileId.parse(fid_str)
        except ValueError as e:
            return _error(str(e), 400)
        # the caller's deadline budget bounds the calls this request
        # makes (read repair's fetches)
        token = retry.bind_deadline(request.headers)
        try:
            if request.method in ("GET", "HEAD"):
                return await self._read(request, fid)
            if request.method in ("POST", "PUT"):
                return await self._write(request, fid)
            if request.method == "DELETE":
                return await self._delete(request, fid)
            return _error("method not allowed", 405)
        finally:
            retry.reset_deadline(token)

    async def _read(self, request: web.Request,
                    fid: FileId) -> web.Response:
        """GetOrHeadHandler (volume_server_handlers_read.go:28-272)."""
        self.metrics.count("read")
        vol = self.store.find_volume(fid.volume_id)
        try:
            # small needles read on the loop: a page-cache pread takes
            # microseconds, an executor hop far longer; the nowait read
            # declines (None) big needles and a taken lock
            n = (vol.read_needle_nowait(fid.key, fid.cookie)
                 if vol is not None else None)
            if n is None:
                n = await _run(self.store.read_needle, fid.volume_id,
                               fid.key, fid.cookie)
        except NeedleExpired:
            # TTL expiry is not data loss: never repaired back
            return _error("not found", 404)
        except NeedleNotFound:
            # a lost local write on a volume this server hosts: a replica
            # may still have the needle
            if (self.store.find_volume(fid.volume_id) is None
                    or not self._repair_permitted(str(fid))):
                return _error("not found", 404)
            n = await self._read_repair(fid)
            if n is None:
                return _error("not found", 404)
        except KeyError:
            # deleted, or no such volume
            return _error("not found", 404)
        except CrcError as rot:
            # on-disk corruption: serve the replica's good copy, which
            # the repair appends here (the rotten record becomes garbage)
            self.metrics.count("read_crc_repair")
            log.error("volume %d: CRC mismatch on needle %s (%s); "
                      "attempting read repair from replicas",
                      fid.volume_id, fid, rot)
            n = None
            if self._repair_permitted(str(fid)):
                n = await self._read_repair(fid)
            if n is None:
                return _error("data corruption", 500)
        except OSError as e:
            if self.store.find_ec_volume(fid.volume_id) is None:
                raise
            # an EC read whose shards cannot be reached (holders that
            # dropped them mid-decode): 404, so the client tries another
            # holder, as upstream answers (the reference answers 500,
            # ROADMAP Queue 3, D7)
            return _error(f"not found: {e}", 404)
        # one dict update per served read (EC reads, the un-EC signal,
        # land here too)
        self.heat.record_read(fid.volume_id)
        etag = f'"{n.etag()}"'
        if request.headers.get("If-None-Match") == etag:
            return web.Response(status=304)
        headers = {"ETag": etag, "Accept-Ranges": "bytes"}
        if n.has(FLAG_HAS_LAST_MODIFIED):
            headers["X-Last-Modified"] = str(n.last_modified)
        mime = (n.mime.decode("utf-8", "replace")
                if n.has(FLAG_HAS_MIME) else "application/octet-stream")
        if n.has(FLAG_HAS_NAME) and n.name:
            headers["Content-Disposition"] = (
                f'inline; filename="{n.name.decode("utf-8", "replace")}"')
        body = n.data
        if n.is_compressed:
            # gzip verbatim only to clients that accept it
            if "gzip" in request.headers.get("Accept-Encoding", ""):
                headers["Content-Encoding"] = "gzip"
            else:
                body = compression.decompress(body)
        status = 200
        rng = request.headers.get("Range")
        if rng and rng.startswith("bytes=") and \
                "Content-Encoding" not in headers:
            try:
                start_s, _, end_s = rng[6:].partition("-")
                if not start_s:
                    # suffix range: the last N bytes (RFC 7233)
                    suffix = int(end_s)
                    if suffix <= 0:
                        raise ValueError
                    start = max(0, len(body) - suffix)
                    end = len(body) - 1
                else:
                    start = int(start_s)
                    end = int(end_s) if end_s else len(body) - 1
                end = min(end, len(body) - 1)
                if start > end:
                    raise ValueError
            except ValueError:
                return web.Response(status=416)
            headers["Content-Range"] = f"bytes {start}-{end}/{len(body)}"
            body = body[start:end + 1]
            status = 206
        if request.method == "HEAD":
            headers["Content-Length"] = str(len(body))
            return web.Response(status=status, headers=headers,
                                content_type=mime)
        return web.Response(status=status, body=body, headers=headers,
                            content_type=mime)

    def _repair_permitted(self, fid_str: str) -> bool:
        """Not for a fid whose repair found no replica in the last
        ``_REPAIR_NEG_TTL`` s, nor past ``_REPAIR_MAX_INFLIGHT`` repairs
        at once: scans of bogus fids must not become replica storms."""
        now = time.monotonic()
        if len(self._repair_neg) > 4096:
            self._repair_neg = {k: v for k, v in self._repair_neg.items()
                                if now - v < self._REPAIR_NEG_TTL}
        seen = self._repair_neg.get(fid_str)
        if seen is not None and now - seen < self._REPAIR_NEG_TTL:
            return False
        return self._repair_inflight < self._REPAIR_MAX_INFLIGHT

    async def _read_repair(self, fid: FileId) -> Optional[Needle]:
        """Fetch a needle this server lost or holds corrupt from a
        replica, append it here and return it; None when no replica has
        it."""
        self._repair_inflight += 1
        try:
            with observe.span("volume.read_repair",
                              tags={"fid": str(fid)}):
                return await self._read_repair_inner(fid)
        finally:
            self._repair_inflight -= 1

    async def _read_repair_inner(self, fid: FileId) -> Optional[Needle]:
        """The reference's repair (seaweedfs_tpu/server/volume_server.py:
        859): each replica in turn over ``/admin/needle_raw``; a replica
        whose breaker is open is skipped without a dial, and connection
        failures feed the breaker."""
        breaker = retry.shared_breaker()
        for url in await self._replica_urls(fid.volume_id):
            try:
                breaker.check(url)
            except retry.BreakerOpen:
                continue
            try:
                async with self._session.get(
                        f"http://{url}/admin/needle_raw",
                        params={"fid": str(fid)},
                        headers=retry.inject_deadline({}),
                        timeout=aiohttp.ClientTimeout(
                            total=retry.cap_timeout(10.0))) as r:
                    if r.status != 200:
                        breaker.record_success(url)  # the host is alive
                        continue
                    raw = await r.read()
                breaker.record_success(url)
                v = self.store.find_volume(fid.volume_id)
                if v is None:
                    return None
                n = Needle.from_bytes(raw, v.version)
                await _run(functools.partial(v.write_needle, n,
                                             preserve_append_at_ns=True))
                log.info("read-repaired needle %s from %s", fid, url)
                self.metrics.count("read_repair")
                return n
            except Exception as e:
                if isinstance(e, (aiohttp.ClientConnectionError, OSError,
                                  asyncio.TimeoutError)):
                    breaker.record_failure(url)
                log.warning("read repair of %s from %s failed: %s", fid,
                            url, e)
        self._repair_neg[str(fid)] = time.monotonic()
        return None

    async def admin_needle_raw(self, request: web.Request) -> web.Response:
        """A needle's raw record, for a peer's read repair."""
        try:
            fid = FileId.parse(request.query["fid"])
            v = self.store.find_volume(fid.volume_id)
            if v is None:
                return _error("no volume", 404)
            n = await _run(functools.partial(v.read_needle, fid.key,
                                             cookie=fid.cookie))
            return web.Response(body=n.to_bytes(v.version),
                                content_type="application/octet-stream")
        except (NeedleNotFound, NeedleDeleted, KeyError, ValueError) as e:
            return _error(str(e), 404)

    async def _write(self, request: web.Request,
                     fid: FileId) -> web.Response:
        """PostHandler + ReplicatedWrite (volume_server_handlers_write.go:
        19, weed/topology/store_replicate.go:21-161): the needle gets the
        reference's fields (name, mime, the compression flag, ttl,
        last-modified) from the multipart part and the query."""
        self.metrics.count("write")
        n = Needle(cookie=fid.cookie, id=fid.key)
        raw_ct = request.headers.get("Content-Type", "")
        filename, ctype = "", ""
        body = await request.read()
        if raw_ct[:10].lower().startswith("multipart/"):
            part = multipart.parse_upload(body, raw_ct)
            if part is None:
                return _error("empty multipart body", 400)
            n.data = part.data
            filename = part.filename
            if filename:
                n.set_flag(FLAG_HAS_NAME)
                n.name = filename.encode()[:255]
            ctype = part.content_type
            if ctype and ctype != "application/octet-stream":
                n.set_flag(FLAG_HAS_MIME)
                n.mime = ctype.encode()[:255]
            already_gzipped = part.content_encoding == "gzip"
        else:
            n.data = body
            already_gzipped = request.headers.get("Content-Encoding",
                                                  "") == "gzip"
        # client-gzipped payloads keep the flag; compressable content is
        # gzipped when that shrinks it; ?compress=false opts out
        if already_gzipped and compression.is_gzipped(n.data):
            n.set_flag(FLAG_IS_COMPRESSED)
        elif request.query.get("compress") != "false":
            ext = os.path.splitext(filename)[1] if filename else ""
            payload, compressed = compression.maybe_compress(n.data, ext,
                                                             ctype)
            if compressed:
                n.data = payload
                n.set_flag(FLAG_IS_COMPRESSED)
        if len(n.data) > MAX_NEEDLE_BYTES:
            return _error("entry too large", 413)
        ttl_s = request.query.get("ttl", "")
        if ttl_s:
            n.set_flag(FLAG_HAS_TTL)
            n.ttl = t.TTL.parse(ttl_s)
        n.set_flag(FLAG_HAS_LAST_MODIFIED)
        n.last_modified = int(time.time())
        replicas: list[str] = []
        primary = request.query.get("type") != "replicate"
        v = self.store.find_volume(fid.volume_id)
        if primary and v is not None:
            # as upstream's GetWritableRemoteReplications
            # (store_replicate.go:163-194), and unlike the reference: a
            # write the master cannot place on every copy is refused
            # before anything is stored
            copies = v.super_block.replica_placement.copy_count()
            if copies > 1:
                replicas = await self._replica_urls(fid.volume_id)
                if len(replicas) + 1 < copies:
                    return _error(
                        f"replicating operations [{len(replicas) + 1}] "
                        f"is less than volume {fid.volume_id} "
                        f"replication copy count [{copies}]", 500)
        try:
            _, _, unchanged = await self._batcher.write(fid.volume_id, n)
        except VolumeReadOnly as e:
            return _error(str(e), 409)
        except KeyError:
            return _error("volume not found", 404)
        except ValueError as e:
            return _error(str(e), 409)
        self.heat.record_write(fid.volume_id)
        if primary and not await self._replicate(request, fid, n,
                                                 replicas):
            return _error("replication failed", 500)
        return web.json_response({
            "name": (n.name or b"").decode("utf-8", "replace"),
            "size": len(n.data), "eTag": n.etag(),
            "unchanged": unchanged}, status=201)

    async def _replicate(self, request: web.Request, fid: FileId,
                         n: Needle, replicas: list[str]) -> bool:
        """POST the stored needle to every other holder; True when each
        answered below 300 (store_replicate.go:21-161)."""
        try:
            if await faults.fire_async("volume.replicate"):
                # an injected drop skips the fan-out
                return True
        except faults.FaultError:
            return False
        if not replicas:
            return True
        # multipart, so that the name and mime survive on the replica and
        # its needle matches this one; a compressed payload carries
        # Content-Encoding so the replica flags it instead of gzipping it
        # again
        boundary = uuid.uuid4().hex
        name = (n.name.decode("utf-8", "replace")
                if n.has(FLAG_HAS_NAME) else "file")
        ctype = (n.mime.decode("utf-8", "replace")
                 if n.has(FLAG_HAS_MIME) else "application/octet-stream")
        head = (f"--{boundary}\r\n"
                f'Content-Disposition: form-data; name="file"; '
                f'filename="{name}"\r\n'
                f"Content-Type: {ctype}\r\n")
        if n.is_compressed:
            head += "Content-Encoding: gzip\r\n"
        payload = head.encode() + b"\r\n" + n.data + \
            f"\r\n--{boundary}--\r\n".encode()
        params = {"type": "replicate",
                  **{k: v for k, v in request.query.items() if k == "ttl"}}
        results = await asyncio.gather(
            *[self._session.post(
                f"http://{url}/{fid}", params=params, data=payload,
                headers={"Content-Type":
                         f"multipart/form-data; boundary={boundary}"})
              for url in replicas], return_exceptions=True)
        ok = True
        for url, res in zip(replicas, results):
            if isinstance(res, BaseException):
                log.warning("replicate %s to %s failed: %s", fid, url, res)
                ok = False
            else:
                ok = ok and res.status < 300
                res.release()
        return ok

    async def _replica_urls(self, vid: int) -> list[str]:
        """The volume's other holders, from the master's lookup, cached
        for 10 s (getWritableRemoteReplications,
        store_replicate.go:163)."""
        cached = self._replica_cache.get(vid)
        if cached and time.monotonic() - cached[1] < 10.0:
            return cached[0]
        try:
            async with self._session.get(
                    f"http://{self.master_url}/dir/lookup",
                    params={"volumeId": str(vid)}) as r:
                if r.status != 200:
                    return []
                body = await r.json()
        except (aiohttp.ClientError, asyncio.TimeoutError, ValueError):
            return []
        urls = [loc["url"] for loc in body.get("locations", [])
                if loc["url"] != self.url]
        self._replica_cache[vid] = (urls, time.monotonic())
        return urls

    async def _delete(self, request: web.Request,
                      fid: FileId) -> web.Response:
        """DeleteHandler. The needle's cookie must match, as upstream
        checks it (volume_server_handlers_write.go); the reference does
        not."""
        self.metrics.count("delete")
        propagate = request.query.get("type") != "replicate"
        ev = self.store.find_ec_volume(fid.volume_id)
        if ev is not None and self.store.find_volume(fid.volume_id) is None:
            # EC delete: local tombstone, then every other shard holder.
            # Every holder has the .ecx, so each checks the cookie, the
            # holders a delete is propagated to as well.
            try:
                n = await _run(self.store.read_needle, fid.volume_id,
                               fid.key)
            except KeyError:
                n = None  # absent or deleted: the tombstone is a no-op
            if n is not None and n.cookie != fid.cookie:
                return _error("File Random Cookie does not match.", 400)
            try:
                self.store.ec_blob_delete(fid.volume_id, fid.key)
            except KeyError:
                return _error("not found", 404)
            self.heat.record_write(fid.volume_id)
            if propagate:
                await self._propagate_ec_delete(fid)
            return web.json_response({"size": 0})
        v = self.store.find_volume(fid.volume_id)
        if v is None:
            return _error("volume not found", 404)
        cookie = await _run(v.needle_cookie, fid.key)
        if cookie is not None and cookie != fid.cookie:
            return _error("File Random Cookie does not match.", 400)
        try:
            size = await _run(self.store.delete_needle, fid.volume_id,
                              Needle(cookie=fid.cookie, id=fid.key))
        except VolumeReadOnly as e:
            return _error(str(e), 409)
        except KeyError:
            return _error("volume not found", 404)
        self.heat.record_write(fid.volume_id)
        if propagate:
            for url in await self._replica_urls(fid.volume_id):
                try:
                    async with self._session.delete(
                            f"http://{url}/{fid}",
                            params={"type": "replicate"}):
                        pass
                except (aiohttp.ClientError, asyncio.TimeoutError) as e:
                    log.warning("delete replicate to %s: %s", url, e)
        return web.json_response({"size": size})

    async def _propagate_ec_delete(self, fid: FileId) -> None:
        try:
            async with self._session.get(
                    f"http://{self.master_url}/col/lookup/ec",
                    params={"volumeId": str(fid.volume_id)}) as r:
                if r.status != 200:
                    return
                shards = (await r.json()).get("shards", {})
        except (aiohttp.ClientError, asyncio.TimeoutError, ValueError):
            return
        urls = {u for us in shards.values() for u in us if u != self.url}
        for url in sorted(urls):
            try:
                async with self._session.delete(
                        f"http://{url}/{fid}",
                        params={"type": "replicate"}):
                    pass
            except (aiohttp.ClientError, asyncio.TimeoutError) as e:
                log.warning("ec delete propagate to %s: %s", url, e)

    # --- admin ---
    async def _beat_after_change(self) -> None:
        try:
            await self.send_heartbeat()
        except (aiohttp.ClientError, asyncio.TimeoutError,
                RuntimeError, ValueError) as e:
            # the change itself succeeded; the next beat reports it
            log.warning("heartbeat after a change failed: %s", e)

    async def admin_assign_volume(self, request: web.Request
                                  ) -> web.Response:
        body = await request.json()
        try:
            await _run(self.store.add_volume, int(body["volume_id"]),
                       body.get("collection", ""),
                       body.get("replication", "000") or "000",
                       body.get("ttl", ""))
        except (ValueError, RuntimeError) as e:
            return _error(str(e), 409)
        await self._beat_after_change()
        return web.json_response({"ok": True})

    async def admin_vacuum(self, request: web.Request) -> web.Response:
        body = await request.json()
        v = self.store.find_volume(int(body["volume_id"]))
        if v is None:
            return _error("volume not found", 404)
        garbage = v.garbage_level()
        try:
            await _run(v.compact)
        except RuntimeError as e:
            return _error(str(e), 409)
        return web.json_response({"ok": True, "garbage_level": garbage})

    async def admin_vacuum_check(self, request: web.Request
                                 ) -> web.Response:
        """VacuumVolumeCheck (weed/server/volume_grpc_vacuum.go): the
        garbage ratio the master decides on."""
        try:
            garbage = self.store.vacuum_check(
                int(request.query["volume_id"]))
        except KeyError:
            return _error("volume not found", 404)
        return web.json_response({"garbage_level": garbage})

    async def admin_vacuum_compact(self, request: web.Request
                                   ) -> web.Response:
        """VacuumVolumeCompact; ``compaction_byte_per_second`` (> 0)
        holds the copy to that rate."""
        body = await request.json()
        rate = int(body.get("compaction_byte_per_second", 0) or 0)
        try:
            await _run(self.store.vacuum_compact, int(body["volume_id"]),
                       rate)
        except KeyError:
            return _error("volume not found", 404)
        except RuntimeError as e:
            return _error(str(e), 409)
        return web.json_response({"ok": True})

    async def admin_vacuum_commit(self, request: web.Request
                                  ) -> web.Response:
        body = await request.json()
        try:
            await _run(self.store.vacuum_commit, int(body["volume_id"]))
        except KeyError:
            return _error("volume not found", 404)
        except RuntimeError as e:
            return _error(str(e), 409)
        return web.json_response({"ok": True})

    async def admin_vacuum_cleanup(self, request: web.Request
                                   ) -> web.Response:
        body = await request.json()
        try:
            await _run(self.store.vacuum_cleanup, int(body["volume_id"]))
        except KeyError:
            return _error("volume not found", 404)
        return web.json_response({"ok": True})

    async def admin_volume_delete(self, request: web.Request
                                  ) -> web.Response:
        body = await request.json()
        ok = await _run(self.store.delete_volume, int(body["volume_id"]))
        await self.send_heartbeat()
        return web.json_response({"ok": ok})

    async def admin_readonly(self, request: web.Request) -> web.Response:
        """Flip a volume's write gate; answers whether it was read-only
        before, so a caller lifts only the seal it set. The flip waits
        for a write in flight, and the beat tells the master at once."""
        body = await request.json()
        vid = int(body["volume_id"])
        v = self.store.find_volume(vid)
        was = v is not None and v.read_only
        ok = await _run(self.store.mark_readonly, vid,
                        body.get("read_only", True))
        await self._beat_after_change()
        return web.json_response({"ok": ok, "was_read_only": was})

    async def admin_volume_mount(self, request: web.Request
                                 ) -> web.Response:
        """VolumeMount (weed/server/volume_grpc_admin.go)."""
        body = await request.json()
        try:
            v = await _run(self.store.mount_volume, int(body["volume_id"]),
                           body.get("collection", ""))
        except (KeyError, ValueError) as e:
            return _error(str(e), 409)
        await self.send_heartbeat()
        return web.json_response({"ok": True,
                                  "file_count": v.file_count()})

    async def admin_volume_unmount(self, request: web.Request
                                   ) -> web.Response:
        """VolumeUnmount: stop serving, keep the files."""
        body = await request.json()
        ok = await _run(self.store.unmount_volume, int(body["volume_id"]))
        await self.send_heartbeat()
        return web.json_response({"ok": ok})

    async def admin_volume_configure(self, request: web.Request
                                     ) -> web.Response:
        """VolumeConfigure: rewrite the superblock's replication."""
        body = await request.json()
        try:
            await _run(self.store.configure_replication,
                       int(body["volume_id"]), body["replication"])
        except (KeyError, ValueError) as e:
            return _error(str(e), 400)
        await self.send_heartbeat()
        return web.json_response({"ok": True})

    async def admin_needle_ids(self, request: web.Request) -> web.Response:
        """The live needle inventory (command_volume_fsck.go collects the
        same per-volume id set)."""
        try:
            vid = int(request.query["volume_id"])
            entries = await _run(self.store.needle_ids, vid)
        except KeyError as e:
            return _error(str(e), 404)
        return web.json_response({"volume_id": vid,
                                  "needles": [[k, s] for k, s in entries]})

    async def _pull(self, source: str, vid: int, collection: str,
                    ext: str, path: str) -> int:
        """Stream one file of a peer's (its /admin/file_copy) to `path`;
        returns the peer's status (the file is written only on 200)."""
        async with self._session.get(
                f"http://{source}/admin/file_copy",
                params={"volume_id": str(vid), "collection": collection,
                        "ext": ext}) as r:
            if r.status == 200:
                with open(path, "wb") as f:
                    async for chunk in r.content.iter_chunked(COPY_CHUNK):
                        f.write(chunk)
            return r.status

    async def admin_volume_copy(self, request: web.Request
                                ) -> web.Response:
        """Pull a whole volume (.dat + .idx) from a source server and
        mount it (VolumeCopy, weed/server/volume_grpc_copy.go:24-151)."""
        body = await request.json()
        vid = int(body["volume_id"])
        collection = body.get("collection", "")
        if not safe_collection(collection):
            return _error("bad collection", 400)
        source = body["source"]
        if self.store.find_volume(vid) is not None:
            return _error("volume exists", 409)
        open_locs = [loc for loc in self.store.locations
                     if len(loc.volumes) < loc.max_volume_count]
        if not open_locs:
            return _error("no free slots", 500)
        loc = min(open_locs, key=lambda loc: len(loc.volumes))
        prefix = f"{collection}_" if collection else ""
        base = os.path.join(loc.directory, f"{prefix}{vid}")
        try:
            for ext in (".dat", ".idx"):
                status = await self._pull(source, vid, collection, ext,
                                          base + ext)
                if status != 200:
                    raise IOError(f"{source} has no {vid}{ext}: {status}")
            # the pulled .idx replaced any journal here wholesale: a
            # sidecar derived from an earlier one must go with it
            remove_sidecars(base + ".idx")
            v = await _run(functools.partial(
                Volume, loc.directory, collection, vid,
                needle_map_kind=self.store.needle_map_kind))
            loc.volumes[vid] = v
        except (OSError, aiohttp.ClientError, asyncio.TimeoutError,
                ValueError) as e:
            for ext in (".dat", ".idx", ".swm", ".sdx"):
                if os.path.exists(base + ext):
                    os.remove(base + ext)
            return _error(str(e), 500)
        await self.send_heartbeat()
        return web.json_response({"ok": True,
                                  "file_count": v.file_count()})

    async def admin_tier_upload(self, request: web.Request
                                ) -> web.Response:
        """Move a volume's .dat to an object-store tier
        (VolumeTierMoveDatToRemote, volume_grpc_tier_upload.go:14)."""
        body = await request.json()
        try:
            info = await _run(functools.partial(
                self.store.tier_upload, int(body["volume_id"]),
                body["backend"]))
        except (KeyError, ValueError, VolumeCompacting) as e:
            return _error(str(e), 400)
        except OSError as e:
            # the object store failed: the volume's seal is rolled back
            return _error(str(e), 502)
        await self._beat_after_change()
        return web.json_response({"ok": True, "info": info})

    async def admin_tier_download(self, request: web.Request
                                  ) -> web.Response:
        """Bring a tiered .dat back to local disk
        (VolumeTierMoveDatFromRemote)."""
        body = await request.json()
        try:
            out = await _run(self.store.tier_download,
                             int(body["volume_id"]))
        except (KeyError, ValueError) as e:
            return _error(str(e), 400)
        await self._beat_after_change()
        return web.json_response({"ok": True, **out})

    async def admin_tail(self, request: web.Request) -> web.StreamResponse:
        """Stream the needle records appended after since_ns, each framed
        by its u32 big-endian length (VolumeTailSender,
        weed/server/volume_grpc_tail.go:16-79). Records are read one at a
        time in an executor thread, so a whole volume streams in the
        memory of one record."""
        q = request.query
        v = self.store.find_volume(int(q["volume_id"]))
        if v is None:
            return _error("volume not found", 404)
        resp = web.StreamResponse()
        resp.headers["Content-Type"] = "application/octet-stream"
        await resp.prepare(request)
        it = volume_backup.iter_needles_since(v, int(q.get("since_ns", 0)))

        def next_record() -> Optional[bytes]:
            n = next(it, None)
            return None if n is None else n.to_bytes(v.version)

        while True:
            rec = await _run(next_record)
            if rec is None:
                break
            await resp.write(len(rec).to_bytes(4, "big") + rec)
        await resp.write_eof()
        return resp

    async def admin_ec_generate(self, request: web.Request
                                ) -> web.Response:
        """One volume (volume_id) or a window (volume_ids) streamed
        through one governed operating point; ``"fused": true`` runs the
        one-pass warm-down instead."""
        body = await request.json()
        return await self._ec_generate_impl(
            body, fused=bool(body.get("fused", False)))

    async def admin_ec_fused(self, request: web.Request) -> web.Response:
        return await self._ec_generate_impl(await request.json(),
                                            fused=True)

    async def _ec_generate_impl(self, body: dict,
                                fused: bool) -> web.Response:
        vids = ([int(v) for v in body["volume_ids"]]
                if "volume_ids" in body else [int(body["volume_id"])])
        if not vids:
            return _error("empty volume_ids", 400)
        try:
            if len(vids) == 1:
                gen = (self.store.ec_fused_generate if fused
                       else self.store.ec_generate)
                shards = await _run(gen, vids[0])
                per_volume = {str(vids[0]): shards}
            else:
                gen_many = (self.store.ec_fused_generate_many if fused
                            else self.store.ec_generate_many)
                per_volume = {str(k): v for k, v in
                              (await _run(gen_many, vids)).items()}
                shards = per_volume.get(str(vids[0]), [])
        except KeyError as e:
            return _error(str(e), 404)
        except VolumeCompacting as e:
            return _error(str(e), 409)
        return web.json_response({"ok": True, "shards": shards,
                                  "fused": fused, "volumes": per_volume})

    async def admin_ec_mount(self, request: web.Request) -> web.Response:
        body = await request.json()
        try:
            mounted = await _run(
                self.store.ec_mount, int(body["volume_id"]),
                body.get("collection", ""),
                [int(s) for s in body["shard_ids"]])
        except (KeyError, FileNotFoundError) as e:
            return _error(str(e), 404)
        await self.send_heartbeat()
        return web.json_response({"ok": True, "mounted": mounted})

    async def admin_ec_unmount(self, request: web.Request) -> web.Response:
        body = await request.json()
        removed = self.store.ec_unmount(int(body["volume_id"]),
                                        [int(s) for s in body["shard_ids"]])
        await self.send_heartbeat()
        return web.json_response({"ok": True, "unmounted": removed})

    async def admin_ec_rebuild(self, request: web.Request) -> web.Response:
        body = await request.json()
        try:
            rebuilt = await _run(self.store.ec_rebuild,
                                 int(body["volume_id"]),
                                 body.get("collection", ""))
        except (KeyError, ValueError) as e:
            return _error(str(e), 409)
        return web.json_response({"ok": True, "rebuilt": rebuilt})

    async def admin_ec_copy(self, request: web.Request) -> web.Response:
        """Pull shard files from a source server (VolumeEcShardsCopy,
        volume_grpc_erasure_coding.go:104), each streamed to disk."""
        body = await request.json()
        vid = int(body["volume_id"])
        collection = body.get("collection", "")
        if not safe_collection(collection):
            return _error("bad collection", 400)
        source = body["source"]
        shard_ids = [int(s) for s in body["shard_ids"]]
        exts = [to_ext(s) for s in shard_ids]
        if body.get("copy_ecx_file", False):
            exts += [".ecx", ".ecj", ".ecm"]
        prefix = f"{collection}_" if collection else ""
        base = os.path.join(self.store.locations[0].directory,
                            f"{prefix}{vid}")
        try:
            for ext in exts:
                status = await self._pull(source, vid, collection, ext,
                                          base + ext)
                if status == 404 and ext in (".ecj", ".ecm"):
                    continue  # the delete journal and marker are optional
                if status != 200:
                    return _error(f"copy {ext} from {source}: {status}",
                                  502)
            await self._take_stamps(source, vid, collection, base,
                                    shard_ids)
        except (aiohttp.ClientError, asyncio.TimeoutError) as e:
            return _error(str(e), 502)
        return web.json_response({"ok": True})

    async def _take_stamps(self, source: str, vid: int, collection: str,
                           base: str, shard_ids: list[int]) -> None:
        """Make the copied shards' digest stamps travel with them: a
        copied shard whose id the local ``.ecm`` does not stamp takes the
        source's stamp, and a target with no ``.ecm`` takes the source's
        whole. Without a stamp the scrubber would skip the shard, so a
        rotten copy would never be found. A source with no marker (an
        unstamped volume) leaves nothing to take."""
        path = base + ".ecm"
        stamped = ec_pipeline.read_stamped_digests(base)
        if os.path.exists(path) and all(s in stamped for s in shard_ids):
            return
        tmp = path + ".src"
        try:
            if await self._pull(source, vid, collection, ".ecm",
                                tmp) != 200:
                return
            if not os.path.exists(path):
                durable.replace_atomic(tmp, path)
                return
            with open(tmp) as f:
                theirs = json.load(f).get("shard_digests") or {}
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        with open(path) as f:
            meta = json.load(f)
        digests = dict(meta.get("shard_digests") or {})
        for sid in shard_ids:
            if str(sid) not in digests and str(sid) in theirs:
                digests[str(sid)] = theirs[str(sid)]
        meta["shard_digests"] = {k: digests[k]
                                 for k in sorted(digests, key=int)}
        durable.write_json_atomic(path, meta)

    async def admin_ec_delete_shards(self, request: web.Request
                                     ) -> web.Response:
        body = await request.json()
        await _run(self.store.ec_delete_shards, int(body["volume_id"]),
                   body.get("collection", ""),
                   [int(s) for s in body["shard_ids"]])
        await self.send_heartbeat()
        return web.json_response({"ok": True})

    async def admin_ec_blob_delete(self, request: web.Request
                                   ) -> web.Response:
        body = await request.json()
        try:
            self.store.ec_blob_delete(int(body["volume_id"]),
                                      int(body["needle_id"]))
        except KeyError as e:
            return _error(str(e), 404)
        return web.json_response({"ok": True})

    async def admin_ec_to_volume(self, request: web.Request
                                 ) -> web.Response:
        body = await request.json()
        try:
            await _run(self.store.ec_to_volume, int(body["volume_id"]),
                       body.get("collection", ""))
        except (KeyError, FileNotFoundError) as e:
            return _error(str(e), 404)
        await self.send_heartbeat()
        return web.json_response({"ok": True})

    # --- the EC scrubber: bit rot -> report -> the master's repair ---
    async def _scrub_loop(self) -> None:
        while True:
            await asyncio.sleep(self.scrub_interval_seconds)
            try:
                await self.scrub_pass()
            except asyncio.CancelledError:
                raise
            except Exception:
                # the scrubber must outlive any one pass (a malformed
                # stamp, a shard dropped under it, a master away)
                log.warning("ec scrub pass failed", exc_info=True)

    async def scrub_pass(self, throttle_seconds: float = 0.05) -> dict:
        """Verify every locally mounted EC shard against the digest
        stamped into its .ecm at encode (ec/pipeline.py). Each shard
        digests in an executor thread and the loop sleeps between
        shards, so serving traffic is not starved. Mismatches are
        reported to the master, whose repair daemon drops the rotten
        copy and rebuilds it. Each shard verified counts in
        ``scrub_shards_checked``; a volume with no stamps is skipped and
        counts nothing. Returns {vid: [bad shard ids]}."""
        bad_by_vid: dict[int, list[int]] = {}
        with observe.span("volume.scrub"):
            for loc in self.store.locations:
                for vid, ev in list(loc.ec_volumes.items()):
                    base = ev.base_file_name()
                    stamped = ec_pipeline.read_stamped_digests(base)
                    if not stamped:
                        continue
                    bad: list[int] = []
                    for sid in ev.shard_ids():
                        want = stamped.get(sid)
                        if want is None:
                            continue
                        try:
                            got = int((await _run(
                                ec_pipeline.shard_file_digest, base,
                                [sid]))[0])
                        except OSError:
                            continue  # unmounted or moved mid-scan
                        self.metrics.count("scrub_shards_checked")
                        if got != want:
                            bad.append(sid)
                            self.metrics.count("scrub_shards_bad")
                            log.warning("scrub: shard %d of volume %d "
                                        "digest mismatch (%d != %d)",
                                        sid, vid, got, want)
                        await asyncio.sleep(throttle_seconds)
                    if bad:
                        bad_by_vid[vid] = bad
        for vid, bad in bad_by_vid.items():
            await self._report_bad_shards(vid, bad)
        return bad_by_vid

    async def _report_bad_shards(self, vid: int, bad: list[int]) -> None:
        try:
            async with self._session.post(
                    f"http://{self.master_url}/ec/scrub_report",
                    json={"volume_id": vid, "url": self.url,
                          "bad_shards": bad},
                    timeout=aiohttp.ClientTimeout(total=10)) as r:
                await r.read()
        except (aiohttp.ClientError, asyncio.TimeoutError) as e:
            log.warning("scrub report for volume %d failed: %s", vid, e)

    async def admin_ec_mesh_status(self,
                                   request: web.Request) -> web.Response:
        """This process's multi-card view: the requested
        WEED_EC_MESH_DEVICES, the cards, and the per-chip staging
        counters and governor gauges of the shared "ec" registry (the
        JSON twin of /metrics for the ec.mesh.status shell command)."""
        return web.json_response(await _run(mesh_coder.mesh_status))

    async def admin_ec_scrub(self, request: web.Request) -> web.Response:
        """Run one scrub pass now (operators, tests)."""
        body = {}
        if request.can_read_body:
            try:
                body = await request.json()
            except ValueError:
                body = {}
        bad = await self.scrub_pass(
            throttle_seconds=float(body.get("throttle_seconds", 0.0)))
        return web.json_response(
            {"ok": True,
             "bad": {str(vid): sids for vid, sids in bad.items()}})

    async def admin_ec_shard_read(self, request: web.Request
                                  ) -> web.Response:
        q = request.query
        try:
            data = self.store.ec_shard_read(
                int(q["volume"]), int(q["shard"]), int(q.get("offset", 0)),
                int(q["size"]))
        except KeyError as e:
            return _error(str(e), 404)
        return web.Response(body=data,
                            content_type="application/octet-stream")

    async def admin_file_copy(self, request: web.Request
                              ) -> web.StreamResponse:
        """Stream a volume or shard file to a pulling peer (CopyFile,
        weed/server/volume_grpc_copy.go:24-281)."""
        q = request.query
        vid = int(q["volume_id"])
        collection = q.get("collection", "")
        ext = q["ext"]
        if not ext.startswith(".") or "/" in ext or ".." in ext \
                or not safe_collection(collection):
            return _error("bad ext or collection", 400)
        prefix = f"{collection}_" if collection else ""
        for loc in self.store.locations:
            path = os.path.join(loc.directory, f"{prefix}{vid}{ext}")
            if os.path.exists(path):
                resp = web.StreamResponse()
                resp.headers["Content-Length"] = str(os.path.getsize(path))
                await resp.prepare(request)
                with open(path, "rb") as f:
                    while True:
                        chunk = f.read(COPY_CHUNK)
                        if not chunk:
                            break
                        await resp.write(chunk)
                await resp.write_eof()
                return resp
        return _error("file not found", 404)

    # shard-location freshness tiers (store_ec.go:221-262): a missing
    # shard re-polls the master after 11 s, a known one after 7 min; a
    # total read miss forces a refresh of a map older than 1 s
    _SHARD_LOC_MISSING_TTL = 11.0
    # a read miss forces a refresh only of a map older than this (D24)
    _SHARD_LOC_FORCE_FLOOR = 1.0
    _SHARD_LOC_KNOWN_TTL = 7 * 60.0
    # with no map yet, a master between leaders (503) is waited out for
    # up to this long, polled this often, not taken for a lost shard
    # (D28)
    _SHARD_LOC_ELECTION_WAIT = 5.0
    _SHARD_LOC_ELECTION_POLL = 0.1

    def _shard_locations(self, vid: int, shard_id: int,
                         force: bool = False) -> list[str]:
        """Tiered-TTL cache of vid -> shard -> holder urls (called from
        executor threads)."""
        now = time.monotonic()
        cached = self._shard_loc_cache.get(vid)
        if cached is not None and not force:
            shards, fetched = cached
            age = now - fetched
            if age < self._SHARD_LOC_MISSING_TTL or \
                    (str(shard_id) in shards
                     and age < self._SHARD_LOC_KNOWN_TTL):
                return [u for u in shards.get(str(shard_id), [])
                        if u != self.url]
        try:
            deadline = now + self._SHARD_LOC_ELECTION_WAIT
            while True:
                status, body = http.get_json(
                    f"http://{self.master_url}/col/lookup/ec?volumeId={vid}",
                    timeout=5)
                if status != 503 or cached is not None or \
                        time.monotonic() >= deadline:
                    break
                time.sleep(self._SHARD_LOC_ELECTION_POLL)
            if status != 200:
                # a master between leaders answers 503: keep the last
                # map, as a failed lookup does (D21)
                raise ValueError(f"HTTP {status}")
            shards = body.get("shards", {})
            self._shard_loc_cache[vid] = (shards, now)
        except (OSError, ValueError) as e:
            log.warning("ec shard lookup for %d failed: %s", vid, e)
            shards = cached[0] if cached else {}
        return [u for u in shards.get(str(shard_id), []) if u != self.url]

    # a peer whose gRPC port refused or timed out is fetched from over
    # HTTP for this long
    _PEER_GRPC_DEAD_S = 60.0

    def _fetch_shard_grpc(self, url: str, vid: int, shard_id: int,
                          offset: int, size: int) -> Optional[bytes]:
        """One interval over the peer's VolumeEcShardRead stream
        (volume_grpc_erasure_coding.go:270-328), on a sync channel kept
        per peer; None when the peer cannot serve it."""
        if time.time() < self._peer_grpc_dead.get(url, 0):
            return None
        import grpc

        from ..pb import rpc
        from ..pb import volume_server_pb2 as vpb
        try:
            ch = self._peer_grpc_channels.get(url)
            if ch is None:
                # setdefault: racing executor threads keep one channel
                new = rpc.dial(rpc.grpc_address(url))
                ch = self._peer_grpc_channels.setdefault(url, new)
                if ch is not new:
                    new.close()
            buf = bytearray()
            for chunk in rpc.VolumeServerStub(ch).VolumeEcShardRead(
                    vpb.EcShardReadRequest(volume_id=vid, shard_id=shard_id,
                                           offset=offset, size=size),
                    timeout=5):
                if chunk.error:
                    return None
                buf += chunk.data
                if chunk.is_last:
                    break
            return bytes(buf) if len(buf) == size else None
        except grpc.RpcError as e:
            if e.code() in (grpc.StatusCode.UNAVAILABLE,
                            grpc.StatusCode.DEADLINE_EXCEEDED):
                self._peer_grpc_dead[url] = (time.time()
                                             + self._PEER_GRPC_DEAD_S)
            return None

    def _make_shard_reader(self, ev):
        """Reader of non-local shard intervals for the EC read path
        (store_ec.go:282-320): over the holder's VolumeEcShardRead gRPC
        stream first, then its /admin/ec/shard_read (a peer without a
        gRPC port, or one whose stream failed). Each served fetch counts
        in ``ec_shard_fetch{route="grpc"|"http"}``. Synchronous: it runs
        in the executor threads of the EC read. A total miss refreshes
        the location cache once, so reads survive shard moves and lost
        servers."""

        def fetch(url: str, shard_id: int, offset: int,
                  size: int) -> Optional[bytes]:
            data = self._fetch_shard_grpc(url, ev.vid, shard_id, offset,
                                          size)
            if data is not None:
                self.metrics.count("ec_shard_fetch",
                                   labels={"route": "grpc"})
                return data
            try:
                r = http.request(
                    "GET", f"http://{url}/admin/ec/shard_read?volume="
                    f"{ev.vid}&shard={shard_id}&offset={offset}"
                    f"&size={size}", timeout=10)
            except OSError:
                return None
            if r.status != 200 or len(r.data) != size:
                return None
            self.metrics.count("ec_shard_fetch", labels={"route": "http"})
            return r.data

        def read(shard_id: int, offset: int, size: int) -> Optional[bytes]:
            for force in (False, True):
                urls = self._shard_locations(ev.vid, shard_id, force=force)
                for url in urls:
                    data = fetch(url, shard_id, offset, size)
                    if data is not None:
                        return data
                if not force and not urls and not self._refresh_due(
                        ev.vid):
                    # a map younger than the floor names no holder of
                    # this shard: it is lost, not moved (D24)
                    break
            return None

        return read

    def _refresh_due(self, vid: int) -> bool:
        """Whether a miss on a shard that `vid`'s map names no holder of
        may force a fresh lookup: not while the map is younger than
        _SHARD_LOC_FORCE_FLOOR. With shards lost, every degraded read
        tries each lost shard, and the reference asks the master again on
        every miss (four lookups a reconstruction with four shards lost).
        A holder the map names that fails its fetch still forces a fresh
        lookup and a second try, as in the reference."""
        cached = self._shard_loc_cache.get(vid)
        return cached is None or \
            time.monotonic() - cached[1] >= self._SHARD_LOC_FORCE_FLOOR

    async def admin_query(self, request: web.Request) -> web.StreamResponse:
        """S3-Select-lite over needle payloads (Query,
        weed/server/volume_grpc_query.go:13-69): filter + project JSON
        documents named by fid, emitting NDJSON."""
        from ..query import QueryFilter, query_json_lines
        body = await request.json()
        flt = None
        if body.get("filter"):
            f = body["filter"]
            flt = QueryFilter(f["field"], f.get("op", "="), f.get("value"))
        projections = body.get("projections") or None
        payloads = await _run(self.read_query_payloads,
                              body.get("fids", []))
        resp = web.StreamResponse()
        resp.headers["Content-Type"] = "application/x-ndjson"
        await resp.prepare(request)
        for line in query_json_lines(payloads, flt, projections):
            await resp.write(line.encode() + b"\n")
        await resp.write_eof()
        return resp

    def read_query_payloads(self, fids: list[str]) -> list[bytes]:
        """The payloads of a query's fids, read one after another (one
        executor call for all: the reference reads them on its loop; a
        fan-out over the shared executor starved the heartbeats); a fid
        that cannot be read is skipped."""
        payloads = []
        for fid_str in fids:
            try:
                fid = FileId.parse(fid_str)
                n = self.store.read_needle(fid.volume_id, fid.key,
                                           cookie=fid.cookie)
                payloads.append(n.data)
            except Exception:
                continue
        return payloads

    async def status(self, request: web.Request) -> web.Response:
        return web.json_response({"url": self.url, **self.store.status()})

    async def healthz(self, request: web.Request) -> web.Response:
        return web.json_response({"ok": True})

    async def metrics_handler(self, request: web.Request) -> web.Response:
        return web.Response(
            text=self.metrics.render() + metrics_mod.render_shared(),
            content_type="text/plain")


async def run_volume_server(host: str, port: int, store: Store,
                            master_url: str, sock=None, **kwargs
                            ) -> tuple[VolumeServer, web.AppRunner]:
    """Serve a volume server on host:port (0 picks a free port), or on
    `sock`, a socket bound already, on the running loop, its heartbeat
    loop started; returns the volume server (``vs.url`` is host:port)
    and its runner. ``await
    runner.cleanup()`` stops it: the listener, kept connections, the
    heartbeat, and the store."""
    if sock is None:
        sock = http.listen_socket(host, port)
    vs = VolumeServer(store, master_url,
                      url=f"{host}:{sock.getsockname()[1]}", **kwargs)
    runner = await http.start_app(vs.app, sock)
    log.info("volume server on %s -> master %s", vs.url, master_url)
    return vs, runner
