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
          POST /admin/volume/copy         (VolumeCopy, pull model)
          POST /admin/ec/generate, /admin/ec/fused (VolumeEcShardsGenerate)
          POST /admin/ec/mount, /unmount, /rebuild
          POST /admin/ec/copy             (VolumeEcShardsCopy, pull model)
          POST /admin/ec/delete_shards, /blob_delete, /to_volume
          POST /admin/ec/scrub            (one scrub pass now)
          GET  /admin/ec/shard_read?volume=&shard=&offset=&size=
          GET  /admin/ec/mesh_status      (the multi-card coder's state)
          GET  /admin/file_copy?volume_id=&collection=&ext=
          GET  /status, /healthz, /metrics

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

Left out: the write batcher and group commit, image resizing, read
repair, tiering, tail, query, batch delete, the UI, guard/JWT, the
fastpath listener and its heat side channel, shard fleets and gRPC.
"""

from __future__ import annotations

import asyncio
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
from ..storage.file_id import FileId
from ..storage.needle import (FLAG_HAS_LAST_MODIFIED, FLAG_HAS_MIME,
                              FLAG_HAS_NAME, FLAG_HAS_TTL,
                              FLAG_IS_COMPRESSED, CrcError, Needle)
from ..storage.store import Store, safe_collection
from ..storage.volume import Volume, VolumeCompacting, VolumeReadOnly
from ..utils import compression, durable, multipart
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


class VolumeServer:
    def __init__(self, store: Store, master_url: str, url: str = "",
                 data_center: str = "", rack: str = "",
                 pulse_seconds: float = 5.0,
                 scrub_interval_seconds: Optional[float] = None):
        self.store = store
        self.master_url = master_url.split(",")[0].strip()
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
        app.router.add_get("/admin/ec/shard_read", self.admin_ec_shard_read)
        app.router.add_get("/admin/ec/mesh_status",
                           self.admin_ec_mesh_status)
        app.router.add_get("/admin/file_copy", self.admin_file_copy)
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
        self._hb_task = asyncio.create_task(self._heartbeat_loop())
        if self.scrub_interval_seconds > 0:
            self._scrub_task = asyncio.create_task(self._scrub_loop())

    async def _on_cleanup(self, app) -> None:
        for task in (self._hb_task, self._scrub_task):
            if task is not None:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
        if self._session is not None:
            await self._session.close()
        await _run(self.store.close)

    # --- heartbeat (weed/server/volume_grpc_client_to_master.go) ---
    async def _heartbeat_loop(self) -> None:
        while True:
            try:
                await self.send_heartbeat()
            except (aiohttp.ClientError, asyncio.TimeoutError,
                    RuntimeError, ValueError) as e:
                log.warning("heartbeat to %s failed: %s", self.master_url,
                            e)
            await asyncio.sleep(self.pulse_seconds)

    def _hb_payload(self) -> dict:
        payload = self.store.heartbeat()
        payload.update({
            "node_id": self.url,
            "url": self.url,
            "public_url": self.url,
            "data_center": self.data_center,
            "rack": self.rack,
        })
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
        async with self._hb_lock:
            payload = self._hb_payload()
            try:
                async with self._session.post(
                        f"http://{self.master_url}/heartbeat",
                        json=payload,
                        timeout=aiohttp.ClientTimeout(total=10)) as r:
                    body = await r.json()
                    if r.status != 200:
                        raise RuntimeError(
                            f"heartbeat: HTTP {r.status} {body}")
            except BaseException:
                # the heat deltas were drained into this payload: a
                # failed delivery must not lose the window's accesses
                # (a lost last_access makes an active volume look idle)
                if payload.get("heat"):
                    self.heat.requeue(payload["heat"])
                raise
        self.volume_size_limit = body.get("volume_size_limit",
                                          self.volume_size_limit)

    # --- data path ---
    async def data_handler(self, request: web.Request) -> web.Response:
        fid_str = request.match_info["fid"].lstrip("/")
        if not fid_str or "," not in fid_str:
            return _error("missing file id", 400)
        try:
            fid = FileId.parse(fid_str)
        except ValueError as e:
            return _error(str(e), 400)
        if request.method in ("GET", "HEAD"):
            return await self._read(request, fid)
        if request.method in ("POST", "PUT"):
            return await self._write(request, fid)
        if request.method == "DELETE":
            return await self._delete(request, fid)
        return _error("method not allowed", 405)

    async def _read(self, request: web.Request,
                    fid: FileId) -> web.Response:
        """GetOrHeadHandler (volume_server_handlers_read.go:28-272)."""
        self.metrics.count("read")
        try:
            n = await _run(self.store.read_needle, fid.volume_id, fid.key,
                           fid.cookie)
        except KeyError:
            # absent, deleted, expired, a wrong cookie or no such volume
            return _error("not found", 404)
        except CrcError:
            return _error("data corruption", 500)
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
            _, _, unchanged = await _run(self.store.write_needle,
                                         fid.volume_id, n)
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
        body = await request.json()
        try:
            await _run(self.store.vacuum_compact, int(body["volume_id"]))
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
        body = await request.json()
        ok = self.store.mark_readonly(int(body["volume_id"]),
                                      body.get("read_only", True))
        return web.json_response({"ok": ok})

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
            v = await _run(Volume, loc.directory, collection, vid)
            loc.volumes[vid] = v
        except (OSError, aiohttp.ClientError, asyncio.TimeoutError,
                ValueError) as e:
            for ext in (".dat", ".idx", ".swm"):
                if os.path.exists(base + ext):
                    os.remove(base + ext)
            return _error(str(e), 500)
        await self.send_heartbeat()
        return web.json_response({"ok": True,
                                  "file_count": v.file_count()})

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
    # total read miss forces an immediate refresh
    _SHARD_LOC_MISSING_TTL = 11.0
    _SHARD_LOC_KNOWN_TTL = 7 * 60.0

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
            status, body = http.get_json(
                f"http://{self.master_url}/col/lookup/ec?volumeId={vid}",
                timeout=5)
            shards = body.get("shards", {}) if status == 200 else {}
            self._shard_loc_cache[vid] = (shards, now)
        except (OSError, ValueError) as e:
            log.warning("ec shard lookup for %d failed: %s", vid, e)
            shards = cached[0] if cached else {}
        return [u for u in shards.get(str(shard_id), []) if u != self.url]

    def _make_shard_reader(self, ev):
        """Reader of non-local shard intervals for the EC read path
        (store_ec.go:282-320), over the holders' /admin/ec/shard_read.
        Synchronous: it runs in the executor threads of the EC read. A
        total miss refreshes the location cache once, so reads survive
        shard moves and lost servers."""

        def fetch(url: str, shard_id: int, offset: int,
                  size: int) -> Optional[bytes]:
            try:
                r = http.request(
                    "GET", f"http://{url}/admin/ec/shard_read?volume="
                    f"{ev.vid}&shard={shard_id}&offset={offset}"
                    f"&size={size}", timeout=10)
            except OSError:
                return None
            if r.status != 200 or len(r.data) != size:
                return None
            return r.data

        def read(shard_id: int, offset: int, size: int) -> Optional[bytes]:
            for force in (False, True):
                for url in self._shard_locations(ev.vid, shard_id,
                                                 force=force):
                    data = fetch(url, shard_id, offset, size)
                    if data is not None:
                        return data
            return None

        return read

    async def status(self, request: web.Request) -> web.Response:
        return web.json_response({"url": self.url, **self.store.status()})

    async def healthz(self, request: web.Request) -> web.Response:
        return web.json_response({"ok": True})

    async def metrics_handler(self, request: web.Request) -> web.Response:
        return web.Response(
            text=self.metrics.render() + metrics_mod.render_shared(),
            content_type="text/plain")


async def run_volume_server(host: str, port: int, store: Store,
                            master_url: str, **kwargs
                            ) -> tuple[VolumeServer, web.AppRunner]:
    """Serve a volume server on host:port (0 picks a free port) on the
    running loop, its heartbeat loop started; returns the volume server
    (``vs.url`` is host:port) and its runner. ``await
    runner.cleanup()`` stops it: the listener, kept connections, the
    heartbeat, and the store."""
    sock = http.listen_socket(host, port)
    vs = VolumeServer(store, master_url,
                      url=f"{host}:{sock.getsockname()[1]}", **kwargs)
    runner = await http.start_app(vs.app, sock)
    log.info("volume server on %s -> master %s", vs.url, master_url)
    return vs, runner
