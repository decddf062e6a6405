"""Volume server: the HTTP data path, the EC admin API, the heartbeat.

The port's reduced copy of seaweedfs_tpu/server/volume_server.py
(upstream weed/server/volume_server_handlers_read.go / _write.go, and the
admin RPCs of volume_grpc_*.go as JSON over HTTP), on the standard
library's HTTP server (server/http.py). The same wire as the reference:

  data:   GET/HEAD/POST/PUT/DELETE /<vid>,<fid>
  admin:  POST /admin/assign_volume       (AllocateVolume)
          POST /admin/volume/delete, /readonly, /mount, /unmount
          POST /admin/ec/generate, /admin/ec/fused (VolumeEcShardsGenerate)
          POST /admin/ec/mount, /unmount, /rebuild
          POST /admin/ec/copy             (VolumeEcShardsCopy, pull model)
          POST /admin/ec/delete_shards, /blob_delete, /to_volume
          GET  /admin/ec/shard_read?volume=&shard=&offset=&size=
          GET  /admin/file_copy?volume_id=&collection=&ext=
          GET  /status, /healthz, /metrics

Handlers run on the request's thread and call the Store directly; the
EC steps run the store's coder, which is the CUDA kernel coder under
"auto" (and raises on a host without a card: the error reaches the
client as an HTTP 500, never as a success). Every handler that changes
what the node holds sends its heartbeat before it answers, so the
master's ``/col/lookup/ec`` is current when the shell's next call lands.
EC reads fetch intervals of shards held elsewhere from their holders'
``/admin/ec/shard_read``, and reconstruct the rest from survivors.

Replication fan-out is not ported: a volume whose replica placement asks
for more than one copy is refused at allocation, never stored as one
copy. Also left out: the write batcher, image resizing, read repair,
vacuum, tiering, tail, query, volume copy, the scrubber, the UI, guard/
JWT, the fastpath listener, shard fleets and gRPC.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional

from ..ec.geometry import to_ext
from ..storage import types as t
from ..storage.file_id import FileId
from ..storage.needle import (FLAG_HAS_LAST_MODIFIED, FLAG_HAS_MIME,
                              FLAG_HAS_NAME, FLAG_HAS_TTL,
                              FLAG_IS_COMPRESSED, CrcError, Needle)
from ..storage.store import Store, safe_collection
from ..storage.superblock import ReplicaPlacement
from ..storage.volume import VolumeReadOnly
from ..utils import compression, multipart
from ..utils import metrics as metrics_mod
from . import http

log = logging.getLogger("volume")

MAX_NEEDLE_BYTES = 32 * 1024 * 1024


def _error(msg: str, status: int) -> http.Response:
    return http.json_response({"error": msg}, status)


class VolumeServer:
    def __init__(self, store: Store, master_url: str, url: str = "",
                 data_center: str = "", rack: str = "",
                 pulse_seconds: float = 5.0):
        self.store = store
        self.master_url = master_url.split(",")[0].strip()
        self.url = url
        self.data_center = data_center
        self.rack = rack
        self.pulse_seconds = pulse_seconds
        self.volume_size_limit = 30 * 1024 * 1024 * 1024
        self.metrics = metrics_mod.Registry("volume")
        self._shard_loc_cache: dict[int, tuple[dict, float]] = {}
        # one heartbeat at a time: a payload built before another must
        # not land after it
        self._hb_lock = threading.Lock()
        self._stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self.app = self._build_app()
        # the EC read path fetches missing shards from peers through this
        store._remote_shard_reader = self._make_shard_reader

    def _build_app(self) -> http.App:
        app = http.App()
        admin = [
            ("assign_volume", self.admin_assign_volume),
            ("volume/delete", self.admin_volume_delete),
            ("volume/readonly", self.admin_readonly),
            ("volume/mount", self.admin_volume_mount),
            ("volume/unmount", self.admin_volume_unmount),
            ("ec/generate", self.admin_ec_generate),
            ("ec/fused", self.admin_ec_fused),
            ("ec/mount", self.admin_ec_mount),
            ("ec/unmount", self.admin_ec_unmount),
            ("ec/rebuild", self.admin_ec_rebuild),
            ("ec/copy", self.admin_ec_copy),
            ("ec/delete_shards", self.admin_ec_delete_shards),
            ("ec/blob_delete", self.admin_ec_blob_delete),
            ("ec/to_volume", self.admin_ec_to_volume),
        ]
        for path, handler in admin:
            app.route("POST", f"/admin/{path}", handler)
        app.route("GET", "/admin/ec/shard_read", self.admin_ec_shard_read)
        app.route("GET", "/admin/file_copy", self.admin_file_copy)
        app.route("GET", "/status", self.status)
        app.route("GET", "/metrics", self.metrics_handler)
        app.route("GET", "/healthz",
                  lambda req: http.json_response({"ok": True}))
        app.catch_all("fid", self.data_handler)
        return app

    # --- heartbeat (weed/server/volume_grpc_client_to_master.go) ---
    def start(self) -> None:
        """Start the heartbeat loop: one beat now, then every pulse."""
        if self._hb_thread is None:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, name=f"heartbeat-{self.url}",
                daemon=True)
            self._hb_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join()
            self._hb_thread = None

    def _heartbeat_loop(self) -> None:
        while True:
            try:
                self.send_heartbeat()
            except Exception as e:
                log.warning("heartbeat to %s failed: %s", self.master_url,
                            e)
            if self._stop.wait(self.pulse_seconds):
                return

    def _hb_payload(self) -> dict:
        payload = self.store.heartbeat()
        payload.update({
            "node_id": self.url,
            "url": self.url,
            "public_url": self.url,
            "data_center": self.data_center,
            "rack": self.rack,
        })
        return payload

    def send_heartbeat(self) -> None:
        with self._hb_lock:
            if self._stop.is_set():
                return
            status, body = http.post_json(
                f"http://{self.master_url}/heartbeat", self._hb_payload(),
                timeout=10)
        if status != 200:
            raise RuntimeError(f"heartbeat: HTTP {status} {body}")
        self.volume_size_limit = body.get("volume_size_limit",
                                          self.volume_size_limit)

    # --- data path ---
    def data_handler(self, req: http.Request) -> http.Response:
        fid_str = req.match["fid"]
        if not fid_str or "," not in fid_str:
            return _error("missing file id", 400)
        try:
            fid = FileId.parse(fid_str)
        except ValueError as e:
            return _error(str(e), 400)
        if req.method in ("GET", "HEAD"):
            return self._read(req, fid)
        if req.method in ("POST", "PUT"):
            return self._write(req, fid)
        if req.method == "DELETE":
            return self._delete(req, fid)
        return _error("method not allowed", 405)

    def _read(self, req: http.Request, fid: FileId) -> http.Response:
        """GetOrHeadHandler (volume_server_handlers_read.go:28-272)."""
        self.metrics.count("read")
        try:
            n = self.store.read_needle(fid.volume_id, fid.key, fid.cookie)
        except KeyError:
            # absent, deleted, expired, a wrong cookie or no such volume
            return _error("not found", 404)
        except CrcError:
            return _error("data corruption", 500)
        etag = f'"{n.etag()}"'
        if req.headers.get("If-None-Match") == etag:
            return http.Response(status=304)
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
            if "gzip" in req.headers.get("Accept-Encoding", ""):
                headers["Content-Encoding"] = "gzip"
            else:
                body = compression.decompress(body)
        status = 200
        rng = req.headers.get("Range")
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
                return http.Response(status=416)
            headers["Content-Range"] = f"bytes {start}-{end}/{len(body)}"
            body = body[start:end + 1]
            status = 206
        return http.Response(body, status, headers, content_type=mime)

    def _write(self, req: http.Request, fid: FileId) -> http.Response:
        """PostHandler (volume_server_handlers_write.go:19): the needle
        gets the reference's fields (name, mime, the compression flag,
        ttl, last-modified) from the multipart part and the query."""
        self.metrics.count("write")
        v = self.store.find_volume(fid.volume_id)
        if v is not None and \
                v.super_block.replica_placement.copy_count() > 1:
            return _error(f"volume {fid.volume_id}: replication "
                          f"{v.super_block.replica_placement} is not "
                          "supported by this server", 409)
        n = Needle(cookie=fid.cookie, id=fid.key)
        raw_ct = req.headers.get("Content-Type", "")
        filename, ctype = "", ""
        if raw_ct[:10].lower().startswith("multipart/"):
            part = multipart.parse_upload(req.body, raw_ct)
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
            n.data = req.body
            already_gzipped = req.headers.get("Content-Encoding",
                                              "") == "gzip"
        # client-gzipped payloads keep the flag; compressable content is
        # gzipped when that shrinks it; ?compress=false opts out
        if already_gzipped and compression.is_gzipped(n.data):
            n.set_flag(FLAG_IS_COMPRESSED)
        elif req.query.get("compress") != "false":
            ext = os.path.splitext(filename)[1] if filename else ""
            payload, compressed = compression.maybe_compress(n.data, ext,
                                                             ctype)
            if compressed:
                n.data = payload
                n.set_flag(FLAG_IS_COMPRESSED)
        if len(n.data) > MAX_NEEDLE_BYTES:
            return _error("entry too large", 413)
        ttl_s = req.query.get("ttl", "")
        if ttl_s:
            n.set_flag(FLAG_HAS_TTL)
            n.ttl = t.TTL.parse(ttl_s)
        n.set_flag(FLAG_HAS_LAST_MODIFIED)
        n.last_modified = int(time.time())
        try:
            _, _, unchanged = self.store.write_needle(fid.volume_id, n)
        except VolumeReadOnly as e:
            return _error(str(e), 409)
        except KeyError:
            return _error("volume not found", 404)
        except ValueError as e:
            return _error(str(e), 409)
        return http.json_response({
            "name": (n.name or b"").decode("utf-8", "replace"),
            "size": len(n.data), "eTag": n.etag(),
            "unchanged": unchanged}, 201)

    def _delete(self, req: http.Request, fid: FileId) -> http.Response:
        """DeleteHandler. The needle's cookie must match, as upstream
        checks it (volume_server_handlers_write.go); the reference does
        not."""
        self.metrics.count("delete")
        propagate = req.query.get("type") != "replicate"
        ev = self.store.find_ec_volume(fid.volume_id)
        if ev is not None and self.store.find_volume(fid.volume_id) is None:
            # EC delete: local tombstone, then every other shard holder.
            # Every holder has the .ecx, so each checks the cookie, the
            # holders a delete is propagated to as well.
            try:
                n = self.store.read_needle(fid.volume_id, fid.key)
            except KeyError:
                n = None  # absent or deleted: the tombstone is a no-op
            if n is not None and n.cookie != fid.cookie:
                return _error("File Random Cookie does not match.", 400)
            try:
                self.store.ec_blob_delete(fid.volume_id, fid.key)
            except KeyError:
                return _error("not found", 404)
            if propagate:
                self._propagate_ec_delete(fid)
            return http.json_response({"size": 0})
        v = self.store.find_volume(fid.volume_id)
        if v is None:
            return _error("volume not found", 404)
        cookie = v.needle_cookie(fid.key)
        if cookie is not None and cookie != fid.cookie:
            return _error("File Random Cookie does not match.", 400)
        try:
            size = self.store.delete_needle(fid.volume_id,
                                            Needle(cookie=fid.cookie,
                                                   id=fid.key))
        except VolumeReadOnly as e:
            return _error(str(e), 409)
        return http.json_response({"size": size})

    def _propagate_ec_delete(self, fid: FileId) -> None:
        try:
            status, body = http.get_json(
                f"http://{self.master_url}/col/lookup/ec"
                f"?volumeId={fid.volume_id}", timeout=10)
        except OSError:
            return
        if status != 200:
            return
        urls = {u for us in body.get("shards", {}).values() for u in us
                if u != self.url}
        for url in sorted(urls):
            try:
                http.request("DELETE", f"http://{url}/{fid}?type=replicate",
                             timeout=30)
            except OSError as e:
                log.warning("ec delete propagate to %s: %s", url, e)

    # --- admin ---
    def admin_assign_volume(self, req: http.Request) -> http.Response:
        body = req.json()
        replication = body.get("replication", "000") or "000"
        try:
            copies = ReplicaPlacement.parse(replication).copy_count()
        except ValueError as e:
            return _error(str(e), 400)
        if copies > 1:
            # the fan-out is not ported: one stored copy would break the
            # placement's promise
            return _error(f"replication {replication} is not supported "
                          "by this server", 409)
        try:
            self.store.add_volume(int(body["volume_id"]),
                                  body.get("collection", ""), replication,
                                  body.get("ttl", ""))
        except (ValueError, RuntimeError) as e:
            return _error(str(e), 409)
        try:
            self.send_heartbeat()
        except Exception as e:
            # the allocation itself succeeded; the next beat reports it
            log.warning("post-allocate heartbeat failed: %s", e)
        return http.json_response({"ok": True})

    def admin_volume_delete(self, req: http.Request) -> http.Response:
        ok = self.store.delete_volume(int(req.json()["volume_id"]))
        self.send_heartbeat()
        return http.json_response({"ok": ok})

    def admin_readonly(self, req: http.Request) -> http.Response:
        body = req.json()
        ok = self.store.mark_readonly(int(body["volume_id"]),
                                      body.get("read_only", True))
        return http.json_response({"ok": ok})

    def admin_volume_mount(self, req: http.Request) -> http.Response:
        body = req.json()
        try:
            v = self.store.mount_volume(int(body["volume_id"]),
                                        body.get("collection", ""))
        except (KeyError, ValueError) as e:
            return _error(str(e), 409)
        self.send_heartbeat()
        return http.json_response({"ok": True,
                                   "file_count": v.file_count()})

    def admin_volume_unmount(self, req: http.Request) -> http.Response:
        ok = self.store.unmount_volume(int(req.json()["volume_id"]))
        self.send_heartbeat()
        return http.json_response({"ok": ok})

    def admin_ec_generate(self, req: http.Request) -> http.Response:
        """One volume (volume_id) or a window (volume_ids) streamed
        through one governed operating point; ``"fused": true`` runs the
        one-pass warm-down instead."""
        body = req.json()
        return self._ec_generate_impl(body,
                                      fused=bool(body.get("fused", False)))

    def admin_ec_fused(self, req: http.Request) -> http.Response:
        return self._ec_generate_impl(req.json(), fused=True)

    def _ec_generate_impl(self, body: dict, fused: bool) -> http.Response:
        vids = ([int(v) for v in body["volume_ids"]]
                if "volume_ids" in body else [int(body["volume_id"])])
        if not vids:
            return _error("empty volume_ids", 400)
        try:
            if len(vids) == 1:
                gen = (self.store.ec_fused_generate if fused
                       else self.store.ec_generate)
                shards = gen(vids[0])
                per_volume = {str(vids[0]): shards}
            else:
                gen_many = (self.store.ec_fused_generate_many if fused
                            else self.store.ec_generate_many)
                per_volume = {str(k): v for k, v in gen_many(vids).items()}
                shards = per_volume.get(str(vids[0]), [])
        except KeyError as e:
            return _error(str(e), 404)
        return http.json_response({"ok": True, "shards": shards,
                                   "fused": fused, "volumes": per_volume})

    def admin_ec_mount(self, req: http.Request) -> http.Response:
        body = req.json()
        try:
            mounted = self.store.ec_mount(
                int(body["volume_id"]), body.get("collection", ""),
                [int(s) for s in body["shard_ids"]])
        except (KeyError, FileNotFoundError) as e:
            return _error(str(e), 404)
        self.send_heartbeat()
        return http.json_response({"ok": True, "mounted": mounted})

    def admin_ec_unmount(self, req: http.Request) -> http.Response:
        body = req.json()
        removed = self.store.ec_unmount(int(body["volume_id"]),
                                        [int(s) for s in body["shard_ids"]])
        self.send_heartbeat()
        return http.json_response({"ok": True, "unmounted": removed})

    def admin_ec_rebuild(self, req: http.Request) -> http.Response:
        body = req.json()
        try:
            rebuilt = self.store.ec_rebuild(int(body["volume_id"]),
                                            body.get("collection", ""))
        except (KeyError, ValueError) as e:
            return _error(str(e), 409)
        return http.json_response({"ok": True, "rebuilt": rebuilt})

    def admin_ec_copy(self, req: http.Request) -> http.Response:
        """Pull shard files from a source server (VolumeEcShardsCopy,
        volume_grpc_erasure_coding.go:104), each streamed to disk."""
        body = req.json()
        vid = int(body["volume_id"])
        collection = body.get("collection", "")
        if not safe_collection(collection):
            return _error("bad collection", 400)
        source = body["source"]
        exts = [to_ext(int(s)) for s in body["shard_ids"]]
        if body.get("copy_ecx_file", False):
            exts += [".ecx", ".ecj", ".ecm"]
        prefix = f"{collection}_" if collection else ""
        base = os.path.join(self.store.locations[0].directory,
                            f"{prefix}{vid}")
        for ext in exts:
            url = (f"http://{source}/admin/file_copy?volume_id={vid}"
                   f"&collection={collection}&ext={ext}")
            try:
                status = http.download_to(url, base + ext)
            except OSError as e:
                return _error(str(e), 502)
            if status == 404 and ext in (".ecj", ".ecm"):
                continue  # the delete journal and marker are optional
            if status != 200:
                return _error(f"copy {ext} from {source}: {status}", 502)
        return http.json_response({"ok": True})

    def admin_ec_delete_shards(self, req: http.Request) -> http.Response:
        body = req.json()
        self.store.ec_delete_shards(int(body["volume_id"]),
                                    body.get("collection", ""),
                                    [int(s) for s in body["shard_ids"]])
        self.send_heartbeat()
        return http.json_response({"ok": True})

    def admin_ec_blob_delete(self, req: http.Request) -> http.Response:
        body = req.json()
        try:
            self.store.ec_blob_delete(int(body["volume_id"]),
                                      int(body["needle_id"]))
        except KeyError as e:
            return _error(str(e), 404)
        return http.json_response({"ok": True})

    def admin_ec_to_volume(self, req: http.Request) -> http.Response:
        body = req.json()
        try:
            self.store.ec_to_volume(int(body["volume_id"]),
                                    body.get("collection", ""))
        except (KeyError, FileNotFoundError) as e:
            return _error(str(e), 404)
        self.send_heartbeat()
        return http.json_response({"ok": True})

    def admin_ec_shard_read(self, req: http.Request) -> http.Response:
        q = req.query
        try:
            data = self.store.ec_shard_read(
                int(q["volume"]), int(q["shard"]), int(q.get("offset", 0)),
                int(q["size"]))
        except KeyError as e:
            return _error(str(e), 404)
        return http.Response(data, content_type="application/octet-stream")

    def admin_file_copy(self, req: http.Request) -> http.Response:
        """Stream a volume or shard file to a pulling peer (CopyFile,
        weed/server/volume_grpc_copy.go:24-281)."""
        q = req.query
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
                return http.FileResponse(path)
        return _error("file not found", 404)

    # shard-location freshness tiers (store_ec.go:221-262): a missing
    # shard re-polls the master after 11 s, a known one after 7 min; a
    # total read miss forces an immediate refresh
    _SHARD_LOC_MISSING_TTL = 11.0
    _SHARD_LOC_KNOWN_TTL = 7 * 60.0

    def _shard_locations(self, vid: int, shard_id: int,
                         force: bool = False) -> list[str]:
        """Tiered-TTL cache of vid -> shard -> holder urls."""
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
        (store_ec.go:282-320), over the holders' /admin/ec/shard_read. A
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

    def status(self, req: http.Request) -> http.Response:
        return http.json_response({"url": self.url, **self.store.status()})

    def metrics_handler(self, req: http.Request) -> http.Response:
        return http.Response(
            (self.metrics.render() + metrics_mod.render_shared()).encode(),
            content_type="text/plain; charset=utf-8")


def run_volume_server(host: str, port: int, store: Store, master_url: str,
                      **kwargs) -> tuple[VolumeServer, http.Server]:
    """Serve a volume server on host:port (0 picks a free port) and start
    its heartbeat; returns the volume server and its HTTP server. Stop
    with ``vs.stop()``, ``server.shutdown()`` and ``store.close()``."""
    vs = VolumeServer(store, master_url, **kwargs)
    server = http.serve(vs.app, host, port)
    vs.url = vs.url or server.url
    vs.start()
    log.info("volume server on %s -> master %s", server.url, master_url)
    return vs, server
