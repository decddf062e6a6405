"""Master server: assignment, lookup, topology, growth, vacuum, the EC
registry.

The port's reduced copy of seaweedfs_tpu/server/master.py (upstream
weed/server/master_server.go:113-129, master_server_handlers.go,
weed/topology/topology_vacuum.go), an aiohttp application with the
reference's wire:

  GET  /dir/assign?count&collection&replication&ttl&dataCenter
  GET  /dir/lookup?volumeId=|fileId=&collection=   (every replica)
  GET  /dir/status         (topology + the EC geometry policy)
  GET  /vol/grow?count&collection&replication&ttl&dataCenter
  GET  /vol/vacuum?garbageThreshold=
  GET  /vol/list
  GET  /col/lookup/ec?volumeId=
  POST /heartbeat          (volume servers report in, JSON Store payload)
  GET  /cluster/status, /healthz, /metrics

One master, no raft: needle keys come from a ``MemorySequencer`` that
every heartbeat raises to the volumes' largest key, so a restarted master
never re-mints a key a volume holds. Two background tasks run on its
loop: one prunes nodes whose heartbeats stopped (pulse x 5, as the
reference's maintenance daemon does), so a stopped volume server leaves
the lookups; the other vacuums, every ``vacuum_interval_seconds`` (900 s,
upstream's 15 minutes), every volume whose garbage is at least
``garbage_threshold`` (0.3, upstream's ``-garbageThreshold``) on all its
replicas. Growth and the vacuum call the volume servers with awaited
aiohttp client calls, so the master shares a loop with them safely.

Left out: raft and the metadata log, the filer ring, balance, geo,
lifecycle, the repair daemon, collection deletion, admin locks, the
watch stream, guard/JWT, the fastpath listener and gRPC.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

import aiohttp
from aiohttp import web

from ..ec.geometry import GeometryPolicy
from ..storage.file_id import FileId, new_cookie
from ..storage.superblock import ReplicaPlacement
from ..topology.sequence import MemorySequencer
from ..topology.topology import Topology
from ..utils import metrics as metrics_mod
from . import http

log = logging.getLogger("master")

# ceiling on /dir/assign?count=N, as in the reference
MAX_ASSIGN_COUNT = 10000
# the largest request body
MAX_BODY = 64 * 1024 * 1024


def _error(msg: str, status: int) -> web.Response:
    return web.json_response({"error": msg}, status=status)


class MasterServer:
    def __init__(self, volume_size_limit_mb: int = 30 * 1024,
                 default_replication: str = "000",
                 pulse_seconds: float = 5.0,
                 garbage_threshold: float = 0.3,
                 vacuum_interval_seconds: float = 900.0,
                 url: str = ""):
        self.topology = Topology(
            volume_size_limit=volume_size_limit_mb * 1024 * 1024,
            pulse_seconds=pulse_seconds)
        self.sequencer = MemorySequencer()
        self.default_replication = default_replication
        self.garbage_threshold = garbage_threshold
        self.vacuum_interval_seconds = vacuum_interval_seconds
        self.url = url
        # a bad WEED_EC_GEOMETRY kills the master at startup
        self.ec_policy = GeometryPolicy.from_env()
        # the pruner's period, as the reference's maintenance daemon
        self.maintenance_interval_seconds = max(pulse_seconds, 0.05)
        self.metrics = metrics_mod.Registry("master")
        # the topology is touched on the loop's thread only; growth and
        # vacuum passes await volume servers and are each serialized
        self._grow_lock: Optional[asyncio.Lock] = None
        self._vacuum_lock: Optional[asyncio.Lock] = None
        self._tasks: list[asyncio.Task] = []
        self.app = self._build_app()

    def _build_app(self) -> web.Application:
        app = web.Application(client_max_size=MAX_BODY,
                              middlewares=[http.errors_as_json])
        app.router.add_get("/dir/assign", self.dir_assign)
        app.router.add_get("/dir/lookup", self.dir_lookup)
        app.router.add_get("/dir/status", self.dir_status)
        app.router.add_get("/vol/grow", self.vol_grow)
        app.router.add_get("/vol/vacuum", self.vol_vacuum)
        app.router.add_get("/vol/list", self.vol_list)
        app.router.add_get("/col/lookup/ec", self.ec_lookup)
        app.router.add_post("/heartbeat", self.heartbeat)
        app.router.add_get("/cluster/status", self.cluster_status)
        app.router.add_get("/metrics", self.metrics_handler)
        app.router.add_get("/healthz", self.healthz)
        app.on_startup.append(self._on_startup)
        app.on_cleanup.append(self._on_cleanup)
        return app

    async def _on_startup(self, app) -> None:
        self._grow_lock = asyncio.Lock()
        self._vacuum_lock = asyncio.Lock()
        self._tasks = [asyncio.create_task(self._maintenance_loop())]
        if self.vacuum_interval_seconds > 0:
            self._tasks.append(asyncio.create_task(self._vacuum_loop()))

    async def _on_cleanup(self, app) -> None:
        for task in self._tasks:
            task.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []

    # --- the dead-node pruner (the reference's maintenance loop,
    #     weed/server/master_server.go:187-257, reduced to pruning) ---
    async def _maintenance_loop(self) -> None:
        while True:
            await asyncio.sleep(self.maintenance_interval_seconds)
            for ev in self.topology.prune_dead_nodes():
                self.metrics.count("dead_nodes_pruned")
                log.info("pruned dead node %s", ev["url"])

    # --- handlers ---
    async def dir_assign(self, request: web.Request) -> web.Response:
        """Assign a write target (dirAssignHandler,
        weed/server/master_server_handlers.go:96-150)."""
        self.metrics.count("assign")
        q = request.query
        try:
            count = int(q.get("count", 1))
        except ValueError:
            return _error("invalid count", 400)
        resp, status = await self.assign_api(
            count=count,
            collection=q.get("collection", ""),
            replication=q.get("replication", self.default_replication),
            ttl=q.get("ttl", ""),
            data_center=q.get("dataCenter", ""))
        return web.json_response(resp, status=status)

    async def assign_api(self, count: int = 1, collection: str = "",
                         replication: str = "", ttl: str = "",
                         data_center: str = "") -> tuple[dict, int]:
        if count < 1:
            # a negative count would roll the sequencer backwards
            return {"error": "invalid count"}, 400
        if count > MAX_ASSIGN_COUNT:
            return {"error": f"count exceeds {MAX_ASSIGN_COUNT}"}, 400
        replication = replication or self.default_replication
        picked = self.topology.pick_for_write(collection, replication, ttl)
        if picked is None:
            async with self._grow_lock:
                picked = self.topology.pick_for_write(collection,
                                                      replication, ttl)
                if picked is None:
                    if not await self._grow(1, collection, replication,
                                            ttl, data_center):
                        return ({"error":
                                 "no writable volumes and cannot grow"},
                                500)
                    picked = self.topology.pick_for_write(
                        collection, replication, ttl)
        if picked is None:
            return {"error": "no writable volumes"}, 500
        vid, nodes = picked
        g = self.ec_policy.for_collection(collection)
        key = self.sequencer.next_file_id(count)
        fid = FileId(vid, key, new_cookie())
        node = nodes[0]
        return {
            "fid": str(fid),
            "url": node.url,
            "publicUrl": node.public_url,
            "count": count,
            "replicas": [n.url for n in nodes[1:]],
            # the RS(k,m) this collection's volumes will seal into
            "ecGeometry": f"{g.data_shards}+{g.parity_shards}",
        }, 200

    async def dir_lookup(self, request: web.Request) -> web.Response:
        q = request.query
        vid_str = q.get("volumeId", q.get("fileId", ""))
        try:
            vid = (FileId.parse(vid_str).volume_id if "," in vid_str
                   else int(vid_str))
        except ValueError:
            return _error("invalid fileId" if "," in vid_str
                          else "invalid volumeId", 400)
        nodes = self.topology.lookup(vid, q.get("collection", ""))
        if not nodes:
            # EC volumes are located through the shard registry
            urls: list[str] = []
            for nlist in self.topology.lookup_ec_shards(vid).values():
                for n in nlist:
                    if n.url not in urls:
                        urls.append(n.url)
            if urls:
                return web.json_response({
                    "volumeId": str(vid),
                    "locations": [{"url": u, "publicUrl": u}
                                  for u in urls],
                    "ec": True})
            return web.json_response(
                {"volumeId": str(vid), "error": "volume not found"},
                status=404)
        return web.json_response({
            "volumeId": str(vid),
            "locations": [{"url": n.url, "publicUrl": n.public_url}
                          for n in nodes]})

    async def dir_status(self, request: web.Request) -> web.Response:
        d = self.topology.to_dict()
        d["ec_geometry"] = self.ec_policy.to_dict()
        return web.json_response(d)

    async def vol_grow(self, request: web.Request) -> web.Response:
        q = request.query
        try:
            count = int(q.get("count", 1))
        except ValueError:
            return _error("invalid count", 400)
        if count < 1:
            return _error("invalid count", 400)
        async with self._grow_lock:
            grown = await self._grow(
                count, q.get("collection", ""),
                q.get("replication", self.default_replication),
                q.get("ttl", ""), q.get("dataCenter", ""))
        if not grown:
            return _error("growth failed", 500)
        return web.json_response({"count": len(grown),
                                  "volume_ids": grown})

    async def _grow(self, count: int, collection: str, replication: str,
                    ttl: str, data_center: str = "") -> list[int]:
        """AutomaticGrowByType (weed/topology/volume_growth.go:70-208):
        pick placement-satisfying nodes, allocate on each. The caller
        holds _grow_lock; each volume server's allocation heartbeat lands
        here while the call is awaited."""
        grown: list[int] = []
        async with aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=30)) as session:
            for _ in range(count):
                nodes = self.topology.find_empty_slots(replication,
                                                       data_center)
                if not nodes:
                    break
                vid = self.topology.next_volume_id()
                ok = True
                for node in nodes:
                    try:
                        async with session.post(
                                f"http://{node.url}/admin/assign_volume",
                                json={"volume_id": vid,
                                      "collection": collection,
                                      "replication": replication,
                                      "ttl": ttl},
                                timeout=aiohttp.ClientTimeout(
                                    total=10)) as r:
                            if r.status != 200:
                                log.warning("allocate %d on %s: HTTP %d",
                                            vid, node.url, r.status)
                                ok = False
                                break
                    except (aiohttp.ClientError,
                            asyncio.TimeoutError) as e:
                        log.warning("allocate %d on %s failed: %s", vid,
                                    node.url, e)
                        ok = False
                        break
                if ok:
                    grown.append(vid)
                    self.metrics.count("volumes_grown")
        return grown

    async def vol_list(self, request: web.Request) -> web.Response:
        """VolumeList (weed/server/master_grpc_server_volume.go:117)."""
        return web.json_response({
            "volume_size_limit_mb":
                self.topology.volume_size_limit // (1024 * 1024),
            "nodes": [{
                "url": n.url, "public_url": n.public_url,
                "data_center": n.data_center, "rack": n.rack,
                "max_volume_count": n.max_volume_count,
                "volumes": [vars(v) for v in n.volumes.values()],
                "ec_shards": [{
                    "id": e.id, "collection": e.collection,
                    "shard_ids": e.shard_ids,
                    "shard_size": e.shard_size,
                } for e in n.ec_shards.values()],
            } for n in self.topology.nodes.values()]})

    # --- vacuum (weed/topology/topology_vacuum.go:17-171) ---
    async def vol_vacuum(self, request: web.Request) -> web.Response:
        """Manual vacuum: compact every volume whose garbage level is at
        least the threshold on all its replicas."""
        try:
            threshold = float(request.query.get("garbageThreshold",
                                                self.garbage_threshold))
        except ValueError:
            return _error("invalid garbageThreshold", 400)
        done = await self._vacuum_pass(threshold)
        return web.json_response({"ok": True, "compacted": done})

    async def _vacuum_loop(self) -> None:
        """The periodic scan (topology_event_handling.go:12 kicks it
        every 15 minutes)."""
        while True:
            await asyncio.sleep(self.vacuum_interval_seconds)
            try:
                await self._vacuum_pass(self.garbage_threshold)
            except (aiohttp.ClientError, asyncio.TimeoutError) as e:
                log.warning("vacuum pass failed: %s", e)

    async def _vacuum_pass(self, threshold: float) -> list[int]:
        """One orchestrated cycle per volume over the threshold: check
        all replicas, compact all (each server replays the writes that
        land meanwhile), commit all, clean up on failure. The volume is
        parked in layout.vacuuming, out of the writable set, for the
        cycle (batchVacuumVolumeCompact/Commit, topology_vacuum.go:
        17-103). Passes are serialized; a failure on one volume never
        aborts the rest of the scan. Read-only volumes, and volumes with
        fewer holders than their placement asks for, are skipped."""
        compacted: list[int] = []
        async with self._vacuum_lock, aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=300)) as s:
            for layout in list(self.topology.layouts.values()):
                copies = ReplicaPlacement.parse(
                    layout.replication).copy_count()
                for vid, nodes in list(layout.locations.items()):
                    if len(nodes) < copies or any(
                            n.volumes[vid].read_only for n in nodes
                            if vid in n.volumes):
                        # as upstream's vacuumOneVolumeLayout, and
                        # unlike the reference: a read-only volume (one
                        # being EC-encoded, say) is never compacted
                        # under its reader, nor one short of copies
                        continue
                    try:
                        if await self._vacuum_one(
                                s, layout, vid, [n.url for n in nodes],
                                threshold):
                            compacted.append(vid)
                            self.metrics.count("volumes_vacuumed")
                    except (aiohttp.ClientError, asyncio.TimeoutError,
                            ValueError, KeyError) as e:
                        log.warning("vacuum of volume %d failed: %s", vid,
                                    e)
        return compacted

    async def _vacuum_one(self, s: aiohttp.ClientSession, layout,
                          vid: int, urls: list[str],
                          threshold: float) -> bool:
        levels = []
        for u in urls:
            async with s.get(f"http://{u}/admin/vacuum/check",
                             params={"volume_id": str(vid)}) as r:
                if r.status != 200:
                    return False
                levels.append((await r.json())["garbage_level"])
        if not levels or min(levels) < threshold:
            return False
        layout.vacuuming.add(vid)
        was_writable = vid in layout.writable
        layout.writable.discard(vid)
        ok = False
        try:
            # a failed commit stops the phase: the holders after it keep
            # their old files, and the cleanup below aborts their copies
            ok = (await self._vacuum_step(s, urls, "compact", vid)
                  and await self._vacuum_step(s, urls, "commit", vid))
            return ok
        finally:
            if not ok:
                # on a refusal or a raised error alike (a holder that
                # died mid-pass): every holder drops its open compaction;
                # one that already committed takes it as a no-op
                for u in urls:
                    try:
                        async with s.post(
                                f"http://{u}/admin/vacuum/cleanup",
                                json={"volume_id": vid}):
                            pass
                    except (aiohttp.ClientError, asyncio.TimeoutError):
                        pass
            layout.vacuuming.discard(vid)
            if was_writable:
                layout.writable.add(vid)

    @staticmethod
    async def _vacuum_step(s: aiohttp.ClientSession, urls: list[str],
                           step: str, vid: int) -> bool:
        """POST one vacuum step to each holder in turn; False at the
        first that refuses it."""
        for u in urls:
            async with s.post(f"http://{u}/admin/vacuum/{step}",
                              json={"volume_id": vid}) as r:
                if r.status != 200:
                    return False
        return True

    async def ec_lookup(self, request: web.Request) -> web.Response:
        """LookupEcVolume (weed/server/master_grpc_server_volume.go:148)."""
        try:
            vid = int(request.query.get("volumeId", ""))
        except ValueError:
            return _error("invalid volumeId", 400)
        shards = self.topology.lookup_ec_shards(vid)
        if not shards:
            return _error("ec volume not found", 404)
        return web.json_response({
            "volumeId": vid,
            "shards": {str(sid): [n.url for n in nodes]
                       for sid, nodes in shards.items()}})

    async def heartbeat(self, request: web.Request) -> web.Response:
        """Heartbeat intake (weed/server/master_grpc_server.go:20-176).
        Body: {node_id, url, public_url, data_center, rack,
               max_volume_count, max_file_key, volumes, ec_shards}."""
        self.metrics.count("heartbeat")
        return web.json_response(self.apply_heartbeat(await request.json()))

    def apply_heartbeat(self, body: dict) -> dict:
        self.topology.register_heartbeat(
            node_id=body["node_id"],
            url=body["url"],
            public_url=body.get("public_url", body["url"]),
            data_center=body.get("data_center", ""),
            rack=body.get("rack", ""),
            max_volume_count=body.get("max_volume_count", 8),
            payload=body)
        # the volumes' largest key raises the sequencer: a restarted
        # master never re-mints a key a volume already holds
        self.sequencer.set_max(body.get("max_file_key", 0))
        return {"volume_size_limit": self.topology.volume_size_limit,
                "leader": self.url}

    async def cluster_status(self, request: web.Request) -> web.Response:
        return web.json_response({
            "is_leader": True, "leader": self.url, "peers": [],
            "raft_term": 0, "topology": self.topology.to_dict()})

    async def healthz(self, request: web.Request) -> web.Response:
        return web.json_response({"ok": True})

    async def metrics_handler(self, request: web.Request) -> web.Response:
        return web.Response(
            text=self.metrics.render() + metrics_mod.render_shared(),
            content_type="text/plain")


async def run_master(host: str = "127.0.0.1", port: int = 0,
                     **kwargs) -> tuple[MasterServer, web.AppRunner]:
    """Serve a master on host:port (0 picks a free port) on the running
    loop; returns the master (``master.url`` is host:port) and its
    runner. ``await runner.cleanup()`` stops it."""
    sock = http.listen_socket(host, port)
    master = MasterServer(url=f"{host}:{sock.getsockname()[1]}", **kwargs)
    runner = await http.start_app(master.app, sock)
    log.info("master listening on %s", master.url)
    return master, runner
