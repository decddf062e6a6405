"""Master server: assignment, lookup, topology, growth, the EC registry.

The port's reduced copy of seaweedfs_tpu/server/master.py (upstream
weed/server/master_server.go:113-129, master_server_handlers.go), on the
standard library's HTTP server (server/http.py). The same wire as the
reference:

  GET  /dir/assign?count&collection&replication&ttl&dataCenter
  GET  /dir/lookup?volumeId=|fileId=&collection=
  GET  /dir/status         (topology + the EC geometry policy)
  GET  /vol/grow?count&collection&replication&ttl&dataCenter
  GET  /vol/list
  GET  /col/lookup/ec?volumeId=
  POST /heartbeat          (volume servers report in, JSON Store payload)
  GET  /cluster/status, /healthz, /metrics

One master, no raft: needle keys come from a ``MemorySequencer`` that
every heartbeat raises to the volumes' largest key, so a restarted master
never re-mints a key a volume holds. A thread prunes nodes whose
heartbeats stopped (pulse x 5, as the reference's maintenance daemon
does), so a stopped volume server leaves ``/col/lookup/ec``.

Left out: raft and the metadata log, the filer ring, balance, geo,
lifecycle, the repair and vacuum daemons, admin locks, the watch stream,
guard/JWT, the fastpath listener and gRPC.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from ..ec.geometry import GeometryPolicy
from ..storage.file_id import FileId, new_cookie
from ..topology.sequence import MemorySequencer
from ..topology.topology import Topology
from ..utils import metrics as metrics_mod
from . import http

log = logging.getLogger("master")

# ceiling on /dir/assign?count=N, as in the reference
MAX_ASSIGN_COUNT = 10000


class MasterServer:
    def __init__(self, volume_size_limit_mb: int = 30 * 1024,
                 default_replication: str = "000",
                 pulse_seconds: float = 5.0,
                 url: str = ""):
        self.topology = Topology(
            volume_size_limit=volume_size_limit_mb * 1024 * 1024,
            pulse_seconds=pulse_seconds)
        self.sequencer = MemorySequencer()
        self.default_replication = default_replication
        self.url = url
        # a bad WEED_EC_GEOMETRY kills the master at startup
        self.ec_policy = GeometryPolicy.from_env()
        # the pruner's period, as the reference's maintenance daemon
        self.maintenance_interval_seconds = max(pulse_seconds, 0.05)
        self.metrics = metrics_mod.Registry("master")
        # handlers run on many threads: the topology is touched under
        # _lock, and growth (which calls volume servers, whose heartbeats
        # take _lock) is serialized by _grow_lock without holding _lock
        self._lock = threading.RLock()
        self._grow_lock = threading.Lock()
        self._stop = threading.Event()
        self._maint: Optional[threading.Thread] = None
        self.app = self._build_app()

    def _build_app(self) -> http.App:
        app = http.App()
        app.route("GET", "/dir/assign", self.dir_assign)
        app.route("GET", "/dir/lookup", self.dir_lookup)
        app.route("GET", "/dir/status", self.dir_status)
        app.route("GET", "/vol/grow", self.vol_grow)
        app.route("GET", "/vol/list", self.vol_list)
        app.route("GET", "/col/lookup/ec", self.ec_lookup)
        app.route("POST", "/heartbeat", self.heartbeat)
        app.route("GET", "/cluster/status", self.cluster_status)
        app.route("GET", "/metrics", self.metrics_handler)
        app.route("GET", "/healthz",
                  lambda req: http.json_response({"ok": True}))
        return app

    # --- the dead-node pruner (the reference's maintenance loop,
    #     weed/server/master_server.go:187-257, reduced to pruning) ---
    def start(self) -> None:
        if self._maint is None:
            self._maint = threading.Thread(target=self._maintenance_loop,
                                           name="master-prune", daemon=True)
            self._maint.start()

    def stop(self) -> None:
        self._stop.set()
        if self._maint is not None:
            self._maint.join()
            self._maint = None

    def _maintenance_loop(self) -> None:
        while not self._stop.wait(self.maintenance_interval_seconds):
            with self._lock:
                pruned = self.topology.prune_dead_nodes()
            for ev in pruned:
                self.metrics.count("dead_nodes_pruned")
                log.info("pruned dead node %s", ev["url"])

    # --- handlers ---
    def dir_assign(self, req: http.Request) -> http.Response:
        """Assign a write target (dirAssignHandler,
        weed/server/master_server_handlers.go:96-150)."""
        self.metrics.count("assign")
        q = req.query
        try:
            count = int(q.get("count", 1))
        except ValueError:
            return http.json_response({"error": "invalid count"}, 400)
        resp, status = self.assign_api(
            count=count,
            collection=q.get("collection", ""),
            replication=q.get("replication", self.default_replication),
            ttl=q.get("ttl", ""),
            data_center=q.get("dataCenter", ""))
        return http.json_response(resp, status)

    def assign_api(self, count: int = 1, collection: str = "",
                   replication: str = "", ttl: str = "",
                   data_center: str = "") -> tuple[dict, int]:
        if count < 1:
            # a negative count would roll the sequencer backwards
            return {"error": "invalid count"}, 400
        if count > MAX_ASSIGN_COUNT:
            return {"error": f"count exceeds {MAX_ASSIGN_COUNT}"}, 400
        replication = replication or self.default_replication
        with self._lock:
            picked = self.topology.pick_for_write(collection, replication,
                                                  ttl)
        if picked is None:
            with self._grow_lock:
                with self._lock:
                    picked = self.topology.pick_for_write(
                        collection, replication, ttl)
                if picked is None:
                    if not self._grow(1, collection, replication, ttl,
                                      data_center):
                        return ({"error":
                                 "no writable volumes and cannot grow"},
                                500)
                    with self._lock:
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

    def dir_lookup(self, req: http.Request) -> http.Response:
        q = req.query
        vid_str = q.get("volumeId", q.get("fileId", ""))
        try:
            vid = (FileId.parse(vid_str).volume_id if "," in vid_str
                   else int(vid_str))
        except ValueError:
            return http.json_response(
                {"error": "invalid fileId" if "," in vid_str
                 else "invalid volumeId"}, 400)
        with self._lock:
            nodes = self.topology.lookup(vid, q.get("collection", ""))
            if not nodes:
                # EC volumes are located through the shard registry
                urls: list[str] = []
                for nlist in self.topology.lookup_ec_shards(vid).values():
                    for n in nlist:
                        if n.url not in urls:
                            urls.append(n.url)
                if urls:
                    return http.json_response({
                        "volumeId": str(vid),
                        "locations": [{"url": u, "publicUrl": u}
                                      for u in urls],
                        "ec": True})
                return http.json_response(
                    {"volumeId": str(vid), "error": "volume not found"},
                    404)
            return http.json_response({
                "volumeId": str(vid),
                "locations": [{"url": n.url, "publicUrl": n.public_url}
                              for n in nodes]})

    def dir_status(self, req: http.Request) -> http.Response:
        with self._lock:
            d = self.topology.to_dict()
        d["ec_geometry"] = self.ec_policy.to_dict()
        return http.json_response(d)

    def vol_grow(self, req: http.Request) -> http.Response:
        q = req.query
        try:
            count = int(q.get("count", 1))
        except ValueError:
            return http.json_response({"error": "invalid count"}, 400)
        if count < 1:
            return http.json_response({"error": "invalid count"}, 400)
        with self._grow_lock:
            grown = self._grow(
                count, q.get("collection", ""),
                q.get("replication", self.default_replication),
                q.get("ttl", ""), q.get("dataCenter", ""))
        if not grown:
            return http.json_response({"error": "growth failed"}, 500)
        return http.json_response({"count": len(grown),
                                   "volume_ids": grown})

    def _grow(self, count: int, collection: str, replication: str,
              ttl: str, data_center: str = "") -> list[int]:
        """AutomaticGrowByType (weed/topology/volume_growth.go:70-208):
        pick placement-satisfying nodes, allocate on each. The caller
        holds _grow_lock; _lock is released while the volume servers are
        called (their allocation heartbeat lands here first)."""
        grown: list[int] = []
        for _ in range(count):
            with self._lock:
                nodes = self.topology.find_empty_slots(replication,
                                                       data_center)
                if not nodes:
                    break
                vid = self.topology.next_volume_id()
            ok = True
            for node in nodes:
                try:
                    status, body = http.post_json(
                        f"http://{node.url}/admin/assign_volume",
                        {"volume_id": vid, "collection": collection,
                         "replication": replication, "ttl": ttl},
                        timeout=10)
                except OSError as e:
                    log.warning("allocate %d on %s failed: %s", vid,
                                node.url, e)
                    status, body = 0, {}
                if status != 200:
                    log.warning("allocate %d on %s: %s %s", vid, node.url,
                                status, body.get("error", ""))
                    ok = False
                    break
            if ok:
                grown.append(vid)
                self.metrics.count("volumes_grown")
        return grown

    def vol_list(self, req: http.Request) -> http.Response:
        """VolumeList (weed/server/master_grpc_server_volume.go:117)."""
        with self._lock:
            return http.json_response({
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

    def ec_lookup(self, req: http.Request) -> http.Response:
        """LookupEcVolume (weed/server/master_grpc_server_volume.go:148)."""
        try:
            vid = int(req.query.get("volumeId", ""))
        except ValueError:
            return http.json_response({"error": "invalid volumeId"}, 400)
        with self._lock:
            shards = self.topology.lookup_ec_shards(vid)
            if not shards:
                return http.json_response({"error": "ec volume not found"},
                                          404)
            return http.json_response({
                "volumeId": vid,
                "shards": {str(sid): [n.url for n in nodes]
                           for sid, nodes in shards.items()}})

    def heartbeat(self, req: http.Request) -> http.Response:
        """Heartbeat intake (weed/server/master_grpc_server.go:20-176).
        Body: {node_id, url, public_url, data_center, rack,
               max_volume_count, max_file_key, volumes, ec_shards}."""
        self.metrics.count("heartbeat")
        return http.json_response(self.apply_heartbeat(req.json()))

    def apply_heartbeat(self, body: dict) -> dict:
        with self._lock:
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

    def cluster_status(self, req: http.Request) -> http.Response:
        with self._lock:
            topo = self.topology.to_dict()
        return http.json_response({
            "is_leader": True, "leader": self.url, "peers": [],
            "raft_term": 0, "topology": topo})

    def metrics_handler(self, req: http.Request) -> http.Response:
        return http.Response(
            (self.metrics.render() + metrics_mod.render_shared()).encode(),
            content_type="text/plain; charset=utf-8")


def run_master(host: str = "127.0.0.1", port: int = 0,
               **kwargs) -> tuple[MasterServer, http.Server]:
    """Serve a master on host:port (0 picks a free port); returns the
    master and its server. Stop with ``master.stop()`` and
    ``server.shutdown()``."""
    master = MasterServer(**kwargs)
    server = http.serve(master.app, host, port)
    master.url = master.url or server.url
    master.start()
    log.info("master listening on %s", server.url)
    return master, server
