"""gRPC face of the master (weed/server/master_grpc_server*.go).

The port's copy of seaweedfs_tpu/server/master_grpc.py. It serves the
Master service of proto/master.proto on the master's gRPC port (HTTP
port + 10000 by convention): assign and lookup, the bidirectional
heartbeat stream (a dropped stream unregisters the node and broadcasts
its DeletedVids at once, master_grpc_server.go:22-49), the KeepConnected
location push, the admin lease, and the admin listings. Every handler
goes through the same MasterServer internals as the HTTP surface: a beat
through ``apply_heartbeat`` (the ``/heartbeat`` intake), KeepConnected
off the subscriber queues of ``/cluster/watch`` (a snapshot, then the
deltas, each with the leader hint; a follower answers with the leader
alone).

The port's master has no ``/col/delete`` yet (ROADMAP Queue 1 A.4), so
``CollectionDelete`` runs the reference's deletion here: every holder's
volumes and shards of the collection through its ``/admin`` API, the
layouts dropped, the volumes retired from the replicated registry.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

import aiohttp

from ..ec import shard_bits
from ..pb import master_pb2 as pb
from ..pb import rpc

log = logging.getLogger("master.grpc")


def _hb_to_dict(req: pb.HeartbeatRequest) -> dict:
    return {
        "node_id": req.node_id,
        "url": req.url,
        "public_url": req.public_url or req.url,
        "data_center": req.data_center,
        "rack": req.rack,
        "max_volume_count": req.max_volume_count or 8,
        "max_file_key": req.max_file_key,
        "volumes": [{
            "id": v.id, "collection": v.collection, "size": v.size,
            "file_count": v.file_count, "delete_count": v.delete_count,
            "deleted_bytes": v.deleted_bytes, "read_only": v.read_only,
            "replica_placement": v.replica_placement or "000",
            "ttl": v.ttl, "version": v.version or 3,
        } for v in req.volumes],
        "ec_shards": [{
            "id": s.id, "collection": s.collection,
            "shard_ids": shard_bits.to_ids(s.ec_index_bits),
            "shard_size": s.shard_size,
        } for s in req.ec_shards],
    }


def heartbeat_to_pb(payload: dict) -> pb.HeartbeatRequest:
    """A store's heartbeat dict -> the wire message (client side)."""
    return pb.HeartbeatRequest(
        node_id=payload["node_id"],
        url=payload["url"],
        public_url=payload.get("public_url", ""),
        data_center=payload.get("data_center", ""),
        rack=payload.get("rack", ""),
        max_volume_count=payload.get("max_volume_count", 8),
        max_file_key=payload.get("max_file_key", 0),
        volumes=[pb.VolumeInformation(
            id=v["id"], collection=v.get("collection", ""),
            size=v.get("size", 0), file_count=v.get("file_count", 0),
            delete_count=v.get("delete_count", 0),
            deleted_bytes=v.get("deleted_bytes", 0),
            read_only=v.get("read_only", False),
            replica_placement=str(v.get("replica_placement", "000")),
            ttl=str(v.get("ttl", "")), version=v.get("version", 3),
        ) for v in payload.get("volumes", [])],
        ec_shards=[pb.EcShardInformation(
            id=s["id"], collection=s.get("collection", ""),
            ec_index_bits=shard_bits.from_ids(s.get("shard_ids", [])),
            shard_size=s.get("shard_size", 0),
        ) for s in payload.get("ec_shards", [])])


def collection_names(master) -> list[str]:
    names = set()
    for node in master.topology.nodes.values():
        names.update(v.collection for v in node.volumes.values())
        names.update(s.collection for s in node.ec_shards.values())
    return sorted(names)


async def delete_collection(master, name: str) -> list[str]:
    """Drop every volume and shard of the collection on every holder
    (master_grpc_server_collection.go:55-86); returns the errors."""
    errors = []
    session = master._maint_http()
    for node in list(master.topology.nodes.values()):
        ops = [("volume/delete", {"volume_id": vid}, str(vid))
               for vid, v in node.volumes.items() if v.collection == name]
        ops += [("ec/delete_shards",
                 {"volume_id": vid, "collection": name,
                  "shard_ids": list(s.shard_ids)}, f"ec{vid}")
                for vid, s in node.ec_shards.items()
                if s.collection == name]
        for op, body, label in ops:
            try:
                async with session.post(
                        f"http://{node.url}/admin/{op}", json=body,
                        timeout=aiohttp.ClientTimeout(total=10)) as r:
                    if r.status != 200:
                        errors.append(f"{node.url}/{label}: {r.status}")
            except (aiohttp.ClientError, asyncio.TimeoutError) as e:
                errors.append(f"{node.url}/{label}: {e}")
    # assignment stops routing to the collection
    master.topology.layouts = {k: v for k, v in
                               master.topology.layouts.items()
                               if k[0] != name}
    retired = [vid for vid, rec in master.metalog.volumes.items()
               if rec.get("collection", "") == name]
    if retired and not await master.raft.propose(
            {"volume_retire": {"vids": retired}}):
        errors.append("volume_retire proposal lost leadership")
    return errors


def _locations(nodes) -> list:
    return [pb.Location(url=n.url, public_url=n.public_url) for n in nodes]


class MasterGrpcServicer:
    def __init__(self, master):
        self.master = master

    async def Assign(self, request: pb.AssignRequest, context):
        if not await self.master.ensure_assign_ready():
            return pb.AssignResponse(error="not the leader / not ready")
        resp, status = await self.master.assign_api(
            count=request.count or 1,
            collection=request.collection,
            replication=request.replication,
            ttl=request.ttl,
            data_center=request.data_center)
        if status != 200:
            return pb.AssignResponse(error=resp.get("error", "failed"))
        return pb.AssignResponse(
            fid=resp["fid"], url=resp["url"],
            public_url=resp["publicUrl"], count=resp["count"],
            auth=resp.get("auth", ""), replicas=resp.get("replicas", []))

    async def Lookup(self, request: pb.LookupRequest, context):
        topo = self.master.topology
        if request.file_id:
            from ..storage.file_id import FileId
            try:
                vid = FileId.parse(request.file_id).volume_id
            except ValueError:
                return pb.LookupResponse(error="invalid fileId")
        else:
            vid = request.volume_id
        nodes = topo.lookup(vid, request.collection)
        if nodes:
            return pb.LookupResponse(volume_id=vid,
                                     locations=_locations(nodes))
        shards = topo.lookup_ec_shards(vid)
        if shards:
            holders = {}
            for nlist in shards.values():
                for n in nlist:
                    holders.setdefault(n.url, n)
            return pb.LookupResponse(volume_id=vid, ec=True,
                                     locations=_locations(holders.values()))
        return pb.LookupResponse(volume_id=vid, error="volume not found")

    async def LookupEc(self, request: pb.LookupEcRequest, context):
        shards = self.master.topology.lookup_ec_shards(request.volume_id)
        if not shards:
            return pb.LookupEcResponse(volume_id=request.volume_id,
                                       error="ec volume not found")
        return pb.LookupEcResponse(
            volume_id=request.volume_id,
            shards=[pb.EcShardLocations(shard_id=sid,
                                        locations=_locations(nodes))
                    for sid, nodes in sorted(shards.items())])

    async def Heartbeat(self, request_iterator, context):
        """Beats up, the size limit and the leader down; a dropped
        stream unregisters the node and pushes its DeletedVids."""
        master = self.master
        node_id: Optional[str] = None
        try:
            async for req in request_iterator:
                body = _hb_to_dict(req)
                node_id = body["node_id"]
                master.metrics.count("heartbeat")
                out = master.apply_heartbeat(body)
                yield pb.HeartbeatResponse(
                    volume_size_limit=out["volume_size_limit"],
                    leader=out["leader"])
        finally:
            if node_id is not None:
                master._broadcast_location(
                    master.topology.unregister_node(node_id))
                log.info("heartbeat stream from %s closed; unregistered",
                         node_id)

    async def KeepConnected(self, request: pb.KeepConnectedRequest,
                            context):
        """A snapshot of every node's volumes, then the location deltas
        of the /cluster/watch feed, each with the leader hint. The stream
        ends where a watch stream ends: at a ``resync`` (the subscriber
        fell behind) or at the master's shutdown."""
        master = self.master
        raft = master.raft
        if not raft.is_leader:
            yield pb.VolumeLocationMessage(leader=raft.leader_id or "")
            return
        q: asyncio.Queue = asyncio.Queue(maxsize=master.watch_queue_depth)
        master._watchers.add(q)
        try:
            for node in list(master.topology.nodes.values()):
                yield pb.VolumeLocationMessage(
                    url=node.url, public_url=node.public_url,
                    new_vids=sorted(set(node.volumes) | set(node.ec_shards)),
                    is_snapshot=True, leader=raft.leader_id or "")
            while True:
                msg = await q.get()
                if msg is None or msg.get("type") == "resync":
                    return
                if msg.get("type") != "update":
                    continue    # the filer ring's lines
                yield pb.VolumeLocationMessage(
                    url=msg.get("url", ""),
                    public_url=msg.get("public_url", ""),
                    new_vids=msg.get("new_vids", []),
                    deleted_vids=msg.get("deleted_vids", []),
                    leader=raft.leader_id or "")
        finally:
            master._watchers.discard(q)

    async def ClusterStatus(self, request, context):
        raft = self.master.raft
        return pb.ClusterStatusResponse(
            is_leader=raft.is_leader, leader=raft.leader_id or "",
            peers=raft.peers, raft_term=raft.term)

    async def VolumeList(self, request, context):
        """Every node's inventory (master_grpc_server_volume.go:117)."""
        topo = self.master.topology
        return pb.VolumeListResponse(
            volume_size_limit_mb=topo.volume_size_limit // (1024 * 1024),
            nodes=[pb.NodeVolumes(
                url=n.url, public_url=n.public_url,
                data_center=n.data_center, rack=n.rack,
                max_volume_count=n.max_volume_count,
                volumes=[pb.VolumeInformation(
                    id=v.id, collection=v.collection, size=v.size,
                    file_count=v.file_count, delete_count=v.delete_count,
                    deleted_bytes=v.deleted_bytes, read_only=v.read_only,
                    replica_placement=str(v.replica_placement),
                    ttl=str(v.ttl), version=v.version)
                    for v in n.volumes.values()],
                ec_shards=[pb.EcShardInformation(
                    id=e.id, collection=e.collection,
                    ec_index_bits=shard_bits.from_ids(e.shard_ids),
                    shard_size=e.shard_size)
                    for e in n.ec_shards.values()])
                for n in topo.nodes.values()])

    async def Statistics(self, request, context):
        """Usage, optionally of one collection
        (master_grpc_server_volume.go:176)."""
        topo = self.master.topology
        total = used = files = 0
        for n in topo.nodes.values():
            total += n.max_volume_count * topo.volume_size_limit
            for v in n.volumes.values():
                if request.collection and \
                        v.collection != request.collection:
                    continue
                used += v.size
                files += v.file_count
        return pb.StatisticsResponse(total_size=total, used_size=used,
                                     file_count=files)

    async def CollectionList(self, request, context):
        return pb.CollectionListResponse(
            collections=collection_names(self.master))

    async def CollectionDelete(self, request, context):
        if not request.name:
            # proto3's zero value must not name the default collection,
            # or every unlabelled volume of the cluster would go
            return pb.CollectionDeleteResponse(
                ok=False, error="collection name required")
        errors = await delete_collection(self.master, request.name)
        if errors:
            return pb.CollectionDeleteResponse(ok=False,
                                               error="; ".join(errors))
        return pb.CollectionDeleteResponse(ok=True)

    async def GetMasterConfiguration(self, request, context):
        m = self.master
        return pb.GetMasterConfigurationResponse(
            default_replication=m.default_replication,
            volume_size_limit_mb=m.topology.volume_size_limit
            // (1024 * 1024),
            garbage_threshold=m.garbage_threshold)

    async def LeaseAdminToken(self, request, context):
        resp, status = await self.master.request_admin_lease(
            request.name, request.client, request.previous_token)
        if status != 200:
            return pb.LeaseAdminTokenResponse(error=resp["error"])
        return pb.LeaseAdminTokenResponse(token=resp["token"],
                                          expires_at=resp["expires_at"])

    async def ReleaseAdminToken(self, request, context):
        return pb.ReleaseAdminTokenResponse(
            ok=self.master.release_admin_token(request.name, request.token))


async def serve_master_grpc(master, host: str, port: int):
    """Start the master's grpc.aio server; the caller stops it."""
    server = await rpc.serve(
        rpc.master_service_handler(MasterGrpcServicer(master),
                                   trace_instance=master.url), host, port)
    log.info("master gRPC on %s:%d", host, port)
    return server
