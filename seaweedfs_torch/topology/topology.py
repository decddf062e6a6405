"""Master topology: DC -> rack -> node tree, volume layouts, placement.

The port's reduced copy of seaweedfs_tpu/topology/topology.py (upstream
weed/topology/): node registration from heartbeats, per-(collection,
replication, ttl) volume layouts with writable tracking, replica-
placement-constrained volume growth, and the EC shard registry. The
planner logic is pure (no sockets), and the per-volume access heat
(``merge_heat``, ``heat_view``) is what the lifecycle daemon plans on. A
volume re-reported under another replica placement leaves its old
layout, which the reference's does not.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Optional

from ..lifecycle.heat import VolumeHeat
from ..storage.superblock import ReplicaPlacement


@dataclass
class VolumeInfo:
    id: int
    collection: str = ""
    size: int = 0
    file_count: int = 0
    delete_count: int = 0
    deleted_bytes: int = 0
    read_only: bool = False
    replica_placement: str = "000"
    ttl: str = ""
    version: int = 3
    # unix seconds of the newest write, for master-side TTL expiry
    last_modified: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "VolumeInfo":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})


@dataclass
class EcShardInfo:
    id: int
    collection: str = ""
    shard_ids: list[int] = field(default_factory=list)
    shard_size: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "EcShardInfo":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})


class DataNode:
    def __init__(self, node_id: str, url: str, public_url: str,
                 data_center: str, rack: str, max_volume_count: int,
                 last_seen: Optional[float] = None):
        self.id = node_id
        self.url = url
        self.public_url = public_url or url
        self.data_center = data_center
        self.rack = rack
        self.max_volume_count = max_volume_count
        self.volumes: dict[int, VolumeInfo] = {}
        self.ec_shards: dict[int, EcShardInfo] = {}
        # per-volume access heat, merged from heartbeat deltas
        # (lifecycle/heat.py); first_seen anchors idleness for volumes
        # that have never been accessed since this master booted
        self.heat: dict[int, VolumeHeat] = {}
        self.last_seen = last_seen if last_seen is not None else time.time()

    def free_slots(self) -> int:
        # EC shards consume fractional slots (TotalShards per volume-equivalent)
        ec_equiv = sum(len(s.shard_ids) for s in self.ec_shards.values())
        return self.max_volume_count - len(self.volumes) - (ec_equiv + 13) // 14

    def to_dict(self) -> dict:
        return {
            "id": self.id, "url": self.url, "public_url": self.public_url,
            "data_center": self.data_center, "rack": self.rack,
            "max_volume_count": self.max_volume_count,
            "volume_count": len(self.volumes),
            "ec_shard_count": sum(len(s.shard_ids)
                                  for s in self.ec_shards.values()),
            "free_slots": self.free_slots(),
            "volumes": [vars(v) for v in self.volumes.values()],
            "ec_shards": [vars(s) for s in self.ec_shards.values()],
        }


def _layout_key(collection: str, replication: str, ttl: str) -> tuple:
    return (collection, replication, ttl)


class VolumeLayout:
    """Writable/readonly tracking per (collection, replication, ttl)
    (weed/topology/volume_layout.go)."""

    def __init__(self, replication: str, ttl: str,
                 volume_size_limit: int):
        self.replication = replication
        self.ttl = ttl
        self.volume_size_limit = volume_size_limit
        self.locations: dict[int, list[DataNode]] = {}
        self.writable: set[int] = set()
        # volumes mid-vacuum: heartbeats must not re-add them to writable
        self.vacuuming: set[int] = set()

    def register(self, vinfo: VolumeInfo, node: DataNode) -> None:
        nodes = self.locations.setdefault(vinfo.id, [])
        if node not in nodes:
            nodes.append(node)
        rp = ReplicaPlacement.parse(vinfo.replica_placement)
        enough_copies = len(nodes) >= rp.copy_count()
        if (not vinfo.read_only and vinfo.size < self.volume_size_limit
                and enough_copies and vinfo.id not in self.vacuuming):
            self.writable.add(vinfo.id)
        elif vinfo.read_only or vinfo.size >= self.volume_size_limit:
            self.writable.discard(vinfo.id)

    def unregister(self, vid: int, node: DataNode) -> None:
        nodes = self.locations.get(vid, [])
        if node in nodes:
            nodes.remove(node)
        if not nodes:
            self.locations.pop(vid, None)
            self.writable.discard(vid)
        else:
            rp_needed = ReplicaPlacement.parse(self.replication).copy_count()
            if len(nodes) < rp_needed:
                self.writable.discard(vid)

    def pick_for_write(self) -> Optional[tuple[int, list[DataNode]]]:
        if not self.writable:
            return None
        vid = random.choice(sorted(self.writable))
        return vid, self.locations[vid]


class Topology:
    def __init__(self, volume_size_limit: int = 30 * 1024 * 1024 * 1024,
                 pulse_seconds: float = 5.0, clock=None):
        self.nodes: dict[str, DataNode] = {}
        self.layouts: dict[tuple, VolumeLayout] = {}
        self.volume_size_limit = volume_size_limit
        self.pulse_seconds = pulse_seconds
        self.max_volume_id = 0
        # injectable clock: every liveness and heat timestamp flows
        # through it
        self._clock = clock if clock is not None else time.time

    # --- registration (heartbeat intake,
    #     weed/server/master_grpc_server.go:20-176) ---
    def register_heartbeat(self, node_id: str, url: str, public_url: str,
                           data_center: str, rack: str,
                           max_volume_count: int, payload: dict) -> dict:
        """Apply one heartbeat; returns the location delta event
        ({url, public_url, new_vids, deleted_vids}) that KeepConnected
        subscribers should receive (master_grpc_server.go:60-140 builds the
        same VolumeLocation message from the incremental heartbeat)."""
        node = self.nodes.get(node_id)
        if node is None:
            node = DataNode(node_id, url, public_url, data_center or "DefaultDataCenter",
                            rack or "DefaultRack", max_volume_count,
                            last_seen=self._clock())
            self.nodes[node_id] = node
        node.last_seen = self._clock()
        node.max_volume_count = max_volume_count
        before = set(node.volumes) | set(node.ec_shards)

        new_volumes = {}
        for vd in payload.get("volumes", []):
            vi = VolumeInfo.from_dict(vd)
            new_volumes[vi.id] = vi
            self.max_volume_id = max(self.max_volume_id, vi.id)
        # unregister volumes that disappeared, and volumes whose replica
        # placement was rewritten (volume.configure.replication): the old
        # layout must not go on listing this node (the reference keeps
        # it, ROADMAP Queue 3, F2)
        for vid in list(node.volumes):
            old = node.volumes[vid]
            vi = new_volumes.get(vid)
            if vi is None:
                node.volumes.pop(vid)
            if vi is None or vi.replica_placement != old.replica_placement:
                self._layout_for(old.collection, old.replica_placement,
                                 old.ttl).unregister(vid, node)
        for vi in new_volumes.values():
            node.volumes[vi.id] = vi
            self._layout_for(vi.collection, vi.replica_placement,
                             vi.ttl).register(vi, node)

        node.ec_shards = {}
        for sd in payload.get("ec_shards", []):
            si = EcShardInfo.from_dict(sd)
            node.ec_shards[si.id] = si
            self.max_volume_id = max(self.max_volume_id, si.id)

        after = set(node.volumes) | set(node.ec_shards)
        # heat bookkeeping: every held volume has a record (first_seen
        # anchors idleness); deltas arrive only for changed volumes, so
        # the merge is O(changed); records of departed volumes go
        born = self._clock()
        for vid in after:
            if vid not in node.heat:
                node.heat[vid] = VolumeHeat(first_seen=born, updated=born)
        for vid in [v for v in node.heat if v not in after]:
            node.heat.pop(vid, None)
        self.merge_heat(node.url, payload.get("heat", []))
        return {"url": node.url, "public_url": node.public_url,
                "new_vids": sorted(after - before),
                "deleted_vids": sorted(before - after)}

    def unregister_node(self, node_id: str) -> Optional[dict]:
        """Remove a node; returns the deleted-locations delta event
        (the DeletedVids broadcast on stream loss,
        master_grpc_server.go:22-49)."""
        node = self.nodes.pop(node_id, None)
        if node is None:
            return None
        for vid, vi in node.volumes.items():
            self._layout_for(vi.collection, vi.replica_placement,
                             vi.ttl).unregister(vid, node)
        gone = sorted(set(node.volumes) | set(node.ec_shards))
        return {"url": node.url, "public_url": node.public_url,
                "new_vids": [], "deleted_vids": gone}

    def prune_dead_nodes(self, timeout: Optional[float] = None
                         ) -> list[dict]:
        timeout = timeout or self.pulse_seconds * 5
        now = self._clock()
        dead = [nid for nid, n in self.nodes.items()
                if now - n.last_seen > timeout]
        events = []
        for nid in dead:
            node = self.nodes.get(nid)
            ev = self.unregister_node(nid)
            if ev:
                events.append(ev)
            # the pruned node's decayed rates go with it: a planner that
            # kept last pass's node objects must not rank a dead node
            if node is not None:
                node.heat.clear()
        return events

    def _layout_for(self, collection: str, replication: str,
                    ttl: str) -> VolumeLayout:
        key = _layout_key(collection, replication, ttl)
        layout = self.layouts.get(key)
        if layout is None:
            layout = VolumeLayout(replication, ttl, self.volume_size_limit)
            self.layouts[key] = layout
        return layout

    # --- lookup ---
    def lookup(self, vid: int, collection: str = "") -> list[DataNode]:
        found: list[DataNode] = []
        for key, layout in self.layouts.items():
            if collection and key[0] != collection:
                continue
            nodes = layout.locations.get(vid)
            if nodes:
                for n in nodes:
                    if n not in found:
                        found.append(n)
        return found

    def lookup_ec_shards(self, vid: int) -> dict[int, list[DataNode]]:
        """shard id -> nodes (weed/topology/topology_ec.go:20)."""
        out: dict[int, list[DataNode]] = {}
        for node in self.nodes.values():
            info = node.ec_shards.get(vid)
            if info is None:
                continue
            for sid in info.shard_ids:
                out.setdefault(sid, []).append(node)
        return out

    # --- heat (the lifecycle plane) ---
    def merge_heat(self, url: str, entries: list) -> bool:
        """Fold heat deltas into a node's records. Unknown nodes and
        volumes are ignored: the next full heartbeat establishes them."""
        node = self.nodes.get(url)
        if node is None:
            return False
        now = self._clock()
        for entry in entries:
            vh = node.heat.get(entry.get("id"))
            if vh is not None:
                vh.merge(entry, now)
        return True

    def heat_view(self, now: Optional[float] = None) -> dict[int, dict]:
        """Cluster-wide per-volume heat, aggregated across holders:
        counts sum (each replica saw distinct requests), last_access is
        the max, read_rate sums (load spreads over replicas), first_seen
        is the earliest sighting. Every registered node counts (the
        lifecycle policy evaluates idleness far in the future); the
        balancer ranks live nodes only (balance/planner.node_rates)."""
        now = now if now is not None else self._clock()
        out: dict[int, dict] = {}
        for node in self.nodes.values():
            for vid, vh in node.heat.items():
                d = vh.to_dict(now)
                agg = out.get(vid)
                if agg is None:
                    out[vid] = d
                else:
                    agg["reads"] += d["reads"]
                    agg["writes"] += d["writes"]
                    agg["last_access"] = max(agg["last_access"],
                                             d["last_access"])
                    agg["read_rate"] = round(agg["read_rate"]
                                             + d["read_rate"], 6)
                    agg["first_seen"] = min(agg["first_seen"],
                                            d["first_seen"])
        return out

    # --- write assignment ---
    def pick_for_write(self, collection: str, replication: str,
                       ttl: str) -> Optional[tuple[int, list[DataNode]]]:
        return self._layout_for(collection, replication, ttl).pick_for_write()

    def next_volume_id(self) -> int:
        self.max_volume_id += 1
        return self.max_volume_id

    # --- growth (weed/topology/volume_growth.go:113-208) ---
    def find_empty_slots(self, replication: str,
                         data_center: str = "",
                         heat_rank: Optional[dict] = None
                         ) -> list[DataNode]:
        """Pick copy_count nodes satisfying the XYZ placement constraints.
        Returns [] if impossible. ``heat_rank`` (node id -> heat score,
        balance/planner.node_rates) tries the coldest candidates first,
        then those with the most free slots, then by id, instead of a
        shuffle; the placement constraints apply either way."""
        rp = ReplicaPlacement.parse(replication)
        candidates = [n for n in self.nodes.values() if n.free_slots() > 0
                      and (not data_center or n.data_center == data_center)]
        if not candidates:
            return []
        if heat_rank is not None:
            candidates.sort(key=lambda n: (heat_rank.get(n.id, 0.0),
                                           -n.free_slots(), n.id))
        else:
            random.shuffle(candidates)
        for main in candidates:
            picked = [main]
            used_nodes = {main.id}
            # same rack
            same_rack = [n for n in candidates
                         if n.data_center == main.data_center
                         and n.rack == main.rack and n.id not in used_nodes]
            if len(same_rack) < rp.same_rack_count:
                continue
            for n in same_rack[:rp.same_rack_count]:
                picked.append(n)
                used_nodes.add(n.id)
            # other racks, same DC — one node per distinct rack
            racks_seen = set()
            chosen_or = []
            for n in candidates:
                if len(chosen_or) >= rp.diff_rack_count:
                    break
                if (n.data_center != main.data_center or n.rack == main.rack
                        or n.id in used_nodes or n.rack in racks_seen):
                    continue
                racks_seen.add(n.rack)
                chosen_or.append(n)
            if len(chosen_or) < rp.diff_rack_count:
                continue
            for n in chosen_or:
                picked.append(n)
                used_nodes.add(n.id)
            # other DCs — one node per distinct DC
            dcs_seen = set()
            chosen_dc = []
            for n in candidates:
                if len(chosen_dc) >= rp.diff_data_center_count:
                    break
                if (n.data_center == main.data_center
                        or n.id in used_nodes
                        or n.data_center in dcs_seen):
                    continue
                dcs_seen.add(n.data_center)
                chosen_dc.append(n)
            if len(chosen_dc) < rp.diff_data_center_count:
                continue
            picked.extend(chosen_dc)
            return picked
        return []

    def to_dict(self) -> dict:
        return {
            "max_volume_id": self.max_volume_id,
            "volume_size_limit": self.volume_size_limit,
            "nodes": [n.to_dict() for n in self.nodes.values()],
            "Topology": self.tree(),
        }

    def tree(self) -> dict:
        """DC -> rack -> node aggregation with up-summed counters
        (the reference's node hierarchy, weed/topology/node.go:16-47,
        data_center.go, rack.go: volumeCount / maxVolumeCount /
        ecShardCount aggregate at every level)."""
        def node_stats(n: DataNode) -> dict:
            return {"volume_count": len(n.volumes),
                    "max_volume_count": n.max_volume_count,
                    "ec_shard_count": sum(len(s.shard_ids)
                                          for s in n.ec_shards.values()),
                    "free_slots": n.free_slots()}

        dcs: dict[str, dict] = {}
        for n in self.nodes.values():
            dc = dcs.setdefault(n.data_center, {"racks": {}})
            rack = dc["racks"].setdefault(n.rack, {"nodes": {}})
            rack["nodes"][n.id] = node_stats(n)

        def aggregate(children: dict) -> dict:
            out = {"volume_count": 0, "max_volume_count": 0,
                   "ec_shard_count": 0, "free_slots": 0}
            for c in children.values():
                for k in out:
                    out[k] += c[k]
            return out

        for dc in dcs.values():
            for rack in dc["racks"].values():
                rack.update(aggregate(rack["nodes"]))
            dc.update(aggregate(dc["racks"]))
        total = aggregate(dcs) if dcs else {
            "volume_count": 0, "max_volume_count": 0,
            "ec_shard_count": 0, "free_slots": 0}
        total["data_centers"] = dcs
        return total
