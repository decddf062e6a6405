"""EC lifecycle admin commands: ec.encode / ec.rebuild / ec.balance planners.

The port's copy of seaweedfs_tpu/shell/ec_commands.py, whole (upstream
weed/shell/command_ec_encode.go, command_ec_rebuild.go,
command_ec_balance.go, command_ec_common.go). The planning logic is pure
(testable with fake topologies, like upstream's command_ec_test.go
dry-run pattern); execution drives the volume servers' admin API through
the Client, under the master's admin lock (client.AdminLock), so that the
master's repair and lifecycle daemons keep away from a move in progress.
"""

from __future__ import annotations

import functools
import logging
from dataclasses import dataclass, field

from ..client import Client, ClientError
from ..ec.geometry import DEFAULT, Geometry, GeometryPolicy

log = logging.getLogger("shell.ec")


@dataclass
class EcNode:
    """A volume server as seen by the EC planners."""
    url: str
    free_slots: int
    shards: dict[int, list[int]] = field(default_factory=dict)  # vid->shards

    def shard_count(self) -> int:
        return sum(len(s) for s in self.shards.values())


def collect_ec_nodes(topology: dict) -> list[EcNode]:
    nodes = []
    for nd in topology.get("nodes", []):
        shards = {int(s["id"]): list(s["shard_ids"])
                  for s in nd.get("ec_shards", [])}
        nodes.append(EcNode(url=nd["url"], free_slots=nd.get("free_slots", 0),
                            shards=shards))
    return nodes


def plan_shard_spread(nodes: list[EcNode], total_shards: int,
                      source_url: str) -> dict[str, list[int]]:
    """Balanced spread of shard ids across nodes (balancedEcDistribution,
    weed/shell/command_ec_encode.go:248-263): repeatedly give the next shard
    to the node with the fewest allocated shards (free slots permitting)."""
    if not nodes:
        return {source_url: list(range(total_shards))}
    alloc: dict[str, list[int]] = {n.url: [] for n in nodes}
    counts = {n.url: n.shard_count() for n in nodes}
    for sid in range(total_shards):
        url = min(alloc, key=lambda u: (counts[u] + len(alloc[u])))
        alloc[url].append(sid)
    return {u: sids for u, sids in alloc.items() if sids}


def plan_rebuild(nodes: list[EcNode], vid: int,
                 total_shards: int) -> tuple[str, list[int], dict[str, list[int]]]:
    """Pick a rebuilder and what to copy (rebuildOneEcVolume,
    weed/shell/command_ec_rebuild.go:130-247).

    Returns (rebuilder_url, missing_shard_ids, copy_plan source->shards)."""
    holders = [n for n in nodes if vid in n.shards]
    if not holders:
        raise ValueError(f"no shards found for volume {vid}")
    existing = sorted({sid for n in holders for sid in n.shards[vid]})
    missing = [sid for sid in range(total_shards) if sid not in existing]
    if not missing:
        return "", [], {}
    # rebuilder: the holder with the most local shards (fewest copies needed)
    rebuilder = max(holders, key=lambda n: len(n.shards[vid]))
    local = set(rebuilder.shards[vid])
    copy_plan: dict[str, list[int]] = {}
    for n in holders:
        if n.url == rebuilder.url:
            continue
        for sid in n.shards[vid]:
            if sid not in local:
                copy_plan.setdefault(n.url, []).append(sid)
                local.add(sid)
    return rebuilder.url, missing, copy_plan


def plan_balance(nodes: list[EcNode],
                 total_shards: int) -> list[tuple[int, int, str, str]]:
    """Moves to even out shard counts (command_ec_balance.go, simplified to
    node-level balancing). Returns [(vid, shard_id, from_url, to_url)].
    Never places two copies of one shard on a node; prefers spreading one
    volume's shards across distinct nodes."""
    moves = []
    if len(nodes) < 2:
        return moves
    by_url = {n.url: n for n in nodes}
    changed = True
    while changed:
        changed = False
        counts = {u: n.shard_count() for u, n in by_url.items()}
        hi = max(counts, key=counts.get)
        lo = min(counts, key=counts.get)
        if counts[hi] - counts[lo] <= 1:
            break
        src, dst = by_url[hi], by_url[lo]
        for vid, sids in sorted(src.shards.items()):
            movable = [s for s in sids
                       if s not in dst.shards.get(vid, [])]
            if movable:
                sid = movable[0]
                sids.remove(sid)
                if not sids:
                    del src.shards[vid]
                dst.shards.setdefault(vid, []).append(sid)
                moves.append((vid, sid, src.url, dst.url))
                changed = True
                break
    return moves


def _under_admin_lock(fn):
    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        with self.client.admin_lock:
            return fn(self, *args, **kwargs)
    return run


class EcCommands:
    """Executors driving the cluster through the admin HTTP API.

    Geometry resolution: an explicit non-default `geometry` pins every
    plan (shrunk-geometry tests); otherwise plans follow the MASTER's
    per-collection policy (WEED_EC_GEOMETRY, served in /dir/status) —
    the plumbing that lets an `archive` collection ride RS(20,4) while
    `media` stays RS(10,4), each plan sized to its own shard count."""

    def __init__(self, client: Client, geometry: Geometry = DEFAULT):
        self.client = client
        self.g = geometry
        self._policy: "GeometryPolicy | None" = None

    def geometry_for(self, collection: str = "",
                     status: "dict | None" = None) -> Geometry:
        """status: an already-fetched /dir/status document, so callers
        that need both the topology and the policy pay ONE round trip."""
        if self.g is not None and self.g != DEFAULT:
            return self.g  # explicit pin wins
        if self._policy is None:
            if status is None:
                try:
                    status = self.client.dir_status()
                except ClientError:
                    # transient fetch failure: answer the default but do
                    # NOT cache — the next command (often holding a
                    # fresh status) must still learn the real policy
                    return GeometryPolicy().for_collection(collection)
            try:
                self._policy = GeometryPolicy.from_dict(
                    status.get("ec_geometry") or {})
            except ValueError:
                # the master SPOKE but the document is malformed: cache
                # the default (re-fetching the same garbage won't help)
                self._policy = GeometryPolicy()
        return self._policy.for_collection(collection)

    def _topology_nodes(self,
                        status: "dict | None" = None) -> list[EcNode]:
        return collect_ec_nodes(status if status is not None
                                else self.client.dir_status())

    def encode(self, vid: int, collection: str = "",
               apply: bool = True, fused: bool = False) -> dict:
        """ec.encode one volume (doEcEncode, command_ec_encode.go:92-158):
        mark readonly -> generate on source -> spread -> mount -> delete
        original. fused=True runs the one-pass warm-down instead of a
        plain encode: the source compacts + gzips + encodes + digests in
        a single governed pass (ec/fused), so the shard set holds the
        compacted volume and no vacuum needs to precede the encode."""
        return self.encode_many([vid], collection, apply=apply,
                                fused=fused)

    @_under_admin_lock
    def encode_many(self, vids: list[int], collection: str = "",
                    apply: bool = True, parallel: int = 1,
                    fused: bool = False) -> dict:
        """ec.encode a WINDOW of volumes: every volume sharing a source
        is generated in ONE multi-volume `ec/generate` call, so the
        volume server streams the batch through a single governed
        executable back-to-back (the encode-queue regime) — then each
        volume spreads/mounts/retires individually.

        `parallel` > 1 drives up to that many SOURCES concurrently
        (each source's generate -> spread -> retire chain stays
        strictly ordered; per-source windows already batch, so the only
        safe parallel axis is across servers — the same axis the
        master's WEED_EC_ENCODE_WORKERS pool fans rebuilds over)."""
        status = self.client.dir_status()
        g = self.geometry_for(collection, status=status)
        locations = {vid: self.client.lookup(vid) for vid in vids}
        sources: dict[str, list[int]] = {}
        for vid in vids:
            sources.setdefault(locations[vid][0], []).append(vid)
        nodes = self._topology_nodes(status)
        plans = {vid: plan_shard_spread(nodes, g.total_shards,
                                        locations[vid][0])
                 for vid in vids}
        if not apply:
            if len(vids) == 1:
                return {"source": locations[vids[0]][0],
                        "plan": plans[vids[0]]}
            return {"sources": sources, "plans": plans,
                    "geometry": f"{g.data_shards}+{g.parity_shards}"}

        for vid in vids:
            for url in locations[vid]:
                self.client.volume_admin(url, "volume/readonly",
                                         {"volume_id": vid,
                                          "read_only": True})

        def run_source(source: str, svids: list[int]) -> None:
            self.client.volume_admin(
                source, "ec/fused" if fused else "ec/generate",
                {"volume_id": svids[0]} if len(svids) == 1
                else {"volume_ids": svids})
            for vid in svids:
                plan = plans[vid]
                for target, sids in plan.items():
                    if target != source:
                        self.client.volume_admin(
                            target, "ec/copy",
                            {"volume_id": vid, "collection": collection,
                             "shard_ids": sids, "source": source,
                             "copy_ecx_file": True})
                    self.client.volume_admin(
                        target, "ec/mount",
                        {"volume_id": vid, "collection": collection,
                         "shard_ids": sids})
                # delete the original everywhere + surplus at source
                for url in locations[vid]:
                    self.client.volume_admin(url, "volume/delete",
                                             {"volume_id": vid})
                surplus = [s for s in range(g.total_shards)
                           if s not in plan.get(source, [])]
                if surplus:
                    self.client.volume_admin(
                        source, "ec/delete_shards",
                        {"volume_id": vid, "collection": collection,
                         "shard_ids": surplus})

        workers = max(1, min(int(parallel or 1), len(sources)))
        if workers > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(
                    max_workers=workers,
                    thread_name_prefix="ec-encode") as ex:
                futures = [ex.submit(run_source, s, sv)
                           for s, sv in sources.items()]
                # surface the FIRST failure after every source settles:
                # cancelling mid-flight sources would strand sealed
                # volumes shards-less with no record of which
                errors = [f.exception() for f in futures]
            first = next((e for e in errors if e is not None), None)
            if first is not None:
                raise first
        else:
            for source, svids in sources.items():
                run_source(source, svids)
        if len(vids) == 1:
            return {"source": locations[vids[0]][0],
                    "plan": plans[vids[0]]}
        return {"sources": sources, "plans": plans,
                "parallel": workers}

    @_under_admin_lock
    def rebuild(self, vid: int, collection: str = "",
                apply: bool = True) -> dict:
        status = self.client.dir_status()
        rebuilder, missing, copy_plan = plan_rebuild(
            self._topology_nodes(status), vid,
            self.geometry_for(collection, status=status).total_shards)
        if not missing:
            return {"rebuilt": [], "rebuilder": None}
        if not apply:
            return {"rebuilder": rebuilder, "missing": missing,
                    "copy_plan": copy_plan}
        copied: list[int] = []
        for src, sids in copy_plan.items():
            self.client.volume_admin(
                rebuilder, "ec/copy",
                {"volume_id": vid, "collection": collection,
                 "shard_ids": sids, "source": src})
            copied.extend(sids)
        out = self.client.volume_admin(rebuilder, "ec/rebuild",
                                       {"volume_id": vid,
                                        "collection": collection})
        rebuilt = out.get("rebuilt", [])
        self.client.volume_admin(
            rebuilder, "ec/mount",
            {"volume_id": vid, "collection": collection,
             "shard_ids": rebuilt})
        # drop the survivor copies we pulled in just for rebuilding
        if copied:
            self.client.volume_admin(
                rebuilder, "ec/delete_shards",
                {"volume_id": vid, "collection": collection,
                 "shard_ids": copied})
        return {"rebuilder": rebuilder, "rebuilt": rebuilt,
                "copied": copied}

    @_under_admin_lock
    def balance(self, collection: str = "", apply: bool = True) -> list:
        status = self.client.dir_status()
        moves = plan_balance(
            self._topology_nodes(status),
            self.geometry_for(collection, status=status).total_shards)
        if not apply:
            return moves
        for vid, sid, src, dst in moves:
            self.client.volume_admin(
                dst, "ec/copy",
                {"volume_id": vid, "collection": collection,
                 "shard_ids": [sid], "source": src,
                 "copy_ecx_file": True})
            self.client.volume_admin(
                dst, "ec/mount",
                {"volume_id": vid, "collection": collection,
                 "shard_ids": [sid]})
            self.client.volume_admin(
                src, "ec/delete_shards",
                {"volume_id": vid, "collection": collection,
                 "shard_ids": [sid]})
        return moves

    @_under_admin_lock
    def decode(self, vid: int, collection: str = "",
               apply: bool = True) -> dict:
        """ec.decode: collect >=k data shards onto one node, decode to a
        normal volume (command_ec_decode.go:37-273)."""
        info = self.client.ec_lookup(vid)
        shards: dict[int, list[str]] = {
            int(s): urls for s, urls in info.get("shards", {}).items()}
        # choose the node holding the most shards
        holder_count: dict[str, int] = {}
        for sid, urls in shards.items():
            for u in urls:
                holder_count[u] = holder_count.get(u, 0) + 1
        if not holder_count:
            raise ClientError(f"no ec shards for volume {vid}")
        g = self.geometry_for(collection)
        target = max(holder_count, key=holder_count.get)
        need = [sid for sid in range(g.total_shards)
                if sid in shards and target not in shards[sid]]
        if not apply:
            return {"target": target, "copy": need}
        for sid in need:
            self.client.volume_admin(
                target, "ec/copy",
                {"volume_id": vid, "collection": collection,
                 "shard_ids": [sid], "source": shards[sid][0],
                 "copy_ecx_file": False})
        self.client.volume_admin(target, "ec/to_volume",
                                 {"volume_id": vid,
                                  "collection": collection})
        # remove shard files everywhere (the target keeps only the decoded
        # volume; its shard files are consumed)
        for sid, urls in shards.items():
            for u in urls:
                if u != target:
                    self.client.volume_admin(
                        u, "ec/delete_shards",
                        {"volume_id": vid, "collection": collection,
                         "shard_ids": [sid]})
        self.client.volume_admin(
            target, "ec/delete_shards",
            {"volume_id": vid, "collection": collection,
             "shard_ids": list(range(g.total_shards))})
        return {"target": target, "copied": need}
