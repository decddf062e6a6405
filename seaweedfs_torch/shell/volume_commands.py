"""volume.* admin commands of the hot tier.

The port's reduced copy of seaweedfs_tpu/shell/volume_commands.py:

- volume.fix.replication  command_volume_fix_replication.go:1-386, with
  its pure planner ``plan_fix_replication``;
- volume.copy / volume.delete  command_volume_copy.go, _delete.go;
- volume.configure.replication  command_volume_configure_replication.go;
- volume.mark  command_volume_mark.go (readonly / writable);
- volume.heat, lifecycle.status, lifecycle.run: the lifecycle plane's
  shell surface (the master's /vol/heat, /lifecycle/status and
  /lifecycle/run);
- volume.tier.upload / volume.tier.download
  command_volume_tier_upload.go, _download.go: a volume's .dat to an
  object store (``-dest local_store:/dir`` or ``s3:http://host/bucket``,
  whose keys come from ``WEED_S3_ACCESS_KEY`` / ``WEED_S3_SECRET_KEY``,
  the environment overrides of the reference's security.toml) and back.

The planner is a pure function over the topology dict (dry-run
testable); the executors drive the volume servers' admin HTTP API
through the Client. ``volume.list`` stays in shell/commands.py. Not
ported: volume.balance, fsck, move, mount, unmount, vacuum and
volumeServer.evacuate.
"""

from __future__ import annotations

import os
from collections import defaultdict

from ..client import ClientError
from ..storage.superblock import ReplicaPlacement
from .commands import CommandEnv, command, parser


def _nodes(env: CommandEnv) -> list[dict]:
    return env.client.dir_status().get("nodes", [])


def _volume_locations(nodes: list[dict]) -> dict[int, list[dict]]:
    """vid -> [node dicts] over normal volumes."""
    locs: dict[int, list[dict]] = defaultdict(list)
    for nd in nodes:
        for v in nd.get("volumes", []):
            locs[v["id"]].append(nd)
    return locs


def _volume_info(nodes: list[dict]) -> dict[int, dict]:
    info: dict[int, dict] = {}
    for nd in nodes:
        for v in nd.get("volumes", []):
            info.setdefault(v["id"], v)
    return info


def _top_keys(counts: dict) -> set:
    """The keys of the largest count (findTopKeys)."""
    most = max(counts.values(), default=0)
    return {k for k, c in counts.items() if c == most}


def satisfies_placement(rp: ReplicaPlacement, holders: list[dict],
                        nd: dict) -> bool:
    """Whether one more copy on node `nd` keeps the volume within its
    placement: at most X other data centers, Y other racks in the main
    data center and Z other servers on the main rack
    (satisfyReplicaPlacement, command_volume_fix_replication.go)."""
    if nd["url"] in {h["url"] for h in holders}:
        return False
    dc, rack = nd.get("data_center", ""), nd.get("rack", "")
    dcs: dict = defaultdict(int)
    for h in holders:
        dcs[h.get("data_center", "")] += 1
    if dc not in dcs:
        return len(dcs) < rp.diff_data_center_count + 1
    if dc not in _top_keys(dcs):
        return False
    racks: dict = defaultdict(int)
    for h in holders:
        if h.get("data_center", "") == dc:
            racks[h.get("rack", "")] += 1
    if rack not in racks:
        return len(racks) < rp.diff_rack_count + 1
    if rack not in _top_keys(racks):
        return False
    return racks[rack] < rp.same_rack_count + 1


def plan_fix_replication(nodes: list[dict]) -> list[dict]:
    """Under-replicated volumes gain a copy on the emptiest non-holding
    node that keeps the placement (another rack preferred among equals);
    over-replicated volumes lose the copy on the fullest holder
    (command_volume_fix_replication.go:1-386). With no node that keeps
    the placement, the add is impossible. The reference's planner ranks
    every node, so a 001 volume on a multi-rack cluster gains its copy
    on another rack there (ROADMAP Queue 3, D4)."""
    locs = _volume_locations(nodes)
    info = _volume_info(nodes)
    actions: list[dict] = []
    holdings = {nd["url"]: {v["id"] for v in nd.get("volumes", [])}
                for nd in nodes}
    load = {nd["url"]: len(nd.get("volumes", [])) for nd in nodes}
    caps = {nd["url"]: nd.get("max_volume_count", 8) for nd in nodes}
    by_url = {nd["url"]: nd for nd in nodes}

    for vid, holders in sorted(locs.items()):
        rp = ReplicaPlacement.parse(info[vid].get("replica_placement",
                                                  "000"))
        want = rp.copy_count()
        have = len(holders)
        if have < want:
            held_racks = {(nd.get("data_center", ""), nd.get("rack", ""))
                          for nd in holders}
            candidates = [u for u in holdings if load[u] < caps[u]
                          and satisfies_placement(rp, holders, by_url[u])]
            if not candidates:
                actions.append({"volume_id": vid, "action": "impossible",
                                "have": have, "want": want})
                continue

            # another rack first, then emptiest
            def rack_key(u: str):
                nd = by_url[u]
                other_rack = (nd.get("data_center", ""),
                              nd.get("rack", "")) not in held_racks
                return (not other_rack, load[u])
            dst = sorted(candidates, key=rack_key)[0]
            actions.append({"volume_id": vid, "action": "add",
                            "from": holders[0]["url"], "to": dst,
                            "collection": info[vid].get("collection", ""),
                            "have": have, "want": want})
            holdings[dst].add(vid)
            load[dst] += 1
        elif have > want:
            victim = max(holders, key=lambda nd: load[nd["url"]])
            actions.append({"volume_id": vid, "action": "remove",
                            "from": victim["url"],
                            "have": have, "want": want})
            holdings[victim["url"]].discard(vid)
            load[victim["url"]] -= 1
    return actions


@command("volume.fix.replication",
         "re-replicate under/over-replicated volumes "
         "(volume.fix.replication [-force])",
         destructive=True)
def volume_fix_replication(env: CommandEnv, argv: list[str]):
    p = parser("volume.fix.replication")
    p.add_argument("-force", action="store_true")
    args = p.parse_args(argv)
    actions = plan_fix_replication(_nodes(env))
    if not args.force:
        return {"plan": actions, "applied": False}
    applied = 0
    for act in actions:
        if act["action"] == "add":
            env.client.volume_admin(
                act["to"], "volume/copy",
                {"volume_id": act["volume_id"],
                 "collection": act.get("collection", ""),
                 "source": act["from"]})
            applied += 1
        elif act["action"] == "remove":
            env.client.volume_admin(act["from"], "volume/delete",
                                    {"volume_id": act["volume_id"]})
            applied += 1
    return {"plan": actions, "applied": True, "count": applied}


@command("volume.copy",
         "copy a volume to another server "
         "(volume.copy -volumeId N -from src -to dst)",
         destructive=True)
def volume_copy(env: CommandEnv, argv: list[str]):
    p = parser("volume.copy")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-from", dest="src", required=True)
    p.add_argument("-to", dest="dst", required=True)
    p.add_argument("-collection", default="")
    args = p.parse_args(argv)
    out = env.client.volume_admin(
        args.dst, "volume/copy",
        {"volume_id": args.volumeId, "collection": args.collection,
         "source": args.src})
    return {"ok": True, **out}


@command("volume.delete",
         "delete a volume from a server "
         "(volume.delete -volumeId N -node url)",
         destructive=True)
def volume_delete(env: CommandEnv, argv: list[str]):
    p = parser("volume.delete")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-node", required=True)
    args = p.parse_args(argv)
    return env.client.volume_admin(args.node, "volume/delete",
                                   {"volume_id": args.volumeId})


@command("volume.mark",
         "mark a volume readonly/writable "
         "(volume.mark -volumeId N -node url -readonly|-writable)",
         destructive=True)
def volume_mark(env: CommandEnv, argv: list[str]):
    p = parser("volume.mark")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-node", required=True)
    p.add_argument("-readonly", action="store_true")
    p.add_argument("-writable", action="store_true")
    args = p.parse_args(argv)
    return env.client.volume_admin(
        args.node, "volume/readonly",
        {"volume_id": args.volumeId, "read_only": not args.writable})


@command("volume.configure.replication",
         "rewrite a volume's replication setting "
         "(volume.configure.replication -volumeId N -replication XYZ)",
         destructive=True)
def volume_configure_replication(env: CommandEnv, argv: list[str]):
    p = parser("volume.configure.replication")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-replication", required=True)
    args = p.parse_args(argv)
    ReplicaPlacement.parse(args.replication)  # validate early
    done = []
    for nd in _volume_locations(_nodes(env)).get(args.volumeId, []):
        env.client.volume_admin(
            nd["url"], "volume/configure_replication",
            {"volume_id": args.volumeId, "replication": args.replication})
        done.append(nd["url"])
    if not done:
        raise ClientError(f"volume {args.volumeId} not found")
    return {"ok": True, "configured": done}


@command("volume.heat",
         "per-volume access heat + lifecycle state "
         "(volume.heat [-volumeId N])")
def volume_heat(env: CommandEnv, argv: list[str]):
    p = parser("volume.heat")
    p.add_argument("-volumeId", type=int, default=0)
    args = p.parse_args(argv)
    return env.client.volume_heat(args.volumeId)


@command("lifecycle.status",
         "lifecycle daemon state: rules, pending and recent transitions "
         "with outcomes (lifecycle.status)")
def lifecycle_status(env: CommandEnv, argv: list[str]):
    return env.client.lifecycle_status()


@command("lifecycle.run",
         "run one lifecycle evaluation pass now (lifecycle.run)")
def lifecycle_run(env: CommandEnv, argv: list[str]):
    return env.client.lifecycle_run()


# --- volume.tier.* (command_volume_tier_upload.go, _download.go) ---

@command("volume.tier.upload",
         "move a volume's .dat to an object-store tier "
         "(volume.tier.upload -volumeId N -dest local_store:/dir | "
         "s3:http://endpoint/bucket)", destructive=True)
def volume_tier_upload(env: CommandEnv, argv: list[str]):
    p = parser("volume.tier.upload")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-dest", required=True)
    args = p.parse_args(argv)
    spec = _parse_backend_dest(args.dest)
    results = [env.client.volume_admin(
        url, "tier/upload", {"volume_id": args.volumeId, "backend": spec})
        for url in env.client.lookup(args.volumeId)]
    return {"ok": True, "results": results}


@command("volume.tier.download",
         "bring a tiered volume's .dat back to local disk "
         "(volume.tier.download -volumeId N)", destructive=True)
def volume_tier_download(env: CommandEnv, argv: list[str]):
    p = parser("volume.tier.download")
    p.add_argument("-volumeId", type=int, required=True)
    args = p.parse_args(argv)
    results = [env.client.volume_admin(url, "tier/download",
                                       {"volume_id": args.volumeId})
               for url in env.client.lookup(args.volumeId)]
    return {"ok": True, "results": results}


def _parse_backend_dest(dest: str) -> dict:
    """'local_store:/path' or 's3:http://endpoint/bucket'."""
    kind, _, rest = dest.partition(":")
    if kind == "local_store":
        return {"type": "local_store", "directory": rest}
    if kind == "s3":
        endpoint, _, bucket = rest.rpartition("/")
        return {"type": "s3", "endpoint": endpoint, "bucket": bucket,
                "access_key": os.environ.get("WEED_S3_ACCESS_KEY", ""),
                "secret_key": os.environ.get("WEED_S3_SECRET_KEY", "")}
    raise ClientError(f"unknown tier destination {dest!r}")
