"""bucket.* and collection.* commands.

The port's copy of seaweedfs_tpu/shell/bucket_commands.py, whole.
Counterparts of weed/shell/command_bucket_*.go (buckets are directories
under /buckets, weed/filer/filer_buckets.go) and
command_collection_*.go (collections group volumes; deleting one deletes
every volume in it). ``collection.delete`` deletes each volume through
its holder's ``/admin/volume/delete``; the master's ``/col/delete``
waits for ROADMAP A.10.
"""

from __future__ import annotations

import stat as stat_mod

from ..client import ClientError
from .commands import CommandEnv, command, parser

BUCKETS_DIR = "/buckets"


@command("bucket.list", "list buckets (bucket.list)")
def bucket_list(env: CommandEnv, argv: list[str]):
    if not env.filer:
        raise ClientError("bucket.* commands need -filer")
    out = env.filer_get("/__meta__/list",
                        {"dir": BUCKETS_DIR, "limit": 1024})
    buckets = [e["path"].rsplit("/", 1)[-1]
               for e in out.get("entries", [])
               if stat_mod.S_ISDIR(e.get("attr", {}).get("mode", 0))]
    return {"buckets": buckets}


@command("bucket.create", "create a bucket (bucket.create -name b)")
def bucket_create(env: CommandEnv, argv: list[str]):
    if not env.filer:
        raise ClientError("bucket.* commands need -filer")
    p = parser("bucket.create")
    p.add_argument("-name", required=True)
    p.add_argument("-replication", default="")
    args = p.parse_args(argv)
    entry = {"path": f"{BUCKETS_DIR}/{args.name}",
             "attr": {"mode": stat_mod.S_IFDIR | 0o770,
                      "collection": args.name,
                      "replication": args.replication}}
    out = env.filer_post("/__meta__/create_entry", {"entry": entry})
    if "error" in out and out["error"] != "exists":
        raise ClientError(out["error"])
    return {"ok": True, "bucket": args.name}


@command("bucket.delete", "delete a bucket (bucket.delete -name b)",
         destructive=True)
def bucket_delete(env: CommandEnv, argv: list[str]):
    if not env.filer:
        raise ClientError("bucket.* commands need -filer")
    p = parser("bucket.delete")
    p.add_argument("-name", required=True)
    args = p.parse_args(argv)
    out = env.filer_post("/__meta__/delete",
                         {"path": f"{BUCKETS_DIR}/{args.name}",
                          "recursive": True,
                          "ignore_recursive_error": True})
    if "error" in out:
        raise ClientError(out["error"])
    return {"ok": True, "deleted": args.name}


@command("collection.list", "list collections (collection.list)")
def collection_list(env: CommandEnv, argv: list[str]):
    names: dict[str, int] = {}
    for nd in env.client.dir_status().get("nodes", []):
        for v in nd.get("volumes", []):
            c = v.get("collection", "")
            names[c] = names.get(c, 0) + 1
        for s in nd.get("ec_shards", []):
            c = s.get("collection", "")
            names.setdefault(c, 0)
    return {"collections": [{"name": n or "(default)", "volumes": c}
                            for n, c in sorted(names.items())]}


@command("collection.delete",
         "delete every volume of a collection "
         "(collection.delete -collection c -force)", destructive=True)
def collection_delete(env: CommandEnv, argv: list[str]):
    p = parser("collection.delete")
    p.add_argument("-collection", required=True)
    p.add_argument("-force", action="store_true")
    args = p.parse_args(argv)
    doomed: list[tuple[str, int]] = []
    for nd in env.client.dir_status().get("nodes", []):
        for v in nd.get("volumes", []):
            if v.get("collection", "") == args.collection:
                doomed.append((nd["url"], v["id"]))
    if not args.force:
        return {"plan": [{"node": u, "volume_id": v} for u, v in doomed],
                "applied": False}
    for url, vid in doomed:
        env.client.volume_admin(url, "volume/delete", {"volume_id": vid})
    return {"deleted": len(doomed), "applied": True}
