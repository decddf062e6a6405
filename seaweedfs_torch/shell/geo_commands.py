"""geo.* admin commands: the geo plane's shell surface.

The port's copy of seaweedfs_tpu/shell/geo_commands.py.

- geo.status   per-bucket replication job state off the master's geo
               daemon (/geo/status): offsets, lag, applied/skipped/
               poisoned counts, backfill progress.
- geo.sync     trigger an immediate rule-scan/reconcile pass (/geo/run):
               a freshly PUT replication rule starts its job (and
               backfill) now instead of at the next interval.
"""

from __future__ import annotations

from ..client import _post_json
from .commands import CommandEnv, command, parser


@command("geo.status",
         "show cluster-to-cluster replication state "
         "(geo.status [-bucket name])")
def geo_status(env: CommandEnv, argv: list[str]):
    p = parser("geo.status")
    p.add_argument("-bucket", default="")
    args = p.parse_args(argv)
    out = env.client._master_get("/geo/status")
    if args.bucket:
        jobs = out.get("jobs", {})
        out["jobs"] = {args.bucket: jobs.get(args.bucket,
                                             {"state": "no job"})}
    return out


@command("geo.sync",
         "run one geo reconcile pass now (starts jobs for fresh "
         "replication rules, including their backfill)")
def geo_sync(env: CommandEnv, argv: list[str]):
    return _post_json(f"http://{env.client.master}/geo/run", {})
