"""filer.ring.* commands: the filer ring's shell surface.

The port's copy of seaweedfs_tpu/shell/ring_commands.py:

- filer.ring.status  the master's ring and each member's own view: its
                     proxy and mirror counters, its local and owned
                     directory counts, its handoff's progress;
- filer.ring.join    add a filer to the ring (the master's
                     ``/dir/ring/join``, through raft, pushed to the
                     filers, which start the partition handoff);
- filer.ring.leave   remove one (a planned leave or a dead member).

Join and leave move partitions, so they hold the master's admin lock, as
the reference's do.
"""

from __future__ import annotations

from ..client import _get_json
from .commands import CommandEnv, command, parser


def _peer_status(peer: str) -> dict:
    try:
        return _get_json(f"http://{peer}/__meta__/ring/status", timeout=5)
    except Exception as e:
        return {"error": str(e)}


@command("filer.ring.status",
         "show the filer ring: membership, each member's partition "
         "counts and handoff (filer.ring.status [-peer host:port])")
def filer_ring_status(env: CommandEnv, argv: list[str]):
    p = parser("filer.ring.status")
    p.add_argument("-peer", default="",
                   help="show one member's row only")
    args = p.parse_args(argv)
    ring = env.client._master_get("/dir/ring")
    out = {"ring": ring, "peers": {}}
    for peer in [args.peer] if args.peer else ring.get("peers", []):
        st = _peer_status(peer)
        router = st.get("router") or {}
        out["peers"][peer] = st if "error" in st else {
            "owned_dirs": st.get("owned_dirs"),
            "local_dirs": st.get("local_dirs"),
            "proxied": router.get("proxied"),
            "mirrored": router.get("mirrored"),
            "mirror_failures": router.get("mirror_failures"),
            "handoff": st.get("handoff"),
        }
    return out


@command("filer.ring.join",
         "add a filer to the ring (filer.ring.join -peer host:port)",
         destructive=True)
def filer_ring_join(env: CommandEnv, argv: list[str]):
    p = parser("filer.ring.join")
    p.add_argument("-peer", required=True)
    return env.client._master_post("/dir/ring/join",
                                   {"peer": p.parse_args(argv).peer})


@command("filer.ring.leave",
         "remove a filer from the ring (filer.ring.leave -peer host:port)",
         destructive=True)
def filer_ring_leave(env: CommandEnv, argv: list[str]):
    p = parser("filer.ring.leave")
    p.add_argument("-peer", required=True)
    return env.client._master_post("/dir/ring/leave",
                                   {"peer": p.parse_args(argv).peer})
