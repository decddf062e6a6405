"""The metadata plane: the partitioned filer ring and the masters' log.

The port's reduced copy of seaweedfs_tpu/metaring/. Two halves:

* the filer ring: ``DirectoryRing`` (ring.py), virtual-node consistent
  hashing keyed on a path's PARENT directory, so one directory's
  children live on one owner with ``replicas`` copies on its ring
  successors. The master owns the membership (``/dir/ring``, changed
  through raft by ``/dir/ring/join`` and ``/dir/ring/leave``, pushed as
  ``ring`` lines of ``/cluster/watch``). A ring-member filer routes every
  namespace op to its owner and mirrors writes to the successors
  (router.py), fans recursive deletes and cross-partition renames out
  per directory (coordinator.py), sweeps its entry cache on the other
  members' ``/__meta__/subscribe`` streams (invalidation.py) and moves
  the directories a ring change takes away from it (handoff.py);
* the masters' replicated metadata log (masterlog.py).

Left out, with their later home (slice 9, the serving tiers; ROADMAP
Queue 1 A): the ring hop's admission class (the reference tags handoff
pushes and the invalidation tail as background, and the receiver
classifies a hop from a ring peer as system) and the pooled keep-alive
client ``cache/http_pool.py`` (the port proxies through the filer's own
aiohttp session). The reference's clustersim uses the ring as the
port's ``churn`` scenario does (owner, add, remove).

Env knobs (the ring is off until peers are configured):

  WEED_FILER_RING_PEERS     comma-separated filer host:port members
  WEED_FILER_RING_VNODES    virtual nodes per peer (default 64)
  WEED_FILER_RING_REPLICAS  entry copies per partition (default 2)
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass
class RingConfig:
    """The WEED_FILER_RING_* knobs (explicit arguments win over env)."""

    peers: list[str] = field(default_factory=list)
    vnodes: int = 64
    replicas: int = 2

    @property
    def enabled(self) -> bool:
        return len(self.peers) > 0

    @classmethod
    def from_env(cls, env=os.environ) -> "RingConfig":
        peers = [p.strip() for p in
                 env.get("WEED_FILER_RING_PEERS", "").split(",")
                 if p.strip()]

        def num(key: str, default: int) -> int:
            try:
                return int(env.get(key, "") or default)
            except ValueError:
                return default

        return cls(peers=peers,
                   vnodes=max(1, num("WEED_FILER_RING_VNODES", 64)),
                   replicas=max(1, num("WEED_FILER_RING_REPLICAS", 2)))


# the ring hop's header (defined once, in overload, as the reference
# does): a request that already passed the edge peer runs where it lands
# and is never routed again (one hop at most)
from ..overload import RING_HOP_HEADER  # noqa: E402
from .ring import DirectoryRing  # noqa: E402
from .masterlog import MasterMetaLog  # noqa: E402

__all__ = ["RingConfig", "DirectoryRing", "MasterMetaLog",
           "RING_HOP_HEADER"]
