"""The re-replication target choice.

The port's reduced copy of seaweedfs_tpu/balance/planner.py: only
``pick_replica_target`` (the repair daemon's rule), not the balancer's
move planner. Pure: no sockets, no clock.
"""

from __future__ import annotations

from typing import Optional

from ..shell.volume_commands import satisfies_placement
from ..storage.superblock import ReplicaPlacement


def _node_dict(n) -> dict:
    return {"url": n.url, "data_center": n.data_center, "rack": n.rack}


def pick_replica_target(topology, replication: str, holders: list,
                        pending: Optional[dict] = None):
    """Rack-aware target for re-replicating one volume: among the nodes
    with a free slot that do not hold it, those where one more copy
    keeps the volume within its placement (upstream's
    satisfyReplicaPlacement, ``shell/volume_commands.py``); among them a
    rack the surviving copies do not occupy when the placement spreads
    racks or data centers; then the most free slots, ties broken by node
    id. ``pending`` (node id -> copies already heading there) discounts
    those. None when no node keeps the placement. The reference's
    planner checks only that rack diversity exists, so a ``001`` volume
    on two racks gains its copy on the other rack there (ROADMAP Queue 3,
    D5)."""
    rp = ReplicaPlacement.parse(replication)
    held = {n.id for n in holders}
    pending = pending or {}

    def free(n):
        return n.free_slots() - pending.get(n.id, 0)

    held_dicts = [_node_dict(n) for n in holders]
    candidates = [n for n in topology.nodes.values()
                  if free(n) > 0 and n.id not in held
                  and satisfies_placement(rp, held_dicts, _node_dict(n))]
    if not candidates or not holders:
        return None
    used_racks = {(n.data_center, n.rack) for n in holders}
    if rp.diff_rack_count or rp.diff_data_center_count:
        spread = [n for n in candidates
                  if (n.data_center, n.rack) not in used_racks]
        if spread:
            candidates = spread
    return max(sorted(candidates, key=lambda n: n.id), key=free)
