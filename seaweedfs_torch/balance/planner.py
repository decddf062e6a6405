"""Balance planning: pure, clock-injected and seeded.

The port's reduced copy of seaweedfs_tpu/balance/planner.py. No sockets
and no ambient time: ``plan_moves`` reads the master's ``Topology`` as
the repair planner does and returns the volume moves that would reduce
the heat imbalance this pass; ``PlannerState`` is the oscillation guard
(two-pass confirmation, per-volume cooldown, the A->B->A veto) that the
daemon and clustersim both run; ``pick_replica_target`` is the repair
daemon's choice of a node for a lost copy.

What a plan never does:

* depend on anything but its inputs: the same topology, config and seed
  give a byte-identical plan (the seed only breaks ties);
* shrink a volume's rack or data-center spread, target a holder, or
  push the destination past the capacity watermark; and, where the
  holders keep the volume's placement, take it out of that placement
  (upstream's ``satisfyReplicaPlacement``; the reference checks spread
  only, ROADMAP Queue 3, D5);
* move a volume that is not sealed (read-only, or past
  ``FULL_FRACTION`` of the size limit), an under-replicated one (the
  repair daemon's), an EC, vacuuming or frozen one;
* make a move that is not a strict improvement: the destination's rate
  after the move stays below the source's before it, so the sum of
  squared node rates strictly falls and a lone hot volume stays put.

The one move to an existing holder: a volume with more live holders than
its placement asks for (a move that crashed between copy and retire)
plans a retire-only move, which the daemon finishes by deleting the
source.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Optional

from ..shell.volume_commands import satisfies_placement
from ..storage.superblock import ReplicaPlacement

# a volume counts as sealed (movable) past this fraction of the size
# limit, WEED_LIFECYCLE_FULL_FRACTION's default
FULL_FRACTION = 0.9


@dataclass
class Move:
    vid: int
    collection: str
    src: str            # source node id
    dst: str            # destination node id
    src_url: str
    dst_url: str
    bytes: int
    rate: float         # the per-holder read rate being moved
    reason: str

    @property
    def key(self) -> tuple:
        return ("balance", self.vid)

    def to_dict(self) -> dict:
        return {"vid": self.vid, "collection": self.collection,
                "src": self.src, "dst": self.dst, "bytes": self.bytes,
                "rate": round(self.rate, 6), "reason": self.reason}


def node_rates(topology, now: float) -> dict[str, float]:
    """node id -> summed decayed read rate over its normal volumes, for
    live nodes only: a node past the prune window (pulse x 5) must not
    rank hot or cold on its stale rates."""
    timeout = topology.pulse_seconds * 5
    out: dict[str, float] = {}
    for nid, node in topology.nodes.items():
        if now - node.last_seen > timeout:
            continue
        total = 0.0
        for vid in node.volumes:
            vh = node.heat.get(vid)
            if vh is not None:
                total += vh.rate_now(now)
        out[nid] = total
    return out


def _node_dict(n) -> dict:
    return {"url": n.url, "data_center": n.data_center, "rack": n.rack}


def placement_holds(rp: ReplicaPlacement, holders: list) -> bool:
    """Whether a holder set keeps its placement: each holder is one that
    ``satisfies_placement`` would add to the others (upstream's
    isMisplaced, command_volume_fix_replication.go)."""
    dicts = [_node_dict(n) for n in holders]
    return all(satisfies_placement(rp, dicts[:i] + dicts[i + 1:], d)
               for i, d in enumerate(dicts))


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


def _spread_after_retire_ok(rp: ReplicaPlacement, holders: list,
                            src) -> bool:
    """Would dropping `src`'s copy leave a holder set that still has the
    placement's copy count and its DC and rack diversity? Guards the
    retire-only moves that finish a crashed copy -> retire."""
    others = [n for n in holders if n.id != src.id]
    if len(others) < rp.copy_count():
        return False
    if len({n.data_center for n in others}) \
            < rp.diff_data_center_count + 1:
        return False
    if len({(n.data_center, n.rack) for n in others}) \
            < rp.diff_data_center_count + rp.diff_rack_count + 1:
        return False
    return True


def _spread_ok(rp: ReplicaPlacement, holders: list, src, dst) -> bool:
    """Would moving the `src` copy to `dst` preserve the placement? The
    holder set's distinct-rack and distinct-DC counts must not fall, a
    same-rack placement keeps `dst` in a rack the other copies occupy,
    and a holder set within its placement stays within it (D5)."""
    if any(n.id == dst.id for n in holders):
        return False  # dst already holds a copy
    others = [n for n in holders if n.id != src.id]
    after = others + [dst]

    def racks(ns):
        return {(n.data_center, n.rack) for n in ns}

    def dcs(ns):
        return {n.data_center for n in ns}

    if len(racks(after)) < len(racks(holders)):
        return False
    if len(dcs(after)) < len(dcs(holders)):
        return False
    if rp.same_rack_count > 0 and others:
        if (dst.data_center, dst.rack) not in racks(others):
            return False
    if placement_holds(rp, holders) and not satisfies_placement(
            rp, [_node_dict(n) for n in others], _node_dict(dst)):
        return False
    return True


def plan_moves(topology, cfg, now: float, seed: int = 0,
               frozen: frozenset = frozenset()) -> list[Move]:
    """One planning pass: up to cfg.max_moves moves from hot nodes to the
    coldest eligible destinations. Deterministic: `now` is an argument,
    and Random(seed) only breaks exact ties among equally cold
    destinations. ``frozen`` (PlannerState's cooldown set) is skipped."""
    timeout = topology.pulse_seconds * 5
    live = {nid: n for nid, n in sorted(topology.nodes.items())
            if now - n.last_seen <= timeout and n.max_volume_count > 0}
    if len(live) < 2:
        return []

    # per-(node, volume) decayed rates and per-node totals, one walk
    vol_rate: dict[tuple, float] = {}
    rates: dict[str, float] = {}
    ec_vids: set[int] = set()
    for nid, node in live.items():
        total = 0.0
        for vid in node.volumes:
            vh = node.heat.get(vid)
            r = vh.rate_now(now) if vh is not None else 0.0
            vol_rate[(nid, vid)] = r
            total += r
        rates[nid] = total
        ec_vids.update(node.ec_shards)
    mean = sum(rates.values()) / len(rates)
    hot_cut = max(mean * cfg.hot_ratio, cfg.min_rate)
    hots = sorted((nid for nid in live if rates[nid] > hot_cut),
                  key=lambda nid: (-rates[nid], nid))
    if not hots:
        return []

    vacuuming = {vid for layout in topology.layouts.values()
                 for vid in layout.vacuuming}
    # live holders per vid (an under-replicated volume is the repair
    # daemon's)
    holders: dict[int, list] = {}
    for nid, node in live.items():
        for vid in node.volumes:
            holders.setdefault(vid, []).append(node)

    rng = random.Random(seed)
    # one stable random priority per node: equal-rate cold nodes are not
    # all picked in id order, and the plan stays replayable
    tie = {nid: rng.random() for nid in sorted(live)}
    proj = dict(rates)                       # projected rates
    pending_add = {nid: 0 for nid in live}   # slots claimed this plan
    planned_vids: set[int] = set()
    moves: list[Move] = []

    for src_id in hots:
        if len(moves) >= cfg.max_moves:
            break
        src = live[src_id]
        vids = sorted((vid for vid in src.volumes
                       if vol_rate[(src_id, vid)] > 0.0),
                      key=lambda vid: (-vol_rate[(src_id, vid)], vid))
        for vid in vids:
            if len(moves) >= cfg.max_moves or proj[src_id] <= hot_cut:
                break
            if vid in frozen or vid in planned_vids or vid in ec_vids \
                    or vid in vacuuming:
                continue
            vi = src.volumes[vid]
            rp = ReplicaPlacement.parse(vi.replica_placement)
            held = holders.get(vid, [])
            if len(held) < rp.copy_count():
                continue  # the repair daemon's
            # more live holders than the placement wants: a move that
            # crashed between copy and retire. Finish it by retiring the
            # source (a move to an existing holder); a fresh copy
            # elsewhere would only widen the surplus
            extra = len(held) > rp.copy_count()
            sealed = (vi.read_only or vi.size >= FULL_FRACTION
                      * topology.volume_size_limit)
            if not sealed:
                continue
            r = vol_rate[(src_id, vid)]
            # coldest-first eligible destinations
            for dst_id in sorted(
                    live, key=lambda nid: (proj[nid], tie[nid], nid)):
                if dst_id == src_id:
                    continue
                dst = live[dst_id]
                dst_holds = any(n.id == dst_id for n in held)
                if extra != dst_holds:
                    continue
                if not extra:
                    # a free slot, and under the watermark after every
                    # move already planned to this destination
                    used = dst.max_volume_count - dst.free_slots()
                    adds = pending_add[dst_id]
                    if dst.free_slots() - adds <= 0:
                        continue
                    if used + adds + 1 > cfg.watermark \
                            * dst.max_volume_count:
                        continue
                # strict improvement (see the module docstring)
                if proj[dst_id] + r >= proj[src_id]:
                    continue
                if extra:
                    if not _spread_after_retire_ok(rp, held, src):
                        continue
                elif not _spread_ok(rp, held, src, dst):
                    continue
                moves.append(Move(
                    vid=vid, collection=vi.collection, src=src_id,
                    dst=dst_id, src_url=src.url, dst_url=dst.url,
                    bytes=vi.size, rate=r,
                    reason=("retire surplus replica of a crashed move"
                            if extra else
                            f"node rate {rates[src_id]:.2f}/s > "
                            f"{hot_cut:.2f}/s hot cut")))
                planned_vids.add(vid)
                proj[src_id] -= r
                proj[dst_id] += r
                if not extra:
                    pending_add[dst_id] += 1
                break
    return moves


@dataclass
class PlannerState:
    """The oscillation guard of the daemon and clustersim:

    * two-pass confirmation: a move fires only when two consecutive
      passes propose the same (src, dst) for a volume;
    * cooldown: a volume that completed a move is frozen for
      cfg.cooldown seconds;
    * the ping-pong veto: while a completed A->B move is remembered
      (4 x cooldown), the reverse B->A move is refused.

    Clock-free: every method takes `now`."""
    cfg: object
    _proposed: dict = field(default_factory=dict)   # vid -> (sig, count)
    _last_move: dict = field(default_factory=dict)  # vid -> (t, src, dst)

    def frozen(self, now: float) -> frozenset:
        self._expire(now)
        return frozenset(vid for vid, (t, _, _) in self._last_move.items()
                         if now - t < self.cfg.cooldown)

    def _expire(self, now: float) -> None:
        horizon = self.cfg.cooldown * 4
        for vid in [v for v, (t, _, _) in self._last_move.items()
                    if now - t >= horizon]:
            self._last_move.pop(vid, None)

    def vetoed(self, move: Move) -> bool:
        last = self._last_move.get(move.vid)
        return (last is not None
                and last[1] == move.dst and last[2] == move.src)

    def confirm(self, moves: list, now: float) -> list:
        """Fold this pass's proposals into the two-pass counter; returns
        the moves seen twice with an unchanged src -> dst. A proposal
        absent this pass starts over."""
        cold = self.frozen(now)
        confirmed: list = []
        fresh: dict = {}
        for m in moves:
            if m.vid in cold or self.vetoed(m):
                continue
            sig = (m.src, m.dst)
            prev = self._proposed.get(m.vid)
            count = prev[1] + 1 if prev is not None and prev[0] == sig \
                else 1
            if count >= 2:
                # launching drops the counter: the next pass (which may
                # still see the pre-move topology) confirms from scratch
                confirmed.append(m)
            else:
                fresh[m.vid] = (sig, count)
        self._proposed = fresh
        return confirmed

    def record_done(self, move: Move, now: float) -> None:
        self._last_move[move.vid] = (now, move.src, move.dst)

    def reset(self) -> None:
        """Forget the pass counters (the reference's demoted leader)."""
        self._proposed.clear()

    def to_dict(self) -> dict:
        return {"proposed": {str(v): {"src": s[0][0], "dst": s[0][1],
                                      "count": s[1]}
                             for v, s in sorted(self._proposed.items())},
                "recent_moves": {str(v): {"at": t, "src": s, "dst": d}
                                 for v, (t, s, d)
                                 in sorted(self._last_move.items())}}
