"""The scenarios clustersim sweeps; each returns a report dict whose
``violations`` list must be empty.

The port's copy of seaweedfs_tpu/clustersim/scenarios.py:

* ``steady``: uniform heat, no events; the balancer plans no move and
  ends at a planner fixpoint.
* ``skew``: a few nodes turn hot; the rebalance converges within a
  bounded number of ticks (fixpoint, the hot nodes drained) with no
  oscillation: no volume moves twice inside the cooldown window and no
  A->B->A path ever.
* ``churn``: node kills, flaps and revivals with no heat skew; no
  balance move, every deficit repaired, the data moved bounded by the
  churn, and the ``DirectoryRing`` moves about 1/N of the directories
  per membership change.
* ``rackloss``: a whole rack dies while heat skew is active; the repair
  storm drains in bounded ticks and no balance job starts while repair
  work is queued.

Each scenario is pure in (name, seed, nodes): ``__main__`` runs each
twice and compares the digests.
"""

from __future__ import annotations

from .. import faults
from ..metaring.ring import DirectoryRing
from .sim import ClusterSim

SCENARIOS = ("steady", "skew", "churn", "rackloss")

# virtual-cluster shape knobs shared by every scenario
TICKS = {"steady": 50, "skew": 120, "churn": 130, "rackloss": 200}


def _oscillation_violations(sim: ClusterSim) -> list[str]:
    """No volume moves twice within the cooldown window; no A->B->A
    path ever (steady heat must never make a volume retrace)."""
    out = []
    by_vid: dict[int, list] = {}
    for tick, vid, src, dst, _ in sim.completed_moves:
        by_vid.setdefault(vid, []).append((tick, src, dst))
    window = sim.cfg.cooldown / sim.tick_seconds
    for vid, moves in sorted(by_vid.items()):
        for (t1, _, _), (t2, _, _) in zip(moves, moves[1:]):
            if t2 - t1 < window:
                out.append(f"volume {vid} moved twice within the "
                           f"cooldown window (ticks {t1} and {t2})")
        for i, (_, s1, d1) in enumerate(moves):
            for (_, s2, d2) in moves[i + 1:]:
                if s2 == d1 and d2 == s1:
                    out.append(f"volume {vid} ping-ponged "
                               f"{s1}->{d1}->{d2}")
    return out


def _base_report(sim: ClusterSim, name: str, seed: int) -> dict:
    return {
        "scenario": name, "seed": seed, "nodes": len(sim.nodes),
        "ticks": sim.tick_no, "digest": sim.digest(),
        "moves": len(sim.completed_moves),
        "repairs": len(sim.completed_repairs),
        "moved_bytes": sim.moved_bytes,
        "repaired_bytes": sim.repaired_bytes,
        "moved_bytes_ratio": round(sim.moved_bytes
                                   / max(sim.total_bytes, 1), 6),
        "deficits_left": sim.deficit_count(),
        "max_node_rate": round(sim.max_node_rate(), 4),
        "violations": [],
    }


def steady(seed: int, nodes: int) -> dict:
    sim = ClusterSim(nodes=nodes, seed=seed)
    for n in sim.nodes:
        for vid in n.volumes:
            n.rates[vid] = 0.2
    sim.run(TICKS["steady"])
    rep = _base_report(sim, "steady", seed)
    if sim.completed_moves:
        rep["violations"].append(
            f"{len(sim.completed_moves)} moves on a uniform cluster")
    if sim.final_plan():
        rep["violations"].append("planner not at fixpoint under "
                                 "uniform heat")
    return rep


def skew(seed: int, nodes: int) -> dict:
    sim = ClusterSim(nodes=nodes, seed=seed)
    skew_tick, hot_nodes, hot_rate = 5, 3, 2.0
    for i in range(hot_nodes):
        for vid in sorted(sim.node(i).volumes):
            sim.at(skew_tick, "heat", i, vid, hot_rate)
    sim.run(TICKS["skew"])
    rep = _base_report(sim, "skew", seed)
    rep["converge_tick"] = (max(t for t, *_ in sim.completed_moves)
                            if sim.completed_moves else 0)
    if not sim.completed_moves:
        rep["violations"].append("no moves despite heat skew")
    if sim.final_plan():
        rep["violations"].append("planner not at fixpoint by end of run")
    if rep["converge_tick"] - skew_tick > 80:
        rep["violations"].append(
            f"convergence took {rep['converge_tick'] - skew_tick} ticks "
            f"(bound 80)")
    # a drained hot node: the per-node peak was hot_rate * volumes-held;
    # nothing can go below one indivisible hot volume's rate
    if rep["max_node_rate"] > hot_rate * 2 + 0.01:
        rep["violations"].append(
            f"hot node not drained: max rate {rep['max_node_rate']}")
    rep["violations"].extend(_oscillation_violations(sim))
    return rep


def churn(seed: int, nodes: int) -> dict:
    sim = ClusterSim(nodes=nodes, seed=seed)
    # deterministic low-probability beat loss (flap noise) through the
    # faults plane: the same drill an operator arms on a live cluster
    sim.at(1, "fault", "sim.heartbeat", "drop", 0.01, None, seed)
    import random as _random
    rng = _random.Random(seed)
    victims = rng.sample(range(len(sim.nodes)), 3)
    sim.at(10, "kill", victims[0])                # permanent
    sim.at(15, "kill", victims[1])                # flap: back before
    sim.at(30, "revive", victims[1])              # the prune window
    sim.at(50, "kill", victims[2])                # permanent
    # the ring's minimal-movement property at the same scale: mirror
    # the membership changes into a DirectoryRing and count how many
    # sampled directories change owner — a consistent-hash ring moves
    # ~1/N per change, a naive rehash would move nearly all of them
    ring = DirectoryRing(peers=[n.id for n in sim.nodes], vnodes=16)
    sample = [f"bucket{i}/dir{i}" for i in range(400)]
    owners = {d: ring.owner(d) for d in sample}
    ring_moved = 0
    membership = [(10, "remove", victims[0]), (15, "remove", victims[1]),
                  (30, "add", victims[1]), (50, "remove", victims[2])]
    sim.run(TICKS["churn"])
    for _, op, idx in membership:
        peer = sim.node(idx).id
        if op == "remove":
            ring.remove_peer(peer)
        else:
            ring.add_peer(peer)
        for d in sample:
            new = ring.owner(d)
            if new != owners[d]:
                owners[d] = new
                ring_moved += 1
    rep = _base_report(sim, "churn", seed)
    rep["ring_moved_dirs"] = ring_moved
    rep["ring_sampled_dirs"] = len(sample)
    if sim.completed_moves:
        rep["violations"].append(
            f"{len(sim.completed_moves)} balance moves from capacity "
            f"churn alone (no heat skew)")
    if rep["deficits_left"]:
        rep["violations"].append(
            f"{rep['deficits_left']} deficits unrepaired after churn")
    # minimal movement: each membership change over N peers should
    # touch ~len(sample)/N directories — allow 4x for vnode variance
    # (plus a floor for small-N noise); a reshuffle would move hundreds
    bound = max(4.0 * len(membership) * len(sample) / len(sim.nodes), 20)
    rep["ring_moved_bound"] = round(bound, 1)
    if ring_moved > bound:
        rep["violations"].append(
            f"ring moved {ring_moved}/{len(sample)} dirs over 4 "
            f"membership changes — not minimal movement")
    # data movement bounded by the churn itself: only the dead nodes'
    # replicas get re-created, nothing else migrates
    dead_fraction = 2.0 / len(sim.nodes)
    ratio = (sim.moved_bytes + sim.repaired_bytes) / sim.total_bytes
    if ratio > dead_fraction * 3 + 1e-9:
        rep["violations"].append(
            f"moved-bytes ratio {ratio:.4f} exceeds 3x the dead-node "
            f"fraction {dead_fraction:.4f}")
    rep["churn_data_ratio"] = round(ratio, 6)
    return rep


def rackloss(seed: int, nodes: int) -> dict:
    sim = ClusterSim(nodes=nodes, seed=seed)
    # heat skew on two nodes OUTSIDE the doomed rack, so balance work
    # coexists with the repair storm — the starvation drill
    survivors = [i for i in range(len(sim.nodes))
                 if (sim.node(i).dc, sim.node(i).rack) != ("dc0", "r0")]
    for i in survivors[:2]:
        for vid in sorted(sim.node(i).volumes):
            sim.at(5, "heat", i, vid, 2.0)
    sim.at(10, "rack_loss", "dc0", "r0")
    sim.run(TICKS["rackloss"])
    rep = _base_report(sim, "rackloss", seed)
    if rep["deficits_left"]:
        rep["violations"].append(
            f"repair storm did not drain: {rep['deficits_left']} "
            f"deficits left after {sim.tick_no} ticks")
    if not sim.completed_repairs:
        rep["violations"].append("rack loss produced no repairs")
    rep["balance_start_while_repair_pending"] = \
        sim.balance_start_while_repair_pending
    if sim.balance_start_while_repair_pending:
        rep["violations"].append(
            "balance jobs started while repair work was queued "
            "(slot-priority inversion)")
    for ev in sim.events:
        if ev["e"] == "move_start" and ev.get("repair_pending", 0) > 0:
            rep["violations"].append(
                f"move_start at tick {ev['t']} with "
                f"{ev['repair_pending']} repairs pending")
    rep["violations"].extend(_oscillation_violations(sim))
    return rep


def run_scenario(name: str, seed: int, nodes: int = 1000) -> dict:
    """One scenario run with a clean faults plane either side (scripted
    ops may arm sim.heartbeat faults; they must not leak across runs —
    a leaked fault would also advance its RNG and break determinism)."""
    fn = {"steady": steady, "skew": skew, "churn": churn,
          "rackloss": rackloss}[name]
    faults.clear("sim.heartbeat")
    try:
        return fn(seed, nodes)
    finally:
        faults.clear("sim.heartbeat")
