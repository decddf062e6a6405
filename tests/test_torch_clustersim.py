"""The port's clustersim held against the reference's.

For each of the four scenarios at seeds 0-2 and 40 nodes, the port's
event-log ``digest()`` must equal the reference's: the port's
``Topology``, ``plan_moves``, ``PlannerState``, ``DirectoryRing`` and
faults plane run the reference's closed loop and must make every
decision the reference makes, tick for tick. ``steady`` and ``skew``
place no repair and match as they stand. ``churn`` and ``rackloss``
re-replicate: the simulated fleet spreads each ``010`` volume over two
data centers, and the port's repair rule keeps a volume within its
placement (upstream's ``satisfyReplicaPlacement``) where the
reference's places the copy across data centers (ROADMAP Queue 3, D5).
Those two therefore match the reference's digest with the reference's
placement rule put into the port's sim, and with the port's own rule
they pass every check of the scenario, with the same counts of moves
and repairs, each repair kept in the survivor's data center. The
reference's own assertions (tests/test_clustersim.py) run on the port's
reports.
"""

import json

import pytest

from seaweedfs_torch import faults as pfaults
from seaweedfs_torch.clustersim import ClusterSim, VirtualClock
from seaweedfs_torch.clustersim import scenarios as pscenarios
from seaweedfs_torch.clustersim import sim as psim
from seaweedfs_torch.clustersim.__main__ import main as pmain
from seaweedfs_torch.clustersim.scenarios import (SCENARIOS, TICKS,
                                                  run_scenario)
from seaweedfs_torch.metaring.ring import DirectoryRing as PRing
from seaweedfs_tpu.balance import planner as rplanner
from seaweedfs_tpu.clustersim.scenarios import run_scenario as rrun
from seaweedfs_tpu.metaring.ring import DirectoryRing as RRing

NODES = 40


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["steady", "skew"])
def test_digest_equals_the_reference(name, seed):
    mine = run_scenario(name, seed, nodes=NODES)
    theirs = rrun(name, seed, nodes=NODES)
    assert mine["digest"] == theirs["digest"]
    assert mine == theirs


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["churn", "rackloss"])
def test_digest_equals_the_reference_under_its_placement_rule(
        name, seed, monkeypatch):
    """With the reference's repair placement in the port's sim the whole
    report is the reference's, digest included."""
    theirs = rrun(name, seed, nodes=NODES)
    monkeypatch.setattr(psim, "pick_replica_target",
                        rplanner.pick_replica_target)
    mine = run_scenario(name, seed, nodes=NODES)
    assert mine["digest"] == theirs["digest"]
    assert mine == theirs


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["churn", "rackloss"])
def test_own_placement_rule_repairs_within_the_data_center(
        name, seed, monkeypatch):
    """With the port's own rule (D5) the scenario passes its checks,
    moves and repairs as often as the reference, and places every
    repair in the surviving copy's data center."""
    theirs = rrun(name, seed, nodes=NODES)
    sims = []

    class Spy(psim.ClusterSim):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            sims.append(self)

    monkeypatch.setattr(pscenarios, "ClusterSim", Spy)
    mine = run_scenario(name, seed, nodes=NODES)
    assert mine["violations"] == [] and mine["deficits_left"] == 0
    assert (mine["moves"], mine["repairs"]) == \
        (theirs["moves"], theirs["repairs"])
    sim = sims[0]
    dc = {n.id: n.dc for n in sim.nodes}
    for ev in sim.events:
        if ev["e"] == "repair_planned":
            assert dc[ev["dst"]] == dc[ev["src"]], ev


def test_reference_assertions_on_the_port():
    """tests/test_clustersim.py's checks, on the port's reports."""
    for name in SCENARIOS:
        a = run_scenario(name, seed=3, nodes=NODES)
        b = run_scenario(name, seed=3, nodes=NODES)
        assert a["digest"] == b["digest"], f"{name} diverged"
    assert run_scenario("churn", 1, nodes=NODES)["digest"] != \
        run_scenario("churn", 2, nodes=NODES)["digest"]
    rep = run_scenario("steady", seed=0, nodes=30)
    assert rep["violations"] == [] and rep["moves"] == 0
    assert rep["moved_bytes"] == 0
    rep = run_scenario("skew", seed=0, nodes=60)
    assert rep["violations"] == [] and rep["moves"] > 0
    assert rep["converge_tick"] is not None
    assert rep["moved_bytes_ratio"] < 0.2
    rep = run_scenario("churn", seed=1, nodes=60)
    assert rep["violations"] == [] and rep["moves"] == 0
    assert rep["deficits_left"] == 0
    assert rep["ring_moved_dirs"] <= rep["ring_moved_bound"]
    rep = run_scenario("rackloss", seed=0, nodes=60)
    assert rep["violations"] == [] and rep["repairs"] > 0
    assert rep["deficits_left"] == 0
    assert rep["balance_start_while_repair_pending"] == 0


def test_virtual_clock_monotone():
    c = VirtualClock()
    t0 = c.now()
    c.advance(2.5)
    assert c.now() == t0 + 2.5
    with pytest.raises(ValueError):
        c.advance(-1.0)


def test_sim_runs_the_real_topology():
    sim = ClusterSim(nodes=12, seed=0)
    sim.at(3, "kill", 0)
    sim.run(40)
    assert len(sim.topology.nodes) == 11
    assert sim.nodes[0].id not in sim.topology.nodes
    assert any(e["e"] == "pruned" for e in sim.events)


def test_sim_script_replay_is_exact():
    def build():
        sim = ClusterSim(nodes=24, seed=5)
        sim.at(2, "kill", 3)
        sim.at(6, "revive", 3)
        for vid in sorted(sim.node(1).volumes):
            sim.at(4, "heat", 1, vid, 3.0)
        sim.run(60)
        return sim
    assert build().digest() == build().digest()


def test_heartbeat_fault_point_drops_beats():
    pfaults.clear()
    try:
        sim = ClusterSim(nodes=10, seed=0)
        sim.at(1, "fault", "sim.heartbeat", "drop", 0.5, None, 7)
        sim.run(3)
        assert any(e["e"] == "beat_lost" for e in sim.events)
        assert any(f["point"] == "sim.heartbeat" for f in pfaults.active())
    finally:
        pfaults.clear()


@pytest.mark.parametrize("vnodes", [1, 16, 64])
def test_directory_ring_like_the_reference(vnodes):
    peers = [f"p{i}:8888" for i in range(12)]
    mine, theirs = PRing(peers, vnodes=vnodes), RRing(peers, vnodes=vnodes)
    dirs = [f"bucket{i}/dir{i}" for i in range(200)]
    ops = [("remove", "p3:8888"), ("add", "p3:8888"), ("remove", "p0:8888"),
           ("add", "new:8888"), ("remove", "absent:1"), ("add", "p5:8888")]
    for op, peer in [(None, None)] + ops:
        if op == "remove":
            assert mine.remove_peer(peer) == theirs.remove_peer(peer)
        elif op == "add":
            assert mine.add_peer(peer) == theirs.add_peer(peer)
        assert [mine.owner(d) for d in dirs] == \
            [theirs.owner(d) for d in dirs]
        assert mine.peers == theirs.peers
        assert mine.version == theirs.version
    assert PRing().owner("x") is None


def test_cli_sweeps_and_reports(capsys):
    assert pmain(["--seeds", "1", "--nodes", str(NODES), "--json",
                  "--scenarios", "steady,skew"]) == 0
    captured = capsys.readouterr()
    reports = json.loads(captured.out)
    assert [r["scenario"] for r in reports] == ["steady", "skew"]
    assert reports[1]["digest"] == rrun("skew", 0, nodes=NODES)["digest"]
    assert "clustersim: 2/2 cells clean" in captured.err
    assert reports[0]["ticks"] == TICKS["steady"]
    with pytest.raises(SystemExit):
        pmain(["--scenarios", "nope"])
