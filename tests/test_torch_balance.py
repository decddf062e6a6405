"""The port's balancer held against the reference.

The planner's cases are the reference's own (tests/test_balance.py):
each topology is built in both packages from the same heartbeat dicts on
an injected clock, and both packages' ``plan_moves`` must give equal
``Move`` lists. ``PlannerState`` runs one operation sequence in both,
``BalanceConfig.from_env`` one table of env dicts, and
``find_empty_slots`` one heat rank. The daemon runs on the port's
``LocalCluster`` as the reference's tests/test_balance_chaos.py drives
its own: a hot node drains with no lost read through an injected
``master.balance.move`` kill; a crash between copy and retire leaves a
complete copy that the next pass retires; nothing launches under the
admin lease, nor for EC volumes or volumes another daemon is moving
(ROADMAP Queue 3, D8); ``/balance/*`` and the two shell commands answer.
Every case that runs servers has its deadline, and waits on conditions,
not sleeps.
"""

import asyncio
import dataclasses
import functools
import json
import os
import signal
import threading
import time

import pytest

from seaweedfs_torch import faults as pfaults
from seaweedfs_torch.balance import BalanceConfig as PConfig
from seaweedfs_torch.balance import PlannerState as PState
from seaweedfs_torch.balance import pick_replica_target as ppick
from seaweedfs_torch.balance import plan_moves as pplan
from seaweedfs_torch.balance.planner import Move as PMove
from seaweedfs_torch.balance.planner import node_rates as prates
from seaweedfs_torch.client import Client as PClient
from seaweedfs_torch.ec import geometry as pgeo
from seaweedfs_torch.server.local_cluster import LocalCluster
from seaweedfs_torch.server.master import MasterServer as PMaster
from seaweedfs_torch.shell import commands as pcommands
from seaweedfs_torch.shell import ec_commands as pec
from seaweedfs_torch.storage.file_id import FileId
from seaweedfs_torch.topology.topology import Topology as PTopology
from seaweedfs_tpu.balance import BalanceConfig as RConfig
from seaweedfs_tpu.balance import PlannerState as RState
from seaweedfs_tpu.balance import pick_replica_target as rpick
from seaweedfs_tpu.balance import plan_moves as rplan
from seaweedfs_tpu.balance.planner import Move as RMove
from seaweedfs_tpu.balance.planner import node_rates as rrates
from seaweedfs_tpu.topology.topology import Topology as RTopology

MB = 1 << 20
PG = pgeo.Geometry(10, 4, large_block_size=64 * 1024,
                   small_block_size=4 * 1024)
PULSE = 0.15


def within(seconds: int):
    """Fail the test with TimeoutError after `seconds` (SIGALRM)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            def fire(signum, frame):
                raise TimeoutError(f"{fn.__name__}: over {seconds} s")

            old = signal.signal(signal.SIGALRM, fire)
            signal.alarm(seconds)
            try:
                return fn(*args, **kwargs)
            finally:
                signal.alarm(0)
                signal.signal(signal.SIGALRM, old)
        return wrapper
    return deco


def _wait(cond, what: str, timeout: float = 40.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.05)


# --- the planner, both packages on one topology --------------------------

class Clock:
    def __init__(self, t: float = 1_000_000.0):
        self.t = t

    def now(self) -> float:
        return self.t


def vol(vid: int, size: int = MB, read_only: bool = True,
        repl: str = "000") -> dict:
    return {"id": vid, "collection": "", "size": size,
            "read_only": read_only, "replica_placement": repl, "ttl": ""}


def _beat(nid, dc, rack, vols, rates=None, maxv=16):
    return ("beat", nid, dc, rack, vols, rates or {}, maxv)


def _build(Topology, script, limit=30 * MB, pulse=5.0):
    """A topology of one package from a script of ("beat", ...) and
    ("advance", dt) steps; returns (topology, clock)."""
    clock = Clock()
    t = Topology(volume_size_limit=limit, pulse_seconds=pulse,
                 clock=clock.now)
    for step in script:
        if step[0] == "advance":
            clock.t += step[1]
            continue
        _, nid, dc, rack, vols, rates, maxv = step
        heat = [{"id": v["id"], "reads": 10, "writes": 0,
                 "last_access": clock.now(), "read_rate": rates[v["id"]]}
                for v in vols if v["id"] in rates]
        t.register_heartbeat(nid, nid, nid, dc, rack, maxv,
                             {"volumes": [dict(v) for v in vols],
                              "ec_shards": [], "heat": heat})
    return t, clock


def _skewed():
    s = [_beat("hot:80", "dc1", "r0", [vol(1), vol(2), vol(3)],
               {1: 5.0, 2: 4.0, 3: 3.0})]
    s += [_beat(f"cold{i}:80", "dc1", f"r{i % 2}", [vol(100 + i)])
          for i in range(5)]
    return s


def _lone():
    return [_beat("hot:80", "dc1", "r0", [vol(1)], {1: 50.0})] + [
        _beat(f"cold{i}:80", "dc1", "r1", []) for i in range(4)]


def _racks(extra: bool):
    vols = [vol(1, repl="010"), vol(2, repl="010")]
    s = [_beat("a:80", "dc1", "r0", vols, {1: 5.0, 2: 4.0}),
         _beat("b:80", "dc1", "r1", vols)]
    s += [_beat(f"cold{i}:80", "dc1", "r1", []) for i in range(3)]
    if extra:
        s.append(_beat("fresh:80", "dc1", "r2", []))
    return s


def _watermark():
    s = [_beat("hot:80", "dc1", "r0", [vol(1), vol(2)], {1: 5.0, 2: 4.0})]
    s += [_beat(f"cold{i}:80", "dc1", "r1",
                [vol(200 + 2 * i), vol(201 + 2 * i)], maxv=4)
          for i in range(3)]
    return s


def _unsealed(full: bool):
    size = 29 * MB if full else MB
    return [_beat("hot:80", "dc1", "r0",
                  [vol(1, size=size, read_only=False),
                   vol(2, size=size, read_only=False)], {1: 5.0, 2: 4.0}),
            _beat("cold:80", "dc1", "r1", [])]


def _under_replicated():
    return [_beat("hot:80", "dc1", "r0",
                  [vol(1, repl="010"), vol(2, repl="010")],
                  {1: 5.0, 2: 4.0}),
            _beat("cold:80", "dc1", "r1", [])]


def _over_replicated():
    return [_beat("hot:80", "dc1", "r0", [vol(1), vol(2)],
                  {1: 5.0, 2: 4.0}),
            _beat("half:80", "dc1", "r1", [vol(1)]),
            _beat("colder:80", "dc1", "r1", [])]


def _retire_spread():
    vols = [vol(1, repl="010"), vol(2, repl="010")]
    return [_beat("a:80", "dc1", "r0", vols, {1: 5.0, 2: 4.0}),
            _beat("b:80", "dc1", "r1", [vol(1, repl="010")]),
            _beat("c:80", "dc1", "r1", [vol(1, repl="010")]),
            _beat("d:80", "dc1", "r1", vols[1:])]


def _dead_node():
    return [_beat("dead:80", "dc1", "r0", [vol(1)], {1: 9.0}),
            _beat("live:80", "dc1", "r1", [vol(2)], {2: 1.0}),
            ("advance", 20.0),
            _beat("live:80", "dc1", "r1", [vol(2)], {2: 1.0})]


def _many_hot():
    """Two hot nodes over a three-rack 010 fleet: several moves, the
    watermark and the projected rates all in play."""
    s = []
    for i in range(9):
        vols = [vol(10 * i + j, repl="010") for j in range(3)]
        rates = ({v["id"]: 3.0 + j for j, v in enumerate(vols)}
                 if i < 2 else {})
        s.append(_beat(f"n{i}:80", "dc1", f"r{i % 3}", vols, rates,
                       maxv=8))
        s.append(_beat(f"p{i}:80", "dc1", f"r{(i + 1) % 3}", vols,
                       maxv=8))
    return s


CASES = {
    "skewed": (_skewed, {}, frozenset(), range(5)),
    "lone_superhot": (_lone, {}, frozenset(), (0,)),
    "racks_no_fresh": (lambda: _racks(False), {}, frozenset(), (0,)),
    "racks_fresh": (lambda: _racks(True), {}, frozenset(), (0, 3)),
    "watermark_half": (_watermark, {"watermark": 0.5}, frozenset(), (0,)),
    "watermark_full": (_watermark, {"watermark": 1.0}, frozenset(), (0,)),
    "unsealed": (lambda: _unsealed(False), {}, frozenset(), (0,)),
    "size_full": (lambda: _unsealed(True), {}, frozenset(), (0,)),
    "under_replicated": (_under_replicated, {}, frozenset(), (0,)),
    "frozen": (_skewed, {}, frozenset({1, 2, 3}), (0,)),
    "frozen_one": (_skewed, {}, frozenset({1}), (0, 1)),
    "over_replicated": (_over_replicated, {}, frozenset(), (0,)),
    "retire_spread": (_retire_spread, {}, frozenset(), (0,)),
    "dead_node": (_dead_node, {}, frozenset(), (0,)),
    "many_hot": (_many_hot, {"max_moves": 8}, frozenset(), (0, 7)),
    "many_hot_one_move": (_many_hot, {"max_moves": 1}, frozenset(), (0,)),
}


def _cfg(Config, **kw):
    base = dict(interval=1.0, cooldown=10.0, max_moves=4, min_rate=0.05)
    base.update(kw)
    return Config(**base)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_moves_like_the_reference(name):
    build, kw, frozen, seeds = CASES[name]
    script = build()
    for seed in seeds:
        plans = []
        for Topology, plan, Config in ((PTopology, pplan, PConfig),
                                       (RTopology, rplan, RConfig)):
            t, clock = _build(Topology, script)
            plans.append([m.to_dict() for m in plan(
                t, _cfg(Config, **kw), clock.now(), seed=seed,
                frozen=frozen)])
        assert plans[0] == plans[1], (name, seed)
        assert json.dumps(plans[0], sort_keys=True) == \
            json.dumps(plans[1], sort_keys=True)


def test_plan_cases_plan_what_the_reference_pins():
    """The reference's assertions on the same cases, on the port."""
    def plan(name, seed=0):
        build, kw, frozen, _ = CASES[name]
        t, clock = _build(PTopology, build())
        return pplan(t, _cfg(PConfig, **kw), clock.now(), seed=seed,
                     frozen=frozen)

    for seed in range(5):
        moves = plan("skewed", seed)
        assert moves and all(m.src == "hot:80" and m.dst != "hot:80"
                             for m in moves)
        assert 0 < sum(m.rate for m in moves) < 12.0
    assert plan("lone_superhot") == []
    assert plan("racks_no_fresh") == []
    assert {m.dst for m in plan("racks_fresh")} == {"fresh:80"}
    assert plan("watermark_half") == [] and plan("watermark_full")
    assert plan("unsealed") == [] and plan("size_full")
    assert plan("under_replicated") == [] and plan("frozen") == []
    by_vid = {m.vid: m for m in plan("over_replicated")}
    assert by_vid[1].dst == "half:80" and "retire" in by_vid[1].reason
    assert all(m.vid != 1 for m in plan("retire_spread"))
    assert all("dead:80" not in (m.src, m.dst) for m in plan("dead_node"))


def test_plan_keeps_the_placement_where_the_reference_breaks_it():
    """D5 for moves: a 010 volume on two racks of one data center may
    move to another rack of that data center, never to a second data
    center; the reference counts only distinct racks and DCs, so it
    moves the copy to the other data center."""
    script = [_beat("a:80", "dc1", "r0", [vol(1, repl="010"),
                                          vol(2, repl="010")],
                    {1: 5.0, 2: 4.0}),
              _beat("b:80", "dc1", "r1", [vol(1, repl="010"),
                                          vol(2, repl="010")]),
              _beat("far:80", "dc2", "r9", [])]
    got = {}
    for Topology, plan, Config in ((PTopology, pplan, PConfig),
                                   (RTopology, rplan, RConfig)):
        t, clock = _build(Topology, script)
        got[Topology.__module__.split(".")[0]] = [
            m.dst for m in plan(t, _cfg(Config), clock.now())]
    assert got["seaweedfs_torch"] == []
    assert got["seaweedfs_tpu"] and set(got["seaweedfs_tpu"]) == {"far:80"}
    script.append(_beat("near:80", "dc1", "r2", []))
    t, clock = _build(PTopology, script)
    assert {m.dst for m in pplan(t, _cfg(PConfig), clock.now())} == \
        {"near:80"}


def test_node_rates_and_pruned_heat_like_the_reference():
    """A node past the prune window never ranks (node_rates), pruning
    drops its heat, and the default heat view keeps every registered
    node, in both packages."""
    out = []
    for Topology, rates in ((PTopology, prates), (RTopology, rrates)):
        t, clock = _build(Topology, _dead_node(), pulse=1.0)
        now = clock.now()
        before = sorted(t.heat_view(now + 3600.0))
        dead = t.nodes["dead:80"]
        pruned = [e["url"] for e in t.prune_dead_nodes()]
        out.append((sorted(rates(t, now)), before, pruned,
                    sorted(t.heat_view(now)), dict(dead.heat)))
    assert out[0] == out[1]
    assert out[0][0] == ["live:80"] and out[0][1] == [1, 2]
    assert out[0][2] == ["dead:80"] and out[0][3] == [2]
    assert out[0][4] == {}


# --- PlannerState, BalanceConfig, find_empty_slots -----------------------

def _mv(Move, vid=1, src="a:80", dst="b:80"):
    return Move(vid=vid, collection="", src=src, dst=dst, src_url=src,
                dst_url=dst, bytes=MB, rate=1.0, reason="test")


STATE_SCRIPT = [
    ("confirm", [(1, "a:80", "b:80")], 0.0),
    ("confirm", [(1, "a:80", "b:80")], 1.0),
    ("confirm", [(1, "a:80", "b:80")], 2.0),
    ("confirm", [(2, "a:80", "b:80")], 3.0),
    ("confirm", [(2, "a:80", "c:80")], 4.0),
    ("confirm", [(2, "a:80", "c:80")], 5.0),
    ("confirm", [(3, "a:80", "b:80")], 6.0),
    ("confirm", [], 7.0),
    ("confirm", [(3, "a:80", "b:80")], 8.0),
    ("reset",),
    ("confirm", [(3, "a:80", "b:80")], 9.0),
    ("done", (1, "a:80", "b:80"), 100.0),
    ("frozen", 105.0),
    ("frozen", 111.0),
    ("vetoed", (1, "b:80", "a:80")),
    ("confirm", [(1, "b:80", "a:80"), (4, "a:80", "b:80")], 111.0),
    ("confirm", [(1, "b:80", "a:80"), (4, "a:80", "b:80")], 112.0),
    ("frozen", 150.0),
    ("vetoed", (1, "b:80", "a:80")),
    ("state",),
]


def _run_state(State, Move, Config) -> list:
    st = State(_cfg(Config, cooldown=10.0))
    out = []
    for step in STATE_SCRIPT:
        op = step[0]
        if op == "confirm":
            got = st.confirm([_mv(Move, *m) for m in step[1]], step[2])
            out.append([m.to_dict() for m in got])
        elif op == "reset":
            st.reset()
        elif op == "done":
            st.record_done(_mv(Move, *step[1]), step[2])
        elif op == "frozen":
            out.append(sorted(st.frozen(step[1])))
        elif op == "vetoed":
            out.append(st.vetoed(_mv(Move, *step[1])))
        else:
            out.append(st.to_dict())
    return out


def test_planner_state_sequence_like_the_reference():
    mine = _run_state(PState, PMove, PConfig)
    assert mine == _run_state(RState, RMove, RConfig)
    # two passes confirm, a launch starts over, absence resets, a veto
    # blocks the reverse move until 4 x cooldown
    assert [m["vid"] for m in mine[1]] == [1] and mine[2] == []
    assert mine[13] == [] and [m["vid"] for m in mine[14]] == [4]
    assert mine[12] is True and mine[15] == [] and mine[16] is False


ENVS = [
    {},
    {"WEED_BALANCE_INTERVAL": "2", "WEED_BALANCE_HOT_RATIO": "2.5",
     "WEED_BALANCE_COLD_RATIO": "0.5", "WEED_BALANCE_MIN_RATE": "1",
     "WEED_BALANCE_MAX_MOVES": "9", "WEED_BALANCE_COOLDOWN": "30",
     "WEED_BALANCE_WATERMARK": "0.6"},
    {"WEED_BALANCE_INTERVAL": "0", "WEED_BALANCE_HOT_RATIO": "0.2",
     "WEED_BALANCE_COLD_RATIO": "7", "WEED_BALANCE_MIN_RATE": "-3",
     "WEED_BALANCE_MAX_MOVES": "0", "WEED_BALANCE_COOLDOWN": "-1",
     "WEED_BALANCE_WATERMARK": "0"},
    {"WEED_BALANCE_WATERMARK": "3", "WEED_BALANCE_COLD_RATIO": "-1"},
    {"WEED_BALANCE_INTERVAL": "abc", "WEED_BALANCE_MAX_MOVES": "x",
     "WEED_BALANCE_MIN_RATE": ""},
    {"WEED_BALANCE_ENABLED": "0"},
    {"WEED_BALANCE_ENABLED": "false", "WEED_BALANCE_ASSIGN": "no"},
    {"WEED_BALANCE_ENABLED": "1", "WEED_BALANCE_ASSIGN": "0"},
    {"WEED_BALANCE_ENABLED": "yes", "WEED_BALANCE_ASSIGN": "1"},
    {"WEED_BALANCE_MAX_MOVES": "3.7"},
]


@pytest.mark.parametrize("i", range(len(ENVS)))
def test_balance_config_from_env_like_the_reference(i):
    mine = PConfig.from_env(ENVS[i])
    theirs = RConfig.from_env(ENVS[i])
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.enabled == theirs.enabled


def test_balance_config_reads_the_process_env(monkeypatch):
    monkeypatch.setenv("WEED_BALANCE_INTERVAL", "7")
    monkeypatch.setenv("WEED_BALANCE_ENABLED", "0")
    cfg = PConfig.from_env()
    assert cfg.interval == 7.0 and not cfg.enabled


@pytest.mark.parametrize("repl", ["000", "001", "010", "100"])
def test_find_empty_slots_heat_rank_like_the_reference(repl):
    """Coldest first, then most free slots, then id; the placement
    constraints decide among them as without a rank."""
    script = []
    for i in range(8):
        script.append(_beat(f"n{i}:80", f"dc{i % 2}", f"r{i % 3}",
                            [vol(100 + j) for j in range(i % 3)],
                            maxv=6))
    rank = {f"n{i}:80": [3.0, 0.5, 0.0, 2.0, 0.0, 1.0, 0.25, 0.0][i]
            for i in range(8)}
    picks = []
    for Topology in (PTopology, RTopology):
        t, _ = _build(Topology, script)
        picks.append([n.id for n in t.find_empty_slots(
            repl, heat_rank=rank)])
        picks.append([n.id for n in t.find_empty_slots(
            repl, "dc1", heat_rank=rank)])
    assert picks[0] == picks[2] and picks[1] == picks[3]
    assert picks[0]
    if repl == "000":
        assert picks[0] == ["n4:80"]  # coldest, then most free slots


@pytest.mark.parametrize("case", ["fresh_rack", "pending", "holders"])
def test_pick_replica_target_like_the_reference(case):
    """The reference's placement cases, where both keep the 010
    placement on one data center."""
    script = [_beat("h0:80", "dc1", "r0", [vol(1, repl="010")], maxv=8),
              _beat("same:80", "dc1", "r0", [], maxv=8),
              _beat("other1:80", "dc1", "r1", [], maxv=8),
              _beat("other2:80", "dc1", "r1", [], maxv=8)]
    if case == "holders":
        script = [_beat("h0:80", "dc1", "r0", [vol(1, repl="010")]),
                  _beat("h1:80", "dc1", "r1", [vol(1, repl="010")])]
    out = []
    for Topology, pick in ((PTopology, ppick), (RTopology, rpick)):
        t, _ = _build(Topology, script)
        holders = [t.nodes[n] for n in sorted(t.nodes)
                   if 1 in t.nodes[n].volumes]
        if case == "pending":
            pending: dict = {}
            picked = []
            for _ in range(2):
                tgt = pick(t, "010", holders, pending=pending)
                pending[tgt.id] = pending.get(tgt.id, 0) + 1
                picked.append(tgt.id)
            out.append(picked)
        else:
            tgt = pick(t, "010", holders)
            out.append(None if tgt is None else tgt.id)
    assert out[0] == out[1]
    if case == "fresh_rack":
        assert out[0] in ("other1:80", "other2:80")
    elif case == "pending":
        assert len(set(out[0])) == 2
    else:
        assert out[0] is None


# --- the daemon on a cluster ----------------------------------------------

@pytest.fixture()
def fast_heat(monkeypatch):
    """A short heat half-life, so a burst of reads ranks a node hot
    within a few heartbeats; the faults plane clean either side."""
    monkeypatch.setenv("WEED_LIFECYCLE_HEAT_HALFLIFE", "2")
    pfaults.clear()
    yield
    pfaults.clear()


def _balance_cluster(interval: float, n: int = 3, racks: int = 1,
                     **master_kw) -> LocalCluster:
    return LocalCluster(
        n, coder_name="numpy", geometry=PG, volume_size_limit_mb=1,
        pulse=PULSE, racks=racks,
        master_kwargs={"balance_config": PConfig(
            interval=interval, cooldown=3.0, max_moves=2, min_rate=0.01,
            watermark=1.0, force_enabled=True),
            "repair_enabled": False, **master_kw})


def _holder_of(cl, vid: int) -> list:
    return [cl.url(i) for i in range(len(cl.nodes))
            if cl.nodes[i][2] is not None
            and cl.store(i).find_volume(vid) is not None]


def _sealed_pair(cl, client, size: int = 972_800):
    """Blobs of 0.95 MB (the limit is 1 MB: each seals its volume by
    size), one collection each, until one server holds two; a lone hot
    volume never moves. Returns (url, [(vid, fid, data), ...])."""
    held: dict = {}
    for i in range(8):
        data = bytes([65 + i]) * size
        fid = client.upload(data, collection=f"hot{i}")
        vid = int(fid.split(",")[0])
        _wait(lambda: any(v["id"] == vid for n in
                          client.dir_status()["nodes"]
                          for v in n["volumes"]), "the volume's beat")
        holder = _holder_of(cl, vid)[0]
        held.setdefault(holder, []).append((vid, fid, data))
        if len(held[holder]) >= 2:
            return holder, held[holder][:2]
    raise AssertionError(f"no server held two volumes: {held}")


class _Reader(threading.Thread):
    """Reads both hot blobs for the whole test: the heat source and the
    probe that no read ever returns wrong bytes."""

    def __init__(self, master_url: str, blobs, prefer: str = "",
                 weights=None):
        super().__init__(daemon=True)
        self.client = PClient(master_url)
        # each blob read `weight` times a round
        self.blobs = [b for b, w in zip(blobs, weights or [1] * len(blobs))
                      for _ in range(w)]
        # read from this holder while it has the blob (the heat stays on
        # the source until it is retired), else through the lookup
        self.prefer = prefer
        self.stop = threading.Event()
        self.ok = self.transient = self.corrupt = 0

    def _get(self, fid: str) -> bytes:
        if self.prefer:
            try:
                return self.client.download(fid, url=self.prefer)
            except Exception:
                pass
        return self.client.download(fid)

    def run(self):
        while not self.stop.is_set():
            for _vid, fid, data in self.blobs:
                self.client._vid_cache.clear()
                try:
                    got = self._get(fid)
                except Exception:
                    self.transient += 1
                    continue
                if got == data:
                    self.ok += 1
                else:
                    self.corrupt += 1
            time.sleep(0.01)


@within(120)
def test_hot_node_drains_zero_loss_through_injected_move_kill(fast_heat):
    """Reads heat one node and the balancer, on its timer, drains it;
    the first move dies at ``master.balance.move`` (before its copy),
    the source stays whole, the retry completes, no read returns wrong
    bytes and every write acknowledged meanwhile reads back."""
    cl = _balance_cluster(interval=0.25)
    try:
        client = PClient(cl.master_url)
        src_url, blobs = _sealed_pair(cl, client)
        pfaults.set_fault("master.balance.move", "error", count=1)
        reader = _Reader(cl.master_url, blobs)
        reader.start()
        written = []
        try:
            _wait(lambda: any(e["outcome"] == "failed"
                              for e in cl.master.balancer.recent),
                  "the injected move failure", timeout=60)
            failed = next(e for e in cl.master.balancer.recent
                          if e["outcome"] == "failed")
            assert "master.balance.move" in failed["error"]
            for vid, _, _ in blobs:
                assert src_url in _holder_of(cl, vid)
            for i in range(3):
                data = b"w%d" % i * 64
                written.append((client.upload(data), data))
            _wait(lambda: cl.master.balancer.moves_done >= 1,
                  "the retried move", timeout=60)
        finally:
            reader.stop.set()
            reader.join(timeout=10)
        moved = next(e for e in cl.master.balancer.recent
                     if e["outcome"] == "ok")
        assert moved["src"] == src_url
        _wait(lambda: _holder_of(cl, moved["volume"]) == [moved["dst"]],
              "one copy, on the destination")
        assert reader.ok > 0 and reader.corrupt == 0, vars(reader)
        for _, fid, data in blobs:
            client._vid_cache.clear()
            assert client.download(fid) == data
        for fid, data in written:
            assert client.download(fid) == data
    finally:
        pfaults.clear()
        cl.shutdown()


@within(120)
def test_crash_between_copy_and_retire_leaves_complete_copy(fast_heat):
    """The move dies after its copy verified and before the source is
    retired: both sides hold a complete copy, reads go on, and the retry
    (the resume path) retires the source without copying again."""
    cl = _balance_cluster(interval=0.3)
    try:
        client = PClient(cl.master_url)
        src_url, blobs = _sealed_pair(cl, client)
        # sealed read-only too (volume.mark -readonly): the move must
        # carry the seal to the copy (D8)
        for vid, _, _ in blobs:
            client.volume_admin(src_url, "volume/readonly",
                                {"volume_id": vid, "read_only": True})
        copies, crashed = [], []
        orig = cl.master._admin_post

        async def flaky(url, op, body, timeout=60.0):
            if op == "volume/copy":
                copies.append(body["volume_id"])
            if op == "volume/delete" and not crashed:
                crashed.append(url)
                raise RuntimeError("injected crash before retire")
            return await orig(url, op, body, timeout=timeout)

        cl.master._admin_post = flaky
        # the surplus copy is retired by a move off the hot source that
        # improves on it: the reads stay on the source, and the first
        # volume is three times as hot as the second, so it alone moves
        # (and crashes) and the second keeps the source the hotter side
        reader = _Reader(cl.master_url, blobs, prefer=src_url,
                         weights=(3, 1))
        reader.start()
        try:
            _wait(lambda: crashed, "the crash between copy and retire",
                  timeout=60)
            failed = next(e for e in cl.master.balancer.recent
                          if e["outcome"] == "failed")
            vid = failed["volume"]
            holders = _holder_of(cl, vid)
            assert len(holders) == 2 and src_url in holders, holders
            assert vid == blobs[0][0]
            _wait(lambda: any(e["outcome"] == "ok" and e["volume"] == vid
                              for e in cl.master.balancer.recent),
                  "the resume path's retire", timeout=60)
        finally:
            reader.stop.set()
            reader.join(timeout=10)
        moved = next(e for e in cl.master.balancer.recent
                     if e["outcome"] == "ok" and e["volume"] == vid)
        assert copies.count(vid) == 1, copies
        _wait(lambda: _holder_of(cl, vid) == [moved["dst"]],
              "one copy left")
        # the seal travelled with the volume (D8)
        dst_store = cl.store(cl.index_of(moved["dst"]))
        assert dst_store.find_volume(vid).read_only
        assert reader.corrupt == 0 and reader.ok > 0, vars(reader)
        for _, fid, data in blobs:
            client._vid_cache.clear()
            assert client.download(fid) == data
    finally:
        cl.shutdown()


class _Writer(threading.Thread):
    """Uploads small needles into the given collections until stopped;
    keeps every acknowledged (fid, data)."""

    def __init__(self, master_url: str, collections: list, tag: int):
        super().__init__(daemon=True)
        self.client = PClient(master_url)
        self.collections = collections
        self.tag = tag
        self.stop = threading.Event()
        self.acked: list = []
        self.refused = 0

    def run(self):
        i = 0
        while not self.stop.is_set():
            data = b"w%d-%d|" % (self.tag, i)
            coll = self.collections[i % len(self.collections)]
            i += 1
            try:
                fid = self.client.upload(data, collection=coll)
            except Exception:
                self.refused += 1
                time.sleep(0.01)
                continue
            self.acked.append((fid, data))
            time.sleep(0.005)


@within(120)
def test_writes_into_a_size_sealed_volume_survive_its_move(fast_heat):
    """Two ``010`` volumes past 0.9 of the limit (movable by size, still
    writable) take uploads while the balancer moves one off their hot
    holder; the window between the copy and the retire is widened to
    0.5 s. The move seals every holder before its copy (D8), so every
    acknowledged needle is on every holder of its volume afterwards,
    read from the holders' stores (an HTTP read would repair a miss)."""
    cl = _balance_cluster(interval=0.25, n=4, racks=2,
                          default_replication="010")
    try:
        client = PClient(cl.master_url)
        src_url, blobs = _sealed_pair(cl, client, size=946_000)
        colls = [cl.store(cl.index_of(src_url)).find_volume(vid).collection
                 for vid, _, _ in blobs]
        orig = cl.master._admin_post

        async def widened(url, op, body, timeout=60.0):
            out = await orig(url, op, body, timeout=timeout)
            if op == "volume/copy":
                await asyncio.sleep(0.5)
            return out

        cl.master._admin_post = widened
        reader = _Reader(cl.master_url, blobs, prefer=src_url,
                         weights=(3, 1))
        writers = [_Writer(cl.master_url, colls, k) for k in range(3)]
        reader.start()
        for w in writers:
            w.start()
        try:
            _wait(lambda: cl.master.balancer.moves_done >= 1,
                  "a completed move", timeout=60)
        finally:
            for t in [reader, *writers]:
                t.stop.set()
            for t in [reader, *writers]:
                t.join(timeout=10)
        moved = next(e for e in cl.master.balancer.recent
                     if e["outcome"] == "ok")
        assert moved["src"] == src_url
        vid = moved["volume"]
        _wait(lambda: src_url not in _holder_of(cl, vid)
              and len(_holder_of(cl, vid)) == 2, "two holders, no source")
        acked = [w.acked for w in writers]
        into_moved = [(FileId.parse(fid), data) for batch in acked
                      for fid, data in batch
                      if FileId.parse(fid).volume_id == vid]
        assert into_moved, "no upload landed in the moved volume"
        for url in _holder_of(cl, vid):
            store = cl.store(cl.index_of(url))
            assert store.find_volume(vid).read_only, url
            for f, data in into_moved:
                assert store.read_needle(vid, f.key, f.cookie).data \
                    == data, (url, f)
        assert reader.corrupt == 0, vars(reader)
        for batch in acked:
            for fid, data in batch:
                client._vid_cache.clear()
                assert client.download(fid) == data
    finally:
        cl.shutdown()


def _hot_topology_master(interval: float = 1.0) -> PMaster:
    """A master (not served) whose topology has one hot node of three
    sealed volumes and two cold ones."""
    m = PMaster(volume_size_limit_mb=30, pulse_seconds=5.0,
                balance_config=PConfig(interval=interval, cooldown=3.0,
                                       min_rate=0.01, watermark=1.0,
                                       force_enabled=True))
    now = time.time()
    for nid, vols, rates in (("hot:1", [1, 2, 3], {1: 5.0, 2: 4.0,
                                                   3: 3.0}),
                             ("cold0:1", [10], {}), ("cold1:1", [11], {})):
        m.topology.register_heartbeat(
            nid, nid, nid, "dc1", "r0", 8,
            {"volumes": [vol(v) for v in vols], "ec_shards": [],
             "heat": [{"id": v, "reads": 10, "writes": 0,
                       "last_access": now, "read_rate": r}
                      for v, r in rates.items()]})
    return m


def test_nothing_launches_under_the_admin_lease():
    """While an operator holds the admin lease a pass launches nothing
    and forgets its first sightings; once released, two passes launch
    (the reference's balancer launches under the lease, D8)."""
    async def drive(master) -> list:
        launched = []
        master.balancer._launch = lambda mv: launched.append(mv.vid)
        token = master.lease_admin_token("admin", "shell-x", 0)[0]["token"]
        held = [await master.balancer.pass_once() for _ in range(3)]
        during = list(launched)
        master.release_admin_token("admin", token)
        first = await master.balancer.pass_once()
        second = await master.balancer.pass_once()
        return [held, during, first, second]

    held, during, first, second = asyncio.run(drive(
        _hot_topology_master()))
    assert during == []
    assert all("admin lease held by shell-x" in h["skipped"]
               for h in held)
    assert first["planned"] > 0 and first["launched"] == []
    assert [m["vid"] for m in second["launched"]]


def test_ec_and_moving_volumes_are_skipped():
    """A volume with EC shards anywhere never moves; nor does one a
    repair or a lifecycle transition is moving (D8)."""
    async def drive(master) -> list:
        launched = []
        master.balancer._launch = lambda mv: launched.append(mv.vid)
        for _ in range(2):
            await master.balancer.pass_once()
        return sorted(launched)

    free = asyncio.run(drive(_hot_topology_master()))
    assert 1 in free
    m = _hot_topology_master()
    m.topology.register_heartbeat(
        "cold1:1", "cold1:1", "cold1:1", "dc1", "r0", 8,
        {"volumes": [vol(11)], "ec_shards": [
            {"id": 1, "collection": "", "shard_ids": [0, 1]}]})
    m._repairs_inflight.add(("replica", 2))
    m.lifecycle._inflight[("warm", 3)] = time.monotonic()
    assert asyncio.run(drive(m)) == []
    m._repairs_inflight.clear()
    m.lifecycle._inflight.clear()
    moved = asyncio.run(drive(m))
    assert moved and 1 not in moved


@within(60)
def test_balance_endpoints_and_shell_commands(fast_heat):
    """``GET /balance/status``, ``POST /balance/run`` and the shell's
    ``cluster.balance.status [-hot N]`` / ``cluster.balance.run``;
    ``/dir/assign`` grows new volumes on the coldest node first."""
    cl = _balance_cluster(interval=3600.0)
    try:
        client = PClient(cl.master_url)
        st = client.balance_status()
        assert st["enabled"] and st["is_leader"]
        assert set(st["node_rates"]) == {cl.url(i) for i in range(3)}
        assert st["config"]["interval"] == 3600.0
        ran = client.balance_run()
        assert ran["ok"] and ran["planned"] == 0 and ran["launched"] == []
        pcommands._register_all()
        env = pcommands.CommandEnv(client, PG)
        out = pcommands.run_command(env, ["cluster.balance.status",
                                          "-hot", "2"])
        assert len(out["node_rates"]) == 2 and out["nodes_tracked"] == 3
        assert pcommands.run_command(env, "cluster.balance.run")["ok"]
        assert cl.master.balancer.passes == 2
        # heat on one node: a new collection's volume grows elsewhere
        fid = client.upload(b"x" * 1000, collection="warm")
        vid = int(fid.split(",")[0])
        hot = _holder_of(cl, vid)[0]
        for _ in range(200):
            client.download(fid)
        _wait(lambda: client.balance_status()["node_rates"][hot] > 1.0,
              "the node ranks hot")
        rank = cl.master.balancer.assign_rank()
        assert max(rank, key=rank.get) == hot
        for i in range(3):
            fid2 = client.upload(b"y" * 1000, collection=f"new{i}")
            assert _holder_of(cl, int(fid2.split(",")[0])) != [hot]
    finally:
        cl.shutdown()


# --- F5: the admin lease waits for the daemons' jobs ----------------------

def _slow_ec_copy(master, delay: float, seen: list):
    """Slow the master's ec/copy admin calls (the repair's first step)
    by `delay` seconds, like a delay fault at that step."""
    orig = master._admin_post

    async def slowed(url, op, body, timeout=60.0):
        if op == "ec/copy":
            seen.append(("copy", time.monotonic()))
            await asyncio.sleep(delay)
        out = await orig(url, op, body, timeout=timeout)
        seen.append((op, time.monotonic()))
        return out

    master._admin_post = slowed


@within(120)
def test_lease_waits_for_a_running_repair_before_ec_decode():
    """F5: a repair slowed at its ec/copy is running when the shell's
    ec.decode asks for the lease; the lease waits for the repair, the
    decode succeeds after it, and every needle reads back."""
    cl = LocalCluster(4, coder_name="numpy", geometry=PG,
                      volume_size_limit_mb=1, pulse=PULSE, racks=1,
                      master_kwargs={"maintenance_interval_seconds": PULSE})
    try:
        client = PClient(cl.master_url)
        blobs = {}
        for i in range(4):
            data = os.urandom(20_000 + 1000 * i)
            blobs[client.upload(data, collection="f5")] = data
        vid = int(next(iter(blobs)).split(",")[0])
        pec.EcCommands(client, PG).encode(vid, "f5")
        seen: list = []
        _slow_ec_copy(cl.master, 2.0, seen)
        lease = cl.master.lease_admin_token

        def leased(name, client_id, previous):
            out = lease(name, client_id, previous)
            if not previous:
                seen.append(("lease", time.monotonic(), out[1]))
            return out

        cl.master.lease_admin_token = leased
        # lose one shard by a direct admin call (unguarded, D6)
        holders = client.ec_lookup(vid)["shards"]
        url = holders["0"][0]
        client.volume_admin(url, "ec/delete_shards",
                            {"volume_id": vid, "collection": "f5",
                             "shard_ids": [0]})
        _wait(lambda: any(op == "copy" for op, _ in seen),
              "the repair reaches its ec/copy")
        assert cl.master.daemon_jobs()
        t0 = time.monotonic()
        pec.EcCommands(client, PG).decode(vid, "f5")
        waited = time.monotonic() - t0
        repair_end = max(e[1] for e in seen if e[0] in ("ec/mount",
                                                         "ec/delete_shards"))
        grants = [e[1] for e in seen if e[0] == "lease" and e[2] == 200]
        assert grants and min(grants) > repair_end
        assert waited > 0.5
        assert cl.master.metrics.value(
            "repairs_succeeded", labels={"kind": "ec"}) >= 1
        client._vid_cache.clear()
        for fid, data in blobs.items():
            assert client.download(fid) == data
    finally:
        cl.shutdown()


def test_fresh_lease_pauses_the_daemons_while_it_waits():
    """F5: while a fresh lease waits for a running repair, a repair
    queued for the one slot gives way, and passes that could launch a
    repair or a balance move launch nothing; the lease is granted once
    the running repair ends, and after its release the same pass
    launches the repair."""
    async def drive(m):
        m._repair_sem = asyncio.Semaphore(1)
        ran: list = []
        release = asyncio.Event()

        async def job(vid):
            ran.append(vid)
            if vid == 7:
                await release.wait()
            return True

        async def repair_pass():
            m._launch_repair(("replica", 8), job, 8)

        m._repair_pass = repair_pass
        launched: list = []
        m.balancer._launch = lambda mv: launched.append(mv.vid)
        m._launch_repair(("ec", 7), job, 7)
        await asyncio.sleep(0)
        m._launch_repair(("ec", 9), job, 9)     # queued for the slot
        lease = asyncio.create_task(
            m.request_admin_lease("admin", "shell-x", 0))
        await asyncio.sleep(0.05)
        paused = m.daemons_paused()
        passes = [await m.balancer.pass_once() for _ in range(2)]
        await m._maintenance_pass()
        release.set()
        granted = await asyncio.wait_for(lease, 5)
        jobs_at_grant = m.daemon_jobs()
        m.release_admin_token("admin", granted[0]["token"])
        await m._maintenance_pass()
        for _ in range(100):
            if 8 in ran:
                break
            await asyncio.sleep(0.01)
        return paused, passes, granted, jobs_at_grant, ran, launched

    paused, passes, granted, jobs_at_grant, ran, launched = asyncio.run(
        drive(_hot_topology_master()))
    assert paused and "waits" in paused
    assert all(p.get("skipped") == paused for p in passes)
    assert granted[1] == 200, granted
    assert jobs_at_grant == set()
    assert launched == []
    assert ran == [7, 8]


def test_lease_refused_while_jobs_run_past_the_bound():
    """With a daemon job still in flight after the bound, a fresh lease
    is answered as one another client holds; a renewal is not held
    back, and once the jobs end the lease is granted."""
    async def drive():
        m = PMaster()
        m.admin_lease_wait_seconds = 0.2
        m._repairs_inflight.add(("ec", 7))
        fresh = m.lease_admin_token("admin", "a", 0)
        t0 = time.monotonic()
        await m._daemon_jobs_drained(m.admin_lease_wait_seconds)
        waited = time.monotonic() - t0
        m._repairs_inflight.clear()
        granted = m.lease_admin_token("admin", "a", 0)
        m.balancer._inflight[("balance", 3)] = time.monotonic()
        renewed = m.lease_admin_token("admin", "a", granted[0]["token"])
        other = m.lease_admin_token("admin", "b", 0)
        return fresh, waited, granted, renewed, other

    fresh, waited, granted, renewed, other = asyncio.run(drive())
    assert fresh[1] == 409 and fresh[0]["holder"] == "daemons"
    assert waited >= 0.2
    assert granted[1] == 200 and renewed[1] == 200
    assert renewed[0]["token"] == granted[0]["token"]
    assert other[1] == 409 and other[0]["holder"] == "a"
