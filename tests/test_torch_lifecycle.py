"""The lifecycle plane of the port against the reference's.

Access heat (``lifecycle/heat.py``), the policy (``lifecycle/policy.py``,
``plan_transitions``), the master topology's heat view and the encode
batcher run in both packages on the same inputs with the same clock, and
must give the same deltas, views, plans and windows. Then the port's
daemon on the port's ``LocalCluster`` (``device="cpu"``; the shrunk
RS(10,4) geometry of tests/cluster_util.py): an idle full volume warms
down with no command into shards byte-identical to the reference's
``fused_vacuum_gzip_encode`` of a snapshot; a crash at
``lifecycle.warm`` or ``lifecycle.encode`` keeps the data and converges;
TTL expiry frees disk and topology; a hot EC volume is decoded back.
Every case that runs servers has its own deadline.
"""

import asyncio
import functools
import os
import random
import shutil
import signal
import time
from dataclasses import asdict

import pytest
import torch

from cluster_util import TEST_GEOMETRY, Cluster
from seaweedfs_torch import faults as pfaults
from seaweedfs_torch import lifecycle as plc
from seaweedfs_torch.client import Client as PClient
from seaweedfs_torch.client import ClientError as PClientError
from seaweedfs_torch.ec import geometry as pgeo
from seaweedfs_torch.lifecycle import daemon as pdaemon
from seaweedfs_torch.lifecycle import heat as pheat
from seaweedfs_torch.server.local_cluster import LocalCluster
from seaweedfs_torch.shell import ec_commands as pec
from seaweedfs_torch.topology import topology as ptopo
from seaweedfs_tpu import ec as rec_mod
from seaweedfs_tpu import lifecycle as rlc
from seaweedfs_tpu.ec import fused as rfused
from seaweedfs_tpu.lifecycle import daemon as rdaemon
from seaweedfs_tpu.lifecycle import heat as rheat
from seaweedfs_tpu.storage.store import Store as RStore
from seaweedfs_tpu.storage.volume import Volume as RVolume
from seaweedfs_tpu.topology import topology as rtopo

torch.set_num_threads(1)

PG = pgeo.Geometry(10, 4, large_block_size=64 * 1024,
                   small_block_size=4 * 1024)
TOTAL = PG.total_shards
PULSE = 0.15
CODERS = {"numpy": {"coder_name": "numpy"},
          "torch_cpu": {"coder_name": "torch", "device": "cpu"}}


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


def _wait(cond, what: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.05)


class _Clock:
    """A settable clock standing in for the ``time`` module."""

    def __init__(self, now: float = 1000.0):
        self.now = now

    def time(self) -> float:
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(rheat, "time", c)
    monkeypatch.setattr(pheat, "time", c)
    return c


# --- heat: the tracker, the master's records, the topology's view ------

def test_heat_tracker_deltas_are_changed_volumes_only(clock):
    out = []
    for mod in (rheat, pheat):
        t = mod.HeatTracker(halflife=10.0)
        steps = []
        for _ in range(5):
            t.record_read(1)
        t.record_write(2)
        clock.now += 2.0
        steps.append(t.deltas())
        steps.append(t.deltas())       # nothing touched: empty
        t.record_read(1)
        clock.now += 1.0
        steps.append(t.deltas())
        out.append(steps)
        clock.now -= 3.0
    assert out[0] == out[1]
    first, empty, again = out[1]
    assert [e["id"] for e in first] == [1, 2] and empty == []
    assert first[0]["reads"] == 5 and first[0]["read_rate"] > 0
    assert [e["id"] for e in again] == [1]


def test_heat_tracker_prunes_and_requeues(clock):
    out = []
    for mod in (rheat, pheat):
        t = mod.HeatTracker(halflife=10.0)
        t.record_read(7)
        t.record_read(8)
        t.record_write(8)
        clock.now += 1.0
        kept = t.deltas(known_vids={7, 8})
        # a failed heartbeat puts the window back; nothing is lost
        t.requeue(kept)
        clock.now += 1.0
        again = t.deltas(known_vids={7})
        out.append((kept, again, sorted(t._stats)))
        clock.now -= 2.0
    assert out[0] == out[1]
    kept, again, left = out[1]
    assert [e["id"] for e in again] == [7] and left == [7]
    assert again[0]["reads"] == 1


@pytest.mark.parametrize("entries,nows", [
    ([{"reads": 10, "writes": 2, "last_access": 105.0, "read_rate": 4.0}],
     [105.0, 705.0, 1305.0]),
    ([{"reads": 1, "read_rate": 0.5, "last_access": 10.0},
      {"writes": 3, "read_rate": 2.0, "last_access": 50.0}],
     [50.0, 60.0, 5000.0]),
])
def test_volume_heat_merge_and_decay(entries, nows):
    out = []
    for mod in (rheat, pheat):
        vh = mod.VolumeHeat(first_seen=100.0, updated=100.0)
        for e in entries:
            vh.merge(e, now=e["last_access"])
        out.append([vh.to_dict(now) for now in nows]
                   + [vh.rate_now(now) for now in nows])
    assert out[0] == out[1]


def _topologies(clock):
    return [mod.Topology(volume_size_limit=1024 * 1024, pulse_seconds=5.0,
                         clock=clock.time) for mod in (rtopo, ptopo)]


def _beat(topos, clock, t: float, url: str, volumes=(), ec=(), heat=(),
          rack: str = "r"):
    clock.now = t
    for topo in topos:
        topo.register_heartbeat(url, url, url, "dc", rack, 16, {
            "volumes": [dict(v) for v in volumes],
            "ec_shards": [dict(s) for s in ec],
            "heat": [dict(h) for h in heat]})


def test_topology_heat_view_matches_reference(clock):
    topos = _topologies(clock)
    v1 = {"id": 1, "size": 10}
    v2 = {"id": 2, "size": 10}
    _beat(topos, clock, 100.0, "a:1", [v1, v2])
    _beat(topos, clock, 101.0, "b:1", [v1])
    _beat(topos, clock, 110.0, "a:1", [v1, v2], heat=[
        {"id": 1, "reads": 4, "writes": 1, "last_access": 109.0,
         "read_rate": 2.0}, {"id": 9, "reads": 1}])
    _beat(topos, clock, 111.0, "b:1", [v1], heat=[
        {"id": 1, "reads": 2, "last_access": 111.0, "read_rate": 1.0}])
    # volume 2 leaves a:1: its record goes with it
    _beat(topos, clock, 120.0, "a:1", [v1])
    views = [[t.heat_view(now) for now in (120.0, 1000.0)]
             + [t.merge_heat("a:1", [{"id": 1, "reads": 1}]),
                t.merge_heat("nobody", [])]
             for t in topos]
    assert views[0] == views[1]
    assert views[1][0][1]["reads"] == 6
    assert 2 not in views[1][0]


# --- the policy: the same plans from both packages ---------------------

FULL = 1000_000      # past 0.9 of the 1 MiB limit
# (beats, config kwargs, nows, warm_requested)
SCENARIOS = {
    "warm_needs_full_and_idle": (
        [(0.0, "a:1", [{"id": 1, "size": FULL}, {"id": 2, "size": 10_000}],
          [], []),
         (100.0, "a:1", [{"id": 1, "size": FULL}, {"id": 2, "size": 10_000}],
          [], [{"id": 1, "last_access": 100.0},
               {"id": 2, "last_access": 100.0}])],
        {"warm_after": 60.0}, [120.0, 159.0, 200.0], None),
    "sealed_counts_as_full": (
        [(0.0, "a:1", [{"id": 3, "size": 10, "read_only": True}], [], [])],
        {"warm_after": 60.0}, [30.0, 61.0], None),
    "fresh_master_waits_from_first_seen": (
        [(190.0, "a:1", [{"id": 1, "size": FULL}], [], [])],
        {"warm_after": 60.0}, [200.0, 251.0], None),
    "replicated_volume_lists_both_holders": (
        [(0.0, "a:1", [{"id": 4, "size": FULL,
                        "replica_placement": "001"}], [], []),
         (0.0, "b:1", [{"id": 4, "size": FULL,
                        "replica_placement": "001"}], [], [])],
        {"warm_after": 10.0}, [11.0], None),
    "unec_on_read_rate": (
        [(100.0, "a:1", [], [{"id": 4, "shard_ids": list(range(14))}],
          [{"id": 4, "read_rate": 2.5, "last_access": 100.0}]),
         (100.0, "b:1", [], [{"id": 5, "shard_ids": list(range(14))}],
          [{"id": 5, "read_rate": 1.0, "last_access": 100.0}])],
        {"hot_read_rate": 2.0}, [100.0, 500.0, 2000.0], None),
    "volume_and_collection_ttl": (
        [(100.0, "a:1", [
            {"id": 5, "collection": "tmp", "last_modified": 100},
            {"id": 6, "collection": "keep", "last_modified": 100},
            {"id": 7, "ttl": "1m", "last_modified": 100},
            {"id": 8, "collection": "tmp", "size": FULL}], [], [])],
        {"collection_ttls": {"tmp": 30.0}, "ttl_grace": 0.0,
         "warm_after": 1.0}, [120.0, 131.0, 200.0], None),
    "ttl_grace": (
        [(100.0, "a:1", [{"id": 5, "collection": "tmp",
                          "last_modified": 100}], [], [])],
        {"collection_ttls": {"tmp": 3.0}, "ttl_grace": 1.0},
        [103.5, 104.0, 104.5], None),
    "expiry_covers_the_warm_tier": (
        [(50.0, "a:1", [], [{"id": 11, "collection": "logs",
                             "shard_ids": list(range(14))}], []),
         (100.0, "a:1", [], [{"id": 11, "collection": "logs",
                              "shard_ids": list(range(14))}],
          [{"id": 11, "last_access": 100.0, "read_rate": 5.0}])],
        {"collection_ttls": {"logs": 30.0}, "ttl_grace": 0.0,
         "hot_read_rate": 1.0}, [120.0, 200.0], None),
    "resume_needs_idleness": (
        [(0.0, "a:1", [{"id": 9, "size": FULL}],
          [{"id": 9, "shard_ids": list(range(14))}],
          [{"id": 9, "last_access": 100.0}])],
        {"warm_after": 60.0}, [130.0, 200.0], None),
    "requested_overrides_idleness": (
        [(0.0, "a:1", [{"id": 3, "size": 10_000}], [],
          [{"id": 3, "last_access": 199.0}])],
        {"warm_after": 3600.0}, [200.0], {3: "s3 transition b/*"}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_plan_transitions_matches_reference(name, clock):
    beats, kwargs, nows, requested = SCENARIOS[name]
    topos = _topologies(clock)
    for t, url, vols, ecs, heat in beats:
        _beat(topos, clock, t, url, vols, ecs, heat)
    plans = []
    for topo, mod in zip(topos, (rlc, plc)):
        cfg = mod.LifecycleConfig(**kwargs)
        rows = []
        for now in nows:
            clock.now = now
            rows.append([
                (t.kind, t.vid, t.collection, t.reason, sorted(t.holders),
                 sorted(t.ec_holders))
                for t in mod.plan_transitions(topo, topo.heat_view(now),
                                              cfg, now, requested)])
        plans.append(rows)
    assert plans[0] == plans[1]
    assert any(plans[1]), "the scenario plans nothing at any time"


def test_vacuuming_volume_never_warms(clock):
    topos = _topologies(clock)
    _beat(topos, clock, 0.0, "a:1", [{"id": 1, "size": FULL}])
    for topo, mod in zip(topos, (rlc, plc)):
        cfg = mod.LifecycleConfig(warm_after=1.0)
        assert [t.kind for t in mod.plan_transitions(
            topo, topo.heat_view(10.0), cfg, 10.0)] == ["warm"]
        next(iter(topo.layouts.values())).vacuuming.add(1)
        assert mod.plan_transitions(topo, topo.heat_view(10.0), cfg,
                                    10.0) == []


@pytest.mark.parametrize("env", [
    {},
    {"WEED_LIFECYCLE_WARM_AFTER": "15m", "WEED_LIFECYCLE_INTERVAL": "30s",
     "WEED_LIFECYCLE_COLLECTION_TTL": "logs=3600,tmp=10m,bad,x=",
     "WEED_LIFECYCLE_TTL_GRACE": "2", "WEED_EC_FUSED": "0"},
    {"WEED_LIFECYCLE_HOT_READ_RATE": "2.5", "WEED_LIFECYCLE_ENABLED": "0",
     "WEED_LIFECYCLE_INTERVAL": "0", "WEED_LIFECYCLE_DAY_SECONDS": "1h",
     "WEED_LIFECYCLE_FULL_FRACTION": "0.5", "WEED_LIFECYCLE_FILER": "f:1"},
    {"WEED_LIFECYCLE_WARM_AFTER": "junk", "WEED_LIFECYCLE_ENABLED": "1"},
])
def test_config_from_env_matches_reference(env):
    r = rlc.LifecycleConfig.from_env(env)
    p = plc.LifecycleConfig.from_env(env)
    # every knob, the S3 pass's day_seconds and scan_limit included
    assert asdict(r) == asdict(p)
    assert r.enabled == p.enabled
    for s in ("", "90", "90s", "15m", "6h", "7d", "x", "3.5m"):
        assert rlc.parse_duration(s, 1.0) == plc.parse_duration(s, 1.0)


# --- the encode batcher ------------------------------------------------

class _FakeMaster:
    """Records the daemon's admin POSTs; fails those to `fail_on`."""

    def __init__(self, fail_on: str = ""):
        self.posts = []
        self.fail_on = fail_on
        from seaweedfs_torch.utils import metrics
        self.metrics = metrics.Registry("master")

    async def _admin_post(self, url, op, body, timeout=60.0):
        await asyncio.sleep(0.01)
        self.posts.append((url, op, body))
        if url == self.fail_on:
            raise RuntimeError(f"{url} refused")
        return {"ok": True}


class _FakeDaemon:
    def __init__(self, master):
        self.master = master
        self._tasks = self.tasks = set()


async def _drive_batcher(mod, window: int, jobs) -> tuple:
    master = _FakeMaster(fail_on="bad:1")
    batcher = mod._EncodeBatcher(_FakeDaemon(master), linger=0.05)
    batcher.max_window = window
    results = await asyncio.gather(
        *[batcher.encode(src, vid, fused=fused) for src, vid, fused in jobs],
        return_exceptions=True)
    return (sorted((u, op, sorted(b.get("volume_ids", [b.get("volume_id")])))
                   for u, op, b in master.posts),
            [type(r).__name__ if r is not None else None for r in results])


@pytest.mark.parametrize("window,jobs", [
    # one source: one window of every volume
    (8, [("a:1", 1, True), ("a:1", 2, True), ("a:1", 3, True)]),
    # the window cap flushes at once; the rest lingers into a second
    (2, [("a:1", 1, True), ("a:1", 2, True), ("a:1", 3, True)]),
    # sources and fused / plain window apart
    (8, [("a:1", 1, True), ("b:1", 2, True), ("a:1", 3, False)]),
    # a failed window fails each of its waiters, and no other
    (8, [("bad:1", 1, True), ("bad:1", 2, True), ("a:1", 3, True)]),
])
def test_encode_batcher_matches_reference(window, jobs, monkeypatch):
    monkeypatch.setenv("WEED_EC_ENCODE_WINDOW", str(window))
    ref = asyncio.run(_drive_batcher(rdaemon, window, jobs))
    port = asyncio.run(_drive_batcher(pdaemon, window, jobs))
    assert ref == port
    if window == 8 and jobs[0][0] == "a:1" and jobs[2][2]:
        assert port[0] == [("a:1", "ec/fused", [1, 2, 3])]


# --- the heartbeat carries only changed volumes -------------------------

def _heat_ids(payload: dict) -> list:
    return [e["id"] for e in payload.get("heat", [])]


@within(60)
def test_heartbeat_heat_payload_is_delta_sized():
    ref = Cluster(n_volume_servers=1, pulse=PULSE)
    port = LocalCluster(1, coder_name="numpy", geometry=PG,
                        volume_size_limit_mb=1, pulse=PULSE)
    try:
        seen = []
        for vs, client, call in (
                (ref.volume_servers[0], ref.client, ref.call),
                (port.nodes[0][0], PClient(port.master_url), port.call)):
            fid = client.upload(b"x" * 500)

            async def halt(vs=vs):
                vs._hb_task.cancel()

            call(halt())
            time.sleep(0.1)
            vs.heat.deltas()  # drain whatever the live loop left
            idle = vs._hb_payload()
            client.download(fid)
            one = vs._hb_payload()
            drained = vs._hb_payload()
            seen.append((_heat_ids(idle), _heat_ids(one),
                         one["heat"][0]["reads"], _heat_ids(drained)))
        assert seen[0] == seen[1]
        assert seen[1][0] == [] and seen[1][2] == 1 and seen[1][3] == []
    finally:
        ref.shutdown()
        port.shutdown()


# --- the daemon on the port's cluster ------------------------------------

def _cluster(n: int = 4, coder: str = "numpy", **cfg) -> LocalCluster:
    return LocalCluster(
        n, geometry=PG, volume_size_limit_mb=1, pulse=PULSE,
        master_kwargs={"lifecycle_config": plc.LifecycleConfig(**cfg)},
        **CODERS[coder])


def _fill_volume(cl, client, collection: str, seed: int = 21,
                 target: int = int(0.95 * 1024 * 1024)):
    """Upload random blobs until one volume of `collection` crosses
    `target` bytes; returns (vid, {fid: data})."""
    rng = random.Random(seed)
    blobs = {}
    for _ in range(64):
        data = rng.randbytes(64 * 1024)
        fid = client.upload(data, collection=collection)
        blobs[fid] = data
        vid = int(fid.split(",")[0])
        sizes = [v.data_file_size() for i in range(len(cl.nodes))
                 if cl.nodes[i][2] is not None
                 for v in [cl.store(i).find_volume(vid)] if v is not None]
        if sizes and max(sizes) >= target:
            return vid, {f: d for f, d in blobs.items()
                         if int(f.split(",")[0]) == vid}
    raise AssertionError("no volume filled")


def _shard_count(client, vid: int) -> int:
    try:
        return len(client.ec_lookup(vid).get("shards", {}))
    except PClientError:
        return 0


def _holds_volume(cl, vid: int) -> bool:
    return any(n[2] is not None and n[2].find_volume(vid) is not None
               for n in cl.nodes)


def _read_all(client, blobs: dict) -> None:
    client._vid_cache.clear()
    for fid, data in blobs.items():
        assert client.download(fid) == data, fid


def _outcomes(client) -> list:
    return [(e["kind"], e["volume"], e["outcome"])
            for e in client.lifecycle_status()["recent"]]


def _shard_path(cl, name: str) -> str:
    for n in cl.nodes:
        p = os.path.join(n[3], name)
        if os.path.exists(p):
            return p
    raise AssertionError(f"{name} on no server")


def _snapshot(cl, tmp_path, collection: str, vid: int) -> None:
    holder = next(i for i in range(len(cl.nodes))
                  if cl.store(i).find_volume(vid) is not None)
    base = cl.store(holder).find_volume(vid).base_file_name()
    for ext in (".dat", ".idx"):
        shutil.copyfile(base + ext, str(tmp_path / f"{collection}_{vid}")
                        + ext)


def _assert_reference_warmdown(cl, tmp_path, collection: str,
                               vid: int) -> None:
    """The cluster's 14 shard files equal the reference's
    fused_vacuum_gzip_encode of the snapshot in tmp_path."""
    rv = RVolume(str(tmp_path), collection, vid)
    try:
        rfused.fused_vacuum_gzip_encode(
            rv, str(tmp_path / "ref"), rec_mod.get_coder("numpy", 10, 4),
            TEST_GEOMETRY)
    finally:
        rv.close()
    for sid in range(TOTAL):
        ext = pgeo.to_ext(sid)
        with open(_shard_path(cl, f"{collection}_{vid}{ext}"), "rb") as a, \
                open(str(tmp_path / "ref") + ext, "rb") as b:
            assert a.read() == b.read(), f"shard {sid}"


def _assert_reference_vacuum_encode(cl, tmp_path, collection: str,
                                    vid: int) -> None:
    """The cluster's 14 shard files equal the reference's compaction and
    encode of the snapshot in tmp_path (the chained warm path)."""
    rv = RVolume(str(tmp_path), collection, vid)
    rv.compact()
    rv.close()
    rs = RStore([str(tmp_path)], coder_name="numpy", geometry=TEST_GEOMETRY)
    try:
        assert rs.ec_generate(vid) == list(range(TOTAL))
    finally:
        rs.close()
    for sid in range(TOTAL):
        ext = pgeo.to_ext(sid)
        with open(_shard_path(cl, f"{collection}_{vid}{ext}"), "rb") as a, \
                open(str(tmp_path / f"{collection}_{vid}") + ext,
                     "rb") as b:
            assert a.read() == b.read(), f"shard {sid}"


@pytest.mark.parametrize("coder,fused", [("numpy", True),
                                         ("torch_cpu", True),
                                         ("numpy", False)])
@within(120)
def test_idle_volume_warms_down_to_reference_bytes(coder, fused, tmp_path):
    """The fused warm-down (the default), and the chained vacuum then
    ec/generate under ``WEED_EC_FUSED=0`` (``ec_fused=False``)."""
    cl = _cluster(4, coder, warm_after=1.5, interval=0.3, ec_fused=fused)
    try:
        client = PClient(cl.master_url)
        vid, blobs = _fill_volume(cl, client, "warm")
        doomed = sorted(blobs)[:3]
        for fid in doomed:
            client.delete(fid)
            blobs.pop(fid)
        # the volume as the daemon will find it, before it can fire
        _snapshot(cl, tmp_path, "warm", vid)
        assert _holds_volume(cl, vid)

        # no command from here: seal, warm down, spread, retire
        _wait(lambda: _shard_count(client, vid) == TOTAL
              and not _holds_volume(cl, vid), "the daemon's warm-down")
        holders: dict = {}
        for sid, urls in client.ec_lookup(vid)["shards"].items():
            for u in urls:
                holders.setdefault(u, []).append(int(sid))
        assert sorted(map(len, holders.values())) == [3, 3, 4, 4]

        # byte-identical to the reference's one-pass warm-down of the
        # snapshot, or its compaction and encode
        if fused:
            _assert_reference_warmdown(cl, tmp_path, "warm", vid)
        else:
            _assert_reference_vacuum_encode(cl, tmp_path, "warm", vid)
        _read_all(client, blobs)
        for fid in doomed:
            with pytest.raises(PClientError, match="404"):
                client.download(fid)

        # the transition records its outcome after its last step
        _wait(lambda: _outcomes(client), "the warm-down's outcome")
        status = client.lifecycle_status()
        assert status["enabled"] and status["passes"] > 0
        assert _outcomes(client) == [("warm", vid, "ok")]
        assert [v["state"] for v in client.volume_heat(vid)["volumes"]] \
            == ["warm"]
        metrics = cl.master.metrics
        assert metrics.value("lifecycle_transitions",
                             {"kind": "warm", "outcome": "ok"}) == 1
        assert metrics.value("lifecycle_encode_windows",
                             {"volumes": "1"}) == 1
    finally:
        cl.shutdown()


@within(60)
def test_shell_warmdown_matches_reference(tmp_path):
    """``ec.warmdown``, the daemon's warm path by hand (``/admin/ec/
    fused``, then the same spread, mount and retire as ``ec.encode``)."""
    from seaweedfs_torch.shell import commands as pcommands
    cl = LocalCluster(3, coder_name="numpy", geometry=PG,
                      volume_size_limit_mb=1, pulse=PULSE,
                      master_kwargs={"repair_enabled": False})
    try:
        client = PClient(cl.master_url)
        vid, blobs = _fill_volume(cl, client, "manual", seed=5,
                                  target=300_000)
        for fid in sorted(blobs)[:2]:
            client.delete(fid)
            blobs.pop(fid)
        holder = client.lookup(vid)[0]
        client.volume_admin(holder, "volume/readonly",
                            {"volume_id": vid, "read_only": True})
        _snapshot(cl, tmp_path, "manual", vid)
        pcommands._register_all()
        env = pcommands.CommandEnv(client, PG)
        out = pcommands.run_command(env, ["ec.warmdown", "-volumeId",
                                          str(vid), "-collection",
                                          "manual"])
        assert sum(map(len, out["plan"].values())) == TOTAL
        assert _shard_count(client, vid) == TOTAL
        assert not _holds_volume(cl, vid)
        _assert_reference_warmdown(cl, tmp_path, "manual", vid)
        _read_all(client, blobs)
    finally:
        cl.shutdown()


@pytest.mark.parametrize("point", ["lifecycle.warm", "lifecycle.encode"])
@within(120)
def test_crash_mid_transition_keeps_data_and_converges(point):
    pfaults.clear()
    cl = _cluster(4, warm_after=0.8, interval=0.3)
    try:
        client = PClient(cl.master_url)
        pfaults.set_fault(point, "error")
        vid, blobs = _fill_volume(cl, client, "chaos", seed=31)

        def failed():
            return [e for e in client.lifecycle_status()["recent"]
                    if e["kind"] == "warm" and e["outcome"] == "failed"]

        _wait(lambda: len(failed()) >= 2, "two failed, backed-off tries")
        # the original survives every crash before its retirement
        assert _holds_volume(cl, vid)
        _read_all(client, blobs)
        if point == "lifecycle.encode":
            # the worst moment: the full shard set live beside it
            assert _shard_count(client, vid) == TOTAL
        n0 = len(failed())
        time.sleep(1.0)
        assert len(failed()) - n0 <= 2, "retries must back off"

        pfaults.clear()
        _wait(lambda: _shard_count(client, vid) == TOTAL
              and not _holds_volume(cl, vid), "convergence after the fault")
        _read_all(client, blobs)
        _wait(lambda: ("warm", vid, "ok") in _outcomes(client),
              "the converged transition's outcome")
        assert {o for _, _, o in _outcomes(client)} == {"failed", "ok"}
    finally:
        pfaults.clear()
        cl.shutdown()


@within(60)
def test_ttl_collection_expiry_frees_disk_and_topology():
    cl = _cluster(2, collection_ttls={"tmp": 3.0}, ttl_grace=0.0,
                  interval=0.3)
    try:
        client = PClient(cl.master_url)
        fid = client.upload(b"ephemeral" * 100, collection="tmp")
        keep = client.upload(b"kept" * 100, collection="keep")
        vid = int(fid.split(",")[0])
        assert client.lookup(vid)
        dats = [os.path.join(n[3], f"tmp_{vid}.dat") for n in cl.nodes]
        assert any(os.path.exists(p) for p in dats)

        def gone() -> bool:
            client._vid_cache.clear()
            try:
                client.lookup(vid)
            except PClientError:
                return True
            return False

        _wait(gone, "the expired volume leaves the topology")
        _wait(lambda: not any(os.path.exists(p) for p in dats),
              "the expired volume's files leave the disk")
        _wait(lambda: _outcomes(client), "the expiry's outcome")
        assert _outcomes(client) == [("expire", vid, "ok")]
        assert client.download(keep) == b"kept" * 100
    finally:
        cl.shutdown()


@within(90)
def test_hot_ec_volume_is_decoded_back(monkeypatch):
    monkeypatch.setenv("WEED_LIFECYCLE_HEAT_HALFLIFE", "0.5")
    cl = _cluster(4, hot_read_rate=1.0, interval=0.3)
    try:
        client = PClient(cl.master_url)
        data = random.Random(41).randbytes(50_000)
        fid = client.upload(data, collection="hotset")
        vid = int(fid.split(",")[0])
        # the repair daemon paused for the shell's spread: a spread half
        # done is not a deficit
        cl.master.repair_enabled = False
        pec.EcCommands(client, PG).encode(vid, "hotset")
        cl.master.repair_enabled = True
        assert _shard_count(client, vid) == TOTAL
        assert not _holds_volume(cl, vid)

        def hammer_until_decoded() -> bool:
            client._vid_cache.clear()
            for _ in range(20):
                try:
                    assert client.download(fid) == data
                except PClientError:
                    break  # mid-decode: the shard set just went
            return _holds_volume(cl, vid)

        _wait(hammer_until_decoded, "the hot EC volume decoded back", 45)
        _wait(lambda: _shard_count(client, vid) == 0,
              "the shards dropped everywhere")
        _read_all(client, {fid: data})
        _wait(lambda: ("unec", vid, "ok") in _outcomes(client),
              "the decode's outcome")
        assert [v["state"] for v in client.volume_heat(vid)["volumes"]] \
            == ["hot"]
    finally:
        cl.shutdown()


@within(60)
def test_lifecycle_shell_and_run():
    """``lifecycle.run`` runs one pass now, and the daemon stays off
    with no rule (a cluster with no rule behaves as before)."""
    from seaweedfs_torch.shell import commands as pcommands
    cl = LocalCluster(1, coder_name="numpy", geometry=PG,
                      volume_size_limit_mb=1, pulse=PULSE)
    try:
        client = PClient(cl.master_url)
        fid = client.upload(b"abc" * 10)
        pcommands._register_all()
        env = pcommands.CommandEnv(client, PG)
        st = pcommands.run_command(env, "lifecycle.status")
        assert st["enabled"] is False and st["passes"] == 0
        out = pcommands.run_command(env, "lifecycle.run")
        assert out == {"ok": True, "planned": 0, "launched": [], "s3": {}}
        assert pcommands.run_command(env, "lifecycle.status")["passes"] == 1
        vid = int(fid.split(",")[0])
        _wait(lambda: pcommands.run_command(
            env, ["volume.heat", "-volumeId", str(vid)])["volumes"][0][
                "writes"] == 1, "the write's heat reaches the master")
        assert pcommands.run_command(env, "volume.heat")["volumes"][0][
            "state"] == "hot"
    finally:
        cl.shutdown()
