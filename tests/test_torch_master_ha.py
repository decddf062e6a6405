"""The port's HA masters: raft election, the replicated metadata log, the
follower proxy, and the servers and clients that follow the leader.

A 3-master ``LocalCluster`` with the kernels' plain versions
(``coder_name="torch", device="cpu"``) at the shrunk RS(10,4) geometry,
raft at the reference fixture's timings (elections 0.15-0.3 s,
heartbeats 0.05 s), modelled on the reference's tests/test_master_ha.py,
tests/test_metaring.py (the leader killed mid-assign), tests/test_chaos.py
(the partition) and tests/test_multiprocess_e2e.py (the CLI):

- one leader, whom every master names; a follower proxies /dir/assign;
  max_volume_id, the volume registry, the geometry stamp and the key
  counter replicate;
- the leader stopped between bulk assigns: the first key after the
  failover is the old leader's committed next key, no key repeats, and
  the old leader restarted on its state directory rejoins as a follower
  with the same metadata log;
- volume servers re-home their heartbeats and the Client rotates past a
  dead master;
- a partition: the cut-off leader mints nothing, the majority elects and
  assigns, one leader remains after the heal;
- D13, in both packages: a leader cut off from the others, whose
  topology lists a volume over the garbage threshold, runs its periodic
  vacuum: the reference's compacts the volume, the port's does not; a
  follower's lifecycle, balance, maintenance and vacuum passes do
  nothing;
- shell ec.encode issued through a follower after the failover, reads
  with two shards lost, ec.rebuild: the shards equal by sha256 the
  reference Store's encode of the same sealed volume;
- ``master -peers -mdir`` as processes: a SIGKILL of the leader leaves a
  new one.
"""

import asyncio
import functools
import hashlib
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from cluster_util import TEST_GEOMETRY, Cluster
from seaweedfs_torch.client import Client as PClient
from seaweedfs_torch.client import ClientError as PClientError
from seaweedfs_torch.ec import geometry as pgeo
from seaweedfs_torch.server.local_cluster import LocalCluster
from seaweedfs_torch.shell import ec_commands as pec
from seaweedfs_torch.storage.file_id import FileId
from seaweedfs_tpu.storage.store import Store as RStore

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PG = pgeo.Geometry(10, 4, large_block_size=64 * 1024,
                   small_block_size=4 * 1024)
PULSE = 0.15
RAFT = {"election_timeout": (0.15, 0.3), "raft_heartbeat": 0.05}


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


def _wait(cond, what: str, timeout: float = 15.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.02)


def _get(url: str, timeout: float = 10.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.load(r)


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _ha_cluster(n_volume_servers: int = 4) -> LocalCluster:
    return LocalCluster(n_volume_servers, coder_name="torch", device="cpu",
                        geometry=PG, volume_size_limit_mb=1, pulse=PULSE,
                        racks=2, n_masters=3,
                        master_kwargs={**RAFT, "repair_enabled": False})


@pytest.fixture(scope="module")
def ha():
    cl = _ha_cluster()
    yield cl
    cl.shutdown()


def _followers(cl) -> list:
    return [m for m in cl.masters if m is not None and not m.raft.is_leader]


# --- election, proxy, replication -------------------------------------

@within(30)
def test_one_leader_elected(ha):
    leader = ha.wait_for_leader()
    assert sum(m.raft.is_leader for m in ha.masters) == 1
    _wait(lambda: all(m.raft.leader_id == leader.url for m in ha.masters),
          "every master names the leader")
    for m in ha.masters:
        st = _get(f"http://{m.url}/cluster/status")
        assert st["is_leader"] == (m is leader)
        assert st["leader"] == leader.url
        assert sorted(st["peers"]) == sorted(
            u for u in ha.master_url.split(",") if u != m.url)
        assert st["raft_term"] == leader.raft.term >= 1


@within(30)
def test_follower_proxies_assign_and_state_replicates(ha):
    leader = ha.wait_for_leader()
    follower = _followers(ha)[0]
    out = _get(f"http://{follower.url}/dir/assign?count=3")
    assert "fid" in out and out["count"] == 3
    assert out["ecGeometry"] == "10+4"
    vid = FileId.parse(out["fid"]).volume_id
    # growth logged max_volume_id and the registry row; the first
    # assign stamped the collection's geometry
    assert leader.metalog.volumes[vid]["replication"] == "000"
    assert leader.metalog.geometry[""] == "10+4"
    _wait(lambda: all(
        m.metalog.capture() == leader.metalog.capture()
        and m.topology.max_volume_id == leader.topology.max_volume_id
        for m in ha.masters), "the followers apply the log")
    status = _get(f"http://{follower.url}/dir/status")
    assert status["metalog"] == leader.metalog.status()


# --- the leader killed between bulk assigns ---------------------------

@within(60)
def test_leader_killed_mid_bulk_assign_replays_exact(ha):
    client = PClient(ha.master_url)
    keys: set = set()

    def assign_ok(count: int) -> int:
        out = client.assign(count=count)
        key = FileId.parse(out["fid"]).key
        for k in range(key, key + count):
            assert k not in keys, f"key {k} re-issued"
            keys.add(k)
        return key

    for i in range(10):
        assign_ok(1 + i % 4)
    leader = ha.wait_for_leader()
    committed = leader.metalog.next_key
    idx = ha.masters.index(leader)
    old_term = leader.raft.term
    ha.stop_master(idx)
    new = ha.wait_for_leader(exclude=(leader,))
    assert new.raft.term > old_term
    # the Client rotates past the dead master and rides out the new
    # leader's wait for heartbeats
    deadline = time.monotonic() + 15
    while True:
        try:
            key = assign_ok(5)
            break
        except PClientError:
            assert time.monotonic() < deadline, "no assign after failover"
            time.sleep(0.1)
    assert key == committed, (key, committed)
    assert new.metalog.next_key == committed + 5
    # volume servers re-home their heartbeats on the new leader
    _wait(lambda: all(n[0].master_url == new.url for n in ha.nodes),
          "volume servers follow the new leader")
    _wait(lambda: len(new.topology.nodes) == len(ha.nodes),
          "the new leader lists every volume server")
    # the old leader restarts on its state dir, rejoins as a follower,
    # and its metadata log catches up to the leader's
    back = ha.restart_master(idx)
    _wait(lambda: back.raft.leader_id == new.url and not back.raft.is_leader
          and back.metalog.capture() == new.metalog.capture(),
          "the restarted master catches up")
    assert ha.leader() is new


@within(30)
def test_client_rotates_past_a_dead_master(ha):
    leader = ha.wait_for_leader()
    dead = f"127.0.0.1:{_free_port()}"
    follower = _followers(ha)[0]
    client = PClient(f"{dead},{follower.url}")
    assert "fid" in client.assign()
    assert client.cluster_status()["leader"] == leader.url
    # the admin lease and its release go through the same rotation
    client2 = PClient(f"{dead},{follower.url}")
    with client2.admin_lock:
        assert leader.admin_lock_holder() == client2.admin_lock.owner
    assert leader.admin_lock_holder() is None


@within(30)
def test_lease_follows_a_new_leader():
    """D14: the admin lease lives in the leader's memory; a renewal that
    lands on a new leader presents its token, which the new leader
    adopts, so the holder keeps the lease."""
    from seaweedfs_torch.server.master import MasterServer
    old, new = MasterServer(), MasterServer()
    lease, st = old.lease_admin_token("admin", "shell-a", 0)
    assert st == 200
    renewed, st = new.lease_admin_token("admin", "shell-a", lease["token"])
    assert st == 200 and renewed["token"] == lease["token"]
    assert new.admin_lock_holder() == "shell-a"
    other, st = new.lease_admin_token("admin", "shell-b", 0)
    assert st == 409 and other["holder"] == "shell-a"


# --- a partition ------------------------------------------------------

def _cut(raft_node, peer_ids: set):
    """Drop every raft RPC from `raft_node` to `peer_ids`."""
    orig = raft_node._post

    async def filtered(peer, path, body, _orig=orig):
        if peer in peer_ids:
            return None
        return await _orig(peer, path, body)

    raft_node._post = filtered
    return orig


@within(60)
def test_partition_no_split_brain(ha):
    leader = ha.wait_for_leader()
    followers = _followers(ha)
    originals = [(leader.raft, _cut(leader.raft,
                                    {f.url for f in followers}))]
    for f in followers:
        originals.append((f.raft, _cut(f.raft, {leader.url})))
    vss = [n[0] for n in ha.nodes]
    saved = [(vs.masters, vs.master_url) for vs in vss]
    try:
        new = None

        def majority_leader():
            nonlocal new
            new = next((f for f in followers if f.raft.is_leader), None)
            return new is not None

        _wait(majority_leader, "a leader on the majority side")
        assert new.raft.term > leader.raft.term
        # the full split: the volume servers reach the majority only
        for vs in vss:
            vs.masters, vs.master_url = [new.url], new.url
        # the cut-off leader may still claim to lead, but mints nothing
        before = leader.metalog.next_key
        try:
            with urllib.request.urlopen(
                    f"http://{leader.url}/dir/assign", timeout=10) as r:
                body = json.load(r)
        except urllib.error.HTTPError as e:
            body = json.load(e)
        assert "fid" not in body, body
        assert leader.metalog.next_key == before

        def new_leader_assigns():
            try:
                return "fid" in _get(f"http://{new.url}/dir/assign")
            except (urllib.error.HTTPError, OSError):
                return False

        _wait(new_leader_assigns, "an assign through the new leader")
    finally:
        for raft_node, orig in originals:
            raft_node._post = orig
        for vs, (masters, url) in zip(vss, saved):
            vs.masters, vs.master_url = masters, url
    _wait(lambda: sum(m.raft.is_leader for m in ha.masters) == 1
          and leader.raft.term >= new.raft.term
          and all(m.metalog.capture() == new.metalog.capture()
                  for m in ha.masters),
          "one leader and one metadata log after the heal")
    assert ha.leader() is new


# --- D13: only the leader vacuums -------------------------------------

def _garbage_volume(client, n: int = 8) -> tuple:
    fids = [client.upload(b"g" * 700, collection="vac") for _ in range(n)]
    for fid in fids[:5]:
        client.delete(fid)
    return int(fids[0].split(",")[0]), fids


def _run_vacuum_loop(loop, master, seconds: float = 1.0) -> None:
    """The master's periodic vacuum, every 0.05 s for `seconds`."""
    master.vacuum_interval_seconds = 0.05
    master.garbage_threshold = 0.3

    async def drive():
        task = asyncio.ensure_future(master._vacuum_loop())
        await asyncio.sleep(seconds)
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)

    asyncio.run_coroutine_threadsafe(drive(), loop).result(seconds + 30)


def _deposed_vacuums(masters, loop, garbage, before_cut=None) -> list:
    """Cut the leader off; once the majority has a new leader, run the
    cut-off leader's vacuum loop, then a follower's; the garbage level
    after each. `before_cut(leader)` runs first."""
    leader = next(m for m in masters if m.raft.is_leader)
    if before_cut is not None:
        before_cut(leader)
    others = [m for m in masters if m is not leader]
    originals = [(leader.raft, _cut(leader.raft, {m.url for m in others}))]
    for m in others:
        originals.append((m.raft, _cut(m.raft, {leader.url})))
    try:
        _wait(lambda: any(m.raft.is_leader for m in others),
              "a new leader on the majority side")
        new = next(m for m in others if m.raft.is_leader)
        follower = next(m for m in others if m is not new)
        assert leader.topology.nodes, "the cut-off leader's topology"
        levels = [garbage()]
        _run_vacuum_loop(loop, follower)
        levels.append(garbage())
        _run_vacuum_loop(loop, leader)
        levels.append(garbage())
        return levels
    finally:
        for raft_node, orig in originals:
            raft_node._post = orig


@within(90)
def test_d13_only_the_leader_vacuums():
    port = _ha_cluster(1)
    try:
        client = PClient(port.master_url)
        vid, _ = _garbage_volume(client)
        vol = lambda: port.store(0).find_volume(vid)  # noqa: E731
        assert vol().garbage_level() > 0.5

        def gate_open(leader):
            # the leader's gate is open before the cut (its settle period
            # shortened to three pulses), so the lease alone closes it
            for m in port.masters:
                m.admin_lease_seconds = 0.0
            _wait(lambda: port.call(leader.leader_ready()),
                  "the leader's gate opens")

        got = _deposed_vacuums(port.masters, port.loop,
                               lambda: vol().garbage_level(), gate_open)
        # neither the follower nor the cut-off leader compacts
        assert all(g > 0.5 for g in got), got
    finally:
        port.shutdown()
    ref = Cluster(n_volume_servers=1, n_masters=3, pulse=PULSE)
    try:
        for m in ref.masters:
            m.repair_enabled = False
        vid, _ = _garbage_volume(ref.client)
        store = ref.volume_servers[0].store
        got = _deposed_vacuums(ref.masters, ref.loop,
                               lambda: store.find_volume(vid)
                               .garbage_level())
        # the reference: its follower's topology is empty, but the
        # cut-off leader, whose topology is stale, compacts the volume
        assert got[0] > 0.5 and got[1] > 0.5 and got[2] == 0, got
    finally:
        ref.shutdown()


@within(30)
def test_follower_passes_do_nothing(ha):
    ha.wait_for_leader()
    follower = _followers(ha)[0]
    launched = []
    follower._launch_repair = lambda key, fn, *a: launched.append(key)
    follower.lifecycle._launch = lambda tr: launched.append(tr.key)
    follower.balancer._launch = lambda mv: launched.append(mv.key)
    follower._ec_deficit_seen[1] = 1

    async def passes():
        await follower._maintenance_pass()
        return (await follower.lifecycle.pass_once(),
                await follower.balancer.pass_once())

    lc, bal = ha.call(passes())
    assert lc == {"skipped": "not leader"}
    assert bal == {"skipped": "not leader"}
    assert launched == [] and follower._ec_deficit_seen == {}
    assert not follower.lifecycle.status()["is_leader"]
    assert not follower.balancer.status()["is_leader"]
    assert ha.leader().balancer.status()["is_leader"]


# --- EC through a follower after the failover -------------------------

def _fill(client, collection: str, n: int = 30, seed: int = 5):
    rng = random.Random(seed)
    first = client.upload(rng.randbytes(1000), collection=collection)
    vid = int(first.split(",")[0])
    fids = {first: None}
    for _ in range(n):
        a = client.assign(collection=collection)
        if int(a["fid"].split(",")[0]) != vid:
            continue
        data = rng.randbytes(rng.randint(100, 20000))
        client.upload_blob(a["url"], a["fid"], data)
        fids[a["fid"]] = data
    fids.pop(first)
    return vid, fids


def _read_all(client, fids: dict) -> None:
    client._vid_cache.clear()
    for fid, data in fids.items():
        assert client.download(fid) == data, fid


@within(120)
def test_ec_encode_through_a_follower(ha, tmp_path):
    leader = ha.wait_for_leader()
    follower = _followers(ha)[0]
    # every request of this client reaches the leader through the proxy
    client = PClient(follower.url)
    vid, fids = _fill(client, "haec")
    shell = pec.EcCommands(client, PG)
    plan = shell.encode(vid, "haec", apply=False)
    client.volume_admin(plan["source"], "volume/readonly",
                        {"volume_id": vid, "read_only": True})
    vol = ha.store(ha.index_of(plan["source"])).find_volume(vid)
    vol.sync()
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    for ext in (".dat", ".idx", ".swm"):
        shutil.copyfile(vol.base_file_name() + ext,
                        ref_dir / f"haec_{vid}{ext}")
    seen = []
    held = leader.lease_admin_token

    def lease(name, owner, previous):
        seen.append(owner)
        return held(name, owner, previous)

    leader.lease_admin_token = lease
    try:
        shell.encode(vid, "haec")
    finally:
        leader.lease_admin_token = held
    # the lease was taken on the leader, through the follower
    assert client.admin_lock.owner in seen
    info = client.ec_lookup(vid)
    assert len(info["shards"]) == 14
    rs = RStore([str(ref_dir)], coder_name="numpy", geometry=TEST_GEOMETRY)
    assert rs.ec_generate(vid) == list(range(14))
    rs.close()
    ref_base = str(ref_dir / f"haec_{vid}")
    holders: dict = {}
    for sid, urls in info["shards"].items():
        for u in urls:
            holders.setdefault(u, []).append(int(sid))
    for url, sids in holders.items():
        base = os.path.join(ha.nodes[ha.index_of(url)][3], f"haec_{vid}")
        for sid in sids:
            assert _sha(base + pgeo.to_ext(sid)) == \
                _sha(ref_base + pgeo.to_ext(sid)), (url, sid)
    _read_all(client, fids)
    # two shards of one holder lost: degraded reads, then ec.rebuild
    url, sids = sorted(holders.items())[0]
    lost = sorted(sids)[:2]
    client.volume_admin(url, "ec/delete_shards",
                        {"volume_id": vid, "collection": "haec",
                         "shard_ids": lost})
    _wait(lambda: len(client.ec_lookup(vid)["shards"]) == 12,
          "the lookup drops the lost shards")
    _read_all(client, fids)
    rb = shell.rebuild(vid, "haec")
    assert sorted(rb["rebuilt"]) == lost
    base = os.path.join(ha.nodes[ha.index_of(rb["rebuilder"])][3],
                        f"haec_{vid}")
    for sid in lost:
        assert _sha(base + pgeo.to_ext(sid)) == \
            _sha(ref_base + pgeo.to_ext(sid))
    assert len(client.ec_lookup(vid)["shards"]) == 14
    _read_all(client, fids)


# --- the CLI ----------------------------------------------------------

_CLI = ("import sys; sys.path.insert(0, %r); "
        "from seaweedfs_torch.cli import main; main()" % str(REPO))


def _free_port() -> int:
    """A free port whose gRPC twin (+10000) is free too: a CLI server
    binds both."""
    from seaweedfs_torch.server.http import free_port_with_grpc_twin
    return free_port_with_grpc_twin()


@within(90)
def test_cli_masters_survive_a_sigkill(tmp_path):
    ports = [_free_port() for _ in range(3)]
    urls = [f"127.0.0.1:{p}" for p in ports]
    procs = [subprocess.Popen(
        [sys.executable, "-I", "-c", _CLI, "master", "-port", str(p),
         "-peers", ",".join(urls), "-mdir", str(tmp_path / f"m{i}"),
         "-maintenance_interval", "0"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        for i, p in enumerate(ports)]

    def leaders(among) -> list:
        out = []
        for u in among:
            try:
                if _get(f"http://{u}/cluster/status", timeout=2)[
                        "is_leader"]:
                    out.append(u)
            except OSError:
                pass
        return out

    try:
        _wait(lambda: len(leaders(urls)) == 1, "a leader", timeout=60)
        old = leaders(urls)[0]
        assert (tmp_path / f"m{urls.index(old)}" / "raft_state.json").exists()
        victim = procs[urls.index(old)]
        victim.send_signal(signal.SIGKILL)
        victim.wait(timeout=10)
        survivors = [u for u in urls if u != old]
        _wait(lambda: len(leaders(survivors)) == 1, "a new leader",
              timeout=30)
        new = leaders(survivors)[0]
        assert new != old
        # the follower proxies to the new leader
        other = next(u for u in survivors if u != new)
        assert _get(f"http://{other}/cluster/status")["leader"] == new
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
