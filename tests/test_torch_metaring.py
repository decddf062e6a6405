"""The port's filer ring (seaweedfs_torch/metaring/) against the
reference's, and the reference's ring cluster tests on the port's
servers.

Both packages' ``DirectoryRing`` place 10 000 seeded directories on the
same owners and replica lists, and each loads the other's wire form;
the masters' raft snapshots carry the ring across the packages; the
handoff's low watermark one package's runner leaves in a sqlite store is
where the other's resumes; clustersim's ``churn`` digests are the ones
the owner-only ring gave. Then tests/test_metaring.py's ring cases, on
a LocalCluster with three port filers in one ring (memory stores, 2
replicas): routing and replication, the status surfaces and the shell,
a recursive delete and a rename across partitions, the cross-peer cache
sweep, read-your-writes at a proxying edge, a peer killed mid-traffic
(no acknowledged entry lost), a handoff that resumes after its
watermark, strays moved whatever the diff says; ``Filer._notify`` on a
move across parents; the shell's join and leave and the CLI filer's
``-ring_peers``. Left out with the overload plane: the reference's
``test_ring_proxy_classifies_system``.
"""

import asyncio
import functools
import http.client
import json
import signal
import subprocess
import sys
import time
import urllib.parse
from pathlib import Path

import numpy as np
import pytest

from seaweedfs_torch import faults
from seaweedfs_torch.client import Client
from seaweedfs_torch.clustersim import scenarios as pscenarios
from seaweedfs_torch.ec.geometry import Geometry
from seaweedfs_torch.filer.entry import new_file
from seaweedfs_torch.filer.filer import Filer
from seaweedfs_torch.filer.stores import MemoryStore
from seaweedfs_torch.metaring import DirectoryRing, RingConfig
from seaweedfs_torch.metaring import handoff as phandoff
from seaweedfs_torch.server import http as phttp
from seaweedfs_torch.server.local_cluster import LocalCluster
from seaweedfs_torch.server.master import MasterServer as PMaster
from seaweedfs_torch.shell import commands as shell_commands
from seaweedfs_tpu.filer import abstract_sql as rsql
from seaweedfs_tpu.filer.filer import Filer as RFiler
from seaweedfs_tpu.filer.stores import MemoryStore as RMemoryStore
from seaweedfs_tpu.metaring import DirectoryRing as RRing
from seaweedfs_tpu.metaring import RingConfig as RRingConfig
from seaweedfs_tpu.metaring import handoff as rhandoff
from seaweedfs_tpu.server.master import MasterServer as RMaster

REPO = Path(__file__).resolve().parent.parent
TEST_GEOMETRY = Geometry(10, 4, large_block_size=64 * 1024,
                         small_block_size=4 * 1024)


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


def _wait(cond, what: str, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.02)


def _meta_create(peer: str, path: str, extended: dict | None = None,
                 timeout: float = 10.0) -> dict:
    entry = new_file(path)
    if extended:
        entry.extended = dict(extended)
    status, out = phttp.post_json(f"http://{peer}/__meta__/create_entry",
                                  {"entry": json.loads(entry.to_json())},
                                  timeout=timeout)
    assert status == 200, (peer, path, status, out)
    return out


def _meta_lookup(peer: str, path: str) -> tuple[int, dict]:
    return phttp.get_json(f"http://{peer}/__meta__/lookup?path="
                          f"{urllib.parse.quote(path)}")


def _found(peer: str, path: str) -> dict:
    status, out = _meta_lookup(peer, path)
    assert status == 200, (peer, path, status, out)
    return out


# --- (a) DirectoryRing against the reference -------------------------------

@within(60)
@pytest.mark.parametrize("n_peers,replicas", [(3, 2), (5, 3), (1, 2)])
def test_owners_and_replicas_equal_the_reference(n_peers, replicas):
    rng = np.random.default_rng(16 + n_peers)
    dirs = [f"/buckets/b{rng.integers(1 << 30)}/d{rng.integers(1 << 20)}"
            for _ in range(10000)]
    peers = [f"127.0.0.1:{8888 + i}" for i in range(n_peers)]
    mine = DirectoryRing(peers, vnodes=64, replicas=replicas)
    theirs = RRing(peers, vnodes=64, replicas=replicas)
    for d in dirs:
        assert mine.owners(d) == theirs.owners(d)
        assert mine.owner(d) == theirs.owner(d)
        assert mine.is_replica(d, peers[0]) == \
            theirs.is_replica(d, peers[0])
    for n in (1, 2, 4):
        assert [mine.owners(d, n) for d in dirs[:500]] == \
            [theirs.owners(d, n) for d in dirs[:500]]
    assert mine.partition_counts(dirs) == theirs.partition_counts(dirs)
    # a membership change moves both the same way
    for ring in (mine, theirs):
        ring.add_peer("127.0.0.1:9999")
        ring.remove_peer(peers[0])
    assert mine.version == theirs.version == 2
    assert [mine.owners(d) for d in dirs] == [theirs.owners(d) for d in dirs]


def test_wire_forms_load_in_either_package():
    mine = DirectoryRing(["a:1", "b:2", "c:3"], vnodes=16, replicas=3,
                         version=7)
    theirs = RRing(["x:1", "y:2"], vnodes=32, replicas=1, version=4)
    assert RRing.from_dict(mine.to_dict()).to_dict() == mine.to_dict()
    assert DirectoryRing.from_dict(theirs.to_dict()).to_dict() == \
        theirs.to_dict()
    crossed = DirectoryRing.from_dict(theirs.to_dict())
    assert [crossed.owners(f"/d{i}") for i in range(100)] == \
        [theirs.owners(f"/d{i}") for i in range(100)]
    # a JSON round trip, as /dir/ring and the watch stream carry it
    assert DirectoryRing.from_dict(json.loads(json.dumps(
        mine.to_dict()))).to_dict() == mine.to_dict()


def test_directory_ring_determinism_and_balance():
    peers = [f"127.0.0.1:{9000 + i}" for i in range(3)]
    a = DirectoryRing(peers, vnodes=64, replicas=2)
    b = DirectoryRing(list(reversed(peers)), vnodes=64, replicas=2)
    dirs = [f"/buckets/b{i}" for i in range(300)]
    for d in dirs:
        assert a.owners(d) == b.owners(d)
        assert len(a.owners(d)) == 2
        assert a.owners(d)[0] != a.owners(d)[1]
    counts = a.partition_counts(dirs)
    assert all(c > 30 for c in counts.values()), counts


def test_ring_remove_moves_only_lost_partitions():
    peers = [f"p{i}:1" for i in range(4)]
    for cls in (DirectoryRing, RRing):
        ring = cls(peers, vnodes=64, replicas=1)
        dirs = [f"/d{i}" for i in range(200)]
        before = {d: ring.owner(d) for d in dirs}
        ring.remove_peer("p2:1")
        for d in dirs:
            if before[d] != "p2:1":
                assert ring.owner(d) == before[d]
            else:
                assert ring.owner(d) != "p2:1"


def test_ring_config_from_env():
    env = {"WEED_FILER_RING_PEERS": " a:1, b:2,,", "WEED_FILER_RING_VNODES":
           "16", "WEED_FILER_RING_REPLICAS": "bad"}
    mine, theirs = RingConfig.from_env(env), RRingConfig.from_env(env)
    assert (mine.peers, mine.vnodes, mine.replicas, mine.enabled) == \
        (theirs.peers, theirs.vnodes, theirs.replicas, theirs.enabled) == \
        (["a:1", "b:2"], 16, 2, True)
    assert not RingConfig.from_env({}).enabled


# clustersim's churn over the owner-only ring the port had before
CHURN_DIGESTS = {
    1: ("454ce09d94d71990be540278235bb7ab08fc37431e25891bebcff28679df1386",
        62),
    2: ("a12f30ccd0b878ba5221ede382cc0b7bead60cd820d0cf2e134eed914e496d61",
        28),
}


@within(60)
@pytest.mark.parametrize("seed", sorted(CHURN_DIGESTS))
def test_churn_digests_unchanged(seed, monkeypatch):
    rep = pscenarios.run_scenario("churn", seed, nodes=40)
    assert (rep["digest"], rep["ring_moved_dirs"]) == CHURN_DIGESTS[seed]
    # and the reference's ring in the port's scenario reports the same
    monkeypatch.setattr(pscenarios, "DirectoryRing", RRing)
    assert pscenarios.run_scenario("churn", seed, nodes=40) == rep


# --- (b) the masters' snapshots carry the ring ------------------------------

@within(30)
def test_snapshot_ring_crosses_packages():
    peers = ["127.0.0.1:8881", "127.0.0.1:8882"]
    ref = RMaster(ring_config=RRingConfig(peers=peers, replicas=2))
    port = PMaster()
    for m in (ref, port):
        m._raft_apply({"ring_add": "127.0.0.1:8883"})
        m._raft_apply({"ring_remove": "127.0.0.1:8881"})
    cap = ref._raft_capture()
    assert cap["ring"]["version"] == 2
    port._raft_restore(cap)
    assert port.ring.to_dict() == ref.ring.to_dict()
    assert port.ring.peers == ["127.0.0.1:8882", "127.0.0.1:8883"]
    # the port's capture restores in the reference
    port._raft_apply({"ring_add": "127.0.0.1:8884"})
    fresh = RMaster()
    fresh._raft_restore(port._raft_capture())
    assert fresh.ring.to_dict() == port.ring.to_dict()
    assert fresh.ring.version == 3
    # an older ring never replaces a newer one
    port._raft_restore({"ring": {"version": 1, "peers": ["z:1"]}})
    assert port.ring.version == 3 and "z:1" not in port.ring.peers


def test_ring_line_on_a_full_watcher_resyncs():
    """A watch subscriber too far behind for a ring line is dropped with
    a resync line (its redial's snapshot carries the ring), as a
    location delta's is; the reference drops the ring line (D18)."""
    port = PMaster()
    full = asyncio.Queue(maxsize=1)
    full.put_nowait({"type": "update"})
    room = asyncio.Queue(maxsize=4)
    port._watchers = {full, room}
    port._raft_apply({"ring_add": "127.0.0.1:8881"})
    assert room.get_nowait() == {"type": "ring",
                                 "ring": port.ring.to_dict()}
    assert full.get_nowait() == {"type": "resync"}
    assert port._watchers == {room}
    assert port._location_snapshot()["ring"] == port.ring.to_dict()


# --- (c) the handoff watermark between the packages -------------------------

class _StubRouter:
    """A router that answers every push with 200 and fails the
    `fail_at`-th (from 1), as a peer that dies mid-pass."""

    def __init__(self, self_url: str, fail_at: int = 0):
        self.self_url = self_url
        self.pushes: list = []
        self.fail_at = fail_at

    def _push(self, peer, body):
        self.pushes.append((peer, body["entry"]["path"]))
        if len(self.pushes) == self.fail_at:
            raise ConnectionResetError("peer went away")

    async def request(self, peer, method, path, params=None, body=None,
                      replica=False, idempotent=False):
        self._push(peer, body)
        return 200, {}

    async def _request(self, peer, method, path, params=None, body=None,
                       replica=False, idempotent=False):
        self._push(peer, body)

        class R:
            status = 200
        return R()


class _StubServer:
    def __init__(self, store):
        self.filer = type("F", (), {"store": store})()


def _fill(store_cls, path: str, dirs: list):
    store = store_cls(path=path)
    for d in dirs:
        for j in range(2):
            store.insert_entry(new_file(f"{d}/f{j}.txt"))
    return store


@within(60)
@pytest.mark.parametrize("first", ["reference", "port"])
def test_handoff_watermark_crosses_packages(first, tmp_path):
    """One package's pass dies mid-way and leaves its watermark in a
    sqlite store; the other package's runner, on the same file, resumes
    after it and moves exactly the directories past it."""
    from seaweedfs_torch.filer.abstract_sql import SqliteStore as PSql
    me, other = "127.0.0.1:1", "127.0.0.1:2"
    dirs = [f"/ho/d{i:02d}" for i in range(24)]
    old = DirectoryRing([me], vnodes=64, replicas=1, version=1)
    new = DirectoryRing([me, other], vnodes=64, replicas=1, version=2)
    moving = sorted(d for d in dirs if old.owners(d) != new.owners(d))
    assert len(moving) >= 6
    db = str(tmp_path / "filer.db")
    mods = {"reference": (rsql.SqliteStore, rhandoff, RRing),
            "port": (PSql, phandoff, DirectoryRing)}
    second = "port" if first == "reference" else "reference"
    store_a, mod_a, ring_a = mods[first]
    store = _fill(store_a, db, dirs)
    runner = mod_a.HandoffRunner(_StubServer(store),
                                 _StubRouter(me, fail_at=2 * 3 + 1))
    with pytest.raises(ConnectionResetError):
        asyncio.run(runner.run_once(
            ring_a.from_dict(new.to_dict()),
            ring_a.from_dict(old.to_dict())))
    assert runner.state == "failed" and runner.moved_dirs == 3
    store.close()
    # the key and value the first package wrote
    store_b, mod_b, ring_b = mods[second]
    store = store_b(path=db)
    raw = store.kv_get("ring_handoff/v2")
    assert json.loads(raw.decode()) == {"dir": moving[2]}
    assert phandoff.read_watermark(store, 2) == moving[2]
    router = _StubRouter(me)
    runner = mod_b.HandoffRunner(_StubServer(store), router)
    moved = asyncio.run(runner.run_once(ring_b.from_dict(new.to_dict()),
                                        ring_b.from_dict(old.to_dict())))
    assert moved == len(moving) - 3
    assert {p.rsplit("/", 1)[0] for _, p in router.pushes} == \
        set(moving[3:])
    assert json.loads(store.kv_get("ring_handoff/v2").decode()) == \
        {"dir": moving[-1]}
    # the moved directories left this store (the first pass's three
    # too); the rest stayed
    for d in dirs:
        held = store.find_entry(f"{d}/f0.txt") is not None
        assert held == (d not in moving), d
    store.close()


@pytest.mark.parametrize("kind", ["memory", "sqlite", "leveldb",
                                  "leveldb2"])
def test_iter_directories(kind, tmp_path):
    from seaweedfs_torch.filer.stores import create_store
    kw = {} if kind == "memory" else {"path": str(tmp_path / "s")}
    store = create_store(kind, **kw)
    for p in ("/a/x", "/a/b/y", "/c/z", "/top"):
        store.insert_entry(new_file(p))
    store.insert_entry(new_file("/gone/q"))
    store.delete_entry("/gone/q")
    assert list(store.iter_directories()) == ["/", "/a", "/a/b", "/c"]
    if kind in ("memory", "sqlite"):
        from seaweedfs_tpu.filer.stores import create_store as rcreate
        ref = rcreate(kind, **({} if kind == "memory"
                               else {"path": str(tmp_path / "r")}))
        for p in ("/a/x", "/a/b/y", "/c/z", "/top"):
            ref.insert_entry(new_file(p))
        assert list(ref.iter_directories()) == \
            list(store.iter_directories())
        ref.close()
    store.close()


# --- (d) the reference's ring cluster tests on the port's servers ----------

@pytest.fixture(scope="module")
def ring_cluster():
    socks = LocalCluster.ring_sockets(3)
    peers = [f"127.0.0.1:{s.getsockname()[1]}" for s in socks]
    c = LocalCluster(1, coder_name="numpy", geometry=TEST_GEOMETRY,
                     volume_size_limit_mb=1, pulse=0.15,
                     master_kwargs={"ring_config": RingConfig(
                         peers=peers, replicas=2)})
    c.ring_peers = peers
    c.ring_filers = [c.add_filer(sock=s, ring_peers=peers, ring_replicas=2)
                     for s in socks]
    # a long entry-cache TTL: the invalidation tests measure the sweep
    for f in c.ring_filers:
        f.filer._entry_cache.ttl = 300.0
    # every member tails the other two
    _wait(lambda: all(len(f.ring_invalidator.status()["peers"]) == 2
                      for f in c.ring_filers), "the invalidation tails")
    yield c
    c.shutdown()


@within(60)
def test_ring_routes_and_replicates(ring_cluster):
    c = ring_cluster
    paths = [f"/ringdata/d{i % 5}/f{i}.txt" for i in range(20)]
    for i, p in enumerate(paths):
        _meta_create(c.ring_filers[i % 3].url, p)   # any peer takes it
    ring = c.ring_filers[0].ring
    for p in paths:
        for f in c.ring_filers:
            assert _found(f.url, p)["path"] == p
        owners = ring.owners(p.rsplit("/", 1)[0])
        for f in c.ring_filers:
            held = f.filer.store.find_entry(p) is not None
            assert held == (f.url in owners), (p, f.url, owners)
    # a directory's entry sits on its own parent's replica set
    owners = ring.owners("/ringdata")
    for f in c.ring_filers:
        held = f.filer.store.find_entry("/ringdata/d0") is not None
        assert held == (f.url in owners)
    # a hop is never routed again: a hop-marked lookup at a peer outside
    # the replica set answers from its own store
    outsider = next(f for f in c.ring_filers
                    if f.url not in ring.owners("/ringdata/d0"))
    _meta_create(ring.owner("/ringdata/d0"), "/ringdata/d0/hop.txt")
    r = phttp.request("GET", f"http://{outsider.url}/__meta__/lookup?path="
                      "/ringdata/d0/hop.txt", headers={
                          "X-Seaweed-Ring-Hop": "1"})
    assert r.status == 404


@within(60)
def test_ring_status_surfaces(ring_cluster):
    c = ring_cluster
    status, st = phttp.get_json(
        f"http://{c.ring_filers[0].url}/__meta__/ring/status")
    assert status == 200
    assert st["enabled"] and st["self"] == c.ring_filers[0].url
    assert sorted(st["ring"]["peers"]) == sorted(c.ring_peers)
    assert st["local_dirs"] >= 1 and st["owned_dirs"] <= st["local_dirs"]
    assert st["router"]["proxied"] + st["router"]["mirrored"] > 0
    shell_commands._register_all()
    env = shell_commands.CommandEnv(Client(c.master_url))
    out = shell_commands.COMMANDS["filer.ring.status"](env, [])
    assert out["ring"] == phttp.get_json(
        f"http://{c.master_url}/dir/ring")[1]
    assert sorted(out["ring"]["peers"]) == sorted(c.ring_peers)
    assert set(out["peers"]) == set(c.ring_peers)
    for row in out["peers"].values():
        assert "error" not in row
    one = shell_commands.run_command(
        env, ["filer.ring.status", "-peer", c.ring_peers[1]])
    assert list(one["peers"]) == [c.ring_peers[1]]
    # the master's status carries the ring too
    assert phttp.get_json(f"http://{c.master_url}/dir/status")[1][
        "ring"] == out["ring"]


@within(60)
def test_recursive_delete_spans_partitions(ring_cluster):
    c = ring_cluster
    paths = [f"/ringrm/sub{i % 4}/f{i}.txt" for i in range(12)]
    for p in paths:
        _meta_create(c.ring_filers[0].url, p)
    status, out = phttp.post_json(
        f"http://{c.ring_filers[1].url}/__meta__/delete",
        {"path": "/ringrm", "recursive": True})
    assert status == 200, out
    for p in paths + ["/ringrm"]:
        assert _meta_lookup(c.ring_filers[2].url, p)[0] == 404
    for f in c.ring_filers:
        for p in paths:
            assert f.filer.store.find_entry(p) is None
    # a non-recursive delete of a populated directory is refused
    _meta_create(c.ring_filers[0].url, "/ringrm2/sub/f.txt")
    status, out = phttp.post_json(
        f"http://{c.ring_filers[2].url}/__meta__/delete",
        {"path": "/ringrm2"})
    assert status == 409, out


@within(60)
def test_cross_partition_rename_converges(ring_cluster):
    c = ring_cluster
    for i in range(6):
        _meta_create(c.ring_filers[0].url, f"/ringmv/src/f{i}.txt")
    status, out = phttp.post_json(
        f"http://{c.ring_filers[2].url}/__meta__/rename",
        {"from": "/ringmv/src", "to": "/ringmv/dst"})
    assert status == 200, out
    for i in range(6):
        assert _found(c.ring_filers[1].url, f"/ringmv/dst/f{i}.txt")[
            "path"] == f"/ringmv/dst/f{i}.txt"
        assert _meta_lookup(c.ring_filers[1].url,
                            f"/ringmv/src/f{i}.txt")[0] == 404
    assert _meta_lookup(c.ring_filers[0].url, "/ringmv/src")[0] == 404
    # and through the file API's ?mv.to=
    r = phttp.request("POST", f"http://{c.ring_filers[1].url}/ringmv/dst"
                      "?mv.to=/ringmv/dst2")
    assert r.status == 200, r.data
    assert _found(c.ring_filers[0].url, "/ringmv/dst2/f3.txt")


@within(60)
def test_cross_peer_cache_invalidation_generation(ring_cluster):
    c = ring_cluster
    path = "/ringinv/hot.txt"
    _meta_create(c.ring_filers[0].url, path, extended={"v": "1"})
    owners = c.ring_filers[0].ring.owners("/ringinv")
    observer = next(f for f in c.ring_filers if f.url not in owners)
    owner = next(f for f in c.ring_filers if f.url == owners[0])
    # the observer proxies the lookup and caches the answer
    assert _found(observer.url, path)["extended"]["v"] == "1"
    cache = observer.filer._entry_cache
    assert path in cache
    gen_before = cache.generation
    entry = new_file(path)
    entry.extended = {"v": "2"}
    status, _ = phttp.post_json(f"http://{owner.url}/__meta__/update_entry",
                                {"entry": json.loads(entry.to_json())})
    assert status == 200
    # the owner's stream sweeps the observer's cache, long before the
    # 300 s TTL
    _wait(lambda: path not in cache and cache.generation > gen_before,
          "the cross-peer sweep")
    assert _found(observer.url, path)["extended"]["v"] == "2"


@within(60)
def test_proxied_write_drops_edge_negative_cache(ring_cluster):
    """Read-your-writes at the proxying edge: a peer that cached a
    negative lookup serves its own proxied create at once."""
    c = ring_cluster
    path = "/ringryw/fresh.txt"
    owners = c.ring_filers[0].ring.owners("/ringryw")
    edge = next(f for f in c.ring_filers if f.url not in owners)
    assert _meta_lookup(edge.url, path)[0] == 404     # cached negative
    _meta_create(edge.url, path)                      # proxied
    assert _found(edge.url, path)["path"] == path     # no wait


@within(60)
def test_file_api_through_the_ring(ring_cluster):
    """PUT, GET, a listing, mkdir and DELETE through every member: the
    bytes go to the volume servers from the edge, the entry to its
    owner."""
    c = ring_cluster
    data = bytes(range(256)) * 200
    for i, f in enumerate(c.ring_filers):
        r = phttp.request("PUT", f"http://{f.url}/ringfiles/d{i}/a.bin",
                          data, {"Content-Type": "application/octet-stream"})
        assert r.status == 201, r.data
    for f in c.ring_filers:
        for i in range(3):
            r = phttp.request("GET", f"http://{f.url}/ringfiles/d{i}/a.bin")
            assert r.status == 200 and r.data == data
        listing = phttp.get_json(f"http://{f.url}/ringfiles/")[1]
        assert [e["FullPath"] for e in listing["Entries"]] == \
            [f"/ringfiles/d{i}" for i in range(3)]
    r = phttp.request("POST", f"http://{c.ring_filers[0].url}/ringfiles/"
                      "made?op=mkdir")
    assert r.status == 201
    assert _found(c.ring_filers[2].url, "/ringfiles/made")
    r = phttp.request("DELETE", f"http://{c.ring_filers[1].url}/ringfiles"
                      "?recursive=true")
    assert r.status == 202

    def gone(url: str) -> bool:
        # a member that cached the entry serves it until the owner's
        # stream sweeps it (its chunks already freed: a cut body)
        try:
            return phttp.request(
                "GET", f"http://{url}/ringfiles/d0/a.bin").status == 404
        except http.client.HTTPException:
            return False

    _wait(lambda: all(gone(f.url) for f in c.ring_filers),
          "every member answers 404 for the deleted tree")


@within(90)
def test_peer_kill_mid_traffic_zero_acked_loss(ring_cluster):
    c = ring_cluster
    victim = c.ring_filers[2]
    survivors = c.ring_filers[:2]
    acked: list = []
    failed: list = []

    def write(i: int, edge: str) -> None:
        p = f"/ringchaos/d{i % 7}/f{i}.txt"
        entry = new_file(p)
        try:
            status, _ = phttp.post_json(
                f"http://{edge}/__meta__/create_entry",
                {"entry": json.loads(entry.to_json())}, timeout=5.0)
        except OSError:
            status = 0
        (acked if status == 200 else failed).append(p)

    for i in range(15):
        write(i, c.ring_filers[i % 3].url)
    c.stop_filer(victim)                          # mid-traffic
    for i in range(15, 30):
        write(i, survivors[i % 2].url)
    # an op whose owner is the dead peer answers 502 through a live edge
    # until the ring drops it (D18)
    dead = next(f"/ringchaos/x{i}" for i in range(100)
                if survivors[0].ring.owner(f"/ringchaos/x{i}") == victim.url)
    status, out = phttp.post_json(
        f"http://{survivors[0].url}/__meta__/create_entry",
        {"entry": json.loads(new_file(f"{dead}/f.txt").to_json())})
    assert status == 502, (status, out)
    failed.append(f"{dead}/f.txt")
    status, out = phttp.post_json(f"http://{c.master_url}/dir/ring/leave",
                                  {"peer": victim.url})
    assert status == 200 and out["ok"]
    assert victim.url not in out["ring"]["peers"]
    _wait(lambda: all(victim.url not in f.ring.peers for f in survivors),
          "the survivors adopt the ring")
    still = []
    for p in failed:
        try:
            _meta_create(survivors[0].url, p, timeout=5.0)
            acked.append(p)
        except AssertionError:
            still.append(p)
    assert not still
    # no acknowledged entry lost: each serves from both survivors
    for p in acked:
        for f in survivors:
            assert _found(f.url, p)["path"] == p
    # a leave of a stranger changes nothing
    status, out = phttp.post_json(f"http://{c.master_url}/dir/ring/leave",
                                  {"peer": victim.url})
    assert status == 200 and out["unchanged"]


@pytest.fixture()
def pair_cluster():
    socks = LocalCluster.ring_sockets(2)
    peers = [f"127.0.0.1:{s.getsockname()[1]}" for s in socks]
    c = LocalCluster(1, coder_name="numpy", geometry=TEST_GEOMETRY,
                     volume_size_limit_mb=1, pulse=0.15,
                     master_kwargs={"ring_config": RingConfig(
                         peers=peers[:1], replicas=1)})
    # replicas=1: a join MOVES partitions (the old owner drops them), so
    # the resume path runs
    c.ring_filers = [c.add_filer(sock=socks[0], ring_peers=peers[:1],
                                 ring_replicas=1)]
    # the second member serves later on the socket held for it
    c.ring_sock = socks[1]
    yield c, peers
    faults.clear()
    c.shutdown()
    socks[1].close()    # if no member served on it


@within(90)
def test_ring_change_handoff_resumes_after_restart(pair_cluster):
    c, peers = pair_cluster
    a = c.ring_filers[0]
    for i in range(24):
        for j in range(3):
            _meta_create(a.url, f"/ho/d{i:02d}/f{j}.txt")
    b = c.add_filer(sock=c.ring_sock, ring_peers=peers,
                    ring_replicas=1)
    new_ring = DirectoryRing(peers=peers, vnodes=64, replicas=1, version=2)
    old_ring = DirectoryRing(peers=peers[:1], vnodes=64, replicas=1,
                             version=1)
    moving = [d for d in sorted(a.filer.store.iter_directories())
              if old_ring.owners(d) != new_ring.owners(d)]
    assert len(moving) >= 6, "the split left too little to move"

    # 1) the runner dies at its first move: state failed, nothing skipped
    faults.set_fault("ring.handoff", "error", count=1)
    with pytest.raises(Exception):
        c.call(a.ring_handoff.run_once(new_ring, old_ring))
    assert a.ring_handoff.state == "failed"
    faults.clear()

    # 2) the runner killed mid-pass: the watermark stays in the KV face
    runner1 = phandoff.HandoffRunner(a, a.ring_router)
    fut = asyncio.run_coroutine_threadsafe(
        runner1.run_once(new_ring, old_ring), c.loop)
    _wait(lambda: runner1.moved_dirs >= 2, "two moves", timeout=20)
    fut.cancel()
    # the thread-side future is done at once; the pass itself ends once
    # the directory it was settling is watermarked
    _wait(lambda: runner1.state != "running", "the cancelled pass")
    moved_first = runner1.moved_dirs
    assert 0 < moved_first < len(moving), (moved_first, len(moving))
    watermark = json.loads(
        a.filer.store.kv_get("ring_handoff/v2").decode())["dir"]

    # 3) a fresh runner resumes after the watermark
    runner2 = phandoff.HandoffRunner(a, a.ring_router)
    moved_second = c.call(runner2.run_once(new_ring, old_ring))
    assert runner2.state == "done"
    assert moved_second == len([d for d in moving if d > watermark])
    assert moved_second < len(moving), "started again from scratch"
    for d in moving:
        if not d.startswith("/ho/d"):
            continue
        for j in range(3):
            assert b.filer.store.find_entry(f"{d}/f{j}.txt") is not None
            assert a.filer.store.find_entry(f"{d}/f{j}.txt") is None
        assert _found(b.url, f"{d}/f0.txt")["path"] == f"{d}/f0.txt"


@within(60)
def test_handoff_moves_strays_despite_unchanged_diff(pair_cluster):
    """Data a cancelled pass left on a peer outside a partition's
    replica set moves even when the old and new views agree."""
    c, peers = pair_cluster
    a = c.ring_filers[0]
    for j in range(3):
        _meta_create(a.url, f"/stray/f{j}.txt")
    b = c.add_filer(sock=c.ring_sock, ring_peers=peers,
                    ring_replicas=1)
    old_v = DirectoryRing(peers=peers[1:], vnodes=64, replicas=1, version=2)
    new_v = DirectoryRing(peers=peers[1:], vnodes=64, replicas=1, version=3)
    moved = c.call(phandoff.HandoffRunner(a, a.ring_router).run_once(
        new_v, old_v))
    assert moved >= 1, "the stray partitions were skipped"
    for j in range(3):
        assert b.filer.store.find_entry(f"/stray/f{j}.txt") is not None
        assert a.filer.store.find_entry(f"/stray/f{j}.txt") is None


@within(90)
def test_join_through_the_shell_hands_partitions_over(pair_cluster):
    """``filer.ring.join``: the master's ring grows through raft, both
    members adopt the pushed ring and the old member's handoff moves
    the joiner's partitions to it; ``filer.ring.leave`` moves them
    back."""
    c, peers = pair_cluster
    a = c.ring_filers[0]
    for i in range(12):
        _meta_create(a.url, f"/join/d{i:02d}/f.txt")
    b = c.add_filer(sock=c.ring_sock, ring_peers=peers,
                    ring_replicas=1)
    shell_commands._register_all()
    env = shell_commands.CommandEnv(Client(c.master_url))
    out = shell_commands.run_command(env, ["filer.ring.join", "-peer",
                                           b.url])
    assert out["ok"] and out["ring"]["peers"] == sorted(peers)
    _wait(lambda: a.ring.version == b.ring.version == out["ring"]["version"]
          and a.ring_handoff.state == "done", "the join's handoff")
    ring = a.ring
    for i in range(12):
        d = f"/join/d{i:02d}"
        owner = ring.owner(d)
        assert (b.filer.store.find_entry(f"{d}/f.txt") is not None) == \
            (owner == b.url)
        assert (a.filer.store.find_entry(f"{d}/f.txt") is not None) == \
            (owner == a.url)
        assert _found(a.url, f"{d}/f.txt") and _found(b.url, f"{d}/f.txt")
    out = shell_commands.run_command(env, ["filer.ring.leave", "-peer",
                                           b.url])
    assert out["ring"]["peers"] == peers[:1]
    _wait(lambda: b.ring.version == out["ring"]["version"]
          and b.ring_handoff.state == "done", "the leave's handoff")
    for i in range(12):
        assert a.filer.store.find_entry(f"/join/d{i:02d}/f.txt") is not None


# --- (e) Filer._notify on a move across parents -----------------------------

@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_notify_rename_covers_both_parents(pkg):
    """A move across directories sweeps the cache for both paths (and a
    moved directory's cached subtree) and tells subscribers of the OLD
    parent that the old path died."""
    if pkg == "port":
        f = Filer(MemoryStore(), entry_cache_ttl=300.0)
    else:
        f = RFiler(RMemoryStore(), entry_cache_ttl=300.0)
    f.create_entry(new_file("/a/sub/x.txt"))
    f.create_entry(new_file("/b/keep.txt"))
    assert f.find_entry("/a/sub/x.txt") is not None
    assert f.find_entry("/b/keep.txt") is not None
    cache = f._entry_cache
    gen = cache.generation
    f.rename("/a/sub", "/b/sub")
    assert cache.generation > gen
    assert "/a/sub/x.txt" not in cache
    assert "/a/sub" not in cache
    assert f.find_entry("/b/sub/x.txt") is not None
    assert f.find_entry("/a/sub/x.txt") is None
    old_side = f.meta_log.events_since(0, prefix="/a")
    assert any(e.old_entry is not None and e.new_entry is None
               and e.old_entry.full_path == "/a/sub" for e in old_side)
    new_side = f.meta_log.events_since(0, prefix="/b")
    assert any(e.new_entry is not None and e.new_entry.full_path == "/b/sub"
               for e in new_side)
    assert all(not e.delete_chunks for e in old_side)


# --- (f) the CLI filer's -ring_peers ----------------------------------------

_CLI = ("import sys; sys.path.insert(0, %r); "
        "from seaweedfs_torch.cli import main; main()" % str(REPO))


@within(120)
def test_cli_filers_form_a_ring(tmp_path):
    """Two ``filer -ring_peers`` processes against an in-process master:
    joined through the shell CLI, an entry created through one is held
    by its owner and served by both."""
    c = LocalCluster(1, coder_name="numpy", geometry=TEST_GEOMETRY,
                     volume_size_limit_mb=1, pulse=0.15)
    socks = LocalCluster.ring_sockets(2)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()       # each CLI filer binds its own
    peers = ",".join(f"127.0.0.1:{p}" for p in ports)
    cli = [sys.executable, "-I", "-c", _CLI]
    procs = [subprocess.Popen(
        cli + ["filer", "-port", str(p), "-mserver", c.master_url,
               "-store", "sqlite", "-store_path", str(tmp_path / f"f{p}.db"),
               "-ring_peers", peers],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        for p in ports]
    try:
        def up() -> bool:
            assert all(p.poll() is None for p in procs)
            try:
                return all(phttp.get_json(
                    f"http://127.0.0.1:{p}/healthz")[0] == 200
                    for p in ports)
            except OSError:
                return False

        _wait(up, "the CLI filers", timeout=60)
        for p in ports:
            out = subprocess.run(
                cli + ["shell", "-master", c.master_url, "filer.ring.join",
                       "-peer", f"127.0.0.1:{p}"],
                capture_output=True, text=True, timeout=60)
            assert out.returncode == 0, out.stderr
        ring = json.loads(out.stdout.strip().splitlines()[-1])["ring"]
        assert ring["peers"] == sorted(peers.split(","))
        urls = [f"127.0.0.1:{p}" for p in ports]

        def adopted() -> bool:
            return all(phttp.get_json(f"http://{u}/__meta__/ring/status")[1][
                "ring"]["version"] == ring["version"] for u in urls)

        _wait(adopted, "the members adopt the joined ring")
        for i in range(6):
            _meta_create(urls[0], f"/cli/d{i}/f.txt")
        for i in range(6):
            for u in urls:
                assert _found(u, f"/cli/d{i}/f.txt")
                # two members, two replicas: each holds every entry
                r = phttp.request("GET", f"http://{u}/__meta__/lookup?path="
                                  f"/cli/d{i}/f.txt",
                                  headers={"X-Seaweed-Ring-Hop": "1"})
                assert r.status == 200, (u, i)
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
        c.shutdown()
