"""Self-healing of the port: the master's repair daemon and the EC scrubber.

With the repair daemon running (``repair_enabled``, the default) on the
port's ``LocalCluster`` (numpy coder, the shrunk RS(10,4) geometry of
tests/cluster_util.py), a deleted shard, a dead holder, a flipped byte
and a lost replica all come back with no shell command, as the
reference's tests/test_self_heal.py drives them: the flipped byte is
reported by ``/admin/ec/scrub`` (with ``scrub_shards_checked`` equal to
the shards mounted there: a scrub that checks nothing would pass too),
its copy dropped and rebuilt to the original bytes. The deficit gate
(two sightings, the in-flight guard, the backoff) and the choice of a
re-replication target run in both packages on the same inputs; where
the reference's target breaks a ``001`` placement the port keeps it
(ROADMAP Queue 3, D5). Every case that runs servers has its deadline.
"""

import asyncio
import functools
import hashlib
import http.server as http_server
import json
import os
import random
import signal
import threading
import time

import pytest

from seaweedfs_torch.client import Client as PClient
from seaweedfs_torch.ec import geometry as pgeo
from seaweedfs_torch.balance import planner as pplanner
from seaweedfs_torch.observe import spans as pspans
from seaweedfs_torch.server import http
from seaweedfs_torch.server.local_cluster import LocalCluster
from seaweedfs_torch.server.master import MasterServer as PMaster
from seaweedfs_torch.server.volume_server import VolumeServer as PVolumeServer
from seaweedfs_torch.shell import commands as pcommands
from seaweedfs_torch.shell import ec_commands as pec
from seaweedfs_torch.storage import store as pstore
from seaweedfs_torch.storage.needle import Needle as PNeedle
from seaweedfs_torch.topology import topology as ptopo
from seaweedfs_tpu.balance import planner as rplanner
from seaweedfs_tpu.server.master import MasterServer as RMaster
from seaweedfs_tpu.server.volume_server import VolumeServer as RVolumeServer
from seaweedfs_tpu.topology import topology as rtopo

PG = pgeo.Geometry(10, 4, large_block_size=64 * 1024,
                   small_block_size=4 * 1024)
TOTAL = PG.total_shards
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


def _wait(cond, what: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.05)


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _cluster(n: int = 4, **kw) -> LocalCluster:
    return LocalCluster(n, coder_name="numpy", geometry=PG,
                        volume_size_limit_mb=1, pulse=PULSE, **kw)


def _ec_setup(cl, collection: str = "heal", seed: int = 11):
    """One volume of a few blobs, encoded by the shell and spread over
    the cluster; returns (vid, {fid: data}, client)."""
    client = PClient(cl.master_url)
    rng = random.Random(seed)
    blobs = {}
    for _ in range(4):
        data = rng.randbytes(rng.randint(10_000, 60_000))
        blobs[client.upload(data, collection=collection)] = data
    vids = {int(f.split(",")[0]) for f in blobs}
    assert len(vids) == 1
    vid = vids.pop()
    # the shell's ec.encode holds the master's admin lock: the repair
    # daemon takes no spread half done for a deficit
    pec.EcCommands(client, PG).encode(vid, collection)
    assert _shards(client, vid) == set(range(TOTAL))
    return vid, blobs, client




def _shards(client, vid: int) -> set:
    return {int(s) for s in client.ec_lookup(vid).get("shards", {})}


def _holders(client, vid: int) -> dict:
    out: dict = {}
    for sid, urls in client.ec_lookup(vid).get("shards", {}).items():
        for u in urls:
            out.setdefault(u, []).append(int(sid))
    return {u: sorted(s) for u, s in out.items()}


def _read_all(client, blobs: dict) -> None:
    client._vid_cache.clear()
    for fid, data in blobs.items():
        assert client.download(fid) == data, fid


def _ec_volume(cl, url: str, vid: int):
    return cl.store(cl.index_of(url)).find_ec_volume(vid)


def _scrub(client, url: str) -> dict:
    return client.volume_admin(url, "ec/scrub", {"throttle_seconds": 0})


def _checked(cl, url: str) -> float:
    return cl.nodes[cl.index_of(url)][0].metrics.value(
        "scrub_shards_checked")


@within(60)
def test_deleted_shard_is_rebuilt():
    cl = _cluster(4)
    try:
        vid, blobs, client = _ec_setup(cl)
        url, sids = sorted(_holders(client, vid).items())[0]
        client.volume_admin(url, "ec/delete_shards",
                            {"volume_id": vid, "collection": "heal",
                             "shard_ids": [sids[0]]})
        assert sids[0] not in _shards(client, vid)
        _wait(lambda: _shards(client, vid) == set(range(TOTAL)),
              "the daemon rebuilds the deleted shard")
        m = cl.master.metrics
        _wait(lambda: m.value("repairs_succeeded", {"kind": "ec"}) >= 1,
              "the repair's outcome")
        assert m.value("repairs_started", {"kind": "ec"}) >= 1
        assert m.value("repairs_failed", {"kind": "ec"}) == 0
        assert any(s["name"] == "master.repair.ec" for s in pspans())
        _read_all(client, blobs)
    finally:
        cl.shutdown()


@within(60)
def test_holder_death_is_rebuilt_on_the_survivors():
    cl = _cluster(4)
    try:
        vid, blobs, client = _ec_setup(cl, seed=12)
        holders = _holders(client, vid)
        lost = next(u for u, s in holders.items() if len(s) == 3)
        cl.stop_volume_server(cl.index_of(lost))

        def rebuilt() -> bool:
            h = _holders(client, vid)
            return (lost not in h
                    and {s for ss in h.values() for s in ss}
                    == set(range(TOTAL)))

        _wait(rebuilt, "the dead holder's shards rebuilt on survivors")
        _read_all(client, blobs)
    finally:
        cl.shutdown()


@within(90)
def test_flipped_byte_is_scrubbed_and_healed():
    cl = _cluster(4)
    try:
        vid, blobs, client = _ec_setup(cl, seed=13)
        holders = _holders(client, vid)
        url, sids = sorted(holders.items())[0]
        sid = sids[-1]
        path = _ec_volume(cl, url, vid).base_file_name() + pgeo.to_ext(sid)
        want = _sha(path)
        with open(path, "r+b") as f:
            f.seek(100)
            b = f.read(1)
            f.seek(100)
            f.write(bytes([b[0] ^ 0xFF]))

        before = _checked(cl, url)
        assert _scrub(client, url) == {"ok": True,
                                       "bad": {str(vid): [sid]}}
        # every shard mounted there was verified, not skipped
        assert _checked(cl, url) - before == len(sids)

        def healed() -> bool:
            h = _holders(client, vid)
            return ({s for ss in h.values() for s in ss}
                    == set(range(TOTAL))
                    and cl.master.metrics.value(
                        "repairs_succeeded", {"kind": "ec"}) >= 1)

        _wait(healed, "the rotten copy dropped and rebuilt")
        assert cl.master.metrics.value("scrub_reports") == 1
        assert cl.master.metrics.value("scrub_shards_dropped") == 1
        holder = next(u for u, s in _holders(client, vid).items()
                      if sid in s)
        assert _sha(_ec_volume(cl, holder, vid).base_file_name()
                    + pgeo.to_ext(sid)) == want
        # a scrub of every holder finds nothing, and checks every shard
        checked = 0
        for u, s in _holders(client, vid).items():
            before = _checked(cl, u)
            assert _scrub(client, u)["bad"] == {}
            assert _checked(cl, u) - before == len(s)
            checked += len(s)
        assert checked == TOTAL
        _read_all(client, blobs)
    finally:
        cl.shutdown()


@within(60)
def test_unstamped_shards_are_not_checked():
    """A volume whose .ecm stamps no digest has nothing to verify
    against: the scrub reports nothing and counts nothing checked (which
    is why the healing tests assert the count)."""
    cl = _cluster(4, master_kwargs={"repair_enabled": False})
    try:
        vid, _, client = _ec_setup(cl, seed=14)
        url = sorted(_holders(client, vid))[0]
        base = _ec_volume(cl, url, vid).base_file_name()
        with open(base + ".ecm") as f:
            meta = json.load(f)
        meta.pop("shard_digests")
        with open(base + ".ecm", "w") as f:
            json.dump(meta, f)
        before = _checked(cl, url)
        assert _scrub(client, url) == {"ok": True, "bad": {}}
        assert _checked(cl, url) == before
    finally:
        cl.shutdown()


@within(60)
def test_copied_shards_take_their_stamps():
    """``ec/copy`` of shards to a holder whose .ecm does not stamp them
    merges the source's stamps; a holder with no .ecm takes the
    source's whole."""
    cl = _cluster(4, master_kwargs={"repair_enabled": False})
    try:
        vid, _, client = _ec_setup(cl, seed=15)
        (a, a_sids), (b, b_sids) = sorted(_holders(client, vid).items())[:2]
        a_base = _ec_volume(cl, a, vid).base_file_name()
        with open(a_base + ".ecm") as f:
            whole = json.load(f)
        stripped = dict(whole, shard_digests={
            k: v for k, v in whole["shard_digests"].items()
            if int(k) in a_sids})
        with open(a_base + ".ecm", "w") as f:
            json.dump(stripped, f)
        client.volume_admin(a, "ec/copy",
                            {"volume_id": vid, "collection": "heal",
                             "shard_ids": b_sids, "source": b})
        with open(a_base + ".ecm") as f:
            merged = json.load(f)
        assert sorted(map(int, merged["shard_digests"])) == \
            sorted(a_sids + b_sids)
        assert all(merged["shard_digests"][k] == whole["shard_digests"][k]
                   for k in merged["shard_digests"])
        os.remove(a_base + ".ecm")
        client.volume_admin(a, "ec/copy",
                            {"volume_id": vid, "collection": "heal",
                             "shard_ids": b_sids[:1], "source": b})
        with open(a_base + ".ecm") as f:
            assert json.load(f) == whole
    finally:
        cl.shutdown()


@within(60)
def test_lost_replica_is_rereplicated():
    cl = _cluster(3, racks=1)
    try:
        client = PClient(cl.master_url)
        data = b"auto-fix" * 120
        fid = client.upload(data, collection="rep", replication="001")
        vid = int(fid.split(",")[0])
        holders = client.lookup(vid)
        assert len(holders) == 2
        client.volume_admin(holders[0], "volume/delete", {"volume_id": vid})

        def restored() -> bool:
            client._vid_cache.clear()
            return len(client.lookup(vid)) == 2

        _wait(restored, "the daemon re-replicates the lost copy")
        for url in client.lookup(vid):
            assert client.download(fid, url=url) == data
        _wait(lambda: cl.master.metrics.value(
            "repairs_succeeded", {"kind": "replica"}) == 1,
            "the re-replication's outcome")
    finally:
        cl.shutdown()


def test_repair_due_gates_like_the_reference():
    """Two consecutive sightings, the in-flight guard, the backoff."""
    rows = []
    for master in (RMaster(), PMaster()):
        seen: dict = {}
        key = ("ec", 7)
        row = [master._repair_due(key, seen, 7),     # first sighting
               master._repair_due(key, seen, 7)]     # second: launch
        master._repairs_inflight.add(key)
        row += [master._repair_due(key, seen, 7),
                master._repair_due(key, seen, 7)]    # in flight: never
        master._repairs_inflight.discard(key)
        master._repair_backoff[key] = (1, time.monotonic() + 60)
        row += [master._repair_due(key, seen, 7),
                master._repair_due(key, seen, 7)]    # backing off
        master._repair_backoff[key] = (1, time.monotonic() - 1)
        row += [master._repair_due(key, seen, 7), dict(seen)]
        rows.append(row)
    assert rows[0] == rows[1]
    assert rows[1] == [False, True, False, False, False, False, True, {}]


def test_repair_leaves_a_volume_mid_transition_alone():
    """A warm-down mid-spread shows a volume short of shards: the
    reference's repair daemon rebuilds it under its own lifecycle daemon
    (ROADMAP Queue 3, F3); the port's leaves it to the transition, and
    repairs the same deficit once the transition is gone."""
    async def drive(master) -> list:
        launched = []
        master._launch_repair = lambda key, fn, *a: launched.append(key)
        master.topology.register_heartbeat(
            "a:1", "a:1", "a:1", "dc1", "rack0", 8, {
                "ec_shards": [{"id": 3, "collection": "c",
                               "shard_ids": [0, 1, 2, 3]}],
                "volumes": [{"id": 5, "replica_placement": "001"}]})
        master.lifecycle._inflight[("warm", 3)] = time.monotonic()
        master.lifecycle._inflight[("expire", 5)] = time.monotonic()
        for _ in range(2):
            await master._repair_pass()
        during = list(launched)
        master.lifecycle._inflight.clear()
        for _ in range(2):
            await master._repair_pass()
        return [during, launched[len(during):]]

    ref = asyncio.run(drive(RMaster()))
    port = asyncio.run(drive(PMaster()))
    both = [("ec", 3), ("replica", 5)]
    assert ref == [both, both]
    assert port == [[], both]


def test_failed_repair_backs_off():
    """A repair that fails counts as failed and backs its key off for
    min(interval * 2^n, 300) s; one that succeeds clears it."""
    async def drive(master, outcomes):
        out = []
        for ok in outcomes:
            async def fn(ok=ok):
                if ok is None:
                    raise RuntimeError("volume server refused")
                return ok
            master._repairs_inflight.add(("ec", 3))
            await master._run_repair(("ec", 3), fn)
            back = master._repair_backoff.get(("ec", 3))
            out.append(None if back is None else back[0])
        return out

    for cls in (RMaster, PMaster):
        master = cls(maintenance_interval_seconds=0.5)
        assert asyncio.run(drive(master, [False, None, True])) == \
            [1, 2, None]
        assert master._repairs_inflight == set()
        assert master.metrics.value("repairs_failed", {"kind": "ec"}) == 2
        assert master.metrics.value("repairs_succeeded",
                                    {"kind": "ec"}) == 1


def _replica_topologies(nodes):
    topos = []
    for mod in (rtopo, ptopo):
        topo = mod.Topology(volume_size_limit=1 << 30)
        for url, rack, vols in nodes:
            topo.register_heartbeat(url, url, url, "dc1", rack, 8, {
                "volumes": [{"id": v, "replica_placement": rp}
                            for v, rp in vols]})
        topos.append(topo)
    return topos


# (nodes [(url, rack, [(vid, placement)])], placement, what each picks)
REPLICA_CASES = {
    # D5: 001 is "one more copy on the same rack": the reference picks
    # the emptier server on the other rack
    "001_two_racks": (
        [("a:1", "rack0", [(5, "001"), (6, "000")]),
         ("b:1", "rack0", [(7, "000"), (8, "000")]),
         ("c:1", "rack1", [])], "001", ("c:1", "b:1")),
    "001_one_rack": (
        [("a:1", "rack0", [(5, "001")]), ("b:1", "rack0", []),
         ("c:1", "rack0", [(6, "000")])], "001", ("b:1", "b:1")),
    "010_prefers_another_rack": (
        [("a:1", "rack0", [(5, "010")]), ("b:1", "rack0", []),
         ("c:1", "rack1", [(6, "000")])], "010", ("c:1", "c:1")),
    "010_one_rack_has_no_target": (
        [("a:1", "rack0", [(5, "010")]), ("b:1", "rack0", [])],
        "010", ("b:1", None)),
}


@pytest.mark.parametrize("case", sorted(REPLICA_CASES))
def test_replica_target_keeps_the_placement(case):
    nodes, rp, want = REPLICA_CASES[case]
    picks = []
    for topo, mod in zip(_replica_topologies(nodes),
                         (rplanner, pplanner)):
        holders = [topo.nodes["a:1"]]
        target = mod.pick_replica_target(topo, rp, holders)
        picks.append(target.url if target is not None else None)
    assert tuple(picks) == want


@within(60)
def test_scrub_report_answers():
    cl = _cluster(1)
    try:
        url = f"http://{cl.master_url}/ec/scrub_report"
        assert http.post_json(url, {"volume_id": 3}, 10) == \
            (400, {"error": "bad report"})
        assert http.post_json(url, {"volume_id": 3, "url": "x:1",
                                    "bad_shards": []}, 10) == \
            (200, {"ok": True})
        assert cl.master._scrub_bad == {}
        assert http.post_json(url, {"volume_id": 3, "url": "x:1",
                                    "bad_shards": [2, "4"]}, 10) == \
            (200, {"ok": True})
        assert cl.master._scrub_bad == {3: {"x:1": {2, 4}}}
    finally:
        cl.shutdown()


# --- reads while shards are dropped -------------------------------------

def _ec_store(d: str, n_needles: int = 24, seed: int = 5):
    """A Store holding one EC volume (id 1) of small needles, every shard
    mounted; returns (store, {needle id: data})."""
    st = pstore.Store([d], coder_name="numpy", geometry=PG)
    st.add_volume(1)
    rng = random.Random(seed)
    want = {}
    for nid in range(1, n_needles + 1):
        want[nid] = rng.randbytes(rng.randint(1000, 20_000))
        st.write_needle(1, PNeedle(cookie=nid, id=nid, data=want[nid]))
    st.find_volume(1).sync()
    assert st.ec_generate(1) == list(range(TOTAL))
    st.delete_volume(1)
    assert st.ec_mount(1, "", list(range(TOTAL))) == list(range(TOTAL))
    return st, want


def test_a_dropped_shard_closes_after_its_reads(tmp_path):
    """A shard dropped while a read is on it keeps its descriptor until
    that read lets go (a reused descriptor number would read another
    file), and no read starts on it after the drop."""
    st, _ = _ec_store(str(tmp_path))
    try:
        ev = st.find_ec_volume(1)
        shard = ev.shards[0]
        assert shard._pin.enter()            # a read in flight
        fd = shard._fd
        assert ev.delete_shard(0)
        os.fstat(fd)                         # still open under the read
        assert shard.read_at(0, 8) == b""    # a new read: gone
        shard._pin.exit()
        with pytest.raises(OSError):
            os.fstat(fd)
    finally:
        st.close()


class _LookupMaster(http_server.BaseHTTPRequestHandler):
    """A master's ``/col/lookup/ec``: answers ``server.answer``, a
    (status, JSON body) pair."""

    def do_GET(self):
        status, body = self.server.answer
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):
        pass


@within(30)
@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_d21_shard_map_kept_through_a_failed_lookup(pkg):
    """A master between leaders answers ``/col/lookup/ec`` with a JSON
    503. Both volume servers keep the last shard map they fetched, so an
    EC read that needs a remote shard still finds its holder; the port
    once cached an empty map for 11 s there, and degraded reads during a
    term change answered 404 (ROADMAP Queue 3, D21)."""
    cls = RVolumeServer if pkg == "reference" else PVolumeServer
    master = http_server.ThreadingHTTPServer(("127.0.0.1", 0), _LookupMaster)
    master.answer = (200, {"shards": {"3": ["10.0.0.1:8080", "me:1"]}})
    threading.Thread(target=master.serve_forever, daemon=True).start()
    try:
        vs = cls.__new__(cls)
        vs.master_url = f"127.0.0.1:{master.server_address[1]}"
        vs.url = "me:1"
        vs._shard_loc_cache = {}
        assert vs._shard_locations(7, 3) == ["10.0.0.1:8080"]
        assert vs._shard_locations(7, 5) == []
        master.answer = (503, {"error": "no leader elected"})
        assert vs._shard_locations(7, 3, force=True) == ["10.0.0.1:8080"]
        assert vs._shard_locations(7, 3) == ["10.0.0.1:8080"]
    finally:
        master.shutdown()
        master.server_close()


class _ElectingLookupMaster(_LookupMaster):
    """Answers 503 "no leader elected" to its first ``server.leaderless``
    lookups, then ``server.answer``."""

    def do_GET(self):
        if self.server.leaderless > 0:
            self.server.leaderless -= 1
            data = b'{"error": "no leader elected"}'
            self.send_response(503)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            return
        super().do_GET()


@within(30)
@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_d28_first_shard_lookup_waits_out_an_election(pkg):
    """A volume server with no shard map yet meets a master between
    leaders (three 503 answers). The reference takes the failed lookup
    for a map that names no holder, so a degraded read during a term
    change answers 404 (chip_smoke phase 13, run 20E); the port polls
    the master until it answers, for up to _SHARD_LOC_ELECTION_WAIT,
    and finds the holder (ROADMAP Queue 3, D28). With a map cached, a
    503 still keeps the last map (D21), without waiting."""
    cls = RVolumeServer if pkg == "reference" else PVolumeServer
    master = http_server.ThreadingHTTPServer(("127.0.0.1", 0),
                                             _ElectingLookupMaster)
    master.answer = (200, {"shards": {"3": ["10.0.0.1:8080"]}})
    master.leaderless = 3
    threading.Thread(target=master.serve_forever, daemon=True).start()
    try:
        vs = cls.__new__(cls)
        vs.master_url = f"127.0.0.1:{master.server_address[1]}"
        vs.url = "me:1"
        vs._shard_loc_cache = {}
        got = vs._shard_locations(7, 3)
        if pkg == "reference":
            assert got == [] and master.leaderless == 2
            return
        assert got == ["10.0.0.1:8080"] and master.leaderless == 0
        master.leaderless = 100
        t0 = time.monotonic()
        assert vs._shard_locations(7, 3, force=True) == ["10.0.0.1:8080"]
        assert time.monotonic() - t0 < 1.0
        assert master.leaderless == 99
    finally:
        master.shutdown()
        master.server_close()


class _CountingLookupMaster(_LookupMaster):
    def do_GET(self):
        self.server.lookups += 1
        super().do_GET()


@within(30)
@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_d24_read_misses_refresh_the_shard_map_at_most_once_a_second(pkg):
    """A degraded read tries each lost shard through the shard reader and
    misses. The reference asks the master again on every miss; the port,
    for a shard its map names no holder of, only when the map is at least
    a second old (ROADMAP Queue 3, D24), so five misses in a row cost it
    one lookup, not six. A named holder that fails forces a lookup in
    the port too."""
    import types
    cls = RVolumeServer if pkg == "reference" else PVolumeServer
    master = http_server.ThreadingHTTPServer(("127.0.0.1", 0),
                                             _CountingLookupMaster)
    master.answer = (200, {"shards": {"3": []}})
    master.lookups = 0
    threading.Thread(target=master.serve_forever, daemon=True).start()
    try:
        vs = cls.__new__(cls)
        vs.master_url = f"127.0.0.1:{master.server_address[1]}"
        vs.url = "me:1"
        vs._shard_loc_cache = {}
        # the port's reader tries a holder's gRPC port first
        vs._peer_grpc_channels, vs._peer_grpc_dead = {}, {}
        read = vs._make_shard_reader(types.SimpleNamespace(vid=7))
        for _ in range(5):
            assert read(5, 0, 10) is None
        assert master.lookups == (6 if pkg == "reference" else 1)
        if pkg == "port":
            shards, fetched = vs._shard_loc_cache[7]
            vs._shard_loc_cache[7] = (shards, fetched - 1.1)
            assert read(5, 0, 10) is None
            assert master.lookups == 2
            # a holder the map names whose fetch fails forces a fresh
            # lookup (and a second try) at once, as every miss does in
            # the reference
            master.answer = (200, {"shards": {"3": ["127.0.0.1:1"]}})
            vs._shard_loc_cache = {}
            assert read(3, 0, 10) is None
            assert master.lookups == 4
    finally:
        master.shutdown()
        master.server_close()


@within(60)
def test_reads_survive_shards_dropped_under_them(tmp_path):
    """Readers hammer an EC volume while every one of its shards is
    dropped (the decode's last step, a rebuild's cleanup): each read
    answers the needle's bytes, or that the volume or too many shards
    are gone, never a closed descriptor's error or another file's
    bytes."""
    st, want = _ec_store(str(tmp_path))
    stop = threading.Event()
    dropped = threading.Event()
    outcomes: list = []
    # per reader: (whether the read began after the last drop, outcome)
    mine: list = [[] for _ in range(4)]

    def reader(i: int) -> None:
        nids = sorted(want)
        n = i
        while not stop.is_set():
            nid = nids[n % len(nids)]
            n += 1
            after = dropped.is_set()
            try:
                got = st.read_needle(1, nid, cookie=nid).data
                out = "ok" if got == want[nid] else f"{nid} read back wrong"
            except KeyError:
                out = "gone"
            except IOError as e:
                out = ("short" if str(e).startswith(
                    ("cannot reconstruct", "ec volume 1: no local"))
                    else repr(e))
            except Exception as e:
                out = repr(e)
            outcomes.append(out)
            mine[i].append((after, out))

    threads = [threading.Thread(target=reader, args=(i,))
               for i in range(4)]
    for t in threads:
        t.start()
    try:
        _wait(lambda: outcomes.count("ok") >= 20, "reads before the drop")
        for sid in range(TOTAL):
            st.ec_delete_shards(1, "", [sid])
            time.sleep(0.01)
        assert st.find_ec_volume(1) is None
        dropped.set()
        n = len(outcomes)
        _wait(lambda: len(outcomes) > n + 20
              and all(any(a for a, _ in m) for m in mine),
              "reads after the drop")
    finally:
        stop.set()
        for t in threads:
            t.join(10)
        st.close()
    assert not any(t.is_alive() for t in threads)
    odd = sorted({o for o in outcomes if o not in ("ok", "gone", "short")})
    assert odd == []
    assert outcomes.count("ok") >= 20
    # the order across threads proves nothing (a read begun before the
    # drop may append its answer after another thread's "gone"): each
    # reader's last read, begun after the drop, answers "gone"
    for m in mine:
        later = [o for a, o in m if a]
        assert later and later[-1] == "gone", later[-5:]


@within(60)
def test_reads_never_miss_a_decoded_volume(tmp_path, monkeypatch):
    """Readers hammer an EC volume while the Store decodes it back into
    a normal volume (``ec/to_volume``, the un-EC's step): every read
    answers the needle's bytes, from the shards before the swap and from
    the decoded volume after it. The decoded volume is mounted before
    the EC volume goes, so no read finds neither, however long the
    mount takes (widened here to 0.3 s)."""
    st, want = _ec_store(str(tmp_path))
    mounting = threading.Event()

    class SlowMount(pstore.Volume):
        def __init__(self, *args, **kwargs):
            mounting.set()
            time.sleep(0.3)
            super().__init__(*args, **kwargs)
            mounting.clear()

    monkeypatch.setattr(pstore, "Volume", SlowMount)
    stop = threading.Event()
    outcomes: list = []
    during_mount = [0]

    def reader(i: int) -> None:
        nids = sorted(want)
        n = i
        while not stop.is_set():
            nid = nids[n % len(nids)]
            n += 1
            in_mount = mounting.is_set()
            try:
                got = st.read_needle(1, nid, cookie=nid).data
                outcomes.append("ok" if got == want[nid]
                                else f"{nid} read back wrong")
            except Exception as e:
                outcomes.append(repr(e))
            if in_mount and mounting.is_set():
                during_mount[0] += 1

    threads = [threading.Thread(target=reader, args=(i,))
               for i in range(4)]
    for t in threads:
        t.start()
    try:
        _wait(lambda: len(outcomes) >= 20, "reads before the decode")
        st.ec_to_volume(1)
        assert st.find_volume(1) is not None
        assert st.find_ec_volume(1) is None
        n = len(outcomes)
        _wait(lambda: len(outcomes) > n + 20, "reads after the decode")
    finally:
        stop.set()
        for t in threads:
            t.join(10)
        st.close()
    assert not any(t.is_alive() for t in threads)
    assert during_mount[0] > 0
    assert sorted(set(outcomes)) == ["ok"]


# --- the daemons outlive a bad pass and keep away from operators --------

@within(60)
def test_scrub_loop_outlives_a_failing_pass():
    """A pass that raises (a malformed stamp) is logged, and the
    periodic scrubber goes on."""
    cl = _cluster(1, volume_kwargs={"scrub_interval_seconds": 0.05})
    try:
        vs = cl.nodes[0][0]
        calls = []

        async def scrub_pass(throttle_seconds: float = 0.05) -> dict:
            calls.append(time.monotonic())
            if len(calls) == 1:
                raise ValueError("invalid literal for int(): 'x'")
            return {}

        vs.scrub_pass = scrub_pass
        _wait(lambda: len(calls) >= 3, "passes after a failing one")
        assert not vs._scrub_task.done()
    finally:
        cl.shutdown()


def test_admin_lease_like_the_reference():
    """Lease, conflict, renewal, release and expiry answer as the
    reference's master answers."""
    rows = []
    for master in (RMaster(), PMaster()):
        row = []
        a, st = master.lease_admin_token("admin", "a", 0)
        row.append(st)
        b, st = master.lease_admin_token("admin", "b", 0)
        row += [st, b]
        again, st = master.lease_admin_token("admin", "a", a["token"])
        row += [st, again["token"] == a["token"]]
        row.append(master.release_admin_token("admin", a["token"] + 1))
        row.append(master.release_admin_token("admin", a["token"]))
        master.admin_lease_seconds = 0.0
        _, st = master.lease_admin_token("", "b", 0)
        row.append(st)
        _, st = master.lease_admin_token("admin", "c", 0)   # b's expired
        row.append(st)
        rows.append(row)
    assert rows[0] == rows[1]
    assert rows[1] == [200, 409, {"error": "lock admin held by a",
                                  "holder": "a"}, 200, True, False, True,
                       200, 200]


def test_daemons_launch_nothing_under_the_admin_lock():
    """While an operator holds the admin lock the repair daemon launches
    nothing and forgets its sightings, and the lifecycle daemon runs no
    pass; once it is released both go on."""
    async def drive(master) -> list:
        launched, passes = [], []
        master._launch_repair = lambda key, fn, *a: launched.append(key)

        async def pass_once():
            passes.append(1)

        master.lifecycle.pass_once = pass_once
        master.lifecycle.cfg.interval = 0.01
        master.topology.register_heartbeat(
            "a:1", "a:1", "a:1", "dc1", "rack0", 8, {
                "ec_shards": [{"id": 3, "collection": "c",
                               "shard_ids": [0, 1, 2, 3]}]})
        token = master.lease_admin_token("admin", "shell-x", 0)[0]["token"]
        assert master.admin_lock_holder() == "shell-x"
        loop = asyncio.create_task(master.lifecycle.run_loop())
        for _ in range(3):
            await master._maintenance_pass()
        await asyncio.sleep(0.1)
        held = [list(launched), len(passes),
                dict(master._ec_deficit_seen)]
        master.release_admin_token("admin", token)
        assert master.admin_lock_holder() is None
        for _ in range(2):
            await master._maintenance_pass()
        await asyncio.sleep(0.1)
        loop.cancel()
        await asyncio.gather(loop, return_exceptions=True)
        return held + [launched, len(passes) > 0]

    assert asyncio.run(drive(PMaster())) == \
        [[], 0, {}, [("ec", 3)], True]


@within(60)
def test_shell_moves_hold_the_admin_lock():
    """Every admin call of the shell's ec.encode and of a destructive
    volume command is made under the client's admin lease; it is
    released after."""
    cl = _cluster(4)
    try:
        client = PClient(cl.master_url)
        fid = client.upload(b"x" * 20_000, collection="lk")
        vid = int(fid.split(",")[0])
        seen = []
        admin = client.volume_admin

        def volume_admin(server, op, body):
            seen.append((op, cl.master.admin_lock_holder()))
            return admin(server, op, body)

        client.volume_admin = volume_admin
        pec.EcCommands(client, PG).encode(vid, "lk")
        assert cl.master.admin_lock_holder() is None
        pcommands._register_all()
        env = pcommands.CommandEnv(client, PG)
        url = client.ec_lookup(vid)["shards"]["0"][0]
        pcommands.run_command(env, ["volume.mark", "-volumeId", str(vid),
                                    "-node", url, "-readonly"])
        assert cl.master.admin_lock_holder() is None
        ops = [op for op, _ in seen]
        assert "ec/generate" in ops and ops[-1] == "volume/readonly"
        assert {h for _, h in seen} == {client.admin_lock.owner}
    finally:
        cl.shutdown()
