"""The rest of the port's storage engine against the reference's: the
TTL expiry of whole volumes, the free-space watchdog (and D9, the seals
it must not lift), the compaction's byte-rate throttle, and the volume
server's storage maintenance.

Expiry is asked of both packages' volumes at the same instants; the
watchdog runs the same sequence of thresholds on both packages' Stores;
the throttle runs both packages' compactions on a virtual clock, so the
sleeps each asks for are compared exactly, and then on the real clock,
where a reader must not wait on the copy.
"""

import os
import random
import threading
import time
import types

import pytest

from seaweedfs_torch.client import Client as PClient
from seaweedfs_torch.ec import geometry as pgeo
from seaweedfs_torch.server.local_cluster import LocalCluster
from seaweedfs_torch.storage import store as pstore
from seaweedfs_torch.storage import volume as pvolume
from seaweedfs_torch.storage.needle import Needle as PNeedle
from seaweedfs_tpu.ec import geometry as rgeo
from seaweedfs_tpu.storage import store as rstore
from seaweedfs_tpu.storage import volume as rvolume
from seaweedfs_tpu.storage.needle import Needle as RNeedle

PACKAGES = {"ref": (rstore, rvolume, RNeedle, rgeo),
            "port": (pstore, pvolume, PNeedle, pgeo)}
SMALL = {"large_block_size": 64 * 1024, "small_block_size": 4 * 1024}
T0 = 1_790_000_000.0


@pytest.mark.parametrize("ttl", ["", "3m", "45m", "2h", "1d"])
def test_volume_expiry_matches_reference(tmp_path, ttl):
    """is_expired and is_expired_long_enough at instants around the TTL
    and its grace, for a volume written at T0 and for one of unknown age
    (never expires)."""
    minutes = {"": 0, "3m": 3, "45m": 45, "2h": 120, "1d": 1440}[ttl]
    instants = [T0 + s for s in (-5, 0, 59, 60 * minutes - 1, 60 * minutes,
                                 60 * minutes + 30, 60 * (minutes + 1),
                                 60 * (minutes + 5), 60 * (minutes + 10),
                                 60 * minutes * 2, 10**7)]
    seen = {}
    for name, (smod, vmod, needle, _) in PACKAGES.items():
        st = smod.Store([str(tmp_path / name)], coder_name="numpy")
        v = st.add_volume(1, ttl=ttl)
        fresh = st.add_volume(2, ttl=ttl)
        v.write_needle(needle(cookie=1, id=1, data=b"ttl"))
        v.last_modified_ts = int(T0)
        fresh.last_modified_ts = 0
        fresh.last_append_at_ns = 0
        got = []
        for now in instants:
            for delay in (1, 3, 10):
                got.append((v.is_expired(now),
                            v.is_expired_long_enough(delay, now),
                            fresh.is_expired(now),
                            fresh.is_expired_long_enough(delay, now)))
        st.close()
        seen[name] = got
    assert seen["port"] == seen["ref"]
    if ttl:
        assert any(g[0] for g in seen["port"])


def test_delete_expired_volumes_matches_reference(tmp_path):
    """Only TTL volumes past their grace go, with their files."""
    seen = {}
    for name, (smod, _, needle, _) in PACKAGES.items():
        d = tmp_path / name
        st = smod.Store([str(d)], coder_name="numpy")
        ages = {1: ("3m", 3600), 2: ("3m", 60), 3: ("", 10**6),
                4: ("1h", 3 * 3600), 5: ("1h", 3700)}
        for vid, (ttl, age) in ages.items():
            v = st.add_volume(vid, ttl=ttl)
            v.write_needle(needle(cookie=vid, id=vid, data=b"x"))
            v.last_modified_ts = int(time.time() - age)
        out = st.delete_expired_volumes(max_delay_minutes=10)
        seen[name] = (sorted(out), sorted(
            vid for loc in st.locations for vid in loc.volumes),
            sorted(os.listdir(d)))
        st.close()
    assert seen["port"] == seen["ref"]
    assert seen["port"][0] == [1, 4]


def _watchdog_run(smod, needle, d) -> list:
    st = smod.Store([str(d)], coder_name="numpy")
    got = []
    try:
        v1 = st.add_volume(1)
        v2 = st.add_volume(2)
        v3 = st.add_volume(3)
        v1.write_needle(needle(cookie=1, id=1, data=b"data"))
        st.mark_readonly(3)                     # the operator's seal
        st.min_free_space_percent = 0.0
        got.append((st.check_free_space(), st.low_disk_space,
                    [v.read_only for v in (v1, v2, v3)]))
        st.min_free_space_percent = 101.0
        got.append((st.check_free_space(), st.low_disk_space,
                    [v.read_only for v in (v1, v2, v3)]))
        try:
            v1.write_needle(needle(cookie=2, id=2, data=b"no"))
            got.append("written")
        except Exception as e:
            got.append(type(e).__name__)
        st.mark_readonly(2)                     # an operator, while low
        got.append((st.check_free_space(),
                    [v.read_only for v in (v1, v2, v3)]))
        st.min_free_space_percent = 0.0
        got.append((st.check_free_space(), st.low_disk_space,
                    [v.read_only for v in (v1, v2, v3)]))
        v1.write_needle(needle(cookie=2, id=2, data=b"yes"))
        got.append(v1.read_needle(2).data)
    finally:
        st.close()
    return got


def test_watchdog_matches_reference(tmp_path):
    seen = {name: _watchdog_run(smod, needle, tmp_path / name)
            for name, (smod, _, needle, _) in PACKAGES.items()}
    assert seen["port"] == seen["ref"]
    assert seen["port"][1][2] == [True, True, True]
    assert seen["port"][4][2] == [False, True, True]


def _d9_run(smod, needle, geo, d, seal) -> tuple:
    """The watchdog seals a volume; then another seal lands on it (an
    encode, or a tier upload); then space comes back."""
    g = geo.Geometry(4, 2, **SMALL)
    st = smod.Store([str(d)], coder_name="numpy",
                    geometry_policy=geo.GeometryPolicy({}, g))
    try:
        v = st.add_volume(1)
        for i in range(1, 30):
            v.write_needle(needle(cookie=i, id=i, data=os.urandom(700)))
        st.min_free_space_percent = 101.0
        st.check_free_space()
        sealed_by_watchdog = v.read_only
        if seal == "ec_generate":
            st.ec_generate(1)
        else:
            st.tier_upload(1, {"type": "local_store",
                               "directory": str(d) + "_bucket"})
        st.min_free_space_percent = 0.0
        st.check_free_space()
        v = st.find_volume(1)
        return sealed_by_watchdog, v.read_only
    finally:
        st.close()


@pytest.mark.parametrize("seal", ["ec_generate", "tier_upload"])
def test_d9_watchdog_lifts_only_its_own_seal(tmp_path, seal):
    """D9: after ec_generate of a volume the watchdog had sealed, space
    coming back lifts the seal in the reference (a write acknowledged
    then is lost when ec.encode deletes the source); the port keeps it.
    A tier upload keeps it sealed in both (a remote .dat is never
    unsealed)."""
    seen = {name: _d9_run(smod, needle, geo, tmp_path / name, seal)
            for name, (smod, _, needle, geo) in PACKAGES.items()}
    assert seen["port"] == (True, True)
    assert seen["ref"] == ((True, False) if seal == "ec_generate"
                           else (True, True))


def test_port_seals_supersede_the_watchdog(tmp_path):
    """Every seal of the port that is not the watchdog's (the EC
    window's seal, set_read_only from a move or the lifecycle daemon)
    clears watchdog_sealed, so space coming back leaves it sealed."""
    st = pstore.Store([str(tmp_path)], coder_name="numpy")
    try:
        vols = [st.add_volume(vid) for vid in (1, 2, 3)]
        st.min_free_space_percent = 101.0
        st.check_free_space()
        assert all(v.read_only and v.watchdog_sealed for v in vols)
        vols[0].seal()
        vols[1].set_read_only(True)
        st.min_free_space_percent = 0.0
        st.check_free_space()
        assert [v.read_only for v in vols] == [True, True, False]
        assert not any(v.watchdog_sealed for v in vols)
    finally:
        st.close()


class _VirtualClock:
    """monotonic() advances only by the sleeps asked for."""

    def __init__(self):
        self.now = 0.0
        self.sleeps = []

    def module(self):
        def sleep(s):
            self.sleeps.append(s)
            self.now += s
        return types.SimpleNamespace(
            monotonic=lambda: self.now, sleep=sleep, time=time.time,
            time_ns=time.time_ns, perf_counter=time.perf_counter)


def _fill(v, needle, n=300, seed=2):
    rng = random.Random(seed)
    for i in range(1, n + 1):
        v.write_needle(needle(cookie=i, id=i,
                              data=rng.randbytes(rng.randint(100, 8000))))
    for i in range(1, n + 1, 3):
        v.delete_needle(needle(cookie=i, id=i))


@pytest.mark.parametrize("rate", [0, 100_000, 1_000_000])
def test_throttle_sleeps_match_reference(tmp_path, monkeypatch, rate):
    """On a virtual clock both packages' copies ask for the same sleeps,
    and the copy's virtual time covers its bytes at the rate."""
    seen = {}
    for name, (_, vmod, needle, _) in PACKAGES.items():
        clock = _VirtualClock()
        monkeypatch.setattr(vmod, "time", clock.module())
        d = str(tmp_path / name)
        os.makedirs(d)
        v = vmod.Volume(d, "", 1, create=True)
        _fill(v, needle)
        v.begin_compact(rate)
        copied = os.path.getsize(os.path.join(d, "1.cpd"))
        v.commit_compact()
        v.close()
        seen[name] = (clock.sleeps, clock.now, copied)
    assert seen["port"][0] == pytest.approx(seen["ref"][0])
    assert seen["port"][2] == seen["ref"][2]
    sleeps, now, copied = seen["port"]
    if rate:
        # the superblock is not throttled
        assert now == pytest.approx((copied - 8) / rate)
    else:
        assert sleeps == []


def test_throttled_compaction_does_not_stall_reads(tmp_path):
    """The copy sleeps outside the volume's lock: a reader in another
    thread is served throughout, and the copy takes at least bytes/rate."""
    v = pvolume.Volume(str(tmp_path), "", 1, create=True)
    _fill(v, PNeedle)
    live = [nv.key for nv in v.nm.values() if nv.size > 0]
    rate = 1_000_000
    worst = [0.0]
    stop = threading.Event()

    def reader():
        i = 0
        while not stop.is_set():
            t0 = time.perf_counter()
            v.read_needle(live[i % len(live)])
            worst[0] = max(worst[0], time.perf_counter() - t0)
            i += 1
            time.sleep(0.002)

    th = threading.Thread(target=reader)
    th.start()
    t0 = time.perf_counter()
    try:
        v.begin_compact(rate)
    finally:
        wall = time.perf_counter() - t0
        stop.set()
        th.join()
    copied = os.path.getsize(str(tmp_path / "1.cpd")) - 8
    v.commit_compact()
    assert wall >= copied / rate
    assert worst[0] < 0.25, worst
    assert sorted(nv.key for nv in v.nm.values() if nv.size > 0) == \
        sorted(live)
    v.close()


def test_volume_server_maintenance_and_vacuum_rate(tmp_path):
    """Through a port server: /admin/vacuum/compact honours the
    reference's compaction_byte_per_second; the heartbeat loop's
    maintenance seals the volumes when the threshold rises above the free
    space and lifts the seal when it drops."""
    g = pgeo.Geometry(10, 4, **SMALL)
    cl = LocalCluster(1, coder_name="numpy", geometry=g,
                      volume_size_limit_mb=64, pulse=0.1,
                      directory=str(tmp_path))
    try:
        client = PClient(cl.master_url)
        rng = random.Random(5)
        fids = [client.upload(rng.randbytes(20_000), collection="m")
                for _ in range(60)]
        vid = int(fids[0].split(",")[0])
        for fid in fids[:20]:
            client.delete(fid)
        url = cl.url(0)
        v = cl.store(0).find_volume(vid)
        rate = 400_000
        t0 = time.perf_counter()
        client.volume_admin(url, "vacuum/compact",
                            {"volume_id": vid,
                             "compaction_byte_per_second": rate})
        wall = time.perf_counter() - t0
        copied = os.path.getsize(v.base_file_name() + ".cpd") - 8
        client.volume_admin(url, "vacuum/commit", {"volume_id": vid})
        assert wall >= copied / rate >= 1.5
        st = cl.store(0)
        st.min_free_space_percent = 101.0
        deadline = time.monotonic() + 10
        while not (v := st.find_volume(vid)).read_only:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert v.watchdog_sealed
        st.min_free_space_percent = 0.0
        deadline = time.monotonic() + 10
        while st.find_volume(vid).read_only:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert client.download(fids[30])
    finally:
        cl.shutdown()


PREALLOCATE = 4 * 1024 * 1024


def _preallocated_run(smod, needle, d, preallocate: int) -> list:
    st = smod.Store([str(d)], coder_name="numpy", preallocate=preallocate)
    st.add_volume(1)
    path = st.find_volume(1).base_file_name() + ".dat"
    fresh = os.stat(path)
    st.write_needle(1, needle(cookie=7, id=1, data=b"x" * 5000))
    written = os.stat(path)
    got = st.read_needle(1, 1, cookie=7).data == b"x" * 5000
    st.close()
    return [fresh.st_size, fresh.st_blocks * 512 >= PREALLOCATE,
            written.st_size, written.st_blocks * 512 >= PREALLOCATE, got]


@pytest.mark.parametrize("preallocate", [0, PREALLOCATE])
def test_preallocate_reserves_space_as_reference(tmp_path, preallocate):
    """A Store's ``preallocate`` reserves the bytes of a new volume's .dat
    (fallocate with KEEP_SIZE): the blocks are there while the size stays
    the superblock's, and writes append from it, as in the reference."""
    seen = {name: _preallocated_run(smod, needle, tmp_path / name,
                                    preallocate)
            for name, (smod, _, needle, _) in PACKAGES.items()}
    assert seen["port"] == seen["ref"]
    assert seen["port"][0] == 8
    if preallocate:
        assert seen["port"][1] and seen["port"][3]
    else:
        assert not seen["port"][1]


def test_cli_volume_flags_reach_the_store(monkeypatch):
    """``volume -index -minFreeSpacePercent -preallocate`` build the Store
    the server runs (the server itself is not started)."""
    from seaweedfs_torch import cli
    from seaweedfs_torch.storage import store as store_mod
    made = {}

    class _Store:
        def __init__(self, dirs, **kwargs):
            made.update(kwargs, dirs=dirs)

        def close(self):
            made["closed"] = True

    monkeypatch.setattr(store_mod, "Store", _Store)
    monkeypatch.setattr(cli, "_serve_until_signalled", lambda start: None)
    cli.main(["volume", "-dir", "/d1,/d2", "-index", "leveldbMedium",
              "-minFreeSpacePercent", "5", "-preallocate", "4"])
    assert made["dirs"] == ["/d1", "/d2"]
    assert made["needle_map_kind"] == "leveldbMedium"
    assert made["min_free_space_percent"] == 5.0
    assert made["preallocate"] == PREALLOCATE
    assert made["closed"]
