"""The volume server's data path in the port, held against the reference.

* The engine: both packages' ``write_needles_batch`` with and without
  ``group_commit``, and ``write_needles_batch_nowait``, give byte-equal
  ``.dat`` and ``.idx`` files for the same needles at the same append
  times (the clock is pinned), and ``read_needle_nowait`` and the nowait
  write decline (None) exactly where the reference's do.
* ``utils/retry``: ``RetryPolicy`` schedules on one seeded rng, the
  circuit breaker's state sequence on one pinned clock,
  ``parse_retry_after``, ``is_shed`` and the deadline headers.
* The server: a needle corrupt on one holder of a ``010`` volume reads
  back good from every holder (tests/test_crashsim.py::
  test_crc_mismatch_triggers_read_repair_from_replica on the port); a
  lost local write is repaired from the replica; a fid with no replica
  copy is not fetched again within the negative cache; an expired needle
  is never repaired; with the peer stopped a corrupt needle answers 500
  at once. Group commit over HTTP: fewer fsyncs than uploads, every
  acknowledged upload reads back.
* D7: a read of an EC volume whose shards cannot be reached answers 404
  on the port and 500 on the reference, on one input.
"""

import asyncio
import functools
import os
import random
import signal
import threading
import time

import pytest

from cluster_util import Cluster
from seaweedfs_torch import faults as pfaults
from seaweedfs_torch.client import Client as PClient
from seaweedfs_torch.ec import geometry as pgeo
from seaweedfs_torch.server import http
from seaweedfs_torch.server.local_cluster import LocalCluster
from seaweedfs_torch.shell import ec_commands as pec
from seaweedfs_torch.storage import needle as pneedle
from seaweedfs_torch.storage import types as ptypes
from seaweedfs_torch.storage import volume as pvolume
from seaweedfs_torch.utils import retry as pretry
from seaweedfs_tpu.storage import needle as rneedle
from seaweedfs_tpu.storage import types as rtypes
from seaweedfs_tpu.storage import volume as rvolume
from seaweedfs_tpu.utils import retry as rretry

PG = pgeo.Geometry(10, 4, large_block_size=64 * 1024,
                   small_block_size=4 * 1024)
PULSE = 0.15
COOKIE = 0x1234ABCD


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


# --- the engine ----------------------------------------------------------

PKGS = {"port": (pvolume, pneedle, ptypes),
        "reference": (rvolume, rneedle, rtypes)}


@pytest.fixture()
def pinned_clock(monkeypatch):
    """time.time_ns counts up from a fixed start: append times are equal
    in both packages' runs."""
    state = {"t": 1_700_000_000_000_000_000}

    def time_ns():
        state["t"] += 1000
        return state["t"]

    def reset():
        state["t"] = 1_700_000_000_000_000_000

    monkeypatch.setattr(time, "time_ns", time_ns)
    return reset


def _needles(mod, seed: int, ids):
    rng = random.Random(seed)
    out = []
    for i, nid in enumerate(ids):
        n = mod.Needle(cookie=COOKIE, id=nid,
                       data=rng.randbytes(rng.choice([1, 96, 700, 5100])))
        n.set_flag(mod.FLAG_HAS_LAST_MODIFIED)
        n.last_modified = 1_700_000_000 + i
        out.append(n)
    return out


def _drive(kind: str, root: str, mode: str) -> dict:
    vmod, nmod, _ = PKGS[kind]
    v = vmod.Volume(root, "", 7, create=True)
    results = []
    batches = [list(range(1, 9)), list(range(5, 13)), [3, 3, 14],
               list(range(20, 60))]
    for b, ids in enumerate(batches):
        ns = _needles(nmod, b, ids)
        if mode == "group":
            res = v.write_needles_batch(ns, group_commit=True)
        elif mode == "nowait":
            res = v.write_needles_batch_nowait(ns)
        else:
            res = v.write_needles_batch(ns)
        results.append([r if isinstance(r, tuple) else type(r).__name__
                        for r in res])
    # an unchanged rewrite, a cookie mismatch and a delete in between
    same = _needles(nmod, 0, [1])
    bad = nmod.Needle(cookie=COOKIE + 1, id=2, data=b"other")
    results.append([r if isinstance(r, tuple) else type(r).__name__
                    for r in v.write_needles_batch(
                        same + [bad], group_commit=(mode == "group"))])
    v.delete_needle(nmod.Needle(cookie=COOKIE, id=4))
    tail = _needles(nmod, 9, [4, 70])
    results.append([r if isinstance(r, tuple) else type(r).__name__
                    for r in v.write_needles_batch(
                        tail, group_commit=(mode == "group"))])
    v.close()
    base = os.path.join(root, "7")
    with open(base + ".dat", "rb") as f:
        dat = f.read()
    with open(base + ".idx", "rb") as f:
        idx = f.read()
    return {"results": results, "dat": dat, "idx": idx}


@pytest.mark.parametrize("mode", ["plain", "group", "nowait"])
def test_batch_writes_byte_equal_to_the_reference(tmp_path, pinned_clock,
                                                  mode):
    out = {}
    for kind in PKGS:
        pinned_clock()
        root = tmp_path / kind
        root.mkdir()
        out[kind] = _drive(kind, str(root), mode)
    assert out["port"]["results"] == out["reference"]["results"]
    assert out["port"]["dat"] == out["reference"]["dat"]
    assert out["port"]["idx"] == out["reference"]["idx"]
    assert "ValueError" in out["port"]["results"][4]


def test_group_commit_is_one_pwritev_and_one_fsync(tmp_path, monkeypatch):
    calls = {"pwritev": 0, "pwrite": 0, "fsync": 0}
    for name in calls:
        real = getattr(os, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(os, name, spy)
    v = pvolume.Volume(str(tmp_path), "", 1, create=True)
    for k in calls:
        calls[k] = 0
    res = v.write_needles_batch(_needles(pneedle, 1, range(1, 33)),
                                group_commit=True)
    assert all(isinstance(r, tuple) for r in res)
    assert calls == {"pwritev": 1, "pwrite": 0, "fsync": 1}
    for nid in range(1, 33):
        assert v.read_needle(nid).cookie == COOKIE
    v.close()


def test_group_commit_failure_fails_the_whole_group(tmp_path):
    """A failed barrier acks none of the group and indexes none of it."""
    v = pvolume.Volume(str(tmp_path), "", 1, create=True)
    pfaults.set_fault("disk.sync", "error", count=1)
    try:
        res = v.write_needles_batch(_needles(pneedle, 2, [1, 2, 3]),
                                    group_commit=True)
    finally:
        pfaults.clear()
    assert all(isinstance(r, pfaults.FaultError) for r in res)
    for nid in (1, 2, 3):
        with pytest.raises(pvolume.NeedleNotFound):
            v.read_needle(nid)
    v.close()


def _decline_cases(kind: str, root: str) -> list:
    vmod, nmod, tmod = PKGS[kind]
    v = vmod.Volume(root, "", 3, create=True)
    small = nmod.Needle(cookie=COOKIE, id=1, data=b"s" * 100)
    big = nmod.Needle(cookie=COOKIE, id=2, data=b"b" * (70 * 1024))
    v.write_needle(small)
    v.write_needle(big)
    gone = nmod.Needle(cookie=COOKIE, id=3, data=b"g" * 10)
    v.write_needle(gone)
    v.delete_needle(nmod.Needle(cookie=COOKIE, id=3))
    old = nmod.Needle(cookie=COOKIE, id=4, data=b"o" * 10)
    old.set_flag(nmod.FLAG_HAS_TTL)
    old.ttl = tmod.TTL.parse("1m")
    old.set_flag(nmod.FLAG_HAS_LAST_MODIFIED)
    old.last_modified = 1000
    v.write_needle(old)
    out = []

    def read(nid, **kw):
        try:
            n = v.read_needle_nowait(nid, **kw)
            return None if n is None else n.data[:4]
        except KeyError as e:
            return type(e).__name__

    out += [read(1), read(1, cookie=COOKIE), read(1, cookie=1), read(2),
            read(2, max_size=128 * 1024), read(3), read(4), read(99)]
    # the nowait write: over a big entry it declines; fresh ones write
    out.append(v.write_needles_batch_nowait(
        [nmod.Needle(cookie=COOKIE, id=2, data=b"x")]))
    out.append([r[1:] for r in v.write_needles_batch_nowait(
        [nmod.Needle(cookie=COOKIE, id=5, data=b"y" * 50)])])
    # a taken lock: both decline
    held = threading.Event()
    release = threading.Event()

    def holder():
        with v._lock:
            held.set()
            release.wait(5)

    t = threading.Thread(target=holder)
    t.start()
    held.wait(5)
    out.append(read(1))
    out.append(v.write_needles_batch_nowait(
        [nmod.Needle(cookie=COOKIE, id=6, data=b"z")]))
    release.set()
    t.join()
    # a backend that is not local disk: both decline
    v._dat.is_local = False
    out.append(read(1))
    out.append(v.write_needles_batch_nowait(
        [nmod.Needle(cookie=COOKIE, id=7, data=b"z")]))
    v.close()
    return out


def test_nowait_declines_where_the_reference_declines(tmp_path):
    got = {}
    for kind in PKGS:
        root = tmp_path / kind
        root.mkdir()
        got[kind] = _decline_cases(kind, str(root))
    assert got["port"] == got["reference"]
    assert got["port"][:8] == [b"ssss", b"ssss", "NeedleNotFound", None,
                               b"bbbb", "NeedleDeleted", "NeedleExpired",
                               "NeedleNotFound"]
    assert got["port"][8] is None
    assert got["port"][-4:] == [None, None, None, None]


# --- utils/retry ---------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"max_attempts": 6, "base_delay": 0.1, "max_delay": 0.5},
    {"max_attempts": 4, "jitter": 0.0}, {"multiplier": 3.0, "jitter": 1.0},
    {"max_attempts": 0}])
def test_retry_policy_delays_like_the_reference(kw):
    mine = pretry.RetryPolicy(rng=random.Random(5), **kw)
    theirs = rretry.RetryPolicy(rng=random.Random(5), **kw)
    assert list(mine.delays()) == list(theirs.delays())
    assert [mine.backoff(a) for a in range(6)] == \
        [theirs.backoff(a) for a in range(6)]


def test_retry_policy_respects_the_deadline_budget(monkeypatch):
    now = {"t": 1000.0}
    monkeypatch.setattr(time, "time", lambda: now["t"])
    out = []
    for mod in (pretry, rretry):
        token = mod.set_deadline(0.3)
        try:
            pol = mod.RetryPolicy(max_attempts=8, base_delay=0.1,
                                  jitter=0.0)
            out.append(list(pol.delays()))
        finally:
            mod.reset_deadline(token)
    assert out[0] == out[1] == [0.1, 0.2]


def test_retry_call_like_the_reference(monkeypatch):
    monkeypatch.setattr(time, "sleep", lambda s: None)
    out = []
    for mod in (pretry, rretry):
        breaker = mod.CircuitBreaker(failure_threshold=2)
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise ConnectionError("no")
            return "ok"

        pol = mod.RetryPolicy(max_attempts=3, rng=random.Random(1))
        row = []
        try:
            row.append(pol.call(flaky, host="h", breaker=breaker))
        except ConnectionError as e:
            row.append(type(e).__name__)
        row.append(breaker.is_open("h"))
        try:
            pol.call(flaky, host="h", breaker=breaker)
        except Exception as e:
            row.append(type(e).__name__)
        else:
            row.append(len(calls))
        out.append(row)
    assert out[0] == out[1]


def test_breaker_state_sequence_like_the_reference(monkeypatch):
    clock = {"t": 50.0}
    monkeypatch.setattr(time, "monotonic", lambda: clock["t"])
    seqs = []
    for mod in (pretry, rretry):
        clock["t"] = 50.0
        b = mod.CircuitBreaker(failure_threshold=3, open_seconds=10.0)
        seq = []

        def check(host="a"):
            try:
                b.check(host)
                seq.append("pass")
            except mod.BreakerOpen:
                seq.append("open")

        for _ in range(2):
            b.record_failure("a")
            check()
        b.record_success("a")
        for _ in range(3):
            b.record_failure("a")
        check()
        seq.append(b.is_open("a"))
        clock["t"] += 10.0
        check()          # the half-open probe
        check()          # others still fail fast
        b.record_failure("a")   # the probe failed: open again
        check()
        clock["t"] += 10.0
        check()
        b.record_success("a")
        check()
        seq.append(b.is_open("a"))
        clock["t"] += 100.0
        for _ in range(3):
            b.record_failure("b")
        check("b")
        clock["t"] += 10.0
        check("b")      # probe taken, never reported
        clock["t"] += 10.0
        check("b")      # the lost probe's slot is given back
        b.reset()
        check("b")
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert seqs[0][:4] == ["pass", "pass", "open", True]


@pytest.mark.parametrize("value", [
    None, "", "0", "2", "2.5", "-4", "999", "abc",
    "Wed, 21 Oct 2015 07:28:00 GMT", "Fri, 01 Jan 2100 00:00:00 GMT"])
def test_parse_retry_after_like_the_reference(value, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 4_102_444_790.0)
    assert pretry.parse_retry_after(value) == \
        rretry.parse_retry_after(value)


@pytest.mark.parametrize("status,headers", [
    (429, {"X-Seaweed-Shed": "1"}), (503, {"x-seaweed-shed": "1"}),
    (503, {}), (500, {"X-Seaweed-Shed": "1"}), (429, None),
    (503, {"X-Seaweed-Shed": " 1 "}), (503, {"X-Seaweed-Shed": "0"})])
def test_is_shed_like_the_reference(status, headers):
    assert pretry.is_shed(status, headers) == \
        rretry.is_shed(status, headers)


def test_deadline_headers_like_the_reference(monkeypatch):
    now = {"t": 2000.0}
    monkeypatch.setattr(time, "time", lambda: now["t"])
    rows = []
    for mod in (pretry, rretry):
        row = [mod.inject_deadline({}), mod.cap_timeout(5.0),
               mod.remaining_budget()]
        tok = mod.bind_deadline({mod.DEADLINE_HEADER: "2.5"})
        row += [mod.current_deadline(), mod.inject_deadline({}),
                mod.cap_timeout(5.0), mod.cap_timeout(1.0),
                mod.cap_timeout(None)]
        now["t"] += 3.0
        try:
            mod.cap_timeout(5.0)
        except mod.DeadlineExceeded:
            row.append("exceeded")
        mod.reset_deadline(tok)
        row += [mod.bind_deadline({mod.DEADLINE_HEADER: "x"}),
                mod.bind_deadline({}), mod.bind_deadline(None),
                mod.current_deadline()]
        now["t"] = 2000.0
        rows.append(row)
    assert rows[0] == rows[1]
    assert rows[0][4] == {"X-Seaweed-Deadline": "2.5"}


def test_client_carries_the_deadline_and_honours_shed(monkeypatch):
    """The port's client sends the ambient budget's remaining seconds,
    waits out a shed answer's Retry-After once, and fails on any other
    retryable status."""
    from aiohttp import web

    seen, answers = [], []

    async def handler(request):
        seen.append(request.headers.get("X-Seaweed-Deadline"))
        status, headers = answers.pop(0)
        return web.json_response({"ok": True}, status=status,
                                 headers=headers)

    async def start():
        app = web.Application()
        app.router.add_get("/{p:.*}", handler)
        sock = http.listen_socket("127.0.0.1", 0)
        runner = await http.start_app(app, sock)
        return runner, sock.getsockname()[1]

    loop = asyncio.new_event_loop()
    th = threading.Thread(target=loop.run_forever, daemon=True)
    th.start()
    runner, port = asyncio.run_coroutine_threadsafe(start(), loop).result()
    slept = []
    monkeypatch.setattr(time, "sleep", lambda s: slept.append(s))
    try:
        client = PClient(f"127.0.0.1:{port}")
        answers[:] = [(503, {"X-Seaweed-Shed": "1", "Retry-After": "2"}),
                      (200, {})]
        token = pretry.set_deadline(30.0)
        try:
            assert client.cluster_status() == {"ok": True}
        finally:
            pretry.reset_deadline(token)
        assert slept == [2.0]
        assert all(s is not None and 0 < float(s) <= 30.0 for s in seen)
        answers[:] = [(502, {})]
        with pytest.raises(Exception, match="HTTP 502"):
            client.cluster_status()
        assert seen[-1] is None
    finally:
        asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result()
        loop.call_soon_threadsafe(loop.stop)
        th.join(10)
        loop.close()


# --- the server: read repair, group commit over HTTP ---------------------

def _pair(**kw) -> LocalCluster:
    """Two servers on two racks, default replication 010."""
    return LocalCluster(2, coder_name="numpy", geometry=PG,
                        volume_size_limit_mb=1, pulse=PULSE, racks=2,
                        master_kwargs={"default_replication": "010",
                                       "repair_enabled": False}, **kw)


def _metric(cl, name: str) -> float:
    return sum(n[0].metrics.value(name) for n in cl.nodes
               if n[0] is not None)


@within(60)
def test_crc_mismatch_triggers_read_repair_from_replica():
    cl = _pair()
    try:
        client = PClient(cl.master_url)
        client.upload(b"warmup", collection="crc")
        payload = bytes(range(256)) * 16
        pfaults.set_fault("disk.write", "corrupt", count=1, seed=11)
        try:
            fid = client.upload(payload, collection="crc")
        finally:
            pfaults.clear("disk.write")
        locs = client.lookup(int(fid.split(",")[0]))
        assert len(locs) == 2
        for url in locs:
            assert client.download(fid, url=url) == payload
        assert _metric(cl, "read_crc_repair") == 1
        assert _metric(cl, "read_repair") == 1
        # the next read is served locally
        for url in locs:
            assert client.download(fid, url=url) == payload
        assert _metric(cl, "read_repair") == 1
    finally:
        cl.shutdown()


@within(60)
def test_lost_write_is_repaired_and_negatives_are_cached():
    """A needle whose index entry one holder lost reads back from that
    holder (repaired from its replica); a fid no replica has answers
    404 and is not fetched again within the negative cache; an expired
    needle is never repaired."""
    cl = _pair()
    try:
        client = PClient(cl.master_url)
        fid = client.upload(b"L" * 3000, collection="lost")
        vid = int(fid.split(",")[0])
        key = int(fid.split(",")[1][:-8], 16)
        a = cl.url(0)
        va = cl.store(0).find_volume(vid)
        va.nm._map.pop(key)      # the lost local write
        assert client.download(fid, url=a) == b"L" * 3000
        assert _metric(cl, "read_repair") == 1
        assert va.read_needle(key).data == b"L" * 3000
        # a fid no holder has: 404, and a second read makes no fetch
        bogus = fid[:-8] + "00000000"
        fetches = []
        for node in cl.nodes:
            inner = node[0]._read_repair_inner

            async def counted(f, _inner=inner):
                fetches.append(str(f))
                return await _inner(f)

            node[0]._read_repair_inner = counted
        for _ in range(2):
            r = http.request("GET", f"http://{a}/{bogus}")
            assert r.status == 404
        assert len(fetches) == 1
        # an expired needle: 404, never fetched
        old = client.assign(collection="lost", ttl="1m")
        r = http.request("POST", f"http://{old['url']}/{old['fid']}"
                         "?ttl=1m", b"T" * 100)
        assert r.status == 201
        ovid = int(old["fid"].split(",")[0])
        okey = int(old["fid"].split(",")[1][:-8], 16)
        holder = cl.index_of(old["url"])
        v = cl.store(holder).find_volume(ovid)
        real_time = time.time
        try:
            pvolume.time.time = lambda: real_time() + 3600
            r = http.request("GET", f"http://{old['url']}/{old['fid']}")
        finally:
            pvolume.time.time = real_time
        assert r.status == 404
        assert v.read_needle(okey).data == b"T" * 100
        assert old["fid"] not in fetches
    finally:
        cl.shutdown()


@within(60)
def test_corrupt_needle_with_the_peer_stopped_answers_500_at_once():
    cl = _pair()
    try:
        client = PClient(cl.master_url)
        client.upload(b"warmup", collection="dead")
        fid = None
        pfaults.set_fault("disk.write", "corrupt", count=1, seed=3)
        try:
            fid = client.upload(b"Q" * 4000, collection="dead")
        finally:
            pfaults.clear("disk.write")
        vid = int(fid.split(",")[0])
        # the corrupt copy is on the server the upload went to first
        corrupt = [u for u in client.lookup(vid)
                   if _is_corrupt(cl, u, fid)]
        assert len(corrupt) == 1
        other = next(u for u in client.lookup(vid) if u != corrupt[0])
        cl.stop_volume_server(cl.index_of(other))
        times = []
        for _ in range(8):
            t0 = time.monotonic()
            r = http.request("GET", f"http://{corrupt[0]}/{fid}",
                             timeout=30)
            times.append(time.monotonic() - t0)
            assert r.status == 500 and b"data corruption" in r.data
        assert max(times) < 2.0, times
    finally:
        cl.shutdown()


def _is_corrupt(cl, url: str, fid: str) -> bool:
    vid = int(fid.split(",")[0])
    key = int(fid.split(",")[1][:-8], 16)
    try:
        cl.store(cl.index_of(url)).find_volume(vid).read_needle(key)
    except ValueError:
        return True
    return False


@within(90)
def test_group_commit_over_http_acks_after_one_fsync_per_group(
        monkeypatch):
    monkeypatch.setenv("WEED_VOLUME_GROUP_COMMIT_US", "20000")
    cl = LocalCluster(1, coder_name="numpy", geometry=PG,
                      volume_size_limit_mb=8, pulse=PULSE, racks=1,
                      master_kwargs={"repair_enabled": False})
    fsyncs = []
    real = os.fsync
    try:
        client = PClient(cl.master_url)
        assert cl.nodes[0][0]._batcher.group_commit_us == 20000
        warm = client.upload(b"w" * 10, collection="gc")
        vid = int(warm.split(",")[0])
        monkeypatch.setattr(os, "fsync",
                            lambda fd: (fsyncs.append(fd), real(fd))[1])
        acked = {}
        lock = threading.Lock()

        def writer(w: int) -> None:
            c = PClient(cl.master_url)
            for i in range(12):
                data = bytes([w]) * (100 + 37 * i)
                a = c.assign(collection="gc")
                c.upload_blob(a["url"], a["fid"], data)
                with lock:
                    acked[a["fid"]] = data

        threads = [threading.Thread(target=writer, args=(w,))
                   for w in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert len(acked) == 16 * 12
        assert {int(f.split(",")[0]) for f in acked} == {vid}
        assert 0 < len(fsyncs) < len(acked) / 2, len(fsyncs)
        for fid, data in acked.items():
            assert client.download(fid) == data
    finally:
        monkeypatch.setattr(os, "fsync", real)
        cl.shutdown()


# --- D7: unreachable shards answer 404 on the port, 500 on the reference --

@within(120)
def test_unreachable_shards_answer_404_where_the_reference_answers_500():
    """One server holds every shard of an EC volume and loses five of
    them (as holders dropping their shards mid-decode leave a reader):
    a needle on a lost shard cannot be reconstructed. The reference
    answers 500; the port answers 404, as upstream's read handler does,
    so a client goes on to another holder."""
    answers = {}
    for name in ("port", "reference"):
        if name == "port":
            cl = LocalCluster(1, coder_name="numpy", geometry=PG,
                              volume_size_limit_mb=1, pulse=PULSE, racks=1,
                              master_kwargs={"repair_enabled": False})
            master_url, url = cl.master_url, cl.url(0)
        else:
            cl = Cluster(n_volume_servers=1, pulse=PULSE)
            for m in cl.masters:
                m.repair_enabled = False
            master_url, url = cl.master_url, cl.volume_servers[0].url
        try:
            client = PClient(master_url)
            rng = random.Random(21)
            fids = []
            for _ in range(12):
                fids.append(client.upload(
                    rng.randbytes(rng.randint(3000, 30000)),
                    collection="d7"))
            vid = int(fids[0].split(",")[0])
            assert {int(f.split(",")[0]) for f in fids} == {vid}
            pec.EcCommands(client, PG).encode(vid, "d7")
            client.volume_admin(url, "ec/delete_shards",
                                {"volume_id": vid, "collection": "d7",
                                 "shard_ids": [0, 1, 2, 3, 4]})
            answers[name] = [http.request("GET", f"http://{url}/{f}",
                                          timeout=30).status
                             for f in fids]
        finally:
            cl.shutdown()
    assert 500 in answers["reference"] and 200 in answers["reference"]
    assert answers["port"] == [404 if s == 500 else s
                               for s in answers["reference"]]
