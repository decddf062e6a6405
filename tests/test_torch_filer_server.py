"""The port's filer server (seaweedfs_torch/server/filer_server.py) and
the master's watch stream against the reference's, over HTTP.

Both packages' clusters (the reference's tests/cluster_util.Cluster, the
port's LocalCluster: a master and three volume servers, 1 MB volumes,
RS(10,4) at the test geometry) each get a filer on the memory store at a
16 KiB chunk size and the same requests: multi-chunk files, ranges
across chunk boundaries and sparse holes; overwrites that free the old
chunks and paginated listings; mkdir, rename, delete and ETag/304; a
super-chunked file folded into manifests; the ``/__meta__`` answers with
fids and times masked; the assign lease's hits and invalidation; a chunk
POST into a volume sealed under the lease; the master's
``/cluster/watch`` (snapshot, an update when a volume appears, the
``resync`` marker on overflow, a follower's 307). The reference's filer
runs with its chunk cache off (as the port's always reads) so that reads
reach the volume servers in both. Two cases hold the packages apart on
purpose: a chunk deleted while its volume is sealed is freed by the
port's retrying deletion worker and leaked by the reference's (ROADMAP
Queue 3, D15), and a chunk that fails after the header cuts the body
short in both (D16).
"""

import asyncio
import http.client
import json
import os
import random
import time

import pytest

from cluster_util import Cluster
from seaweedfs_torch.ec.geometry import Geometry
from seaweedfs_torch.filer import assign_lease as plib
from seaweedfs_torch.server import http as phttp
from seaweedfs_torch.server.local_cluster import LocalCluster
from seaweedfs_torch.utils import metrics as pmetrics
from seaweedfs_tpu.filer import assign_lease as rlib
from seaweedfs_tpu.utils import metrics as rmetrics

CHUNK = 16 * 1024
TEST_GEOMETRY = Geometry(10, 4, large_block_size=64 * 1024,
                         small_block_size=4 * 1024)
PKGS = ("reference", "port")


class Side:
    """One package's cluster and filer, driven over HTTP."""

    def __init__(self, pkg: str):
        self.pkg = pkg
        if pkg == "reference":
            saved = {k: os.environ.get(k) for k in
                     ("WEED_CHUNK_CACHE_MB", "WEED_CHUNK_CACHE_WRITE_THROUGH")}
            os.environ["WEED_CHUNK_CACHE_MB"] = "0"
            os.environ["WEED_CHUNK_CACHE_WRITE_THROUGH"] = "0"
            try:
                self.cluster = Cluster(n_volume_servers=3)
                self.fs = self.cluster.add_filer(chunk_size=CHUNK)
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            self.master = self.cluster.master
        else:
            self.cluster = LocalCluster(3, coder_name="numpy",
                                        geometry=TEST_GEOMETRY,
                                        volume_size_limit_mb=1, pulse=0.15)
            self.fs = self.cluster.add_filer(chunk_size=CHUNK)
            self.master = self.cluster.master
        self.url = f"http://{self.fs.url}"
        self.master_url = self.cluster.master_url.split(",")[0]
        self.wait_watch()

    def wait_watch(self, timeout: float = 10.0) -> None:
        """Until the filer's watch stream delivered its snapshot."""
        deadline = time.monotonic() + timeout
        if self.pkg == "port":
            while self.fs.watch_messages == 0:
                assert time.monotonic() < deadline
                time.sleep(0.02)

    def req(self, method, path, body=None, headers=None):
        return phttp.request(method, self.url + path, body, headers or {})

    def put(self, path, data, query=""):
        r = self.req("PUT", path + query, data,
                     {"Content-Type": "application/octet-stream"})
        assert r.status == 201, (self.pkg, r.status, r.data)
        return json.loads(r.data)

    def get(self, path, headers=None):
        return self.req("GET", path, headers=headers)

    def meta(self, route, **params):
        qs = "&".join(f"{k}={v}" for k, v in params.items())
        return phttp.get_json(f"{self.url}/__meta__/{route}?{qs}")

    def post_meta(self, route, body):
        return phttp.post_json(f"{self.url}/__meta__/{route}", body)

    def fids(self, path):
        status, e = self.meta("lookup", path=path)
        assert status == 200, (self.pkg, path, e)
        return [c["fid"] for c in e["chunks"]]

    def holders(self, vid):
        status, body = phttp.get_json(
            f"http://{self.master_url}/dir/lookup?volumeId={vid}")
        return [loc["url"] for loc in body.get("locations", [])]

    def fid_status(self, fid):
        """The fid's GET status on its first holder (404 once freed)."""
        urls = self.holders(int(fid.split(",")[0]))
        return phttp.request("GET", f"http://{urls[0]}/{fid}").status

    def seal(self, vid, read_only=True):
        for url in self.holders(vid):
            status, out = phttp.post_json(
                f"http://{url}/admin/volume/readonly",
                {"volume_id": vid, "read_only": read_only})
            assert status == 200, out

    def metric(self, name):
        return self.fs.metrics.value(name)

    def shutdown(self):
        self.cluster.shutdown()


@pytest.fixture(scope="module")
def sides():
    out = {pkg: Side(pkg) for pkg in PKGS}
    yield out
    for side in out.values():
        side.shutdown()


def _both(sides, fn):
    got = {pkg: fn(side) for pkg, side in sides.items()}
    assert got["port"] == got["reference"], got
    return got["port"]


def wait_until(cond, what, timeout=15.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timeout: {what}")
        time.sleep(0.05)


SIZES = (0, 1, CHUNK - 1, CHUNK, CHUNK + 1, 100_000)
RANGES = ("bytes=16000-17000", "bytes=16383-16385", "bytes=-100",
          "bytes=50000-", "bytes=0-0", "bytes=99990-200000")


def test_files_ranges_and_sparse_holes(sides):
    rng = random.Random(11)
    files = {f"/f/s{n}.bin": rng.randbytes(n) for n in SIZES}

    def run(side):
        out = []
        for path, data in files.items():
            put = side.put(path, data)
            r = side.get(path)
            assert r.data == data
            out.append((put, r.status, r.headers["Content-Length"]))
        big = files["/f/s100000.bin"]
        for rg in RANGES:
            r = side.get("/f/s100000.bin", {"Range": rg})
            out.append((rg, r.status, r.headers.get("Content-Range"),
                        len(r.data)))
            s, _, e = rg[6:].partition("-")
            want = (big[-int(e):] if not s
                    else big[int(s):(int(e) + 1 if e else None)])
            assert r.data == want, (side.pkg, rg)
        out.append(side.get("/f/s100000.bin",
                            {"Range": "bytes=200000-"}).status)
        # a sparse file: the chunks of s100000 moved up by 50000 bytes,
        # a second copy of the first chunk at 0; the gap reads as zeros
        status, e = side.meta("lookup", path="/f/s100000.bin")
        first = dict(e["chunks"][0])
        for c in e["chunks"]:
            c["offset"] += 50_000
        e["chunks"].insert(0, first)
        e["path"] = "/f/sparse.bin"
        side.post_meta("create_entry", {"entry": e,
                                        "free_old_chunks": False})
        r = side.get("/f/sparse.bin")
        want = big[:CHUNK] + bytes(50_000 - CHUNK) + big
        assert r.data == want, side.pkg
        r = side.get("/f/sparse.bin", {"Range": "bytes=16000-60000"})
        assert r.data == want[16000:60001]
        out.append(len(want))
        return out

    _both(sides, run)


def test_overwrite_frees_old_chunks_and_paginates(sides):
    rng = random.Random(12)
    first, second = rng.randbytes(3 * CHUNK), rng.randbytes(2 * CHUNK + 7)

    def run(side):
        side.put("/o/file.bin", first)
        old = side.fids("/o/file.bin")
        side.put("/o/file.bin", second)
        assert side.get("/o/file.bin").data == second
        wait_until(lambda: all(side.fid_status(f) == 404 for f in old),
                   f"{side.pkg}: the old chunks freed")
        for i in range(10):
            side.put(f"/o/list/n{i:02d}", bytes([i]) * (i + 1))
        pages, last = [], ""
        while True:
            status, body = phttp.get_json(
                f"{side.url}/o/list/?limit=3&lastFileName={last}")
            names = [x["FullPath"].rsplit("/", 1)[1]
                     for x in body["Entries"]]
            pages.append((names, body["ShouldDisplayLoadMore"],
                          [x["Size"] for x in body["Entries"]]))
            if not body["ShouldDisplayLoadMore"]:
                break
            last = body["LastFileName"]
        return len(old), pages

    _both(sides, run)


def test_mkdir_rename_delete_and_etag(sides):
    data = random.Random(13).randbytes(2 * CHUNK + 5)

    def run(side):
        out = []
        r = side.req("POST", "/m/dir?op=mkdir")
        out.append((r.status, json.loads(r.data)))
        side.put("/m/dir/a/file.bin", data)
        r = side.get("/m/dir/a/file.bin")
        etag = r.headers["ETag"]
        out.append(side.get("/m/dir/a/file.bin",
                            {"If-None-Match": etag}).status)
        out.append(side.get("/m/dir/a/file.bin",
                            {"If-None-Match": '"other"'}).status)
        r = side.req("POST", "/m/dir?mv.to=/m/moved")
        out.append((r.status, json.loads(r.data)))
        out.append(side.get("/m/dir/a/file.bin").status)
        assert side.get("/m/moved/a/file.bin").data == data
        out.append(side.get("/m/moved/a/file.bin").headers["ETag"] == etag)
        out.append(side.req("POST", "/m/nope?mv.to=/m/x").status)
        fids = side.fids("/m/moved/a/file.bin")
        out.append(side.req("DELETE", "/m/moved").status)
        out.append(side.req("DELETE", "/m/moved?recursive=true").status)
        out.append(side.get("/m/moved").status)
        out.append(side.req("DELETE", "/m/moved").status)
        wait_until(lambda: all(side.fid_status(f) == 404 for f in fids),
                   f"{side.pkg}: a recursive delete frees the chunks")
        return out

    _both(sides, run)


def test_super_chunked_file_folds_into_manifests(sides):
    """manifest_batch set small (as tests/test_filer_breadth.py does):
    a 21-chunk file folds into manifests of 4, reads back whole and by
    range, resolves to its data chunks, and its delete frees them all."""
    data = random.Random(14).randbytes(21 * CHUNK - 3)

    def run(side):
        side.fs.manifest_batch = 4
        try:
            put = side.put("/big/super.bin", data)
        finally:
            side.fs.manifest_batch = 1000
        status, e = side.meta("lookup", path="/big/super.bin")
        kinds = [bool(c.get("is_chunk_manifest")) for c in e["chunks"]]
        assert side.get("/big/super.bin").data == data
        r = side.get("/big/super.bin", {"Range": "bytes=65000-200000"})
        assert r.data == data[65000:200001]
        status, res = side.meta("resolve_chunks", path="/big/super.bin")
        data_fids = [c["fid"] for c in res["chunks"]]
        assert side.req("DELETE", "/big/super.bin").status == 202
        everything = data_fids + [c["fid"] for c in e["chunks"]]
        wait_until(lambda: all(side.fid_status(f) == 404
                               for f in everything),
                   f"{side.pkg}: data and manifest chunks freed")
        return put, kinds, len(data_fids), \
            [c["offset"] for c in res["chunks"]]

    put, kinds, n, offsets = _both(sides, run)
    assert sum(kinds) >= 2 and n == 21


def _mask(obj):
    """Fids, times, etags, urls and signatures masked."""
    if isinstance(obj, dict):
        return {k: ("*" if k in ("fid", "mtime", "crtime", "tsns",
                                 "etag", "signature", "url", "publicUrl",
                                 "eTag", "Mtime")
                    else _mask(v)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_mask(v) for v in obj]
    return obj


def test_meta_answers_equal_masked(sides):
    data = random.Random(15).randbytes(CHUNK + 9)

    def run(side):
        out = []
        side.put("/meta/a.bin", data)
        out.append(side.meta("lookup", path="/meta/a.bin"))
        out.append(side.meta("lookup", path="/meta/none"))
        out.append(side.meta("list", dir="/meta"))
        out.append(side.meta("list", dir="/meta", prefix="a", limit=1))
        out.append(side.post_meta("create_entry", {"entry": {
            "path": "/meta/d", "attr": {"mode": 0o40770}}}))
        out.append(side.post_meta("create_entry", {"entry": {
            "path": "/meta/d", "attr": {"mode": 0o40770}},
            "o_excl": True}))
        out.append(side.post_meta("create_entry", {"entry": {
            "path": "/meta/a.bin/x", "attr": {"mode": 0o100660}}}))
        status, e = side.meta("lookup", path="/meta/a.bin")
        e["extended"] = {"k": "v"}
        out.append(side.post_meta("update_entry", {"entry": e}))
        out.append(side.meta("lookup", path="/meta/a.bin"))
        e["path"] = "/meta/ghost"
        out.append(side.post_meta("update_entry", {"entry": e}))
        out.append(side.post_meta("rename", {"from": "/meta/a.bin",
                                             "to": "/meta/b.bin"}))
        out.append(side.post_meta("rename", {"from": "/meta/zzz",
                                             "to": "/meta/y"}))
        out.append(side.meta("resolve_chunks", path="/meta/b.bin",
                             shift=10))
        out.append(side.post_meta("delete", {"path": "/meta"}))
        out.append(side.post_meta("delete", {"path": "/meta/d"}))
        out.append(side.post_meta("delete", {"path": "/meta/none"}))
        status, info = side.meta("info")
        out.append((status, sorted(info)))
        status, a = side.meta("assign", count=3)
        out.append((status, a["count"], sorted(a)))
        out.append(side.meta("assign", count=0))
        vid = int(a["fid"].split(",")[0])
        status, loc = side.meta("lookup_volume", volumeId=vid)
        out.append((status, len(loc["locations"])))
        out.append(side.meta("lookup_volume", volumeId=9999))
        status, ev = side.meta("events", since=0, prefix="/meta")
        out.append((status, len(ev["events"]) > 5))
        return _mask(out)

    _both(sides, run)


def test_assign_lease_hits_and_invalidation(sides):
    data = random.Random(16).randbytes(8 * CHUNK)

    def run(side):
        hit0 = side.metric("assign_lease_hit")
        miss0 = side.metric("assign_lease_miss")
        side.put("/lease/a.bin", data)
        side.put("/lease/b.bin", data)
        hits = side.metric("assign_lease_hit") - hit0
        misses = side.metric("assign_lease_miss") - miss0
        fid = side.fids("/lease/b.bin")[-1]
        inv = side.fs._assign_pool.invalidate(fid)
        miss1 = side.metric("assign_lease_miss")
        side.put("/lease/c.bin", data[:CHUNK])
        assert side.get("/lease/c.bin").data == data[:CHUNK]
        return (hits >= 13, misses <= 3, inv,
                side.metric("assign_lease_miss") - miss1,
                side.metric("assign_lease_invalidate") >= 1)

    assert _both(sides, run) == (True, True, 1, 1.0, True)


def _fake_fetch(vid_box):
    state = {"calls": 0, "key": 16}

    async def fetch(params, count):
        state["calls"] += 1
        await asyncio.sleep(0.001)
        key = state["key"]
        state["key"] += count
        return {"fid": f"{vid_box[0]},{key:x}000000ff", "url": "vs:1",
                "publicUrl": "vs:1", "count": count, "replicas": []}

    return fetch, state


@pytest.mark.parametrize("lib,metrics", [(plib, pmetrics),
                                         (rlib, rmetrics)],
                         ids=["port", "reference"])
def test_async_lease_pool_unit(lib, metrics):
    """The pool against a fake master, as tests/test_assign_lease.py
    drives the reference's: one refill serves concurrent misses, a
    drained lease doubles, invalidation drops the volume."""

    async def main():
        vid_box = [7]
        fetch, state = _fake_fetch(vid_box)
        reg = metrics.Registry("t")
        # the reference's pool also reads WEED_ASSIGN_LEASE, so it is
        # switched on explicitly; the port's has no lease-off path
        extra = {"enabled": True} if lib is rlib else {}
        pool = lib.AsyncAssignLeasePool(fetch, metrics=reg, start_count=8,
                                        max_count=64, ttl=30.0, **extra)
        got = await asyncio.gather(*[pool.get() for _ in range(8)])
        fids = [a["fid"] for a in got]
        assert state["calls"] == 1 and len(set(fids)) == 8
        await pool.get()
        leases = pool.core._leases
        assert leases[("", "", "")].count == 16
        vid_box[0] = 9
        assert pool.invalidate(fids[0]) == 1
        after = await pool.get()
        return (fids, after["fid"], state["calls"],
                reg.value("assign_lease_hit"),
                reg.value("assign_lease_miss"),
                reg.value("assign_lease_invalidate"))

    fids, after, calls, hits, misses, inv = asyncio.run(main())
    assert after.startswith("9,") and calls == 3
    assert (hits, misses, inv) == (7.0, 3.0, 1.0)
    assert fids[1] == "7,11000000ff"


def test_chunk_post_into_sealed_volume_retries(sides):
    """A lease's volume sealed (as a warm-down seals it) under the
    filer: the next chunk POST bounces 409, the lease is invalidated and
    the chunk lands on a fresh fid; the file reads back."""
    rng = random.Random(17)
    small, data = rng.randbytes(100), rng.randbytes(3 * CHUNK)

    def run(side):
        side.put("/seal/first.bin", small, "?collection=sealc")
        vid = int(side.fids("/seal/first.bin")[0].split(",")[0])
        side.seal(vid)
        # the master must have heard of the seal, or the retry's fresh
        # assignment could name the same volume
        wait_until(lambda: all(
            v.get("read_only") for n in phttp.get_json(
                f"http://{side.master_url}/dir/status")[1]["nodes"]
            for v in n.get("volumes", []) if v.get("id") == vid),
            f"{side.pkg}: the master lists volume {vid} read-only")
        inv0 = side.metric("assign_lease_invalidate")
        put = side.put("/seal/second.bin", data, "?collection=sealc")
        assert side.get("/seal/second.bin").data == data
        assert side.get("/seal/first.bin").data == small
        vids = {int(f.split(",")[0]) for f in side.fids("/seal/second.bin")}
        side.seal(vid, False)
        return put, vid not in vids, \
            side.metric("assign_lease_invalidate") - inv0 >= 1

    _both(sides, run)


def _watch_lines(master_url, n, timeout=10.0):
    conn = http.client.HTTPConnection(master_url, timeout=timeout)
    conn.request("GET", "/cluster/watch")
    r = conn.getresponse()
    return conn, r


def test_cluster_watch_snapshot_and_update(sides):
    def run(side):
        conn, r = _watch_lines(side.master_url, 2)
        try:
            snap = json.loads(r.readline())
            status, grown = phttp.get_json(
                f"http://{side.master_url}/vol/grow?count=1"
                f"&collection=watchc")
            vid = int(grown.get("volumeIds", grown.get("volume_ids",
                                                       [0]))[0]) \
                if "volumeIds" in grown or "volume_ids" in grown else None
            update = None
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                msg = json.loads(r.readline())
                if msg.get("type") == "update" and msg["new_vids"]:
                    update = msg
                    break
        finally:
            conn.close()
        return (snap["type"], sorted(snap) == ["leader", "ring", "type",
                                               "volumes"]
                or sorted(snap) == ["leader", "type", "volumes"],
                all(isinstance(v, list) for v in snap["volumes"].values()),
                update is not None and sorted(update) == [
                    "deleted_vids", "new_vids", "public_url", "type",
                    "url"],
                vid is None or vid in update["new_vids"])

    assert _both(sides, run) == ("snapshot", True, True, True, True)


def test_cluster_watch_resync_on_overflow(sides):
    """A subscriber whose queue is full is dropped with a resync line
    after what it still holds (both packages' broadcaster)."""
    def run(side):
        async def drive():
            q = asyncio.Queue(maxsize=2)
            side.master._watchers.add(q)
            for vid in (101, 102, 103):
                side.master._broadcast_location(
                    {"url": "x:1", "public_url": "x:1", "new_vids": [vid],
                     "deleted_vids": []})
            out = []
            while not q.empty():
                out.append(q.get_nowait())
            return [m.get("type") for m in out], q in side.master._watchers

        return side.cluster.call(drive())

    assert _both(sides, run) == (["update", "resync"], False)


def test_follower_redirects_watch_to_leader():
    """/cluster/watch on a follower: a 307 to the leader, in both."""
    got = {}
    ref = Cluster(n_volume_servers=0, n_masters=3)
    try:
        got["reference"] = _follower_307(ref.masters, ref.wait_for_leader())
    finally:
        ref.shutdown()
    port = LocalCluster(0, coder_name="numpy", n_masters=3,
                        master_kwargs={"election_timeout": (0.15, 0.3),
                                       "raft_heartbeat": 0.05})
    try:
        got["port"] = _follower_307(port.masters, port.wait_for_leader())
    finally:
        port.shutdown()
    assert got["port"] == got["reference"] == (307, True)


def _follower_307(masters, leader):
    follower = next(m for m in masters if m is not leader)
    conn = http.client.HTTPConnection(follower.url, timeout=10)
    try:
        conn.request("GET", "/cluster/watch")
        r = conn.getresponse()
        return r.status, r.getheader("Location") == \
            f"http://{leader.url}/cluster/watch"
    finally:
        conn.close()


def test_chunk_deleted_on_sealed_volume(sides):
    """D15: a file deleted while its chunk's volume is sealed (a
    warm-down in progress): the volume answers the chunk's DELETE with
    409 in both packages. The port's deletion worker tries again and
    frees the chunk once the volume takes deletes; the reference's
    drops it, and the chunk stays readable on its volume for good."""
    data = random.Random(18).randbytes(500)

    def run(side):
        side.put("/d15/a.bin", data, "?collection=d15")
        fid = side.fids("/d15/a.bin")[0]
        vid = int(fid.split(",")[0])
        side.seal(vid)
        assert side.req("DELETE", "/d15/a.bin").status == 202
        time.sleep(1.0)
        sealed = side.fid_status(fid)
        side.seal(vid, False)
        deadline = time.monotonic() + 5
        while side.fid_status(fid) != 404 and time.monotonic() < deadline:
            time.sleep(0.1)
        return sealed, side.fid_status(fid)

    got = {pkg: run(side) for pkg, side in sides.items()}
    assert got["port"] == (200, 404)
    assert got["reference"] == (200, 200)


def test_chunk_failing_after_header_cuts_the_body(sides):
    """D16: the read's 200 and Content-Length go out before the chunks
    are fetched (as upstream's filer streams); then a chunk gone from
    its volume. The port closes the connection short of its length, as
    upstream's net/http does, so the client sees an incomplete body at
    once; the reference leaves the connection open and the client waits
    until its own read timeout."""
    data = random.Random(19).randbytes(3 * CHUNK)

    def run(side):
        side.put("/d16/a.bin", data)
        fids = side.fids("/d16/a.bin")
        urls = side.holders(int(fids[1].split(",")[0]))
        assert phttp.request("DELETE", f"http://{urls[0]}/{fids[1]}"
                             ).status in (200, 202)
        conn = http.client.HTTPConnection(side.fs.url, timeout=2)
        try:
            conn.request("GET", "/d16/a.bin")
            r = conn.getresponse()
            head = (r.status, r.getheader("Content-Length"))
            try:
                body = r.read()
                return head, "whole" if body == data else "wrong"
            except http.client.IncompleteRead as e:
                return head, ("short" if data.startswith(e.partial)
                              else "wrong")
            except TimeoutError:
                return head, "hangs"
        finally:
            conn.close()

    got = {pkg: run(side) for pkg, side in sides.items()}
    head = (200, str(3 * CHUNK))
    assert got["port"] == (head, "short")
    assert got["reference"] == (head, "hangs")
