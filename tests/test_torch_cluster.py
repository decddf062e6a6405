"""The port's servers, EC shell and CLI against the reference's.

The port's master and volume servers run in this process
(``seaweedfs_torch.server.local_cluster.LocalCluster``), with the "numpy"
coder or the kernels' plain versions (``coder_name="torch",
device="cpu"``), at the shrunk RS(10,4) geometry of tests/cluster_util.py
(64 KiB / 4 KiB blocks). Byte-exact everywhere:

(a) the EC lifecycle of tests/test_cluster_e2e.py redone against the
    port, its shard files equal to the reference Store's ec_generate on a
    copy of the sealed volume;
(b) wire compatibility both ways: the reference's Client and EcCommands
    drive the port's cluster, the port's drive the reference's;
(c) the same requests give the same answers, key for key, from both
    clusters (apart from ports, timestamps, cookies, the heat view's
    read rates, and /dir/status's metalog and ring, which belong to
    planes the port leaves out), and a multipart POST stores the same
    needle fields;
(d) the four planners, (e) the topology and (f) the sequencer against
    the reference's; (g) the multipart parser; (h) the CLI as processes.

Replicated volumes (``001``, one more copy on the same rack) take part
in (b) and (c): a write acknowledged by the primary reads back from each
holder, deletes and the vacuum (``/vol/vacuum`` and every
``/admin/vacuum/*`` step) answer alike, a fan-out that fails answers
alike, and each package's shell restores a lost copy with
``volume.fix.replication`` on the other's cluster.

Also: the port's DELETE checks the cookie where the reference's does not
(ROADMAP Queue 3, D1); the port refuses a write the master cannot place
on every copy and never vacuums a read-only volume, as upstream does and
the reference does not (D2, D3); "auto" without a card fails the encode
with an HTTP error and writes no shard; a placement no server set can
satisfy fails at growth. Every server binds port 0 and every test that
runs servers has its own deadline.
"""

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
from pathlib import Path

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cluster_util import TEST_GEOMETRY, Cluster
from seaweedfs_torch import faults as pfaults
from seaweedfs_torch.client import Client as PClient
from seaweedfs_torch.client import ClientError as PClientError
from seaweedfs_torch.ec import geometry as pgeo
from seaweedfs_torch.server import http
from seaweedfs_torch.server import volume_server as pvs
from seaweedfs_torch.server.local_cluster import LocalCluster
from seaweedfs_torch.shell import commands as pcommands
from seaweedfs_torch.shell import ec_commands as pec
from seaweedfs_torch.shell import volume_commands as pvc
from seaweedfs_torch.storage.file_id import FileId
from seaweedfs_torch.topology import sequence as pseq
from seaweedfs_torch.topology import topology as ptopo
from seaweedfs_torch.utils import multipart as pmp
from seaweedfs_tpu import faults as rfaults
from seaweedfs_tpu.client import Client as RClient
from seaweedfs_tpu.shell import commands as rcommands
from seaweedfs_tpu.shell import ec_commands as rec
from seaweedfs_tpu.shell import volume_commands as rvc
from seaweedfs_tpu.storage.store import Store as RStore
from seaweedfs_tpu.topology import sequence as rseq
from seaweedfs_tpu.topology import topology as rtopo
from seaweedfs_tpu.utils import fast_multipart as rmp

# the plain version runs at test sizes: one thread keeps this worker
# from crowding the others under pytest-xdist
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PG = pgeo.Geometry(10, 4, large_block_size=64 * 1024,
                   small_block_size=4 * 1024)
CODERS = {"numpy": {"coder_name": "numpy"},
          "torch_cpu": {"coder_name": "torch", "device": "cpu"}}
PULSE = 0.15


def within(seconds: int):
    """Fail the test with TimeoutError after `seconds` (SIGALRM on the
    test's own thread), so that no test can hold the run."""
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


def _cluster(n: int = 3, coder: str = "numpy", **kw) -> LocalCluster:
    return LocalCluster(n, geometry=PG, volume_size_limit_mb=1,
                        pulse=PULSE, **CODERS[coder], **kw)


# the shell's rebuild and fix, not the master's repair daemon (as the
# reference's clusters here set repair_enabled = False)
NO_REPAIR = {"master_kwargs": {"repair_enabled": False}}


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _fill(client, collection: str, n: int = 40, seed: int = 7):
    """Upload into one fresh volume of `collection` (the reference's
    ec_encode_setup); returns (vid, fid -> bytes)."""
    rng = random.Random(seed)
    first = client.upload(rng.randbytes(1000), collection=collection)
    vid = int(first.split(",")[0])
    fids = {}
    for _ in range(n):
        a = client.assign(collection=collection)
        if int(a["fid"].split(",")[0]) != vid:
            continue
        data = rng.randbytes(rng.randint(100, 20000))
        client.upload_blob(a["url"], a["fid"], data)
        fids[a["fid"]] = data
    assert fids
    return vid, fids


def _read_all(client, fids: dict) -> None:
    client._vid_cache.clear()
    for fid, data in fids.items():
        assert client.download(fid) == data, fid


def _holders(info: dict) -> dict:
    """url -> sorted shard ids, from a /col/lookup/ec answer."""
    out: dict = {}
    for sid, urls in info["shards"].items():
        for u in urls:
            out.setdefault(u, []).append(int(sid))
    return {u: sorted(s) for u, s in out.items()}


def _wait(cond, what: str, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.02)


# --- (a) the EC lifecycle -------------------------------------------------

@pytest.mark.parametrize("coder", sorted(CODERS))
@within(120)
def test_ec_lifecycle(coder, tmp_path):
    cl = _cluster(3, coder, **NO_REPAIR)
    try:
        client = PClient(cl.master_url)
        vid, fids = _fill(client, "ecdemo")
        shell = pec.EcCommands(client, PG)
        plan = shell.encode(vid, "ecdemo", apply=False)
        assert sum(len(s) for s in plan["plan"].values()) == 14
        # the sealed volume, copied for the reference's encode
        client.volume_admin(plan["source"], "volume/readonly",
                            {"volume_id": vid, "read_only": True})
        vol = cl.store(cl.index_of(plan["source"])).find_volume(vid)
        vol.sync()
        ref_dir = tmp_path / "ref"
        ref_dir.mkdir()
        for ext in (".dat", ".idx", ".swm"):
            shutil.copyfile(vol.base_file_name() + ext,
                            ref_dir / f"ecdemo_{vid}{ext}")

        shell.encode(vid, "ecdemo")
        info = client.ec_lookup(vid)
        assert len(info["shards"]) == 14
        holders = _holders(info)
        assert len(holders) == 3
        assert sorted(map(len, holders.values())) == [4, 5, 5]
        assert all(cl.store(i).find_volume(vid) is None for i in range(3))
        status = client.cluster_status()
        assert status["is_leader"] and len(status["topology"]["nodes"]) == 3

        # every shard file, .ecx and .ecm equal the reference's
        rs = RStore([str(ref_dir)], coder_name="numpy",
                    geometry=TEST_GEOMETRY)
        assert rs.ec_generate(vid) == list(range(14))
        rs.close()
        ref_base = str(ref_dir / f"ecdemo_{vid}")
        for url, sids in holders.items():
            base = os.path.join(cl.nodes[cl.index_of(url)][3],
                                f"ecdemo_{vid}")
            for sid in sids:
                assert _sha(base + pgeo.to_ext(sid)) == \
                    _sha(ref_base + pgeo.to_ext(sid)), (url, sid)
            assert _sha(base + ".ecx") == _sha(ref_base + ".ecx")
            with open(base + ".ecm") as fp, open(ref_base + ".ecm") as fr:
                assert json.load(fp) == json.load(fr)

        _read_all(client, fids)
        # a server lost: the one with 4 shards (RS(10,4) survives it)
        lost_url = next(u for u, s in holders.items() if len(s) == 4)
        cl.stop_volume_server(cl.index_of(lost_url))
        _wait(lambda: lost_url not in _holders(client.ec_lookup(vid)),
              "the master prunes the stopped server")
        _read_all(client, fids)

        rb = shell.rebuild(vid, "ecdemo")
        assert sorted(rb["rebuilt"]) == holders[lost_url]
        assert len(client.ec_lookup(vid)["shards"]) == 14
        rb_base = os.path.join(cl.nodes[cl.index_of(rb["rebuilder"])][3],
                               f"ecdemo_{vid}")
        for sid in rb["rebuilt"]:
            assert _sha(rb_base + pgeo.to_ext(sid)) == \
                _sha(ref_base + pgeo.to_ext(sid))
        _read_all(client, fids)

        shell.decode(vid, "ecdemo")
        assert client.ec_lookup(vid) == {"error": "ec volume not found"}
        _read_all(client, fids)
    finally:
        cl.shutdown()


# --- (b) wire compatibility, both ways -----------------------------------

def _encode_read_rebuild(client, shell, collection: str) -> None:
    """Encode one volume, read, lose two shards of one holder, read
    degraded, rebuild, read: through whichever package's client and
    shell, against whichever package's cluster."""
    vid, fids = _fill(client, collection, n=30, seed=3)
    shell.encode(vid, collection)
    assert len(client.ec_lookup(vid)["shards"]) == 14
    _read_all(client, fids)
    holders = _holders(client.ec_lookup(vid))
    url, sids = next(iter(sorted(holders.items())))
    client.volume_admin(url, "ec/delete_shards",
                        {"volume_id": vid, "collection": collection,
                         "shard_ids": sids[:2]})
    _read_all(client, fids)
    rb = shell.rebuild(vid, collection)
    assert sorted(rb["rebuilt"]) == sids[:2]
    assert len(client.ec_lookup(vid)["shards"]) == 14
    _read_all(client, fids)


def _holder_reads(fids: dict, holders) -> None:
    """Every blob read back from each holder named."""
    for fid, data in fids.items():
        for url in holders:
            r = http.request("GET", f"http://{url}/{fid}")
            assert (r.status, r.data) == (200, data), (fid, url)


def _nodes_listed(master: str) -> set:
    return {n["url"] for n in
            http.get_json(f"http://{master}/dir/status")[1]["nodes"]}


def _replicate_and_fix(client, run_shell, master: str, stop, add) -> None:
    """Upload to a 001 collection and read each blob from both holders;
    lose one holder, start a fresh server, restore the copy with the
    shell's volume.fix.replication and read every blob from it."""
    rng = random.Random(11)
    fids = {}
    for _ in range(12):
        data = rng.randbytes(rng.randint(100, 20000))
        fids[client.upload(data, collection="rep",
                           replication="001")] = data
    vids = {int(f.split(",")[0]) for f in fids}
    assert len(vids) == 1
    vid = vids.pop()
    holders = client.lookup(vid)
    assert len(holders) == 2
    _holder_reads(fids, holders)
    stop(holders[1])
    new = add()
    _wait(lambda: holders[1] not in _nodes_listed(master)
          and new in _nodes_listed(master),
          "the master to prune the lost holder and list the new server")
    out = run_shell(["volume.fix.replication", "-force"])
    added = [a for a in out["plan"] if a["volume_id"] == vid]
    assert out["applied"] and [a["action"] for a in added] == ["add"]
    client._vid_cache.clear()
    assert sorted(client.lookup(vid)) == sorted([holders[0],
                                                 added[0]["to"]])
    _holder_reads(fids, [added[0]["to"]])


@within(120)
def test_reference_client_drives_port_cluster():
    cl = _cluster(3, **NO_REPAIR)
    try:
        client = RClient(cl.master_url)
        _encode_read_rebuild(client, rec.EcCommands(client, TEST_GEOMETRY),
                             "wire")
        rcommands._register_all()
        env = rcommands.CommandEnv(client, TEST_GEOMETRY)
        _replicate_and_fix(
            client, lambda argv: rcommands.run_command(env, argv),
            cl.master_url, lambda url: cl.stop_volume_server(
                cl.index_of(url)), cl.add_volume_server)
    finally:
        cl.shutdown()


@within(120)
def test_port_client_drives_reference_cluster():
    ref = Cluster(n_volume_servers=3, pulse=PULSE)
    try:
        # the shell's rebuild and fix, not the master's repair daemon
        for m in ref.masters:
            m.repair_enabled = False
        client = PClient(ref.master_url)
        _encode_read_rebuild(client, pec.EcCommands(client, PG), "wire")
        pcommands._register_all()
        env = pcommands.CommandEnv(client, PG)

        def stop(url: str) -> None:
            ref.stop_volume_server(next(
                i for i, v in enumerate(ref.volume_servers) if v.url == url))

        _replicate_and_fix(
            client, lambda argv: pcommands.run_command(env, argv),
            f"127.0.0.1:{ref.master_port}", stop,
            lambda: ref.add_volume_server(rack="rack0").url)
    finally:
        ref.shutdown()


# --- (c) the same requests, the same answers -----------------------------

def _multipart(data: bytes, name: str = "file",
               ctype: str = "application/octet-stream",
               extra: str = "") -> tuple[bytes, dict]:
    b = "b0undary"
    head = (f'--{b}\r\nContent-Disposition: form-data; name="file"; '
            f'filename="{name}"\r\nContent-Type: {ctype}\r\n{extra}\r\n')
    return (head.encode() + data + f"\r\n--{b}--\r\n".encode(),
            {"Content-Type": f"multipart/form-data; boundary={b}"})


# one cookie for both clusters' writes, so the ETags and bodies compare
COOKIE = "deadbeef"
VOLUME_REQUESTS = [
    ("POST", "/1,01" + COOKIE, *_multipart(b"hello world " * 50, "a.txt",
                                           "text/plain")),
    ("POST", "/1,02" + COOKIE, *_multipart(b"\x89PNG" + bytes(300),
                                           "p.png", "image/png")),
    ("POST", "/1,03" + COOKIE + "?ttl=5m", *_multipart(b"ttl data")),
    ("POST", "/1,04" + COOKIE, b"raw body bytes",
     {"Content-Type": "application/octet-stream"}),
    # a base64 part: the parse falls back to email.parser on both sides
    ("POST", "/1,05" + COOKIE,
     *_multipart(b"aGVsbG8gYmFzZTY0", "b.bin",
                 extra="Content-Transfer-Encoding: base64\r\n")),
    ("POST", "/1,06" + COOKIE, b"",
     {"Content-Type": "multipart/form-data; boundary=zz"}),
    ("POST", "/99,07" + COOKIE, *_multipart(b"no such volume")),
    ("GET", "/1,01" + COOKIE, None, None),
    ("GET", "/1,01" + COOKIE, None, {"Accept-Encoding": "gzip"}),
    ("HEAD", "/1,01" + COOKIE, None, None),
    ("GET", "/1,02" + COOKIE, None, {"Range": "bytes=1-10"}),
    ("GET", "/1,02" + COOKIE, None, {"Range": "bytes=-5"}),
    ("GET", "/1,02" + COOKIE, None, {"Range": "bytes=9999-"}),
    ("GET", "/1,03" + COOKIE, None, None),
    ("GET", "/1,04" + COOKIE, None, None),
    ("GET", "/1,05" + COOKIE, None, None),
    ("GET", "/1,01deadbee0", None, None),          # a bad cookie
    ("GET", "/1,09" + COOKIE, None, None),         # a missing needle
    ("GET", "/1,zz", None, None),
    ("GET", "/nofid", None, None),
    ("DELETE", "/1,04" + COOKIE, None, None),
    ("GET", "/1,04" + COOKIE, None, None),         # a deleted needle
    ("DELETE", "/1,04" + COOKIE, None, None),
    ("DELETE", "/1,77" + COOKIE, None, None),
]
MASTER_REQUESTS = [
    "/dir/lookup?volumeId=1", "/dir/lookup?volumeId=x",
    "/dir/lookup?fileId=1,01" + COOKIE, "/dir/lookup?fileId=1",
    "/dir/lookup?volumeId=99", "/col/lookup/ec?volumeId=1",
    "/col/lookup/ec?volumeId=zz", "/vol/grow?count=0",
    "/dir/assign?count=0", "/dir/assign?count=x", "/vol/list",
    "/dir/status", "/nope",
]


# the heat view's clock readings, and the read rate its drains' timing sets
HEAT_CLOCK = ("now", "first_seen", "idle_s", "last_access", "read_rate")
# the lifecycle config's knobs of the reference's S3 pass, which waits
# for a filer in the port
S3_KNOBS = ("day_seconds", "scan_limit")


class _Normal:
    """Answers with each cluster's own addresses, cookies and times
    replaced by placeholders."""

    def __init__(self, urls: dict):
        self.urls = urls

    def value(self, v):
        if isinstance(v, dict):
            return {self.value(k): self.value(x) for k, x in v.items()
                    if k not in ("last_modified", "metalog", "ring")
                    + HEAT_CLOCK + S3_KNOBS}
        if isinstance(v, list):
            return [self.value(x) for x in v]
        if isinstance(v, str):
            for url, name in self.urls.items():
                v = v.replace(url, name)
        return v

    def answer(self, r) -> tuple:
        headers = {k: v for k, v in r.headers.items()
                   if k not in ("Date", "Server", "X-Last-Modified")}
        try:
            body = self.value(json.loads(r.data))
        except ValueError:
            body = r.data
        else:
            # a JSON body's length depends on the placeholders' values:
            # the header must be the body's true length, and the bodies
            # are compared as JSON
            assert int(headers.pop("Content-Length")) == len(r.data)
        if isinstance(body, dict) and "fid" in body:
            # same volume and key, each master's own random cookie
            body["fid"] = body["fid"][:-8]
        return r.status, self.value(headers), body


def _ask(base: str, norm: _Normal, method: str, path: str, body=None,
         headers=None) -> tuple:
    return norm.answer(http.request(method, f"http://{base}{path}", body,
                                    headers))


def _settle(master: str, node: str) -> None:
    """Until the master's view of the node's volumes is the node's own:
    a DELETE sends no heartbeat, so the counts reach the master only
    with the node's next periodic beat."""
    def current() -> bool:
        want = http.get_json(f"http://{node}/status")[1]["volumes"]
        listed = http.get_json(f"http://{master}/vol/list")[1]["nodes"]
        return [v for n in listed for v in n["volumes"]] == want

    _wait(current, f"{master} to see {node}'s volumes")


@within(120)
def test_same_requests_same_answers():
    ref = Cluster(n_volume_servers=1, pulse=PULSE)
    port = _cluster(1, racks=1, **NO_REPAIR)
    try:
        for m in ref.masters:
            m.repair_enabled = False
        rm, pm = f"127.0.0.1:{ref.master_port}", port.master_url
        rv, pv = ref.volume_servers[0].url, port.url(0)
        rn = _Normal({rm: "<master>", rv: "<node>"})
        pn = _Normal({pm: "<master>", pv: "<node>"})

        def both(method, path, body=None, headers=None, master=False):
            a = _ask(rm if master else rv, rn, method, path, body, headers)
            b = _ask(pm if master else pv, pn, method, path, body, headers)
            assert a == b, (method, path)
            return a

        for path in ("/dir/assign?collection=c1",
                     "/dir/assign?collection=c1&count=3",
                     "/vol/grow?count=1&collection=c2"):
            both("GET", path, master=True)
        for method, path, body, headers in VOLUME_REQUESTS:
            both(method, path, body, headers)
        etag = both("GET", "/1,02" + COOKIE)[1]["ETag"]
        assert both("GET", "/1,02" + COOKIE, None,
                    {"If-None-Match": etag})[0] == 304
        # the stored needle of a multipart POST: the same fields
        key = FileId.parse("1,01" + COOKIE).key
        rneedle = ref.volume_servers[0].store.read_needle(1, key)
        pneedle = port.store(0).read_needle(1, key)
        for field in ("cookie", "id", "size", "data", "flags",
                      "name", "mime", "pairs", "checksum"):
            assert getattr(rneedle, field) == getattr(pneedle, field), field
        assert str(rneedle.ttl) == str(pneedle.ttl)
        # last_modified is each write's wall-clock second
        assert abs(rneedle.last_modified - pneedle.last_modified) <= 2
        _settle(rm, rv)
        _settle(pm, pv)
        for path in MASTER_REQUESTS:
            both("GET", path, master=True)

        # the same volume encoded by each package's shell
        rec.EcCommands(RClient(rm), TEST_GEOMETRY).encode(1, "c1")
        pec.EcCommands(PClient(pm), PG).encode(1, "c1")
        _settle(rm, rv)
        _settle(pm, pv)
        for path in ("/col/lookup/ec?volumeId=1", "/dir/lookup?volumeId=1",
                     "/vol/list", "/dir/status"):
            both("GET", path, master=True)
        for path in ("/1,01" + COOKIE, "/1,02" + COOKIE, "/1,04" + COOKIE,
                     "/1,01deadbee0"):
            both("GET", path)
        both("DELETE", "/1,02" + COOKIE)
        both("GET", "/1,02" + COOKIE)
        both("DELETE", "/1,77" + COOKIE)
        # the lifecycle plane: no rule, so no daemon; the heat view once
        # the last requests' heartbeats have landed on both masters
        for path in ("/lifecycle/status", "/vol/heat?volumeId=x"):
            both("GET", path, master=True)
        for path in ("/vol/heat", "/vol/heat?volumeId=1"):
            _wait(lambda: _ask(rm, rn, "GET", path)
                  == _ask(pm, pn, "GET", path), f"{path} alike")
            heat = both("GET", path, master=True)[2]
        assert [(v["state"], v["reads"] > 0) for v in heat["volumes"]] \
            == [("warm", True)]
        for report in ({"volume_id": 1, "url": "x:1", "bad_shards": []},
                       {"volume_id": 1}, {"url": "x:1"},
                       {"volume_id": "x", "url": "x:1"}):
            both("POST", "/ec/scrub_report", json.dumps(report).encode(),
                 {"Content-Type": "application/json"}, master=True)

        # a 001 collection on a second server of the same rack: each
        # package's primary fans writes and deletes out, and the vacuum
        # compacts both copies
        ref.add_volume_server(rack="rack0")
        port.add_volume_server()
        ref.wait_for_nodes(2)
        port.wait_for_nodes(2)
        grown = both("GET", "/vol/grow?count=1&collection=r1"
                     "&replication=001", master=True)
        vid = grown[2]["volume_ids"][0]
        roles = {}
        for master, norm in ((rm, rn), (pm, pn)):
            # the primary is the holder allocated (and listed) first
            primary, replica = PClient(master).lookup(vid)
            roles[master] = {"primary": primary, "replica": replica}
            norm.urls = {master: "<master>", primary: "<primary>",
                         replica: "<replica>"}

        def on(role, method, path, body=None, headers=None):
            a = _ask(roles[rm][role], rn, method, path, body, headers)
            b = _ask(roles[pm][role], pn, method, path, body, headers)
            assert a == b, (role, method, path)
            return a

        for path in (f"/dir/lookup?volumeId={vid}",
                     "/dir/assign?collection=r1&replication=001"):
            both("GET", path, master=True)
        text, raw = f"/{vid},11" + COOKIE, f"/{vid},12" + COOKIE
        on("primary", "POST", text, *_multipart(b"replicated " * 40,
                                                "r.txt", "text/plain"))
        on("primary", "POST", raw, b"raw replicated bytes" * 30,
           {"Content-Type": "application/octet-stream"})
        for role in ("primary", "replica"):
            for path in (text, raw):
                on(role, "GET", path)
                on(role, "GET", path, None, {"Accept-Encoding": "gzip"})
            on(role, "HEAD", text)
        on("primary", "DELETE", raw)
        for role in ("primary", "replica"):
            on(role, "GET", raw)
            on(role, "GET", f"/admin/vacuum/check?volume_id={vid}")
        both("GET", "/vol/vacuum?garbageThreshold=0.01", master=True)
        vacuum = [("POST", "/admin/vacuum/compact", {"volume_id": vid}),
                  ("POST", "/admin/vacuum/compact", {"volume_id": vid}),
                  ("POST", "/admin/vacuum/commit", {"volume_id": vid}),
                  ("POST", "/admin/vacuum/commit", {"volume_id": vid}),
                  ("POST", "/admin/vacuum/cleanup", {"volume_id": vid}),
                  ("POST", "/admin/vacuum", {"volume_id": vid}),
                  ("POST", "/admin/vacuum/compact", {"volume_id": 99}),
                  ("POST", "/admin/vacuum/cleanup", {"volume_id": 99})]
        for role in ("primary", "replica"):
            on(role, "GET", f"/admin/vacuum/check?volume_id={vid}")
            on(role, "GET", text)
            on(role, "GET", raw)
            for method, path, body in vacuum:
                on(role, method, path, json.dumps(body).encode(),
                   {"Content-Type": "application/json"})
            on(role, "GET", "/admin/vacuum/check?volume_id=99")
            on(role, "GET", text)
        both("GET", f"/dir/lookup?volumeId={vid}", master=True)
    finally:
        ref.shutdown()
        port.shutdown()


@within(60)
def test_delete_checks_the_cookie():
    """Upstream's DeleteHandler refuses a wrong cookie; the reference
    deletes the needle anyway (ROADMAP Queue 3, D1). The port follows
    upstream."""
    ref = Cluster(n_volume_servers=1, pulse=PULSE)
    port = _cluster(1, **NO_REPAIR)
    try:
        for m in ref.masters:
            m.repair_enabled = False
        answers = []
        for master in (f"127.0.0.1:{ref.master_port}", port.master_url):
            a = http.get_json(f"http://{master}/dir/assign")[1]
            fid = FileId.parse(a["fid"])
            body, headers = _multipart(b"keep me")
            http.request("POST", f"http://{a['url']}/{fid}", body, headers)
            wrong = FileId(fid.volume_id, fid.key, fid.cookie ^ 1)
            r = http.request("DELETE", f"http://{a['url']}/{wrong}")
            still = http.request("GET", f"http://{a['url']}/{fid}").status
            answers.append((r.status, json.loads(r.data), still))
        status, body, still = answers[0]
        assert status == 200 and body["size"] > 0 and still == 404
        assert answers[1] == (
            400, {"error": "File Random Cookie does not match."}, 200)
        # the same on the port's EC path
        client = PClient(port.master_url)
        pec.EcCommands(client, PG).encode(fid.volume_id, "")
        r = http.request("DELETE", f"http://{port.url(0)}/{wrong}")
        assert r.status == 400
        # a delete propagated to a shard holder checks the cookie too
        r = http.request("DELETE",
                         f"http://{port.url(0)}/{wrong}?type=replicate")
        assert r.status == 400
        assert client.download(str(fid)) == b"keep me"
    finally:
        ref.shutdown()
        port.shutdown()


# --- refusals -------------------------------------------------------------

@within(60)
def test_auto_coder_without_a_card_fails_the_encode():
    """"auto" is the CUDA kernel coder: on a host without a card the
    generate step answers an HTTP error (the shell raises) and no shard
    is written; nothing runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cl = LocalCluster(3, coder_name="auto", geometry=PG,
                      volume_size_limit_mb=1, pulse=PULSE)
    try:
        client = PClient(cl.master_url)
        vid, fids = _fill(client, "nocard", n=5)
        with pytest.raises(PClientError, match="CUDA|card|cuda"):
            pec.EcCommands(client, PG).encode(vid, "nocard")
        for i in range(3):
            assert not [f for f in os.listdir(cl.nodes[i][3])
                        if ".ec" in f], i
        _read_all(client, fids)
    finally:
        cl.shutdown()


@within(60)
def test_unsupported_replication_is_refused():
    """What no server set can honour fails at growth: 010 on one rack,
    001 on one server. A 001 volume allocated by hand on a lone server
    takes no write: the port refuses it with 500 before storing, as
    upstream does; the reference stores and acknowledges it (ROADMAP
    Queue 3, D2)."""
    cl = _cluster(2, racks=1)
    try:
        client = PClient(cl.master_url)
        with pytest.raises(PClientError, match="cannot grow"):
            client.assign(replication="010")
        assert all(not cl.store(i).find_volume(1) for i in range(2))
        assert client.dir_status()["max_volume_id"] == 0
    finally:
        cl.shutdown()
    ref = Cluster(n_volume_servers=1, pulse=PULSE)
    cl = _cluster(1, **NO_REPAIR)
    try:
        for m in ref.masters:
            m.repair_enabled = False
        answers = []
        for master, url, store in (
                (f"127.0.0.1:{ref.master_port}",
                 ref.volume_servers[0].url, ref.volume_servers[0].store),
                (cl.master_url, cl.url(0), cl.store(0))):
            client = PClient(master)
            with pytest.raises(PClientError, match="cannot grow"):
                client.assign(replication="001")
            client.volume_admin(url, "assign_volume",
                                {"volume_id": 41, "replication": "001"})
            body, headers = _multipart(b"one copy")
            r = http.request("POST", f"http://{url}/41,01deadbeef", body,
                             headers)
            answers.append((r.status, store.find_volume(41).file_count()))
        assert answers == [(201, 1), (500, 0)]
    finally:
        ref.shutdown()
        cl.shutdown()


@pytest.mark.parametrize("action", ["error", "drop"])
@within(60)
def test_failed_fan_out_answers_alike(action):
    """The fault point volume.replicate armed in both packages: an
    error answers 500 and a drop 201, and either way the primary keeps
    the needle and the replica stores none, in both packages alike (the
    replica's store is read directly: a GET there would have the
    reference's read repair fetch the needle from the primary)."""
    ref = Cluster(n_volume_servers=0, pulse=PULSE)
    port = _cluster(2, racks=1, **NO_REPAIR)
    try:
        for m in ref.masters:
            m.repair_enabled = False
        for _ in range(2):
            ref.add_volume_server(rack="rack0")
        ref.wait_for_nodes(2)
        answers = []
        stores = {vs.url: vs.store for vs in ref.volume_servers}
        stores.update({port.url(i): port.store(i) for i in range(2)})
        for master, fmod in ((f"127.0.0.1:{ref.master_port}", rfaults),
                             (port.master_url, pfaults)):
            client = PClient(master)
            vid = client.grow(collection="f", replication="001")[
                "volume_ids"][0]
            primary, replica = client.lookup(vid)
            fmod.set_fault("volume.replicate", action, count=1)
            try:
                body, headers = _multipart(b"primary only")
                r = http.request("POST", f"http://{primary}/{vid},01"
                                 + COOKIE, body, headers)
            finally:
                fmod.clear("volume.replicate")
            answers.append((
                r.status, json.loads(r.data).get("error"),
                http.request("GET", f"http://{primary}/{vid},01"
                             + COOKIE).data,
                stores[primary].find_volume(vid).file_count(),
                stores[replica].find_volume(vid).file_count()))
        assert answers[0] == answers[1]
        assert answers[0] == ((500, "replication failed") if action ==
                              "error" else (201, None)) + (b"primary only",
                                                           1, 0)
    finally:
        ref.shutdown()
        port.shutdown()


@within(60)
def test_vacuum_skips_read_only_volumes():
    """A read-only volume over the threshold: the reference's /vol/vacuum
    compacts it, the port's skips it as upstream's vacuumOneVolumeLayout
    does (ROADMAP Queue 3, D3), and compacts it once it is writable."""
    ref = Cluster(n_volume_servers=1, pulse=PULSE)
    port = _cluster(1, **NO_REPAIR)
    try:
        for m in ref.masters:
            m.repair_enabled = False
        compacted = []
        for master, url in ((f"127.0.0.1:{ref.master_port}",
                             ref.volume_servers[0].url),
                            (port.master_url, port.url(0))):
            client = PClient(master)
            fids = [client.upload(b"v" * 500, collection="ro")
                    for _ in range(6)]
            vid = int(fids[0].split(",")[0])
            for fid in fids[:4]:
                client.delete(fid)
            for read_only in (True, False):
                client.volume_admin(url, "volume/readonly",
                                    {"volume_id": vid,
                                     "read_only": read_only})
                _settle(master, url)
                compacted.append(client.vacuum(0.1)["compacted"])
        assert compacted == [[1], [], [], [1]]
    finally:
        ref.shutdown()
        port.shutdown()


# --- (d) the planners ----------------------------------------------------

_topologies = st.lists(
    st.tuples(st.integers(0, 20),
              st.dictionaries(st.integers(1, 3),
                              st.lists(st.integers(0, 13), unique=True,
                                       min_size=1, max_size=14),
                              max_size=3)),
    max_size=6)


def _status(nodes: list) -> dict:
    return {"nodes": [
        {"url": f"10.0.0.{i}:8080", "free_slots": free,
         "ec_shards": [{"id": vid, "shard_ids": sids}
                       for vid, sids in sorted(shards.items())]}
        for i, (free, shards) in enumerate(nodes)]}


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("planner", ["collect", "spread", "rebuild",
                                     "balance"])
@settings(deadline=None, max_examples=40, database=None)
@given(nodes=_topologies, vid=st.integers(1, 3),
       total=st.sampled_from([6, 14, 24]))
def test_planners_match_reference(planner, nodes, vid, total):
    status = _status(nodes)
    r_nodes = rec.collect_ec_nodes(status)
    p_nodes = pec.collect_ec_nodes(status)
    if planner == "collect":
        assert [vars(n) for n in r_nodes] == [vars(n) for n in p_nodes]
    elif planner == "spread":
        assert rec.plan_shard_spread(r_nodes, total, "src:1") == \
            pec.plan_shard_spread(p_nodes, total, "src:1")
    elif planner == "rebuild":
        assert _outcome(lambda: rec.plan_rebuild(r_nodes, vid, total)) == \
            _outcome(lambda: pec.plan_rebuild(p_nodes, vid, total))
    else:
        assert rec.plan_balance(r_nodes, total) == \
            pec.plan_balance(p_nodes, total)
        assert [vars(n) for n in r_nodes] == [vars(n) for n in p_nodes]


_volume_topologies = st.lists(
    st.tuples(st.sampled_from(["rack0", "rack1"]), st.integers(1, 4),
              st.lists(st.tuples(st.integers(1, 6),
                                 st.sampled_from(["000", "001", "010"])),
                       max_size=4, unique_by=lambda v: v[0])),
    max_size=5)


def _within_placement(rp: str, racks: list) -> bool:
    """One data center: at most Y+1 racks, at most Z+1 copies a rack."""
    _, y, z = (int(c) for c in rp)
    per_rack = {r: racks.count(r) for r in racks}
    return len(per_rack) <= y + 1 and max(per_rack.values()) <= z + 1


@settings(deadline=None, max_examples=60, database=None)
@given(nodes=_volume_topologies)
def test_fix_replication_planner_matches_reference(nodes):
    """volume.fix.replication's planner on the same topologies: the same
    adds, removes and impossibles wherever the reference's adds keep each
    volume's placement. Where one does not (ROADMAP Queue 3, D4), the
    port acts on the same volumes in the same order, an add of one
    planner may be impossible in the other (the copies land elsewhere,
    so the free slots differ), and each of the port's adds keeps the
    placement."""
    status = [{"url": f"10.0.0.{i}:8080", "data_center": "dc1",
               "rack": rack, "max_volume_count": cap,
               "volumes": [{"id": vid, "replica_placement": rp,
                            "collection": "c"} for vid, rp in vols]}
              for i, (rack, cap, vols) in enumerate(nodes)]
    # one placement per volume, as the master keeps it
    placement: dict = {}
    for nd in status:
        for v in nd["volumes"]:
            v["replica_placement"] = placement.setdefault(
                v["id"], v["replica_placement"])
    rack_of = {nd["url"]: nd["rack"] for nd in status}
    held = {vid: [nd["rack"] for nd in status
                  if vid in {v["id"] for v in nd["volumes"]}]
            for vid in placement}

    def keeps(act: dict) -> bool:
        return _within_placement(placement[act["volume_id"]],
                                 held[act["volume_id"]]
                                 + [rack_of[act["to"]]])

    ours = pvc.plan_fix_replication(status)
    theirs = rvc.plan_fix_replication(status)
    if all(keeps(a) for a in theirs if a["action"] == "add"):
        assert ours == theirs
        return
    assert [(a["volume_id"], a["have"], a["want"]) for a in ours] == \
        [(a["volume_id"], a["have"], a["want"]) for a in theirs]
    for a, b in zip(ours, theirs):
        assert a["action"] == b["action"] or \
            {a["action"], b["action"]} == {"add", "impossible"}
        if a["action"] == "add" and _within_placement(
                placement[a["volume_id"]], held[a["volume_id"]]):
            assert keeps(a)


def test_fix_replication_keeps_the_placement():
    """On two racks, a lost 001 copy comes back on the holder's rack and
    a lost 010 copy on the other rack; with no server left on the
    holder's rack, the 001 add is impossible. The reference's planner
    puts the 001 copy on the other rack (ROADMAP Queue 3, D4)."""
    def node(i: int, rack: str, vols: list) -> dict:
        return {"url": f"10.0.0.{i}:8080", "data_center": "dc1",
                "rack": rack, "max_volume_count": 8,
                "volumes": [{"id": vid, "replica_placement": rp,
                             "collection": "c"} for vid, rp in vols]}

    status = [node(0, "rack0", [(1, "001"), (2, "010")]),
              node(1, "rack0", [(3, "000"), (4, "000")]),
              node(2, "rack1", [])]
    plan = pvc.plan_fix_replication(status)
    assert [(a["volume_id"], a["action"], a["to"]) for a in plan] == [
        (1, "add", "10.0.0.1:8080"), (2, "add", "10.0.0.2:8080")]
    assert rvc.plan_fix_replication(status)[0]["to"] == "10.0.0.2:8080"
    assert pvc.plan_fix_replication(status[:1] + status[2:])[0][
        "action"] == "impossible"


# --- (e) the topology ----------------------------------------------------

_events = st.lists(st.one_of(
    st.tuples(st.just("hb"), st.integers(0, 3),
              st.lists(st.tuples(st.integers(1, 6),
                                 st.sampled_from(["", "c1"]),
                                 st.integers(0, 2000), st.booleans()),
                       max_size=4),
              st.lists(st.tuples(st.integers(7, 9),
                                 st.lists(st.integers(0, 13), unique=True,
                                          min_size=1)), max_size=2)),
    st.tuples(st.just("tick"), st.floats(0.1, 4.0)),
    st.tuples(st.just("prune")),
    st.tuples(st.just("pick"), st.sampled_from(["", "c1"]),
              st.integers(0, 1000)),
    st.tuples(st.just("slots"), st.sampled_from(["000", "001", "010"]),
              st.integers(0, 1000))), max_size=25)


def _node_ids(nodes) -> list:
    return [n.id for n in nodes]


@settings(deadline=None, max_examples=40, database=None)
@given(events=_events)
def test_topology_matches_reference(events):
    now = [1000.0]
    clock = lambda: now[0]  # noqa: E731
    r = rtopo.Topology(volume_size_limit=1000, pulse_seconds=1.0,
                       clock=clock)
    p = ptopo.Topology(volume_size_limit=1000, pulse_seconds=1.0,
                       clock=clock)
    for ev in events:
        if ev[0] == "hb":
            _, i, vols, ecs = ev
            payload = {
                "volumes": [{"id": vid, "collection": c, "size": size,
                             "read_only": ro} for vid, c, size, ro in vols],
                "ec_shards": [{"id": vid, "shard_ids": sids}
                              for vid, sids in ecs]}
            args = (f"n{i}", f"10.0.0.{i}:80", "", "dc1", f"rack{i % 2}",
                    8, payload)
            assert r.register_heartbeat(*args) == \
                p.register_heartbeat(*args)
        elif ev[0] == "tick":
            now[0] += ev[1]
        elif ev[0] == "prune":
            assert r.prune_dead_nodes() == p.prune_dead_nodes()
        elif ev[0] == "pick":
            random.seed(ev[2])
            a = r.pick_for_write(ev[1], "000", "")
            random.seed(ev[2])
            b = p.pick_for_write(ev[1], "000", "")
            assert (a and (a[0], _node_ids(a[1]))) == \
                (b and (b[0], _node_ids(b[1])))
        else:
            random.seed(ev[2])
            a = _node_ids(r.find_empty_slots(ev[1]))
            random.seed(ev[2])
            assert a == _node_ids(p.find_empty_slots(ev[1]))
        assert r.to_dict() == p.to_dict()
        assert r.lookup_ec_shards(8).keys() == p.lookup_ec_shards(8).keys()


def test_replication_change_moves_the_layout():
    """A volume re-reported under another replica placement (after
    volume.configure.replication) and then gone: the reference's
    topology goes on listing the node in the old layout, the port's does
    not (ROADMAP Queue 3, F2). Everything else the two answer alike."""
    lookups = []
    for mod in (rtopo, ptopo):
        topo = mod.Topology(volume_size_limit=1000, pulse_seconds=1.0)
        for rp, vols in (("000", [5]), ("001", [5]), ("001", [])):
            topo.register_heartbeat(
                "n0", "10.0.0.0:80", "", "dc1", "rack0", 8,
                {"volumes": [{"id": v, "collection": "c",
                              "replica_placement": rp} for v in vols]})
        lookups.append([n.url for n in topo.lookup(5)])
    assert lookups == [["10.0.0.0:80"], []]


# --- (f) the sequencer ---------------------------------------------------

@settings(deadline=None, max_examples=40, database=None)
@given(ops=st.lists(st.tuples(st.sampled_from(["next", "max"]),
                              st.integers(1, 500)), max_size=30))
def test_sequencer_matches_reference(ops):
    r, p = rseq.MemorySequencer(), pseq.MemorySequencer()
    for op, n in ops:
        if op == "next":
            assert r.next_file_id(n) == p.next_file_id(n)
        else:
            r.set_max(n)
            p.set_max(n)
        assert r.peek() == p.peek()


@within(60)
def test_restarted_master_never_remints_a_key():
    """A master restarted on the same address learns the volumes' largest
    key from their heartbeats and assigns above it."""
    cl = _cluster(1)
    try:
        client = PClient(cl.master_url)
        keys = [FileId.parse(client.upload(b"x" * 100)).key
                for _ in range(12)]
        assert keys == sorted(keys)
        port = int(cl.master_url.rsplit(":", 1)[1])
        cl.stop_master()
        cl.start_master(port, volume_size_limit_mb=1, pulse_seconds=PULSE)
        cl.wait_for_nodes(1)
        a = client.assign()
        assert FileId.parse(a["fid"]).key > max(keys)
        client.upload_blob(a["url"], a["fid"], b"after the restart")
        assert client.download(a["fid"]) == b"after the restart"
    finally:
        cl.shutdown()


@pytest.mark.parametrize("package", ["reference", "port"])
@within(60)
def test_volume_commands_drive_port_cluster(package):
    """Each package's volume.configure.replication, volume.mark,
    volume.copy and volume.delete on the port's cluster."""
    cl = _cluster(3, racks=1, **NO_REPAIR)
    try:
        client = PClient(cl.master_url)
        if package == "port":
            pcommands._register_all()
            env = pcommands.CommandEnv(client, PG)
            run = functools.partial(pcommands.run_command, env)
        else:
            rcommands._register_all()
            env = rcommands.CommandEnv(RClient(cl.master_url),
                                       TEST_GEOMETRY)
            run = functools.partial(rcommands.run_command, env)
        fid = client.upload(b"one copy", collection="vc")
        vid = int(fid.split(",")[0])
        src = client.lookup(vid)[0]
        dst = next(cl.url(i) for i in range(3) if cl.url(i) != src)
        out = run(["volume.configure.replication", "-volumeId", str(vid),
                   "-replication", "001"])
        assert out["configured"] == [src]
        vol = cl.store(cl.index_of(src)).find_volume(vid)
        assert str(vol.super_block.replica_placement) == "001"
        run(["volume.mark", "-volumeId", str(vid), "-node", src,
             "-readonly"])
        assert vol.read_only
        run(["volume.mark", "-volumeId", str(vid), "-node", src,
             "-writable"])
        assert not vol.read_only
        run(["volume.copy", "-volumeId", str(vid), "-from", src, "-to",
             dst, "-collection", "vc"])
        client._vid_cache.clear()
        assert sorted(client.lookup(vid)) == sorted([src, dst])
        _holder_reads({fid: b"one copy"}, [src, dst])
        # the copy carries the rewritten placement
        copy = cl.store(cl.index_of(dst)).find_volume(vid)
        assert str(copy.super_block.replica_placement) == "001"
        run(["volume.delete", "-volumeId", str(vid), "-node", src])
        client._vid_cache.clear()
        assert client.lookup(vid) == [dst]
        assert cl.store(cl.index_of(src)).find_volume(vid) is None
    finally:
        cl.shutdown()


@within(60)
def test_master_vacuums_on_its_own():
    """The master's periodic vacuum (every vacuum_interval_seconds, at
    garbage_threshold) compacts a volume over the threshold with no
    request."""
    cl = _cluster(1)
    try:
        client = PClient(cl.master_url)
        fids = [client.upload(b"w" * 700) for _ in range(8)]
        for fid in fids[:5]:
            client.delete(fid)
        vid = int(fids[0].split(",")[0])
        vol = cl.store(0).find_volume(vid)
        assert vol.garbage_level() > 0.5
        port = int(cl.master_url.rsplit(":", 1)[1])
        cl.stop_master()
        cl.start_master(port, volume_size_limit_mb=1, pulse_seconds=PULSE,
                        garbage_threshold=0.5, vacuum_interval_seconds=0.2)
        _wait(lambda: cl.store(0).find_volume(vid).garbage_level() == 0,
              "the periodic vacuum")
        assert cl.store(0).find_volume(vid).super_block \
            .compaction_revision == 1
        client._vid_cache.clear()
        for fid in fids[5:]:
            assert client.download(fid) == b"w" * 700
    finally:
        cl.shutdown()


@pytest.mark.parametrize("failure", ["holder_lost", "commit_refused"])
@within(60)
def test_failed_vacuum_cleans_up_every_holder(failure, monkeypatch):
    """A vacuum pass that fails midway leaves no holder compacting and
    no .cpd/.cpx behind. holder_lost: the second holder dies right after
    the first's compact, so the master's next POST raises. commit_refused:
    the first holder's volume turns read-only after its compact, so its
    commit is refused and the second holder is never asked to commit."""
    cl = _cluster(2, racks=1)
    try:
        client = PClient(cl.master_url)
        fids = [client.upload(b"r" * 700, collection="vf",
                              replication="001") for _ in range(8)]
        for fid in fids[:5]:
            client.delete(fid)
        vid = int(fids[0].split(",")[0])
        layout = next(lay for lay in cl.master.topology.layouts.values()
                      if vid in lay.locations)
        first, second = [n.url for n in layout.locations[vid]]
        store = cl.store(cl.index_of(first))
        compact = store.vacuum_compact

        def compact_then_fail(v: int) -> None:
            compact(v)
            if failure == "holder_lost":
                cl.stop_volume_server(cl.index_of(second))
            else:
                store.mark_readonly(v)

        monkeypatch.setattr(store, "vacuum_compact", compact_then_fail)
        assert client.vacuum(0.1)["compacted"] == []
        holders = [first] + ([] if failure == "holder_lost" else [second])
        for url in holders:
            i = cl.index_of(url)
            v = cl.store(i).find_volume(vid)
            assert not v._compacting
            assert v.super_block.compaction_revision == 0
            assert not [f for f in os.listdir(cl.nodes[i][3])
                        if f.endswith((".cpd", ".cpx"))]
        assert vid not in layout.vacuuming
        _holder_reads({fid: b"r" * 700 for fid in fids[5:]}, holders)
    finally:
        cl.shutdown()


# --- (g) multipart ---------------------------------------------------------

_BODIES = {
    "single": _multipart(b"payload\r\nwith crlf", "f.bin"),
    "quoted_mime": _multipart(b"{}", "x.json", "application/json"),
    "gzip_encoding": _multipart(b"\x1f\x8bdata", "g.gz",
                                extra="Content-Encoding: gzip\r\n"),
    "base64": _multipart(b"aGk=", "b.txt",
                         extra="Content-Transfer-Encoding: base64\r\n"),
    "two_parts": (b"--q\r\nContent-Disposition: form-data; name=\"a\"; "
                  b"filename=\"1\"\r\n\r\none\r\n--q\r\nContent-"
                  b"Disposition: form-data; name=\"b\"\r\n\r\ntwo\r\n"
                  b"--q--\r\n",
                  {"Content-Type": "multipart/form-data; boundary=q"}),
    "no_close": (b"--q\r\n\r\nunterminated",
                 {"Content-Type": "multipart/form-data; boundary=q"}),
    "no_boundary": (b"--q\r\n\r\nx\r\n--q--\r\n",
                    {"Content-Type": "multipart/form-data"}),
    "escaped_name": (b"--q\r\nContent-Disposition: form-data; name=\"f\"; "
                     b"filename=\"a\\\"b\"\r\n\r\nx\r\n--q--\r\n",
                     {"Content-Type": "multipart/form-data; boundary=q"}),
}


@pytest.mark.parametrize("case", sorted(_BODIES))
def test_multipart_matches_reference(case):
    body, headers = _BODIES[case]
    ct = headers["Content-Type"]
    fast = pmp.parse_single_part(body, ct)
    assert fast == rmp.parse_single_part(body, ct)
    part = pmp.parse_upload(body, ct)
    if fast is not None:
        assert part == fast
    else:
        assert part is None or isinstance(part, pmp.Part)


# --- (h) the CLI -----------------------------------------------------------

_CLI = ("import sys; sys.path.insert(0, %r); "
        "from seaweedfs_torch.cli import main; main()" % str(REPO))


def _free_port() -> int:
    """A free port whose gRPC twin (+10000) is free too: a CLI server
    binds both."""
    from seaweedfs_torch.server.http import free_port_with_grpc_twin
    return free_port_with_grpc_twin()


@within(120)
def test_cli_master_volume_shell(tmp_path):
    """`master` and `volume -coder numpy` as `python -I` processes, one
    `shell ec.encode`, a read of every needle with one shard deleted."""
    mport, vport = _free_port(), _free_port()
    blocks = ["-ec_large_block", "65536", "-ec_small_block", "4096"]
    cli = [sys.executable, "-I", "-c", _CLI]
    procs = [subprocess.Popen(cli + args, stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL)
             for args in (["master", "-port", str(mport), "-pulse", "0.2",
                           "-volumeSizeLimitMB", "4",
                           # reads with a shard deleted, not a rebuild
                           "-maintenance_interval", "0"],
                          ["volume", "-port", str(vport),
                           "-dir", str(tmp_path), "-pulse", "0.2",
                           "-mserver", f"127.0.0.1:{mport}",
                           "-coder", "numpy", *blocks])]
    try:
        client = PClient(f"127.0.0.1:{mport}")

        def up() -> bool:
            assert all(p.poll() is None for p in procs)
            try:
                return len(client.dir_status()["nodes"]) == 1
            except OSError:
                return False

        _wait(up, "the CLI cluster", timeout=60)
        vid, fids = _fill(client, "cli", n=12)
        out = subprocess.run(
            cli + ["shell", "-server", f"127.0.0.1:{mport}", *blocks,
                   "ec.encode", "-volumeId", str(vid), "-collection", "cli"],
            capture_output=True, text=True, timeout=60)
        assert out.returncode == 0, out.stderr
        plan = json.loads(out.stdout.strip().splitlines()[-1])
        assert plan["plan"] == {f"127.0.0.1:{vport}": list(range(14))}
        assert len(client.ec_lookup(vid)["shards"]) == 14
        client.volume_admin(f"127.0.0.1:{vport}", "ec/delete_shards",
                            {"volume_id": vid, "collection": "cli",
                             "shard_ids": [0]})
        assert len(client.ec_lookup(vid)["shards"]) == 13
        _read_all(client, fids)
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                assert p.wait(timeout=20) == 0
            except subprocess.TimeoutExpired:
                p.kill()
                raise


@pytest.mark.parametrize("command", ["webdav", "mount"])
def test_cli_lists_client_surfaces_with_the_reference_flags(command,
                                                             capsys):
    """`webdav` and `mount` are commands of the port's CLI; `-h` answers
    for each, with the reference's flags and defaults."""
    from seaweedfs_torch import cli as pcli
    from seaweedfs_tpu import cli as rcli

    def flags(parser) -> dict:
        sub = next(a for a in parser._actions
                   if a.__class__.__name__ == "_SubParsersAction")
        return {a.dest: (a.default, a.required)
                for a in sub.choices[command]._actions
                if a.dest != "help"}

    assert flags(pcli.build_parser()) == flags(rcli.build_parser())
    with pytest.raises(SystemExit) as e:
        pcli.main([command, "-h"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert f"seaweedfs-torch {command}" in out and "-filer" in out


def test_cli_compact_matches_reference(tmp_path, capsys):
    """`compact -dir -volumeId` on copies of one volume: the same answer
    and the same files from both packages' CLI."""
    import argparse

    from seaweedfs_torch import cli as pcli
    from seaweedfs_torch.storage.needle import Needle
    from seaweedfs_torch.storage.volume import Volume
    from seaweedfs_tpu import cli as rcli
    src = tmp_path / "src"
    src.mkdir()
    v = Volume(str(src), "", 4, create=True)
    for i in range(1, 30):
        v.write_needle(Needle(cookie=i, id=i, data=bytes([i]) * 300 * i,
                              append_at_ns=10 ** 18 + i),
                       preserve_append_at_ns=True)
    for i in range(1, 30, 3):
        v.delete_needle(Needle(cookie=i, id=i, append_at_ns=2 * 10 ** 18),
                        preserve_append_at_ns=True)
    v.close()
    answers = []
    for name in ("reference", "port"):
        d = tmp_path / name
        shutil.copytree(src, d)
        if name == "reference":
            rcli.cmd_compact(argparse.Namespace(dir=str(d), collection="",
                                                volumeId=4))
        else:
            pcli.main(["compact", "-dir", str(d), "-volumeId", "4"])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        answers.append((out, (d / "4.dat").read_bytes(),
                        (d / "4.idx").read_bytes()))
    assert answers[0] == answers[1]
    assert answers[1][0]["reclaimed"] > 0


def test_shell_registry():
    pcommands._register_all()
    assert set(pcommands.COMMANDS) == {
        "ec.encode", "ec.warmdown", "ec.rebuild", "ec.balance",
        "ec.decode", "ec.mesh.status", "volume.list",
        "volume.fix.replication",
        "volume.copy", "volume.delete", "volume.configure.replication",
        "volume.mark", "volume.heat", "lifecycle.status",
        "lifecycle.run", "cluster.balance.status", "cluster.balance.run",
        "volume.tier.upload", "volume.tier.download",
        "fs.pwd", "fs.cd", "fs.ls", "fs.du", "fs.cat", "fs.mv", "fs.rm",
        "fs.mkdir", "fs.tree", "fs.meta.cat", "fs.meta.save",
        "fs.meta.load", "filer.ring.status", "filer.ring.join",
        "filer.ring.leave", "bucket.list", "bucket.create",
        "bucket.delete", "collection.list", "collection.delete",
        "geo.status", "geo.sync"}


# --- the HTTP layer --------------------------------------------------------

@within(60)
def test_http_layer(tmp_path, monkeypatch):
    """The aiohttp apps: keep-alive, HEAD, 404/405, a chunked request
    body, 413 on a body over the cap whether sent with a length or in
    chunks, a file streamed to a pulling peer in chunks, and a shutdown
    that closes kept connections."""
    import http.client as hc
    cap = 64 * 1024
    monkeypatch.setattr(pvs, "MAX_BODY", cap)
    cl = _cluster(1)
    try:
        host, port = cl.url(0).split(":")
        conn = hc.HTTPConnection(host, int(port))
        for _ in range(2):
            conn.request("GET", "/healthz")
            r = conn.getresponse()
            assert (r.status, json.loads(r.read())) == (200, {"ok": True})

        def chunked(path: str, chunks: list) -> hc.HTTPResponse:
            conn.putrequest("POST", path)
            conn.putheader("Transfer-Encoding", "chunked")
            conn.putheader("Content-Type", "application/octet-stream")
            conn.endheaders()
            for c in chunks:
                conn.send(b"%x\r\n%s\r\n" % (len(c), c))
            conn.send(b"0\r\n\r\n")
            return conn.getresponse()

        fid = PClient(cl.master_url).assign()["fid"]
        r = chunked(f"/{fid}", [b"hello", b" world"])
        assert r.status == 201, r.read()
        r.read()
        base = f"http://{cl.url(0)}/{fid}"
        assert http.request("GET", base).data == b"hello world"
        r = http.request("HEAD", base)
        assert r.data == b"" and r.headers["Content-Length"] == "11"
        assert http.request("GET",
                            f"http://{cl.master_url}/nope").status == 404
        assert http.request(
            "GET", f"http://{cl.master_url}/heartbeat").status == 405
        assert http.request("POST", base, b"x" * (cap + 1)).status == 413
        r = chunked(f"/{fid}", [b"y" * 40000, b"z" * 40000])
        assert r.status == 413
        conn.close()
        # a file larger than one copy chunk, streamed
        big = os.urandom(3 * 1024 * 1024 + 7)
        with open(os.path.join(cl.nodes[0][3], "9.bin"), "wb") as f:
            f.write(big)
        r = http.request("GET", f"http://{cl.url(0)}/admin/file_copy"
                         "?volume_id=9&ext=.bin")
        assert r.status == 200 and r.data == big
        kept = hc.HTTPConnection(host, int(port))
        kept.request("GET", "/healthz")
        kept.getresponse().read()
    finally:
        cl.shutdown()
    with pytest.raises(OSError):
        kept.request("GET", "/healthz")
        kept.getresponse()
    with pytest.raises(OSError):
        http.request("GET", f"http://{host}:{port}/healthz")


def test_vid_cache_is_per_client():
    a, b = PClient("127.0.0.1:1"), PClient("127.0.0.1:1")
    a._vid_cache.put(3, ["x:1"])
    assert a._vid_cache.get(3) == ["x:1"] and b._vid_cache.get(3) is None
    a._vid_cache.clear()
    assert a._vid_cache.get(3) is None
