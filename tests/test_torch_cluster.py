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
    clusters (apart from ports, timestamps, cookies, and /dir/status's
    metalog and ring, which belong to planes the port leaves out), and a
    multipart POST stores the same needle fields;
(d) the four planners, (e) the topology and (f) the sequencer against
    the reference's; (g) the multipart parser; (h) the CLI as processes.

Also: the port's DELETE checks the cookie where the reference's does not
(ROADMAP Queue 3), "auto" without a card fails the encode with an HTTP
error and writes no shard, and a replication the port cannot honour is
refused. Every server binds port 0 and every test that runs servers has
its own deadline.
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
from seaweedfs_torch.client import Client as PClient
from seaweedfs_torch.client import ClientError as PClientError
from seaweedfs_torch.ec import geometry as pgeo
from seaweedfs_torch.server import http
from seaweedfs_torch.server.local_cluster import LocalCluster
from seaweedfs_torch.server.master import run_master
from seaweedfs_torch.shell import commands as pcommands
from seaweedfs_torch.shell import ec_commands as pec
from seaweedfs_torch.storage.file_id import FileId
from seaweedfs_torch.topology import sequence as pseq
from seaweedfs_torch.topology import topology as ptopo
from seaweedfs_torch.utils import multipart as pmp
from seaweedfs_tpu.client import Client as RClient
from seaweedfs_tpu.shell import ec_commands as rec
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
    cl = _cluster(3, coder)
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


@within(120)
def test_reference_client_drives_port_cluster():
    cl = _cluster(3)
    try:
        client = RClient(cl.master_url)
        _encode_read_rebuild(client, rec.EcCommands(client, TEST_GEOMETRY),
                             "wire")
    finally:
        cl.shutdown()


@within(120)
def test_port_client_drives_reference_cluster():
    ref = Cluster(n_volume_servers=3, pulse=PULSE)
    try:
        # the shell's rebuild, not the master's repair daemon
        for m in ref.masters:
            m.repair_enabled = False
        client = PClient(ref.master_url)
        _encode_read_rebuild(client, pec.EcCommands(client, PG), "wire")
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


class _Normal:
    """Answers with each cluster's own addresses, cookies and times
    replaced by placeholders."""

    def __init__(self, urls: dict):
        self.urls = urls

    def value(self, v):
        if isinstance(v, dict):
            return {self.value(k): self.value(x) for k, x in v.items()
                    if k not in ("last_modified", "metalog", "ring")}
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
    port = _cluster(1)
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
    finally:
        ref.shutdown()
        port.shutdown()


@within(60)
def test_delete_checks_the_cookie():
    """Upstream's DeleteHandler refuses a wrong cookie; the reference
    deletes the needle anyway (ROADMAP Queue 3, D1). The port follows
    upstream."""
    ref = Cluster(n_volume_servers=1, pulse=PULSE)
    port = _cluster(1)
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
    cl = _cluster(2)
    try:
        client = PClient(cl.master_url)
        with pytest.raises(PClientError, match="cannot grow"):
            client.assign(replication="001")
        with pytest.raises(PClientError, match="not supported"):
            client.volume_admin(cl.url(0), "assign_volume",
                                {"volume_id": 40, "replication": "010"})
        assert all(not cl.store(i).find_volume(40) for i in range(2))
        assert client.dir_status()["max_volume_id"] <= 1
        # a replicated volume already on disk takes no write either
        cl.store(0).add_volume(41, replica_placement="001")
        with pytest.raises(PClientError, match="HTTP 409"):
            client.upload_blob(cl.url(0), "41,01deadbeef", b"one copy")
        assert cl.store(0).find_volume(41).file_count() == 0
    finally:
        cl.shutdown()


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
        port = cl.master_server.port
        cl.master.stop()
        cl.master_server.shutdown()
        cl.master, cl.master_server = run_master(
            "127.0.0.1", port, volume_size_limit_mb=1, pulse_seconds=PULSE)
        cl.wait_for_nodes(1)
        a = client.assign()
        assert FileId.parse(a["fid"]).key > max(keys)
        client.upload_blob(a["url"], a["fid"], b"after the restart")
        assert client.download(a["fid"]) == b"after the restart"
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
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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
                           "-volumeSizeLimitMB", "4"],
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


def test_shell_registry():
    pcommands._register_all()
    assert set(pcommands.COMMANDS) == {"ec.encode", "ec.rebuild",
                                       "ec.balance", "ec.decode",
                                       "volume.list"}


# --- the HTTP layer --------------------------------------------------------

@within(60)
def test_http_layer(tmp_path, monkeypatch):
    """Keep-alive, HEAD, 404/405, a chunked request body, 413 on a body
    over the cap whether sent with a length or in chunks, a file streamed
    from its descriptor, and a shutdown that closes kept connections."""
    big = tmp_path / "big.bin"
    big.write_bytes(os.urandom(3 * 1024 * 1024 + 7))
    app = http.App()
    app.route("POST", "/echo", lambda req: http.Response(req.body))
    app.route("GET", "/file", lambda req: http.FileResponse(str(big)))
    app.route("GET", "/q", lambda req: http.json_response(req.query))
    server = http.serve(app)
    base = f"http://127.0.0.1:{server.port}"
    try:
        assert http.get_json(base + "/q?a=1&b=&a=2") == (200, {"a": "1",
                                                               "b": ""})
        r = http.request("POST", base + "/echo", b"x" * 70000)
        assert r.status == 200 and r.data == b"x" * 70000
        import http.client as hc
        conn = hc.HTTPConnection("127.0.0.1", server.port)
        conn.putrequest("POST", "/echo")
        conn.putheader("Transfer-Encoding", "chunked")
        conn.endheaders()
        conn.send(b"5\r\nhello\r\n6\r\n world\r\n0\r\n\r\n")
        assert conn.getresponse().read() == b"hello world"
        conn.close()
        assert http.request("HEAD", base + "/q").data == b""
        assert http.request("GET", base + "/nope").status == 404
        assert http.request("GET", base + "/echo").status == 405
        dst = tmp_path / "copy.bin"
        assert http.download_to(base + "/file", str(dst)) == 200
        assert dst.read_bytes() == big.read_bytes()
        monkeypatch.setattr(http, "MAX_BODY", 10)
        assert http.request("POST", base + "/echo", b"x" * 11).status == 413
        conn = hc.HTTPConnection("127.0.0.1", server.port)
        conn.putrequest("POST", "/echo")
        conn.putheader("Transfer-Encoding", "chunked")
        conn.endheaders()
        conn.send(b"6\r\nhello \r\n6\r\nworld!\r\n0\r\n\r\n")
        assert conn.getresponse().status == 413
        conn.close()
    finally:
        server.shutdown()
    with pytest.raises(OSError):
        http.request("GET", base + "/q")


def test_vid_cache_is_per_client():
    a, b = PClient("127.0.0.1:1"), PClient("127.0.0.1:1")
    a._vid_cache.put(3, ["x:1"])
    assert a._vid_cache.get(3) == ["x:1"] and b._vid_cache.get(3) is None
    a._vid_cache.clear()
    assert a._vid_cache.get(3) is None
