"""``/__meta__/subscribe`` and ``Filer.apply_event`` between the packages.

A reference filer (tests/cluster_util.Cluster) and a port filer
(LocalCluster) each take the same namespace mutations through their meta
API: nested creates, an update, an overwrite, a move of a directory
across parents, a file delete and a recursive delete. Each one's
``/__meta__/subscribe`` stream, read from ``since=0``, replays through
the OTHER package's ``Filer.apply_event`` into a namespace equal, entry
for entry, to the source's store; the live tail delivers a mutation made
after the stream opened; ``since``, ``prefix`` and ``exclude_sig`` cut
the stream the same way in both; the port's persisted log replays after
a restart; an event's ``signatures`` keep a replay from looping back.
"""

import functools
import http.client
import json
import signal
import time

import pytest

from cluster_util import Cluster
from seaweedfs_torch.ec.geometry import Geometry
from seaweedfs_torch.filer.entry import new_file
from seaweedfs_torch.filer.filer import Filer as PFiler
from seaweedfs_torch.filer.filer import MetaEvent as PEvent
from seaweedfs_torch.filer.stores import MemoryStore as PMemory
from seaweedfs_torch.server import http as phttp
from seaweedfs_torch.server.local_cluster import LocalCluster
from seaweedfs_tpu.filer.filer import Filer as RFiler
from seaweedfs_tpu.filer.filer import MetaEvent as REvent
from seaweedfs_tpu.filer.stores import MemoryStore as RMemory

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


@pytest.fixture(scope="module")
def servers():
    ref = Cluster(n_volume_servers=1)
    port = LocalCluster(1, coder_name="numpy", geometry=TEST_GEOMETRY,
                        volume_size_limit_mb=1, pulse=0.15)
    out = {"reference": ref.add_filer(), "port": port.add_filer()}
    yield out
    port.shutdown()
    ref.shutdown()


def _post(url: str, route: str, body: dict) -> None:
    status, out = phttp.post_json(f"http://{url}/__meta__/{route}", body)
    assert status == 200, (route, body, status, out)


def _create(url: str, path: str, **extended) -> None:
    e = new_file(path)
    e.extended = dict(extended)
    _post(url, "create_entry", {"entry": json.loads(e.to_json())})


def mutate(url: str, root: str) -> None:
    """The namespace traffic both filers take."""
    for i in range(4):
        _create(url, f"{root}/a/d{i}/f{i}.txt", n=str(i))
    _create(url, f"{root}/b/keep.txt")
    e = new_file(f"{root}/a/d1/f1.txt")
    e.extended = {"n": "updated"}
    _post(url, "update_entry", {"entry": json.loads(e.to_json())})
    _create(url, f"{root}/a/d2/f2.txt", n="overwritten")
    _post(url, "rename", {"from": f"{root}/a/d3", "to": f"{root}/b/d3"})
    _post(url, "delete", {"path": f"{root}/a/d0/f0.txt"})
    _post(url, "delete", {"path": f"{root}/a/d2", "recursive": True})


def stream(url: str, n: int, timeout: float = 10.0, **params) -> list:
    """The first n lines of url's subscribe stream, as dicts."""
    host, port = url.split(":")
    qs = "&".join(f"{k}={v}" for k, v in params.items())
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request("GET", f"/__meta__/subscribe?{qs}")
        r = conn.getresponse()
        assert r.status == 200
        assert r.getheader("Content-Type").startswith(
            "application/x-ndjson")
        return [json.loads(r.readline()) for _ in range(n)]
    finally:
        conn.close()


def namespace(store, root: str = "/") -> dict:
    """path -> entry JSON of every entry under `root` in a store."""
    out = {}
    for e in store.list_directory_entries(root, limit=1 << 20):
        out[e.full_path] = json.loads(e.to_json())
        if e.is_directory:
            out.update(namespace(store, e.full_path))
    return out


def events_of(fs, root: str) -> int:
    return len(fs.filer.meta_log.events_since(0, root))


REPLAY = {"reference": (PFiler, PMemory, PEvent),
          "port": (RFiler, RMemory, REvent)}


@within(60)
@pytest.mark.parametrize("source", ["reference", "port"])
def test_stream_replays_in_the_other_package(servers, source):
    fs = servers[source]
    root = f"/sub_{source}"
    mutate(fs.url, root)
    n = events_of(fs, root)
    lines = stream(fs.url, n, since=0, prefix=root)
    assert [d["tsns"] for d in lines] == sorted(d["tsns"] for d in lines)
    filer_cls, store_cls, event_cls = REPLAY[source]
    replica = filer_cls(store_cls())
    for d in lines:
        assert replica.apply_event(event_cls.from_dict(d))
    want = namespace(fs.filer.store, root)
    got = namespace(replica.store, root)
    assert got == want
    assert f"{root}/b/d3/f3.txt" in got and f"{root}/a/d2" not in got
    assert got[f"{root}/a/d1/f1.txt"]["extended"] == {"n": "updated"}
    # a line of this stream is the source's own wire form, byte for byte
    e = fs.filer.meta_log.events_since(0, root)[0]
    assert json.loads(e.wire()) == lines[0]
    # the replayed events carry the replica's signature after the
    # source's: replayed back, the source skips them
    back = replica.meta_log.events_since(0, root)
    assert back and all(fs.filer.signature in ev.signatures and
                        replica.signature in ev.signatures for ev in back)
    assert not fs.filer.apply_event(back[0])


@within(60)
@pytest.mark.parametrize("source", ["reference", "port"])
def test_live_tail_since_prefix_and_exclude_sig(servers, source):
    fs = servers[source]
    root = f"/tail_{source}"
    _create(fs.url, f"{root}/x/one.txt")
    first = stream(fs.url, events_of(fs, root), since=0, prefix=root)
    since = first[-1]["tsns"]
    host, port = fs.url.split(":")
    subs = fs.filer.meta_log._subscribers
    n0 = len(subs)
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    try:
        conn.request("GET", f"/__meta__/subscribe?since={since}&prefix="
                     f"{root}/y")
        r = conn.getresponse()
        deadline = time.monotonic() + 10
        while len(subs) == n0:
            assert time.monotonic() < deadline, "the stream's subscriber"
            time.sleep(0.01)
        # made once the stream is live: its tail carries it, and nothing
        # outside the prefix
        _create(fs.url, f"{root}/x/two.txt")
        _create(fs.url, f"{root}/y/three.txt")
        d = json.loads(r.readline())
    finally:
        conn.close()
    assert d["new"]["path"] in (f"{root}/y", f"{root}/y/three.txt")
    # since= resumes after an offset; exclude_sig= drops what another
    # filer signed
    rest = stream(fs.url, 1, since=since, prefix=f"{root}/x")
    assert rest[0]["new"]["path"] == f"{root}/x/two.txt"
    sig = fs.filer.signature
    e = new_file(f"{root}/x/foreign.txt")
    _post(fs.url, "create_entry", {"entry": json.loads(e.to_json()),
                                   "signatures": [424242]})
    only = stream(fs.url, 1, since=since, prefix=f"{root}/x",
                  exclude_sig=424242)
    assert only[0]["new"]["path"] == f"{root}/x/two.txt"
    assert all(sig in x["signatures"] for x in first)


@within(60)
def test_port_persisted_log_replays_after_restart(tmp_path):
    cl = LocalCluster(1, coder_name="numpy", geometry=TEST_GEOMETRY,
                      volume_size_limit_mb=1, pulse=0.15)
    try:
        fs = cl.add_filer("sqlite", store_kwargs={
            "path": str(tmp_path / "f.db")},
            meta_log_path=str(tmp_path / "events.jsonl"))
        for i in range(3):
            _create(fs.url, f"/p/f{i}.txt")
        n = events_of(fs, "/")
        fs = cl.restart_filer(fs)
        assert events_of(fs, "/") == 0          # the memory tail is new
        lines = stream(fs.url, n, since=0)
        replica = RFiler(RMemory())
        for d in lines:
            replica.apply_event(REvent.from_dict(d))
        assert namespace(replica.store) == namespace(fs.filer.store)
    finally:
        cl.shutdown()


def test_meta_log_subscribers():
    f = PFiler(PMemory())
    seen = []
    f.meta_log.subscribe(seen.append)
    f.create_entry(new_file("/s/a.txt"))
    assert [e.new_entry.full_path for e in seen] == ["/s", "/s/a.txt"]
    f.meta_log.unsubscribe(seen.append)
    f.delete_entry("/s/a.txt")
    assert len(seen) == 2
    # ensure_parents=False leaves the ancestors to the caller (the ring)
    f.create_entry(new_file("/t/u/v.txt"), ensure_parents=False)
    assert f.find_entry("/t/u") is None
    assert f.find_entry("/t/u/v.txt") is not None
