"""The port's notification/ and replication/ (and the filer server's
notifier and peer aggregation) against the reference's.

Three kinds of case, each on the same inputs in both packages
(parametrised by ``pkg``; the reference's live filers on
``cluster_util.Cluster``, the port's on ``LocalCluster``):

- the reference's cases of tests/test_meta_sync.py (the file queue
  spool, ``load_notifier``, the filer server's ``notifier=``, the local
  and GCS sinks, ``peers=`` aggregation, ``/__meta__/subscribe``
  replaying ``since``), tests/test_queue_replication.py (the file-queue
  input's consume, resume and torn tail, the replicator's durable offset
  and its exact retries of a poison event, a corrupt spool line skipped
  loudly) and tests/test_azure_sink.py (its seven cases);
- the queue and sink wire: one FileQueue spool written by each package's
  notifier is read alike by both packages' inputs, and each package's
  sinks put the same objects into the fakes;
- an end-to-end script: one seeded sequence of creates, overwrites,
  renames, deletes, mkdirs and versioned S3 PUTs on a source filer of
  each package, replicated by that package's ``Replicator`` into a second
  filer (``FilerSink``) and a directory (``LocalSink``). Each replica's
  namespace and bytes equal its source's; the two packages' replica
  namespaces, bytes and sink trees are equal entry by entry, with chunk
  fids and signatures aside and version ids replaced by their rank.

Every comparison is exact.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from types import SimpleNamespace

import pytest

from cluster_util import Cluster, free_port

PKGS = ("reference", "port")


def _mods(pkg: str) -> SimpleNamespace:
    if pkg == "reference":
        from seaweedfs_tpu import faults
        from seaweedfs_tpu.filer import entry, filer, stores
        from seaweedfs_tpu.filer.chunks import FileChunk
        from seaweedfs_tpu.notification import queues
        from seaweedfs_tpu.replication import (fake_azure, fake_gcs,
                                               replicator, sink, sub)
        from seaweedfs_tpu.utils import config, metrics
    else:
        from seaweedfs_torch import faults
        from seaweedfs_torch.filer import entry, filer, stores
        from seaweedfs_torch.filer.chunks import FileChunk
        from seaweedfs_torch.notification import queues
        from seaweedfs_torch.replication import (fake_azure, fake_gcs,
                                                 replicator, sink, sub)
        from seaweedfs_torch.utils import config, metrics
    return SimpleNamespace(
        pkg=pkg, faults=faults, entry=entry, Filer=filer.Filer,
        MetaEvent=filer.MetaEvent, MemoryStore=stores.MemoryStore,
        FileChunk=FileChunk, queues=queues, fake_azure=fake_azure,
        fake_gcs=fake_gcs, replicator=replicator, sink=sink, sub=sub,
        Configuration=config.Configuration, metrics=metrics)


@pytest.fixture(params=PKGS)
def m(request):
    return _mods(request.param)


def _event(m, path: str, tsns: int):
    return m.MetaEvent(tsns=tsns, directory=os.path.dirname(path),
                       old_entry=None,
                       new_entry=m.entry.new_file(
                           path, [m.FileChunk("1,ab", 0, 3)]))


# --- the live clusters, one per package ---

class Live:
    def __init__(self, pkg: str):
        self.pkg = pkg
        if pkg == "reference":
            self.cluster = Cluster(n_volume_servers=1)
        else:
            from seaweedfs_torch.server.local_cluster import LocalCluster
            self.cluster = LocalCluster(
                1, coder_name="torch", device="cpu", pulse=0.15,
                master_kwargs={"repair_enabled": False})
        self.filer = self.add_filer()

    def add_filer(self, **kw):
        if self.pkg == "reference":
            return self.cluster.add_filer(**kw)
        return self.cluster.add_filer("memory", 16 * 1024, **kw)

    def add_filer_server(self, **kw):
        """A filer with constructor options the test helpers lack."""
        if self.pkg == "reference":
            from seaweedfs_tpu.server.filer_server import FilerServer
            port = free_port()
            fs = FilerServer(self.cluster.master_url, store_name="memory",
                             chunk_size=16 * 1024, **kw)
            self.cluster.runners.append(self.cluster.serve(fs.app, port))
            fs.url = f"127.0.0.1:{port}"
            return fs
        return self.cluster.add_filer("memory", 16 * 1024, **kw)

    def add_s3(self, fs) -> str:
        if self.pkg == "reference":
            from seaweedfs_tpu.s3.s3_server import S3Server
            port = free_port()
            gw = S3Server(fs.url, url=f"127.0.0.1:{port}")
            self.cluster.serve(gw.app, port)
            return f"127.0.0.1:{port}"
        return self.cluster.add_s3(fs).url

    def shutdown(self):
        self.cluster.shutdown()


@pytest.fixture(scope="module", params=PKGS)
def live(request):
    lv = Live(request.param)
    lv.m = _mods(request.param)
    yield lv
    lv.shutdown()


@pytest.fixture(scope="module")
def live_filer(live):
    """The replicators' source filer (the reference's fixture of that
    name): the offset and poison cases share it, in that order."""
    return live.add_filer()


def _put(filer: str, path: str, data: bytes) -> None:
    req = urllib.request.Request(
        f"http://{filer}{urllib.parse.quote(path)}", data=data,
        method="PUT", headers={"Content-Type": "application/octet-stream"})
    urllib.request.urlopen(req, timeout=30).close()


def _get(filer: str, path: str):
    try:
        with urllib.request.urlopen(
                f"http://{filer}{urllib.parse.quote(path)}",
                timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, b""


def _post(filer: str, path: str, query: str) -> int:
    req = urllib.request.Request(
        f"http://{filer}{urllib.parse.quote(path)}?{query}", method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status


def _delete(filer: str, path: str) -> None:
    req = urllib.request.Request(
        f"http://{filer}{urllib.parse.quote(path)}?recursive=true",
        method="DELETE")
    urllib.request.urlopen(req, timeout=30).close()


def _lookup(filer: str, path: str):
    try:
        with urllib.request.urlopen(
                f"http://{filer}/__meta__/lookup?"
                + urllib.parse.urlencode({"path": path}), timeout=5) as r:
            return json.load(r)
    except urllib.error.HTTPError:
        return None


def _wait(cond, what: str, timeout: float = 20.0) -> None:
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, f"timed out: {what}"
        time.sleep(0.05)


# ------------------------------------------------ test_meta_sync's cases

def test_file_queue_spool(m, tmp_path):
    q = m.queues.FileQueue(str(tmp_path / "spool"))
    f = m.Filer(m.MemoryStore())
    f.signature = 3
    f.meta_log.subscribe(q.notify)
    f.create_entry(m.entry.new_file("/spooled", []))
    q.close()
    files = os.listdir(tmp_path / "spool")
    assert len(files) == 1
    lines = (tmp_path / "spool" / files[0]).read_text().splitlines()
    evs = [m.MetaEvent.from_dict(json.loads(line)) for line in lines]
    assert any(e.new_entry and e.new_entry.full_path == "/spooled"
               for e in evs)


def test_load_notifier_selects_first_enabled(m, tmp_path):
    cfg = m.Configuration({"notification": {
        "log": {"enabled": False},
        "file": {"enabled": True, "directory": str(tmp_path / "nq")},
    }})
    n = m.queues.load_notifier(cfg)
    assert isinstance(n, m.queues.FileQueue)
    assert m.queues.load_notifier(m.Configuration({})) is None
    for name in ("aws_sqs", "gocdk"):
        with pytest.raises(RuntimeError, match="broker SDK"):
            m.queues.load_notifier(m.Configuration(
                {"notification": {name: {"enabled": True}}}))


def test_local_sink_materializes_tree(m, tmp_path):
    sink = m.sink.LocalSink(str(tmp_path / "out"))
    f = m.entry.new_file("/a/b/c.txt", [])
    sink.create_entry(f, lambda: b"content!")
    assert (tmp_path / "out/a/b/c.txt").read_bytes() == b"content!"
    sink.create_entry(m.entry.new_directory("/a/empty"), lambda: b"")
    assert (tmp_path / "out/a/empty").is_dir()
    sink.delete_entry(f)
    assert not (tmp_path / "out/a/b/c.txt").exists()


def test_gcs_sink_contract(m):
    fake = m.fake_gcs.FakeGcsServer(token="tok123")
    try:
        sink = m.sink.GcsSink("bkt", directory="/mirror",
                              endpoint=fake.endpoint, token="tok123")
        f = m.entry.new_file("/a/b/c.txt", [])
        sink.create_entry(f, lambda: b"gcs content")
        assert fake.buckets["bkt"]["mirror/a/b/c.txt"] == b"gcs content"
        sink.create_entry(m.entry.new_directory("/a/dir"), lambda: b"")
        assert "mirror/a/dir" not in fake.buckets["bkt"]
        sink.create_entry(f, lambda: b"v2")
        assert fake.buckets["bkt"]["mirror/a/b/c.txt"] == b"v2"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(
                f"{fake.endpoint}/storage/v1/b/bkt/o/"
                "mirror%2Fa%2Fb%2Fc.txt?alt=media")
        assert e.value.code == 401
        sink.delete_entry(f)
        assert "mirror/a/b/c.txt" not in fake.buckets["bkt"]
        sink.delete_entry(f)  # idempotent: 404 swallowed
        bad = m.sink.GcsSink("bkt", endpoint=fake.endpoint, token="nope")
        with pytest.raises(urllib.error.HTTPError) as e:
            bad.create_entry(m.entry.new_file("/x", []), lambda: b"d")
        assert e.value.code == 401
    finally:
        fake.close()


def test_gcs_sink_loads_from_config(m):
    cfg = m.Configuration({"sink": {"gcs": {
        "enabled": True, "bucket": "b1", "directory": "/d",
        "endpoint": "http://127.0.0.1:1", "token": "t"}}})
    s = m.sink.load_sink(cfg)
    assert isinstance(s, m.sink.GcsSink)
    assert s.bucket == "b1" and s.prefix == "d"
    assert s.identity() == "GcsSink:http://127.0.0.1:1/b1/d"


def test_filer_notifier_spools_every_mutation(live, tmp_path):
    """The filer server's notifier= gets each mutation of the MetaLog."""
    m = live.m
    q = m.queues.FileQueue(str(tmp_path / "spool"))
    fs = live.add_filer_server(notifier=q)
    _put(fs.url, "/note/a.txt", b"one")
    _post(fs.url, "/note/d", "op=mkdir")
    _delete(fs.url, "/note/a.txt")
    q.close()
    inp = m.sub.FileQueueInput(str(tmp_path / "spool"))
    seen = [(e.old_entry.full_path if e.old_entry else None,
             e.new_entry.full_path if e.new_entry else None)
            for e in m.sub.iter_queue(inp, idle_timeout=0.2)]
    assert (None, "/note/a.txt") in seen
    assert (None, "/note/d") in seen
    assert ("/note/a.txt", None) in seen


def test_meta_subscribe_and_sync_e2e(live):
    """Two filers on one blob cluster, B aggregating A through peers=:
    writes on A appear on B (same chunks, so B serves the bytes) and a
    delete on A propagates."""
    fa = live.filer
    fb = live.add_filer_server(peers=[fa.url])
    _put(fa.url, "/sync/hello.txt", b"hello from A")
    _wait(lambda: _lookup(fb.url, "/sync/hello.txt") is not None,
          "entry synced to B", timeout=10)
    assert _get(fb.url, "/sync/hello.txt") == (200, b"hello from A")
    _delete(fa.url, "/sync/hello.txt")
    _wait(lambda: _lookup(fb.url, "/sync/hello.txt") is None,
          "delete synced to B", timeout=10)


def test_subscribe_stream_replays_since(live):
    import socket
    f = live.add_filer()
    _put(f.url, "/stream/a.txt", b"1")
    _put(f.url, "/stream/b.txt", b"2")
    with urllib.request.urlopen(
            f"http://{f.url}/__meta__/subscribe?since=0&prefix=/stream",
            timeout=5) as r:
        lines = []
        try:
            for line in r:
                lines.append(json.loads(line))
                if len(lines) >= 3:
                    break
        except socket.timeout:
            pass
    paths = {d["new"]["path"] for d in lines if d.get("new")}
    assert {"/stream/a.txt", "/stream/b.txt"} <= paths


# ----------------------------------------- test_queue_replication's cases

def test_file_queue_input_consumes_and_resumes(m, tmp_path):
    spool = str(tmp_path / "spool")
    q = m.queues.FileQueue(spool)
    for i in range(5):
        q.notify(_event(m, f"/data/f{i}", 100 + i))
    q.close()
    inp = m.sub.FileQueueInput(spool)
    got = [e.new_entry.full_path
           for e in m.sub.iter_queue(inp, idle_timeout=0.2)]
    assert got == [f"/data/f{i}" for i in range(5)]
    q = m.queues.FileQueue(spool)
    q.notify(_event(m, "/data/late", 200))
    q.close()
    inp2 = m.sub.FileQueueInput(spool)
    got2 = [e.new_entry.full_path
            for e in m.sub.iter_queue(inp2, idle_timeout=0.2)]
    assert got2 == ["/data/late"]


def test_file_queue_input_tolerates_torn_tail(m, tmp_path):
    spool = str(tmp_path / "spool")
    q = m.queues.FileQueue(spool)
    q.notify(_event(m, "/d/whole", 10))
    q.close()
    files = [n for n in os.listdir(spool) if n.endswith(".ndjson")]
    with open(os.path.join(spool, files[0]), "a", encoding="utf-8") as f:
        f.write('{"tsns": 11, "directory": "/d"')
    inp = m.sub.FileQueueInput(spool)
    got = [e.new_entry.full_path
           for e in m.sub.iter_queue(inp, idle_timeout=0.2)]
    assert got == ["/d/whole"]


def test_spool_reads_alike_in_both_packages(tmp_path):
    """A spool each package's FileQueue wrote is consumed by each
    package's FileQueueInput as the same events, position for
    position."""
    out = {}
    for writer in PKGS:
        mw = _mods(writer)
        spool = str(tmp_path / writer)
        q = mw.queues.FileQueue(spool)
        rng = random.Random(7)
        for i in range(40):
            q.notify(_event(mw, f"/w/{rng.randrange(1000)}/f{i}",
                            1000 + i))
        q.close()
        for reader in PKGS:
            mr = _mods(reader)
            inp = mr.sub.FileQueueInput(
                spool, str(tmp_path / f"{writer}-{reader}.pos"))
            evs = [e.to_dict() for e in mr.sub.iter_queue(
                inp, idle_timeout=0.2)]
            with open(inp.position_path) as f:
                out[writer, reader] = (evs, json.load(f))
    assert out["reference", "reference"] == out["reference", "port"]
    assert out["port", "reference"] == out["port", "port"]
    assert len(out["port", "port"][0]) == 40


def test_corrupt_spool_line_skipped_loudly(m, tmp_path):
    spool = tmp_path / "events-0001.ndjson"
    lines = [json.dumps(_event(m, "/s/ok", 5).to_dict()),
             '{"tsns": 6, "directory": "/s", CORRUPT',
             json.dumps(_event(m, "/s/ok2", 7).to_dict())]
    spool.write_text("\n".join(lines) + "\n", encoding="utf-8")
    reg = m.metrics.shared("replication")
    before = reg._counters.get("replication_corrupt_events", 0)
    got = [e.new_entry.full_path
           for e in m.replicator.consume_spool_file(str(spool))]
    assert got == ["/s/ok", "/s/ok2"]
    assert reg._counters.get("replication_corrupt_events", 0) \
        == before + 1


class CountingSink:
    """LocalSink wrapper counting applies per path."""

    def __init__(self, m, directory: str):
        self.inner = m.sink.LocalSink(directory)
        self.creates: dict = {}
        self.deletes: dict = {}

    def create_entry(self, entry, fetch_data, signatures=()):
        self.creates[entry.full_path] = \
            self.creates.get(entry.full_path, 0) + 1
        return self.inner.create_entry(entry, fetch_data, signatures)

    def update_entry(self, old, new, fetch_data, signatures=()):
        return self.create_entry(new, fetch_data, signatures)

    def delete_entry(self, entry, signatures=()):
        self.deletes[entry.full_path] = \
            self.deletes.get(entry.full_path, 0) + 1
        return self.inner.delete_entry(entry, signatures)


def test_replicator_offset_durable_across_restart(live, live_filer,
                                                  tmp_path):
    """Kill the replicator between runs: the second instance resumes from
    the persisted offset, zero re-applied, zero lost."""
    m = live.m
    Replicator = m.replicator.Replicator
    filer = live_filer.url
    offset_path = str(tmp_path / "offset.json")
    payload = {f"/r1/f{i}": f"durable {i}".encode() for i in range(10)}
    _post(filer, "/r1", "op=mkdir")
    for p, data in payload.items():
        _put(filer, p, data)
    sink1 = CountingSink(m, str(tmp_path / "sink"))
    r1 = Replicator(filer, sink1, "/r1", offset_path=offset_path)
    assert r1.run(max_events=6) == 6
    del r1
    sink2 = CountingSink(m, str(tmp_path / "sink"))
    r2 = Replicator(filer, sink2, "/r1", offset_path=offset_path)
    assert r2.run(max_events=5) == 5
    creates: dict = {}
    for s in (sink1, sink2):
        for p, n in s.creates.items():
            creates[p] = creates.get(p, 0) + n
    for p in payload:
        assert creates.get(p) == 1, (p, creates)
    for p, data in payload.items():
        with open(str(tmp_path / "sink") + p, "rb") as f:
            assert f.read() == data
    sink3 = CountingSink(m, str(tmp_path / "sink"))
    r3 = Replicator(filer, sink3, "/r1", offset_path=offset_path)
    _put(filer, "/r1/late", b"only this one")
    assert r3.run(max_events=1) == 1
    assert list(sink3.creates) == ["/r1/late"]


def test_replicator_poison_event_exact_retries(live, live_filer,
                                               tmp_path):
    """A persistently failing event is attempted exactly
    MAX_EVENT_RETRIES times, skipped loudly, and the stream moves on."""
    m = live.m
    Replicator = m.replicator.Replicator
    faults = m.faults
    filer = live_filer.url
    sink = CountingSink(m, str(tmp_path / "psink"))
    r = Replicator(filer, sink, "/r2",
                   offset_path=str(tmp_path / "poffset.json"))
    stop = [False]
    t = threading.Thread(target=lambda: r.run(stop_check=lambda: stop[0]),
                         daemon=True)
    _post(filer, "/r2", "op=mkdir")
    t.start()
    _wait(lambda: os.path.isdir(str(tmp_path / "psink") + "/r2"),
          "mkdir applied")
    assert Replicator.MAX_EVENT_RETRIES == 3
    faults.set_fault("geo.apply", "error",
                     count=Replicator.MAX_EVENT_RETRIES)
    try:
        _put(filer, "/r2/poisoned", b"never lands")
        _put(filer, "/r2/after", b"lands fine")
        _wait(lambda: "/r2/after" in sink.creates,
              "stream wedged behind poison")
        fired = [f for f in faults.active()
                 if f["point"] == "geo.apply"][0]["fired"]
        assert fired == Replicator.MAX_EVENT_RETRIES
        assert "/r2/poisoned" not in sink.creates
        assert sink.creates.get("/r2/after") == 1
    finally:
        faults.clear("geo.apply")
        stop[0] = True
        _put(filer, "/r2/wake", b"unblock the stop_check")
        t.join(timeout=10)
        assert not t.is_alive()


def test_d27_queued_create_of_a_deleted_path(live, live_filer, tmp_path):
    """D27: a queued create whose path was deleted at the source since
    can never fetch its body. The reference's run_from_queue raises out
    of the loop on it and leaves the position before it, so the queue
    stops there for good, and its LocalSink leaves an empty file at the
    path; the port's skips it loudly (the source answered 404) and
    applies the events behind it, and its LocalSink fetches the body
    before it opens the file."""
    m = live.m
    filer = live_filer.url
    _post(filer, "/q27", "op=mkdir")
    _put(filer, "/q27/gone", b"deleted before the queue is drained")
    _put(filer, "/q27/kept", b"still at the source")
    _delete(filer, "/q27/gone")
    spool = str(tmp_path / "spool")
    q = m.queues.FileQueue(spool)
    q.notify(_event(m, "/q27/gone", 10))
    q.notify(_event(m, "/q27/kept", 11))
    q.close()
    sink_dir = str(tmp_path / "sink")
    r = m.replicator.Replicator(filer, m.sink.LocalSink(sink_dir), "/q27")
    pos = str(tmp_path / "pos")
    if m.pkg == "reference":
        for _ in range(2):  # a restart meets the same event
            with pytest.raises(RuntimeError):
                m.replicator.run_from_queue(
                    r, m.sub.FileQueueInput(spool, pos), idle_timeout=0.2)
        assert not os.path.exists(sink_dir + "/q27/kept")
        assert os.path.getsize(sink_dir + "/q27/gone") == 0
        return
    assert m.replicator.run_from_queue(
        r, m.sub.FileQueueInput(spool, pos), idle_timeout=0.2) == 1
    assert not os.path.exists(sink_dir + "/q27/gone")
    with open(sink_dir + "/q27/kept", "rb") as f:
        assert f.read() == b"still at the source"
    # the skipped event was consumed: a restart has nothing left
    assert m.replicator.run_from_queue(
        r, m.sub.FileQueueInput(spool, pos), idle_timeout=0.2) == 0


@pytest.mark.parametrize("fails", [2, 3])
def test_d27_queue_mode_retries_a_failing_event(live, live_filer, tmp_path,
                                                fails):
    """D27: any other failure of a queued event is retried 1 s apart as
    live mode retries it: an event that fails twice lands on its third
    try, one that fails MAX_EVENT_RETRIES times is skipped and the queue
    goes on. The reference's queue mode raises on the first failure."""
    m = live.m
    filer = live_filer.url
    _post(filer, f"/q27r{fails}", "op=mkdir")
    for name in ("first", "second"):
        _put(filer, f"/q27r{fails}/{name}", name.encode())
    spool = str(tmp_path / "spool")
    q = m.queues.FileQueue(spool)
    q.notify(_event(m, f"/q27r{fails}/first", 10))
    q.notify(_event(m, f"/q27r{fails}/second", 11))
    q.close()
    sink_dir = str(tmp_path / "sink")
    r = m.replicator.Replicator(filer, m.sink.LocalSink(sink_dir),
                                f"/q27r{fails}")
    inp = m.sub.FileQueueInput(spool, str(tmp_path / "pos"))
    m.faults.set_fault("geo.apply", "error", count=fails)
    try:
        if m.pkg == "reference":
            with pytest.raises(m.faults.FaultError):
                m.replicator.run_from_queue(r, inp, idle_timeout=0.2)
            return
        applied = m.replicator.run_from_queue(r, inp, idle_timeout=0.2)
        fired = [f for f in m.faults.active()
                 if f["point"] == "geo.apply"][0]["fired"]
    finally:
        m.faults.clear("geo.apply")
    assert fired == fails
    got = sorted(os.listdir(sink_dir + f"/q27r{fails}"))
    if fails < m.replicator.Replicator.MAX_EVENT_RETRIES:
        assert applied == 2 and got == ["first", "second"]
    else:
        assert applied == 1 and got == ["second"]


# ------------------------------------------------ test_azure_sink's cases

@pytest.fixture()
def azure(m):
    f = m.fake_azure.FakeAzureServer()
    yield m, f
    f.close()


def test_azure_sink_contract(azure):
    m, fake = azure
    sink = m.sink.AzureSink(fake.account, fake.key, "cont1",
                            directory="/mirror", endpoint=fake.endpoint)
    f = m.entry.new_file("/a/b/c.txt", [])
    sink.create_entry(f, lambda: b"azure content")
    assert fake.containers["cont1"]["mirror/a/b/c.txt"] == b"azure content"
    sink.create_entry(m.entry.new_directory("/a/dir"), lambda: b"")
    assert "mirror/a/dir" not in fake.containers["cont1"]
    sink.create_entry(f, lambda: b"v2")
    assert fake.containers["cont1"]["mirror/a/b/c.txt"] == b"v2"
    with urllib.request.urlopen(
            f"{fake.endpoint}/cont1/mirror/a/b/c.txt") as r:
        assert r.read() == b"v2"
    sink.delete_entry(f)
    assert "mirror/a/b/c.txt" not in fake.containers["cont1"]
    sink.delete_entry(f)


def test_azure_sink_block_list_upload(azure):
    m, fake = azure
    sink = m.sink.AzureSink(fake.account, fake.key, "cont2",
                            endpoint=fake.endpoint, block_size=1024)
    payload = bytes(range(256)) * 20  # 5120 B -> 5 blocks
    sink.create_entry(m.entry.new_file("/big.bin", []), lambda: payload)
    assert fake.containers["cont2"]["big.bin"] == payload
    assert ("cont2", "big.bin") not in fake.blocks


def test_azure_sink_bad_key_rejected(azure):
    m, fake = azure
    bad = m.sink.AzureSink(fake.account, "d3JvbmdrZXk=", "cont3",
                           endpoint=fake.endpoint)
    with pytest.raises(urllib.error.HTTPError) as e:
        bad.create_entry(m.entry.new_file("/x", []), lambda: b"d")
    assert e.value.code == 403


def test_azure_signature_covers_amz_headers(azure):
    m, fake = azure
    sink = m.sink.AzureSink(fake.account, fake.key, "cont4",
                            endpoint=fake.endpoint)
    orig = urllib.request.urlopen

    def tamper(req, *a, **kw):
        if req.get_method() == "PUT":
            req.headers["x-ms-version"] = "1999-01-01"
        return orig(req, *a, **kw)

    urllib.request.urlopen = tamper
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            sink.create_entry(m.entry.new_file("/t.txt", []), lambda: b"x")
        assert e.value.code == 403
    finally:
        urllib.request.urlopen = orig


def test_azure_sink_loads_from_config(m):
    cfg = m.Configuration({"sink": {"azure": {
        "enabled": True, "account": "acct", "account_key": "a2V5",
        "container": "c", "directory": "/d",
        "endpoint": "http://127.0.0.1:1"}}})
    s = m.sink.load_sink(cfg)
    assert isinstance(s, m.sink.AzureSink)
    assert s.container == "c" and s.prefix == "d"


def test_backblaze_loads_as_s3_route(m):
    cfg = m.Configuration({"sink": {"backblaze": {
        "enabled": True, "bucket": "b2bkt", "directory": "/m",
        "endpoint": "http://127.0.0.1:1",
        "b2_account_id": "AK", "b2_master_application_key": "SK"}}})
    s = m.sink.load_sink(cfg)
    assert isinstance(s, m.sink.S3Sink)
    assert s.store.bucket == "b2bkt" and s.prefix == "m"


def test_backblaze_s3_route_against_own_gateway(live):
    """The b2 route (the S3 sink with an endpoint override) into the
    package's own S3 gateway."""
    m = live.m
    gw = live.add_s3(live.filer)
    req = urllib.request.Request(f"http://{gw}/b2mirror", method="PUT")
    urllib.request.urlopen(req, timeout=30).read()
    cfg = m.Configuration({"sink": {"backblaze": {
        "enabled": True, "bucket": "b2mirror",
        "endpoint": f"http://{gw}"}}})
    sink = m.sink.load_sink(cfg)
    sink.create_entry(m.entry.new_file("/data/rep.txt", []),
                      lambda: b"replicated to b2-style endpoint")
    with urllib.request.urlopen(f"http://{gw}/b2mirror/data/rep.txt",
                                timeout=30) as r:
        assert r.read() == b"replicated to b2-style endpoint"
    sink.delete_entry(m.entry.new_file("/data/rep.txt", []))
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://{gw}/b2mirror/data/rep.txt",
                               timeout=30)
    assert e.value.code == 404


def test_sinks_put_the_same_objects(tmp_path):
    """One seeded set of entries through each package's GCS, Azure and
    local sinks leaves the same objects in the fakes and the same tree."""
    out = {}
    for pkg in PKGS:
        m = _mods(pkg)
        gcs = m.fake_gcs.FakeGcsServer()
        az = m.fake_azure.FakeAzureServer()
        try:
            sinks = [m.sink.GcsSink("g", "/p", endpoint=gcs.endpoint),
                     m.sink.AzureSink(az.account, az.key, "c", "/p",
                                      endpoint=az.endpoint,
                                      block_size=4096),
                     m.sink.LocalSink(str(tmp_path / pkg))]
            rng = random.Random(11)
            for i in range(30):
                e = m.entry.new_file(f"/d{rng.randrange(4)}/f{i}", [])
                data = rng.randbytes(rng.randrange(1, 10_000))
                for s in sinks:
                    s.create_entry(e, lambda d=data: d)
                    if i % 5 == 0:
                        s.delete_entry(e)
            out[pkg] = (dict(gcs.buckets["g"]), dict(az.containers["c"]),
                        _tree(str(tmp_path / pkg)),
                        [s.identity().split(":")[0] for s in sinks])
        finally:
            gcs.close()
            az.close()
    assert out["reference"] == out["port"]


# ------------------------------------------------ the seeded replication

def _tree(root: str) -> dict:
    out = {}
    for dirpath, dirs, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        for d in dirs:
            out[os.path.normpath(os.path.join(rel, d))] = "dir"
        for name in files:
            with open(os.path.join(dirpath, name), "rb") as f:
                out[os.path.normpath(os.path.join(rel, name))] = \
                    hashlib.sha256(f.read()).hexdigest()
    return out


class TeeSink:
    def __init__(self, *sinks):
        self.sinks = sinks

    def create_entry(self, entry, fetch_data, signatures=()):
        data = fetch_data()
        for s in self.sinks:
            s.create_entry(entry, lambda: data, signatures)

    def update_entry(self, old, new, fetch_data, signatures=()):
        data = fetch_data()
        for s in self.sinks:
            s.update_entry(old, new, lambda: data, signatures)

    def delete_entry(self, entry, signatures=()):
        for s in self.sinks:
            s.delete_entry(entry, signatures)


def _s3(gw: str, method: str, path: str, data: bytes = None) -> int:
    req = urllib.request.Request(f"http://{gw}{path}", data=data,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            r.read()
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def _namespace(filer: str, root: str) -> dict:
    """path -> (is dir, mime, sha256 of bytes, extended) under root, by a
    walk of the filer's listings (chunk fids and signatures aside)."""
    out = {}
    todo = [root]
    while todo:
        d = todo.pop()
        start = ""
        while True:
            with urllib.request.urlopen(
                    f"http://{filer}/__meta__/list?" + urllib.parse.urlencode(
                        {"dir": d, "start": start, "limit": "512"}),
                    timeout=30) as r:
                entries = json.load(r).get("entries", [])
            for e in entries:
                is_dir = bool(e.get("attr", {}).get("mode", 0) & 0o40000)
                sha = ""
                if is_dir:
                    todo.append(e["path"])
                else:
                    st, body = _get(filer, e["path"])
                    assert st == 200, e["path"]
                    sha = hashlib.sha256(body).hexdigest()
                out[e["path"]] = (is_dir, e.get("attr", {}).get("mime", ""),
                                  sha, json.dumps(e.get("extended") or {},
                                                  sort_keys=True))
            if len(entries) < 512:
                break
            start = entries[-1]["path"].rsplit("/", 1)[-1]
    return out


def _rank_versions(ns: dict) -> dict:
    """Version ids (time-ordered, different in every run) replaced by
    their rank among the run's ids, in paths and in attributes."""
    import re
    ids = set()
    for path, (_, _, _, ext) in ns.items():
        ids.update(re.findall(r"\.versions/([0-9a-f]{20})", path))
        ids.update(re.findall(r'"([0-9a-f]{20})"', ext))
    rank = {v: f"v{i:03d}" for i, v in enumerate(sorted(ids))}

    def sub(s: str) -> str:
        return re.sub(r"[0-9a-f]{20}", lambda mo: rank.get(mo.group(0),
                                                           mo.group(0)), s)
    return {sub(p): (d, mime, sha, sub(ext))
            for p, (d, mime, sha, ext) in ns.items()}


def _script(seed: int) -> list:
    """Rounds of (op, path, arg): each round touches a path at most once,
    so a round's events all fetch what they name."""
    rng = random.Random(seed)
    live_files: list = []
    rounds, n = [], 0
    for _ in range(4):
        ops, touched = [], set()
        for _ in range(12):
            kind = rng.choice(["create", "create", "overwrite", "rename",
                               "delete", "mkdir", "s3"])
            free = [p for p in live_files if p not in touched]
            if kind in ("overwrite", "rename", "delete") and not free:
                kind = "create"
            n += 1
            if kind == "create":
                p = f"/rep/d{rng.randrange(3)}/f{n}"
                ops.append(("create", p, rng.randbytes(rng.randrange(
                    1, 40_000))))
                live_files.append(p)
            elif kind == "overwrite":
                p = rng.choice(free)
                ops.append(("create", p, rng.randbytes(rng.randrange(
                    1, 40_000))))
            elif kind == "rename":
                p = rng.choice(free)
                q = f"/rep/d{rng.randrange(3)}/moved{n}"
                ops.append(("rename", p, q))
                live_files.remove(p)
                live_files.append(q)
                touched.add(q)
            elif kind == "delete":
                p = rng.choice(free)
                ops.append(("delete", p, None))
                live_files.remove(p)
            elif kind == "mkdir":
                p = f"/rep/dir{n}"
                ops.append(("mkdir", p, None))
            else:
                key = f"obj{rng.randrange(3)}"
                ops.append(("s3", key, rng.randbytes(rng.randrange(
                    1, 20_000))))
                p = f"/buckets/vb/{key}"
            touched.add(p)
        rounds.append(ops)
    return rounds


def _replicate_script(pkg: str, tmp: str) -> tuple:
    m = _mods(pkg)
    lv = Live(pkg)
    try:
        src = lv.filer
        dst = lv.add_filer()
        gw = lv.add_s3(src)
        assert _s3(gw, "PUT", "/vb") == 200
        assert _s3(gw, "PUT", "/vb?versioning",
                   b"<VersioningConfiguration><Status>Enabled</Status>"
                   b"</VersioningConfiguration>") == 200
        local = m.sink.LocalSink(os.path.join(tmp, "local"))
        applied: set = set()

        class Marking(TeeSink):
            def create_entry(self, entry, fetch_data, signatures=()):
                super().create_entry(entry, fetch_data, signatures)
                applied.add(entry.full_path)

        sink = Marking(m.sink.FilerSink(dst.url), local)
        r = m.replicator.Replicator(src.url, sink, "/",
                                    offset_path=os.path.join(tmp, "off"))
        for i, ops in enumerate(_script(20)):
            for op, p, arg in ops:
                if op == "create":
                    _put(src.url, p, arg)
                elif op == "rename":
                    _post(src.url, p, "mv.to=" + urllib.parse.quote(arg))
                elif op == "delete":
                    _delete(src.url, p)
                elif op == "mkdir":
                    _post(src.url, p, "op=mkdir")
                else:
                    assert _s3(gw, "PUT", f"/vb/{p}", arg) == 200
            # two marks end the round: the run stops at the second once
            # the first has been applied
            first, second = f"/mark/r{i}a", f"/mark/r{i}b"
            _put(src.url, first, b"a")
            _put(src.url, second, b"b")
            r.run(stop_check=lambda: first in applied)
        src_ns = _namespace(src.url, "/rep")
        src_ns.update(_namespace(src.url, "/buckets/vb"))
        dst_ns = _namespace(dst.url, "/rep")
        dst_ns.update(_namespace(dst.url, "/buckets/vb"))
        # FilerSink carries the bytes, not the mime type (upstream's)
        strip = {p: (v[0], v[2]) for p, v in src_ns.items()}
        assert {p: (v[0], v[2]) for p, v in dst_ns.items()} == strip
        tree = _tree(os.path.join(tmp, "local"))
        for p, (is_dir, _, sha, _) in src_ns.items():
            assert tree[p.lstrip("/")] == ("dir" if is_dir else sha), p
        return _rank_versions(dst_ns), _rank_versions(
            {k: (v == "dir", "", "" if v == "dir" else v, "{}")
             for k, v in tree.items()})
    finally:
        lv.shutdown()


def test_seeded_script_replicates_alike(tmp_path):
    ns_ref, tree_ref = _replicate_script("reference",
                                         str(tmp_path / "reference"))
    ns_port, tree_port = _replicate_script("port", str(tmp_path / "port"))
    assert len(ns_port) > 30
    assert any(".versions/" in p for p in ns_port)
    assert ns_port == ns_ref
    assert tree_port == tree_ref


# ------------------------------------------------------------------ D25

def _big_entry(path: str, chunks: int) -> dict:
    return {"path": path,
            "attr": {"mode": 0o100644, "mtime": 1.0, "crtime": 1.0},
            "chunks": [{"fid": f"3,{i:08x}deadbeef", "offset": i * 1024,
                        "size": 1024, "mtime": i} for i in range(chunks)],
            "extended": {}}


@pytest.mark.parametrize("pkg", PKGS)
def test_d25_peer_aggregation_passes_an_event_over_128_kib(pkg):
    """ROADMAP Queue 3, D25: an event of an entry with 4000 chunks is
    a subscribe line of about 300 KiB. The port's aggregator splits the
    stream by hand and replays it and what follows; the reference's reads
    it with aiohttp's line iterator, which raises past about 128 KiB, so
    its peer retries that line every second and replays nothing after
    it."""
    lv = Live(pkg)
    try:
        fa = lv.filer
        fb = lv.add_filer_server(peers=[fa.url])
        body = json.dumps({"entry": _big_entry("/d25/big", 4000)}).encode()
        assert len(body) > 256 * 1024
        req = urllib.request.Request(
            f"http://{fa.url}/__meta__/create_entry", data=body,
            headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=30).close()
        _put(fa.url, "/d25/after", b"after the big event")
        if pkg == "port":
            _wait(lambda: _lookup(fb.url, "/d25/after") is not None,
                  "the event after the big one", timeout=10)
            assert len(_lookup(fb.url, "/d25/big")["chunks"]) == 4000
        else:
            time.sleep(3.0)
            assert _lookup(fb.url, "/d25/big") is None
            assert _lookup(fb.url, "/d25/after") is None
    finally:
        lv.shutdown()
