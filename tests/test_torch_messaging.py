"""The port's message broker against the reference's.

Modelled on tests/test_messaging.py: the log buffer, partition and
broker picking, publish and subscribe, live tails, filer-backed segments,
brokers that register over the filer's gRPC KeepConnected and share the
partitions by rendezvous hash (a 307 to the owner), failover when one
dies, the ack-level contract under a SIGKILL of a CLI ``msg.broker``,
the SeaweedMessaging gRPC service, the channel wrappers, and the broker
queue and input of the notification and replication planes.

The log buffer's offsets and segments, LogEntry's wire form,
``pick_partition`` and ``pick_broker`` are held equal to the
reference's on seeded inputs. Clients of both packages speak to the
port's brokers (HTTP and gRPC), and the reference's BrokerQueue feeds
the port's BrokerQueueInput and the other way round. The port's servers
run in this process (``LocalCluster(with_grpc=True)``).
"""

import json
import os
import queue as queue_mod
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import grpc
import numpy as np
import pytest

from cluster_util import TEST_GEOMETRY
from seaweedfs_torch.filer.chunks import FileChunk
from seaweedfs_torch.filer.entry import new_file
from seaweedfs_torch.filer.filer import MetaEvent
from seaweedfs_torch.messaging import client as pclient
from seaweedfs_torch.messaging.broker import run_broker
from seaweedfs_torch.notification import queues as pqueues
from seaweedfs_torch.pb import messaging_pb2 as mpb
from seaweedfs_torch.pb import rpc as prpc
from seaweedfs_torch.replication import sub as psub
from seaweedfs_torch.server import http
from seaweedfs_torch.server.local_cluster import LocalCluster
from seaweedfs_torch.utils import log_buffer as plb
from seaweedfs_torch.utils.config import Configuration
from seaweedfs_tpu.messaging import client as rclient
from seaweedfs_tpu.notification import queues as rqueues
from seaweedfs_tpu.pb import rpc as rrpc
from seaweedfs_tpu.replication import sub as rsub
from seaweedfs_tpu.utils import log_buffer as rlb

REPO = Path(__file__).resolve().parent.parent
CLIENTS = {"port": pclient, "reference": rclient}
STUBS = {"port": prpc, "reference": rrpc}
_CLI = ("import sys; sys.path.insert(0, %r); "
        "from seaweedfs_torch.cli import main; main()" % str(REPO))


def _wait(pred, timeout: float = 15.0, what: str = ""):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timeout waiting for {what}")
        time.sleep(0.1)


# --- the log buffer, partitions and brokers, against the reference ---

def _buffers(flush_bytes: int, retention: int = 65536):
    out = {}
    for name, m in (("port", plb), ("reference", rlb)):
        segs = []

        def flush(seg, segs=segs, name=name):
            segs.append(seg)
            # the port's flush callback says when its segment landed
            if name == "port":
                out[name][0].persisted(seg)

        out[name] = (m.LogBuffer(flush_fn=flush, flush_bytes=flush_bytes,
                                 retention=retention), segs)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_log_buffer_offsets_and_segments_match_reference(seed):
    rng = np.random.default_rng(seed)
    bufs = _buffers(flush_bytes=int(rng.integers(200, 2000)),
                    retention=int(rng.integers(5, 40)))
    # given timestamps, some repeated or going back: both must make them
    # strictly monotonic the same way
    ts = np.cumsum(rng.integers(-2, 4, size=120)) + 1000
    for i, t in enumerate(ts):
        key = rng.bytes(int(rng.integers(0, 8)))
        value = rng.bytes(int(rng.integers(0, 90)))
        got = {n: b.add(key, value, {"i": str(i)}, ts_ns=int(t)).ts_ns
               for n, (b, _) in bufs.items()}
        assert got["port"] == got["reference"]
    for b, _ in bufs.values():
        b.flush()
    (pb, psegs), (rb, rsegs) = bufs["port"], bufs["reference"]
    assert [[e.to_dict() for e in s] for s in psegs] == \
        [[e.to_dict() for e in s] for s in rsegs]
    assert pb.read_since(0) == [] and rb.read_since(0) == []


def test_log_buffer_read_since_and_fanout():
    lb = plb.LogBuffer()
    e1 = lb.add(b"k1", b"v1")
    e2 = lb.add(b"k2", b"v2")
    assert e2.ts_ns > e1.ts_ns
    assert [e.value for e in lb.read_since(0)] == [b"v1", b"v2"]
    assert [e.value for e in lb.read_since(e1.ts_ns)] == [b"v2"]
    got = []
    lb.subscribe(got.append)
    lb.add(b"a", b"1")
    lb.unsubscribe(got.append)
    lb.add(b"b", b"2")
    assert [e.key for e in got] == [b"a"]


def test_log_entry_wire_form_matches_reference():
    rng = np.random.default_rng(3)
    for _ in range(20):
        args = (int(rng.integers(1, 2**62)), rng.bytes(5), rng.bytes(40),
                {"h": str(rng.integers(9))})
        d = plb.LogEntry(*args).to_dict()
        assert d == rlb.LogEntry(*args).to_dict()
        back = rlb.LogEntry.from_dict(d)
        assert (back.ts_ns, back.key, back.value, back.headers) == args
        back = plb.LogEntry.from_dict(d)
        assert (back.ts_ns, back.key, back.value, back.headers) == args


@pytest.mark.parametrize("count", [1, 2, 8, 13])
def test_pick_partition_matches_reference(count):
    rng = np.random.default_rng(count)
    keys = [rng.bytes(int(rng.integers(0, 24))) for _ in range(300)]
    assert [pclient.pick_partition(k, count) for k in keys] == \
        [rclient.pick_partition(k, count) for k in keys]
    if count > 1:
        assert len({pclient.pick_partition(k, count) for k in keys}) == count


def test_pick_broker_matches_reference_and_is_stable():
    rng = np.random.default_rng(9)
    brokers = [f"10.0.0.{i}:{int(rng.integers(1000, 60000))}"
               for i in range(5)]
    for p in range(64):
        assert pclient.pick_broker(brokers, "ns", f"t{p % 7}", p) == \
            rclient.pick_broker(brokers, "ns", f"t{p % 7}", p)
    before = {p: pclient.pick_broker(brokers, "ns", "t", p)
              for p in range(64)}
    reduced = brokers[:2] + brokers[3:]
    for p in range(64):
        if before[p] != brokers[2]:
            assert pclient.pick_broker(reduced, "ns", "t", p) == before[p]
    with pytest.raises(ValueError):
        pclient.pick_broker([], "ns", "t", 0)


# --- live brokers ---

@pytest.fixture(scope="module")
def cluster():
    c = LocalCluster(1, coder_name="numpy", geometry=TEST_GEOMETRY,
                     volume_size_limit_mb=4, pulse=0.15, with_grpc=True)
    c.filer = c.add_filer(chunk_size=64 * 1024)
    c.brokers = []
    yield c
    for runner in c.brokers:
        c.call(runner.cleanup())
    c.shutdown()


def _broker(cluster, filer_url: str = "", **kwargs):
    port = http.free_port_with_grpc_twin()
    b, runner = cluster.call(run_broker("127.0.0.1", port,
                                        filer_url=filer_url, **kwargs))
    b.url = b.advertise_url
    b.runner = runner
    cluster.brokers.append(runner)
    return b


@pytest.mark.parametrize("side", CLIENTS)
def test_publish_subscribe_roundtrip(cluster, side):
    m = CLIENTS[side]
    b = _broker(cluster)
    pub = m.Publisher([b.url], "chat", f"room{side}", partition_count=2)
    for i in range(20):
        pub.publish(f"user{i % 3}".encode(), f"msg-{i}".encode())
    got = []
    for p in range(2):
        sub = m.Subscriber([b.url], "chat", f"room{side}", partition=p)
        got += [e.value.decode() for e in sub.stream(since=0, timeout=1.0)]
    assert sorted(got) == sorted(f"msg-{i}" for i in range(20))


def test_subscribe_tails_live_messages(cluster):
    b = _broker(cluster)
    pub = pclient.Publisher([b.url], "live", "topic", partition_count=1)
    sub = pclient.Subscriber([b.url], "live", "topic", partition=0)
    got = []

    def consume():
        for e in sub.stream(since=0, timeout=3.0):
            got.append(e.value)
            if len(got) >= 3:
                return

    t = threading.Thread(target=consume)
    t.start()
    time.sleep(0.3)
    for i in range(3):
        pub.publish(b"k", f"live-{i}".encode())
    t.join(timeout=5)
    assert got == [b"live-0", b"live-1", b"live-2"]


@pytest.fixture(scope="module")
def broker_pair(cluster):
    filer = cluster.filer
    b1 = _broker(cluster, filer.url)
    b2 = _broker(cluster, filer.url)
    urls = {b1.url, b2.url}

    def registered():
        status, body = http.get_json(f"http://{filer.url}/__meta__/brokers")
        return status == 200 and set(body["brokers"]) == urls

    _wait(registered, what="both brokers registered")
    _wait(lambda: set(b1.peer_brokers) == urls == set(b2.peer_brokers),
          what="peer lists converged")
    return {"filer": filer, "b1": b1, "b2": b2}


def test_multi_broker_registry_and_redirect(broker_pair):
    b1, b2 = broker_pair["b1"], broker_pair["b2"]
    brokers = sorted([b1.url, b2.url])
    owners = {pclient.pick_broker(brokers, "mb", "spread", p)
              for p in range(16)}
    assert owners == set(brokers)
    # through one broker: a partition it does not own is answered with a
    # 307 to its owner and lands there
    pub = pclient.Publisher([b1.url], "mb", "spread", partition_count=16)
    for i in range(64):
        pub.publish(f"key{i}".encode(), f"m{i}".encode())
    got = []
    for p in range(16):
        owner = pclient.pick_broker(brokers, "mb", "spread", p)
        sub = pclient.Subscriber([owner], "mb", "spread", partition=p)
        got += [e.value.decode() for e in sub.stream(since=0, timeout=0.5)]
    assert sorted(got) == sorted(f"m{i}" for i in range(64))
    assert {k for k in b2.partitions if k[0] == "mb"}
    for b in (b1, b2):
        for (ns, _, p) in b.partitions:
            if ns == "mb":
                assert pclient.pick_broker(brokers, "mb", "spread", p) \
                    == b.url


@pytest.mark.parametrize("side", STUBS)
def test_grpc_publish_redirects_to_the_owner(broker_pair, side):
    """A gRPC Publish or Subscribe of a partition another broker owns is
    answered with that owner (the gRPC twin of the 307); FindBroker
    names it too."""
    b1, b2 = broker_pair["b1"], broker_pair["b2"]
    brokers = sorted([b1.url, b2.url])
    p = next(p for p in range(32)
             if pclient.pick_broker(brokers, "rd", "t", p) == b2.url)
    with grpc.insecure_channel(prpc.grpc_address(b1.url)) as ch:
        stub = STUBS[side].MessagingStub(ch)
        init = mpb.PublishRequest(init=mpb.PublishRequest.InitMessage(
            namespace="rd", topic="t", partition=p))
        resp = list(stub.Publish(iter([init]), timeout=10))
        assert [r.redirect_to for r in resp] == [b2.url]
        sub_init = mpb.SubscriberMessage(
            init=mpb.SubscriberMessage.InitMessage(
                namespace="rd", topic="t", partition=p))
        resp = list(stub.Subscribe(iter([sub_init]), timeout=10))
        assert [r.redirect_to for r in resp] == [b2.url]
        fb = stub.FindBroker(mpb.FindBrokerRequest(
            namespace="rd", topic="t", partition=p), timeout=10)
        assert fb.broker == b2.url and list(fb.all_brokers) == brokers
    assert not [k for k in b1.partitions if k[0] == "rd"]


def test_broker_failover_on_death(cluster, broker_pair):
    filer, b1, b2 = (broker_pair["filer"], broker_pair["b1"],
                     broker_pair["b2"])
    ns, topic = "mb", "failover"
    victim = next(p for p in range(32)
                  if pclient.pick_broker(sorted([b1.url, b2.url]), ns,
                                         topic, p) == b2.url)
    pub = pclient.Publisher([b1.url], ns, topic, filer=filer.url,
                            ack="flush")

    def publish_to(value: bytes) -> dict:
        body = json.dumps(plb.LogEntry(0, b"k", value, {}).to_dict(),
                          separators=(",", ":")).encode() + b"\n"
        return pub._post(b1.url, victim, body)

    assert publish_to(b"before-death")["published"] == 1
    # b2's KeepConnected stream drops with it; ownership moves to b1
    cluster.call(b2.runner.cleanup())
    cluster.brokers.remove(b2.runner)

    def gone():
        status, body = http.get_json(f"http://{filer.url}/__meta__/brokers")
        return body["brokers"] == [b1.url]

    _wait(gone, what="dead broker deregistered")
    _wait(lambda: b1.peer_brokers == [b1.url], what="b1 registry shrink")
    assert publish_to(b"after-death")["published"] == 1
    # the flushed message comes from the filer's segments
    sub = pclient.Subscriber([b1.url], ns, topic, partition=victim)
    assert [e.value for e in sub.stream(since=0, timeout=1.0)] == \
        [b"before-death", b"after-death"]


def test_pub_sub_channels(cluster):
    b = _broker(cluster)
    with pclient.PubChannel([b.url], "jobs") as pc:
        for i in range(40):
            pc.put(f"job-{i}".encode())
    sc = pclient.SubChannel([b.url], "jobs", idle_timeout=1.0)
    assert list(sc) == [f"job-{i}".encode() for i in range(40)]
    assert sc.digest() == pc.digest()


def test_broker_sigkill_ack_durability_contract(cluster, tmp_path):
    """Messages acknowledged with ack=flush outlive a SIGKILL of a CLI
    ``msg.broker`` (their segments are in the filer); the unflushed
    ack=memory tail is lost, exactly that tail."""
    filer = cluster.filer
    port = http.free_port_with_grpc_twin()
    proc = subprocess.Popen(
        [sys.executable, "-I", "-c", _CLI, "msg.broker", "-ip",
         "127.0.0.1", "-port", str(port), "-filer", filer.url],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    url = f"127.0.0.1:{port}"
    try:
        def up():
            try:
                urllib.request.urlopen(f"http://{url}/topics",
                                       timeout=1).close()
                return True
            except OSError:
                return False
        _wait(up, timeout=30, what="the CLI broker")
        flush_pub = pclient.Publisher([url], "dur", "crash",
                                      partition_count=1, ack="flush")
        for i in range(5):
            flush_pub.publish(b"k", f"durable-{i}".encode())
        mem_pub = pclient.Publisher([url], "dur", "crash",
                                    partition_count=1, ack="memory")
        for i in range(7):
            mem_pub.publish(b"k", f"volatile-{i}".encode())
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
    b2 = _broker(cluster, filer_url=filer.url, register=False)
    sub = pclient.Subscriber([b2.url], "dur", "crash", partition=0)
    values = [e.value.decode() for e in sub.stream(since=0, timeout=1.0)]
    assert values == [f"durable-{i}" for i in range(5)], values


@pytest.mark.parametrize("side", STUBS)
def test_messaging_grpc_service(cluster, side):
    """Publish and Subscribe streams, topic configuration, FindBroker
    and DeleteTopic over gRPC, with either package's stubs."""
    b = _broker(cluster)
    ns = f"g{side}"
    with grpc.insecure_channel(prpc.grpc_address(b.url)) as ch:
        stub = STUBS[side].MessagingStub(ch)
        stub.ConfigureTopic(mpb.ConfigureTopicRequest(
            namespace=ns, topic="t",
            configuration=mpb.TopicConfiguration(partition_count=8)),
            timeout=10)
        got = stub.GetTopicConfiguration(
            mpb.GetTopicConfigurationRequest(namespace=ns, topic="t"),
            timeout=10)
        assert got.configuration.partition_count == 8

        def pubs():
            yield mpb.PublishRequest(init=mpb.PublishRequest.InitMessage(
                namespace=ns, topic="t", partition=0))
            for i in range(5):
                yield mpb.PublishRequest(data=mpb.Message(
                    key=b"k", value=f"v{i}".encode()))

        acks = list(stub.Publish(pubs(), timeout=15))
        assert len(acks) == 5 and all(a.ack_ts_ns > 0 for a in acks)
        assert [a.ack_ts_ns for a in acks] == sorted(a.ack_ts_ns
                                                     for a in acks)
        req_q: "queue_mod.Queue" = queue_mod.Queue()
        req_q.put(mpb.SubscriberMessage(
            init=mpb.SubscriberMessage.InitMessage(
                namespace=ns, topic="t", partition=0,
                start_position=mpb.SubscriberMessage.InitMessage.EARLIEST)))

        def reqs():
            while True:
                item = req_q.get()
                if item is None:
                    return
                yield item

        stream = stub.Subscribe(reqs(), timeout=20)
        values = []
        for msg in stream:
            values.append(msg.data.value)
            if len(values) == 5:
                break
        stream.cancel()
        req_q.put(None)
        assert values == [f"v{i}".encode() for i in range(5)]
        fb = stub.FindBroker(mpb.FindBrokerRequest(
            namespace=ns, topic="t", partition=3), timeout=10)
        assert fb.broker == b.url and list(fb.all_brokers) == [b.url]
        stub.DeleteTopic(mpb.DeleteTopicRequest(namespace=ns, topic="t"),
                         timeout=10)
    assert not [k for k in b.partitions if k[0] == ns]
    assert (ns, "t") not in b.topic_configs


def test_segments_persist_to_filer_and_replay(cluster):
    filer = cluster.filer
    b = _broker(cluster, filer_url=filer.url, register=False)
    pub = pclient.Publisher([b.url], "persist", "events", partition_count=1)
    payload = b"x" * 4096
    # past the 1 MiB flush threshold, then the rest forced out
    pub.publish_many([(f"k{i}".encode(), payload) for i in range(300)])
    for tp in b.partitions.values():
        tp.buffer.flush()
    b.persist.drain()
    status, body = http.get_json(
        f"http://{filer.url}/__meta__/list?dir=/topics/persist/events/0000")
    assert status == 200 and len(body["entries"]) >= 2
    b2 = _broker(cluster, filer_url=filer.url, register=False)
    got = list(pclient.Subscriber([b2.url], "persist", "events",
                                  partition=0).stream(since=0, timeout=2.0))
    assert len(got) == 300 and all(e.value == payload for e in got)


# --- the broker queue and input ---

def _event(path: str, tsns: int) -> MetaEvent:
    return MetaEvent(tsns=tsns, directory=os.path.dirname(path),
                     old_entry=None,
                     new_entry=new_file(path, [FileChunk("1,ab", 0, 3)]))


@pytest.mark.parametrize("queue_side,input_side",
                         [("port", "port"), ("reference", "port"),
                          ("port", "reference")])
def test_broker_queue_to_input(cluster, tmp_path, queue_side, input_side):
    """Filer events through a broker topic: each package's queue feeds
    either package's input, in order, resuming from the saved position."""
    b = _broker(cluster, filer_url=cluster.filer.url, register=False)
    qm = pqueues if queue_side == "port" else rqueues
    im = psub if input_side == "port" else rsub
    topic = f"ev{queue_side}{input_side}"
    q = qm.BrokerQueue([b.url], topic=topic)
    for i in range(4):
        q.notify(_event(f"/data/k{i}", 100 + i))
    if queue_side == "port":
        q.drain()
    pos = str(tmp_path / "broker.pos")
    inp = im.BrokerQueueInput([b.url], topic=topic, position_path=pos)
    got = [e.new_entry.full_path
           for e in im.iter_queue(inp, idle_timeout=0.5)]
    assert got == [f"/data/k{i}" for i in range(4)]
    q.notify(_event("/data/late", 200))
    if queue_side == "port":
        q.drain()
    inp2 = im.BrokerQueueInput([b.url], topic=topic, position_path=pos)
    assert [e.new_entry.full_path
            for e in im.iter_queue(inp2, idle_timeout=0.5)] == ["/data/late"]


def test_broker_input_skips_corrupt_message(cluster):
    b = _broker(cluster)
    q = pqueues.BrokerQueue([b.url], topic="mix", ack="memory")
    q.notify(_event("/data/ok0", 1))
    q.drain()
    pclient.Publisher([b.url], "notifications", "mix",
                      partition_count=1).publish(b"filer", b"{not json")
    q.notify(_event("/data/ok1", 2))
    q.drain()
    inp = psub.BrokerQueueInput([b.url], topic="mix")
    assert [e.new_entry.full_path
            for e in psub.iter_queue(inp, idle_timeout=0.5)] == \
        ["/data/ok0", "/data/ok1"]


def test_registries_accept_broker_sections(cluster):
    b = _broker(cluster)
    n = pqueues.load_notifier(Configuration({"notification": {
        "broker": {"enabled": True, "brokers": b.url, "topic": "reg"}}}))
    assert isinstance(n, pqueues.BrokerQueue)
    inp = psub.load_notification_input(Configuration({"source": {
        "broker": {"enabled": True, "brokers": b.url, "topic": "reg"}}}))
    assert isinstance(inp, psub.BrokerQueueInput)
    n.notify(_event("/reg/a", 5))
    n.drain()
    assert inp.receive(timeout=1.0).new_entry.full_path == "/reg/a"


def _notify_to(fs, q) -> None:
    """Make `q` the filer server's notifier, as its ``notifier=`` does."""
    fs.notifier = q
    fs.filer.meta_log.subscribe(q.notify)


def _put(fs, path: str, data: bytes) -> None:
    req = urllib.request.Request(f"http://{fs.url}{path}", data=data,
                                 method="PUT")
    urllib.request.urlopen(req, timeout=30).close()


def _topic(b, topic: str) -> list:
    sub = pclient.Subscriber([b.url], "notifications", topic)
    return [MetaEvent.from_dict(json.loads(e.value))
            for e in sub.stream(since=0, timeout=0.5)]


def test_broker_queue_skips_the_brokers_own_segments(cluster):
    """A filer whose notifications go to a broker that keeps its
    segments in the same filer: each acknowledged (ack=flush) publish
    writes a segment under /topics while the filer's PUTs wait on their
    events (the queue publishes off the mutation thread), each PUT's
    event is in the topic when the PUT answers, and the segment writes
    (the /topics directory itself included) are not published again
    (ROADMAP Queue 3, D29), so the topic holds the namespace's events
    and stops growing."""
    fs = cluster.add_filer(chunk_size=64 * 1024)
    b = _broker(cluster, filer_url=fs.url, register=False)
    _notify_to(fs, pqueues.BrokerQueue([b.url], topic="self", filer=fs.url))
    for i in range(3):
        _put(fs, f"/data/f{i}.bin", b"x" * (1000 + i))
        assert f"/data/f{i}.bin" in [e.new_entry.full_path
                                     for e in _topic(b, "self")
                                     if e.new_entry]

    events = _topic(b, "self")
    paths = [e.new_entry.full_path for e in events if e.new_entry]
    assert [p for p in paths if p.startswith("/data/f")] == \
        [f"/data/f{i}.bin" for i in range(3)]
    assert not [p for p in paths if p.startswith("/topics")]
    assert not [e for e in events if e.directory.startswith("/topics")]
    status, body = http.get_json(
        f"http://{fs.url}/__meta__/list?dir=/topics/notifications/self/0000")
    assert status == 200 and body["entries"]
    time.sleep(1.0)
    assert len(_topic(b, "self")) == len(events)


def test_filer_write_answers_after_its_event_is_published(cluster):
    """The filer answers a write only once the write's event is on the
    broker, as the reference, which publishes before it answers: a PUT
    whose publish is held does not answer until the publish goes."""
    fs = cluster.add_filer(chunk_size=64 * 1024)
    b = _broker(cluster)
    q = pqueues.BrokerQueue([b.url], topic="held", ack="memory")
    _notify_to(fs, q)
    release = threading.Event()
    orig = q._pub.publish

    def held(key, value):
        release.wait(20)
        return orig(key, value)

    q._pub.publish = held
    answered = threading.Event()
    writer = threading.Thread(target=lambda: (
        _put(fs, "/held/a.bin", b"abc"), answered.set()), daemon=True)
    writer.start()
    try:
        assert not answered.wait(1.0)
        assert fs.filer.find_entry("/held/a.bin") is not None
        assert _topic(b, "held") == []
    finally:
        release.set()
    assert answered.wait(20)
    writer.join(5)
    assert [e.new_entry.full_path for e in _topic(b, "held")
            if e.new_entry] == ["/held", "/held/a.bin"]


@pytest.mark.parametrize("side", ["port", "reference"])
def test_subscriber_sees_a_segment_whose_write_is_in_flight(cluster, side):
    """A message flushed into a segment whose write to the filer has not
    landed yet is in neither the broker's memory nor the filer. The
    port's broker keeps such a segment readable until it lands; the
    reference's subscriber misses it (ROADMAP Queue 3, D31)."""
    from seaweedfs_tpu.messaging import broker as rbroker
    if side == "port":
        b = _broker(cluster, filer_url=cluster.filer.url, register=False)
    else:
        sock = http.listen_socket("127.0.0.1", 0)
        b = rbroker.BrokerServer(
            filer_url=cluster.filer.url,
            advertise_url=f"127.0.0.1:{sock.getsockname()[1]}")
        b.url = b.advertise_url
        cluster.brokers.append(cluster.call(http.start_app(b.app, sock)))
    pub = CLIENTS[side].Publisher([b.url], "inflight", side,
                                  partition_count=1)
    pub.publish(b"k", b"first")
    pub.publish(b"k", b"second")
    release = threading.Event()
    orig = b.persist._write_segment_sync

    def held(dir_path, segment):
        release.wait(10)
        return orig(dir_path, segment)

    b.persist._write_segment_sync = held
    try:
        for tp in list(b.partitions.values()):
            tp.buffer.flush()
        got = [e.value for e in CLIENTS[side].Subscriber(
            [b.url], "inflight", side).stream(since=0, timeout=1.0)]
    finally:
        release.set()
        b.persist._write_segment_sync = orig
    assert got == ([b"first", b"second"] if side == "port" else [])
    b.persist.drain()
    assert [e.value for e in CLIENTS[side].Subscriber(
        [b.url], "inflight", side).stream(since=0, timeout=1.0)] == \
        [b"first", b"second"]
