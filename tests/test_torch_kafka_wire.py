"""The port's Kafka wire client, in-repo broker, queue and input against
the reference's.

Modelled on tests/test_kafka_wire.py: the v0 MessageSet codec (bytes
equal to the reference's), Produce / Fetch / Metadata, acks=0, a topic
refused when the queue is configured, KafkaQueue -> KafkaQueueInput with
a saved position, the message key, a broker restart under a consumer,
the registries, a negative fetch offset (OFFSET_OUT_OF_RANGE) and a
corrupt message skipped rather than taken for "caught up". Each wire
test runs every pairing of the two packages' clients and brokers, and
the queue tests every pairing of queue and input.
"""

import json
import os
import struct

import numpy as np
import pytest

from seaweedfs_torch.filer.chunks import FileChunk
from seaweedfs_torch.filer.entry import new_file
from seaweedfs_torch.filer.filer import MetaEvent
from seaweedfs_torch.messaging import fake_kafka as pfake
from seaweedfs_torch.messaging import kafka_wire as pwire
from seaweedfs_torch.notification import queues as pqueues
from seaweedfs_torch.replication import sub as psub
from seaweedfs_torch.utils.config import Configuration
from seaweedfs_tpu.messaging import fake_kafka as rfake
from seaweedfs_tpu.messaging import kafka_wire as rwire
from seaweedfs_tpu.notification import queues as rqueues
from seaweedfs_tpu.replication import sub as rsub

WIRES = {"port": pwire, "reference": rwire}
FAKES = {"port": pfake, "reference": rfake}
PAIRS = [(c, s) for c in WIRES for s in FAKES]
QUEUES = {"port": (pqueues, psub), "reference": (rqueues, rsub)}


@pytest.fixture(params=PAIRS, ids=[f"{c}-on-{s}" for c, s in PAIRS])
def wire(request):
    """(client module, broker) for one pairing of the packages."""
    client_side, server_side = request.param
    b = FAKES[server_side].FakeKafkaServer()
    yield WIRES[client_side], b
    b.close()


@pytest.fixture(params=["port", "reference"])
def broker(request):
    b = FAKES[request.param].FakeKafkaServer()
    yield b
    b.close()


def _event(path: str, tsns: int) -> MetaEvent:
    return MetaEvent(tsns=tsns, directory=os.path.dirname(path),
                     old_entry=None,
                     new_entry=new_file(path, [FileChunk("1,ab", 0, 3)]))


def test_message_codec_matches_reference():
    rng = np.random.default_rng(4)
    for _ in range(30):
        key = None if rng.integers(3) == 0 else rng.bytes(
            int(rng.integers(0, 20)))
        value = rng.bytes(int(rng.integers(0, 300)))
        assert pwire.encode_message(key, value) == \
            rwire.encode_message(key, value)
    m1, m2 = pwire.encode_message(b"k1", b"v1"), pwire.encode_message(
        None, b"v2")
    raw = (struct.pack(">qi", 5, len(m1) - 12) + m1[12:]
           + struct.pack(">qi", 6, len(m2) - 12) + m2[12:])
    assert pwire.decode_message_set(raw) == rwire.decode_message_set(raw) \
        == [(5, b"k1", b"v1"), (6, None, b"v2")]
    bad = bytearray(raw)
    bad[-1] ^= 0xFF
    with pytest.raises(pwire.KafkaError):
        pwire.decode_message_set(bytes(bad))
    assert pwire.decode_message_set(raw[:-3]) == [(5, b"k1", b"v1")]


def test_produce_fetch_metadata(wire):
    m, b = wire
    c = m.KafkaClient(b.host, b.port)
    assert c.produce("t1", 0, b"a", b"hello") == 0
    assert c.produce("t1", 0, b"b", b"world") == 1
    md = c.metadata(["t1"])
    assert md["topics"]["t1"]["error"] == 0
    assert 0 in md["topics"]["t1"]["partitions"]
    got = c.fetch("t1", 0, 0)
    assert [(o, v) for o, _k, v in got] == [(0, b"hello"), (1, b"world")]
    assert [v for _o, _k, v in c.fetch("t1", 0, 1)] == [b"world"]
    assert c.fetch("t1", 0, 2) == []
    one = c.fetch("t1", 0, 0, max_bytes=10)
    assert len(one) == 1 and one[0][2] == b"hello"
    c.close()


def test_produce_acks0_fire_and_forget(wire):
    m, b = wire
    c = m.KafkaClient(b.host, b.port, timeout=3.0)
    assert c.produce("ff", 0, None, b"quiet", acks=0) == -1
    assert c.produce("ff", 0, None, b"loud", acks=1) == 1
    assert [v for _o, _k, v in c.fetch("ff", 0, 0)] == [b"quiet", b"loud"]
    c.close()


def test_fetch_negative_offset_is_out_of_range(wire):
    """The -1 "latest" sentinel answers OFFSET_OUT_OF_RANGE (1), never
    messages under wrong offsets."""
    m, b = wire
    c = m.KafkaClient(b.host, b.port)
    c.produce("neg", 0, None, b"m0")
    c.produce("neg", 0, None, b"m1")
    with pytest.raises(m.KafkaError) as e:
        c.fetch("neg", 0, -1)
    assert e.value.code == 1
    assert [v for _o, _k, v in c.fetch("neg", 0, 0)] == [b"m0", b"m1"]
    c.close()


def test_unknown_topic_rejected_at_configure_time():
    for fake in FAKES.values():
        b = fake.FakeKafkaServer(auto_create=False)
        try:
            with pytest.raises(pwire.KafkaError):
                pqueues.KafkaQueue(b.addr, topic="never_created")
        finally:
            b.close()


@pytest.mark.parametrize("queue_side,input_side",
                         [("port", "port"), ("reference", "port"),
                          ("port", "reference")])
def test_notification_queue_to_input(broker, tmp_path, queue_side,
                                     input_side):
    qm, im = QUEUES[queue_side][0], QUEUES[input_side][1]
    q = qm.KafkaQueue(broker.addr, topic="swfs_events")
    for i in range(4):
        q.notify(_event(f"/data/k{i}", 100 + i))
    q.close()
    pos = str(tmp_path / "kafka.pos")
    inp = im.KafkaQueueInput(broker.addr, topic="swfs_events",
                             position_path=pos)
    got = [e.new_entry.full_path
           for e in im.iter_queue(inp, idle_timeout=0.2)]
    assert got == [f"/data/k{i}" for i in range(4)]
    inp.close()
    q2 = qm.KafkaQueue(broker.addr, topic="swfs_events")
    q2.notify(_event("/data/late", 200))
    q2.close()
    inp2 = im.KafkaQueueInput(broker.addr, topic="swfs_events",
                              position_path=pos)
    assert [e.new_entry.full_path
            for e in im.iter_queue(inp2, idle_timeout=0.2)] == ["/data/late"]
    inp2.close()


def test_kafka_message_key_is_entry_path(broker):
    q = pqueues.KafkaQueue(broker.addr, topic="keyed")
    q.notify(_event("/buckets/b/obj.txt", 1))
    q.close()
    c = pwire.KafkaClient(broker.host, broker.port)
    [(off, key, value)] = c.fetch("keyed", 0, 0)
    assert off == 0 and key == b"/buckets/b/obj.txt"
    assert json.loads(value)["directory"] == "/buckets/b"
    c.close()


@pytest.mark.parametrize("side", FAKES)
def test_client_survives_broker_restart(tmp_path, side):
    """After a broker restart on the same port the consumer reconnects
    and resumes from its saved offset (notification_kafka.go's progress
    file)."""
    fake = FAKES[side]
    b = fake.FakeKafkaServer()
    port = b.port
    q = pqueues.KafkaQueue(b.addr, topic="restart_t")
    q.notify(_event("/r/a", 1))
    q.notify(_event("/r/b", 2))
    q.close()
    pos = str(tmp_path / "pos")
    inp = psub.KafkaQueueInput(b.addr, topic="restart_t", position_path=pos)
    assert inp.receive(timeout=0.5).new_entry.full_path == "/r/a"
    inp.ack()
    b.kill()
    # what was fetched already drains, then the receive fails cleanly
    assert inp.receive(timeout=0.3).new_entry.full_path == "/r/b"
    inp.ack()
    assert inp.receive(timeout=0.3) is None
    b2 = fake.FakeKafkaServer(port=port)
    b2.topics["restart_t"] = list(b.topics["restart_t"])
    q2 = pqueues.KafkaQueue(b2.addr, topic="restart_t")
    q2.notify(_event("/r/c", 3))
    q2.close()
    try:
        ev = inp.receive(timeout=1.0)
        assert ev is not None and ev.new_entry.full_path == "/r/c"
        inp.ack()
        with open(pos) as f:
            assert json.load(f)["offset"] == 3
    finally:
        inp.close()
        b2.close()


def test_registries_accept_kafka(broker, tmp_path):
    n = pqueues.load_notifier(Configuration({"notification": {"kafka": {
        "enabled": True, "hosts": broker.addr, "topic": "regtest"}}}))
    assert isinstance(n, pqueues.KafkaQueue)
    n.notify(_event("/r/x", 5))
    n.close()
    inp = psub.load_notification_input(Configuration({"source": {"kafka": {
        "enabled": True, "hosts": broker.addr, "topic": "regtest",
        "position_path": str(tmp_path / "p")}}}))
    assert isinstance(inp, psub.KafkaQueueInput)
    ev = inp.receive(timeout=0.5)
    assert ev is not None and ev.new_entry.full_path == "/r/x"
    inp.close()


@pytest.mark.parametrize("input_side", ["port", "reference"])
def test_kafka_input_skips_corrupt_message(broker, input_side):
    """A message that does not decode is dropped and logged, never taken
    for "caught up": receive() goes on to the next one."""
    im = QUEUES[input_side][1]
    c = pwire.KafkaClient(broker.host, broker.port)
    q = pqueues.KafkaQueue(broker.addr, topic="corrupt_mix")
    q.notify(_event("/data/ok0", 1))
    c.produce("corrupt_mix", 0, None, b"{not json")
    q.notify(_event("/data/ok1", 2))
    c.produce("corrupt_mix", 0, None, b"\xff\xfe")
    q.close()
    c.close()
    inp = im.KafkaQueueInput(broker.addr, topic="corrupt_mix")
    assert [e.new_entry.full_path
            for e in im.iter_queue(inp, idle_timeout=0.2)] == \
        ["/data/ok0", "/data/ok1"]
    inp.close()
