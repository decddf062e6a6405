"""Notification queue implementations (weed/notification/configuration.go).

The port's reduced copy of seaweedfs_tpu/notification/queues.py. The
interface is one method, ``notify(event)``, invoked synchronously from
the filer's meta log fanout. Queues are registered by name like the
reference's side-effect-imported queue plugins.

``BrokerQueue`` (``[notification.broker]``) publishes every event to a
topic of the messaging broker (messaging/), one partition, acknowledged
once the broker has flushed it to the filer by default; ``KafkaQueue``
(``[notification.kafka]``) produces it to a Kafka topic over the wire
client (messaging/kafka_wire.py), keyed by the entry's path.
``load_notifier`` answers an enabled ``aws_sqs``, ``google_pub_sub`` or
``gocdk`` section with the reference's ``_broker_stub`` error.
"""

from __future__ import annotations

import concurrent.futures
import json
import logging
import os
import queue as queue_mod
import threading
import time
import urllib.request
from typing import Optional

from ..utils import retry

log = logging.getLogger("notification")


class LogQueue:
    """Log every event (notification.log in the reference)."""

    def notify(self, event) -> None:
        log.info("filer event: %s", json.dumps(event.to_dict()))


class FileQueue:
    """Append events as ndjson into dated spool files under a directory.

    A durable local queue: cross-cluster replication (`filer.replicate
    -from_queue`) consumes these files the way the reference consumes
    Kafka topics (weed/replication/sub/).
    """

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._f = None
        self._day = ""

    def _file(self):
        day = time.strftime("%Y-%m-%d")
        if self._f is None or day != self._day:
            if self._f:
                self._f.close()
            self._day = day
            self._f = open(os.path.join(self.directory, f"events-{day}.ndjson"),
                           "a", encoding="utf-8")
        return self._f

    def notify(self, event) -> None:
        with self._lock:
            f = self._file()
            f.write(json.dumps(event.to_dict(), separators=(",", ":")) + "\n")
            f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f:
                self._f.close()
                self._f = None


class WebhookQueue:
    """POST every event as JSON to an HTTP endpoint: any consumer with a
    URL receives the filer event stream.

    Delivery runs on a background worker so a slow or dead endpoint never
    blocks filer mutations. Failed posts append to an ndjson spool file
    for out-of-band replay (nothing replays it automatically); with a
    bounded in-memory queue, overflow events go straight to the spool.
    """

    def __init__(self, url: str, spool_path: str = "",
                 timeout: float = 10.0, queue_size: int = 4096):
        self.url = url
        self.timeout = timeout
        self.spool_path = spool_path
        self._lock = threading.Lock()
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=queue_size)
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()

    def notify(self, event) -> None:
        body = json.dumps(event.to_dict()).encode()
        try:
            self._q.put_nowait(body)
        except queue_mod.Full:
            self._spool(body)

    def _drain(self) -> None:
        while True:
            body = self._q.get()
            req = urllib.request.Request(
                self.url, data=body, method="POST",
                headers={"Content-Type": "application/json"})
            try:
                # an external endpoint: the ambient budget bounds the
                # socket, the cluster's deadline header is not sent
                urllib.request.urlopen(
                    req, timeout=retry.cap_timeout(self.timeout)).close()
            except Exception as e:
                log.warning("webhook notify %s failed: %s", self.url, e)
                self._spool(body)

    def _spool(self, body: bytes) -> None:
        if not self.spool_path:
            return
        with self._lock, open(self.spool_path, "a",
                              encoding="utf-8") as f:
            f.write(body.decode() + "\n")


# the broker keeps its topics' segments in the filer under this tree
BROKER_TOPICS_DIR = "/topics"


def _under_topics(path: str) -> bool:
    return path == BROKER_TOPICS_DIR or \
        path.startswith(BROKER_TOPICS_DIR + "/")


class BrokerQueue:
    """Publish every filer event to a messaging-broker topic, the
    Kafka-class outbound queue (weed/notification/kafka); replicators
    consume it with replication.sub.BrokerQueueInput.

    The events go out in order from one worker thread, and the filer
    server answers a write only once the write's events are published
    (``run``, awaited by ``FilerServer._exec``), as the reference, which
    publishes before it answers. The publish is not made on the filer's
    mutation thread: that thread may hold the namespace lock, and an
    ``ack=flush`` publish to a broker that keeps its segments in this
    filer waits for the segment's PUT, which needs the lock and a free
    executor thread of the filer. The events of the broker's own segment
    tree (``/topics`` and below) are not published, or each segment
    write would be a new message whose flush writes the next segment
    (upstream's filer skips its own log tree so,
    weed/filer/filer_notify.go). ROADMAP Queue 3, D29."""

    def __init__(self, brokers: list, namespace: str = "notifications",
                 topic: str = "filer", filer: str = "",
                 ack: str = "flush"):
        from ..messaging.client import Publisher
        # one partition: the filer's events are one ordered stream
        self._pub = Publisher(brokers, namespace, topic,
                              partition_count=1, filer=filer, ack=ack)
        # (body, future) in notify order; a write's answer waits on its
        # events, so the backlog is the writes in flight
        self._q: queue_mod.Queue = queue_mod.Queue()
        self._lock = threading.Lock()
        self._last = None
        # the future of the newest event a thread notified
        self._local = threading.local()
        self._worker = threading.Thread(target=self._publish, daemon=True,
                                        name="broker-queue")
        self._worker.start()

    def notify(self, event) -> None:
        paths = [event.directory] + [e.full_path for e in (
            event.old_entry, event.new_entry) if e is not None]
        if any(_under_topics(p) for p in paths):
            return
        body = json.dumps(event.to_dict(), separators=(",", ":")).encode()
        done = concurrent.futures.Future()
        with self._lock:
            self._q.put((body, done))
            self._last = done
        self._local.last = done

    def run(self, fn):
        """``fn()`` on this thread; returns its result and a future that
        is done once every event it notified was published (None when it
        notified none)."""
        self._local.last = None
        result = fn()
        return result, self._local.last

    def _publish(self) -> None:
        while True:
            body, done = self._q.get()
            try:
                self._pub.publish(b"filer", body)
            except Exception as e:
                # as the reference: the write stands, the event is logged
                log.warning("broker notify failed: %s", e)
            done.set_result(None)

    def drain(self) -> None:
        """Block until every event notified so far was published (or
        failed)."""
        with self._lock:
            last = self._last
        if last is not None:
            last.result()


class KafkaQueue:
    """Produce every filer event to a Kafka topic over the wire protocol
    (weed/notification/kafka/kafka_queue.go:1-70: the event's path is the
    message key)."""

    def __init__(self, bootstrap: str, topic: str = "seaweedfs_filer",
                 partition: int = 0):
        from ..messaging.kafka_wire import KafkaClient, KafkaError
        self._client = KafkaClient.from_addr(bootstrap)
        self.topic = topic
        self.partition = partition
        # a missing topic or broker shows when the queue is configured,
        # as the reference's NewSyncProducer shows it
        md = self._client.metadata([topic])
        terr = md["topics"].get(topic, {}).get("error", 0)
        if terr:
            raise KafkaError(terr, f"topic {topic}")

    def notify(self, event) -> None:
        d = event.to_dict()
        # the key is the entry's path: one entry's events keep their
        # order on a partitioned topic
        key = ((d.get("new") or d.get("old") or {}).get("path")
               or d.get("directory", "")).encode()
        body = json.dumps(d, separators=(",", ":")).encode()
        try:
            self._client.produce(self.topic, self.partition, key, body)
        except Exception as e:
            log.warning("kafka notify failed: %s", e)

    def close(self) -> None:
        self._client.close()


QUEUES = {
    "log": lambda cfg: LogQueue(),
    "kafka": lambda cfg: KafkaQueue(
        cfg.get_string("hosts", "127.0.0.1:9092").split(",")[0],
        topic=cfg.get_string("topic", "seaweedfs_filer")),
    "file": lambda cfg: FileQueue(cfg.get_string("directory",
                                                 "./notifications")),
    "webhook": lambda cfg: WebhookQueue(
        cfg.get_string("url", ""),
        cfg.get_string("spool", "")),
    "broker": lambda cfg: BrokerQueue(
        [b for b in cfg.get_string("brokers", "").split(",") if b],
        namespace=cfg.get_string("namespace", "notifications"),
        topic=cfg.get_string("topic", "filer"),
        filer=cfg.get_string("filer", "")),
}


def _broker_stub(name: str):
    raise RuntimeError(
        f"notification queue {name!r} needs its broker SDK, which this "
        "image does not ship; use 'webhook' or 'file' instead")


def load_notifier(config) -> Optional[object]:
    """First enabled [notification.<name>] section wins
    (weed/notification/configuration.go LoadConfiguration)."""
    section = config.section("notification")
    for name in section.keys():
        sub = section.section(name)
        if not sub.get_bool("enabled"):
            continue
        if name in QUEUES:
            return QUEUES[name](sub)
        if name in ("aws_sqs", "google_pub_sub", "gocdk"):
            _broker_stub(name)
    return None
