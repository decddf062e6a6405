"""Queue-fed replication inputs (weed/replication/sub/notifications.go).

The port's reduced copy of seaweedfs_tpu/replication/sub.py. `weed
filer.replicate` consumes filer events from a message queue that the
source filer's notification layer feeds. ``FileQueueInput`` tails the
notification ``FileQueue`` spool directory (notification/queues.py
writes it) with a persisted (file, offset) position: the durable local
queue. It keeps the reference's NotificationInput contract: receive()
blocks up to a timeout and returns the next MetaEvent (or None), and
ack() persists the consume position.

``BrokerQueueInput`` (``[source.broker]``) consumes the topic that
notification.queues.BrokerQueue publishes to, resuming after the last
acknowledged message's offset, a batch a subscribe stream;
``KafkaQueueInput`` (``[source.kafka]``) fetches from a Kafka topic, resuming at the next offset. Both persist
the position at ``position_path`` on ack(), and both skip (and log) a
message that does not decode, going on to the next one.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Iterator, Optional

from ..filer.filer import MetaEvent
from ..utils import durable

log = logging.getLogger("replication.sub")


class NotificationInput:
    name = "base"

    def receive(self, timeout: float = 1.0) -> Optional[MetaEvent]:
        raise NotImplementedError

    def ack(self) -> None:
        """Persist the consume position of the last received event."""

    def close(self) -> None:
        pass


class FileQueueInput(NotificationInput):
    """Tail the FileQueue spool: dated ndjson files consumed in order."""

    name = "file"

    def __init__(self, directory: str, position_path: str = ""):
        self.directory = directory
        self.position_path = position_path or os.path.join(
            directory, ".consumer_position")
        self._file = ""
        self._offset = 0
        self._load_position()

    def _load_position(self) -> None:
        try:
            with open(self.position_path, encoding="utf-8") as f:
                d = json.load(f)
            self._file, self._offset = d.get("file", ""), d.get("offset", 0)
        except (OSError, ValueError):
            pass

    def ack(self) -> None:
        # durable: a position that rolls back after power loss re-applies
        # events (safe but wasteful); a torn position file would read as
        # {} and restart from the epoch
        durable.write_json_atomic(
            self.position_path,
            {"file": self._file, "offset": self._offset})

    def _spool_files(self) -> list[str]:
        try:
            return sorted(n for n in os.listdir(self.directory)
                          if n.startswith("events-")
                          and n.endswith(".ndjson"))
        except OSError:
            return []

    def receive(self, timeout: float = 1.0) -> Optional[MetaEvent]:
        deadline = time.monotonic() + timeout
        while True:
            ev = self._try_read()
            if ev is not None:
                return ev
            if time.monotonic() >= deadline:
                return None
            time.sleep(min(0.1, timeout))

    def _try_read(self) -> Optional[MetaEvent]:
        files = self._spool_files()
        if not files:
            return None
        if self._file not in files:
            # position file ahead of retention or first run: start at the
            # earliest spool file after the recorded one
            later = [n for n in files if n > self._file]
            self._file = later[0] if later else files[0]
            self._offset = 0
        while True:
            path = os.path.join(self.directory, self._file)
            try:
                with open(path, encoding="utf-8") as f:
                    f.seek(self._offset)
                    line = f.readline()
            except OSError:
                return None
            if line.endswith("\n"):
                self._offset += len(line.encode("utf-8"))
                line = line.strip()
                if not line:
                    continue
                try:
                    return MetaEvent.from_dict(json.loads(line))
                except Exception:
                    continue
            # tail of the current file: move on if a newer file exists
            later = [n for n in self._spool_files() if n > self._file]
            if not later:
                return None
            self._file, self._offset = later[0], 0


class BrokerQueueInput(NotificationInput):
    """Consume filer events from a messaging-broker topic."""

    name = "broker"

    def __init__(self, brokers: list[str], namespace: str = "notifications",
                 topic: str = "filer", partition: int = 0,
                 position_path: str = ""):
        from ..messaging.client import Subscriber
        self.position_path = position_path
        self._since = 0
        if position_path and os.path.exists(position_path):
            try:
                with open(position_path, encoding="utf-8") as f:
                    self._since = json.load(f).get("since", 0)
            except (OSError, ValueError):
                pass
        self._sub = Subscriber(brokers, namespace, topic,
                               partition=partition)
        self._pending: list = []

    # messages read ahead from one subscribe stream, at most
    READ_AHEAD = 4096

    def receive(self, timeout: float = 1.0) -> Optional[MetaEvent]:
        while True:
            if not self._pending:
                # one stream a batch, read until it idles `timeout`: each
                # stream replays the partition's persisted segments since
                # the position, so the reference's stream a message reads
                # them again for every message (ROADMAP Queue 3, D30)
                for entry in self._sub.stream(since=self._since,
                                              timeout=timeout):
                    self._pending.append(entry)
                    if len(self._pending) >= self.READ_AHEAD:
                        break
            if not self._pending:
                return None
            entry = self._pending.pop(0)
            self._since = entry.ts_ns
            try:
                return MetaEvent.from_dict(json.loads(entry.value.decode()))
            except Exception:
                # a dropped message is not "caught up": go on past it
                log.warning("broker input: dropping corrupt message at "
                            "ts %d", entry.ts_ns)

    def ack(self) -> None:
        if self.position_path:
            durable.write_json_atomic(self.position_path,
                                      {"since": self._since})


class KafkaQueueInput(NotificationInput):
    """Consume filer events from a Kafka topic over the wire protocol
    (weed/replication/sub/notification_kafka.go:22-117), the resume
    offset persisted in a progress file."""

    name = "kafka"

    def __init__(self, bootstrap: str, topic: str = "seaweedfs_filer",
                 partition: int = 0, position_path: str = ""):
        from ..messaging.kafka_wire import KafkaClient
        self._client = KafkaClient.from_addr(bootstrap)
        self.topic = topic
        self.partition = partition
        self.position_path = position_path
        self._offset = 0
        if position_path and os.path.exists(position_path):
            try:
                with open(position_path, encoding="utf-8") as f:
                    self._offset = json.load(f).get("offset", 0)
            except (OSError, ValueError):
                pass
        self._pending: list = []

    def receive(self, timeout: float = 1.0) -> Optional[MetaEvent]:
        # a corrupt message is skipped, never taken for "caught up": a
        # batch the drop emptied fetches again, so None still means idle
        while True:
            if not self._pending:
                try:
                    self._pending = self._client.fetch(
                        self.topic, self.partition, self._offset,
                        max_wait_ms=int(timeout * 1000))
                except Exception:
                    return None
                if not self._pending:
                    return None
            while self._pending:
                offset, _key, value = self._pending.pop(0)
                self._offset = offset + 1
                try:
                    return MetaEvent.from_dict(
                        json.loads((value or b"").decode()))
                except Exception:
                    log.warning("kafka input: dropping corrupt message "
                                "at %s/%d offset %d", self.topic,
                                self.partition, offset)

    def ack(self) -> None:
        if self.position_path:
            durable.write_json_atomic(self.position_path,
                                      {"offset": self._offset})

    def close(self) -> None:
        self._client.close()


def iter_queue(inp: NotificationInput, idle_timeout: float = 1.0,
               stop_check=None) -> Iterator[MetaEvent]:
    """Drain an input until it idles past idle_timeout (or stop_check)."""
    while True:
        if stop_check is not None and stop_check():
            return
        ev = inp.receive(timeout=idle_timeout)
        if ev is None:
            return
        yield ev
        inp.ack()


def load_notification_input(cfg) -> Optional[NotificationInput]:
    """Build the input from replication.toml's [source.*] section
    (the reference reads the notification config for the same purpose)."""
    if cfg.get_bool("source.file.enabled", False):
        return FileQueueInput(
            cfg.get_string("source.file.directory", "./filer_events"),
            cfg.get_string("source.file.position_path", ""))
    if cfg.get_bool("source.broker.enabled", False):
        return BrokerQueueInput(
            [b for b in cfg.get_string("source.broker.brokers",
                                       "").split(",") if b],
            namespace=cfg.get_string("source.broker.namespace",
                                     "notifications"),
            topic=cfg.get_string("source.broker.topic", "filer"),
            partition=cfg.get_int("source.broker.partition", 0),
            position_path=cfg.get_string("source.broker.position_path", ""))
    if cfg.get_bool("source.kafka.enabled", False):
        return KafkaQueueInput(
            cfg.get_string("source.kafka.hosts",
                           "127.0.0.1:9092").split(",")[0],
            topic=cfg.get_string("source.kafka.topic", "seaweedfs_filer"),
            partition=cfg.get_int("source.kafka.partition", 0),
            position_path=cfg.get_string("source.kafka.position_path", ""))
    return None
