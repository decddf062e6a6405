"""Notification queue implementations (weed/notification/configuration.go).

The port's reduced copy of seaweedfs_tpu/notification/queues.py. The
interface is one method, ``notify(event)``, invoked synchronously from
the filer's meta log fanout. Queues are registered by name like the
reference's side-effect-imported queue plugins.

Left out, with their later home: ``BrokerQueue`` and ``KafkaQueue`` (the
``broker`` and ``kafka`` sections), which publish through ``messaging/``
(ROADMAP Queue 1 A.8b). Until then ``load_notifier`` answers an enabled
``broker`` or ``kafka`` section, as it answers ``aws_sqs``,
``google_pub_sub`` and ``gocdk``, with the reference's ``_broker_stub``
error.
"""

from __future__ import annotations

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


QUEUES = {
    "log": lambda cfg: LogQueue(),
    "file": lambda cfg: FileQueue(cfg.get_string("directory",
                                                 "./notifications")),
    "webhook": lambda cfg: WebhookQueue(
        cfg.get_string("url", ""),
        cfg.get_string("spool", "")),
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
        if name in ("broker", "kafka", "aws_sqs", "google_pub_sub",
                    "gocdk"):
            _broker_stub(name)
    return None
