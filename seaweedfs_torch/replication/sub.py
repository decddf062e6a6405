"""Queue-fed replication inputs (weed/replication/sub/notifications.go).

The port's reduced copy of seaweedfs_tpu/replication/sub.py. `weed
filer.replicate` consumes filer events from a message queue that the
source filer's notification layer feeds. ``FileQueueInput`` tails the
notification ``FileQueue`` spool directory (notification/queues.py
writes it) with a persisted (file, offset) position: the durable local
queue. It keeps the reference's NotificationInput contract: receive()
blocks up to a timeout and returns the next MetaEvent (or None), and
ack() persists the consume position.

Left out, with their later home: ``BrokerQueueInput`` and
``KafkaQueueInput`` (``[source.broker]`` and ``[source.kafka]``), which
consume through ``messaging/`` (ROADMAP Queue 1 A.8b);
``load_notification_input`` refuses those sections until then.
"""

from __future__ import annotations

import json
import os
import time
from typing import Iterator, Optional

from ..filer.filer import MetaEvent
from ..utils import durable


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
    for name in ("broker", "kafka"):
        if cfg.get_bool(f"source.{name}.enabled", False):
            raise RuntimeError(
                f"replication source {name!r} consumes through the "
                "messaging broker, which this package does not have yet; "
                "use [source.file]")
    return None
