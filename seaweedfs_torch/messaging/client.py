"""Messaging client: Publisher / Subscriber over the broker's HTTP API.

The port's copy of seaweedfs_tpu/messaging/client.py.

Mirrors weed/messaging/msgclient: messages are keyed; the partition is
picked by hashing the key over the topic's partition count, and the broker
for a partition is picked from the broker list by consistent hashing
(broker/consistent_distribution.go — here a rendezvous hash, same
stability property: adding/removing a broker only moves its own share).
"""

from __future__ import annotations

import hashlib
import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Iterator, Optional

from ..utils import retry
from ..utils.log_buffer import LogEntry


def _hash(*parts: str) -> int:
    h = hashlib.md5("/".join(parts).encode()).digest()
    return int.from_bytes(h[:8], "big")


def pick_partition(key: bytes, partition_count: int) -> int:
    if partition_count <= 1:
        return 0
    return int.from_bytes(hashlib.md5(key).digest()[:8], "big") \
        % partition_count


def pick_broker(brokers: list[str], ns: str, topic: str,
                partition: int) -> str:
    """Rendezvous (highest-random-weight) hashing over the broker list."""
    if not brokers:
        raise ValueError("no brokers")
    return max(brokers,
               key=lambda b: _hash(b, ns, topic, str(partition)))


class Publisher:
    def __init__(self, brokers: list[str], namespace: str, topic: str,
                 partition_count: int = 4, filer: str = "",
                 ack: str = "memory"):
        """filer: when set, the broker list is (re)discovered from the
        filer registry — dead brokers drop out when their KeepConnected
        stream breaks, so publishes fail over to the new owner.
        ack: "memory" (default, reference posture) or "flush" (segment
        persisted to the filer before the ack returns)."""
        self.brokers = brokers
        self.ns = namespace
        self.topic = topic
        self.partition_count = partition_count
        self.filer = filer
        self.ack = ack
        if filer and not brokers:
            self.refresh_brokers()

    def refresh_brokers(self) -> None:
        if not self.filer:
            return
        try:
            req = urllib.request.Request(
                f"http://{self.filer}/__meta__/brokers",
                headers=retry.inject_deadline({}))
            with urllib.request.urlopen(
                    req, timeout=retry.cap_timeout(10)) as r:
                brokers = json.load(r).get("brokers", [])
            if brokers:
                self.brokers = brokers
        except OSError:
            pass

    def _post(self, broker: str, p: int, body: bytes) -> dict:
        """POST with manual 307 handling (urllib won't re-POST) — the
        broker redirects to the partition's owner."""
        url = (f"http://{broker}/publish/{self.ns}/{self.topic}/{p}"
               f"?ack={self.ack}")
        for _ in range(3):
            req = urllib.request.Request(
                url, data=body, method="POST",
                headers=retry.inject_deadline(
                    {"Content-Type": "application/x-ndjson"}))
            try:
                with urllib.request.urlopen(
                        req, timeout=retry.cap_timeout(60)) as r:
                    return json.load(r)
            except urllib.error.HTTPError as err:
                if err.code in (301, 302, 307, 308):
                    url = err.headers["Location"]
                    continue
                raise
        raise OSError("too many broker redirects")

    def _post_with_failover(self, p: int, body: bytes) -> dict:
        """POST to the partition's owner; with a filer configured, a
        dead or missing broker triggers registry rediscovery and retry
        against the re-converged owner."""
        attempts = 4 if self.filer else 1
        last_err: Exception = OSError("no brokers")
        for attempt in range(attempts):
            try:
                if not self.brokers:
                    raise ValueError("no brokers known yet")
                broker = pick_broker(self.brokers, self.ns, self.topic, p)
                return self._post(broker, p, body)
            except urllib.error.HTTPError:
                raise
            except (OSError, ValueError) as err:
                last_err = err
                if self.filer:
                    import time as _time
                    _time.sleep(0.5 * (attempt + 1))
                    self.refresh_brokers()
        raise last_err

    def publish(self, key: bytes, value: bytes,
                headers: Optional[dict] = None) -> int:
        """Send one message; returns its broker-assigned timestamp
        offset."""
        p = pick_partition(key, self.partition_count)
        e = LogEntry(0, key, value, headers or {})
        body = json.dumps(e.to_dict(), separators=(",", ":")).encode() + b"\n"
        return self._post_with_failover(p, body)["last_ts"]

    def publish_many(self, messages: list[tuple[bytes, bytes]]) -> int:
        """Batch publish; groups by partition. Returns count."""
        groups: dict[int, list[LogEntry]] = {}
        for key, value in messages:
            groups.setdefault(pick_partition(key, self.partition_count),
                              []).append(LogEntry(0, key, value, {}))
        n = 0
        for p, entries in groups.items():
            body = b"".join(
                json.dumps(e.to_dict(), separators=(",", ":")).encode()
                + b"\n" for e in entries)
            n += self._post_with_failover(p, body)["published"]
        return n


class Subscriber:
    def __init__(self, brokers: list[str], namespace: str, topic: str,
                 partition: int = 0):
        self.brokers = brokers
        self.ns = namespace
        self.topic = topic
        self.partition = partition

    def stream(self, since: int = 0,
               timeout: Optional[float] = None) -> Iterator[LogEntry]:
        """Replay messages after `since`, then tail live. With a timeout
        the iterator stops at the first idle gap (bounded consumption)."""
        broker = pick_broker(self.brokers, self.ns, self.topic,
                             self.partition)
        url = (f"http://{broker}/subscribe/{self.ns}/{self.topic}/"
               f"{self.partition}?"
               + urllib.parse.urlencode({"since": str(since)}))
        try:
            req = urllib.request.Request(
                url, headers=retry.inject_deadline({}))
            with urllib.request.urlopen(req, timeout=timeout) as r:
                for line in r:
                    line = line.strip()
                    if not line:
                        continue
                    yield LogEntry.from_dict(json.loads(line))
        except TimeoutError:
            return
        except OSError as e:  # socket timeout surfaces as URLError too
            if "timed out" in str(e):
                return
            raise

    def consume(self, handler: Callable[[LogEntry], None],
                since: int = 0) -> None:
        for e in self.stream(since):
            handler(e)


class PubChannel:
    """Channel-style publish wrapper (msgclient/chan_pub.go:15-75): a
    named channel is the topic ("chan" namespace, partition 0); put()
    enqueues without blocking on the broker, a background thread drains
    the queue in batches, and close() flushes before returning. The
    running digest mirrors chan_pub's md5 so both ends can compare."""

    def __init__(self, brokers: list[str], chan_name: str,
                 filer: str = "", ack: str = "memory"):
        import hashlib
        import queue as queue_mod
        import threading
        self._pub = Publisher(brokers, "chan", chan_name,
                              partition_count=1, filer=filer, ack=ack)
        self._q: "queue_mod.Queue" = queue_mod.Queue(maxsize=1024)
        self._md5 = hashlib.md5()
        self._err: list[Exception] = []
        self._closed = False
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self) -> None:
        import queue as queue_mod
        while True:
            item = self._q.get()
            if item is None:
                return
            batch = [item]
            while len(batch) < 128:
                try:
                    nxt = self._q.get_nowait()
                except queue_mod.Empty:
                    break
                if nxt is None:
                    self._flush(batch)
                    return
                batch.append(nxt)
            self._flush(batch)

    def _flush(self, batch: list) -> None:
        try:
            self._pub.publish_many([(b"", v) for v in batch])
        except Exception as e:
            self._err.append(e)

    def put(self, message: bytes) -> None:
        """chan_pub.go Publish: enqueue one message."""
        if self._closed:
            raise RuntimeError("channel closed")
        if self._err:
            raise self._err[0]
        self._q.put(message)
        self._md5.update(message)

    def digest(self) -> str:
        return self._md5.hexdigest()

    def close(self) -> None:
        """Flush and stop (chan_pub.go Close sends the EOF marker)."""
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout=30)
        if self._err:
            raise self._err[0]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SubChannel:
    """Channel-style subscribe wrapper (msgclient/chan_sub.go:16-80):
    iterate messages like receiving from a Go channel; a background
    thread feeds an internal queue so slow consumers don't stall the
    HTTP stream. The iterator ends when the producer side is idle past
    `idle_timeout` (the HTTP analog of the channel closing)."""

    _DONE = object()

    def __init__(self, brokers: list[str], chan_name: str,
                 since: int = 0, idle_timeout: float = 5.0):
        import hashlib
        import queue as queue_mod
        import threading
        self._sub = Subscriber(brokers, "chan", chan_name, partition=0)
        self._q: "queue_mod.Queue" = queue_mod.Queue(maxsize=1024)
        self._md5 = hashlib.md5()
        self._idle = idle_timeout
        self._since = since
        self._thread = threading.Thread(target=self._feed, daemon=True)
        self._thread.start()

    def _feed(self) -> None:
        try:
            for e in self._sub.stream(since=self._since,
                                      timeout=self._idle):
                self._q.put(e.value)
        finally:
            self._q.put(self._DONE)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                return
            self._md5.update(item)
            yield item

    def digest(self) -> str:
        return self._md5.hexdigest()
