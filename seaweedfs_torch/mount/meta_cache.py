"""Local metadata cache for the mount (weed/filesys/meta_cache/).

The port's copy of seaweedfs_tpu/mount/meta_cache.py, whole. Caches
filer entries per path with TTL, invalidated by the filer's metadata
subscribe stream (``/__meta__/subscribe``, whose lines are
``MetaEvent.to_dict()``: the reference mirrors the mounted subtree into
a local leveldb kept fresh by SubscribeMetadata; here an in-memory dict
plus the same subscription wiring)."""

from __future__ import annotations

import json
import threading
import time
import urllib.parse
import urllib.request
from typing import Optional

from ..utils import retry


class MetaCache:
    def __init__(self, ttl: float = 60.0):
        self.ttl = ttl
        self._entries: dict[str, tuple[Optional[dict], float]] = {}
        self._listings: dict[str, tuple[list[dict], float]] = {}
        self._lock = threading.Lock()
        self._sub_thread: Optional[threading.Thread] = None
        self._stop = False

    def get(self, path: str) -> Optional[tuple[Optional[dict], float]]:
        with self._lock:
            hit = self._entries.get(path)
            if hit and time.time() - hit[1] < self.ttl:
                return hit
            return None

    def put(self, path: str, entry: Optional[dict]) -> None:
        with self._lock:
            self._entries[path] = (entry, time.time())

    def get_listing(self, dir_path: str) -> Optional[list[dict]]:
        with self._lock:
            hit = self._listings.get(dir_path)
            if hit and time.time() - hit[1] < self.ttl:
                return hit[0]
            return None

    def put_listing(self, dir_path: str, entries: list[dict]) -> None:
        with self._lock:
            self._listings[dir_path] = (entries, time.time())

    def invalidate(self, path: str) -> None:
        with self._lock:
            self._entries.pop(path, None)
            parent = path.rsplit("/", 1)[0] or "/"
            self._listings.pop(parent, None)
            self._listings.pop(path, None)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._listings.clear()

    # --- freshness via the filer's subscribe stream ---
    def start_subscriber(self, filer_url: str, prefix: str = "/") -> None:
        def run() -> None:
            since = time.time_ns()
            while not self._stop:
                url = (f"http://{filer_url}/__meta__/subscribe?"
                       + urllib.parse.urlencode({"since": str(since),
                                                 "prefix": prefix}))
                try:
                    req = urllib.request.Request(
                        url, headers=retry.inject_deadline({}))
                    # long-lived tail: timeout=None is deliberate — the
                    # stream lives as long as the mount, and the daemon
                    # thread carries no ambient budget to cap it with
                    with urllib.request.urlopen(req, timeout=None) as r:
                        for line in r:
                            if self._stop:
                                return
                            try:
                                d = json.loads(line)
                            except Exception:
                                continue
                            since = max(since, int(d.get("tsns", since)))
                            for side in ("old", "new"):
                                ent = d.get(side)
                                if ent and ent.get("path"):
                                    self.invalidate(ent["path"])
                except Exception:
                    time.sleep(1.0)

        self._sub_thread = threading.Thread(target=run, daemon=True)
        self._sub_thread.start()

    def stop(self) -> None:
        self._stop = True
