"""PeerInvalidator: cross-peer entry-cache invalidation.

The port's reduced copy of seaweedfs_tpu/metaring/invalidation.py. A
ring member caches the entries it proxied (lookups of partitions it does
not own), and the owner's mutations sweep only the owner's own cache.
This watcher tails every other member's ``/__meta__/subscribe`` stream
and sweeps the LOCAL entry cache for each remote mutation: both the old
and the new path, and, for a directory, both subtrees by prefix. Each
sweep bumps the cache's generation, so a read-through fill that raced
the remote mutation is dropped by ``put_if_fresh`` like a local one.

It writes nothing to the store: the stream is cache-coherency traffic
only, so a watcher outage degrades to the entry cache's TTL, never to
wrong durable state. Left out with the overload plane: the tail's
background priority class.
"""

from __future__ import annotations

import asyncio
import json
import logging
import stat

import aiohttp

from ..filer.filer import MetaEvent
from ..filer.netutil import iter_ndjson
from ..lifecycle import jittered

log = logging.getLogger("metaring.invalidation")


class PeerInvalidator:
    def __init__(self, filer_server, peers_fn):
        """``peers_fn`` returns the remote ring members now (a ring change
        reshapes the watch set at ``reconcile``)."""
        self.fs = filer_server
        self.peers_fn = peers_fn
        self.swept = 0
        self.events = 0
        self._tasks: dict[str, asyncio.Task] = {}
        # each peer's resume offset, in memory only: a restarted watcher
        # that sweeps old history again only churns the cache
        self._since: dict[str, int] = {}

    def start(self) -> None:
        self.reconcile()

    def reconcile(self) -> None:
        """Start and stop the per-peer tails to match the ring."""
        want = set(self.peers_fn())
        for peer in list(self._tasks):
            if peer not in want:
                self._tasks.pop(peer).cancel()
        for peer in want:
            if peer not in self._tasks or self._tasks[peer].done():
                self._tasks[peer] = asyncio.create_task(
                    self._watch_loop(peer))

    async def stop(self) -> None:
        tasks = list(self._tasks.values())
        self._tasks.clear()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)

    async def _watch_loop(self, peer: str) -> None:
        while True:
            try:
                async with self.fs._session.get(
                        f"http://{peer}/__meta__/subscribe",
                        params={"since": str(self._since.get(peer, 0)),
                                "prefix": "/"},
                        timeout=aiohttp.ClientTimeout(
                            total=None, sock_read=None)) as r:
                    async for line in iter_ndjson(r.content):
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            d = json.loads(line)
                            tsns = int(d.get("tsns", 0))
                        except (ValueError, KeyError, TypeError):
                            continue
                        self._since[peer] = max(
                            self._since.get(peer, 0), tsns)
                        self.apply_raw(d)
            except asyncio.CancelledError:
                return
            except Exception as e:
                log.debug("invalidation tail of %s: %r (retrying)", peer, e)
            await asyncio.sleep(jittered(1.0))

    def apply(self, event: MetaEvent) -> None:
        """Sweep for one parsed event (tests, in-process use)."""
        self.apply_raw(event.to_dict())

    @staticmethod
    def _side(d: dict, key: str):
        """(path, is_directory) of one side of an event, without building
        an Entry."""
        s = d.get(key)
        if not s:
            return None, False
        mode = int((s.get("attr") or {}).get("mode", 0))
        return s.get("path", ""), stat.S_ISDIR(mode)

    def apply_raw(self, d: dict) -> None:
        """Sweep the local entry cache for one remote mutation (its wire
        dict): the old and the new parent's sides both."""
        self.events += 1
        if self.fs.filer.signature in (d.get("signatures") or ()):
            # the echo of a mutation this peer made or mirrored (the
            # owner's signature rides every mirror): its own event swept
            return
        old_path, old_is_dir = self._side(d, "old")
        new_path, new_is_dir = self._side(d, "new")
        # a remote directory delete or move also drops the ring's
        # parent-existence cache (file events leave it)
        dir_cache = getattr(self.fs, "_ring_dir_cache", None)
        if dir_cache is not None and old_path and old_is_dir \
                and new_path != old_path:
            dir_cache.pop(old_path)
            dir_cache.drop_prefix(old_path.rstrip("/") + "/")
        cache = self.fs.filer._entry_cache
        if cache is None:
            return
        paths, prefixes = [], []
        for path, is_dir in ((old_path, old_is_dir),
                             (new_path, new_is_dir)):
            if not path:
                continue
            paths.append(path)
            if is_dir:
                prefixes.append(path.rstrip("/") + "/")
        if paths:
            cache.drop_paths(paths)
            self.swept += len(paths)
        for p in prefixes:
            cache.drop_prefix(p)

    def status(self) -> dict:
        return {"peers": sorted(self._tasks),
                "events": self.events, "swept": self.swept}
