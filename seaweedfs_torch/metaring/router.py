"""RingRouter: owner-routed namespace ops for a ring-member filer.

The port's reduced copy of seaweedfs_tpu/metaring/router.py. Every
namespace op is keyed on its PARENT directory and runs on that
directory's ring owner. A peer that is not the owner proxies it one hop,
marked with ``RING_HOP_HEADER``: the receiver runs it where it lands and
never routes it again. Writes the owner applied are mirrored to its
ring successors, synchronously and marked with ``RING_REPLICA_HEADER``
(apply here, mirror no further), so an acknowledged entry is on
``replicas`` peers and losing the owner loses none. Reads fall back down
the replica list when the owner cannot be reached.

The reference proxies through the threaded pooled client
(cache/http_pool.py) from the executor; the port's filer is an aiohttp
application on one loop, so hops ride the filer's own
``aiohttp.ClientSession`` (``session_fn``). The wire is the reference's:
the paths, the headers, one hop. An ``idempotent`` op (an upsert) is sent
again once when a kept connection turns out dead, as the pooled client
re-sends one. Left out with the overload plane: the trace and priority
headers on the hop.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Callable, Optional

import aiohttp

from .. import faults
from ..filer.entry import Entry
from . import RING_HOP_HEADER
from .ring import DirectoryRing

log = logging.getLogger("metaring.router")

# marks a replica mirror: apply locally although this peer is not the
# owner, and do not mirror again
RING_REPLICA_HEADER = "X-Seaweed-Ring-Replica"

# what a hop to a peer that died or went away raises
_HOP_ERRORS = (aiohttp.ClientError, OSError, asyncio.TimeoutError)


class RingProxyError(RuntimeError):
    """The owner (and every fallback replica) refused or could not be
    reached; carries the last HTTP status for the surface to map."""

    def __init__(self, message: str, status: int = 502,
                 body: Optional[dict] = None):
        super().__init__(message)
        self.status = status
        self.body = body or {}


class RingRouter:
    def __init__(self, ring: DirectoryRing, self_url: str,
                 session_fn: Callable[[], aiohttp.ClientSession],
                 metrics=None, timeout: float = 30.0):
        self.ring = ring
        self.self_url = self_url
        self.session_fn = session_fn
        self.metrics = metrics
        self.timeout = timeout
        self.proxied = 0
        self.mirrored = 0
        self.mirror_failures = 0

    # --- placement ---
    def owners(self, directory: str) -> list[str]:
        return self.ring.owners(directory)

    def is_owner(self, directory: str) -> bool:
        owners = self.ring.owners(directory)
        return not owners or owners[0] == self.self_url

    def is_replica(self, directory: str) -> bool:
        owners = self.ring.owners(directory)
        return not owners or self.self_url in owners

    def mirror_targets(self, directory: str) -> list[str]:
        return [p for p in self.ring.owners(directory)
                if p != self.self_url]

    # --- one hop ---
    def _count(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.count(name)

    async def request(self, peer: str, method: str, path: str,
                      params: Optional[dict] = None,
                      body: Optional[dict] = None, replica: bool = False,
                      idempotent: bool = False) -> tuple[int, dict]:
        """One ring hop to `peer`: (status, JSON body). Raises what a
        peer that cannot be reached raises."""
        if await faults.fire_async("ring.proxy"):
            raise ConnectionResetError(f"injected ring.proxy drop to {peer}")
        headers = {RING_HOP_HEADER: "1"}
        if replica:
            headers[RING_REPLICA_HEADER] = "1"
        self._count("ring_proxy_requests")
        for attempt in range(2 if idempotent else 1):
            try:
                async with self.session_fn().request(
                        method, f"http://{peer}{path}", params=params,
                        json=body, headers=headers,
                        timeout=aiohttp.ClientTimeout(
                            total=self.timeout)) as r:
                    try:
                        out = await r.json(content_type=None)
                    except ValueError:
                        out = {}
                    return r.status, out if isinstance(out, dict) else {}
            except aiohttp.ServerDisconnectedError:
                # a kept connection the peer had closed
                if attempt or not idempotent:
                    raise
        raise AssertionError("unreachable")

    async def call_owner(self, directory: str, method: str, path: str,
                         params: Optional[dict] = None,
                         body: Optional[dict] = None,
                         read_fallback: bool = False,
                         idempotent: bool = False) -> dict:
        """Run one meta op on the directory's owner; with
        ``read_fallback`` walk down the replica list when the owner
        cannot be reached (reads stay available through a peer's
        death)."""
        targets = [p for p in self.ring.owners(directory)
                   if p != self.self_url]
        if not targets:
            raise RingProxyError(f"no ring owner for {directory}")
        if not read_fallback:
            targets = targets[:1]
        last: Optional[Exception] = None
        for peer in targets:
            try:
                status, out = await self.request(
                    peer, method, path, params=params, body=body,
                    idempotent=idempotent)
            except _HOP_ERRORS as e:
                last = e
                continue
            self.proxied += 1
            if status >= 500:
                last = RingProxyError(f"{peer}{path}: HTTP {status}",
                                      status=status, body=out)
                continue
            if status >= 400:
                raise RingProxyError(f"{peer}{path}: HTTP {status}",
                                     status=status, body=out)
            return out
        raise RingProxyError(f"ring owner unreachable for {directory}: "
                             f"{last!r}", body={"error": str(last)})

    async def mirror(self, directory: str, path: str, body: dict,
                     idempotent: bool = False) -> None:
        """Mirror one applied mutation to the ring successors and wait for
        them (the acknowledgement implies the replicas hold it). A
        successor that cannot be reached degrades to a warning, not a
        failed op: the handoff restores the copy count once the ring
        membership catches up."""
        targets = self.mirror_targets(directory)
        if not targets:
            return

        async def one(peer: str) -> None:
            try:
                status, _ = await self.request(peer, "POST", path,
                                               body=body, replica=True,
                                               idempotent=idempotent)
                if status >= 400:
                    raise RingProxyError(f"HTTP {status}", status=status)
                self.mirrored += 1
                self._count("ring_mirrors")
            except Exception as e:
                self.mirror_failures += 1
                self._count("ring_mirror_failures")
                log.warning("ring mirror of %s to %s failed: %r",
                            directory, peer, e)

        await asyncio.gather(*[one(p) for p in targets])

    # --- typed meta ops (the /__meta__ wire face) ---
    async def find_entry(self, path: str) -> Optional[Entry]:
        directory = path.rstrip("/").rsplit("/", 1)[0] or "/"
        try:
            out = await self.call_owner(directory, "GET",
                                        "/__meta__/lookup",
                                        params={"path": path},
                                        read_fallback=True)
        except RingProxyError as e:
            if e.status == 404:
                return None
            raise
        return Entry.from_json(json.dumps(out))

    async def list_directory(self, dir_path: str, start: str = "",
                             include_start: bool = False,
                             limit: int = 1024,
                             prefix: str = "") -> list[Entry]:
        out = await self.call_owner(
            dir_path, "GET", "/__meta__/list",
            params={"dir": dir_path, "start": start,
                    "include_start": "true" if include_start else "false",
                    "limit": str(limit), "prefix": prefix},
            read_fallback=True)
        return [Entry.from_json(json.dumps(e))
                for e in out.get("entries", [])]

    async def create_entry(self, entry: Entry, o_excl: bool = False,
                           signatures: tuple = (),
                           free_old_chunks: bool = True) -> None:
        await self.call_owner(
            entry.parent, "POST", "/__meta__/create_entry",
            body={"entry": json.loads(entry.to_json()),
                  "o_excl": o_excl, "signatures": list(signatures),
                  "free_old_chunks": free_old_chunks},
            # an exclusive create must not be sent twice: the second
            # would answer a conflict with itself
            idempotent=not o_excl)

    async def update_entry(self, entry: Entry,
                           signatures: tuple = ()) -> None:
        await self.call_owner(
            entry.parent, "POST", "/__meta__/update_entry",
            body={"entry": json.loads(entry.to_json()),
                  "signatures": list(signatures)},
            idempotent=True)

    async def delete_entry(self, path: str, recursive: bool = False,
                           free_chunks: bool = True,
                           signatures: tuple = ()) -> None:
        directory = path.rstrip("/").rsplit("/", 1)[0] or "/"
        await self.call_owner(
            directory, "POST", "/__meta__/delete",
            body={"path": path, "recursive": recursive,
                  "free_chunks": free_chunks,
                  "signatures": list(signatures)})

    def status(self) -> dict:
        return {"self": self.self_url, "ring": self.ring.to_dict(),
                "proxied": self.proxied, "mirrored": self.mirrored,
                "mirror_failures": self.mirror_failures}
