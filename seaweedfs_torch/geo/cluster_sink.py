"""ClusterSink: apply filer metadata events to a *remote cluster*.

The port's copy of seaweedfs_tpu/geo/cluster_sink.py. The sync
replication sinks (replication/sink.py) target object stores and single
filers from a standalone process. This sink is the geo plane's async
counterpart: it writes through the remote cluster's filer HTTP API, so
the remote side does its own chunking, assign leasing and upload
pipelining with its own masters and volume servers; the sink never
touches remote fids.

Every request rides an aiohttp session created with
``observe.client_trace_config()``, so the deadline budget and the
ambient CLASS_BG priority (bound by the geo daemon) propagate like every
other intra-cluster client: replication traffic sheds first at the
remote cluster's admission plane.

Loop prevention for active/active pairs: the event's ``signatures``
(filer ids that already processed the mutation) are passed through on
every write, the remote filer stamps them into its own meta events, and
this cluster's subscription to the remote side filters them out
server-side via ``exclude_sig`` (weed/command/filer_sync.go:81-330).
"""

from __future__ import annotations

import json
import urllib.parse
from typing import Optional

import aiohttp

from ..filer.filer import MetaEvent


class SinkError(RuntimeError):
    """A remote-cluster write that did not land."""


class SinkBusy(SinkError):
    """A retriable remote-side condition — shed (429/503, the
    admission plane asking replication to back off, which is bg and
    sheds FIRST by design) or a transient 5xx.  Never counts toward
    event poison: there is nothing event-specific about an overloaded
    or restarting peer."""


_BUSY_STATUSES = frozenset({429, 500, 502, 503, 504})


def _raise_for(status: int, what: str) -> None:
    if status in _BUSY_STATUSES:
        raise SinkBusy(f"{what}: HTTP {status}")
    raise SinkError(f"{what}: HTTP {status}")


class ClusterSink:
    def __init__(self, session: aiohttp.ClientSession,
                 remote_filer: str, remote_bucket: str,
                 source_filer: str, source_bucket: str,
                 prefix: str = ""):
        self.session = session
        self.remote = remote_filer.rstrip("/")
        self.source = source_filer.rstrip("/")
        self.src_prefix = f"/buckets/{source_bucket}"
        self.dst_prefix = f"/buckets/{remote_bucket}"
        # optional key prefix from the replication rule: only keys under
        # it replicate
        self.key_prefix = prefix
        self._remote_sig: Optional[int] = None

    def identity(self) -> str:
        return f"ClusterSink:{self.remote}{self.dst_prefix}"

    async def signature(self) -> int:
        """The remote filer's store signature — the ``exclude_sig`` the
        caller subscribes with so events this sink already delivered
        are filtered server-side instead of looping back."""
        if self._remote_sig is None:
            async with self.session.get(
                    f"http://{self.remote}/__meta__/info") as r:
                self._remote_sig = int((await r.json())["signature"])
        return self._remote_sig

    # --- path admission/mapping ---

    def admits(self, path: str, is_dir: bool = False) -> bool:
        """True when `path` is inside the replicated bucket (exact
        directory or below — a plain startswith would let bucket "b"
        admit "b2") and under the rule's key prefix.  An ancestor
        DIRECTORY of the prefix is admitted (its mkdir must land so
        the prefixed keys have parents); a mere FILE whose name is a
        string-prefix of the rule prefix ("log" under Prefix=logs/) is
        not."""
        if path != self.src_prefix and \
                not path.startswith(self.src_prefix + "/"):
            return False
        if self.key_prefix:
            if path == self.src_prefix:
                return True
            key = path[len(self.src_prefix) + 1:]
            return key.startswith(self.key_prefix) or \
                (is_dir and self.key_prefix.startswith(key + "/"))
        return True

    def _map(self, path: str) -> str:
        return self.dst_prefix + path[len(self.src_prefix):]

    @staticmethod
    def _sigs(signatures: tuple) -> str:
        return ",".join(str(s) for s in signatures)

    # --- event application ---

    async def apply(self, event: MetaEvent) -> None:
        """One namespace mutation onto the remote cluster.  Create and
        update both land as an upsert (data re-fetched from the source
        filer BY PATH, so a late apply converges to the source's
        current content); renames split into delete+create."""
        old, new = event.old_entry, event.new_entry
        if new is not None and not self.admits(new.full_path,
                                               new.is_directory):
            new = None
        if old is not None and not self.admits(old.full_path,
                                               old.is_directory):
            old = None
        if old is None and new is None:
            return
        sigs = event.signatures
        if new is not None and old is not None \
                and old.full_path != new.full_path:
            await self.delete_path(old.full_path, old.is_directory, sigs)
            old = None
        if new is not None:
            await self.upsert_entry(new, sigs)
        elif old is not None:
            await self.delete_path(old.full_path, old.is_directory, sigs)

    async def upsert_entry(self, entry, signatures: tuple = ()) -> None:
        dst = self._map(entry.full_path)
        q = {"signatures": self._sigs(signatures)}
        if entry.is_directory:
            url = (f"http://{self.remote}{urllib.parse.quote(dst)}"
                   f"?op=mkdir&{urllib.parse.urlencode(q)}")
            async with self.session.post(url) as r:
                if r.status >= 300 and r.status != 409:
                    _raise_for(r.status, f"mkdir {dst}")
            # directories can carry extended attrs too (bucket rules do
            # not replicate — the bucket entry's parent is /buckets,
            # outside the subscription prefix — but object-level dirs
            # keep theirs)
            if entry.extended:
                await self._merge_extended(dst, entry, signatures)
            return
        data = b""
        if entry.chunks:
            data = await self.fetch_source_data(entry.full_path)
        headers = {"Content-Type": entry.attr.mime
                   or "application/octet-stream"}
        url = (f"http://{self.remote}{urllib.parse.quote(dst)}"
               f"?{urllib.parse.urlencode(q)}")
        async with self.session.put(url, data=data,
                                    headers=headers) as r:
            if r.status >= 300:
                _raise_for(r.status, f"put {dst}")
        if entry.extended or entry.attr.ttl_sec:
            # version ids, delete markers, storage class, tags: metadata
            # the remote PUT path doesn't carry — merged via the meta
            # API so the replica's version history matches the source
            await self._merge_extended(dst, entry, signatures)

    async def _merge_extended(self, dst: str, entry,
                              signatures: tuple = ()) -> None:
        async with self.session.get(
                f"http://{self.remote}/__meta__/lookup",
                params={"path": dst}) as r:
            if r.status != 200:
                _raise_for(r.status, f"lookup {dst} after put")
            remote_entry = await r.json()
        ext = dict(remote_entry.get("extended") or {})
        ext.update(entry.extended)
        remote_entry["extended"] = ext
        if entry.attr.ttl_sec:
            remote_entry.setdefault("attr", {})["ttl_sec"] = \
                entry.attr.ttl_sec
        async with self.session.post(
                f"http://{self.remote}/__meta__/update_entry",
                json={"entry": remote_entry,
                      "signatures": list(signatures)}) as r:
            if r.status != 200:
                _raise_for(r.status, f"update {dst}")

    async def delete_path(self, path: str, is_dir: bool,
                          signatures: tuple = ()) -> None:
        dst = self._map(path)
        q = {"recursive": "true", "signatures": self._sigs(signatures)}
        url = (f"http://{self.remote}{urllib.parse.quote(dst)}"
               f"?{urllib.parse.urlencode(q)}")
        async with self.session.delete(url) as r:
            if r.status >= 300 and r.status != 404:
                _raise_for(r.status, f"delete {dst}")

    async def fetch_source_data(self, path: str) -> bytes:
        """Object bytes from the SOURCE filer (server-side chunk and
        manifest resolution, exactly like the sync replicator's
        _fetch_entry_data)."""
        async with self.session.get(
                f"http://{self.source}{urllib.parse.quote(path)}") as r:
            if r.status != 200:
                _raise_for(r.status, f"source fetch {path}")
            return await r.read()

    # --- backfill support ---

    async def list_source(self, dir_path: str, start: str = "",
                          limit: int = 512) -> list[dict]:
        async with self.session.get(
                f"http://{self.source}/__meta__/list",
                params={"dir": dir_path, "start": start,
                        "limit": str(limit)}) as r:
            if r.status != 200:
                _raise_for(r.status, f"source list {dir_path}")
            return (await r.json()).get("entries", [])

    async def lookup_source(self, path: str) -> Optional[dict]:
        async with self.session.get(
                f"http://{self.source}/__meta__/lookup",
                params={"path": path}) as r:
            if r.status != 200:
                return None
            return await r.json()


def entry_from_dict(d: dict):
    """Filer JSON entry dict -> Entry (the list/lookup wire form is the
    same JSON Entry.to_json produces)."""
    from ..filer.entry import Entry
    return Entry.from_json(json.dumps(d))
