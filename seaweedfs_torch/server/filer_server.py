"""Filer HTTP server: a POSIX-style file API over the blob cluster.

The port's reduced copy of seaweedfs_tpu/server/filer_server.py (upstream
weed/server/filer_server_handlers_read.go,
filer_server_handlers_write_autochunk.go:26-233), an aiohttp application
with the reference's wire:

  GET    /path/to/file      streamed from chunks, Range and ETag/304,
                            sparse holes zero-filled, manifests resolved
  GET    /path/to/dir/      JSON listing (?limit=&lastFileName=&prefix=)
  PUT    /path/to/file      upload, auto-chunked at ``chunk_size``
  POST   /path/to/dir?op=mkdir
  POST   /path?mv.to=/new   rename (AtomicRenameEntry)
  DELETE /path[?recursive=true]
  GET    /__meta__/{lookup,list,info,assign,lookup_volume,
                    resolve_chunks,events}
  GET    /__meta__/subscribe?since=&prefix=&exclude_sig=   (ndjson tail)
  GET    /__meta__/ring/status
  GET    /__meta__/brokers          (the brokers of gRPC KeepConnected)
  POST   /__meta__/{create_entry,update_entry,delete,rename}
  GET    /healthz, /metrics

An upload is read chunk by chunk from the request body; each chunk takes
its fid from the bulk-assign lease pool (filer/assign_lease.py, which
refills through ``/dir/assign?count=N``) and is POSTed to its volume
server through a bounded window (filer/upload_window.py); a file of more
than ``manifest_batch`` chunks folds into manifest chunks. A chunk POST
answered 401/404/409 (a volume deleted or sealed under the lease) or not
answered at all invalidates the leases on that volume and retries once on
a fresh fid; a failed upload deletes every fid it tried. Freed chunks
(overwrites, deletes) go to a background deletion worker, which frees
manifests' data chunks first; a chunk that no holder freed is tried
again later, up to ``DELETE_ATTEMPTS`` times (the reference drops it,
ROADMAP Queue 3, D15). Volume locations come from a TTL cache fed by the
master's ``/cluster/watch`` stream (its entries pinned until the stream
says otherwise); concurrent lookups of one volume and fetches of one
chunk range are coalesced (cache/singleflight.py). The master list
rotates on failure.

``/__meta__/subscribe`` streams the metadata log as ndjson lines (one
``MetaEvent.to_dict()`` each, the reference's form, so either package's
stream replays through the other's ``Filer.apply_event``): the persisted
log and the memory tail since ``?since`` (nanoseconds), then every live
mutation under ``?prefix``, without the events ``?exclude_sig`` already
signed.

With ``ring_config`` (else ``WEED_FILER_RING_*``) naming peers, the filer
is a member of the filer ring (metaring/): every namespace op of the
meta API and the file API is keyed on its parent directory and runs on
the directory's ring owner (a peer that is not the owner proxies it one
hop, marked so the receiver never routes it again), the owner mirrors a
write to its ring successors before it answers, a parent directory's
entry is created on its own owner, reads fall back down the replica
list, recursive deletes and renames fan out through the coordinator,
the other members' subscribe streams sweep the entry cache, and a ring
line of the master's watch stream (a newer version) re-routes and starts
the partition handoff. ``GET /__meta__/ring/status`` is the member's
view (``filer.ring.status``). Without peers every namespace call goes
straight to the local ``Filer``.

A ``notifier`` (notification/queues.py, from notification.toml) gets
every metadata event of the ``MetaLog``; with a ``BrokerQueue`` a write
answers once its events are published. Each of ``peers`` (filers of
other namespaces, upstream's MetaAggregator,
weed/filer/meta_aggregator.go) is tailed through its
``/__meta__/subscribe`` and its events are replayed into the local
store, resuming from ``meta_progress/<peer>`` in the store's KV.

With ``grpc_port`` the filer also serves the SeaweedFiler gRPC service
(server/filer_grpc.py; the CLI's ``-grpc_port``, HTTP port + 10000 by
default): the same facade as the meta API, SubscribeMetadata over the
same log as ``/__meta__/subscribe``, and KeepConnected, whose
``broker@host:port`` streams make the registry ``/__meta__/brokers``
lists and message brokers (messaging/broker.py) find each other by.

Left out, each with its later home (ROADMAP Queue 1 A): admission and
the reserved ops routes, and with them the ring hop's admission class,
the chunk cache, the pooled ``cache/http_pool`` client (the ring's hops
ride this server's aiohttp session), chunk encryption (``cipher``), the
guard and JWTs, gRPC over TLS, the status UI and the SO_REUSEPORT shard
context (A.3, the serving tiers). The reference's
``WEED_FILER_UPLOAD_CONCURRENCY`` and ``WEED_ASSIGN_LEASE*`` knobs are
left out too: their defaults are constants here. Without the chunk cache every view is read from a
volume server, as the reference reads with its cache off.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Optional

import aiohttp
from aiohttp import web

from .. import observe
from ..cache import AsyncSingleflight, TTLCache
from ..filer import manifest as manifest_mod
from ..filer.assign_lease import AsyncAssignLeasePool
from ..filer.chunks import FileChunk, etag as chunks_etag, read_plan
from ..filer.entry import Entry, new_directory, new_file
from ..filer.filer import Filer, MetaEvent, _norm
from ..filer.netutil import iter_ndjson
from ..filer.stores import FilerStore, create_store
from ..filer.upload_window import UploadWindow
from ..metaring import DirectoryRing, RingConfig
from ..metaring.coordinator import FanoutCoordinator
from ..metaring.handoff import HandoffRunner
from ..metaring.invalidation import PeerInvalidator
from ..metaring.router import (RING_HOP_HEADER, RING_REPLICA_HEADER,
                               RingProxyError, RingRouter)
from ..notification.queues import BrokerQueue
from ..utils import metrics as metrics_mod
from ..utils.retry import RETRYABLE_STATUSES, is_shed, parse_retry_after
from . import http

log = logging.getLogger("filer.server")

# tries of a chunk delete that no holder answered with success
DELETE_ATTEMPTS = 8


class _StaleAssignment(RuntimeError):
    """A chunk POST bounced with 401/404/409: the assigned volume is gone
    or sealed read-only, the lease that minted the fid is stale."""


# upload outcomes that poison the fid lease on that volume: the volume
# answered "wrong target" or never answered at all
_LEASE_POISON = (_StaleAssignment, aiohttp.ClientError,
                 asyncio.TimeoutError, OSError)


def _parse_signatures(request: web.Request) -> tuple[int, ...]:
    """?signatures=1,2,3: filer ids that already processed this
    mutation (filer_pb EventNotification.signatures)."""
    out = []
    for part in request.query.get("signatures", "").split(","):
        part = part.strip()
        if part:
            try:
                out.append(int(part))
            except ValueError:
                pass
    return tuple(out)


# chunk uploads in flight per PUT (the reference's
# WEED_FILER_UPLOAD_CONCURRENCY default)
UPLOAD_WINDOW = 4


@web.middleware
async def _ring_errors(request: web.Request, handler):
    """A ring hop's failure as its own status (502: the owner cannot be
    reached), not a 500 with a traceback per op while a peer is down."""
    try:
        return await handler(request)
    except RingProxyError as e:
        return web.json_response({"error": str(e)}, status=e.status)


class FilerServer:
    def __init__(self, master_url: str, store: FilerStore,
                 chunk_size: int = 8 * 1024 * 1024,
                 default_replication: str = "",
                 default_collection: str = "",
                 meta_log_path: str = "",
                 url: str = "",
                 ring_config: Optional[RingConfig] = None,
                 peers: Optional[list[str]] = None,
                 notifier=None,
                 grpc_port: int = 0):
        # the SeaweedFiler gRPC service's port (0: none)
        self.grpc_port = grpc_port
        self._grpc_server = None
        # clients announced over gRPC KeepConnected (mounts, brokers):
        # name -> resources; the brokers among them: address -> count
        self.connected_clients: dict[str, list[str]] = {}
        self.broker_registry: dict[str, int] = {}
        # the comma-separated master list rotates on failure
        # (wdclient/masterclient.go)
        self.masters = [m.strip() for m in master_url.split(",")
                        if m.strip()]
        self._master_i = 0
        self.chunk_size = chunk_size
        self.default_replication = default_replication
        self.default_collection = default_collection
        self.url = url
        self.metrics = metrics_mod.Registry("filer")
        self.filer = Filer(store,
                           on_delete_chunks=self._queue_chunk_deletes,
                           meta_log_path=meta_log_path,
                           metrics=self.metrics)
        # entries fold chunk lists into manifest blobs past this many
        # chunks (filechunk_manifest.go ManifestBatch)
        self.manifest_batch = manifest_mod.MANIFEST_BATCH
        # concurrent lookups of one volume, and fetches of one chunk
        # range, collapse into one request
        self._fetch_flight = AsyncSingleflight("filer.fetch",
                                               metrics=self.metrics)
        # filers whose metadata streams replay into this one's store
        self.peers = [p for p in (peers or []) if p]
        # the outbound notification queue: every metadata event
        self.notifier = notifier
        if notifier is not None:
            self.filer.meta_log.subscribe(notifier.notify)
        # pipelined chunk uploads ride a bounded in-flight window; fids
        # come from a bulk-assignment lease pool
        self.upload_concurrency = UPLOAD_WINDOW
        # the first lease covers two windows; adaptive doubling follows
        self._assign_pool = AsyncAssignLeasePool(
            self._assign_fetch, start_count=2 * UPLOAD_WINDOW,
            metrics=self.metrics)
        self._session: Optional[aiohttp.ClientSession] = None
        self._delete_queue: Optional[asyncio.Queue] = None
        self._tasks: list[asyncio.Task] = []
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # vid -> holder urls; entries the watch stream fed are pinned
        self._vid_cache = TTLCache(ttl=60.0, metrics=self.metrics,
                                   name="vid")
        # the watch stream's snapshots and updates applied
        self.watch_messages = 0
        # the open /__meta__/subscribe streams' queues, ended at shutdown
        self._subscribers: set = set()
        # the filer ring (metaring/): off unless peers are configured
        self.ring_cfg = ring_config or RingConfig.from_env()
        self.ring: Optional[DirectoryRing] = None
        if self.ring_cfg.enabled:
            self.ring = DirectoryRing(peers=self.ring_cfg.peers,
                                      vnodes=self.ring_cfg.vnodes,
                                      replicas=self.ring_cfg.replicas)
            self.ring_router = RingRouter(self.ring, self.url,
                                          lambda: self._session,
                                          metrics=self.metrics)
            self.ring_coordinator = FanoutCoordinator(self)
            self.ring_invalidator = PeerInvalidator(
                self, lambda: [p for p in self.ring.peers if p != self.url])
            self.ring_handoff = HandoffRunner(self, self.ring_router)
            # parent-directory existence for the ring's parent checks: the
            # entry cache's generation moves with every file create, so a
            # parent lookup would never stay cached under write load;
            # directories change far less often, and their events (local
            # and from peers) sweep this set
            self._ring_dir_cache = TTLCache(ttl=5.0, max_entries=8192,
                                            metrics=self.metrics,
                                            name="ringdir")
            self.filer.meta_log.subscribe(self._ring_dir_event)
        self.app = self._build_app()

    def _build_app(self) -> web.Application:
        app = web.Application(client_max_size=1024 * 1024 * 1024,
                              middlewares=[http.errors_as_json,
                                           _ring_errors])
        # reserved for every method, so a PUT /healthz is no file write
        app.router.add_route("*", "/healthz", self.healthz)
        app.router.add_route("*", "/metrics", self.metrics_handler)
        # the JSON face of the reference's filer gRPC (weed/pb/
        # filer.proto LookupDirectoryEntry, ListEntries, CreateEntry,
        # UpdateEntry, DeleteEntry, AtomicRenameEntry)
        app.router.add_get("/__meta__/lookup", self.meta_lookup)
        app.router.add_get("/__meta__/list", self.meta_list)
        app.router.add_post("/__meta__/create_entry", self.meta_create)
        app.router.add_post("/__meta__/update_entry", self.meta_update)
        app.router.add_post("/__meta__/delete", self.meta_delete)
        app.router.add_post("/__meta__/rename", self.meta_rename)
        app.router.add_route("*", "/__meta__/events", self.meta_events)
        app.router.add_route("*", "/__meta__/subscribe",
                             self.meta_subscribe)
        app.router.add_get("/__meta__/ring/status", self.meta_ring_status)
        app.router.add_get("/__meta__/brokers", self.meta_brokers)
        app.router.add_get("/__meta__/info", self.meta_info)
        app.router.add_get("/__meta__/assign", self.meta_assign)
        app.router.add_get("/__meta__/lookup_volume",
                           self.meta_lookup_volume)
        app.router.add_get("/__meta__/resolve_chunks",
                           self.meta_resolve_chunks)
        app.router.add_route("*", "/{path:.*}", self.dispatch)
        app.on_startup.append(self._on_startup)
        app.on_shutdown.append(self._on_shutdown)
        app.on_cleanup.append(self._on_cleanup)
        return app

    async def _exec(self, fn):
        loop = asyncio.get_running_loop()
        if not isinstance(self.notifier, BrokerQueue):
            return await loop.run_in_executor(None, fn)
        result, published = await loop.run_in_executor(
            None, self.notifier.run, fn)
        if published is not None:
            # a write answers once its events are on the broker, as the
            # reference's publish before the answer
            await asyncio.wrap_future(published)
        return result

    async def _create(self, entry: Entry, o_excl: bool = False,
                      signatures: tuple = (),
                      free_old_chunks: bool = True) -> None:
        """Create or overwrite in the local store; a replaced entry's
        chunks that the new one does not keep are freed (hard-link
        aware). In a ring the ancestors were created through the ring,
        each on its own partition's owner."""
        def apply() -> list:
            # one executor hop for the lookup, the create and the freeable
            # chunks
            old = self.filer.find_entry(entry.full_path) \
                if free_old_chunks else None
            self.filer.create_entry(entry, o_excl=o_excl,
                                    signatures=signatures,
                                    ensure_parents=self.ring is None)
            if not free_old_chunks:
                return []
            new_fids = {c.fid for c in entry.chunks}
            return [c for c in self.filer.freeable_replaced_chunks(old)
                    if c.fid not in new_fids]

        self._queue_chunk_deletes(await self._exec(apply))

    # --- the ring face: owner-routed namespace ops (metaring/) ---
    #
    # Without a ring each goes straight to the local Filer. With one, the
    # parent directory's owner runs it (a proxy hop when that is a peer),
    # the owner mirrors to its successors, and proxied lookups fill the
    # local entry cache under its generation guard, so the peers' sweeps
    # keep them honest.
    _MISS = object()

    def _ring_drop_cached(self, path: str, subtree: bool = False) -> None:
        """Drop this peer's cached view of a path it just changed through
        a hop (a generation bump: a racing fill is dropped too)."""
        cache = self.filer._entry_cache
        if cache is not None:
            cache.pop(path)
            if subtree:
                cache.drop_prefix(path.rstrip("/") + "/")
        if subtree:
            self._ring_dir_cache.pop(path)
            self._ring_dir_cache.drop_prefix(path.rstrip("/") + "/")

    def _ring_dir_event(self, event) -> None:
        """The local log's hook: a directory deleted or moved leaves the
        parent-existence cache (file events do not touch it)."""
        old = event.old_entry
        if old is not None and old.is_directory and (
                event.new_entry is None
                or event.new_entry.full_path != old.full_path):
            self._ring_dir_cache.pop(old.full_path)
            self._ring_dir_cache.drop_prefix(old.full_path.rstrip("/") + "/")

    async def _ring_ensure_parents(self, dir_path: str) -> None:
        """Create each missing ancestor's entry on the ancestor's own
        partition owner (the local Filer's auto-create would put it on
        the leaf's owner)."""
        if dir_path in ("", "/") or self._ring_dir_cache.get(dir_path):
            return
        entry = await self.ring_find(dir_path)
        if entry is not None:
            if not entry.is_directory:
                # creating under a file is a 409, ring or no ring
                raise NotADirectoryError(dir_path)
            self._ring_dir_cache.put(dir_path, True)
            return
        await self._ring_ensure_parents(dir_path.rsplit("/", 1)[0] or "/")
        try:
            await self.ring_create(new_directory(dir_path),
                                   ensure_parents=False)
        except FileExistsError:
            pass  # a racing create made it
        self._ring_dir_cache.put(dir_path, True)

    async def ring_find(self, path: str) -> Optional[Entry]:
        path = _norm(path)
        if self.ring is None:
            return await self._exec(lambda: self.filer.find_entry(path))
        directory = path.rsplit("/", 1)[0] or "/"
        if self.ring_router.is_owner(directory):
            return await self._exec(lambda: self.filer.find_entry(path))
        if self.ring_router.is_replica(directory):
            # the synchronous mirror keeps a replica current, except just
            # after a ring change made it one (before the handoff pushed):
            # a local miss asks the owner, and an owner that cannot be
            # reached leaves the local answer standing
            entry = await self._exec(lambda: self.filer.find_entry(path))
            if entry is not None:
                return entry
            try:
                return await self._ring_map(
                    self.ring_router.find_entry(path))
            except (RingProxyError, FileNotFoundError):
                return None
        cache = self.filer._entry_cache
        if cache is not None:
            hit = cache.get(path, self._MISS)
            if hit is not self._MISS:
                return hit
            gen = cache.generation
        entry = await self._ring_map(self.ring_router.find_entry(path))
        if cache is not None:
            # a sweep between the read and the fill drops the value
            cache.put_if_fresh(path, entry, gen)
        return entry

    async def ring_list(self, dir_path: str, start: str = "",
                        include_start: bool = False, limit: int = 1024,
                        prefix: str = "") -> list:
        def local() -> list:
            return self.filer.list_directory(dir_path, start,
                                             include_start, limit, prefix)

        if self.ring is None or self.ring_router.is_owner(dir_path):
            return await self._exec(local)
        if self.ring_router.is_replica(dir_path):
            out = await self._exec(local)
            if out:
                return out
            # an empty local view may be a new successor's gap: ask the
            # owner, and if it is down empty is the best answer there is
            try:
                return await self._ring_map(
                    self.ring_router.list_directory(
                        dir_path, start, include_start, limit, prefix))
            except (RingProxyError, FileNotFoundError):
                return out
        return await self._ring_map(self.ring_router.list_directory(
            dir_path, start, include_start, limit, prefix))

    async def ring_create(self, entry: Entry, o_excl: bool = False,
                          signatures: tuple = (),
                          free_old_chunks: bool = True,
                          force_local: bool = False, mirror: bool = True,
                          ensure_parents: bool = True) -> None:
        if self.ring is None:
            await self._create(entry, o_excl, signatures, free_old_chunks)
            return
        if ensure_parents:
            await self._ring_ensure_parents(entry.parent)
        directory = entry.parent
        if not force_local and not self.ring_router.is_owner(directory):
            await self._ring_map(self.ring_router.create_entry(
                entry, o_excl=o_excl, signatures=signatures,
                free_old_chunks=free_old_chunks))
            # read-your-writes at the edge: this peer may have cached a
            # negative lookup a moment ago, and the owner's sweep comes
            # later, over the stream
            self._ring_drop_cached(entry.full_path)
            return
        local = self._create(entry, o_excl, signatures, free_old_chunks)
        if not mirror or not self.ring_router.mirror_targets(directory):
            await local
            return
        # the owner's signature rides the mirror, so the replica's event
        # carries it and the owner's own watcher skips the echo
        copy = self.ring_router.mirror(
            directory, "/__meta__/create_entry",
            {"entry": json.loads(entry.to_json()), "o_excl": False,
             "signatures": list(signatures) + [self.filer.signature],
             "free_old_chunks": False}, idempotent=True)
        if o_excl:
            # the replica's copy must not land before the owner's verdict
            await local
            await copy
        else:
            # the acknowledgement waits for both, which overlap
            await asyncio.gather(local, copy)

    async def ring_update(self, entry: Entry, signatures: tuple = (),
                          force_local: bool = False,
                          mirror: bool = True) -> None:
        if self.ring is None:
            await self._exec(lambda: self.filer.update_entry(
                entry, signatures=signatures))
            return
        directory = entry.parent
        if not force_local and not self.ring_router.is_owner(directory):
            await self._ring_map(self.ring_router.update_entry(
                entry, signatures=signatures))
            self._ring_drop_cached(entry.full_path)
            return
        local = self._exec(lambda: self.filer.update_entry(
            entry, signatures=signatures))
        if not mirror:
            await local
            return
        await asyncio.gather(local, self.ring_router.mirror(
            directory, "/__meta__/update_entry",
            {"entry": json.loads(entry.to_json()),
             "signatures": list(signatures) + [self.filer.signature]},
            idempotent=True))

    async def ring_delete(self, path: str, recursive: bool = False,
                          free_chunks: bool = True, signatures: tuple = (),
                          force_local: bool = False,
                          mirror: bool = True) -> None:
        if self.ring is None:
            await self._exec(lambda: self.filer.delete_entry(
                path, recursive=recursive, free_chunks=free_chunks,
                signatures=signatures))
            return
        directory = path.rstrip("/").rsplit("/", 1)[0] or "/"
        if not force_local and not self.ring_router.is_owner(directory):
            await self._ring_map(self.ring_router.delete_entry(
                path, recursive=recursive, free_chunks=free_chunks,
                signatures=signatures))
            self._ring_drop_cached(path, subtree=recursive)
            return
        await self._exec(lambda: self.filer.delete_entry(
            path, recursive=recursive, free_chunks=free_chunks,
            signatures=signatures))
        if mirror:
            await self.ring_router.mirror(
                directory, "/__meta__/delete",
                # replicas never free chunks: the owner's deletion queue
                # frees them, a second free would delete the fids twice
                {"path": path, "recursive": recursive, "free_chunks": False,
                 "signatures": list(signatures) + [self.filer.signature]})

    async def ring_delete_entry_point(self, path: str,
                                      recursive: bool = False,
                                      free_chunks: bool = True,
                                      signatures: tuple = ()) -> None:
        """A delete that entered at this peer. The emptiness check asks
        the DIRECTORY's owner (its children live there), and a populated
        subtree fans out through the coordinator, each partition's share
        on its owner."""
        path = _norm(path)
        entry = await self.ring_find(path)
        if entry is None:
            raise FileNotFoundError(path)
        if entry.is_directory:
            children = await self.ring_list(path, limit=2)
            if children and not recursive:
                raise OSError(f"directory {path} not empty")
            if children:
                await self.ring_coordinator.delete_subtree(
                    path, free_chunks=free_chunks, signatures=signatures)
                return
        await self.ring_delete(path, recursive=recursive,
                               free_chunks=free_chunks,
                               signatures=signatures)

    async def _ring_map(self, awaitable):
        """A hop's HTTP verdict as the local exceptions the handlers and
        the coordinator speak."""
        try:
            return await awaitable
        except RingProxyError as e:
            err = (e.body or {}).get("error", "")
            if e.status == 404:
                raise FileNotFoundError(err or "not found") from e
            if e.status == 409:
                if err == "exists":
                    raise FileExistsError(err) from e
                raise OSError(err or "conflict") from e
            raise

    @staticmethod
    def _hop_flags(request: web.Request) -> tuple[bool, bool]:
        """(a ring hop, a replica mirror) from the request's headers."""
        return (request.headers.get(RING_HOP_HEADER) == "1",
                request.headers.get(RING_REPLICA_HEADER) == "1")

    # --- meta API handlers ---
    async def meta_lookup(self, request: web.Request) -> web.Response:
        hop, _ = self._hop_flags(request)
        path = request.query["path"]
        if self.ring is not None and not hop:
            try:
                entry = await self.ring_find(path)
            except FileNotFoundError:
                entry = None
        else:
            entry = await self._exec(lambda: self.filer.find_entry(path))
        if entry is None:
            return web.json_response({"error": "not found"}, status=404)
        return web.json_response(json.loads(entry.to_json()))

    async def meta_list(self, request: web.Request) -> web.Response:
        q = request.query
        hop, _ = self._hop_flags(request)
        args = (q["dir"], q.get("start", ""),
                q.get("include_start") == "true",
                int(q.get("limit", 1024)), q.get("prefix", ""))
        if self.ring is not None and not hop:
            entries = await self.ring_list(*args)
        else:
            entries = await self._exec(
                lambda: self.filer.list_directory(*args))
        return web.json_response(
            {"entries": [json.loads(e.to_json()) for e in entries]})

    async def meta_create(self, request: web.Request) -> web.Response:
        body = await request.json()
        entry = Entry.from_json(json.dumps(body["entry"]))
        # filers that already applied this mutation (loop prevention)
        sigs = tuple(int(s) for s in body.get("signatures") or ())
        hop, replica = self._hop_flags(request)
        try:
            await self.ring_create(
                entry, o_excl=body.get("o_excl", False), signatures=sigs,
                free_old_chunks=body.get("free_old_chunks", True),
                force_local=hop, mirror=not replica,
                # the edge peer made the ancestors before its hop
                ensure_parents=not (hop or replica))
        except FileExistsError:
            return web.json_response({"error": "exists"}, status=409)
        except (IsADirectoryError, NotADirectoryError) as e:
            return web.json_response({"error": str(e)}, status=409)
        return web.json_response({"ok": True})

    async def meta_update(self, request: web.Request) -> web.Response:
        body = await request.json()
        entry = Entry.from_json(json.dumps(body["entry"]))
        sigs = tuple(int(s) for s in body.get("signatures") or ())
        hop, replica = self._hop_flags(request)
        try:
            await self.ring_update(entry, signatures=sigs, force_local=hop,
                                   mirror=not replica)
        except FileNotFoundError:
            return web.json_response({"error": "not found"}, status=404)
        return web.json_response({"ok": True})

    async def meta_delete(self, request: web.Request) -> web.Response:
        body = await request.json()
        sigs = tuple(int(s) for s in body.get("signatures") or ())
        hop, replica = self._hop_flags(request)
        args = dict(recursive=body.get("recursive", False),
                    free_chunks=body.get("free_chunks", True),
                    signatures=sigs)
        try:
            if self.ring is not None and not hop:
                await self.ring_delete_entry_point(body["path"], **args)
            else:
                await self.ring_delete(body["path"], force_local=hop,
                                       mirror=not replica, **args)
        except FileNotFoundError:
            return web.json_response({"error": "not found"}, status=404)
        except OSError as e:
            return web.json_response({"error": str(e)}, status=409)
        return web.json_response({"ok": True})

    async def meta_rename(self, request: web.Request) -> web.Response:
        body = await request.json()
        hop, _ = self._hop_flags(request)
        try:
            if self.ring is not None and not hop:
                await self.ring_coordinator.rename(_norm(body["from"]),
                                                   _norm(body["to"]))
            else:
                await self._exec(lambda: self.filer.rename(body["from"],
                                                           body["to"]))
        except FileNotFoundError:
            return web.json_response({"error": "not found"}, status=404)
        return web.json_response({"ok": True})

    async def meta_ring_status(self, request: web.Request) -> web.Response:
        """This member's ring view: the membership, the proxy and mirror
        counters, the handoff, the invalidation sweeps, and the local and
        owned directory counts (``filer.ring.status``)."""
        if self.ring is None:
            return web.json_response({"enabled": False})
        local_dirs = await self._exec(
            lambda: list(self.filer.store.iter_directories()))
        return web.json_response({
            "enabled": True,
            "self": self.url,
            "ring": self.ring.to_dict(),
            "router": self.ring_router.status(),
            "handoff": self.ring_handoff.status(),
            "invalidation": self.ring_invalidator.status(),
            "local_dirs": len(local_dirs),
            "owned_dirs": sum(1 for d in local_dirs
                              if self.ring_router.is_owner(d)),
        })

    async def meta_subscribe(self, request: web.Request
                             ) -> web.StreamResponse:
        """The metadata log as a stream (SubscribeMetadata,
        weed/server/filer_grpc_server_sub_meta.go): the persisted and the
        in-memory events since ?since, then every live mutation under
        ?prefix, one ndjson line each; ?exclude_sig=N leaves out what
        filer N signed."""
        since = int(request.query.get("since", 0))
        prefix = request.query.get("prefix", "/")
        exclude_sig = int(request.query.get("exclude_sig", 0))
        resp = web.StreamResponse(
            headers={"Content-Type": "application/x-ndjson"})
        await resp.prepare(request)
        queue: asyncio.Queue = asyncio.Queue()
        loop = asyncio.get_running_loop()

        def on_event(e) -> None:
            # mutations run on executor threads
            loop.call_soon_threadsafe(queue.put_nowait, e)

        def admit(e) -> bool:
            return not (exclude_sig and exclude_sig in e.signatures)

        self._subscribers.add(queue)
        self.filer.meta_log.subscribe(on_event)
        try:
            seen = set()
            # the replay: the persisted log, then the memory tail
            replay = await self._exec(lambda: list(
                self.filer.meta_log.read_persisted_since(since, prefix)))
            replay += self.filer.meta_log.events_since(since, prefix)
            for e in replay:
                if e.tsns in seen:
                    continue
                seen.add(e.tsns)
                if admit(e):
                    await resp.write(e.wire())
            # the live tail, drained greedily into one write per wakeup;
            # `seen` keeps an event that raced into the replay and the
            # queue from going out twice
            while True:
                batch = [await queue.get()]
                while len(batch) < 256:
                    try:
                        batch.append(queue.get_nowait())
                    except asyncio.QueueEmpty:
                        break
                if None in batch:
                    break
                payload = b"".join(
                    e.wire() for e in batch
                    if e.tsns not in seen
                    and e.directory.startswith(prefix) and admit(e))
                if payload:
                    await resp.write(payload)
        except (ConnectionResetError, asyncio.CancelledError):
            pass
        finally:
            self.filer.meta_log.unsubscribe(on_event)
            self._subscribers.discard(queue)
        return resp

    async def meta_events(self, request: web.Request) -> web.Response:
        """Poll-based metadata subscription (SubscribeMetadata)."""
        since = int(request.query.get("since", 0))
        prefix = request.query.get("prefix", "/")
        events = self.filer.meta_log.events_since(since, prefix)
        return web.json_response({"events": [{
            "tsns": e.tsns,
            "directory": e.directory,
            "old": json.loads(e.old_entry.to_json()) if e.old_entry else None,
            "new": json.loads(e.new_entry.to_json()) if e.new_entry else None,
        } for e in events]})

    async def meta_brokers(self, request: web.Request) -> web.Response:
        """The message brokers registered over gRPC KeepConnected: the
        HTTP face of LocateBroker."""
        return web.json_response({"brokers": sorted(self.broker_registry)})

    async def meta_info(self, request: web.Request) -> web.Response:
        """The filer's signature (weed/filer/meta_aggregator.go:169)."""
        return web.json_response({"signature": self.filer.signature})

    async def meta_assign(self, request: web.Request) -> web.Response:
        """A volume assignment under the filer's default collection and
        replication (AssignVolume, weed/server/filer_grpc_server.go).
        ?count=N passes bulk assignment through; count=1 is served from
        the lease pool, unless ?direct=true asks for a fresh master
        assignment (a retry after a failed upload)."""
        q = request.query
        try:
            count = int(q.get("count", 1) or 1)
        except ValueError:
            return web.json_response({"error": "invalid count"}, status=400)
        if count < 1:
            return web.json_response({"error": "invalid count"}, status=400)
        try:
            collection = q.get("collection", self.default_collection)
            replication = q.get("replication", self.default_replication)
            ttl = q.get("ttl", "")
            if count == 1 and q.get("direct") == "true":
                params = {k: v for k, v in (("collection", collection),
                                            ("replication", replication),
                                            ("ttl", ttl)) if v}
                a = await self._assign_fetch(params, 1)
            else:
                a = await self._assign(collection, replication, ttl,
                                       count=count)
        except web.HTTPError as e:
            return web.json_response({"error": e.text}, status=500)
        return web.json_response(a)

    async def meta_lookup_volume(self, request: web.Request
                                 ) -> web.Response:
        """Volume locations (LookupVolume): ?volumeId=N through the
        filer's cache, or ?fileId=<fid> straight from the master."""
        fid = request.query.get("fileId", "")
        if fid:
            body = await self._master_get("/dir/lookup", {"fileId": fid})
            if "error" in body and not body.get("locations"):
                return web.json_response(body, status=404)
            return web.json_response(body)
        try:
            vid = int(request.query["volumeId"])
        except (KeyError, ValueError):
            return web.json_response({"error": "bad volumeId"}, status=400)
        urls = await self._lookup(vid)
        if not urls:
            return web.json_response({"error": "not found"}, status=404)
        return web.json_response(
            {"locations": [{"url": u} for u in urls]})

    async def meta_resolve_chunks(self, request: web.Request
                                  ) -> web.Response:
        """An entry's data chunks with manifests resolved, offsets
        shifted by ?shift=N; ?free_manifests=true queues the manifest
        blobs (not their data chunks) for deletion."""
        entry = await self._exec(lambda: self.filer.find_entry(
            request.query.get("path", "")))
        if entry is None:
            return web.json_response({"error": "not found"}, status=404)
        shift = int(request.query.get("shift", 0))
        resolved = entry.chunks
        manifests = [c for c in entry.chunks if c.is_chunk_manifest]
        if manifests:
            resolved = await manifest_mod.resolve_manifests(
                entry.chunks, self._fetch_manifest_blob)
            if request.query.get("free_manifests") == "true":
                # the flag stripped: the worker must not cascade into
                # the data chunks
                self._queue_chunk_deletes([
                    FileChunk(fid=m.fid, offset=0, size=m.size)
                    for m in manifests])
        out = []
        for c in resolved:
            d = c.to_dict()
            d["offset"] += shift
            out.append(d)
        return web.json_response({"chunks": out})

    # --- lifecycle ---
    async def _on_startup(self, app) -> None:
        self._loop = asyncio.get_running_loop()
        self._delete_queue = asyncio.Queue()
        # inactivity-bounded, no total cap (large chunk streams)
        self._session = aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=None, sock_connect=10,
                                          sock_read=60))
        self._tasks = [asyncio.create_task(self._deletion_worker()),
                       asyncio.create_task(self._watch_master())]
        self._tasks += [asyncio.create_task(self._aggregate_from_peer(p))
                        for p in self.peers]
        if self.ring is not None:
            self.ring_invalidator.start()
        if self.grpc_port:
            from .filer_grpc import serve_filer_grpc
            self._grpc_server = await serve_filer_grpc(
                self, self.url.rsplit(":", 1)[0] or "127.0.0.1",
                self.grpc_port)

    async def _on_shutdown(self, app) -> None:
        # end the subscribe streams: their subscribers redial
        for q in list(self._subscribers):
            q.put_nowait(None)

    async def _on_cleanup(self, app) -> None:
        if self._grpc_server is not None:
            await self._grpc_server.stop(grace=0.5)
            self._grpc_server = None
        for task in self._tasks:
            task.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []
        if self.ring is not None:
            await self.ring_invalidator.stop()
            await self.ring_handoff.stop()
        if self._session is not None:
            await self._session.close()
        await self._exec(self.filer.close)

    async def _aggregate_from_peer(self, peer: str) -> None:
        """Subscribe to one peer filer's meta stream and replay its events
        into our store, resuming from a persisted per-peer offset
        (MetaAggregator, weed/filer/meta_aggregator.go)."""
        offset_key = f"meta_progress/{peer}"

        def replay(e: MetaEvent) -> None:
            self.filer.apply_event(e)
            self.filer.store.kv_put(offset_key, str(e.tsns).encode())

        while True:
            raw = await self._exec(lambda: self.filer.store.kv_get(
                offset_key))
            since = int(raw.decode()) if raw else 0
            try:
                async with self._session.get(
                        f"http://{peer}/__meta__/subscribe",
                        params={"since": str(since)},
                        timeout=aiohttp.ClientTimeout(total=None,
                                                      sock_read=None)) as r:
                    async for line in iter_ndjson(r.content):
                        line = line.strip()
                        if not line:
                            continue
                        e = MetaEvent.from_dict(json.loads(line))
                        await self._exec(lambda e=e: replay(e))
            except asyncio.CancelledError:
                raise
            except Exception as ex:
                log.debug("meta aggregator peer %s: %s (retrying)", peer, ex)
            await asyncio.sleep(1.0)

    async def _watch_master(self) -> None:
        """The vid-location subscription: the master pushes location
        deltas, so chunk reads stop polling /dir/lookup
        (wdclient/masterclient.go:95-151). A lost stream redials the
        next master and starts again from a snapshot."""
        while True:
            try:
                async with self._session.get(
                        f"http://{self.master_url}/cluster/watch",
                        timeout=aiohttp.ClientTimeout(total=None,
                                                      sock_read=3600)) as r:
                    if r.status != 200:
                        raise aiohttp.ClientError(
                            f"watch: HTTP {r.status}")
                    async for line in r.content:
                        msg = json.loads(line)
                        self.watch_messages += 1
                        if msg.get("type") == "snapshot":
                            self._vid_cache.clear()
                            for vid, locs in \
                                    msg.get("volumes", {}).items():
                                self._vid_cache.put(
                                    int(vid), [x["url"] for x in locs],
                                    pin=True)
                            if msg.get("ring"):
                                self._apply_ring_update(msg["ring"])
                        elif msg.get("type") == "update":
                            self._apply_location_update(msg)
                        elif msg.get("type") == "ring":
                            self._apply_ring_update(msg.get("ring") or {})
            except asyncio.CancelledError:
                return
            except Exception as e:
                # a lost or garbled stream: redial the next master
                log.info("watch stream from %s: %r", self.master_url, e)
            self._master_i = (self._master_i + 1) % len(self.masters)
            await asyncio.sleep(0.2)

    def _apply_ring_update(self, ring_dict: dict) -> None:
        """Adopt a ring the master pushed when its version is newer (the
        configured view is version 0, so any join or leave supersedes
        it): re-route, reshape the invalidation tails and start the
        partition handoff from the old view to the new."""
        if self.ring is None or not ring_dict.get("peers") or \
                ring_dict.get("version", 0) <= self.ring.version:
            return
        old, new = self.ring, DirectoryRing.from_dict(ring_dict)
        # the pass is marked running before the new view shows
        self.ring_handoff.trigger(new, old)
        self.ring = self.ring_router.ring = new
        log.info("ring v%d adopted: %s", new.version, new.peers)
        self.ring_invalidator.reconcile()

    def _apply_location_update(self, msg: dict) -> None:
        url = msg["url"]
        for vid in msg.get("new_vids", []):
            urls = self._vid_cache.get(vid) or []
            if url not in urls:
                urls = urls + [url]
            self._vid_cache.put(vid, urls, pin=True)
        for vid in msg.get("deleted_vids", []):
            urls = [u for u in (self._vid_cache.get(vid) or [])
                    if u != url]
            if urls:
                self._vid_cache.put(vid, urls, pin=True)
            else:
                self._vid_cache.pop(vid)

    # --- the chunk deletion queue (filer_deletion.go) ---
    def _queue_chunk_deletes(self, chunks: list[FileChunk]) -> None:
        if self._loop is None:
            return
        for c in chunks:
            self._loop.call_soon_threadsafe(self._delete_queue.put_nowait,
                                            (c, 0))

    async def _fetch_manifest_blob(self, chunk: FileChunk) -> bytes:
        return await self._fetch_raw(chunk.fid)

    async def _deletion_worker(self) -> None:
        while True:
            chunk, attempt = await self._delete_queue.get()
            try:
                if chunk.is_chunk_manifest and attempt == 0:
                    # free the data chunks a manifest references before
                    # the manifest blob itself
                    try:
                        nested = manifest_mod.unpack_manifest(
                            await self._fetch_manifest_blob(chunk))
                        for c in nested:
                            self._delete_queue.put_nowait((c, 0))
                    except (web.HTTPError, ValueError, KeyError) as e:
                        log.warning("manifest %s resolution for delete "
                                    "failed: %s", chunk.fid, e)
                if await self._delete_chunk(chunk):
                    self.metrics.count("chunks_freed")
                    continue
            except asyncio.CancelledError:
                raise
            except Exception:
                # the worker must outlive any one chunk
                log.warning("chunk delete %s failed", chunk.fid,
                            exc_info=True)
            if attempt + 1 >= DELETE_ATTEMPTS:
                self.metrics.count("chunks_not_freed")
                log.warning("chunk %s not freed on any holder after %d "
                            "tries", chunk.fid, DELETE_ATTEMPTS)
                continue
            # a volume sealed for its warm-down refuses deletes (409)
            # until its shards serve them: try again later
            self._loop.call_later(min(0.5 * 2 ** attempt, 30.0),
                                  self._delete_queue.put_nowait,
                                  (chunk, attempt + 1))

    async def _delete_chunk(self, chunk: FileChunk) -> bool:
        """DELETE the fid on its holders until one frees it (200, 202;
        404: already gone)."""
        for url in await self._lookup(int(chunk.fid.split(",")[0])):
            try:
                async with self._session.delete(
                        f"http://{url}/{chunk.fid}") as r:
                    if r.status in (200, 202, 404):
                        return True
                    log.info("chunk delete %s on %s: HTTP %d",
                             chunk.fid, url, r.status)
            except aiohttp.ClientError:
                continue
        return False

    # --- master and volume plumbing ---
    @property
    def master_url(self) -> str:
        return self.masters[self._master_i]

    async def _master_get(self, path: str, params: dict) -> dict:
        """GET against the current master, rotating through the list on
        connection failure or 502/503/504 (a leaderless follower). A
        shed answer waits out its Retry-After with one master, and
        rotates at once with several."""
        last: Optional[Exception] = None
        attempts = max(2 * len(self.masters), 2)
        for attempt in range(attempts):
            try:
                async with self._session.get(
                        f"http://{self.master_url}{path}",
                        params=params) as r:
                    if r.status in RETRYABLE_STATUSES:
                        if is_shed(r.status, r.headers):
                            last = aiohttp.ClientError(
                                f"master {self.master_url}: shed "
                                f"HTTP {r.status}")
                            delay = parse_retry_after(
                                r.headers.get("Retry-After"))
                            delay = min(delay if delay is not None
                                        else 0.5, 5.0)
                            if len(self.masters) > 1:
                                self._master_i = (self._master_i + 1) \
                                    % len(self.masters)
                                if (attempt + 1) % len(self.masters) == 0:
                                    await asyncio.sleep(delay)
                            elif attempt < attempts - 1:
                                await asyncio.sleep(delay)
                            continue
                        raise aiohttp.ClientError(
                            f"master {self.master_url}: HTTP {r.status}")
                    return await r.json()
            except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as e:
                last = e
                if len(self.masters) > 1:
                    self._master_i = (self._master_i + 1) % len(self.masters)
                    await asyncio.sleep(0.05)
                else:
                    raise
        raise aiohttp.ClientError(f"all masters failed: {last}")

    async def _lookup(self, vid: int) -> list[str]:
        cached = self._vid_cache.get(vid)
        if cached:
            return cached

        async def fetch() -> list[str]:
            body = await self._master_get("/dir/lookup",
                                          {"volumeId": str(vid)})
            urls = [loc["url"] for loc in body.get("locations", [])]
            if urls:
                self._vid_cache.put(vid, urls)
            return urls

        return await self._fetch_flight.do(("lookup", vid), fetch)

    async def _assign_fetch(self, params: dict, count: int) -> dict:
        """One master assignment: the lease pool's refill and the direct
        path."""
        p = dict(params)
        if count > 1:
            p["count"] = str(count)
        body = await self._master_get("/dir/assign", p)
        if "error" in body:
            raise web.HTTPInternalServerError(text=body["error"])
        return body

    async def _assign(self, collection: str, replication: str,
                      ttl: str, count: int = 1) -> dict:
        """A fid from the (collection, replication, ttl) lease, refilled
        through /dir/assign?count=N; count>1 always asks the master."""
        if count > 1:
            params = {k: v for k, v in (("collection", collection),
                                        ("replication", replication),
                                        ("ttl", ttl)) if v}
            return await self._assign_fetch(params, count)
        return await self._assign_pool.get(collection, replication, ttl)

    async def _upload_chunk(self, data: bytes, collection: str,
                            replication: str, ttl: str,
                            offset: int, name_hint: str = "",
                            mime_hint: str = "",
                            attempted: Optional[list] = None) -> FileChunk:
        with observe.span("filer.upload_chunk",
                          tags={"bytes": len(data)}):
            last: Optional[Exception] = None
            for attempt in range(2):
                a = await self._assign(collection, replication, ttl)
                rec = FileChunk(fid=a["fid"], offset=offset,
                                size=len(data))
                if attempted is not None:
                    # recorded before the POST: a failure past this point
                    # deletes the fid (a never-landed one answers 404)
                    attempted.append(rec)
                try:
                    body = await self._post_chunk(a, data, ttl, name_hint,
                                                  mime_hint)
                except _LEASE_POISON as e:
                    # the leased volume is gone, sealed or unreachable:
                    # drop every lease on it and retry once on a fresh
                    # fid; the failed attempt may have landed, so its
                    # delete is queued now
                    self._assign_pool.invalidate(a["fid"])
                    self._queue_chunk_deletes([rec])
                    self.metrics.count("upload_stale_assignment")
                    last = e
                    continue
                return FileChunk(fid=a["fid"], offset=offset,
                                 size=len(data), mtime=time.time_ns(),
                                 etag=body.get("eTag", ""))
            raise web.HTTPBadGateway(text=f"chunk upload failed: {last}")

    async def _post_chunk(self, a: dict, payload: bytes, ttl: str,
                          name_hint: str, mime_hint: str) -> dict:
        form = aiohttp.FormData()
        # name and mime hints let the volume server's compression
        # decision see the real content type
        form.add_field("file", payload, filename=name_hint or "chunk",
                       content_type=mime_hint or "application/octet-stream")
        url = f"http://{a['url']}/{a['fid']}"
        if ttl:
            url += f"?ttl={ttl}"
        async with self._session.post(url, data=form) as r:
            if r.status in (401, 404, 409):
                # volume deleted or sealed under the lease: stale
                raise _StaleAssignment(
                    f"chunk upload to {a['url']}: {r.status}")
            if r.status >= 300:
                raise web.HTTPBadGateway(
                    text=f"chunk upload to {a['url']}: {r.status}")
            return await r.json()

    async def _fetch_view(self, fid: str, offset_in_chunk: int,
                          size: int) -> bytes:
        """One view of a chunk, read from a volume server; concurrent
        reads of the same view share one fetch."""
        return await self._fetch_flight.do(
            (fid, offset_in_chunk, size),
            lambda: self._fetch_raw(fid, offset_in_chunk, size))

    async def _fetch_raw(self, fid: str, offset_in_chunk: int = 0,
                         size: int = -1) -> bytes:
        with observe.span("filer.fetch_chunk", tags={"fid": fid}):
            last: Optional[Exception] = None
            for url in await self._lookup(int(fid.split(",")[0])):
                headers = {}
                if size >= 0:
                    headers["Range"] = (f"bytes={offset_in_chunk}-"
                                        f"{offset_in_chunk + size - 1}")
                try:
                    async with self._session.get(f"http://{url}/{fid}",
                                                 headers=headers) as r:
                        if r.status in (200, 206):
                            data = await r.read()
                            if r.status == 200 and size >= 0:
                                data = data[offset_in_chunk:
                                            offset_in_chunk + size]
                            return data
                        last = RuntimeError(f"{url}/{fid}: HTTP {r.status}")
                except aiohttp.ClientError as e:
                    last = e
            raise web.HTTPBadGateway(text=f"fetch chunk {fid}: {last}")

    # --- request dispatch ---
    async def dispatch(self, request: web.Request) -> web.StreamResponse:
        path = "/" + request.match_info["path"]
        if request.method in ("GET", "HEAD"):
            return await self.handle_read(request, path)
        if request.method in ("PUT", "POST"):
            if request.query.get("op") == "mkdir":
                return await self.handle_mkdir(request, path)
            if "mv.to" in request.query:
                return await self.handle_rename(request, path)
            return await self.handle_write(request, path)
        if request.method == "DELETE":
            return await self.handle_delete(request, path)
        return web.json_response({"error": "method not allowed"}, status=405)

    async def handle_read(self, request: web.Request,
                          path: str) -> web.StreamResponse:
        self.metrics.count("read")
        try:
            entry = await self.ring_find(path)
        except FileNotFoundError:
            entry = None
        if entry is None:
            return web.json_response({"error": "not found"}, status=404)
        if entry.is_directory:
            return await self._list_dir(request, path)
        size = entry.size()
        file_etag = f'"{chunks_etag(entry.chunks)}"' if entry.chunks else '""'
        if request.headers.get("If-None-Match") == file_etag:
            return web.Response(status=304)
        start, length, status = 0, size, 200
        headers = {"ETag": file_etag, "Accept-Ranges": "bytes"}
        rng = request.headers.get("Range", "")
        if rng.startswith("bytes="):
            try:
                s, _, e = rng[6:].partition("-")
                if not s:
                    length = min(int(e), size)
                    start = size - length
                else:
                    start = int(s)
                    end = min(int(e) if e else size - 1, size - 1)
                    length = end - start + 1
                if start < 0 or length <= 0:
                    raise ValueError
                status = 206
                headers["Content-Range"] = (
                    f"bytes {start}-{start + length - 1}/{size}")
            except ValueError:
                return web.Response(status=416)
        mime = entry.attr.mime or "application/octet-stream"
        resp = web.StreamResponse(status=status, headers={
            **headers, "Content-Type": mime,
            "Content-Length": str(length)})
        # the header goes out before the chunks are fetched, as
        # upstream's filer streams
        await resp.prepare(request)
        if request.method == "HEAD" or length == 0:
            await resp.write_eof()
            return resp
        try:
            await self._write_views(resp, entry.chunks, start, length)
        except web.HTTPException as e:
            # too late for a status: close the connection short of its
            # Content-Length, as upstream's net/http does, so the client
            # sees a truncated body at once (the reference leaves the
            # connection open and the client waits, ROADMAP Queue 3, D16)
            log.warning("read %s failed after its header: %s", path,
                        e.text)
            self.metrics.count("read_cut_short")
            if request.transport is not None:
                request.transport.close()
            return resp
        await resp.write_eof()
        return resp

    async def _write_views(self, resp: web.StreamResponse,
                           chunks: list[FileChunk], start: int,
                           length: int) -> None:
        if any(c.is_chunk_manifest for c in chunks):
            chunks = await manifest_mod.resolve_manifests(
                chunks, self._fetch_manifest_blob)
        written = start
        for view in read_plan(chunks, start, length):
            if view.logic_offset > written:
                # a sparse hole reads as zeros
                await resp.write(bytes(view.logic_offset - written))
                written = view.logic_offset
            data = await self._fetch_view(view.fid, view.offset_in_chunk,
                                          view.size)
            await resp.write(data)
            written += len(data)
        if written < start + length:
            await resp.write(bytes(start + length - written))

    async def _list_dir(self, request: web.Request,
                        path: str) -> web.Response:
        q = request.query
        limit = int(q.get("limit", 1024))
        entries = await self.ring_list(
            _norm(path), q.get("lastFileName", ""), False, limit,
            q.get("prefix", ""))
        return web.json_response({
            "Path": _norm(path),
            "Entries": [{
                "FullPath": e.full_path,
                "IsDirectory": e.is_directory,
                "Size": e.size(),
                "Mtime": e.attr.mtime,
                "Mime": e.attr.mime,
                "Chunks": len(e.chunks),
            } for e in entries],
            "LastFileName": entries[-1].name if entries else "",
            "ShouldDisplayLoadMore": len(entries) >= limit,
        })

    async def handle_write(self, request: web.Request,
                           path: str) -> web.Response:
        """Auto-chunking upload (filer_server_handlers_write_autochunk.go)."""
        self.metrics.count("write")
        if path.endswith("/"):
            return web.json_response({"error": "cannot write a directory"},
                                     status=400)
        collection = request.query.get("collection",
                                       self.default_collection)
        replication = request.query.get("replication",
                                        self.default_replication)
        ttl = request.query.get("ttl", "")
        mime = request.content_type or "application/octet-stream"
        reader = None
        if request.content_type.startswith("multipart/"):
            mp = await request.multipart()
            part = await mp.next()
            if part is None:
                return web.json_response({"error": "empty multipart"},
                                         status=400)
            if part.headers.get("Content-Type"):
                mime = part.headers["Content-Type"]
            reader = part
        chunks: list[FileChunk] = []
        # every fid a volume server was asked to store: the failure path
        # deletes them all, so an aborted upload leaves no orphan
        attempted: list[FileChunk] = []
        offset = 0
        name_hint = path.rsplit("/", 1)[-1]
        # in a ring the owner's create looks the replaced entry up
        old_entry = None if self.ring is not None else \
            await self._exec(lambda: self.filer.find_entry(path))

        async def upload(index: int, data: bytes, at: int) -> FileChunk:
            return await self._upload_chunk(
                data, collection, replication, ttl, at,
                name_hint=name_hint, mime_hint=mime, attempted=attempted)

        # the body streams into the next chunk while up to
        # upload_concurrency earlier chunks POST; completions land out of
        # order and the offset sort restores the list
        window = UploadWindow(upload, self.upload_concurrency,
                              metrics=self.metrics)
        try:
            with observe.span("filer.upload.window") as sp:
                while True:
                    # both aiohttp readers return what is buffered, not
                    # the size asked: accumulate a whole chunk
                    buf = bytearray()
                    while len(buf) < self.chunk_size:
                        want = self.chunk_size - len(buf)
                        more = (await reader.read_chunk(want)
                                if reader is not None
                                else await request.content.read(want))
                        if not more:
                            break
                        buf += more
                    if not buf:
                        break
                    await window.submit(bytes(buf), offset)
                    offset += len(buf)
                chunks = await window.drain()
                chunks.sort(key=lambda c: c.offset)
                sp.tags["chunks"] = len(chunks)
                sp.tags["stall_ms"] = round(window.stall_s * 1000, 1)
            if len(chunks) > self.manifest_batch:
                # a super-large file: chunk groups fold into manifest
                # blobs (filechunk_manifest.go:41-120)
                async def save_manifest(blob: bytes, at: int) -> FileChunk:
                    return await self._upload_chunk(
                        blob, collection, replication, ttl, at,
                        attempted=attempted)
                chunks = await manifest_mod.maybe_manifestize(
                    chunks, save_manifest, self.manifest_batch)
        except BaseException:
            # cancel the window, then delete every chunk that did (or
            # might have) landed
            await window.abort()
            self._queue_chunk_deletes(attempted)
            raise
        entry = new_file(_norm(path), chunks, mime=mime,
                         collection=collection, replication=replication)
        if ttl:
            from ..storage.types import TTL
            entry.attr.ttl_sec = TTL.parse(ttl).minutes() * 60
        sigs = _parse_signatures(request)
        # ?free_old_chunks=false keeps the replaced entry's chunks (a
        # caller that archived them first)
        free_old = request.query.get("free_old_chunks") != "false"
        if self.ring is not None:
            # the owner frees what the entry replaced
            await self.ring_create(entry, signatures=sigs,
                                   free_old_chunks=free_old)
        else:
            await self._exec(lambda: self.filer.create_entry(
                entry, signatures=sigs))
            if free_old:
                self._queue_chunk_deletes(
                    self.filer.freeable_replaced_chunks(old_entry))
        return web.json_response(
            {"name": entry.name, "size": offset,
             "chunks": len(chunks)}, status=201)

    async def handle_mkdir(self, request: web.Request,
                           path: str) -> web.Response:
        entry = new_directory(_norm(path))
        await self.ring_create(entry, signatures=_parse_signatures(request))
        return web.json_response({"name": entry.full_path}, status=201)

    async def handle_rename(self, request: web.Request,
                            path: str) -> web.Response:
        to = request.query["mv.to"]
        try:
            if self.ring is not None:
                # the two parents' partitions may differ, and a moved
                # directory's levels too: the coordinator creates each
                # entry at its new owner, then drops the old metadata-only
                await self.ring_coordinator.rename(_norm(path), _norm(to))
            else:
                await self._exec(lambda: self.filer.rename(path, to))
        except FileNotFoundError:
            return web.json_response({"error": "not found"}, status=404)
        return web.json_response({"from": _norm(path), "to": _norm(to)})

    async def handle_delete(self, request: web.Request,
                            path: str) -> web.Response:
        self.metrics.count("delete")
        recursive = request.query.get("recursive") == "true"
        sigs = _parse_signatures(request)
        try:
            if self.ring is not None:
                await self.ring_delete_entry_point(
                    path, recursive=recursive, signatures=sigs)
            else:
                await self.ring_delete(path, recursive=recursive,
                                       signatures=sigs)
        except FileNotFoundError:
            return web.json_response({"error": "not found"}, status=404)
        except OSError as e:
            return web.json_response({"error": str(e)}, status=409)
        return web.json_response({"ok": True}, status=202)

    async def healthz(self, request: web.Request) -> web.Response:
        return web.json_response({"ok": True,
                                  "store": self.filer.store.name})

    async def metrics_handler(self, request: web.Request) -> web.Response:
        return web.Response(
            text=self.metrics.render() + metrics_mod.render_shared(),
            content_type="text/plain")


async def run_filer(host: str, port: int, master_url: str, sock=None,
                    store_name: str = "memory",
                    store_kwargs: Optional[dict] = None,
                    **kwargs) -> tuple[FilerServer, web.AppRunner]:
    """Serve a filer on host:port (0 picks a free port), or on `sock`, on
    the running loop; returns the filer (``filer.url`` is host:port) and
    its runner. ``await runner.cleanup()`` stops it and closes its
    store."""
    if sock is None:
        sock = http.listen_socket(host, port)
    # a network store connects (and etcd and elastic send requests) as it
    # opens: never on the loop
    store = await asyncio.get_running_loop().run_in_executor(
        None, lambda: create_store(store_name, **(store_kwargs or {})))
    try:
        server = FilerServer(master_url, store,
                             url=f"{host}:{sock.getsockname()[1]}",
                             **kwargs)
    except BaseException:
        store.close()
        raise
    runner = await http.start_app(server.app, sock)
    log.info("filer on %s -> master %s", server.url, master_url)
    return server, runner
