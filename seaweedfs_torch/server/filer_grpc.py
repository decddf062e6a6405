"""gRPC face of the filer (weed/server/filer_grpc_server*.go).

The port's copy of seaweedfs_tpu/server/filer_grpc.py. It serves the
SeaweedFiler service of proto/filer.proto on the filer's gRPC port (HTTP
port + 10000 by convention): entry CRUD through the same ring-aware
facade as the ``/__meta__/*`` HTTP surface (``ring_find``,
``ring_list``, ``ring_create``...), the ListEntries and
SubscribeMetadata server streams (the latter over the same metadata log
as ``/__meta__/subscribe``: the persisted log and the memory tail since
``since_ns``, then every live mutation under ``path_prefix``, without
what ``exclude_signature`` signed), assignment and lookup through the
filer's lease pool and vid cache, KeepConnected (which keeps the broker
registry that ``LocateBroker`` and ``GET /__meta__/brokers`` answer
from), and the store's KV.

The port's master has no ``/col/list`` or ``/col/delete`` (ROADMAP
Queue 1 A.4): ``CollectionList`` reads the collections off the master's
``/vol/list``, and ``DeleteCollection`` goes to the master's gRPC
``CollectionDelete``.
"""

from __future__ import annotations

import asyncio
import logging

from ..filer.chunks import FileChunk
from ..filer.entry import Attr, Entry
from ..pb import filer_pb2 as pb
from ..pb import rpc

log = logging.getLogger("filer.grpc")


def _ok() -> pb.Ok:
    return pb.Ok(ok=True)


def _err(e) -> pb.Ok:
    return pb.Ok(ok=False, error=str(e))


def _chunk_to_pb(c: FileChunk) -> pb.FileChunk:
    return pb.FileChunk(fid=c.fid, offset=c.offset, size=c.size,
                        mtime_ns=c.mtime, etag=c.etag,
                        is_chunk_manifest=c.is_chunk_manifest,
                        cipher_key=c.cipher_key)


def _chunk_from_pb(c: pb.FileChunk, offset: int) -> FileChunk:
    return FileChunk(fid=c.fid, offset=offset, size=c.size,
                     mtime=c.mtime_ns, etag=c.etag,
                     is_chunk_manifest=c.is_chunk_manifest,
                     cipher_key=c.cipher_key)


def entry_to_pb(e: Entry) -> pb.Entry:
    a = e.attr
    return pb.Entry(
        path=e.full_path,
        attr=pb.FuseAttributes(
            mtime=a.mtime, crtime=a.crtime, mode=a.mode, uid=a.uid,
            gid=a.gid, mime=a.mime, ttl_sec=a.ttl_sec,
            user_name=a.user_name, group_names=a.group_names,
            symlink_target=a.symlink_target, md5=a.md5,
            replication=a.replication, collection=a.collection),
        chunks=[_chunk_to_pb(c) for c in e.chunks],
        extended=dict(e.extended),
        hard_link_id=e.hard_link_id)


def entry_from_pb(m: pb.Entry) -> Entry:
    a = m.attr
    return Entry(
        full_path=m.path,
        attr=Attr(mtime=a.mtime, crtime=a.crtime, mode=a.mode, uid=a.uid,
                  gid=a.gid, mime=a.mime, ttl_sec=a.ttl_sec,
                  user_name=a.user_name, group_names=list(a.group_names),
                  symlink_target=a.symlink_target, md5=a.md5,
                  replication=a.replication, collection=a.collection),
        chunks=[_chunk_from_pb(c, c.offset) for c in m.chunks],
        extended=dict(m.extended),
        hard_link_id=m.hard_link_id)


def _event_to_pb(e) -> pb.MetaEvent:
    msg = pb.MetaEvent(tsns=e.tsns, directory=e.directory,
                       signatures=list(e.signatures))
    if e.old_entry is not None:
        msg.old_entry.CopyFrom(entry_to_pb(e.old_entry))
    if e.new_entry is not None:
        msg.new_entry.CopyFrom(entry_to_pb(e.new_entry))
    return msg


class FilerGrpcServicer:
    def __init__(self, fs):
        self.fs = fs            # FilerServer
        self.filer = fs.filer
        # path -> [lock, holders]: appends to one entry run one at a time
        self._append_locks: dict[str, list] = {}

    # --- entries ---
    async def _find(self, path: str):
        try:
            return await self.fs.ring_find(path or "/")
        except FileNotFoundError:
            return None

    async def LookupDirectoryEntry(self, request: pb.LookupEntryRequest,
                                   context):
        path = request.directory.rstrip("/")
        if request.name:
            path = f"{path}/{request.name}"
        entry = await self._find(path)
        if entry is None:
            return pb.EntryResponse(error="not found")
        return pb.EntryResponse(entry=entry_to_pb(entry))

    async def ListEntries(self, request: pb.ListEntriesRequest, context):
        entries = await self.fs.ring_list(
            request.directory, request.start_from_file_name,
            request.inclusive_start_from, request.limit or 1024,
            request.prefix)
        for e in entries:
            yield pb.EntryResponse(entry=entry_to_pb(e))

    async def CreateEntry(self, request: pb.EntryRequest, context):
        try:
            await self.fs.ring_create(entry_from_pb(request.entry),
                                      o_excl=request.o_excl)
        except FileExistsError:
            return _err("exists")
        except (IsADirectoryError, NotADirectoryError) as e:
            return _err(e)
        return _ok()

    async def UpdateEntry(self, request: pb.EntryRequest, context):
        try:
            await self.fs.ring_update(entry_from_pb(request.entry))
        except FileNotFoundError:
            return _err("not found")
        return _ok()

    async def AppendToEntry(self, request: pb.AppendToEntryRequest,
                            context):
        """Read, extend and write the entry under a per-path lock: two
        appends at once would take one base offset and one chunk list
        would overwrite the other (filer_grpc_server_append.go)."""
        holder = self._append_locks.setdefault(request.path,
                                               [asyncio.Lock(), 0])
        holder[1] += 1
        try:
            async with holder[0]:
                entry = await self._find(request.path)
                if entry is None:
                    return _err("not found")
                offset = entry.size()
                for c in request.chunks:
                    entry.chunks.append(_chunk_from_pb(c, offset))
                    offset += c.size
                await self.fs.ring_update(entry)
        finally:
            holder[1] -= 1
            if holder[1] == 0:
                self._append_locks.pop(request.path, None)
        return _ok()

    async def DeleteEntry(self, request: pb.DeleteEntryRequest, context):
        args = dict(recursive=request.is_recursive,
                    free_chunks=request.is_delete_data)
        try:
            if self.fs.ring is not None:
                await self.fs.ring_delete_entry_point(request.path, **args)
            else:
                await self.fs.ring_delete(request.path, **args)
        except FileNotFoundError as e:
            return _ok() if request.ignore_recursive_error else _err(e)
        except OSError as e:
            return _err(e)
        return _ok()

    async def AtomicRenameEntry(self, request: pb.RenameEntryRequest,
                                context):
        try:
            if self.fs.ring is not None:
                await self.fs.ring_coordinator.rename(request.old_path,
                                                      request.new_path)
            else:
                await self.fs._exec(lambda: self.filer.rename(
                    request.old_path, request.new_path))
        except FileNotFoundError as e:
            return _err(e)
        return _ok()

    # --- assignment and lookup ---
    async def AssignVolume(self, request: pb.AssignVolumeRequest, context):
        from aiohttp import web
        try:
            a = await self.fs._assign(
                request.collection or self.fs.default_collection,
                request.replication or self.fs.default_replication,
                # the TTL's smallest unit is the minute
                f"{max(1, request.ttl_sec // 60)}m" if request.ttl_sec
                else "")
        except web.HTTPError as e:
            return pb.AssignVolumeResponse(error=str(e))
        return pb.AssignVolumeResponse(
            fid=a["fid"], url=a["url"],
            public_url=a.get("publicUrl", a["url"]),
            count=a.get("count", 1), auth=a.get("auth", ""))

    async def LookupVolume(self, request: pb.LookupVolumeRequest, context):
        resp = pb.LookupVolumeResponse()
        for vid_or_fid in request.volume_or_file_ids:
            try:
                urls = await self.fs._lookup(int(vid_or_fid.split(",")[0]))
            except ValueError:
                urls = []
            resp.locations_map[vid_or_fid].urls.extend(urls or [])
        return resp

    # --- collections, statistics, configuration ---
    async def CollectionList(self, request, context):
        body = await self.fs._master_get("/vol/list", {})
        names = set()
        for node in body.get("nodes", []):
            for key in ("volumes", "ec_shards"):
                names.update(v.get("collection", "")
                             for v in node.get(key, []))
        return pb.CollectionListResponse(collections=sorted(names))

    async def DeleteCollection(self, request: pb.DeleteCollectionRequest,
                               context):
        from ..pb import master_pb2 as mpb
        async with rpc.aio_dial(
                rpc.grpc_address(self.fs.master_url)) as channel:
            out = await rpc.MasterStub(channel).CollectionDelete(
                mpb.CollectionDeleteRequest(name=request.collection))
        return _ok() if out.ok else _err(out.error)

    async def Statistics(self, request: pb.StatisticsRequest, context):
        """Usage from the master's inventory (/vol/list), optionally of
        one collection: the master's Statistics computed here."""
        body = await self.fs._master_get("/vol/list", {})
        limit = body.get("volume_size_limit_mb", 0) * 1024 * 1024
        total = used = files = 0
        for node in body.get("nodes", []):
            total += node.get("max_volume_count", 0) * limit
            for v in node.get("volumes", []):
                if request.collection and \
                        v.get("collection") != request.collection:
                    continue
                used += v.get("size", 0)
                files += v.get("file_count", 0)
        return pb.StatisticsResponse(total_size=total, used_size=used,
                                     file_count=files)

    async def GetFilerConfiguration(self, request, context):
        return pb.FilerConfigurationResponse(
            masters=self.fs.masters,
            collection=self.fs.default_collection,
            replication=self.fs.default_replication,
            max_mb=self.fs.chunk_size // (1024 * 1024),
            dir_buckets="/buckets", cipher=False,
            signature=self.filer.signature)

    # --- the metadata streams ---
    async def SubscribeMetadata(self, request: pb.SubscribeMetadataRequest,
                                context):
        async for msg in self._subscribe(request):
            yield msg

    async def SubscribeLocalMetadata(self,
                                     request: pb.SubscribeMetadataRequest,
                                     context):
        # the meta log is this filer's own log (peers' events are
        # replayed into it before they reach it)
        async for msg in self._subscribe(request):
            yield msg

    async def _subscribe(self, request: pb.SubscribeMetadataRequest):
        since = request.since_ns
        prefix = request.path_prefix or "/"
        exclude_sig = request.exclude_signature
        meta_log = self.filer.meta_log
        queue: asyncio.Queue = asyncio.Queue()
        loop = asyncio.get_running_loop()

        def on_event(e) -> None:
            # mutations run on executor threads
            loop.call_soon_threadsafe(queue.put_nowait, e)

        def admit(e) -> bool:
            return not (exclude_sig and exclude_sig in e.signatures)

        self.fs._subscribers.add(queue)
        meta_log.subscribe(on_event)
        try:
            seen = set()
            replay = await self.fs._exec(lambda: list(
                meta_log.read_persisted_since(since, prefix)))
            replay += meta_log.events_since(since, prefix)
            for e in replay:
                if e.tsns in seen:
                    continue
                seen.add(e.tsns)
                if admit(e):
                    yield _event_to_pb(e)
            while True:
                e = await queue.get()
                if e is None:
                    return      # the filer shuts down
                dup = e.tsns in seen
                if seen and queue.empty():
                    # the replay's race with the live tail is over once
                    # the queue drains: stop holding every id seen
                    seen = set()
                if dup or not e.directory.startswith(prefix) \
                        or not admit(e):
                    continue
                yield _event_to_pb(e)
        finally:
            meta_log.unsubscribe(on_event)
            self.fs._subscribers.discard(queue)

    async def KeepConnected(self, request_iterator, context):
        """Clients announce themselves and the filer answers each; a
        ``broker@host:port`` name registers a message broker until its
        stream ends (filer_grpc_server.go KeepConnected)."""
        name = entry = broker = None
        try:
            async for req in request_iterator:
                name = req.name
                entry = list(req.resources)
                self.fs.connected_clients[name] = entry
                if name.startswith("broker@"):
                    broker = name[len("broker@"):]
                    self.fs.broker_registry[broker] = len(entry)
                yield pb.KeepConnectedResponse()
        finally:
            # only this stream's own entry goes: a client that redialled
            # under the same name has replaced it already
            if name is not None \
                    and self.fs.connected_clients.get(name) is entry:
                self.fs.connected_clients.pop(name, None)
                if broker is not None:
                    self.fs.broker_registry.pop(broker, None)

    async def LocateBroker(self, request: pb.LocateBrokerRequest, context):
        brokers = self.fs.broker_registry
        if not brokers:
            return pb.LocateBrokerResponse(found=False)
        return pb.LocateBrokerResponse(found=True, resources=[
            pb.BrokerResource(grpc_address=addr, resource_count=count)
            for addr, count in sorted(brokers.items())])

    # --- the store's KV ---
    async def KvGet(self, request: pb.KvRequest, context):
        val = await self.fs._exec(
            lambda: self.filer.store.kv_get(request.key.decode()))
        if val is None:
            return pb.KvResponse(error="not found")
        return pb.KvResponse(value=val)

    async def KvPut(self, request: pb.KvRequest, context):
        await self.fs._exec(lambda: self.filer.store.kv_put(
            request.key.decode(), bytes(request.value)))
        return _ok()


async def serve_filer_grpc(fs, host: str, port: int):
    """Start a filer's grpc.aio server; the caller stops it."""
    server = await rpc.serve(
        rpc.filer_service_handler(FilerGrpcServicer(fs),
                                  trace_instance=fs.url), host, port)
    log.info("filer gRPC on %s:%d", host, port)
    return server
