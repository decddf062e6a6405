"""gRPC face of the volume server (weed/server/volume_grpc_*.go).

The port's copy of seaweedfs_tpu/server/volume_grpc.py. It serves the
VolumeServer service of proto/volume_server.proto on the server's gRPC
port (HTTP port + 10000 by convention). The handlers go through the
same Store internals as the HTTP ``/admin/*`` surface; the bulk
surfaces (CopyFile, VolumeTail, VolumeIncrementalCopy, VolumeEcShardRead,
Query) are server streams of ``DataChunk``s, the last one ``is_last``.
``VolumeEcShardsGenerate`` and ``VolumeEcShardsRebuild`` run the store's
coder (the CUDA kernels under ``auto``); a degraded read's survivor
fetches from peers ride ``VolumeEcShardRead``.

The port's own differences: ``VolumeTierMoveDatToRemote`` refuses
``keep_local_dat_file`` (``-keepLocal`` is not ported), a shard copy
also takes the ``.ecm`` and its digest stamps (as the HTTP
``/admin/ec/copy`` does), and ``ReadVolumeFileStatus`` reads the
superblock's compaction revision (the reference's answers an error).
"""

from __future__ import annotations

import asyncio
import functools
import json
import logging
import os
import shutil

import grpc

from ..ec.geometry import to_ext
from ..pb import rpc
from ..pb import volume_server_pb2 as pb
from ..storage.store import safe_collection
from ..storage.volume import VolumeCompacting
from ..utils import durable

log = logging.getLogger("volume.grpc")

_CHUNK = 1 << 20


async def _run(fn, *args):
    return await asyncio.get_running_loop().run_in_executor(None, fn, *args)


def _ok() -> pb.Ok:
    return pb.Ok(ok=True)


def _err(e) -> pb.Ok:
    return pb.Ok(ok=False, error=str(e))


def _last(error: str = "") -> pb.DataChunk:
    return pb.DataChunk(error=error, is_last=True)


class VolumeGrpcServicer:
    def __init__(self, vs):
        self.vs = vs
        self.store = vs.store

    async def _beat(self) -> None:
        """The heartbeat after a change, so the master's view is current
        when the caller's next request lands."""
        try:
            await self.vs.send_heartbeat()
        except Exception as e:
            log.warning("post-admin heartbeat failed: %s", e)

    # --- the data plane ---
    async def BatchDelete(self, request: pb.BatchDeleteRequest, context):
        from ..storage.file_id import FileId
        from ..storage.needle import Needle
        results = []
        for fid_str in request.fids:
            try:
                fid = FileId.parse(fid_str)
                size = await _run(self.store.delete_needle, fid.volume_id,
                                  Needle(cookie=fid.cookie, id=fid.key))
                results.append(pb.DeleteResult(fid=fid_str, status=202,
                                               size=size))
            except Exception as e:
                results.append(pb.DeleteResult(fid=fid_str, status=404,
                                               error=str(e)))
        return pb.BatchDeleteResponse(results=results)

    async def VolumeNeedleStatus(self, request: pb.NeedleStatusRequest,
                                 context):
        try:
            n = await _run(self.store.read_needle, request.volume_id,
                           request.needle_id)
        except Exception as e:
            return pb.NeedleStatusResponse(error=str(e))
        return pb.NeedleStatusResponse(
            cookie=n.cookie, size=len(n.data),
            last_modified=n.last_modified or 0, crc=n.checksum or 0,
            ttl=str(n.ttl or ""))

    # --- vacuum ---
    async def VacuumVolumeCheck(self, request: pb.VolumeRef, context):
        try:
            return pb.VacuumCheckResponse(
                garbage_ratio=self.store.vacuum_check(request.volume_id))
        except KeyError:
            return pb.VacuumCheckResponse(error="volume not found")

    async def VacuumVolumeCompact(self, request: pb.VacuumCompactRequest,
                                  context):
        try:
            await _run(self.store.vacuum_compact, request.volume_id,
                       request.compaction_byte_per_second)
        except (KeyError, RuntimeError) as e:
            return _err(e)
        return _ok()

    async def VacuumVolumeCommit(self, request: pb.VolumeRef, context):
        try:
            await _run(self.store.vacuum_commit, request.volume_id)
        except (KeyError, RuntimeError) as e:
            return _err(e)
        return _ok()

    async def VacuumVolumeCleanup(self, request: pb.VolumeRef, context):
        try:
            self.store.vacuum_cleanup(request.volume_id)
        except KeyError as e:
            return _err(e)
        return _ok()

    # --- a volume's life ---
    async def AllocateVolume(self, request: pb.AllocateVolumeRequest,
                             context):
        try:
            await _run(self.store.add_volume, request.volume_id,
                       request.collection, request.replication or "000",
                       request.ttl)
        except (ValueError, RuntimeError) as e:
            return _err(e)
        await self._beat()
        return _ok()

    async def VolumeMount(self, request: pb.VolumeRef, context):
        try:
            await _run(self.store.mount_volume, request.volume_id,
                       request.collection)
        except Exception as e:
            return _err(e)
        await self._beat()
        return _ok()

    async def _flag(self, ok: bool, beat: bool = False) -> pb.Ok:
        if beat:
            await self._beat()
        return pb.Ok(ok=ok, error="" if ok else "volume not found")

    async def VolumeUnmount(self, request: pb.VolumeRef, context):
        return await self._flag(
            self.store.unmount_volume(request.volume_id), beat=True)

    async def VolumeDelete(self, request: pb.VolumeRef, context):
        return await self._flag(
            self.store.delete_volume(request.volume_id), beat=True)

    async def VolumeMarkReadonly(self, request: pb.VolumeRef, context):
        return await self._flag(
            self.store.mark_readonly(request.volume_id, True))

    async def VolumeMarkWritable(self, request: pb.VolumeRef, context):
        return await self._flag(
            self.store.mark_readonly(request.volume_id, False))

    async def VolumeConfigure(self, request: pb.VolumeConfigureRequest,
                              context):
        try:
            self.store.configure_replication(request.volume_id,
                                             request.replication)
        except Exception as e:
            return _err(e)
        return _ok()

    async def VolumeStatus(self, request: pb.VolumeRef, context):
        v = self.store.find_volume(request.volume_id)
        if v is None:
            return pb.VolumeStatusResponse(error="volume not found")
        return pb.VolumeStatusResponse(
            is_read_only=v.read_only, volume_size=v.data_file_size(),
            file_count=v.file_count(), delete_count=v.nm.deleted_count)

    async def DeleteCollection(self, request: pb.DeleteCollectionRequest,
                               context):
        vids = [vid for loc in self.store.locations
                for vid, v in list(loc.volumes.items())
                if v.collection == request.collection]
        for vid in vids:
            self.store.delete_volume(vid)
        await self._beat()
        return _ok()

    # --- copies, tails, sync ---
    async def VolumeCopy(self, request: pb.VolumeCopyRequest, context):
        """Pull a whole volume over the source's CopyFile stream and
        mount it (volume_grpc_copy.go:24-151)."""
        from ..storage.needle_map import remove_sidecars
        from ..storage.volume import Volume
        vid, collection = request.volume_id, request.collection
        if not safe_collection(collection):
            return _err("bad collection")
        if self.store.find_volume(vid) is not None:
            return _err("volume exists")
        open_locs = [loc for loc in self.store.locations
                     if len(loc.volumes) < loc.max_volume_count]
        if not open_locs:
            return _err("no free slots")
        loc = min(open_locs, key=lambda loc: len(loc.volumes))
        prefix = f"{collection}_" if collection else ""
        base = os.path.join(loc.directory, f"{prefix}{vid}")
        try:
            for ext in (".dat", ".idx"):
                await pull_file_grpc(request.source_data_node, vid,
                                     collection, ext, base + ext)
            # the pulled .idx replaced any journal here wholesale
            remove_sidecars(base + ".idx")
            v = await _run(functools.partial(
                Volume, loc.directory, collection, vid,
                needle_map_kind=self.store.needle_map_kind))
            loc.volumes[vid] = v
        except (OSError, grpc.RpcError, ValueError) as e:
            for ext in (".dat", ".idx", ".swm", ".sdx"):
                if os.path.exists(base + ext):
                    os.remove(base + ext)
            return _err(e)
        await self._beat()
        return _ok()

    async def ReadVolumeFileStatus(self, request: pb.VolumeRef, context):
        v = self.store.find_volume(request.volume_id)
        if v is None:
            return pb.VolumeFileStatusResponse(error="volume not found")
        idx = v.base_file_name() + ".idx"
        return pb.VolumeFileStatusResponse(
            volume_id=request.volume_id,
            idx_file_size=os.path.getsize(idx) if os.path.exists(idx) else 0,
            dat_file_size=v.data_file_size(), file_count=v.file_count(),
            compaction_revision=v.super_block.compaction_revision,
            collection=v.collection)

    async def CopyFile(self, request: pb.CopyFileRequest, context):
        """Stream one volume or shard file to a pulling peer."""
        ext = request.ext
        if not ext.startswith(".") or "/" in ext or ".." in ext \
                or not safe_collection(request.collection):
            yield _last("bad ext or collection")
            return
        prefix = f"{request.collection}_" if request.collection else ""
        path = next((p for p in (
            os.path.join(loc.directory, f"{prefix}{request.volume_id}{ext}")
            for loc in self.store.locations) if os.path.exists(p)), None)
        if path is None:
            yield _last("file not found")
            return
        stop = request.stop_offset or os.path.getsize(path)
        with open(path, "rb") as f:
            sent = 0
            while sent < stop:
                chunk = await _run(f.read, min(_CHUNK, stop - sent))
                if not chunk:
                    break
                sent += len(chunk)
                yield pb.DataChunk(data=chunk)
        yield _last()

    async def VolumeTail(self, request: pb.TailRequest, context):
        """One needle record a chunk, each appended after since_ns
        (VolumeTailSender, volume_grpc_tail.go:16-79)."""
        from ..storage import volume_backup
        v = self.store.find_volume(request.volume_id)
        if v is None:
            yield _last("volume not found")
            return
        it = volume_backup.iter_needles_since(v, request.since_ns)

        def next_record():
            n = next(it, None)
            return None if n is None else n.to_bytes(v.version)

        while True:
            rec = await _run(next_record)
            if rec is None:
                break
            yield pb.DataChunk(data=rec)
        yield _last()

    async def VolumeIncrementalCopy(self, request: pb.TailRequest,
                                    context):
        async for chunk in self.VolumeTail(request, context):
            yield chunk

    async def VolumeTailSender(self, request: pb.TailRequest, context):
        async for chunk in self.VolumeTail(request, context):
            yield chunk

    async def VolumeSyncStatus(self, request: pb.VolumeRef, context):
        """The tail offset and compaction revision of an incremental sync
        (volume_grpc_sync.go)."""
        v = self.store.find_volume(request.volume_id)
        if v is None:
            return pb.VolumeSyncStatusResponse(error="volume not found")
        idx = v.base_file_name() + ".idx"
        return pb.VolumeSyncStatusResponse(
            volume_id=request.volume_id, collection=v.collection,
            tail_offset=v.data_file_size(),
            compact_revision=v.super_block.compaction_revision,
            idx_file_size=os.path.getsize(idx) if os.path.exists(idx) else 0)

    async def VolumeTailReceiver(self, request: pb.TailReceiverRequest,
                                 context):
        """Pull the source's new needle records and append them here
        (volume_grpc_tail.go:81-126)."""
        from ..storage import volume_backup
        from ..storage.needle import Needle
        v = self.store.find_volume(request.volume_id)
        if v is None:
            return _err("volume not found")
        applied = 0
        async with rpc.aio_dial(
                rpc.grpc_address(request.source_volume_server)) as channel:
            async for chunk in rpc.VolumeServerStub(channel).VolumeTail(
                    pb.TailRequest(volume_id=request.volume_id,
                                   since_ns=request.since_ns)):
                if chunk.error:
                    return _err(chunk.error)
                if chunk.is_last:
                    break
                # an empty body is a delete; the source's append time is
                # kept, so the next tail resumes where this one ended
                await _run(volume_backup.apply_tailed_needle, v,
                           Needle.from_bytes(chunk.data, v.version))
                applied += 1
        log.info("tail-receive applied %d records to %d", applied,
                 request.volume_id)
        return _ok()

    # --- erasure coding ---
    async def VolumeEcShardsGenerate(self, request: pb.EcGenerateRequest,
                                     context):
        try:
            await _run(self.store.ec_generate, request.volume_id)
        except (KeyError, ValueError, VolumeCompacting) as e:
            return _err(e)
        return _ok()

    async def VolumeEcShardsRebuild(self, request: pb.EcRebuildRequest,
                                    context):
        try:
            rebuilt = await _run(self.store.ec_rebuild, request.volume_id,
                                 request.collection)
        except (KeyError, ValueError) as e:
            return pb.EcRebuildResponse(error=str(e))
        return pb.EcRebuildResponse(rebuilt_shard_ids=rebuilt)

    async def VolumeEcShardsCopy(self, request: pb.EcCopyRequest, context):
        """Pull shard files over the source's CopyFile stream; the index,
        journal and marker with them when asked, and the copied shards'
        digest stamps."""
        vid, collection = request.volume_id, request.collection
        if not safe_collection(collection):
            return _err("bad collection")
        prefix = f"{collection}_" if collection else ""
        base = os.path.join(self.store.locations[0].directory,
                            f"{prefix}{vid}")
        exts = [to_ext(sid) for sid in request.shard_ids]
        if request.copy_ecx_file:
            exts += [".ecx", ".ecj", ".ecm"]
        try:
            for ext in exts:
                try:
                    await pull_file_grpc(request.source_data_node, vid,
                                         collection, ext, base + ext)
                except FileNotFoundError:
                    if ext in (".ecj", ".ecm"):
                        continue    # the journal and marker are optional
                    raise
            await self.vs._take_stamps(request.source_data_node, vid,
                                       collection, base,
                                       list(request.shard_ids))
        except Exception as e:
            return _err(e)
        return _ok()

    async def VolumeEcShardsDelete(self, request: pb.EcShardsRequest,
                                   context):
        await _run(self.store.ec_delete_shards, request.volume_id,
                   request.collection, list(request.shard_ids))
        await self._beat()
        return _ok()

    async def VolumeEcShardsMount(self, request: pb.EcShardsRequest,
                                  context):
        try:
            await _run(self.store.ec_mount, request.volume_id,
                       request.collection, list(request.shard_ids))
        except (KeyError, FileNotFoundError) as e:
            return _err(e)
        await self._beat()
        return _ok()

    async def VolumeEcShardsUnmount(self, request: pb.EcShardsRequest,
                                    context):
        self.store.ec_unmount(request.volume_id, list(request.shard_ids))
        await self._beat()
        return _ok()

    async def VolumeEcShardRead(self, request: pb.EcShardReadRequest,
                                context):
        """Stream a shard's byte range (volume_grpc_erasure_coding.go:
        270-328): a degraded read's survivor fetch from a peer. Each
        chunk is read on the loop, as ``/admin/ec/shard_read`` reads its
        range: the fetching read waits in an executor thread, and where
        servers share a process an executor hop here queues behind the
        very reads that wait on it (the reference hops)."""
        offset, remaining = request.offset, request.size
        try:
            while remaining > 0:
                n = min(_CHUNK, remaining)
                data = self.store.ec_shard_read(request.volume_id,
                                                request.shard_id, offset, n)
                if data:
                    yield pb.DataChunk(data=data)
                if len(data) < n:
                    # past the shard's end: a truncated stream must not
                    # look complete
                    yield _last(f"short read at {offset + len(data)}")
                    return
                offset += n
                remaining -= n
        except KeyError as e:
            yield _last(str(e))
            return
        yield _last()

    async def VolumeEcBlobDelete(self, request: pb.EcBlobDeleteRequest,
                                 context):
        try:
            self.store.ec_blob_delete(request.volume_id, request.file_key)
        except KeyError as e:
            return _err(e)
        return _ok()

    async def VolumeEcShardsToVolume(self, request: pb.VolumeRef, context):
        try:
            await _run(self.store.ec_to_volume, request.volume_id,
                       request.collection)
        except (KeyError, FileNotFoundError) as e:
            return _err(e)
        await self._beat()
        return _ok()

    # --- the object-store tier ---
    async def VolumeTierMoveDatToRemote(self, request: pb.TierMoveRequest,
                                        context):
        """destination_backend_name carries the JSON backend spec (the
        HTTP surface's ``backend``)."""
        if request.keep_local_dat_file:
            return _err("keep_local_dat_file is not supported")
        try:
            spec = json.loads(request.destination_backend_name)
        except ValueError:
            return _err("destination_backend_name must be a JSON "
                        "backend spec")
        try:
            await _run(self.store.tier_upload, request.volume_id, spec)
        except Exception as e:
            return _err(e)
        await self._beat()
        return _ok()

    async def VolumeTierMoveDatFromRemote(self, request: pb.TierMoveRequest,
                                          context):
        try:
            await _run(self.store.tier_download, request.volume_id)
        except (KeyError, ValueError) as e:
            return _err(e)
        await self._beat()
        return _ok()

    # --- the server ---
    async def VolumeServerStatus(self, request, context):
        disks, volumes, shards = [], 0, 0
        for loc in self.store.locations:
            try:
                u = shutil.disk_usage(loc.directory)
                disks.append(pb.DiskStatus(dir=loc.directory, all=u.total,
                                           used=u.used, free=u.free))
            except OSError:
                pass
            volumes += len(loc.volumes)
            shards += sum(len(ev.shards) for ev in loc.ec_volumes.values())
        return pb.VolumeServerStatusResponse(
            disk_statuses=disks, volume_count=volumes,
            ec_shard_count=shards, version="seaweedfs-torch")

    async def VolumeServerLeave(self, request, context):
        """Stop heartbeating, so the master prunes this node
        (command_volume_server_leave.go)."""
        if self.vs._hb_task is not None:
            self.vs._hb_task.cancel()
            self.vs._hb_task = None
        return _ok()

    # --- query pushdown ---
    async def Query(self, request: pb.QueryRequest, context):
        """Filter and project the JSON documents of the named fids
        (volume_grpc_query.go:13-69), read as ``/admin/query`` reads
        them: one executor call, through the store, so a fid on an EC
        volume with lost shards is reconstructed on the card."""
        from ..query import QueryFilter, query_json_lines
        flt = None
        if request.filter_json:
            try:
                f = json.loads(request.filter_json)
                flt = QueryFilter(f["field"], f.get("op", "="),
                                  f.get("value"))
            except (ValueError, KeyError) as e:
                yield _last(f"bad filter: {e}")
                return
        payloads = await _run(self.vs.read_query_payloads,
                              list(request.file_ids))
        for line in query_json_lines(payloads, flt,
                                     list(request.selections) or None):
            yield pb.DataChunk(data=line.encode() + b"\n")
        yield _last()


async def pull_file_grpc(source_http_url: str, vid: int, collection: str,
                         ext: str, dest_path: str) -> None:
    """Fetch one volume or shard file of a peer's over its CopyFile
    stream into dest_path (durably, through a .tmp); FileNotFoundError
    when the peer lacks the file."""
    tmp = dest_path + ".tmp"
    try:
        async with rpc.aio_dial(rpc.grpc_address(source_http_url)) as ch:
            with open(tmp, "wb") as f:
                async for chunk in rpc.VolumeServerStub(ch).CopyFile(
                        pb.CopyFileRequest(volume_id=vid,
                                           collection=collection, ext=ext)):
                    if chunk.error:
                        if "not found" in chunk.error:
                            raise FileNotFoundError(chunk.error)
                        raise IOError(chunk.error)
                    if chunk.data:
                        f.write(chunk.data)
                    if chunk.is_last:
                        break
        # a pulled copy counts in a repair plan once it lands: commit it
        await _run(durable.replace_atomic, tmp, dest_path)
    finally:
        # a transport error lands here too: no partial .tmp stays
        if os.path.exists(tmp):
            os.remove(tmp)


async def serve_volume_grpc(vs, host: str, port: int):
    """Start a volume server's grpc.aio server; the caller stops it."""
    server = await rpc.serve(
        rpc.volume_service_handler(VolumeGrpcServicer(vs),
                                   trace_instance=vs.url), host, port)
    log.info("volume gRPC on %s:%d", host, port)
    return server
