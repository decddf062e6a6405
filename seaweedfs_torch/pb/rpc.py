"""gRPC service plumbing for the cluster's four services.

The port's reduced copy of seaweedfs_tpu/pb/rpc.py. grpcio ships no
code generator here, so instead of generated ``*_pb2_grpc`` stubs each
service is registered through gRPC's generic-handler API and clients use
multicallables with explicit serializers: byte-identical on the wire to
what generated stubs produce. Four services (the reference's 4 proto
files):

  seaweedfs_tpu.master.Master              proto/master.proto        (13)
  seaweedfs_tpu.volume.VolumeServer        proto/volume_server.proto (33)
  seaweedfs_tpu.filer.SeaweedFiler         proto/filer.proto         (19)
  seaweedfs_tpu.messaging.SeaweedMessaging proto/messaging.proto     (6)

The service names are wire names, kept letter for letter, so either
package's clients and servers answer each other. gRPC listens on the
HTTP port + 10000 (weed/pb/grpc_client_server.go).

Every served RPC runs inside a fault gate (``rpc.<Method>``: a drop
aborts UNAVAILABLE, an error INTERNAL) and a root span ``grpc
<service>/<Method>``. Client stubs retry the idempotent unary RPCs of
``_RETRYABLE_RPCS`` on UNAVAILABLE with jittered backoff, and give a
call without a timeout the ambient deadline budget as its timeout; the
ambient priority class rides as ``x-seaweed-priority`` metadata.

Left out, with their later home (ROADMAP Queue 1 A.3): TLS on the
channels and servers and the IP whitelist (``security/``), and the
``x-seaweed-trace`` metadata pair. Until then ``dial``/``aio_dial``
refuse a ``security.toml`` that configures TLS or a whitelist, rather
than dial in plain text where TLS was asked for.
"""

from __future__ import annotations

import asyncio
import time

import grpc

from .. import faults, observe, overload
from ..utils import retry as retry_mod
from . import filer_pb2 as fpb
from . import master_pb2 as mpb
from . import messaging_pb2 as msgpb
from . import volume_server_pb2 as vpb

GRPC_PORT_OFFSET = 10000

MASTER_SERVICE = "seaweedfs_tpu.master.Master"
VOLUME_SERVICE = "seaweedfs_tpu.volume.VolumeServer"
FILER_SERVICE = "seaweedfs_tpu.filer.SeaweedFiler"
MESSAGING_SERVICE = "seaweedfs_tpu.messaging.SeaweedMessaging"

PRIORITY_KEY = "x-seaweed-priority"


def grpc_address(http_url: str) -> str:
    """host:port -> host:(port+10000)."""
    host, _, port = http_url.rpartition(":")
    return f"{host}:{int(port) + GRPC_PORT_OFFSET}"


_security_checked = False


def _refuse_security() -> None:
    """Raise when security.toml asks for TLS or an IP whitelist, which
    this package cannot honour yet (read once a process)."""
    global _security_checked
    if _security_checked:
        return
    from ..utils.config import load_configuration
    cfg = load_configuration("security")
    if cfg.get_string("tls.cert_file") and cfg.get_string("tls.key_file"):
        raise RuntimeError("security.toml configures [tls]: gRPC over TLS "
                           "is not supported by this package")
    if cfg.get_string("guard.white_list"):
        raise RuntimeError("security.toml configures a guard whitelist: "
                           "the gRPC planes cannot enforce it yet")
    _security_checked = True


def dial(target: str) -> grpc.Channel:
    """A sync channel to a cluster gRPC endpoint. Its unary-stream calls
    (a degraded read's survivor fetch, from an executor thread) are read
    on the calling thread, with no channel thread between (grpcio's
    SingleThreadedUnaryStream)."""
    _refuse_security()
    from grpc.experimental import ChannelOptions
    return grpc.insecure_channel(target, options=[
        (ChannelOptions.SingleThreadedUnaryStream, 1)])


def aio_dial(target: str) -> grpc.aio.Channel:
    """grpc.aio variant of dial()."""
    _refuse_security()
    return grpc.aio.insecure_channel(target)


# --- service specs: name -> (kind, request type, response type) ---
# kind: uu unary-unary, us unary-stream, ss stream-stream

MASTER_SPEC = {
    "Assign": ("uu", mpb.AssignRequest, mpb.AssignResponse),
    "Lookup": ("uu", mpb.LookupRequest, mpb.LookupResponse),
    "LookupEc": ("uu", mpb.LookupEcRequest, mpb.LookupEcResponse),
    "Heartbeat": ("ss", mpb.HeartbeatRequest, mpb.HeartbeatResponse),
    "KeepConnected": ("us", mpb.KeepConnectedRequest,
                      mpb.VolumeLocationMessage),
    "ClusterStatus": ("uu", mpb.ClusterStatusRequest,
                      mpb.ClusterStatusResponse),
    "LeaseAdminToken": ("uu", mpb.LeaseAdminTokenRequest,
                        mpb.LeaseAdminTokenResponse),
    "ReleaseAdminToken": ("uu", mpb.ReleaseAdminTokenRequest,
                          mpb.ReleaseAdminTokenResponse),
    "VolumeList": ("uu", mpb.VolumeListRequest, mpb.VolumeListResponse),
    "Statistics": ("uu", mpb.StatisticsRequest, mpb.StatisticsResponse),
    "CollectionList": ("uu", mpb.CollectionListRequest,
                       mpb.CollectionListResponse),
    "CollectionDelete": ("uu", mpb.CollectionDeleteRequest,
                         mpb.CollectionDeleteResponse),
    "GetMasterConfiguration": ("uu", mpb.GetMasterConfigurationRequest,
                               mpb.GetMasterConfigurationResponse),
}

VOLUME_SPEC = {
    "BatchDelete": ("uu", vpb.BatchDeleteRequest, vpb.BatchDeleteResponse),
    "VolumeNeedleStatus": ("uu", vpb.NeedleStatusRequest,
                           vpb.NeedleStatusResponse),
    "VacuumVolumeCheck": ("uu", vpb.VolumeRef, vpb.VacuumCheckResponse),
    "VacuumVolumeCompact": ("uu", vpb.VacuumCompactRequest, vpb.Ok),
    "VacuumVolumeCommit": ("uu", vpb.VolumeRef, vpb.Ok),
    "VacuumVolumeCleanup": ("uu", vpb.VolumeRef, vpb.Ok),
    "AllocateVolume": ("uu", vpb.AllocateVolumeRequest, vpb.Ok),
    "VolumeMount": ("uu", vpb.VolumeRef, vpb.Ok),
    "VolumeUnmount": ("uu", vpb.VolumeRef, vpb.Ok),
    "VolumeDelete": ("uu", vpb.VolumeRef, vpb.Ok),
    "VolumeMarkReadonly": ("uu", vpb.VolumeRef, vpb.Ok),
    "VolumeMarkWritable": ("uu", vpb.VolumeRef, vpb.Ok),
    "VolumeConfigure": ("uu", vpb.VolumeConfigureRequest, vpb.Ok),
    "VolumeStatus": ("uu", vpb.VolumeRef, vpb.VolumeStatusResponse),
    "DeleteCollection": ("uu", vpb.DeleteCollectionRequest, vpb.Ok),
    "VolumeCopy": ("uu", vpb.VolumeCopyRequest, vpb.Ok),
    "ReadVolumeFileStatus": ("uu", vpb.VolumeRef,
                             vpb.VolumeFileStatusResponse),
    "CopyFile": ("us", vpb.CopyFileRequest, vpb.DataChunk),
    "VolumeTail": ("us", vpb.TailRequest, vpb.DataChunk),
    "VolumeTailSender": ("us", vpb.TailRequest, vpb.DataChunk),
    "VolumeTailReceiver": ("uu", vpb.TailReceiverRequest, vpb.Ok),
    "VolumeSyncStatus": ("uu", vpb.VolumeRef,
                         vpb.VolumeSyncStatusResponse),
    "VolumeIncrementalCopy": ("us", vpb.TailRequest, vpb.DataChunk),
    "VolumeEcShardsGenerate": ("uu", vpb.EcGenerateRequest, vpb.Ok),
    "VolumeEcShardsRebuild": ("uu", vpb.EcRebuildRequest,
                              vpb.EcRebuildResponse),
    "VolumeEcShardsCopy": ("uu", vpb.EcCopyRequest, vpb.Ok),
    "VolumeEcShardsDelete": ("uu", vpb.EcShardsRequest, vpb.Ok),
    "VolumeEcShardsMount": ("uu", vpb.EcShardsRequest, vpb.Ok),
    "VolumeEcShardsUnmount": ("uu", vpb.EcShardsRequest, vpb.Ok),
    "VolumeEcShardRead": ("us", vpb.EcShardReadRequest, vpb.DataChunk),
    "VolumeEcBlobDelete": ("uu", vpb.EcBlobDeleteRequest, vpb.Ok),
    "VolumeEcShardsToVolume": ("uu", vpb.VolumeRef, vpb.Ok),
    "VolumeTierMoveDatToRemote": ("uu", vpb.TierMoveRequest, vpb.Ok),
    "VolumeTierMoveDatFromRemote": ("uu", vpb.TierMoveRequest, vpb.Ok),
    "VolumeServerStatus": ("uu", vpb.Empty,
                           vpb.VolumeServerStatusResponse),
    "VolumeServerLeave": ("uu", vpb.Empty, vpb.Ok),
    "Query": ("us", vpb.QueryRequest, vpb.DataChunk),
}

FILER_SPEC = {
    "LookupDirectoryEntry": ("uu", fpb.LookupEntryRequest,
                             fpb.EntryResponse),
    "ListEntries": ("us", fpb.ListEntriesRequest, fpb.EntryResponse),
    "CreateEntry": ("uu", fpb.EntryRequest, fpb.Ok),
    "UpdateEntry": ("uu", fpb.EntryRequest, fpb.Ok),
    "AppendToEntry": ("uu", fpb.AppendToEntryRequest, fpb.Ok),
    "DeleteEntry": ("uu", fpb.DeleteEntryRequest, fpb.Ok),
    "AtomicRenameEntry": ("uu", fpb.RenameEntryRequest, fpb.Ok),
    "AssignVolume": ("uu", fpb.AssignVolumeRequest,
                     fpb.AssignVolumeResponse),
    "LookupVolume": ("uu", fpb.LookupVolumeRequest,
                     fpb.LookupVolumeResponse),
    "CollectionList": ("uu", fpb.Empty, fpb.CollectionListResponse),
    "DeleteCollection": ("uu", fpb.DeleteCollectionRequest, fpb.Ok),
    "Statistics": ("uu", fpb.StatisticsRequest, fpb.StatisticsResponse),
    "GetFilerConfiguration": ("uu", fpb.Empty,
                              fpb.FilerConfigurationResponse),
    "SubscribeMetadata": ("us", fpb.SubscribeMetadataRequest,
                          fpb.MetaEvent),
    "SubscribeLocalMetadata": ("us", fpb.SubscribeMetadataRequest,
                               fpb.MetaEvent),
    "KeepConnected": ("ss", fpb.KeepConnectedRequest,
                      fpb.KeepConnectedResponse),
    "LocateBroker": ("uu", fpb.LocateBrokerRequest,
                     fpb.LocateBrokerResponse),
    "KvGet": ("uu", fpb.KvRequest, fpb.KvResponse),
    "KvPut": ("uu", fpb.KvRequest, fpb.Ok),
}

MESSAGING_SPEC = {
    "Subscribe": ("ss", msgpb.SubscriberMessage, msgpb.BrokerMessage),
    "Publish": ("ss", msgpb.PublishRequest, msgpb.PublishResponse),
    "DeleteTopic": ("uu", msgpb.DeleteTopicRequest,
                    msgpb.DeleteTopicResponse),
    "ConfigureTopic": ("uu", msgpb.ConfigureTopicRequest,
                       msgpb.ConfigureTopicResponse),
    "GetTopicConfiguration": ("uu", msgpb.GetTopicConfigurationRequest,
                              msgpb.GetTopicConfigurationResponse),
    "FindBroker": ("uu", msgpb.FindBrokerRequest, msgpb.FindBrokerResponse),
}

_HANDLER_FACTORY = {
    "uu": grpc.unary_unary_rpc_method_handler,
    "us": grpc.unary_stream_rpc_method_handler,
    "ss": grpc.stream_stream_rpc_method_handler,
}


def _traced(method, kind: str, service: str, rpc_name: str,
            instance: str):
    """Wrap a servicer method in a per-RPC root span; a slow unary RPC
    logs as a slow HTTP request does. Streams (Heartbeat, KeepConnected)
    may live for hours: their span is recorded at close, never
    slow-logged."""
    name = f"grpc {rpc_name}"
    ctx = observe.TraceCtx("", "", service, instance)

    if kind in ("us", "ss"):
        async def stream_wrapper(request, context):
            with observe.Span(name, ctx=ctx, root=True):
                async for item in method(request, context):
                    yield item
        return stream_wrapper

    async def unary_wrapper(request, context):
        sp = observe.Span(name, ctx=ctx, root=True)
        try:
            with sp:
                return await method(request, context)
        finally:
            observe.maybe_log_slow(sp)
    return unary_wrapper


async def _gate(point: str, context) -> None:
    try:
        dropped = await faults.fire_async(point)
    except faults.FaultError as e:
        await context.abort(grpc.StatusCode.INTERNAL, str(e))
    if dropped:
        await context.abort(grpc.StatusCode.UNAVAILABLE, "injected drop")


def _faulted(method, kind: str, rpc_name: str):
    """Wrap a servicer method in the fault gate ``rpc.<Method>``."""
    point = f"rpc.{rpc_name}"

    if kind in ("us", "ss"):
        async def stream_wrapper(request, context):
            await _gate(point, context)
            async for item in method(request, context):
                yield item
        return stream_wrapper

    async def unary_wrapper(request, context):
        await _gate(point, context)
        return await method(request, context)
    return unary_wrapper


def service_handler(service: str, spec: dict, servicer,
                    trace_service: str = "",
                    trace_instance: str = "") -> grpc.GenericRpcHandler:
    """Bind a servicer object (async methods named like the RPCs) into a
    generic handler grpc.aio can serve. Methods the servicer does not
    implement are not registered (grpc answers UNIMPLEMENTED)."""
    svc_label = trace_service or service.rsplit(".", 1)[-1].lower()
    handlers = {}
    for name, (kind, req, resp) in spec.items():
        method = getattr(servicer, name, None)
        if method is None:
            continue
        method = _traced(_faulted(method, kind, name), kind, svc_label,
                         f"{service}/{name}", trace_instance)
        handlers[name] = _HANDLER_FACTORY[kind](
            method, request_deserializer=req.FromString,
            response_serializer=resp.SerializeToString)
    return grpc.method_handlers_generic_handler(service, handlers)


def _with_priority(multicallable):
    """Wrap a client multicallable so every RPC carries the ambient
    priority class as metadata (the HTTP clients' X-Seaweed-Priority)."""
    def call(request, **kwargs):
        cls = overload.current_priority()
        if cls:
            meta = list(kwargs.get("metadata") or ())
            meta.append((PRIORITY_KEY, cls))
            kwargs["metadata"] = meta
        return multicallable(request, **kwargs)
    return call


_RPC_RETRY = retry_mod.RetryPolicy(max_attempts=3, base_delay=0.05,
                                   max_delay=1.0)

# Only these unary RPCs are retried on UNAVAILABLE: a connection can
# break after the server executed, and re-sending a destructive op
# (VolumeDelete, VacuumVolumeCommit, shard deletes...) would run it
# twice. Reads, lookups and status are safe; Assign only mints fresh
# ids. Everything else fails fast to its caller.
_RETRYABLE_RPCS = frozenset({
    "Assign", "Lookup", "LookupEc", "ClusterStatus", "VolumeList",
    "Statistics", "CollectionList", "GetMasterConfiguration",
    "VolumeNeedleStatus", "VacuumVolumeCheck", "VolumeStatus",
    "ReadVolumeFileStatus", "VolumeSyncStatus", "VolumeServerStatus",
    "LookupDirectoryEntry", "LookupVolume", "GetFilerConfiguration",
    "KvGet", "LocateBroker", "FindBroker", "GetTopicConfiguration",
})


def _retryable(e: grpc.RpcError, attempt: int) -> bool:
    return (e.code() == grpc.StatusCode.UNAVAILABLE
            and attempt < _RPC_RETRY.max_attempts - 1)


def _retried_unary(call_fn):
    """Retry a unary multicallable on UNAVAILABLE with the jittered
    backoff of utils/retry.py; a call without a timeout gets the ambient
    deadline budget as its timeout. Works on sync channels (errors raise
    inline) and aio channels (errors surface at the await)."""

    def call(request, **kwargs):
        if kwargs.get("timeout") is None:
            left = retry_mod.remaining_budget()
            if left is not None:
                kwargs["timeout"] = max(left, 0.001)
        attempt = 0
        while True:
            try:
                result = call_fn(request, **kwargs)
            except grpc.RpcError as e:
                if not _retryable(e, attempt):
                    raise
                time.sleep(_RPC_RETRY.backoff(attempt))
                attempt += 1
                continue
            if not hasattr(result, "__await__"):
                return result

            async def awaited(first=result):
                a, c = 0, first
                while True:
                    try:
                        return await c
                    except grpc.RpcError as e:
                        if not _retryable(e, a):
                            raise
                        await asyncio.sleep(_RPC_RETRY.backoff(a))
                        a += 1
                        c = call_fn(request, **kwargs)
            return awaited()

    return call


class _SpecStub:
    """Client multicallables (what a generated stub would hold)."""

    def __init__(self, channel, service: str, spec: dict):
        factories = {"uu": channel.unary_unary,
                     "us": channel.unary_stream,
                     "ss": channel.stream_stream}
        for name, (kind, req, resp) in spec.items():
            call = _with_priority(factories[kind](
                f"/{service}/{name}",
                request_serializer=req.SerializeToString,
                response_deserializer=resp.FromString))
            if kind == "uu" and name in _RETRYABLE_RPCS:
                call = _retried_unary(call)
            setattr(self, name, call)


class MasterStub(_SpecStub):
    def __init__(self, channel):
        super().__init__(channel, MASTER_SERVICE, MASTER_SPEC)


class VolumeServerStub(_SpecStub):
    def __init__(self, channel):
        super().__init__(channel, VOLUME_SERVICE, VOLUME_SPEC)


class FilerStub(_SpecStub):
    def __init__(self, channel):
        super().__init__(channel, FILER_SERVICE, FILER_SPEC)


class MessagingStub(_SpecStub):
    def __init__(self, channel):
        super().__init__(channel, MESSAGING_SERVICE, MESSAGING_SPEC)


def master_service_handler(servicer, trace_instance: str = ""):
    return service_handler(MASTER_SERVICE, MASTER_SPEC, servicer,
                           "master", trace_instance)


def volume_service_handler(servicer, trace_instance: str = ""):
    return service_handler(VOLUME_SERVICE, VOLUME_SPEC, servicer,
                           "volume", trace_instance)


def filer_service_handler(servicer, trace_instance: str = ""):
    return service_handler(FILER_SERVICE, FILER_SPEC, servicer,
                           "filer", trace_instance)


def messaging_service_handler(servicer, trace_instance: str = ""):
    return service_handler(MESSAGING_SERVICE, MESSAGING_SPEC, servicer,
                           "broker", trace_instance)


async def serve(handler: grpc.GenericRpcHandler, host: str,
                port: int) -> grpc.aio.Server:
    """Start a grpc.aio server with one service; the caller stops it
    with ``await server.stop(grace)``."""
    _refuse_security()
    server = grpc.aio.server()
    server.add_generic_rpc_handlers((handler,))
    # a port that cannot be bound raises (some grpc versions answer 0)
    if not server.add_insecure_port(f"{host}:{port}"):
        raise RuntimeError(f"gRPC port {host}:{port} could not be bound")
    await server.start()
    return server
