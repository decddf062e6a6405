"""gRPC face of the message broker (proto/messaging.proto: the
reference's weed/pb/messaging.proto SeaweedMessaging service).

The port's copy of seaweedfs_tpu/messaging/broker_grpc.py.

Publish and Subscribe are bidi streams: one connection carries a whole
session, with redirect messages steering clients to the partition's
owning broker (the gRPC analog of the HTTP 307s). Delegates to the same
BrokerServer internals the HTTP surface uses.
"""

from __future__ import annotations

import asyncio
import logging
import time

from ..pb import messaging_pb2 as pb
from ..pb import rpc
from ..utils.log_buffer import LogEntry

log = logging.getLogger("broker.grpc")


def _to_pb(e: LogEntry) -> pb.Message:
    return pb.Message(event_time_ns=e.ts_ns, key=e.key, value=e.value,
                      headers={k: str(v) for k, v in e.headers.items()})


class MessagingGrpcServicer:
    def __init__(self, broker):
        self.broker = broker  # BrokerServer

    def _redirect_target(self, ns: str, topic: str, partition: int):
        """Owning broker url, or None when this broker owns it."""
        b = self.broker
        if not b.register:
            return None
        owner = b._owner(ns, topic, partition)
        return owner if owner != b.advertise_url else None

    async def Publish(self, request_iterator, context):
        tp = None
        ack_level = "memory"
        async for req in request_iterator:
            if req.HasField("init"):
                init = req.init
                owner = self._redirect_target(init.namespace, init.topic,
                                              init.partition)
                if owner is not None:
                    yield pb.PublishResponse(redirect_to=owner)
                    return
                tp = self.broker._partition(init.namespace, init.topic,
                                            init.partition)
                ack_level = init.ack_level or "memory"
                continue
            if tp is None:
                yield pb.PublishResponse(error="publish before init")
                return
            d = req.data
            added = tp.buffer.add(d.key, d.value, dict(d.headers))
            if ack_level == "flush" and self.broker.persist is not None:
                tp.buffer.flush()
                await asyncio.get_event_loop().run_in_executor(
                    None, self.broker.persist.drain)
            yield pb.PublishResponse(ack_ts_ns=added.ts_ns)

    async def Subscribe(self, request_iterator, context):
        it = request_iterator.__aiter__()
        try:
            first = await it.__anext__()
        except StopAsyncIteration:
            return
        if not first.HasField("init"):
            log.warning("subscribe stream without init message; closing")
            return
        init = first.init
        owner = self._redirect_target(init.namespace, init.topic,
                                      init.partition)
        if owner is not None:
            yield pb.BrokerMessage(redirect_to=owner)
            return
        tp = self.broker._partition(init.namespace, init.topic,
                                    init.partition)
        Start = pb.SubscriberMessage.InitMessage.StartPosition
        tail_only = init.start_position == Start.LATEST
        if init.start_position == Start.TIMESTAMP:
            since = init.timestamp_ns
        elif tail_only:
            # LATEST = only messages published after this subscribe; the
            # in-memory counter is 0 after a broker restart, so a wall
            # snapshot (entry offsets are monotonic time_ns) is the
            # correct "now" even when history exists only in the filer
            since = time.time_ns()
        else:
            since = 0

        queue: asyncio.Queue = asyncio.Queue()
        loop = asyncio.get_event_loop()

        def on_entry(e: LogEntry) -> None:
            loop.call_soon_threadsafe(queue.put_nowait, e)

        tp.buffer.subscribe(on_entry)

        async def watch_close():
            # a client close message ends the stream
            async for req in it:
                if req.is_close:
                    await queue.put(None)
                    return

        closer = asyncio.create_task(watch_close())
        try:
            last = since
            if not tail_only:
                for e in await tp.replay(self.broker._session, since):
                    last = max(last, e.ts_ns)
                    yield pb.BrokerMessage(data=_to_pb(e))
            while True:
                e = await queue.get()
                if e is None:
                    return
                if e.ts_ns <= last:
                    continue
                yield pb.BrokerMessage(data=_to_pb(e))
        finally:
            closer.cancel()
            tp.buffer.unsubscribe(on_entry)

    async def DeleteTopic(self, request: pb.DeleteTopicRequest, context):
        b = self.broker
        keys = [k for k in list(b.partitions)
                if k[0] == request.namespace and k[1] == request.topic]
        for k in keys:
            tp = b.partitions.pop(k, None)
            if tp is not None:
                tp.buffer.flush()
        b.topic_configs.pop((request.namespace, request.topic), None)
        if b.persist is not None and b._session is not None:
            # in-flight segment flushes must land BEFORE the recursive
            # delete, or a late PUT resurrects the topic's data
            await asyncio.get_event_loop().run_in_executor(
                None, b.persist.drain)
            # drop persisted segments via the filer
            try:
                await b._session.post(
                    f"http://{b.filer_url}/__meta__/delete",
                    json={"path": f"/topics/{request.namespace}/"
                          f"{request.topic}", "recursive": True,
                          "free_chunks": True})
            except Exception as e:
                return pb.DeleteTopicResponse(ok=False, error=str(e))
        return pb.DeleteTopicResponse(ok=True)

    async def ConfigureTopic(self, request: pb.ConfigureTopicRequest,
                             context):
        self.broker.topic_configs[
            (request.namespace, request.topic)] = \
            request.configuration.partition_count or 4
        return pb.ConfigureTopicResponse(ok=True)

    async def GetTopicConfiguration(
            self, request: pb.GetTopicConfigurationRequest, context):
        count = self.broker.topic_configs.get(
            (request.namespace, request.topic), 4)
        return pb.GetTopicConfigurationResponse(
            configuration=pb.TopicConfiguration(partition_count=count))

    async def FindBroker(self, request: pb.FindBrokerRequest, context):
        b = self.broker
        brokers = b.peer_brokers or [b.advertise_url]
        from .client import pick_broker
        return pb.FindBrokerResponse(
            broker=pick_broker(sorted(brokers), request.namespace,
                               request.topic, request.partition),
            all_brokers=sorted(brokers))


async def serve_messaging_grpc(broker, host: str, port: int):
    """Start a broker's grpc.aio server; the caller stops it."""
    server = await rpc.serve(
        rpc.messaging_service_handler(MessagingGrpcServicer(broker),
                                      trace_instance=broker.advertise_url),
        host, port)
    log.info("messaging gRPC on %s:%d", host, port)
    return server
