"""Protobuf wire layer: the four services' messages.

``master_pb2``, ``volume_server_pb2``, ``filer_pb2`` and
``messaging_pb2`` are protoc's output for ``proto/master.proto``,
``proto/volume_server.proto``, ``proto/filer.proto`` and
``proto/messaging.proto``, kept byte for byte as generated: protobuf's
default descriptor pool accepts a file registered twice only when its
serialized bytes are identical. The proto packages on the wire are
``seaweedfs_tpu.master``, ``.volume``, ``.filer`` and ``.messaging``;
they are names on the wire, not imports. ``rpc.py`` binds them to gRPC.
The generated modules import nothing of each other, so nothing here
touches ``sys.path``.
"""
