"""Stream and socket helpers of the filer's clients and stores.

The port's copy of seaweedfs_tpu/filer/netutil.py: ``iter_ndjson``
splits a streamed ndjson body (the geo BucketReplicator, the metaring
PeerInvalidator and the filer's peer aggregation read
``/__meta__/subscribe`` through it), and the mongodb (OP_MSG) and
cassandra (CQL v4) clients and servers read whole frames through
``read_exact``.
"""

from __future__ import annotations


async def iter_ndjson(content):
    """The lines of an aiohttp body, split by hand: aiohttp's own line
    iterator raises past about 128 KiB, and the event of an entry with
    many chunks is larger (a stream that resumes at the same offset would
    be fed the same line for ever)."""
    buf = bytearray()
    async for chunk in content.iter_any():
        buf += chunk
        while True:
            i = buf.find(b"\n")
            if i < 0:
                break
            line = bytes(buf[:i])
            del buf[:i + 1]
            yield line
    if buf:
        yield bytes(buf)


def read_exact(recv, n: int) -> bytes:
    """Exactly n bytes from `recv(k)`; ConnectionError if the peer
    closes first."""
    buf = b""
    while len(buf) < n:
        chunk = recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed connection")
        buf += chunk
    return buf
