"""Socket helpers of the binary-wire filer stores and their fakes.

The port's copy of seaweedfs_tpu/filer/netutil.py's ``read_exact``:
the mongodb (OP_MSG) and cassandra (CQL v4) clients and servers read
whole frames through it. (The ndjson splitter of that module lives in
metaring/invalidation.py.)
"""

from __future__ import annotations


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
