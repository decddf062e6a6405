"""Read-path performance tier: caching, coalescing, pooled HTTP.

The port's copy of seaweedfs_tpu/cache/:

- ``tiered``      : weed/util/chunk_cache, a size-class-accounted
                    in-memory LRU front backed by an optional on-disk
                    tier, TTL'd, with hit/miss/eviction counters and
                    ``cache.lookup`` spans (the mount's chunk cache);
- ``singleflight``: golang.org/x/sync/singleflight as used by the filer
                    reader, the mount and EC shard reads: N concurrent
                    fetches of one key collapse into one backend read;
                    waiters emit ``singleflight.wait`` spans;
- ``http_pool``   : keep-alive pooled HTTP connections for the sync
                    intra-cluster clients (weed/util/http_util keeps one
                    shared transport);
- ``ttl``         : the wdclient vid-location cache shape, a TTL'd
                    lookup cache with pinned (push-fed) entries.

The filer server's own chunk cache and the client's and the filer's use
of ``shared_pool`` wait for ROADMAP A.9.
"""

from .http_pool import HttpPool, PoolResponse, shared_pool
from .singleflight import AsyncSingleflight, Singleflight
from .tiered import TieredChunkCache
from .ttl import TTLCache

__all__ = [
    "AsyncSingleflight",
    "HttpPool",
    "PoolResponse",
    "Singleflight",
    "TieredChunkCache",
    "TTLCache",
    "shared_pool",
]
