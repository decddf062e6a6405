"""Lookup caching and fetch coalescing for the filer.

The port's reduced copy of seaweedfs_tpu/cache/: ``ttl`` (``TTLCache``,
the wdclient vid-location cache shape with pinned, push-fed entries) and
``singleflight`` (``AsyncSingleflight``: N concurrent fetches of one key
become one). Left out: the tiered chunk cache (``TieredChunkCache``), the
threaded ``Singleflight`` and the pooled HTTP client.
"""

from .singleflight import AsyncSingleflight
from .ttl import TTLCache

__all__ = ["AsyncSingleflight", "TTLCache"]
