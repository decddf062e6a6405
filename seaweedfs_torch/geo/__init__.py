"""Geo plane: cluster-to-cluster async replication, S3 versioning,
replica failover.

The port's copy of seaweedfs_tpu/geo/__init__.py. Three layers:

1. **Cluster-to-cluster async replication** (cluster_sink.py,
   applier.py, replicate.py, daemon.py): a leader-only daemon on the
   master, sibling of the repair and lifecycle daemons, reads per-bucket
   replication rules off the filer and runs one
   :class:`~seaweedfs_torch.geo.replicate.BucketReplicator` job per
   replicated bucket. Each job tails the source filer's
   ``/__meta__/subscribe`` stream (resuming from a durable offset kept
   as a filer entry under ``/buckets/.geo/``), fans events through a
   parallel applier pool with per-directory ordering, and writes
   through the *remote cluster's filer*, so the remote side chunks,
   leases and places with its own masters and volume servers. All
   replication traffic binds ``overload.CLASS_BG``: it sheds first under
   load. Signature-based loop prevention (the filer event
   ``signatures`` field + ``exclude_sig`` server-side filtering) makes
   active/active pairs safe.

2. **S3 object versioning** (versioning.py + s3/s3_server.py), with the
   replication rules the gateway stores on a bucket entry (rules.py).
   Noncurrent versions are sibling filer entries under
   ``<key>.versions/``, so the replicator ships the version history.

3. **Replica failover** (client.py + s3/s3_server.py): a read whose
   primary cluster is unreachable is served from the replica cluster
   instead, marked stale (``X-Seaweed-Stale-Ok: 1``).

Knobs: WEED_GEO_FILER, WEED_GEO_PEER, WEED_GEO_INTERVAL,
WEED_GEO_APPLIERS, WEED_GEO_QUEUE, WEED_GEO_MAX_EVENT_RETRIES,
WEED_GEO_BACKFILL, WEED_GEO_STREAM_IDLE, WEED_GEO_ENABLED,
WEED_GEO_REPLICA_MASTERS, WEED_GEO_REPLICA_FILER.

Left out, with its later home: the trace ids the reference's replicator
carries on its requests (the trace propagation of ``observe/``, ROADMAP
Queue 1 A.9); the deadline and the priority class ride them here.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

# where per-bucket resume offsets live on the SOURCE filer: ordinary
# (chunkless) entries, so offsets survive daemon and master restarts
# with the filer store. The dot name hides the directory from S3
# ListBuckets.
OFFSET_DIR = "/buckets/.geo"


@dataclass
class GeoConfig:
    """All WEED_GEO_* knobs in one place."""
    filer: str = ""             # WEED_GEO_FILER: source-cluster filer
    peer: str = ""              # WEED_GEO_PEER: default remote filer
    interval: float = 10.0      # WEED_GEO_INTERVAL: rule-scan period
    appliers: int = 4           # WEED_GEO_APPLIERS: workers per bucket
    queue_depth: int = 128      # WEED_GEO_QUEUE: per-worker queue bound
    max_event_retries: int = 3  # WEED_GEO_MAX_EVENT_RETRIES
    backfill: bool = True       # WEED_GEO_BACKFILL: copy pre-rule objects
    stream_idle_s: float = 300.0  # WEED_GEO_STREAM_IDLE: sock_read bound
    force_enabled: Optional[bool] = None  # WEED_GEO_ENABLED override

    @property
    def enabled(self) -> bool:
        """The daemon runs only when a source filer is configured (or
        the operator forces it)."""
        if self.force_enabled is not None:
            return self.force_enabled
        return bool(self.filer)

    @classmethod
    def from_env(cls, env: Optional[dict] = None) -> "GeoConfig":
        env = env if env is not None else os.environ
        force = env.get("WEED_GEO_ENABLED", "")

        def _f(name: str, default: float) -> float:
            try:
                return float(env.get(name, "") or default)
            except ValueError:
                return default

        def _i(name: str, default: int) -> int:
            try:
                return int(env.get(name, "") or default)
            except ValueError:
                return default

        return cls(
            filer=env.get("WEED_GEO_FILER", ""),
            peer=env.get("WEED_GEO_PEER", ""),
            interval=max(_f("WEED_GEO_INTERVAL", 10.0), 0.05),
            appliers=max(_i("WEED_GEO_APPLIERS", 4), 1),
            queue_depth=max(_i("WEED_GEO_QUEUE", 128), 1),
            max_event_retries=max(_i("WEED_GEO_MAX_EVENT_RETRIES", 3), 1),
            backfill=env.get("WEED_GEO_BACKFILL", "1")
            not in ("0", "false", "no"),
            stream_idle_s=max(_f("WEED_GEO_STREAM_IDLE", 300.0), 1.0),
            force_enabled=(None if force == ""
                           else force not in ("0", "false", "no")),
        )


from .versioning import (DELETE_MARKER_ATTR, VERSION_ID_ATTR,  # noqa: E402
                         VERSIONING_ATTR, VERSIONS_SUFFIX,
                         new_version_id, versions_dir)

__all__ = [
    "GeoConfig", "OFFSET_DIR",
    "VERSIONING_ATTR", "VERSION_ID_ATTR", "DELETE_MARKER_ATTR",
    "VERSIONS_SUFFIX", "new_version_id", "versions_dir",
]
