"""Lifecycle plane: heat-driven hot -> warm tiering and TTL expiry.

The port's reduced copy of seaweedfs_tpu/lifecycle/, in two layers:

1. **Heat tracking** (heat.py): volume servers sample their read and
   write paths into per-volume access stats (counts, last access, a
   decayed-EWMA read rate) and report only the changed entries in each
   heartbeat; the master topology keeps the cluster's heat view, served
   at ``GET /vol/heat`` and by the ``volume.heat`` shell command.

2. **Policy and daemon** (policy.py, daemon.py): a daemon on the master,
   sibling of the repair daemon and sharing its concurrency semaphore
   and backoff, evaluates the rules every ``WEED_LIFECYCLE_INTERVAL``:
   full and idle volumes are sealed and warmed down into the EC tier
   (the fused compact + gzip + encode + digest pass), EC volumes whose
   read rate turns hot are decoded back, and volumes of a TTL'd
   collection expire whole. Transitions are resumable: a crash leaves
   either the original volume or the full shard set, never neither.

3. **S3 bucket rules** (s3_rules.py and the daemon's S3 pass): with
   ``WEED_LIFECYCLE_FILER`` set, each pass walks ``/buckets`` through the
   filer's ``/__meta__`` API, expires objects past a rule's Expiration
   and marks those past its Transition ``WARM``, nudging the volumes that
   hold their chunks into the warm tier on the next pass.

Left out: the overload plane's background priority.
"""

from __future__ import annotations

import random

from .heat import HALFLIFE, HeatTracker, VolumeHeat, decayed_rate
from .policy import (LifecycleConfig, Transition, parse_duration,
                     plan_transitions)


def jittered(seconds: float, spread: float = 0.2) -> float:
    """An interval with +/-(spread/2) relative jitter: a master and its
    volume servers must not fire their scans in lockstep."""
    lo = 1.0 - spread / 2.0
    return max(seconds, 0.01) * (lo + spread * random.random())


__all__ = [
    "HALFLIFE", "HeatTracker", "VolumeHeat", "decayed_rate",
    "LifecycleConfig", "Transition", "parse_duration",
    "plan_transitions", "jittered",
]
