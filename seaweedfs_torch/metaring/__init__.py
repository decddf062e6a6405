"""The metadata plane.

The port's reduced copy of seaweedfs_tpu/metaring/: ``DirectoryRing``'s
membership and owner lookup (ring.py), which clustersim's ``churn``
scenario uses, and the masters' replicated metadata log (masterlog.py).
The router, handoff, coordinator, invalidation and the ring's membership
through raft wait for the filer slice.
"""

from .masterlog import MasterMetaLog

__all__ = ["MasterMetaLog"]
