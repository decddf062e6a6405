"""Filer replication: sinks, queue inputs and the replicator.

The port's copy of seaweedfs_tpu/replication/ (upstream weed/replication/).
"""

from .sink import ReplicationSink, LocalSink, FilerSink  # noqa: F401
from .replicator import Replicator  # noqa: F401
