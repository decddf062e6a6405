"""Geo plane: the parts the S3 gateway uses.

The port's reduced copy of seaweedfs_tpu/geo/__init__.py: S3 object
versioning (versioning.py: version ids, the ``<key>.versions/`` layout,
delete markers) and the PutBucketReplication rules the gateway stores on
a bucket entry (rules.py). Not ported: ``GeoConfig``, ``OFFSET_DIR``,
the cluster-to-cluster replicator and its daemon, and the gateway's
replica-filer read failover (ROADMAP A.8).
"""

from .versioning import (DELETE_MARKER_ATTR, VERSION_ID_ATTR,
                         VERSIONING_ATTR, VERSIONS_SUFFIX,
                         new_version_id, versions_dir)

__all__ = [
    "VERSIONING_ATTR", "VERSION_ID_ATTR", "DELETE_MARKER_ATTR",
    "VERSIONS_SUFFIX", "new_version_id", "versions_dir",
]
