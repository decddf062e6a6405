"""The filer ring's consistent hashing.

The port's reduced copy of seaweedfs_tpu/metaring/: only
``DirectoryRing``'s membership and owner lookup (ring.py), which
clustersim's ``churn`` scenario uses. The router, handoff, coordinator,
invalidation and the master's metadata log wait for the filer and HA
master slices.
"""
