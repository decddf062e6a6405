"""The multi-card EC coder: ``MeshCoder`` (mesh_coder.py), the production
ErasureCoder over several devices, and the batched kernel surface
(sharded.py). The port's counterpart of seaweedfs_tpu/parallel/."""

from .mesh_coder import MeshCoder, coder, mesh_device_count, mesh_status

__all__ = ["MeshCoder", "coder", "mesh_device_count", "mesh_status"]
