"""The mount: WFS over a filer (wfs.py), its dirty pages and metadata
cache, and the kernel FUSE glue (fuse_mount.py over fusepy or the
libfuse2 ctypes binding). The port's copy of seaweedfs_tpu/mount/."""

from .dirty_pages import ContinuousIntervals  # noqa: F401
from .wfs import WFS, FileHandle  # noqa: F401
