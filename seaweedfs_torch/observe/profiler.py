"""Device-trace annotations around the EC pipeline's kernel work.

The port's counterpart of seaweedfs_tpu/observe/profiler.py's
``trace_annotation``: there a JAX trace annotation, here an NVTX range,
so that ``nsys profile`` shows ``ec_pipeline_dispatch`` and
``ec_pipeline_kernel_wait`` on the host timeline beside the kernels. A
range costs a call into the NVTX library, which does nothing unless a
tool is attached; on a host without a card the annotation is inert. Not
ported: the sampling profiler and the pstats windows (they come with the
servers).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def trace_annotation(name: str):
    """An NVTX range named `name` around the block on a CUDA host; inert
    elsewhere."""
    if not torch.cuda.is_available():
        yield
        return
    torch.cuda.nvtx.range_push(name)
    try:
        yield
    finally:
        torch.cuda.nvtx.range_pop()
