"""seaweedfs_torch: the erasure-coding storage path on PyTorch and CUDA.

The port of ``seaweedfs_tpu`` to an NVIDIA H100. Its layout mirrors the
JAX package (``ops/``, ``ec/``, ``storage/``, ``observe/``, ``faults/``,
``utils/``) module for module; it imports nothing of that package and
nothing of JAX. The GF(2^8) kernels are hand-written CUDA
(``csrc/gf_apply.cu``, ``csrc/gf_mxu.cu``, ``csrc/gf_xorsched.cu``),
built with nvcc at first use and bound through ctypes
(``ops/_build.py``).
"""

__version__ = "0.1.0"
