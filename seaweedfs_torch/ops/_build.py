"""Build and load the port's CUDA library (kernels and host CRC-32C).

``csrc/*.cu`` compile with nvcc into one shared library with a plain C
interface, loaded through ctypes: no PyTorch headers, so a build takes
seconds. The build runs at first use, never at import, into
``seaweedfs_torch/_build/`` (listed in .gitignore); the library's file
name carries a hash of the sources, the headers they include
(``csrc/*.cuh``) and the flags, so an edited source builds anew and a
finished build is reused. ``build()`` starts one nvcc per source, all at
once, and links the objects in a last call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: list = []  # the loaded CDLL, once built (one per process)


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def nvcc() -> str | None:
    """Path of nvcc, or None where the CUDA toolkit is absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.path.exists(default) else None


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libseaweedfs_torch_{_digest()}.so"


def build() -> Path:
    """Compile and link the sources into the shared library; returns its
    path. A no-op when it exists."""
    out = library_path()
    if out.exists():
        return out
    compiler = nvcc()
    if compiler is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [Path(work) / f"{src.stem}.o" for src in sources()]
        procs = [subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources(), objs)]
        logs = [p.communicate()[0] for p in procs]
        if any(p.returncode for p in procs):
            raise RuntimeError("nvcc failed:\n" + "".join(logs))
        tmp = Path(work) / out.name
        proc = subprocess.run(
            [compiler, *NVCC_FLAGS, "-shared", *map(str, objs),
             "-o", str(tmp)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError("nvcc link failed:\n" + proc.stdout
                               + proc.stderr)
        os.replace(tmp, out)  # concurrent builds race to the same bytes
    return out


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed, with every entry
    point's argument and result types declared."""
    with _lock:
        if _lib:
            return _lib[0]
        lib = ctypes.CDLL(str(build()))
        lib.sw_gf_apply.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p]
        lib.sw_gf_apply.restype = ctypes.c_int
        lib.sw_gf_mxu.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.sw_gf_mxu.restype = ctypes.c_int
        lib.sw_gf_xorsched.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        lib.sw_gf_xorsched.restype = ctypes.c_int
        lib.sw_crc32c_update.argtypes = [
            ctypes.c_uint32, ctypes.c_char_p, ctypes.c_size_t]
        lib.sw_crc32c_update.restype = ctypes.c_uint32
        _lib.append(lib)
        return lib
