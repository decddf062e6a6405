"""Volume storage backends and the object-store tier.

The port's copy of seaweedfs_tpu/storage/backend.py (upstream
weed/storage/backend/backend.go:15-45, backend/disk_file.go,
backend/s3_backend/s3_backend.go:28, volume_tier.go:15-50 and the
``.vif`` of pb/volume_info.go:18):

- ``BackendStorageFile``: the positioned-IO file a volume reads and
  writes its .dat through;
- ``DiskFile``: the local file, whose writes and fsync carry the fault
  points ``disk.write`` and ``disk.sync``, with the gathered
  ``writev_at`` of group commit (one ``os.pwritev``) and the reserve of a
  new volume's space (``preallocate``, fallocate with KEEP_SIZE);
- ``ObjectStore``: the object API a tier needs, a directory-backed
  ``LocalObjectStore`` and an ``S3ObjectStore`` that signs SigV4
  (s3/sigv4.py) with the spec's keys or ``WEED_S3_ACCESS_KEY`` /
  ``WEED_S3_SECRET_KEY``; stores register by name (``register_store``)
  and open from a spec (``open_store``);
- ``RemoteFile``: a tiered volume's read-only .dat in an object store,
  read through an LRU of 1 MiB blocks; it has no file descriptor;
- the ``.vif`` sidecar (JSON): where a tiered .dat lives, so the volume
  opens tiered again after a restart.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
from typing import Callable, Optional

from .. import faults
from ..utils import durable, retry

log = logging.getLogger("volume")


def _fallocate_keep_size(fd: int, length: int) -> bool:
    """Reserve contiguous space without changing the visible file size —
    the fallocate(FALLOC_FL_KEEP_SIZE) call the reference issues on volume
    creation (backend/volume_create_linux.go:16). Python's
    os.posix_fallocate grows the file, so the raw syscall goes through
    ctypes (the direct syscall layer SURVEY §2.12 calls for)."""
    import ctypes
    import ctypes.util
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c"), use_errno=True)
        FALLOC_FL_KEEP_SIZE = 0x01
        ret = libc.fallocate(ctypes.c_int(fd),
                             ctypes.c_int(FALLOC_FL_KEEP_SIZE),
                             ctypes.c_longlong(0),
                             ctypes.c_longlong(length))
        return ret == 0
    except (OSError, AttributeError, TypeError):
        return False  # non-Linux or filesystem without fallocate




class BackendStorageFile:
    """Positioned-IO file (backend.go:15-24)."""

    # True for page-cache positioned IO on a local disk: event-loop
    # callers may read and write it inline (the volume's _nowait paths)
    is_local = False
    writable = False

    def read_at(self, n: int, offset: int) -> bytes:
        raise NotImplementedError

    def write_at(self, data: bytes, offset: int) -> int:
        raise NotImplementedError

    def fileno(self) -> int:
        """Raw fd for positioned reads outside the backend (the fused
        warm-down); backends without a local fd raise."""
        raise OSError("backend has no file descriptor")

    def size(self) -> int:
        raise NotImplementedError

    def truncate(self, n: int) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def sync(self) -> None:
        pass

    def close(self) -> None:
        pass

    @property
    def closed(self) -> bool:
        return False


class DiskFile(BackendStorageFile):
    """Local file (backend/disk_file.go)."""

    is_local = True
    writable = True

    def __init__(self, path: str, create: bool = False,
                 preallocate: int = 0):
        self.path = path
        self._f = open(path, "w+b" if create else "r+b")
        if create and preallocate > 0 and not _fallocate_keep_size(
                self._f.fileno(), preallocate):
            log.warning("could not preallocate %d bytes for %s",
                        preallocate, path)

    def read_at(self, n: int, offset: int) -> bytes:
        return os.pread(self._f.fileno(), n, offset)

    def fileno(self) -> int:
        return self._f.fileno()

    def write_at(self, data: bytes, offset: int) -> int:
        if faults.fire("disk.write"):
            return len(data)  # drop: the kernel never saw the bytes
        data = faults.corrupt("disk.write", data)
        return os.pwrite(self._f.fileno(), data, offset)

    def writev_at(self, buffers, offset: int) -> int:
        """One gathered pwritev for a group-commit batch, under the same
        ``disk.write`` fault point: a drop loses the whole group before
        the kernel, and a corrupt fault flips a byte anywhere in it (the
        mutated stream then goes down as one pwrite)."""
        buffers = [b for b in buffers if len(b)]
        if not buffers:
            return 0
        total = sum(len(b) for b in buffers)
        if faults.fire("disk.write"):
            return total
        joined = b"".join(buffers)
        corrupted = faults.corrupt("disk.write", joined)
        if corrupted != joined:
            return os.pwrite(self._f.fileno(), corrupted, offset)
        return os.pwritev(self._f.fileno(), buffers, offset)

    def size(self) -> int:
        return os.fstat(self._f.fileno()).st_size

    def truncate(self, n: int) -> None:
        self._f.truncate(n)

    def flush(self) -> None:
        self._f.flush()

    def sync(self) -> None:
        faults.fire("disk.sync")
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    @property
    def closed(self) -> bool:
        return self._f.closed


# --- object stores ---

class ObjectStore:
    """Minimal object API the cloud tier needs."""

    kind = "base"

    def put(self, key: str, source_path: str) -> None:
        raise NotImplementedError

    def get_range(self, key: str, offset: int, n: int) -> bytes:
        raise NotImplementedError

    def get_to_file(self, key: str, dest_path: str) -> None:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def size(self, key: str) -> int:
        raise NotImplementedError

    def spec(self) -> dict:
        """Serializable backend spec for the `.vif` sidecar."""
        raise NotImplementedError


class LocalObjectStore(ObjectStore):
    """Directory-backed object store — the test/dev stand-in for a cloud
    bucket (same role as the reference's memory-mapped test backends)."""

    kind = "local_store"

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, key: str) -> str:
        safe = key.replace("/", "_")
        return os.path.join(self.dir, safe)

    def put(self, key: str, source_path: str) -> None:
        import shutil
        shutil.copyfile(source_path, self._path(key))

    def get_range(self, key: str, offset: int, n: int) -> bytes:
        with open(self._path(key), "rb") as f:
            return os.pread(f.fileno(), n, offset)

    def get_to_file(self, key: str, dest_path: str) -> None:
        import shutil
        shutil.copyfile(self._path(key), dest_path)

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def size(self, key: str) -> int:
        return os.path.getsize(self._path(key))

    def spec(self) -> dict:
        return {"type": self.kind, "directory": self.dir}


class S3ObjectStore(ObjectStore):
    """S3-compatible store over SigV4 REST (s3_backend/s3_backend.go:28) —
    works against AWS or this project's own S3 gateway."""

    kind = "s3"

    def __init__(self, endpoint: str, bucket: str,
                 access_key: str = "", secret_key: str = "",
                 region: str = "us-east-1"):
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region

    def _request(self, method: str, key: str, data: Optional[bytes] = None,
                 headers: Optional[dict] = None) -> bytes:
        import urllib.request
        from ..s3.sigv4 import sign_request
        url = f"{self.endpoint}/{self.bucket}/{key}"
        hdrs = dict(headers or {})
        if self.access_key:
            hdrs = sign_request(
                method, url, hdrs, data or b"",
                self.access_key, self.secret_key, self.region)
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=hdrs)
        # external (possibly non-seaweed) endpoint: the ambient budget
        # bounds the socket; the cluster header would break SigV4
        with urllib.request.urlopen(
                req, timeout=retry.cap_timeout(300)) as r:
            return r.read()

    def put(self, key: str, source_path: str) -> None:
        with open(source_path, "rb") as f:
            data = f.read()
        self._request("PUT", key, data=data)

    def get_range(self, key: str, offset: int, n: int) -> bytes:
        return self._request(
            "GET", key, headers={"Range": f"bytes={offset}-{offset+n-1}"})

    def get_to_file(self, key: str, dest_path: str) -> None:
        size = self.size(key)
        with open(dest_path, "wb") as f:
            off = 0
            while off < size:
                n = min(1 << 24, size - off)
                f.write(self.get_range(key, off, n))
                off += n

    def delete(self, key: str) -> None:
        self._request("DELETE", key)

    def size(self, key: str) -> int:
        import urllib.request
        from ..s3.sigv4 import sign_request
        url = f"{self.endpoint}/{self.bucket}/{key}"
        hdrs: dict = {}
        if self.access_key:
            hdrs = sign_request("HEAD", url, hdrs, b"", self.access_key,
                                self.secret_key, self.region)
        req = urllib.request.Request(url, method="HEAD", headers=hdrs)
        with urllib.request.urlopen(
                req, timeout=retry.cap_timeout(60)) as r:
            return int(r.headers["Content-Length"])

    def spec(self) -> dict:
        # credentials never go into the .vif; they come from security
        # config at open time (the reference reads them from master.toml)
        return {"type": self.kind, "endpoint": self.endpoint,
                "bucket": self.bucket, "region": self.region}


_STORE_FACTORIES: dict[str, Callable[[dict], ObjectStore]] = {}


def register_store(kind: str, factory: Callable[[dict], ObjectStore]) -> None:
    _STORE_FACTORIES[kind] = factory


register_store("local_store", lambda spec: LocalObjectStore(spec["directory"]))
def _s3_store(spec: dict) -> "S3ObjectStore":
    """An S3 store from a spec. A `.vif` holds no keys, so a volume
    opened from one signs with the server's own ``WEED_S3_ACCESS_KEY`` /
    ``WEED_S3_SECRET_KEY`` (the environment overrides of the reference's
    security.toml); keys in the spec come first."""
    return S3ObjectStore(
        spec["endpoint"], spec["bucket"],
        spec.get("access_key") or os.environ.get("WEED_S3_ACCESS_KEY", ""),
        spec.get("secret_key") or os.environ.get("WEED_S3_SECRET_KEY", ""),
        spec.get("region", "us-east-1"))


register_store("s3", _s3_store)


def open_store(spec: dict) -> ObjectStore:
    factory = _STORE_FACTORIES.get(spec.get("type", ""))
    if factory is None:
        raise KeyError(f"unknown backend type {spec.get('type')!r}; "
                       f"have {sorted(_STORE_FACTORIES)}")
    return factory(spec)


class RemoteFile(BackendStorageFile):
    """Read-only `.dat` living in an ObjectStore, with a small LRU block
    cache so needle reads don't pay one round trip per header+body."""

    name = "remote"
    writable = False
    BLOCK = 1 << 20
    CACHE_BLOCKS = 64

    def __init__(self, store: ObjectStore, key: str, file_size: int):
        self.store = store
        self.key = key
        self._size = file_size
        self._cache: collections.OrderedDict[int, bytes] = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self._closed = False

    def _block(self, index: int) -> bytes:
        with self._lock:
            blk = self._cache.get(index)
            if blk is not None:
                self._cache.move_to_end(index)
                return blk
        off = index * self.BLOCK
        n = min(self.BLOCK, self._size - off)
        blk = self.store.get_range(self.key, off, n)
        with self._lock:
            self._cache[index] = blk
            while len(self._cache) > self.CACHE_BLOCKS:
                self._cache.popitem(last=False)
        return blk

    def read_at(self, n: int, offset: int) -> bytes:
        if offset >= self._size:
            return b""
        n = min(n, self._size - offset)
        out = bytearray()
        while n > 0:
            idx, in_off = divmod(offset, self.BLOCK)
            blk = self._block(idx)
            take = min(n, len(blk) - in_off)
            if take <= 0:
                break
            out += blk[in_off:in_off + take]
            offset += take
            n -= take
        return bytes(out)

    def write_at(self, data: bytes, offset: int) -> int:
        raise IOError("remote volume is read-only (tiered .dat)")

    def truncate(self, n: int) -> None:
        raise IOError("remote volume is read-only (tiered .dat)")

    def size(self) -> int:
        return self._size

    def close(self) -> None:
        self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed


# --- .vif sidecar (pb/volume_info.go:18; JSON here, same content) ---

def vif_path(base_file_name: str) -> str:
    return base_file_name + ".vif"


def save_volume_info(base_file_name: str, info: dict) -> None:
    # the .vif is the only record of where a tiered .dat lives — losing
    # it to a dropped rename strands the volume, so the write is durable
    durable.write_json_atomic(vif_path(base_file_name), info, indent=1)


def load_volume_info(base_file_name: str) -> Optional[dict]:
    try:
        with open(vif_path(base_file_name)) as f:
            return json.load(f)
    except FileNotFoundError:
        return None


def open_remote_dat(base_file_name: str) -> Optional[RemoteFile]:
    """Open the tiered `.dat` described by the `.vif` sidecar, if any."""
    info = load_volume_info(base_file_name)
    if not info:
        return None
    files = info.get("files", [])
    if not files:
        return None
    spec = files[0]
    store = open_store(spec["backend"])
    return RemoteFile(store, spec["key"], spec["file_size"])
