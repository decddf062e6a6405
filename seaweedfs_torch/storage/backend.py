"""The positioned-IO file a volume reads and writes its .dat through.

The port's reduced copy of seaweedfs_tpu/storage/backend.py (upstream
weed/storage/backend/backend.go:15-45, backend/disk_file.go): the
``BackendStorageFile`` interface and ``DiskFile``, the local file, whose
writes and fsync carry the fault points ``disk.write`` and ``disk.sync``,
with the gathered ``writev_at`` of group commit (one ``os.pwritev``).
Not ported: the object stores, ``RemoteFile`` and the ``.vif`` sidecars
of tiered volumes, and preallocation.
"""

from __future__ import annotations

import os

from .. import faults


class BackendStorageFile:
    """Positioned-IO file (backend.go:15-24)."""

    # True for page-cache positioned IO on a local disk: event-loop
    # callers may read and write it inline (the volume's _nowait paths)
    is_local = False

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

    def __init__(self, path: str, create: bool = False):
        self.path = path
        self._f = open(path, "w+b" if create else "r+b")

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
