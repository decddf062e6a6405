"""Record layer: interpose on the file API under one directory tree.

The port's copy of seaweedfs_tpu/crashsim/shim.py. The port's durable
writers persist through ``storage/backend.DiskFile`` (``os.pwrite`` +
``os.fsync``), plain ``open()`` (the ``.idx`` journal, ``striping``'s
shard files), ``utils/durable`` (``os.replace`` and directory fsyncs) and
the EC fan-out's ``os.open`` + ``os.writev`` + ``os.fsync``
(``ec/pipeline._FanOut``, on its writer threads), so the recorder patches
all of them process-wide while it records, scoped by path prefix:
operations outside the recorded root pass through untouched.

What gets logged (see :class:`Op`):

  create   path                # open() created or truncated the file
  write    path offset bytes   # payload captured for replay
  trunc    path size
  unlink   path
  rename   src dst             # os.replace / os.rename
  fsync    path                # file barrier (os.fsync/fdatasync by fd)
  dirsync  path                # directory barrier (fsync of a dir fd)

Positions for stream writes are modeled by the wrapper (append mode
writes at the tracked size; seeks update a tracked cursor). ``os.pwritev``
is recorded as one ``write`` per buffer at its computed offset, and
``os.writev`` the same at a per-fd cursor modeled for ``os.open``
handles, which the fan-out's writers only ever append through (opened
``O_TRUNC``, never seeked). Reads (``os.pread``, ``mmap``) are not
recorded. The fd-to-path map drops an fd when it is closed through the
patched ``os.close`` or the wrapper's ``close``, so a deferred close (an
EC shard's ``Pinned`` closer) cannot leave a stale entry for a recycled
fd number.

Recording is process-global state (the patches live in ``builtins`` and
``os``); one recorder may be active at a time. Anything that builds
files on first use (the kernels' ``nvcc`` build) must run before a
recording starts.
"""

from __future__ import annotations

import builtins
import os
import threading
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class Op:
    seq: int
    kind: str                 # create|write|trunc|unlink|rename|fsync|dirsync
    path: str                 # root-relative, posix
    offset: int = 0           # write
    data: bytes = b""         # write payload
    size: int = 0             # trunc
    dst: str = ""             # rename target (root-relative)


def _as_bytes(data) -> bytes:
    if isinstance(data, bytes):
        return data
    if isinstance(data, str):
        return data.encode("utf-8")
    return bytes(data)   # memoryview / bytearray / numpy buffer


class _TracedFile:
    """Proxy for a writable file under the recorded root: delegates
    everything to the real file object while logging writes/truncates
    with modeled positions and registering its fd for fsync mapping."""

    def __init__(self, recorder: "DiskRecorder", real, path: str,
                 mode: str, existed: bool):
        self._rec = recorder
        self._real = real
        self._path = path
        self._append = "a" in mode
        try:
            self._size = os.path.getsize(recorder.abs(path)) \
                if existed and "w" not in mode else 0
        except OSError:
            self._size = 0
        self._pos = self._size if self._append else 0
        recorder.register_fd(real.fileno(), path)

    # --- write-side ops (recorded) ---
    def write(self, data):
        b = _as_bytes(data)
        n = self._real.write(data)
        off = self._size if self._append else self._pos
        self._rec.record("write", self._path, offset=off, data=b)
        end = off + len(b)
        self._pos = end
        self._size = max(self._size, end)
        return n

    def writelines(self, lines):
        for line in lines:
            self.write(line)

    def truncate(self, size=None):
        out = self._real.truncate(size)
        size = self._pos if size is None else size
        self._rec.record("trunc", self._path, size=size)
        self._size = size
        self._pos = min(self._pos, size)
        return out

    def seek(self, offset, whence=os.SEEK_SET):
        out = self._real.seek(offset, whence)
        if whence == os.SEEK_SET:
            self._pos = offset
        elif whence == os.SEEK_CUR:
            self._pos += offset
        else:
            self._pos = self._size + offset
        return out

    # --- passthrough ---
    def read(self, *a):
        return self._real.read(*a)

    def readline(self, *a):
        return self._real.readline(*a)

    def tell(self):
        return self._real.tell()

    def flush(self):
        # flush is NOT a durability barrier — nothing is recorded; the
        # replay layer is exactly the machine that makes this visible
        return self._real.flush()

    def fileno(self):
        return self._real.fileno()

    def close(self):
        if not self._real.closed:
            self._rec.unregister_fd(self._real.fileno())
        return self._real.close()

    @property
    def closed(self):
        return self._real.closed

    @property
    def name(self):
        return self._real.name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __iter__(self):
        return iter(self._real)

    def __getattr__(self, name):
        # anything not modeled above (readinto, seekable, encoding, ...)
        # delegates to the real file — reads are never recorded
        return getattr(self._real, name)


_WRITE_MODE_CHARS = ("w", "a", "x", "+")


class DiskRecorder:
    """Context manager: patch the file API, log ops under `root`."""

    _active: Optional["DiskRecorder"] = None

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.ops: list[Op] = []
        self.baseline: dict[str, bytes] = {}
        self._lock = threading.Lock()
        self._fds: dict[int, str] = {}
        self._fd_pos: dict[int, int] = {}   # os.open appenders' cursor
        self._orig: dict = {}

    # --- path helpers ---
    def rel(self, path) -> Optional[str]:
        p = os.path.abspath(os.fspath(path))
        if p == self.root or p.startswith(self.root + os.sep):
            return os.path.relpath(p, self.root).replace(os.sep, "/")
        return None

    def abs(self, rel: str) -> str:
        return os.path.join(self.root, rel.replace("/", os.sep))

    # --- recording primitives ---
    def record(self, kind: str, path: str, **kw) -> None:
        with self._lock:
            self.ops.append(Op(seq=len(self.ops), kind=kind, path=path,
                               **kw))

    def mark(self) -> int:
        """Current log length — the watermark harness acks pin to."""
        with self._lock:
            return len(self.ops)

    def register_fd(self, fd: int, path: str) -> None:
        with self._lock:
            self._fds[fd] = path

    def unregister_fd(self, fd: int) -> None:
        with self._lock:
            self._fds.pop(fd, None)
            self._fd_pos.pop(fd, None)

    def _snapshot_baseline(self) -> None:
        self.baseline = {}
        for dirpath, _dirs, files in os.walk(self.root):
            for name in files:
                p = os.path.join(dirpath, name)
                rel = self.rel(p)
                with open(p, "rb") as f:      # pre-patch builtin open
                    self.baseline[rel] = f.read()

    # --- the patches ---
    def __enter__(self) -> "DiskRecorder":
        if DiskRecorder._active is not None:
            raise RuntimeError("a DiskRecorder is already active")
        self._snapshot_baseline()
        DiskRecorder._active = self
        rec = self
        o = self._orig = {
            "open": builtins.open, "os_open": os.open,
            "os_close": os.close, "replace": os.replace,
            "rename": os.rename, "remove": os.remove,
            "unlink": os.unlink, "fsync": os.fsync,
            "fdatasync": os.fdatasync, "pwrite": os.pwrite,
            "pwritev": os.pwritev, "writev": os.writev,
            "ftruncate": os.ftruncate, "truncate": os.truncate,
        }

        def p_open(file, mode="r", *a, **kw):
            rel = rec.rel(file) if isinstance(file, (str, os.PathLike)) \
                else None
            if rel is None:
                return o["open"](file, mode, *a, **kw)
            if not any(c in mode for c in _WRITE_MODE_CHARS):
                # read-only opens still map their fd so a later
                # os.fsync(fd) (durable.replace_atomic) resolves — and
                # the wrapper UNREGISTERS it on close, so a recycled fd
                # number can never misattribute a barrier to this path
                f = o["open"](file, mode, *a, **kw)
                return _TracedFile(rec, f, rel, mode, True)
            existed = os.path.exists(file)
            f = o["open"](file, mode, *a, **kw)
            if "w" in mode or "x" in mode or not existed:
                rec.record("create", rel)
            return _TracedFile(rec, f, rel, mode, existed)

        def p_os_open(path, flags, *a, **kw):
            existed = isinstance(path, (str, os.PathLike)) \
                and os.path.exists(path)
            fd = o["os_open"](path, flags, *a, **kw)
            rel = rec.rel(path) if isinstance(path, (str, os.PathLike)) \
                else None
            if rel is not None:
                rec.register_fd(fd, rel)
                # the writev cursor: appenders either truncate (cursor
                # 0) or O_APPEND onto the existing size; anything that
                # seeks is outside the model (nothing in-tree does)
                pos = 0
                if existed and not flags & os.O_TRUNC \
                        and flags & os.O_APPEND:
                    try:
                        pos = os.path.getsize(path)
                    except OSError:
                        pos = 0
                with rec._lock:
                    rec._fd_pos[fd] = pos
                if flags & os.O_CREAT and flags & (os.O_WRONLY | os.O_RDWR):
                    rec.record("create", rel)
            return fd

        def p_os_close(fd):
            rec.unregister_fd(fd)
            return o["os_close"](fd)

        def p_replace(src, dst, **kw):
            out = o["replace"](src, dst, **kw)
            rs, rd = rec.rel(src), rec.rel(dst)
            if rs is not None and rd is not None:
                rec.record("rename", rs, dst=rd)
            return out

        def p_remove(path, **kw):
            out = o["remove"](path, **kw)
            rel = rec.rel(path)
            if rel is not None:
                rec.record("unlink", rel)
            return out

        def p_fsync(fd):
            out = o["fsync"](fd)
            rel = rec._fds.get(fd)
            if rel is not None:
                absolute = rec.abs(rel)
                kind = "dirsync" if os.path.isdir(absolute) else "fsync"
                rec.record(kind, rel)
            return out

        def p_pwrite(fd, data, offset):
            out = o["pwrite"](fd, data, offset)
            rel = rec._fds.get(fd)
            if rel is not None:
                rec.record("write", rel, offset=offset,
                           data=_as_bytes(data))
            return out

        def p_pwritev(fd, buffers, offset, *a, **kw):
            # materialize first: the real pwritev consumes nothing, but
            # the recorded ops must carry stable payload copies
            bufs = [_as_bytes(b) for b in buffers]
            out = o["pwritev"](fd, bufs, offset, *a, **kw)
            rel = rec._fds.get(fd)
            if rel is not None:
                # one op per buffer so the crash sweep can tear the
                # group between records (the whole point of proving the
                # group-commit barrier)
                off = offset
                for b in bufs:
                    rec.record("write", rel, offset=off, data=b)
                    off += len(b)
            return out

        def p_writev(fd, buffers):
            # materialize first (the recorded ops need stable copies);
            # the kernel may write a prefix, so only `out` bytes are
            # logged — the caller's retry loop re-enters with the rest
            bufs = [_as_bytes(b) for b in buffers]
            out = o["writev"](fd, bufs)
            rel = rec._fds.get(fd)
            if rel is not None and out > 0:
                with rec._lock:
                    off = rec._fd_pos.get(fd, 0)
                remaining = out
                for b in bufs:
                    if remaining <= 0:
                        break
                    chunk = b[:remaining]
                    rec.record("write", rel, offset=off, data=chunk)
                    off += len(chunk)
                    remaining -= len(chunk)
                with rec._lock:
                    rec._fd_pos[fd] = off
            return out

        def p_ftruncate(fd, length):
            out = o["ftruncate"](fd, length)
            rel = rec._fds.get(fd)
            if rel is not None:
                rec.record("trunc", rel, size=length)
            return out

        def p_truncate(path, length):
            if isinstance(path, int):
                return p_ftruncate(path, length)
            out = o["truncate"](path, length)
            rel = rec.rel(path)
            if rel is not None:
                rec.record("trunc", rel, size=length)
            return out

        builtins.open = p_open
        os.open = p_os_open
        os.close = p_os_close
        os.replace = p_replace
        os.rename = p_replace
        os.remove = p_remove
        os.unlink = p_remove
        os.fsync = p_fsync
        os.fdatasync = p_fsync
        os.pwrite = p_pwrite
        os.pwritev = p_pwritev
        os.writev = p_writev
        os.ftruncate = p_ftruncate
        os.truncate = p_truncate
        return self

    def __exit__(self, *exc) -> bool:
        o = self._orig
        builtins.open = o["open"]
        os.open = o["os_open"]
        os.close = o["os_close"]
        os.replace = o["replace"]
        os.rename = o["rename"]
        os.remove = o["remove"]
        os.unlink = o["unlink"]
        os.fsync = o["fsync"]
        os.fdatasync = o["fdatasync"]
        os.pwrite = o["pwrite"]
        os.pwritev = o["pwritev"]
        os.writev = o["writev"]
        os.ftruncate = o["ftruncate"]
        os.truncate = o["truncate"]
        DiskRecorder._active = None
        return False
