"""Kernel FUSE adapter for WFS (`weed mount` equivalent,
weed/command/mount_std.go:51).

The port's copy of seaweedfs_tpu/mount/fuse_mount.py, whole.

Thin: every FUSE callback delegates to the corresponding WFS method. Two
bindings are supported — fusepy when installed, otherwise the built-in
ctypes binding to libfuse2 (mount/fuse_ctypes.py). All mount logic lives
(and is unit-tested) in wfs.py / dirty_pages.py, mirroring how the
reference splits weed/filesys/ from the bazil.org/fuse glue.
"""

from __future__ import annotations

import errno
import stat


class _WfsAdapter:
    """WFS with the couple of shims the kernel surface needs."""

    def __init__(self, wfs):
        self._w = wfs

    def __getattr__(self, name):
        return getattr(self._w, name)

    def getattr(self, path: str) -> dict:
        a = self._w.getattr(path)
        mode = a["mode"]
        if stat.S_IFMT(mode) == 0:
            mode |= stat.S_IFREG
        return {**a, "mode": mode}


def mount(filer_url: str, mountpoint: str, collection: str = "",
          replication: str = "", chunk_size: int = 8 * 1024 * 1024,
          foreground: bool = True) -> None:
    from .wfs import WFS

    wfs = _WfsAdapter(WFS(filer_url, collection=collection,
                          replication=replication,
                          chunk_size=chunk_size, subscribe=True))
    try:
        _mount_fusepy(wfs, mountpoint, foreground)
        return
    except ImportError:
        pass
    # built-in ctypes binding (the image has libfuse2 + /dev/fuse but no
    # fusepy)
    from .fuse_ctypes import fuse_main
    try:
        code = fuse_main(mountpoint, wfs, foreground=foreground)
        if code != 0:
            raise SystemExit(f"fuse_main exited with {code}")
    finally:
        wfs.destroy()


def _mount_fusepy(wfs, mountpoint: str, foreground: bool) -> None:
    from fuse import FUSE, FuseOSError, Operations  # fusepy

    from .wfs import FuseError

    class WeedFuse(Operations):
        def _wrap(self, fn, *args):
            try:
                return fn(*args)
            except FuseError as e:
                raise FuseOSError(e.errno or errno.EIO)

        def getattr(self, path, fh=None):
            # wfs is the _WfsAdapter: the S_IFREG mode shim lives there
            a = self._wrap(wfs.getattr, path)
            return {"st_mode": a["mode"], "st_size": a["size"],
                    "st_mtime": a["mtime"], "st_uid": a["uid"],
                    "st_gid": a["gid"], "st_nlink": 1}

        def readdir(self, path, fh):
            return [".", ".."] + self._wrap(wfs.readdir, path)

        def create(self, path, mode, fi=None):
            return self._wrap(wfs.create, path, mode)

        def open(self, path, flags):
            import os
            writable = bool(flags & (os.O_WRONLY | os.O_RDWR))
            return self._wrap(wfs.open, path, writable)

        def read(self, path, size, offset, fh):
            return self._wrap(wfs.read, fh, size, offset)

        def write(self, path, data, offset, fh):
            return self._wrap(wfs.write, fh, data, offset)

        def flush(self, path, fh):
            return self._wrap(wfs.flush, fh)

        def release(self, path, fh):
            return self._wrap(wfs.release, fh)

        def mkdir(self, path, mode):
            return self._wrap(wfs.mkdir, path, mode)

        def unlink(self, path):
            return self._wrap(wfs.unlink, path)

        def rmdir(self, path):
            return self._wrap(wfs.rmdir, path)

        def rename(self, old, new):
            return self._wrap(wfs.rename, old, new)

        def truncate(self, path, length, fh=None):
            return self._wrap(wfs.truncate, path, length)

        def link(self, link_path, target):
            # fusepy argument order is (new, existing)
            return self._wrap(wfs.link, target, link_path)

        def setxattr(self, path, name, value, options, position=0):
            return self._wrap(wfs.setxattr, path, name, value)

        def getxattr(self, path, name, position=0):
            return self._wrap(wfs.getxattr, path, name)

        def listxattr(self, path):
            return self._wrap(wfs.listxattr, path)

        def removexattr(self, path, name):
            return self._wrap(wfs.removexattr, path, name)

        def statfs(self, path):
            s = wfs.statfs()
            return {"f_bsize": s["bsize"], "f_blocks": s["blocks"],
                    "f_bavail": s["bfree"], "f_bfree": s["bfree"]}

        def destroy(self, path):
            wfs.destroy()

    FUSE(WeedFuse(), mountpoint, foreground=foreground, nothreads=False,
         big_writes=True)
