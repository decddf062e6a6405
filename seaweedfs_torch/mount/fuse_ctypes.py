"""Minimal ctypes binding to libfuse 2.9 (high-level, path-based API).

The port's copy of seaweedfs_tpu/mount/fuse_ctypes.py, whole. Where
/dev/fuse and libfuse.so.2 exist but fusepy does not, this module is the
kernel-mount glue for `weed mount` (role of bazil.org/fuse upstream):
a fuse_operations struct of CFUNCTYPE trampolines dispatching into a
python operations object (WFS), run via fuse_main_real. Every
trampoline catches what its operation raises and returns ``-errno``;
the library is loaded only inside ``fuse_main``.

Scope: the operations the filer mount needs — getattr/readdir/create/
open/read/write/flush/release/truncate/unlink/mkdir/rmdir/rename/link/
xattr/statfs. Layouts are x86-64 Linux (struct stat, fuse_file_info,
FUSE_USE_VERSION 26 fuse_operations).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import errno
import logging
import os

log = logging.getLogger("fuse")

c_stat_time = ctypes.c_long * 2  # struct timespec


class Stat(ctypes.Structure):
    _fields_ = [
        ("st_dev", ctypes.c_ulong),
        ("st_ino", ctypes.c_ulong),
        ("st_nlink", ctypes.c_ulong),
        ("st_mode", ctypes.c_uint),
        ("st_uid", ctypes.c_uint),
        ("st_gid", ctypes.c_uint),
        ("__pad0", ctypes.c_uint),
        ("st_rdev", ctypes.c_ulong),
        ("st_size", ctypes.c_long),
        ("st_blksize", ctypes.c_long),
        ("st_blocks", ctypes.c_long),
        ("st_atim", c_stat_time),
        ("st_mtim", c_stat_time),
        ("st_ctim", c_stat_time),
        ("__reserved", ctypes.c_long * 3),
    ]


# callback prototypes (x86-64, FUSE_USE_VERSION 26)
GETATTR_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p,
                             ctypes.POINTER(Stat))
READLINK_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p,
                              ctypes.POINTER(ctypes.c_char),
                              ctypes.c_size_t)
MK_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_uint)
PATH_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p)
PATH2_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p)
CHOWN_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_uint,
                           ctypes.c_uint)
TRUNCATE_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p,
                              ctypes.c_long)
FI_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p)
RW_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p,
                        ctypes.POINTER(ctypes.c_char), ctypes.c_size_t,
                        ctypes.c_long, ctypes.c_void_p)
FILLER_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p,
                            ctypes.POINTER(Stat), ctypes.c_long)
READDIR_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p,
                             ctypes.c_void_p, FILLER_T, ctypes.c_long,
                             ctypes.c_void_p)
CREATE_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_uint,
                            ctypes.c_void_p)
SETXATTR_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p,
                              ctypes.c_char_p,
                              ctypes.POINTER(ctypes.c_char),
                              ctypes.c_size_t, ctypes.c_int)
GETXATTR_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p,
                              ctypes.c_char_p,
                              ctypes.POINTER(ctypes.c_char),
                              ctypes.c_size_t)
LISTXATTR_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_char),
                               ctypes.c_size_t)
UTIMENS_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p,
                             ctypes.c_void_p)
VOID_T = ctypes.c_void_p


class FuseOperations(ctypes.Structure):
    _fields_ = [
        ("getattr", GETATTR_T),
        ("readlink", READLINK_T),
        ("getdir", VOID_T),
        ("mknod", VOID_T),
        ("mkdir", MK_T),
        ("unlink", PATH_T),
        ("rmdir", PATH_T),
        ("symlink", PATH2_T),
        ("rename", PATH2_T),
        ("link", PATH2_T),
        ("chmod", MK_T),
        ("chown", CHOWN_T),
        ("truncate", TRUNCATE_T),
        ("utime", VOID_T),
        ("open", FI_T),
        ("read", RW_T),
        ("write", RW_T),
        ("statfs", VOID_T),
        ("flush", FI_T),
        ("release", FI_T),
        ("fsync", VOID_T),
        ("setxattr", SETXATTR_T),
        ("getxattr", GETXATTR_T),
        ("listxattr", LISTXATTR_T),
        ("removexattr", PATH2_T),
        ("opendir", VOID_T),
        ("readdir", READDIR_T),
        ("releasedir", VOID_T),
        ("fsyncdir", VOID_T),
        ("init", VOID_T),
        ("destroy", VOID_T),
        ("access", VOID_T),
        ("create", CREATE_T),
        ("ftruncate", VOID_T),
        ("fgetattr", VOID_T),
        ("lock", VOID_T),
        ("utimens", UTIMENS_T),
        ("bmap", VOID_T),
        ("flags", ctypes.c_uint),
        ("ioctl", VOID_T),
        ("poll", VOID_T),
        ("write_buf", VOID_T),
        ("read_buf", VOID_T),
        ("flock", VOID_T),
        ("fallocate", VOID_T),
    ]


def _errno_of(exc: BaseException) -> int:
    if isinstance(exc, OSError) and exc.errno:
        return -exc.errno
    return -errno.EIO


# fuse_file_info.fh offset on x86-64 (flags 4 + pad 4 + fh_old 8 +
# writepage 4 + bitfield 4)
_FH_OFFSET = 24


def _get_fh(fi: int) -> int:
    if not fi:
        return 0
    return ctypes.cast(fi + _FH_OFFSET,
                       ctypes.POINTER(ctypes.c_uint64)).contents.value


def _set_fh(fi: int, fh: int) -> None:
    if fi:
        ctypes.cast(fi + _FH_OFFSET,
                    ctypes.POINTER(ctypes.c_uint64)).contents.value = fh


def fuse_main(mountpoint: str, ops, foreground: bool = True,
              options: str = "") -> int:
    """Mount `ops` (a WFS-style object) at mountpoint and serve until
    unmounted. Blocks; returns libfuse's exit code."""
    import platform
    if platform.machine() != "x86_64":
        raise RuntimeError(
            f"built-in fuse binding only knows x86-64 struct layouts "
            f"(this is {platform.machine()}); install fusepy instead")
    libname = ctypes.util.find_library("fuse")
    if libname is None:
        raise RuntimeError("libfuse not found")
    libfuse = ctypes.CDLL(libname)

    kept = []  # keep trampolines alive for the mount's lifetime

    def wrap(factory, fn):
        cb = factory(fn)
        kept.append(cb)
        return cb

    def _getattr(path, stbuf):
        try:
            ctypes.memset(stbuf, 0, ctypes.sizeof(Stat))
            st = ops.getattr(path.decode())
            s = stbuf.contents
            s.st_mode = st["mode"]
            s.st_nlink = st.get("nlink", 1)
            s.st_size = st.get("size", 0)
            s.st_uid = st.get("uid") or os.getuid()
            s.st_gid = st.get("gid") or os.getgid()
            mtime = int(st.get("mtime", 0))
            s.st_mtim[0] = mtime
            s.st_ctim[0] = mtime
            s.st_atim[0] = mtime
            s.st_blocks = (st.get("size", 0) + 511) // 512
            s.st_blksize = 4096
            return 0
        except Exception as e:
            return _errno_of(e)

    def _readdir(path, buf, filler, offset, fi):
        try:
            filler(buf, b".", None, 0)
            filler(buf, b"..", None, 0)
            for name in ops.readdir(path.decode()):
                filler(buf, name.encode(), None, 0)
            return 0
        except Exception as e:
            return _errno_of(e)

    def _create(path, mode, fi):
        try:
            _set_fh(fi, ops.create(path.decode(), mode))
            return 0
        except Exception as e:
            return _errno_of(e)

    def _open(path, fi):
        try:
            flags = (ctypes.cast(fi, ctypes.POINTER(ctypes.c_int))
                     .contents.value if fi else 0)
            writable = bool(flags & (os.O_WRONLY | os.O_RDWR))
            _set_fh(fi, ops.open(path.decode(), for_write=writable))
            return 0
        except Exception as e:
            return _errno_of(e)

    def _read(path, buf, size, offset, fi):
        try:
            data = ops.read(_get_fh(fi), size, offset)
            ctypes.memmove(buf, data, len(data))
            return len(data)
        except Exception as e:
            return _errno_of(e)

    def _write(path, buf, size, offset, fi):
        try:
            data = ctypes.string_at(buf, size)
            return ops.write(_get_fh(fi), data, offset)
        except Exception as e:
            return _errno_of(e)

    def _flush(path, fi):
        try:
            ops.flush(_get_fh(fi))
            return 0
        except Exception as e:
            return _errno_of(e)

    def _release(path, fi):
        try:
            ops.release(_get_fh(fi))
            return 0
        except Exception as e:
            return _errno_of(e)

    def _truncate(path, length):
        try:
            ops.truncate(path.decode(), length)
            return 0
        except Exception as e:
            return _errno_of(e)

    def _unlink(path):
        try:
            ops.unlink(path.decode())
            return 0
        except Exception as e:
            return _errno_of(e)

    def _mkdir(path, mode):
        try:
            ops.mkdir(path.decode(), mode)
            return 0
        except Exception as e:
            return _errno_of(e)

    def _rmdir(path):
        try:
            ops.rmdir(path.decode())
            return 0
        except Exception as e:
            return _errno_of(e)

    def _rename(old, new):
        try:
            ops.rename(old.decode(), new.decode())
            return 0
        except Exception as e:
            return _errno_of(e)

    def _link(target, link_path):
        try:
            ops.link(target.decode(), link_path.decode())
            return 0
        except Exception as e:
            return _errno_of(e)

    def _setxattr(path, name, value, size, flags):
        try:
            ops.setxattr(path.decode(), name.decode(),
                         ctypes.string_at(value, size))
            return 0
        except Exception as e:
            return _errno_of(e)

    def _getxattr(path, name, buf, size):
        try:
            value = ops.getxattr(path.decode(), name.decode())
            if size == 0:
                return len(value)
            if size < len(value):
                return -errno.ERANGE
            ctypes.memmove(buf, value, len(value))
            return len(value)
        except Exception as e:
            return _errno_of(e)

    def _listxattr(path, buf, size):
        try:
            names = b"".join(n.encode() + b"\x00"
                             for n in ops.listxattr(path.decode()))
            if size == 0:
                return len(names)
            if size < len(names):
                return -errno.ERANGE
            ctypes.memmove(buf, names, len(names))
            return len(names)
        except Exception as e:
            return _errno_of(e)

    def _removexattr(path, name):
        try:
            ops.removexattr(path.decode(), name.decode())
            return 0
        except Exception as e:
            return _errno_of(e)

    def _ok(*args):
        return 0

    operations = FuseOperations()
    operations.getattr = wrap(GETATTR_T, _getattr)
    operations.readdir = wrap(READDIR_T, _readdir)
    operations.create = wrap(CREATE_T, _create)
    operations.open = wrap(FI_T, _open)
    operations.read = wrap(RW_T, _read)
    operations.write = wrap(RW_T, _write)
    operations.flush = wrap(FI_T, _flush)
    operations.release = wrap(FI_T, _release)
    operations.truncate = wrap(TRUNCATE_T, _truncate)
    operations.unlink = wrap(PATH_T, _unlink)
    operations.mkdir = wrap(MK_T, _mkdir)
    operations.rmdir = wrap(PATH_T, _rmdir)
    operations.rename = wrap(PATH2_T, _rename)
    operations.link = wrap(PATH2_T, _link)
    operations.setxattr = wrap(SETXATTR_T, _setxattr)
    operations.getxattr = wrap(GETXATTR_T, _getxattr)
    operations.listxattr = wrap(LISTXATTR_T, _listxattr)
    operations.removexattr = wrap(PATH2_T, _removexattr)
    operations.chmod = wrap(MK_T, _ok)
    operations.chown = wrap(CHOWN_T, _ok)
    operations.utimens = wrap(UTIMENS_T, _ok)

    argv = [b"seaweedfs-torch", mountpoint.encode()]
    if foreground:
        argv.append(b"-f")
    argv.append(b"-s")  # single-threaded: WFS handles are loop-free sync
    if options:
        argv += [b"-o", options.encode()]
    argc = len(argv)
    argv_arr = (ctypes.c_char_p * argc)(*argv)

    libfuse.fuse_main_real.restype = ctypes.c_int
    return libfuse.fuse_main_real(
        argc, argv_arr, ctypes.byref(operations),
        ctypes.sizeof(operations), None)
