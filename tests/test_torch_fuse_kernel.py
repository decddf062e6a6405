"""A real kernel FUSE mount of the port (tests/test_fuse_kernel.py against
the port's libfuse2 binding and its CLI ``mount``).

Runs only where /dev/fuse, libfuse, fusermount and uid 0 exist (the
reference's predicate), and only after a probe filesystem through the
port's binding mounts and serves a write and a read. The mount runs as a
subprocess; the file operations through the kernel run in a
subprocess of their own with a time limit, so a hung mount fails this
test instead of stalling the run; teardown lazy-unmounts and stops both.
"""

import ctypes.util
import json
import os
import shutil
import subprocess
import sys
import time
import urllib.request

import pytest

from seaweedfs_torch.server.local_cluster import LocalCluster

fuse_available = (os.path.exists("/dev/fuse")
                  and ctypes.util.find_library("fuse") is not None
                  and shutil.which("fusermount") is not None
                  and hasattr(os, "getuid") and os.getuid() == 0)

pytestmark = pytest.mark.skipif(not fuse_available,
                                reason="no usable /dev/fuse in this env")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOUNT_S = 30.0     # for a mount point to appear
DRIVE_S = 60.0     # for the file operations through the mount

_PROBE_FS = '''
import errno, stat, sys
sys.path.insert(0, %r)
from seaweedfs_torch.mount.fuse_ctypes import fuse_main


class ProbeFS:
    """One-directory in-memory fs: just enough ops for a write/read
    round trip through the kernel."""

    def __init__(self):
        self.files = {}
        self.cur = None

    def getattr(self, path):
        if path == "/":
            return {"mode": stat.S_IFDIR | 0o755, "nlink": 2}
        if path not in self.files:
            raise OSError(errno.ENOENT, path)
        return {"mode": stat.S_IFREG | 0o644, "size": len(self.files[path])}

    def readdir(self, path):
        return [p[1:] for p in self.files]

    def create(self, path, mode):
        self.files[path] = b""
        self.cur = path
        return 1

    def open(self, path, for_write=False):
        if path not in self.files:
            raise OSError(errno.ENOENT, path)
        self.cur = path
        return 1

    def read(self, fh, size, offset):
        return self.files[self.cur][offset:offset + size]

    def write(self, fh, data, offset):
        cur = self.files[self.cur].ljust(offset, b"\\0")
        self.files[self.cur] = cur[:offset] + data + cur[offset + len(data):]
        return len(data)

    def truncate(self, path, length):
        self.files[path] = self.files.get(path, b"")[:length]

    def flush(self, fh):
        pass

    def release(self, fh):
        self.cur = None


sys.exit(fuse_main(sys.argv[1], ProbeFS()))
''' % REPO

# the kernel-path operations of tests/test_fuse_kernel.py, through the
# mount point given as argv[1]; prints what it saw as JSON
_DRIVE = r'''
import json, os, sys
from pathlib import Path
mnt = Path(sys.argv[1])
big = bytes(range(256)) * 1200
p = mnt / "kernel.txt"
p.write_bytes(b"written through the kernel")
out = {"first": p.read_bytes().decode()}
(mnt / "d").mkdir()
(mnt / "d" / "big.bin").write_bytes(big)
out["big_equal"] = (mnt / "d" / "big.bin").read_bytes() == big
out["listing"] = sorted(os.listdir(mnt))
os.rename(mnt / "kernel.txt", mnt / "d" / "moved.txt")
out["moved"] = (mnt / "d" / "moved.txt").read_bytes().decode()
os.setxattr(mnt / "d" / "moved.txt", "user.k", b"v")
out["xattr"] = os.getxattr(mnt / "d" / "moved.txt", "user.k").decode()
os.link(mnt / "d" / "moved.txt", mnt / "alias.txt")
os.remove(mnt / "d" / "moved.txt")
out["alias"] = (mnt / "alias.txt").read_bytes().decode()
with open(mnt / "d" / "big.bin", "r+b") as f:
    f.truncate(1000)
out["truncated"] = os.path.getsize(mnt / "d" / "big.bin")
print(json.dumps(out))
'''


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = ":".join(
        p for p in (env.get("PYTHONPATH", ""), REPO) if p)
    return env


def _wait_mount(proc, mnt, timeout: float) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.ismount(mnt):
            return True
        if proc.poll() is not None:
            return False
        time.sleep(0.1)
    return os.path.ismount(mnt)


def _unmount(proc, mnt) -> None:
    subprocess.run(["fusermount", "-u", "-z", str(mnt)],
                   stderr=subprocess.DEVNULL, timeout=30)
    if proc is not None:
        proc.terminate()
        try:
            proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=5)


_fuse_functional_cache = None


def _require_functional_fuse(tmp_path):
    """Skip when the kernel's FUSE is what is broken here: a probe
    filesystem through the port's binding must mount and serve a write
    and a read (tests/test_fuse_kernel.py's probe)."""
    global _fuse_functional_cache
    if _fuse_functional_cache is None:
        _fuse_functional_cache = _probe_fuse(tmp_path)
    if not _fuse_functional_cache:
        pytest.skip("kernel FUSE is non-functional here (probe fs "
                    "mounted but file I/O failed)")


def _probe_fuse(tmp_path) -> bool:
    mnt = tmp_path / "fuse_probe"
    mnt.mkdir()
    proc = subprocess.Popen([sys.executable, "-c", _PROBE_FS, str(mnt)],
                            env=_env(), stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        if not _wait_mount(proc, mnt, 15.0):
            return False
        check = subprocess.run(
            [sys.executable, "-c",
             "import sys, pathlib; p = pathlib.Path(sys.argv[1]) / 'probe';"
             "p.write_bytes(b'ping'); assert p.read_bytes() == b'ping'",
             str(mnt)], timeout=15, capture_output=True)
        return check.returncode == 0
    except subprocess.TimeoutExpired:
        return False
    finally:
        _unmount(proc, mnt)


def test_kernel_mount_end_to_end(tmp_path):
    _require_functional_fuse(tmp_path)
    cl = LocalCluster(1, coder_name="torch", device="cpu", pulse=0.15)
    mnt = tmp_path / "mnt"
    mnt.mkdir()
    proc = None
    try:
        filer = cl.add_filer("memory", 64 * 1024)
        proc = subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_torch.cli", "mount",
             "-filer", filer.url, "-dir", str(mnt)], cwd=REPO, env=_env(),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        assert _wait_mount(proc, mnt, MOUNT_S), "mount never appeared"
        drive = subprocess.run([sys.executable, "-c", _DRIVE, str(mnt)],
                               capture_output=True, text=True,
                               timeout=DRIVE_S)
        assert drive.returncode == 0, drive.stderr[-2000:]
        out = json.loads(drive.stdout.strip().splitlines()[-1])
        assert out == {"first": "written through the kernel",
                       "big_equal": True, "listing": ["d", "kernel.txt"],
                       "moved": "written through the kernel",
                       "xattr": "v", "alias": "written through the kernel",
                       "truncated": 1000}
        # the data really lives in the filer, not the kernel cache
        with urllib.request.urlopen(f"http://{filer.url}/alias.txt",
                                    timeout=10) as r:
            assert r.read() == b"written through the kernel"
        with urllib.request.urlopen(f"http://{filer.url}/d/big.bin",
                                    timeout=10) as r:
            assert r.read() == (bytes(range(256)) * 1200)[:1000]
    finally:
        _unmount(proc, mnt)
        cl.shutdown()
