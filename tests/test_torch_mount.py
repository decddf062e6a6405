"""The port's mount (seaweedfs_torch/mount/) against the reference's.

- the dirty-page interval algebra: the reference's cases of
  tests/test_mount.py run on both packages' ``ContinuousIntervals``, and
  seeded random sequences of adds, reads and pops on both, with equal
  intervals, reads and popped runs after every step;
- the eight ``WFS`` cases of tests/test_mount.py and the xattr and hard
  link cases of tests/test_aux_surface.py on the port's cluster;
- one seeded script of mount operations (overlapping out-of-order
  writes with early flushes, a reopen and overwrite, truncate, rename,
  mkdir, readdir, unlink, rmdir, link, xattrs) on the reference's
  ``WFS`` over a reference cluster and on the port's over a port
  cluster: equal bytes, equal entry sizes, equal chunk layouts (each
  chunk's offset and size), equal listings and xattrs;
- truncate and rename of a file while a handle holds it open (ROADMAP
  Queue 3, D22 and D23): the port's against a ``bytearray`` model, the
  reference's recorded as it behaves.
"""

import random
import time

import pytest

import test_mount as ref
from cluster_util import Cluster as RCluster
from seaweedfs_torch.mount import dirty_pages as pdirty
from seaweedfs_torch.mount import wfs as pwfs
from seaweedfs_torch.server import http as phttp
from seaweedfs_torch.server.local_cluster import LocalCluster
from seaweedfs_tpu.mount import dirty_pages as rdirty
from seaweedfs_tpu.mount import wfs as rwfs

INTERVAL_CASES = ["test_single_interval_roundtrip", "test_overwrite_newer_wins",
                  "test_partial_overlap_left_right", "test_adjacent_coalesce",
                  "test_gap_not_coalesced_and_pop_largest",
                  "test_randomized_against_reference_buffer"]
WFS_CASES = ["test_wfs_create_write_read", "test_wfs_multi_chunk_flush",
             "test_wfs_overwrite_middle", "test_wfs_dirs_and_readdir",
             "test_wfs_rename", "test_wfs_truncate", "test_wfs_enoent",
             "test_wfs_read_your_writes_after_auto_flush"]
LIBS = {"reference": (rdirty, rwfs), "port": (pdirty, pwfs)}


@pytest.mark.parametrize("pkg", sorted(LIBS))
@pytest.mark.parametrize("case", INTERVAL_CASES)
def test_reference_interval_case(case, pkg, monkeypatch):
    monkeypatch.setattr(ref, "ContinuousIntervals",
                        LIBS[pkg][0].ContinuousIntervals)
    getattr(ref, case)()


def _state(ci) -> list:
    return [(iv.start, iv.data) for iv in ci.intervals]


@pytest.mark.parametrize("seed", range(4))
def test_interval_sequences_equal(seed):
    rng = random.Random(seed)
    cis = [rdirty.ContinuousIntervals(), pdirty.ContinuousIntervals()]
    for _ in range(300):
        op = rng.random()
        if op < 0.75:
            off, n = rng.randrange(0, 4000), rng.randrange(0, 300)
            data = rng.randbytes(n)
            for ci in cis:
                ci.add_interval(data, off)
        elif op < 0.9:
            off, n = rng.randrange(0, 4200), rng.randrange(0, 600)
            assert cis[0].read_data_at(n, off) == cis[1].read_data_at(n, off)
        else:
            popped = [ci.pop_largest_contiguous() for ci in cis]
            assert [None if p is None else (p.start, p.data)
                    for p in popped[:1]] == \
                [None if p is None else (p.start, p.data)
                 for p in popped[1:]]
        assert _state(cis[0]) == _state(cis[1])
        assert cis[0].total_size() == cis[1].total_size()
        assert cis[0].buffered_bytes() == cis[1].buffered_bytes()
    assert [(i.start, i.data) for i in cis[0].pop_all()] == \
        [(i.start, i.data) for i in cis[1].pop_all()]


def test_interval_truncate():
    ci = pdirty.ContinuousIntervals()
    ci.add_interval(b"abcdef", 0)
    ci.add_interval(b"xyz", 10)
    ci.add_interval(b"QQ", 20)
    ci.truncate(11)
    assert _state(ci) == [(0, b"abcdef"), (10, b"x")]
    ci.truncate(0)
    assert _state(ci) == [] and ci.total_size() == 0


# --- WFS over a port cluster ---

@pytest.fixture(scope="module")
def cluster():
    cl = LocalCluster(1, coder_name="torch", device="cpu", pulse=0.15)
    yield cl
    cl.shutdown()


@pytest.fixture(scope="module")
def filer(cluster):
    return cluster.add_filer("memory", 8 * 1024)


@pytest.fixture(scope="module")
def wfs(filer):
    w = pwfs.WFS(filer.url, chunk_size=8 * 1024, cache_ttl=0.0)
    yield w
    w.destroy()


@pytest.mark.parametrize("case", WFS_CASES)
def test_reference_wfs_case(case, wfs, monkeypatch):
    monkeypatch.setattr(ref, "FuseError", pwfs.FuseError)
    getattr(ref, case)(wfs)


def test_wfs_xattr(filer):
    """tests/test_aux_surface.py::test_wfs_xattr on the port."""
    w = pwfs.WFS(filer.url)
    fh = w.create("/x/attrs.txt")
    w.write(fh, b"data", 0)
    w.flush(fh)
    w.release(fh)

    w.setxattr("/x/attrs.txt", "user.color", b"blue")
    w.setxattr("/x/attrs.txt", "user.shape", b"round")
    assert w.getxattr("/x/attrs.txt", "user.color") == b"blue"
    assert sorted(w.listxattr("/x/attrs.txt")) == ["user.color",
                                                   "user.shape"]
    w.removexattr("/x/attrs.txt", "user.color")
    assert w.listxattr("/x/attrs.txt") == ["user.shape"]
    with pytest.raises(pwfs.FuseError):
        w.getxattr("/x/attrs.txt", "user.color")
    w.destroy()


def test_wfs_hardlink_shares_data_and_survives_unlink(cluster, filer):
    """tests/test_aux_surface.py::test_wfs_hardlink_... on the port, and
    the last unlink frees the shared chunks."""
    w = pwfs.WFS(filer.url)
    fh = w.create("/h/orig.bin")
    w.write(fh, b"linked-bytes" * 100, 0)
    w.flush(fh)
    w.release(fh)
    fids = [c["fid"] for c in w.lookup("/h/orig.bin")["chunks"]]

    w.link("/h/orig.bin", "/h/alias.bin")
    fh = w.open("/h/alias.bin")
    assert w.read(fh, 12, 0) == b"linked-bytes"
    w.release(fh)

    # removing the original must not free the shared chunks
    w.unlink("/h/orig.bin")
    time.sleep(0.5)  # let any (wrong) chunk deletion run
    fh = w.open("/h/alias.bin")
    assert w.read(fh, 12 * 100, 0) == b"linked-bytes" * 100
    w.release(fh)
    # removing the last link frees them
    w.unlink("/h/alias.bin")
    deadline = time.monotonic() + 10
    while any(phttp.request("GET", f"http://{cluster.url(0)}/{f}").status
              != 404 for f in fids):
        assert time.monotonic() < deadline, "the last unlink freed nothing"
        time.sleep(0.05)
    w.destroy()


# --- one seeded script on both packages ---

def _pieces(rng: random.Random, size: int) -> list:
    cover, at = [], 0
    while at < size:
        n = min(size - at, rng.randrange(100, 3000))
        cover.append((at, n))
        at += n
    extra = [(rng.randrange(0, max(1, size - 500)), rng.randrange(1, 500))
             for _ in range(len(cover) // 3)]
    out = cover + extra
    rng.shuffle(out)
    return [(off, rng.randbytes(n)) for off, n in out]


def _script(w, seed: int) -> dict:
    """Mount operations on `w`; what they leave behind."""
    rng = random.Random(seed)
    w.mkdir("/s")
    w.mkdir("/s/d")
    paths = []
    for i in range(6):
        path = f"/s/f{i}.bin"
        size = rng.choice([50, 900, 5000, 9000, 17000, 30000])
        fh = w.create(path)
        for off, data in _pieces(rng, size):
            w.write(fh, data, off)
        w.release(fh)
        paths.append(path)
    # a reopen that overwrites a middle range and extends the file
    fh = w.open(paths[3], for_write=True)
    w.write(fh, rng.randbytes(2000), 1000)
    w.write(fh, rng.randbytes(700), 9500)
    w.release(fh)
    w.truncate(paths[4], 7001)
    w.rename(paths[5], "/s/d/renamed.bin")
    w.link(paths[2], "/s/d/link.bin")
    w.unlink(paths[1])
    w.setxattr(paths[0], "user.k", b"v1")
    w.setxattr("/s/d/renamed.bin", "user.k", b"v2")
    w.mkdir("/s/gone")
    w.rmdir("/s/gone")
    out = {"ls": w.readdir("/s"), "ls_d": w.readdir("/s/d")}
    for p in ["/s/f0.bin", "/s/f2.bin", "/s/f3.bin", "/s/f4.bin",
              "/s/d/renamed.bin", "/s/d/link.bin"]:
        entry = w.lookup(p)
        fh = w.open(p)
        out[p] = {"bytes": w.read(fh, 1 << 20, 0),
                  "size": w.getattr(p)["size"],
                  "chunks": [(c["offset"], c["size"])
                             for c in entry["chunks"]],
                  "xattrs": {n: w.getxattr(p, n) for n in w.listxattr(p)}}
        w.release(fh)
    return out


def test_seeded_mount_script_equal():
    rc = RCluster(n_volume_servers=1, pulse=0.15)
    pc = LocalCluster(1, coder_name="torch", device="cpu", pulse=0.15)
    try:
        got = []
        for lib, fs in ((rwfs, rc.add_filer(chunk_size=8 * 1024)),
                        (pwfs, pc.add_filer("memory", 8 * 1024))):
            w = lib.WFS(fs.url, chunk_size=4096, cache_ttl=0.0)
            try:
                got.append(_script(w, 2026))
            finally:
                w.destroy()
        assert got[0] == got[1]
        # the script did what it meant to: early flushes, several chunks
        assert max(len(v["chunks"]) for k, v in got[1].items()
                   if k.startswith("/")) > 3
    finally:
        pc.shutdown()
        rc.shutdown()


def test_truncate_and_rename_of_open_files(filer):
    """D22: a truncate under an open handle drops its buffered and
    flushed bytes past the cut; D23: a rename under an open handle moves
    it, so its release saves the new name. Held against a bytearray."""
    rng = random.Random(5)
    w = pwfs.WFS(filer.url, chunk_size=4096, cache_ttl=0.0)
    try:
        model = bytearray()
        fh = w.create("/open/cut.bin")
        for off, data in _pieces(rng, 20000):
            w.write(fh, data, off)
            model[len(model):off] = bytes(max(0, off - len(model)))
            model[off:off + len(data)] = data
        assert w.handles[fh]._has_local_chunks  # an early flush ran
        w.truncate("/open/cut.bin", 6000)
        del model[6000:]
        assert w.getattr("/open/cut.bin")["size"] == 6000
        assert w.read(fh, 30000, 0) == bytes(model)
        tail = rng.randbytes(300)
        w.write(fh, tail, 5900)
        model[5900:6200] = tail
        w.release(fh)
        fh = w.open("/open/cut.bin")
        assert w.read(fh, 30000, 0) == bytes(model)
        assert w.getattr("/open/cut.bin")["size"] == 6200
        w.release(fh)

        fh = w.create("/open/mv.bin")
        w.write(fh, b"before", 0)
        w.rename("/open/mv.bin", "/open/moved.bin")
        w.write(fh, b"-after", 6)
        w.release(fh)
        assert w.lookup("/open/mv.bin") is None
        fh = w.open("/open/moved.bin")
        assert w.read(fh, 100, 0) == b"before-after"
        w.release(fh)
    finally:
        w.destroy()


def test_reference_rename_of_an_open_file_recreates_the_old_name():
    """D23 as the reference behaves: its handle keeps the old path, so
    the release saves a file at the old name again."""
    rc = RCluster(n_volume_servers=1, pulse=0.15)
    try:
        w = rwfs.WFS(rc.add_filer().url, cache_ttl=0.0)
        fh = w.create("/open/mv.bin")
        w.write(fh, b"before", 0)
        w.rename("/open/mv.bin", "/open/moved.bin")
        w.write(fh, b"-after", 6)
        w.release(fh)
        assert w.lookup("/open/mv.bin") is not None
        assert w.lookup("/open/moved.bin") is not None
        w.destroy()
    finally:
        rc.shutdown()


def test_reference_truncate_of_an_open_file_is_undone():
    """D22 as the reference behaves: its handle keeps its chunk list and
    dirty pages, so the release brings the cut bytes back."""
    rc = RCluster(n_volume_servers=1, pulse=0.15)
    try:
        w = rwfs.WFS(rc.add_filer().url, chunk_size=4096, cache_ttl=0.0)
        fh = w.create("/open/cut.bin")
        w.write(fh, random.Random(1).randbytes(20000), 0)
        w.truncate("/open/cut.bin", 6000)
        w.release(fh)
        assert w.getattr("/open/cut.bin")["size"] == 20000
        w.destroy()
    finally:
        rc.shutdown()
