"""The port's compaction and open-time crash recovery against the
reference's.

(a) The reference's tests/test_vacuum.py cases run against the port's
    Volume: compaction reclaims garbage, the makeup-diff replay keeps the
    writes and deletes that land between begin_compact and
    commit_compact, cleanup aborts, a second begin is refused. Beyond
    the reference: an EC seal and a compaction exclude each other.
(b) Byte identity: one directory is written once, copied, and each copy
    is compacted (with writes in the makeup window, their append times
    preserved) by its own package's Volume or Store; the .dat, .idx and
    .swm come out equal. The Store's vacuum steps, needle_ids and
    configure_replication likewise.
(c) Crash recovery on the same torn inputs: a volume's files are taken
    while it is open (half its needles behind a sync watermark, half
    not), then the .dat tail is cut, the .idx is cut anywhere past its
    watermark, a byte of the un-synced tail may be flipped, or the
    journal trails the .dat by whole entries; each package opens its
    own copy. Both must leave the same .dat/.idx and the same readable
    needles, or fail the same way.
"""

import json
import os
import shutil

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from seaweedfs_torch.ec import geometry as pgeo
from seaweedfs_torch.storage import needle as pneedle
from seaweedfs_torch.storage import types as pt
from seaweedfs_torch.storage.store import Store as PStore
from seaweedfs_torch.storage.volume import NeedleDeleted as PDeleted
from seaweedfs_torch.storage.volume import NeedleNotFound as PNotFound
from seaweedfs_torch.storage.volume import Volume as PVolume
from seaweedfs_torch.storage.volume import VolumeCompacting, VolumeReadOnly
from seaweedfs_tpu.storage import needle as rneedle
from seaweedfs_tpu.storage.store import Store as RStore
from seaweedfs_tpu.storage.volume import Volume as RVolume

PACKAGES = {"reference": (RVolume, rneedle), "port": (PVolume, pneedle)}
T0 = 1_700_000_000_000_000_000


def mk_needle(i: int, data: bytes) -> pneedle.Needle:
    return pneedle.Needle(cookie=0x1234 + i, id=i, data=data)


# --- (a) the reference's vacuum cases on the port ---------------------------

def test_compact_reclaims_garbage(tmp_path):
    v = PVolume(str(tmp_path), "", 1, create=True)
    for i in range(1, 11):
        v.write_needle(mk_needle(i, bytes([i]) * 100))
    for i in (2, 4, 6):
        v.delete_needle(mk_needle(i, b""))
    size_before = v.data_file_size()
    assert v.garbage_level() > 0
    v.compact()
    assert v.data_file_size() < size_before
    assert v.garbage_level() == 0
    assert v.super_block.compaction_revision == 1
    for i in range(1, 11):
        if i in (2, 4, 6):
            with pytest.raises((PNotFound, PDeleted)):
                v.read_needle(i)
        else:
            assert v.read_needle(i).data == bytes([i]) * 100
    v.close()


def test_compact_makeup_diff_replays_concurrent_writes(tmp_path):
    v = PVolume(str(tmp_path), "", 2, create=True)
    for i in range(1, 8):
        v.write_needle(mk_needle(i, b"old" + bytes([i]) * 50))
    v.delete_needle(mk_needle(3, b""))
    v.begin_compact()
    # these land in the old .dat while the copy is in flight
    v.write_needle(mk_needle(100, b"during-compact-new"))
    v.write_needle(mk_needle(5, b"during-compact-overwrite"))
    v.delete_needle(mk_needle(6, b""))
    v.write_needle(mk_needle(101, b"added-then-deleted"))
    v.delete_needle(mk_needle(101, b""))
    v.commit_compact()
    assert v.read_needle(100).data == b"during-compact-new"
    assert v.read_needle(5).data == b"during-compact-overwrite"
    for gone in (3, 6, 101):
        with pytest.raises((PNotFound, PDeleted)):
            v.read_needle(gone)
    for i in (1, 2, 4, 7):
        assert v.read_needle(i).data == b"old" + bytes([i]) * 50
    # the compacted files survive a reload (the journal is coherent)
    v.close()
    v2 = PVolume(str(tmp_path), "", 2)
    assert v2.read_needle(100).data == b"during-compact-new"
    assert v2.read_needle(5).data == b"during-compact-overwrite"
    with pytest.raises((PNotFound, PDeleted)):
        v2.read_needle(6)
    v2.close()


def test_compact_cleanup_aborts(tmp_path):
    v = PVolume(str(tmp_path), "", 3, create=True)
    v.write_needle(mk_needle(1, b"x" * 64))
    v.begin_compact()
    base = v.base_file_name()
    assert os.path.exists(base + ".cpd")
    v.cleanup_compact()
    assert not os.path.exists(base + ".cpd")
    assert not os.path.exists(base + ".cpx")
    # a fresh cycle works after an abort
    v.compact()
    assert v.read_needle(1).data == b"x" * 64
    v.close()


def test_double_begin_compact_rejected(tmp_path):
    v = PVolume(str(tmp_path), "", 4, create=True)
    v.write_needle(mk_needle(1, b"y"))
    v.begin_compact()
    with pytest.raises(RuntimeError):
        v.begin_compact()
    v.commit_compact()
    v.close()


def test_seal_and_compaction_exclude_each_other(tmp_path):
    """A commit swaps the .dat and .idx; an EC encode reads them as they
    stand. So a seal is refused while a compaction is open, a sealed
    volume refuses a compaction, and a volume made read-only during one
    refuses its commit, its files untouched until the cleanup aborts it.
    The encode then runs on the files it sealed."""
    live = _write_source(str(tmp_path), 5)
    g = pgeo.Geometry(10, 4, large_block_size=64 * 1024,
                      small_block_size=4 * 1024)
    store = PStore([str(tmp_path)], coder_name="numpy", geometry=g)
    v = store.find_volume(7)
    base = v.base_file_name()
    try:
        store.vacuum_compact(7)
        with pytest.raises(VolumeCompacting):
            store.ec_generate(7)
        with pytest.raises(VolumeCompacting):
            store.ec_generate_many([7])
        assert not v.read_only
        assert not [f for f in os.listdir(tmp_path) if ".ec" in f]
        store.vacuum_commit(7)
        assert v.super_block.compaction_revision == 1

        store.vacuum_compact(7)
        store.mark_readonly(7)
        before = _files(str(tmp_path))
        with pytest.raises(VolumeReadOnly):
            store.vacuum_commit(7)
        assert _files(str(tmp_path)) == before
        assert v.super_block.compaction_revision == 1
        store.vacuum_cleanup(7)
        assert not os.path.exists(base + ".cpd")
        assert not os.path.exists(base + ".cpx")
        with pytest.raises(VolumeReadOnly):
            store.vacuum_compact(7)

        store.mark_readonly(7, False)
        assert store.ec_generate(7) == list(range(14))
        assert v.read_only
        with pytest.raises(VolumeReadOnly):
            store.vacuum_compact(7)
        for nid, data in live.items():
            assert store.read_needle(7, nid).data == data
    finally:
        store.close()


# --- (b) byte identity ------------------------------------------------------

def _put(volume, needle_mod, nid: int, data: bytes, t: int,
         name: bytes = b"") -> None:
    n = needle_mod.Needle(cookie=0xC0FFEE00 + nid, id=nid, data=data,
                          append_at_ns=T0 + t)
    if name:
        n.name = name
        n.set_flag(0x02)
    volume.write_needle(n, preserve_append_at_ns=True)


def _delete(volume, needle_mod, nid: int, t: int) -> None:
    volume.delete_needle(needle_mod.Needle(cookie=0xC0FFEE00 + nid, id=nid,
                                           append_at_ns=T0 + t),
                         preserve_append_at_ns=True)


def _write_source(directory: str, seed: int, count: int = 60) -> dict:
    """A volume "c_7" of seeded puts, overwrites and deletes, closed;
    returns id -> data of the live needles."""
    rng = np.random.default_rng(seed)
    v = PVolume(directory, "c", 7, create=True)
    live = {}
    for i in range(count):
        nid = int(rng.integers(1, 30))
        if live.get(nid) and rng.random() < 0.3:
            _delete(v, pneedle, nid, i)
            del live[nid]
            continue
        data = rng.bytes(int(rng.choice([1, 9, 300, 5000, 40000])))
        _put(v, pneedle, nid, data, i,
             name=b"f%d.bin" % i if rng.random() < 0.3 else b"")
        live[nid] = data
    v.close()
    return live


def _files(directory, base: str = "c_7") -> dict:
    out = {}
    for ext in (".dat", ".idx", ".swm"):
        path = os.path.join(directory, base + ext)
        if os.path.exists(path):
            with open(path, "rb") as f:
                out[ext] = f.read()
    if ".swm" in out:
        out[".swm"] = json.loads(out[".swm"])
    return out


def _copies(tmp_path, src) -> dict:
    out = {}
    for name in PACKAGES:
        out[name] = tmp_path / name
        shutil.copytree(src, out[name])
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_compaction_bytes_identical_to_reference(tmp_path, seed):
    """Each package's begin_compact / writes and deletes in the makeup
    window / commit_compact on a copy of one volume: the same files."""
    src = tmp_path / "src"
    src.mkdir()
    live = _write_source(str(src), seed)
    files = {}
    for name, d in _copies(tmp_path, src).items():
        vol_cls, needle_mod = PACKAGES[name]
        v = vol_cls(str(d), "c", 7)
        assert v.garbage_level() > 0
        v.begin_compact()
        _put(v, needle_mod, 200, b"during the copy" * 10, 1000)
        _put(v, needle_mod, next(iter(live)), b"overwritten", 1001)
        _delete(v, needle_mod, sorted(live)[-1], 1002)
        v.commit_compact()
        assert v.super_block.compaction_revision == 1
        v.close()
        files[name] = _files(d)
    assert files["port"] == files["reference"]
    assert len(files["port"][".dat"]) < os.path.getsize(src / "c_7.dat")


def test_store_vacuum_matches_reference(tmp_path):
    """The Store's vacuum steps, needle_ids and configure_replication on
    copies of one directory: the same answers and the same files."""
    src = tmp_path / "src"
    src.mkdir()
    _write_source(str(src), 4)
    results = {}
    for name, d in _copies(tmp_path, src).items():
        store = (PStore if name == "port" else RStore)(
            [str(d)], coder_name="numpy")
        out = [store.vacuum_check(7), sorted(store.needle_ids(7))]
        store.vacuum_compact(7)
        with pytest.raises(RuntimeError):
            store.vacuum_compact(7)
        store.vacuum_cleanup(7)
        with pytest.raises(RuntimeError):
            store.vacuum_commit(7)
        store.vacuum_compact(7)
        store.vacuum_commit(7)
        store.configure_replication(7, "001")
        out += [store.vacuum_check(7), sorted(store.needle_ids(7)),
                str(store.find_volume(7).super_block.replica_placement)]
        for op in (store.vacuum_check, store.vacuum_compact,
                   store.vacuum_commit, store.vacuum_cleanup,
                   store.needle_ids):
            with pytest.raises(KeyError):
                op(99)
        with pytest.raises(ValueError):
            store.configure_replication(7, "009")
        store.close()
        # the placement survives a reopen
        store = (PStore if name == "port" else RStore)(
            [str(d)], coder_name="numpy")
        out.append(str(store.find_volume(7).super_block.replica_placement))
        store.close()
        results[name] = (out, _files(d))
    assert results["port"] == results["reference"]
    assert results["port"][0][-1] == "001"


# --- (c) crash recovery on the same torn inputs -------------------------------

@pytest.fixture(scope="module")
def crash_image(tmp_path_factory):
    """The files of volume "c_7" taken while it is open: 40 needles
    behind a sync watermark (.swm), then 40 more puts and deletes that
    were never synced. Returns (directory, .dat and .idx watermarks)."""
    d = tmp_path_factory.mktemp("crash_src")
    rng = np.random.default_rng(9)
    v = PVolume(str(d), "c", 7, create=True)
    for i in range(80):
        nid = int(rng.integers(1, 50))
        if i % 7 == 6:
            _delete(v, pneedle, nid, i)
        else:
            _put(v, pneedle, nid,
                 rng.bytes(int(rng.choice([0, 5, 700, 9000]))), i)
        if i == 39:
            v.sync()
            wm = json.load(open(d / "c_7.swm"))
    image = d / "image"
    image.mkdir()
    for ext in (".dat", ".idx", ".swm"):
        shutil.copyfile(d / f"c_7{ext}", image / f"c_7{ext}")
    v.close()
    return image, wm["synced_size"], wm["idx_synced_size"]


def _recover(image, work, cut_dat: int, cut_idx: int, flip,
             watermark: bool) -> dict:
    """Open a torn copy of the image with each package; returns package
    -> (files after open and close, readable needles) or the error."""
    results = {}
    for name, (vol_cls, _) in PACKAGES.items():
        d = work / name
        shutil.copytree(image, d)
        if not watermark:
            os.remove(d / "c_7.swm")
        with open(d / "c_7.dat", "r+b") as f:
            f.truncate(cut_dat)
            if flip is not None and flip < cut_dat:
                f.seek(flip)
                b = f.read(1)
                f.seek(flip)
                f.write(bytes([b[0] ^ 0x5A]))
        with open(d / "c_7.idx", "r+b") as f:
            f.truncate(cut_idx)
        try:
            v = vol_cls(str(d), "c", 7)
        except Exception as e:
            # without a watermark a cut below the journal's last
            # reference is trusted, and the open fails on it: the same
            # failure from both packages is the same outcome
            results[name] = ("error", type(e).__name__)
            continue
        readable = {}
        for key, _size in v.nm.live_entries():
            try:
                readable[key] = v.read_needle(key).data
            except (KeyError, ValueError, OSError) as e:
                readable[key] = type(e).__name__
        v.close()
        results[name] = (_files(d), readable)
    return results


@pytest.mark.parametrize("watermark", [True, False])
@settings(deadline=None, max_examples=30, database=None)
@given(dat_at=st.floats(0, 1), idx_at=st.floats(0, 1),
       flip_at=st.one_of(st.none(), st.floats(0, 1)))
def test_crash_recovery_matches_reference(crash_image, tmp_path_factory,
                                          watermark, dat_at, idx_at,
                                          flip_at):
    image, dat_wm, idx_wm = crash_image
    dat_size = os.path.getsize(image / "c_7.dat")
    idx_size = os.path.getsize(image / "c_7.idx")
    # a power loss keeps everything below the watermarks (fsynced)
    cut_dat = dat_wm + int(dat_at * (dat_size - dat_wm))
    lo = idx_wm if watermark else 0
    cut_idx = lo + int(idx_at * (idx_size - lo))
    flip = (None if flip_at is None
            else dat_wm + int(flip_at * (dat_size - dat_wm - 1)))
    results = _recover(image, tmp_path_factory.mktemp("torn"), cut_dat,
                       cut_idx, flip, watermark)
    assert results["port"] == results["reference"]


@pytest.mark.parametrize("watermark", [True, False])
def test_trailing_journal_rederived_like_reference(crash_image, tmp_path,
                                                   watermark):
    """A whole .dat whose journal lost its last 9 entries: both packages
    re-derive the entries of records that carry data, to the same
    files, and every needle with a body reads back."""
    image, _, idx_wm = crash_image
    entry = pt.needle_map_entry_size(pt.OFFSET_SIZE)
    idx_size = os.path.getsize(image / "c_7.idx")
    cut_idx = max(idx_size - 9 * entry, idx_wm if watermark else 0)
    results = _recover(image, tmp_path, os.path.getsize(image / "c_7.dat"),
                       cut_idx, None, watermark)
    assert results["port"] == results["reference"]
    files, readable = results["port"]
    assert len(files[".idx"]) > cut_idx
    assert readable and all(isinstance(v, bytes) for v in readable.values())
