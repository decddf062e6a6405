"""The port's needle maps against the reference's.

One seeded sequence of puts, deletes and puts over a reused key space
goes through both packages' ``CompactNeedleMap`` and ``DiskNeedleMap``
(the disk map at a small flush threshold, so that it writes several
segments): the entries, counters and inventories must be equal, and so
must the ``.idx`` journal and the ``.sdx`` sidecar, byte for byte. Each
package then opens the other's sidecar without a rebuild, a replaced
journal makes either reject a stale sidecar, and a reopen replays only
the journal's tail past the last segment. A ``Volume`` runs on every
kind (and keeps its kind through a compaction), a batch that would bring
a disk map to its merge is declined by the nowait write in both
packages, and the reference's 10M-entry probe holds the port's disk map
to the same resident-memory budget, under the reference's skip rule.
"""

import json
import os
import random
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from seaweedfs_torch.storage import needle_map as pnm
from seaweedfs_torch.storage.needle import Needle as PNeedle
from seaweedfs_torch.storage.volume import Volume as PVolume
from seaweedfs_tpu.storage import idx as ridx
from seaweedfs_tpu.storage import needle_map as rnm
from seaweedfs_tpu.storage.needle import Needle as RNeedle
from seaweedfs_tpu.storage.volume import Volume as RVolume

KINDS = ["compact", "leveldb"]
# a disk map's threshold at test sizes: several segments per sequence
THRESHOLD = 64


def _ops(n: int = 3000, key_space: int = 700, seed: int = 13) -> list:
    """put / delete / put over a reused key space: overwrites, deletes of
    live and of absent keys, puts over tombstones."""
    rng = random.Random(seed)
    ops = []
    for i in range(n):
        key = rng.randrange(1, key_space)
        if rng.random() < 0.25:
            ops.append(("delete", key, i + 1, 0))
        else:
            ops.append(("put", key, i + 1, rng.randrange(1, 5000)))
    return ops


def _apply(nm, ops) -> None:
    for op, key, offset, size in ops:
        if op == "put":
            nm.put(key, offset, size)
        else:
            nm.delete(key, tombstone_offset=offset)


def _make(mod, kind: str, path):
    nm = mod.create_needle_map(kind, str(path))
    if isinstance(nm, mod.DiskNeedleMap):
        nm.FLUSH_THRESHOLD = THRESHOLD
    return nm


def _state(nm) -> dict:
    visited = []
    nm.ascending_visit(lambda nv: visited.append((nv.key, nv.offset,
                                                  nv.size)))
    return {
        "values": sorted((nv.key, nv.offset, nv.size) for nv in nm.values()),
        "counters": (nm.file_count, nm.deleted_count, nm.file_byte_count,
                     nm.deleted_byte_count, nm.maximum_key, len(nm)),
        "live": nm.live_entries(),
        "visit": visited,
        "gets": [(k, None if nm.get(k) is None else
                  (nm.get(k).offset, nm.get(k).size)) for k in range(0, 710)],
        "contains": [k in nm for k in range(0, 710)],
    }


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("kind", KINDS)
def test_maps_match_reference_bytes(tmp_path, kind):
    ops = _ops()
    maps = {}
    for name, mod in (("ref", rnm), ("port", pnm)):
        (tmp_path / name).mkdir()
        nm = _make(mod, kind, tmp_path / name / "1.idx")
        _apply(nm, ops)
        maps[name] = nm
    assert _state(maps["port"]) == _state(maps["ref"])
    if kind == "leveldb":
        assert maps["port"].flushes > 3
    for nm in maps.values():
        nm.close()
    for ext in (".idx", ".sdx"):
        r, p = tmp_path / "ref" / f"1{ext}", tmp_path / "port" / f"1{ext}"
        assert r.exists() == p.exists(), ext
        if r.exists():
            assert _bytes(p) == _bytes(r), ext
    assert (tmp_path / "port" / "1.sdx").exists() == (kind == "leveldb")


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_sidecar_opens_across_packages_without_rebuild(tmp_path, writer):
    """A sidecar written by one package is adopted by the other: no
    journal entry is folded at the open, and the journal tail appended
    after the last segment (a crash before the next flush) is replayed."""
    ops = _ops(1500)
    wmod, omod = (rnm, pnm) if writer == "ref" else (pnm, rnm)
    path = tmp_path / "1.idx"
    nm = _make(wmod, "leveldb", path)
    _apply(nm, ops)
    nm.close()
    sdx = _bytes(tmp_path / "1.sdx")
    closed = _state(_make(wmod, "leveldb", path))

    folded = []
    orig_fold = omod.DiskNeedleMap._fold

    def fold(self, *a):
        folded.append(a)
        return orig_fold(self, *a)

    omod.DiskNeedleMap._fold = fold
    try:
        other = _make(omod, "leveldb", path)
    finally:
        omod.DiskNeedleMap._fold = orig_fold
    assert folded == [] and len(other._map) == 0
    assert _state(other) == closed
    assert _bytes(tmp_path / "1.sdx") == sdx
    # a tail past the segment: appended, then the process dies
    tail = [("put", 5000 + i, 90_000 + i, 77) for i in range(5)] + \
        [("delete", ops[3][1], 90_100, 0)]
    _apply(other, tail)
    other._index_file.close()
    orig_fold = wmod.DiskNeedleMap._fold
    wmod.DiskNeedleMap._fold = fold
    try:
        back = _make(wmod, "leveldb", path)
    finally:
        wmod.DiskNeedleMap._fold = orig_fold
    assert len(folded) == len(tail)
    want = rnm.NeedleMap()
    _apply(want, ops + tail)
    assert sorted((nv.key, nv.offset, nv.size) for nv in back.values()
                  if nv.size > 0) == sorted(
        (nv.key, nv.offset, nv.size) for nv in want.values() if nv.size > 0)
    back.close()


@pytest.mark.parametrize("mod", [rnm, pnm], ids=["ref", "port"])
def test_stale_sidecar_rejected(tmp_path, mod):
    """An .idx replaced wholesale (vacuum commit, volume copy, `fix`)
    no longer matches the sidecar's fingerprint: the map rebuilds from
    the journal instead of serving the old segment."""
    path = str(tmp_path / "1.idx")
    nm = mod.DiskNeedleMap(path)
    for key in range(1, 10):
        nm.put(key, key, 100)
    nm.close()
    assert os.path.exists(tmp_path / "1.sdx")
    with open(path, "wb") as f:
        for key in range(1, 10):
            f.write(ridx.pack_entry(key, 21 + key, 100))
    again = mod.DiskNeedleMap(path)
    assert again.get(3).offset == 24 and len(again) == 9
    if mod is pnm:
        assert not again.adopted and again.replayed == 9
    again.close()


def test_tail_only_replay_matches_reference(tmp_path):
    """A reopen folds only what the journal gained since the last
    segment, and both packages agree on the result."""
    ops = _ops(2000, seed=5)
    for name, mod in (("ref", rnm), ("port", pnm)):
        (tmp_path / name).mkdir()
        nm = _make(mod, "leveldb", tmp_path / name / "1.idx")
        _apply(nm, ops)
        # the process dies with the delta unflushed
        nm._index_file.close()
    states = {}
    for name, mod in (("ref", rnm), ("port", pnm)):
        nm = _make(mod, "leveldb", tmp_path / name / "1.idx")
        states[name] = _state(nm)
        if mod is pnm:
            assert nm.adopted and 0 < nm.replayed < THRESHOLD
        nm.close()
    assert states["port"] == states["ref"]


def test_compact_map_merges_and_matches_dict_map(tmp_path):
    """Past its merge threshold the compact map folds its overflow into
    the arrays and still answers as the dict map does."""
    ops = _ops(6000, key_space=4000, seed=3)
    cm = pnm.CompactNeedleMap(str(tmp_path / "1.idx"))
    cm.MERGE_THRESHOLD = 100
    dm = pnm.NeedleMap()
    _apply(cm, ops)
    _apply(dm, ops)
    assert len(cm._keys) > 0
    assert _state(cm) == _state(dm)
    cm.close()
    assert _state(pnm.CompactNeedleMap(str(tmp_path / "1.idx"))) == \
        _state(dm)


def test_create_needle_map_names_match_reference(tmp_path):
    for kind in ("memory", "", "compact", "leveldb", "leveldbMedium",
                 "leveldbLarge", "disk"):
        p = pnm.create_needle_map(kind, str(tmp_path / f"p{kind}.idx"))
        r = rnm.create_needle_map(kind, str(tmp_path / f"r{kind}.idx"))
        assert type(p).__name__ == type(r).__name__
        assert getattr(p, "FLUSH_THRESHOLD", None) == \
            getattr(r, "FLUSH_THRESHOLD", None)
        p.close()
        r.close()
    for mod in (pnm, rnm):
        with pytest.raises(KeyError):
            mod.create_needle_map("btree")


@pytest.mark.parametrize("kind", ["memory", "compact", "leveldb",
                                  "leveldbMedium", "leveldbLarge"])
def test_volume_runs_on_each_kind(tmp_path, kind):
    """Writes, deletes and reads on a Volume of each map kind, the same
    answers as the reference's; a reopen and a compaction keep the kind,
    and the commit drops the sidecar of the replaced journal."""
    ids = list(range(1, 120))
    answers = {}
    for name, vmod, needle in (("ref", RVolume, RNeedle),
                               ("port", PVolume, PNeedle)):
        d = str(tmp_path / name)
        os.makedirs(d)
        v = vmod(d, "", 1, create=True, needle_map_kind=kind)
        for i in ids:
            v.write_needle(needle(cookie=i, id=i, data=b"x" * i))
        for i in ids[::5]:
            v.delete_needle(needle(cookie=i, id=i))
        v.write_needle(needle(cookie=3, id=3, data=b"over"))
        v.close()
        v = vmod(d, "", 1, needle_map_kind=kind)
        got = [type(v.nm).__name__, v.file_count(), v.nm.deleted_count]
        v.compact()
        got += [type(v.nm).__name__, v.file_count(),
                os.path.exists(os.path.join(d, "1.sdx"))]
        for i in ids:
            try:
                got.append(v.read_needle(i, cookie=i).data)
            except KeyError as e:
                got.append(type(e).__name__)
        v.close()
        v = vmod(d, "", 1, needle_map_kind=kind)
        got.append(sorted((nv.key, nv.size) for nv in v.nm.values()))
        v.close()
        answers[name] = got
    assert answers["port"] == answers["ref"]
    assert answers["port"][0] == type(
        pnm.create_needle_map(kind, None)).__name__


def test_crash_recovery_rejects_the_sidecar_of_a_torn_journal(tmp_path):
    """Open-time recovery drops .idx entries that reference torn .dat
    bytes and rewrites the journal: the sidecar that covered the old
    journal must not be adopted."""
    d = str(tmp_path)
    v = PVolume(d, "", 1, create=True, needle_map_kind="leveldb")
    for i in range(1, 40):
        v.write_needle(PNeedle(cookie=i, id=i, data=bytes([i]) * 500))
    v.close()                       # flushes the .sdx; a watermark too
    os.remove(os.path.join(d, "1.swm"))
    # tear the .dat inside the last record: its .idx entry must go
    dat = os.path.join(d, "1.dat")
    with open(dat, "r+b") as f:
        f.truncate(os.path.getsize(dat) - 100)
    v = PVolume(d, "", 1, needle_map_kind="leveldb")
    assert not v.nm.adopted
    assert v.file_count() == 38
    with pytest.raises(KeyError):
        v.read_needle(39)
    assert v.read_needle(38, cookie=38).data == bytes([38]) * 500
    v.close()


@pytest.mark.parametrize("vmod,needle", [(RVolume, RNeedle),
                                         (PVolume, PNeedle)],
                         ids=["ref", "port"])
def test_flush_imminent_declines_the_nowait_batch(tmp_path, vmod, needle):
    v = vmod(str(tmp_path), "", 1, create=True, needle_map_kind="leveldb")
    v.nm.FLUSH_THRESHOLD = 10
    for i in range(1, 8):
        v.write_needle(needle(cookie=i, id=i, data=b"d"))
    batch = [needle(cookie=i, id=i, data=b"e") for i in (20, 21, 22)]
    assert v.nm.flush_imminent(len(batch))
    assert v.write_needles_batch_nowait(batch) is None
    assert v.nm.get(20) is None
    small = [needle(cookie=30, id=30, data=b"f")]
    assert not v.nm.flush_imminent(1)
    assert v.write_needles_batch_nowait(small) is not None
    assert v.read_needle(30).data == b"f"
    v.close()


def _rss_probe_available() -> bool:
    """The reference's skip rule: peak RSS is read from VmHWM in
    /proc/self/status, which sandboxed kernels omit."""
    try:
        with open("/proc/self/status") as f:
            return any(line.startswith("VmHWM") for line in f)
    except OSError:
        return False


@pytest.mark.skipif(not _rss_probe_available(),
                    reason="no VmHWM in /proc/self/status "
                           "(sandboxed kernel): the RSS probe is unusable")
def test_disk_map_10m_entries_bounded_rss(tmp_path):
    """The reference's probe at its size, on the port's map: 10M unique
    needles straight into an .idx, opened by a clean subprocess (python
    -I: no test harness, no jax), random lookups, peak RSS under the
    reference's budgets, cold and on the reopen that adopts the .sdx."""
    n = 10_000_000
    rec = np.empty(n, dtype=[("k", ">u8"), ("o", ">u4"), ("s", ">u4")])
    rec["k"] = np.arange(1, n + 1, dtype=">u8")
    rec["o"] = np.arange(1, n + 1, dtype=">u4")
    rec["s"] = 1000
    path = str(tmp_path / "big.idx")
    rec.tofile(path)
    del rec
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = textwrap.dedent("""
        import json, sys, time
        sys.path.insert(0, sys.argv[2])
        from seaweedfs_torch.storage.needle_map import DiskNeedleMap
        def hwm_mb():
            for line in open("/proc/self/status"):
                if line.startswith("VmHWM"):
                    return int(line.split()[1]) / 1024
        t0 = time.perf_counter()
        nm = DiskNeedleMap(sys.argv[1])
        load_s = time.perf_counter() - t0
        for key in range(1, 10_000_000, 997_001):
            nv = nm.get(key)
            assert nv is not None and nv.offset == key, key
        assert nm.get(10_000_001) is None
        assert len(nm) == 10_000_000
        assert "jax" not in sys.modules
        print(json.dumps({"maxrss_mb": hwm_mb(), "load_s": load_s,
                          "adopted": nm.adopted}))
    """)
    stats = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-I", "-c", code, path, repo],
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        stats.append(json.loads(out.stdout))
    cold, warm = stats
    assert not cold["adopted"] and warm["adopted"], stats
    assert cold["maxrss_mb"] < 640 and cold["load_s"] < 60, stats
    assert warm["maxrss_mb"] < 250 and warm["load_s"] < 5, stats
    shutil.rmtree(tmp_path, ignore_errors=True)
