"""The port's fused warm-down (ec/fused.py) against the reference's.

A volume with the reference test's five payload kinds is written once,
copied, and each copy opened by its own package's Volume; both packages'
``fused_vacuum_gzip_encode`` then run on the same source bytes, the
reference with the "numpy" coder and the port with "numpy" and with the
kernels' plain versions (``TorchCoder(device="cpu")``). The compacted
.dat and .idx, the sorted .ecx and every shard must be equal bytes, and
so must the .ecm's geometry, dat_size and stamped digests. Also: the
port against its own sequential vacuum -> gzip -> encode chain, the
gated layout, the watermark, the three fault points, the Store's
promotion and staging sweep, and the governor's gzip axis.
"""

import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from seaweedfs_torch import faults as pfaults
from seaweedfs_torch import observe as pobserve
from seaweedfs_torch.ec import coder as pcoder
from seaweedfs_torch.ec import fused as pfused
from seaweedfs_torch.ec import geometry as pgeo
from seaweedfs_torch.ec import governor as pgov
from seaweedfs_torch.ec import pipeline as ppipe
from seaweedfs_torch.ec import striping as pstrip
from seaweedfs_torch.storage import idx as pidx
from seaweedfs_torch.storage import store as pstore
from seaweedfs_torch.storage import types as pt
from seaweedfs_torch.storage.needle import FLAG_IS_COMPRESSED
from seaweedfs_torch.storage.needle import Needle as PNeedle
from seaweedfs_torch.storage.superblock import SuperBlock as PSuperBlock
from seaweedfs_torch.storage.volume import Volume as PVolume
from seaweedfs_torch.utils import compression as pcomp
from seaweedfs_tpu import faults as rfaults
from seaweedfs_tpu.ec import fused as rfused
from seaweedfs_tpu.ec import geometry as rgeo
from seaweedfs_tpu.ec import get_coder as rget_coder
from seaweedfs_tpu.ec import governor as rgov
from seaweedfs_tpu.storage import store as rstore
from seaweedfs_tpu.storage.needle import (FLAG_HAS_MIME, FLAG_HAS_NAME,
                                          Needle as RNeedle)
from seaweedfs_tpu.storage.volume import Volume as RVolume
from seaweedfs_tpu.utils import compression as rcomp

# the plain version runs at test sizes: one thread keeps this worker
# from crowding the others under pytest-xdist
torch.set_num_threads(1)

CODERS = {"numpy": lambda k, m: pcoder.NumpyCoder(k, m),
          "torch_cpu": lambda k, m: pcoder.TorchCoder(k, m, device="cpu")}


@pytest.fixture(autouse=True)
def _clean_slate():
    for mod in (pfaults, rfaults):
        mod.clear()
    for mod in (pgov, rgov):
        mod.reset()
    yield
    for mod in (pfaults, rfaults):
        mod.clear()
    for mod in (pgov, rgov):
        mod.reset()


def build_volume(d, vid, n_needles, rng, delete_all=False):
    """The reference test's volume (tests/test_fused_warmdown.py:95-126),
    written by the reference's Volume: five payload kinds (compressible,
    gzip-declined random, tiny odd sizes, pre-compressed, bulky), names
    and mimes on every third, half the ids tombstoned (all with
    delete_all)."""
    v = RVolume(d, "", vid, create=True)
    for i in range(n_needles):
        kind = i % 5
        if kind == 0:
            data = b"compressible text block " * int(rng.integers(1, 400))
        elif kind == 1:
            data = rng.integers(0, 256, size=int(rng.integers(1, 9000)),
                                dtype=np.uint8).tobytes()
        elif kind == 2:
            data = b"x" * int(rng.integers(1, 7))
        elif kind == 3:
            data = rcomp.compress(b"already " * 600)
        else:
            data = b"padme" * int(rng.integers(100, 5000))
        n = RNeedle(cookie=int(rng.integers(0, 2**32)), id=i + 1, data=data)
        if kind == 3:
            n.set_flag(FLAG_IS_COMPRESSED)
        if i % 3 == 0:
            n.name = f"file-{i}.txt".encode()
            n.mime = b"text/plain"
            n.set_flag(FLAG_HAS_NAME)
            n.set_flag(FLAG_HAS_MIME)
        v.write_needle(n)
    for i in range(n_needles):
        if delete_all or i % 4 in (1, 2):
            v.delete_needle(RNeedle(cookie=0, id=i + 1))
    v.close()


def _files(base: str, g) -> dict:
    out = {}
    for ext in [".dat", ".idx", ".ecx"] + [pgeo.to_ext(i)
                                           for i in range(g.total_shards)]:
        with open(base + ext, "rb") as f:
            out[ext] = f.read()
    return out


def _marker(base: str) -> dict:
    with open(base + ".ecm") as f:
        return json.load(f)


def assert_identical(base_a: str, base_b: str, g) -> None:
    a, b = _files(base_a, g), _files(base_b, g)
    for ext in a:
        if a[ext] != b[ext]:
            common = min(len(a[ext]), len(b[ext]))
            first = next((i for i in range(common)
                          if a[ext][i] != b[ext][i]), common)
            pytest.fail(f"{ext}: diverges at byte {first} (sizes "
                        f"{len(a[ext])} vs {len(b[ext])})")
    ma, mb = _marker(base_a), _marker(base_b)
    for key in ("layout_version", "dat_size", "geometry", "shard_digests"):
        assert ma[key] == mb[key], key
    # the stamped digests are the files' own
    stamped = ppipe.read_stamped_digests(base_b)
    true = ppipe.shard_file_digest(base_b, range(g.total_shards))
    assert [stamped[i] for i in range(g.total_shards)] == true.tolist()


def _run_both(tmp_path, coder, kmbb, n_needles, seed, delete_all=False):
    """Both packages' fused passes on copies of one source volume;
    returns (reference stats, port stats, reference base, port base, g)."""
    k, m, lb, sb = kmbb
    src = tmp_path / "src"
    src.mkdir()
    build_volume(str(src), 7, n_needles, np.random.default_rng(seed),
                 delete_all)
    shutil.copytree(src, tmp_path / "ref")
    shutil.copytree(src, tmp_path / "port")
    rv = RVolume(str(tmp_path / "ref"), "", 7)
    pv = PVolume(str(tmp_path / "port"), "", 7)
    try:
        rstats = rfused.fused_vacuum_gzip_encode(
            rv, str(tmp_path / "ref" / "fused"), rget_coder("numpy", k, m),
            rgeo.Geometry(k, m, lb, sb))
        pg = pgeo.Geometry(k, m, lb, sb)
        pstats = pfused.fused_vacuum_gzip_encode(
            pv, str(tmp_path / "port" / "fused"), CODERS[coder](k, m), pg)
    finally:
        rv.close()
        pv.close()
    return (rstats, pstats, str(tmp_path / "ref" / "fused"),
            str(tmp_path / "port" / "fused"), pg)


_STATS = ("live_needles", "src_bytes", "compacted_bytes", "shard_files",
          "gzipped_needles", "shard_digests")


@pytest.mark.parametrize("coder", sorted(CODERS))
@pytest.mark.parametrize("kmbb,needles,seed", [
    ((10, 4, 64 * 1024, 4 * 1024), 120, 1),
    ((20, 4, 32 * 1024, 2 * 1024), 90, 2),
], ids=["rs10+4", "rs20+4"])
def test_fused_matches_reference(tmp_path, coder, kmbb, needles, seed):
    rstats, pstats, rbase, pbase, g = _run_both(tmp_path, coder, kmbb,
                                                needles, seed)
    assert_identical(rbase, pbase, g)
    assert {k: pstats[k] for k in _STATS} == {k: rstats[k] for k in _STATS}
    assert pstats["gzipped_needles"] > 0      # the splice ran
    assert pstats["live_needles"] < needles   # tombstones left


@pytest.mark.parametrize("coder", sorted(CODERS))
def test_fused_matches_reference_zero_live(tmp_path, coder):
    rstats, pstats, rbase, pbase, g = _run_both(
        tmp_path, coder, (10, 4, 64 * 1024, 4 * 1024), 40, 3,
        delete_all=True)
    assert_identical(rbase, pbase, g)
    assert pstats["live_needles"] == rstats["live_needles"] == 0


@pytest.mark.parametrize("coder", sorted(CODERS))
def test_fused_matches_reference_governed_multiworker(tmp_path, monkeypatch,
                                                      coder):
    monkeypatch.setenv("WEED_EC_GZIP_WORKERS", "4")
    monkeypatch.setenv("WEED_EC_GZIP_MAX", "8")   # 1-core hosts clamp
    monkeypatch.setenv("WEED_EC_READERS", "3")
    pgov.reset()
    rgov.reset()
    rstats, pstats, rbase, pbase, g = _run_both(
        tmp_path, coder, (10, 4, 64 * 1024, 4 * 1024), 120, 5)
    assert_identical(rbase, pbase, g)
    assert pstats["gzip_workers"] == rstats["gzip_workers"] == 4


# ------------------------------------------- the port's own sequential chain

def sequential_reference(volume, dst_base, coder, g, gzip_level=1):
    """The chained path the fused pass replaces, in the port: compact and
    gzip into dst by per-needle reads, then stream_encode, then the sorted
    .ecx (the reference test's chain, tests/test_fused_warmdown.py:48-92,
    on the port's modules)."""
    with volume._lock:
        snapshot = [nv for nv in volume.nm.values()
                    if pt.size_is_valid(nv.size)]
        sb = PSuperBlock(
            version=volume.super_block.version,
            replica_placement=volume.super_block.replica_placement,
            ttl=volume.super_block.ttl,
            compaction_revision=(volume.super_block.compaction_revision
                                 + 1),
            extra=volume.super_block.extra)
    snapshot.sort(key=lambda nv: nv.offset)
    with open(dst_base + ".dat", "wb") as dat, \
            open(dst_base + ".idx", "wb") as idx:
        dat.write(sb.to_bytes())
        offset = len(sb.to_bytes())
        for nv in snapshot:
            n = volume.read_needle_at(pt.stored_to_offset(nv.offset),
                                      nv.size)
            if n.data and not n.is_compressed \
                    and volume.version != pt.VERSION1:
                head = n.data[:4096]
                trial = pcomp.compress(head, level=gzip_level)
                if len(trial) * 10 < len(head) * 9:
                    comp = pcomp.compress(n.data, level=gzip_level)
                    if len(comp) * 10 < len(n.data) * 9:
                        n.data = comp
                        n.set_flag(FLAG_IS_COMPRESSED)
            record = n.to_bytes(volume.version)
            if offset % pt.NEEDLE_PADDING_SIZE:
                pad = (-offset) % pt.NEEDLE_PADDING_SIZE
                dat.write(bytes(pad))
                offset += pad
            dat.write(record)
            idx.write(pidx.pack_entry(
                nv.key, pt.offset_to_stored(offset, volume.offset_size),
                n.size, offset_size=volume.offset_size))
            offset += len(record)
    ppipe.stream_encode(dst_base, coder, g)
    pstrip.write_sorted_ecx_from_idx(dst_base,
                                     offset_size=volume.offset_size)


@pytest.mark.parametrize("coder", sorted(CODERS))
def test_fused_matches_port_sequential_chain(tmp_path, coder):
    g = pgeo.Geometry(20, 4, 32 * 1024, 2 * 1024)
    build_volume(str(tmp_path), 7, 90, np.random.default_rng(2))
    v = PVolume(str(tmp_path), "", 7)
    try:
        stats = pfused.fused_vacuum_gzip_encode(
            v, str(tmp_path / "fused"), CODERS[coder](20, 4), g)
        sequential_reference(v, str(tmp_path / "seq"), CODERS[coder](20, 4),
                             g)
    finally:
        v.close()
    assert_identical(str(tmp_path / "seq"), str(tmp_path / "fused"), g)
    assert stats["gzipped_needles"] > 0


# ------------------------------------------------- gated incremental layout

def _finished_wm(total):
    wm = pfused._Watermark()
    wm.advance(total)
    wm.finish(total)
    return wm


@pytest.mark.parametrize("total", [
    0, 1, 4095, 4096 * 10 - 1, 4096 * 10, 4096 * 10 + 1,
    65536 * 10 - 4096, 65536 * 10, 65536 * 10 + 4096 * 3,
    65536 * 10 + 65536 * 10 - 4096 * 10 + 1,   # the ambiguity window
    65536 * 25 + 1234,
])
def test_gated_segments_match_stripe_segments(total):
    g = pgeo.Geometry(10, 4, 65536, 4096)
    got = list(pfused._gated_segments(g, 4096 * 4, _finished_wm(total)))
    assert got == list(pstrip.stripe_segments(total, g, 4096 * 4))
    rwm = rfused._Watermark()
    rwm.finish(total)
    assert got == list(rfused._gated_segments(
        rgeo.Geometry(10, 4, 65536, 4096), 4096 * 4, rwm))


def test_gated_segments_stream_before_total_is_known():
    g = pgeo.Geometry(3, 2, 8192, 1024)
    wm = pfused._Watermark()
    seg_iter = pfused._gated_segments(g, 1024, wm)
    got = []
    grabber = threading.Thread(
        target=lambda: got.extend([next(seg_iter), next(seg_iter)]))
    wm.advance(g.large_row_size + g.small_row_size)
    grabber.start()
    grabber.join(timeout=10)
    assert not grabber.is_alive(), \
        "gated segments did not stream ahead of the compactor"
    total = g.large_row_size + g.small_row_size
    wm.finish(total)
    assert got + list(seg_iter) == list(pstrip.stripe_segments(total, g,
                                                               1024))


@pytest.mark.parametrize("wait", ["cover", "decidable"])
def test_watermark_fail_propagates(wait):
    wm = pfused._Watermark()
    wm.fail(ValueError("boom"))
    with pytest.raises(RuntimeError) as info:
        if wait == "cover":
            wm.wait_cover(10)
        else:
            wm.wait_decidable(0, 10)
    assert isinstance(info.value.__cause__, ValueError)


# ------------------------------------------------- fail-closed fault paths

@pytest.mark.parametrize("point", ["ec.fused.read", "ec.fused.gzip",
                                   "ec.fused.commit"])
def test_fused_fault_fails_closed(tmp_path, point):
    g = pgeo.Geometry(3, 2, 8192, 1024)
    coder = pcoder.TorchCoder(3, 2, device="cpu")
    build_volume(str(tmp_path), 7, 30, np.random.default_rng(9))
    v = PVolume(str(tmp_path), "", 7)
    base = str(tmp_path / "fused")
    try:
        pfaults.set_fault(point, "drop")
        with pytest.raises((RuntimeError, OSError)):
            pfused.fused_vacuum_gzip_encode(v, base, coder, g)
        leftovers = [base + ext for ext in
                     [".dat", ".idx", ".ecx", ".ecm"]
                     + [pgeo.to_ext(i) for i in range(g.total_shards)]
                     if os.path.exists(base + ext)]
        assert not leftovers, f"partial dst files left: {leftovers}"
        assert pfaults.active()[0]["fired"] >= 1
        pfaults.clear()
        # the source is untouched: the same call now succeeds
        pfused.fused_vacuum_gzip_encode(v, base, coder, g)
        assert os.path.exists(base + ".ecm")
    finally:
        v.close()


# ------------------------------------------------------ the store's flow

def _store_source(d: str) -> None:
    st = rstore.Store([d], coder_name="numpy",
                      geometry_policy=rgeo.GeometryPolicy.parse("arc=3+2"))
    for vid in (7, 8):
        st.add_volume(vid, collection="arc")
        for i in range(12):
            data = ((b"store fused text " * 40) if i % 2
                    else np.random.default_rng((vid, i)).bytes(900))
            st.write_needle(vid, RNeedle(id=vid * 100 + i + 1, cookie=1,
                                         data=data))
        st.delete_needle(vid, RNeedle(id=vid * 100 + 3, cookie=1))
    st.close()


@pytest.mark.parametrize("coder", sorted(CODERS))
def test_store_fused_generate_promotes_atomically(tmp_path, coder):
    """The port's Store.ec_fused_generate and _many against the
    reference's on copies of one directory: the promoted shards, .ecx and
    .ecm equal; stale staging swept; the source files kept."""
    src = str(tmp_path / "src")
    _store_source(src)
    rdir, pdir = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, rdir)
    shutil.copytree(src, pdir)
    kw = ({"coder_name": "numpy"} if coder == "numpy"
          else {"coder_name": "torch", "device": "cpu"})
    rs = rstore.Store([rdir], coder_name="numpy",
                      geometry_policy=rgeo.GeometryPolicy.parse("arc=3+2"))
    ps = pstore.Store([pdir], geometry_policy=pgeo.GeometryPolicy.parse(
        "arc=3+2"), **kw)
    try:
        base = ps.find_volume(7).base_file_name()
        # stale staging junk from a crashed earlier pass must be swept
        for junk in (".fusing.dat", ".fusing.ec04"):
            with open(base + junk, "wb") as f:
                f.write(b"stale")
        assert ps.ec_fused_generate(7) == rs.ec_fused_generate(7) == \
            list(range(5))
        assert ps.ec_fused_generate_many([8]) == \
            rs.ec_fused_generate_many([8]) == {8: list(range(5))}
        assert not any(".fusing" in name for name in os.listdir(pdir))
        for vid in (7, 8):
            for ext in [pgeo.to_ext(i) for i in range(5)] + [".ecx"]:
                with open(os.path.join(rdir, f"arc_{vid}{ext}"), "rb") as a, \
                        open(os.path.join(pdir, f"arc_{vid}{ext}"),
                             "rb") as b:
                    assert a.read() == b.read(), (vid, ext)
            assert _marker(os.path.join(rdir, f"arc_{vid}")) == \
                _marker(os.path.join(pdir, f"arc_{vid}"))
            pbase = os.path.join(pdir, f"arc_{vid}")
            # the source volume files stay (verify, then retire)
            assert os.path.exists(pbase + ".dat")
            assert os.path.exists(pbase + ".idx")
            stamped = ppipe.read_stamped_digests(pbase)
            true = ppipe.shard_file_digest(pbase, range(5))
            assert [stamped[i] for i in range(5)] == true.tolist()
    finally:
        rs.close()
        ps.close()
    # the promoted set mounts and serves, decompressing the gzipped ones
    ps = pstore.Store([pdir], geometry_policy=pgeo.GeometryPolicy.parse(
        "arc=3+2"), **kw)
    try:
        ps.delete_volume(7)
        assert ps.ec_mount(7, "arc", list(range(5))) == list(range(5))
        for i in range(12):
            nid = 700 + i + 1
            if i == 2:
                with pytest.raises(KeyError):
                    ps.read_needle(7, nid)
                continue
            n = ps.read_needle(7, nid)
            data = pcomp.decompress(n.data) if n.is_compressed else n.data
            want = ((b"store fused text " * 40) if i % 2
                    else np.random.default_rng((7, i)).bytes(900))
            assert data == want
            assert n.is_compressed == bool(i % 2)
    finally:
        ps.close()


def test_store_fused_failure_lifts_the_seal(tmp_path):
    src = str(tmp_path / "src")
    _store_source(src)
    ps = pstore.Store([src], coder_name="numpy",
                      geometry_policy=pgeo.GeometryPolicy.parse("arc=3+2"))
    try:
        pfaults.set_fault("ec.fused.commit", "drop")
        with pytest.raises(OSError):
            ps.ec_fused_generate_many([7, 8])
        assert not ps.find_volume(7).read_only
        assert not any(name.endswith(".ecm") or ".fusing" in name
                       for name in os.listdir(src))
    finally:
        ps.close()


# ------------------------------------------------- the governor's gzip axis

def test_governor_widens_gzip_workers_when_gzip_bound(monkeypatch):
    monkeypatch.setenv("WEED_EC_GZIP_WORKERS", "1")
    monkeypatch.setenv("WEED_EC_GZIP_MAX", "8")
    gov = pgov.FeedGovernor()
    assert gov.plan(100 * 1024 * 1024, 10).gzip_workers == 1
    ctx = pobserve.TraceCtx(pobserve.new_id(), "", "ec", "")
    for name, secs in (("ec.read", 0.1), ("ec.dispatch", 0.1),
                       ("ec.kernel", 0.1), ("ec.write", 0.1),
                       ("ec.compact", 0.4), ("ec.gzip", 5.0)):
        for _ in range(8):
            pobserve.record_span(name, ctx, 0, int(secs / 8 * 1e6))
    op = gov.plan(100 * 1024 * 1024, 10)
    gov.finish_run(ctx.trace_id, op, 100 * 1024 * 1024, 10)
    assert gov.plan(100 * 1024 * 1024, 10).gzip_workers == 2


def test_fused_records_compact_and_gzip_spans(tmp_path):
    g = pgeo.Geometry(10, 4, 64 * 1024, 4 * 1024)
    build_volume(str(tmp_path), 7, 60, np.random.default_rng(4))
    v = PVolume(str(tmp_path), "", 7)
    try:
        ctx = pobserve.TraceCtx(pobserve.new_id(), "", "ec", "")
        pobserve.run_with(ctx, pfused.fused_vacuum_gzip_encode, v,
                          str(tmp_path / "fused"), pcoder.NumpyCoder(10, 4),
                          g)
    finally:
        v.close()
    totals = pobserve.stage_totals(ctx.trace_id, prefix="ec.")
    for name in ("ec.compact", "ec.gzip", "ec.read", "ec.kernel",
                 "ec.write"):
        assert totals.get(name, (0, 0))[0] > 0, name


def test_compression_matches_reference():
    rng = np.random.default_rng(6)
    for data in (b"", b"abc" * 1000, rng.bytes(5000)):
        for level in (1, 3, 9):
            assert pcomp.compress(data, level) == rcomp.compress(data, level)
        comp = pcomp.compress(data)
        assert pcomp.is_gzipped(comp) and not pcomp.is_gzipped(b"x")
        assert pcomp.decompress(comp) == rcomp.decompress(comp) == data
