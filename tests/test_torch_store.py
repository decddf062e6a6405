"""The port's Store EC lifecycle against the reference's.

One source directory is written once (needle records carry their append
time, so two writes differ), copied, and each copy opened by its own
package's Store through load_existing: the reference with the "numpy"
coder, the port once with "numpy" and once with the kernels' plain
versions (``coder_name="torch", device="cpu"``). Both then run the same
lifecycle under the policy ``arc=4+2,archive=20+4`` (block sizes shrunk
so that the volumes have large and small rows): ec_generate and
ec_generate_many, mount, shard reads, reads with every shard and with two
lost, ec_blob_delete, a reopen under a changed policy (the .ecm marker
wins), ec_rebuild, ec_to_volume. Every file the two produce must be equal
bytes. Also here: the geometry policy against the reference's, the
coder's refusal of "auto" without a card, the WEED_EC_MESH_DEVICES lift
onto a MeshCoder (on a stubbed card count), and the
absent-marker warning of check_layout_marker.
"""

import hashlib
import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch

from seaweedfs_torch.ec import coder as pcoder
from seaweedfs_torch.ec import ec_volume as pecv
from seaweedfs_torch.ec import geometry as pgeo
from seaweedfs_torch.ec import striping as pstrip
from seaweedfs_torch.storage import store as pstore
from seaweedfs_torch.storage.needle import Needle as PNeedle
from seaweedfs_torch.storage.volume import Volume as PVolume
from seaweedfs_tpu.ec import geometry as rgeo
from seaweedfs_tpu.storage import store as rstore

# the plain version runs at test sizes: one thread keeps this worker
# from crowding the others under pytest-xdist
torch.set_num_threads(1)

SPEC = "arc=4+2,archive=20+4"
LARGE, SMALL = 65536, 4096
SEED = 11
# vid -> (collection, bytes of needles written)
VOLUMES = {1: ("arc", 700_000), 2: ("archive", 1_500_000),
           3: ("arc", 300_000)}
CODERS = {"numpy": {"coder_name": "numpy"},
          "torch_cpu": {"coder_name": "torch", "device": "cpu"}}
LOST = (0, 3)


def _policy(geo, spec: str = SPEC):
    """The parsed policy with every geometry's blocks shrunk."""
    p = geo.GeometryPolicy.parse(spec)

    def shrink(g):
        return geo.Geometry(g.data_shards, g.parity_shards, LARGE, SMALL)

    return geo.GeometryPolicy(
        {n: shrink(g) for n, g in p.per_collection.items()},
        shrink(p.default))


def _payload(nid: int, size: int) -> bytes:
    return np.random.default_rng((SEED, nid)).bytes(size)


def _cookie(nid: int) -> int:
    return nid * 7919 & 0xFFFFFFFF


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    """One directory with three volumes written by the port's Store,
    about 8% of each one's needles deleted."""
    d = str(tmp_path_factory.mktemp("store_src"))
    rng = np.random.default_rng(SEED)
    st = pstore.Store([d], coder_name="numpy", geometry_policy=_policy(pgeo))
    sizes, deleted, nid = {}, set(), 0
    for vid, (collection, total) in VOLUMES.items():
        st.add_volume(vid, collection=collection)
        written = 0
        while written < total:
            nid += 1
            size = int(np.exp(rng.uniform(np.log(100), np.log(40_000))))
            st.write_needle(vid, PNeedle(cookie=_cookie(nid), id=nid,
                                         data=_payload(nid, size)))
            sizes[nid] = (vid, size)
            written += size
    for i in rng.choice(sorted(sizes), size=len(sizes) // 12, replace=False):
        i = int(i)
        st.delete_needle(sizes[i][0], PNeedle(cookie=_cookie(i), id=i))
        deleted.add(i)
    st.close()
    return {"dir": d, "sizes": sizes, "deleted": deleted}


def _bases(d: str) -> dict:
    return {vid: os.path.join(d, f"{c}_{vid}")
            for vid, (c, _) in VOLUMES.items()}


def _assert_same(rdir: str, pdir: str, vid: int, exts) -> None:
    collection = VOLUMES[vid][0]
    for ext in exts:
        r = os.path.join(rdir, f"{collection}_{vid}{ext}")
        p = os.path.join(pdir, f"{collection}_{vid}{ext}")
        assert os.path.exists(r) == os.path.exists(p), (vid, ext)
        if ext == ".ecm" and os.path.exists(r):
            with open(r) as fr, open(p) as fp:
                assert json.load(fr) == json.load(fp), (vid, ext)
        elif os.path.exists(r):
            assert _sha(r) == _sha(p), (vid, ext)


def _shard_exts(vid: int) -> list:
    g = _policy(pgeo).for_collection(VOLUMES[vid][0])
    return [pgeo.to_ext(i) for i in range(g.total_shards)]


def _read_all(stores, source, vids) -> None:
    """Every needle of the given volumes through each store: the live
    ones equal to what was written (and equal between the stores), the
    deleted ones refused."""
    for nid, (vid, size) in source["sizes"].items():
        if vid not in vids:
            continue
        for st in stores:
            if nid in source["deleted"]:
                with pytest.raises(KeyError):
                    st.read_needle(vid, nid)
            else:
                n = st.read_needle(vid, nid, cookie=_cookie(nid))
                assert n.data == _payload(nid, size), (vid, nid)


def _found(st) -> dict:
    return {"volumes": sorted(v for loc in st.locations for v in loc.volumes),
            "ec_volumes": {vid: ev.shard_ids() for loc in st.locations
                           for vid, ev in loc.ec_volumes.items()}}


@pytest.mark.parametrize("coder", sorted(CODERS))
def test_store_ec_lifecycle_matches_reference(source, tmp_path, coder):
    rdir, pdir = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(source["dir"], rdir)
    shutil.copytree(source["dir"], pdir)
    rs = rstore.Store([rdir], coder_name="numpy",
                      geometry_policy=_policy(rgeo))
    ps = pstore.Store([pdir], geometry_policy=_policy(pgeo),
                      **CODERS[coder])
    try:
        assert _found(ps) == _found(rs) == {"volumes": [1, 2, 3],
                                            "ec_volumes": {}}
        assert ps.geometry_for("archive").total_shards == 24
        # encode: one volume alone, then a window of two geometries
        assert ps.ec_generate(1) == rs.ec_generate(1) == list(range(6))
        assert ps.ec_generate_many([2, 3]) == rs.ec_generate_many([2, 3])
        for vid in VOLUMES:
            _assert_same(rdir, pdir, vid,
                         _shard_exts(vid) + [".ecx", ".ecm"])
        encoded = {vid: {ext: _sha(_bases(pdir)[vid] + ext)
                         for ext in _shard_exts(vid)} for vid in VOLUMES}
        # the shards take over from the volumes
        for st in (rs, ps):
            for vid, (collection, _) in VOLUMES.items():
                assert st.delete_volume(vid)
                n = len(_shard_exts(vid))
                assert st.ec_mount(vid, collection, list(range(n))) == \
                    list(range(n))
                assert st.ec_mount(vid, collection, [0]) == []
        for vid in VOLUMES:
            for sid in (0, len(_shard_exts(vid)) - 1):
                assert ps.ec_shard_read(vid, sid, 100, 5000) == \
                    rs.ec_shard_read(vid, sid, 100, 5000)
        _read_all((rs, ps), source, VOLUMES)
        # two shards lost from every volume: degraded reads
        for st in (rs, ps):
            for vid, (collection, _) in VOLUMES.items():
                st.ec_delete_shards(vid, collection, list(LOST))
        assert _found(ps) == _found(rs)
        calls = []
        for coder_ in {id(c): c for c in ps._coders.values()}.values():
            real = coder_._rec_apply

            def counting(present, missing, real=real):
                calls.append(missing)
                return real(present, missing)

            coder_._rec_apply = counting
        _read_all((rs, ps), source, VOLUMES)
        # the port's degraded reads went through its coder
        assert calls and all(len(m) == 1 and m[0] in LOST for m in calls)
        # deletes on the EC volumes journal to .ecj and tombstone .ecx
        live = sorted(nid for nid, (vid, _) in source["sizes"].items()
                      if vid == 2 and nid not in source["deleted"])
        gone = live[::7]
        for st in (rs, ps):
            for nid in gone:
                st.ec_blob_delete(2, nid)
        _assert_same(rdir, pdir, 2, [".ecj", ".ecx"])
        for nid in gone:
            with pytest.raises(KeyError):
                ps.read_needle(2, nid)
    finally:
        rs.close()
        ps.close()

    # reopened under another live policy: the marker wins
    rs = rstore.Store([rdir], coder_name="numpy",
                      geometry_policy=_policy(rgeo, "arc=10+4,archive=6+3"))
    ps = pstore.Store([pdir], geometry_policy=_policy(pgeo,
                                                      "arc=10+4,archive=6+3"),
                      **CODERS[coder])
    try:
        want = {vid: [i for i in range(len(_shard_exts(vid)))
                      if i not in LOST] for vid in VOLUMES}
        assert _found(ps) == _found(rs) == {"volumes": [],
                                            "ec_volumes": want}
        assert ps.find_ec_volume(2).g.total_shards == 24
        for vid, (collection, _) in VOLUMES.items():
            assert ps.ec_rebuild(vid, collection) == \
                rs.ec_rebuild(vid, collection) == list(LOST)
            _assert_same(rdir, pdir, vid,
                         _shard_exts(vid) + [".ecx", ".ecj", ".ecm"])
            for ext in _shard_exts(vid):
                assert _sha(_bases(pdir)[vid] + ext) == encoded[vid][ext]
        assert not os.path.exists(_bases(pdir)[2] + ".ecj")
        # decode back to volumes
        for st in (rs, ps):
            for vid, (collection, _) in VOLUMES.items():
                st.ec_to_volume(vid, collection)
        for vid in VOLUMES:
            _assert_same(rdir, pdir, vid, [".dat", ".idx"])
        assert _found(ps) == _found(rs) == {"volumes": [1, 2, 3],
                                            "ec_volumes": {}}
        deleted = source["deleted"] | set(gone)
        _read_all((rs, ps), {**source, "deleted": deleted}, VOLUMES)
    finally:
        rs.close()
        ps.close()


@pytest.mark.parametrize("coder", sorted(CODERS))
def test_store_reopen_finds_the_same_volumes(source, tmp_path, coder):
    rdir, pdir = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(source["dir"], rdir)
    shutil.copytree(source["dir"], pdir)
    rs = rstore.Store([rdir], coder_name="numpy",
                      geometry_policy=_policy(rgeo))
    ps = pstore.Store([pdir], geometry_policy=_policy(pgeo),
                      **CODERS[coder])
    for st in (rs, ps):
        st.ec_generate(3)
        st.delete_volume(3)
    rs.close()
    ps.close()
    rs = rstore.Store([rdir], coder_name="numpy",
                      geometry_policy=_policy(rgeo))
    ps = pstore.Store([pdir], geometry_policy=_policy(pgeo),
                      **CODERS[coder])
    try:
        assert _found(ps) == _found(rs) == {
            "volumes": [1, 2], "ec_volumes": {3: list(range(6))}}
        _read_all((rs, ps), source, VOLUMES)
    finally:
        rs.close()
        ps.close()


def test_store_auto_coder_raises_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: 'auto' is the kernel coder there")
    st = pstore.Store([str(tmp_path)])
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            st.coder()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pcoder.get_coder("auto", 10, 4, device="cpu")
    finally:
        st.close()


@pytest.fixture
def two_cards(monkeypatch):
    """A host with two cards whose mesh members run on the CPU: the card
    count torch reports, and the devices a card count maps to."""
    from seaweedfs_torch.parallel import mesh_coder
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(mesh_coder, "card_devices",
                        lambda n: [torch.device("cpu")] * n)
    return mesh_coder


@pytest.mark.parametrize("coder", ["auto", "torch"])
def test_store_lifts_card_coder_onto_mesh(tmp_path, monkeypatch, two_cards,
                                          coder):
    """WEED_EC_MESH_DEVICES lifts the card coders ("auto", and "torch" on
    a card) onto a MeshCoder over the cards asked for, as the reference's
    _maybe_mesh does; the lifted coder encodes the numpy coder's bytes."""
    monkeypatch.setenv("WEED_EC_MESH_DEVICES", "all")
    st = pstore.Store([str(tmp_path)], coder_name=coder)
    try:
        c = st.coder()
        assert isinstance(c, two_cards.MeshCoder)
        assert c.mesh_devices == 2 and c.formulation == "bitplane"
        assert st.coder() is c
        data = np.random.default_rng(5).integers(0, 256, (10, 1001),
                                                 dtype=np.uint8)
        assert np.array_equal(c.encode(data),
                              pcoder.NumpyCoder(10, 4).encode(data))
    finally:
        st.close()


def test_store_mesh_request_clamps_to_one_card(tmp_path, monkeypatch,
                                               two_cards):
    """A request for more cards than the host has clamps to those
    present, and a host with one card keeps the single-card coder."""
    monkeypatch.setenv("WEED_EC_MESH_DEVICES", "8")
    st = pstore.Store([str(tmp_path)], coder_name="auto")
    try:
        assert two_cards.mesh_device_count() == 2
        assert st.coder().mesh_devices == 2
    finally:
        st.close()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert two_cards.mesh_device_count() == 0
    # the card's single coder, standing in on the CPU
    single = pcoder.TorchCoder(10, 4, device="cpu")
    monkeypatch.setattr(pstore.ec_mod, "get_coder",
                        lambda name, k, m, device=None: single)
    st = pstore.Store([str(tmp_path / "one")], coder_name="auto")
    try:
        assert st.coder() is single
    finally:
        st.close()


def test_store_keeps_single_coder_when_the_mesh_fails(tmp_path, monkeypatch,
                                                       two_cards, caplog):
    """A mesh that fails to build keeps the single-card coder and logs an
    error, as the reference's _maybe_mesh does."""
    monkeypatch.setenv("WEED_EC_MESH_DEVICES", "2")

    def broken(*args, **kwargs):
        raise RuntimeError("peer copies unavailable")

    monkeypatch.setattr(two_cards, "MeshCoder", broken)
    single = pcoder.TorchCoder(10, 4, device="cpu")
    monkeypatch.setattr(pstore.ec_mod, "get_coder",
                        lambda name, k, m, device=None: single)
    st = pstore.Store([str(tmp_path)], coder_name="auto")
    try:
        with caplog.at_level(logging.ERROR, logger="store"):
            assert st.coder() is single
        assert "peer copies unavailable" in caplog.text
    finally:
        st.close()


def test_store_mesh_env_leaves_explicit_numpy_coder(tmp_path, monkeypatch):
    """As in the reference, only the device coders are mesh-lifted: an
    explicit "numpy" coder stays what was asked for."""
    monkeypatch.setenv("WEED_EC_MESH_DEVICES", "2")
    st = pstore.Store([str(tmp_path)], coder_name="numpy")
    try:
        assert isinstance(st.coder(), pcoder.NumpyCoder)
    finally:
        st.close()


@pytest.mark.parametrize("kind", ["compact", "leveldb"])
def test_store_runs_every_needle_map_kind(source, tmp_path, kind):
    """The source opened under another map kind by both packages' Stores:
    the same reads and heartbeat, the same shard set and .ecx from
    ec_generate and ec_fused_generate, and the kind kept by every volume
    (the disk kind's .sdx adopted at the reopen)."""
    rdir, pdir = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(source["dir"], rdir)
    shutil.copytree(source["dir"], pdir)
    stores = {}
    for d in (rdir, pdir):
        mod, geo = (rstore, rgeo) if d == rdir else (pstore, pgeo)
        stores[d] = mod.Store([d], coder_name="numpy",
                              geometry_policy=_policy(geo),
                              needle_map_kind=kind)
    rs, ps = stores[rdir], stores[pdir]
    try:
        assert {type(v.nm).__name__ for loc in ps.locations
                for v in loc.volumes.values()} == {
            "CompactNeedleMap" if kind == "compact" else "DiskNeedleMap"}
        _read_all((rs, ps), source, VOLUMES)

        def beat(st):
            return sorted((h["id"], h["file_count"], h["delete_count"],
                           h["deleted_bytes"], h["size"])
                          for h in st.heartbeat()["volumes"])

        assert beat(ps) == beat(rs)
        assert ps.ec_generate(1) == rs.ec_generate(1)
        assert ps.ec_fused_generate(2) == rs.ec_fused_generate(2)
        for vid in (1, 2):
            _assert_same(rdir, pdir, vid,
                         _shard_exts(vid) + [".ecx", ".ecm"])
    finally:
        rs.close()
        ps.close()
    ps = pstore.Store([pdir], coder_name="numpy",
                      geometry_policy=_policy(pgeo), needle_map_kind=kind)
    try:
        if kind == "leveldb":
            assert all(v.nm.adopted for loc in ps.locations
                       for v in loc.volumes.values())
        _read_all((ps,), source, (3,))
    finally:
        ps.close()


# ------------------------------------------------------------- geometry

SPECS = ["20+4", "12,4", " 6 + 3 ", "0+4", "10+0", "30+4", "ten+four", "10",
         "10+4+2", "31+1", "32+1"]
POLICIES = ["default=10+4,archive=20+4,media=12+4", "12+4", "*=6+3,a=4+2",
            "a=10+4,a=12+4", "a=33+4", "archive=broken", "", ",, a=4+2 ,",
            "default=10+4,archive=20+4"]


def _outcome(fn, spec):
    try:
        return ("ok", fn(spec))
    except ValueError:
        return ("ValueError", None)


@pytest.mark.parametrize("spec", SPECS)
def test_parse_geometry_matches_reference(spec):
    pk, pg = _outcome(pgeo.parse_geometry, spec)
    rk, rg = _outcome(rgeo.parse_geometry, spec)
    assert pk == rk
    if pk == "ok":
        assert (pg.data_shards, pg.parity_shards, pg.large_block_size,
                pg.small_block_size) == (rg.data_shards, rg.parity_shards,
                                         rg.large_block_size,
                                         rg.small_block_size)


@pytest.mark.parametrize("spec", POLICIES)
def test_policy_parse_matches_reference(spec):
    pk, pp = _outcome(pgeo.GeometryPolicy.parse, spec)
    rk, rp = _outcome(rgeo.GeometryPolicy.parse, spec)
    assert pk == rk
    if pk == "ok":
        assert pp.to_dict() == rp.to_dict()
        for name in ["", "archive", "media", "a", "unknown"]:
            assert pp.for_collection(name).total_shards == \
                rp.for_collection(name).total_shards
        # to_dict / from_dict round trip, and across the packages
        q = pgeo.GeometryPolicy.from_dict(pp.to_dict())
        assert q.default == pp.default
        assert q.per_collection == pp.per_collection
        assert pgeo.GeometryPolicy.from_dict(rp.to_dict()).to_dict() == \
            rp.to_dict()


def test_policy_from_env_and_default_spec(monkeypatch):
    monkeypatch.delenv("WEED_EC_GEOMETRY", raising=False)
    assert pgeo.GeometryPolicy.DEFAULT_SPEC == \
        rgeo.GeometryPolicy.DEFAULT_SPEC
    p = pgeo.GeometryPolicy.from_env()
    assert p.for_collection("archive").total_shards == 24
    assert p.for_collection("") == pgeo.DEFAULT
    monkeypatch.setenv("WEED_EC_GEOMETRY", "archive=99+4")
    with pytest.raises(ValueError):
        pgeo.GeometryPolicy.from_env()


def test_read_marker_geometry_matches_reference(tmp_path):
    base = str(tmp_path / "1")
    assert pstrip.read_marker_geometry(base) is None
    g = pgeo.Geometry(20, 4, LARGE, SMALL)
    pstrip.write_layout_marker(base, 1234, g)
    from seaweedfs_tpu.ec import striping as rstrip
    r = rstrip.read_marker_geometry(base)
    assert pstrip.read_marker_geometry(base) == g
    assert (r.data_shards, r.parity_shards, r.large_block_size,
            r.small_block_size) == (20, 4, LARGE, SMALL)
    with open(base + ".ecm", "w") as f:
        f.write("{not json")
    assert pstrip.read_marker_geometry(base) is None


# ------------------------------------------------- the absent-marker warning

def test_unmarked_whole_large_block_set_warns_and_serves(tmp_path, caplog):
    """An unmarked shard set whose size is a whole number of large blocks
    logs the reference's warning and still serves its needles."""
    d = str(tmp_path)
    g = pgeo.Geometry(4, 2, 16384, 1024)
    vol = PVolume(d, "", 1, create=True)
    sizes = {}
    for nid in range(1, 12):
        size = 5000 + 97 * nid
        vol.write_needle(PNeedle(cookie=_cookie(nid), id=nid,
                                 data=_payload(nid, size)))
        sizes[nid] = size
    vol.close()
    base = os.path.join(d, "1")
    dat_size = os.path.getsize(base + ".dat")
    assert g.large_row_size - g.small_row_size < dat_size <= g.large_row_size
    pstrip.write_ec_files(base, pcoder.NumpyCoder(4, 2), g)
    pstrip.write_sorted_ecx_from_idx(base)
    os.remove(base + ".ecm")
    ev = pecv.EcVolume(d, "", 1, g, coder=pcoder.NumpyCoder(4, 2))
    try:
        for sid in range(g.total_shards):
            ev.add_shard(sid)
        assert ev.shard_size() == g.large_block_size
        with caplog.at_level(logging.WARNING, logger="ec"):
            for nid, size in sizes.items():
                assert ev.read_needle(nid).data == _payload(nid, size)
    finally:
        ev.close()
    warnings = [r for r in caplog.records
                if r.name == "ec" and "unmarked EC shard set" in r.message]
    assert len(warnings) == 1


# ------------------------------------------------------ volume management

def test_volume_management_matches_reference(tmp_path):
    """add/has/mark_readonly/unmount/mount/delete on both packages' Stores,
    with the same outcomes and the same files left on disk."""
    outcomes = {}
    for name, mod in (("ref", rstore), ("port", pstore)):
        d = str(tmp_path / name)
        st = mod.Store([d], max_volume_counts=[2], coder_name="numpy")
        got = []
        try:
            st.add_volume(1, collection="c", replica_placement="010")
            st.add_volume(2)
            for call in (lambda: st.add_volume(1), lambda: st.add_volume(3),
                         lambda: st.mount_volume(2),
                         lambda: st.mount_volume(9)):
                try:
                    call()
                    got.append("ok")
                except (ValueError, RuntimeError, KeyError) as e:
                    got.append(type(e).__name__)
            got += [st.has_volume(1), st.has_volume(3),
                    st.mark_readonly(1), st.mark_readonly(3),
                    st.find_volume(1).read_only]
            got.append(st.unmount_volume(1))
            got.append(st.has_volume(1))
            got.append(st.mount_volume(1, collection="c").read_only)
            got.append(st.find_volume(1).super_block.replica_placement
                       .to_byte())
            got.append(st.delete_volume(2))
            got.append(st.delete_volume(2))
        finally:
            st.close()
        got.append(sorted(os.listdir(d)))
        outcomes[name] = got
    assert outcomes["port"] == outcomes["ref"]


@pytest.mark.parametrize("name", ["", "photos", "a_b", "../up", "a/b",
                                  "a\\b", "x\x00y", "..", "v.1"])
def test_safe_collection_matches_reference(name):
    assert pstore.safe_collection(name) == rstore.safe_collection(name)
    assert pstore._parse_volume_file_name(name + "_7") == \
        rstore._parse_volume_file_name(name + "_7")
