"""The port's multi-card coder (seaweedfs_torch/parallel) against the
reference's (seaweedfs_tpu/parallel).

The port's MeshCoder runs over eight members on the CPU ([cpu] * 8, the
kernels' plain versions), the reference's over the eight virtual CPU
devices that tests/conftest.py forces. The same numpy-seeded inputs go
through both and must give the same bytes: parity at widths that divide
over the mesh and widths that take the padded path, the all-gather
rebuild, both formulations at RS(10,4) and RS(20,4), stream_encode and
stream_rebuild shard files (sha256), the device sinks' digests, and the
batched kernel surface (sharded_encode / sharded_rebuild). Also here: the
WEED_EC_MESH_DEVICES rules on a stubbed card count, the governed run's
chips, a mixed-geometry ec_generate_many on a mesh-lifted store, an
explicit backend never meshed, the teardown of a mid-encode failure, and
mesh_status. The reference's HLO and weedlint cases have no counterpart.
"""

import hashlib
import os
import shutil

import numpy as np
import pytest
import torch

from seaweedfs_torch.ec import coder as pcoder
from seaweedfs_torch.ec import feed as pfeed
from seaweedfs_torch.ec import geometry as pgeo
from seaweedfs_torch.ec import governor as pgov
from seaweedfs_torch.ec import pipeline as ppipe
from seaweedfs_torch.ops import gf256 as pgf
from seaweedfs_torch.parallel import mesh_coder as pmesh
from seaweedfs_torch.parallel import sharded as psharded
from seaweedfs_torch.storage import store as pstore
from seaweedfs_torch.storage.needle import Needle as PNeedle
from seaweedfs_tpu import ec as rec
from seaweedfs_tpu.ec import governor as rgov
from seaweedfs_tpu.ec import pipeline as rpipe
from seaweedfs_tpu.parallel import MeshCoder as RMeshCoder
from seaweedfs_tpu.parallel import mesh_device_count as r_mesh_count
from seaweedfs_tpu.parallel import sharded as rsharded

# the plain version runs at test sizes: one thread keeps this worker
# from crowding the others under pytest-xdist
torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
PGEO = pgeo.Geometry(10, 4, large_block_size=10000, small_block_size=100)
RGEO = rec.Geometry(10, 4, large_block_size=10000, small_block_size=100)


@pytest.fixture(autouse=True)
def fresh_governors():
    pgov.reset()
    rgov.reset()
    yield
    pgov.reset()
    rgov.reset()


@pytest.fixture(scope="module")
def pmesh8():
    return pmesh.MeshCoder(10, 4, devices=CPU8)


@pytest.fixture(scope="module")
def rmesh8():
    return RMeshCoder(10, 4, n_devices=8)


@pytest.fixture
def stub_cards(monkeypatch):
    """Pretend the host has `n` cards whose members run on the CPU: the
    card count torch reports, and the devices a card count maps to."""

    def stub(n: int) -> None:
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
        monkeypatch.setattr(pmesh, "card_devices",
                            lambda k: [torch.device("cpu")] * k)

    return stub


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _write_dat(tmp_path, name: str, size: int, seed: int) -> str:
    rng = np.random.default_rng(seed)
    base = os.path.join(str(tmp_path), name)
    with open(base + ".dat", "wb") as f:
        f.write(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    return base


def _twin(base: str, name: str) -> str:
    """A copy of base's .dat under another name."""
    other = os.path.join(os.path.dirname(base), name)
    shutil.copyfile(base + ".dat", other + ".dat")
    return other


def _survivors(k: int, m: int, width: int, missing: tuple, seed: int):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (k, width), dtype=np.uint8)
    rows = list(data) + list(pgf.encode_parity(data, m))
    present = tuple(i for i in range(k + m) if i not in missing)[:k]
    return rows, present, np.stack([rows[i] for i in present])


# ------------------------------------------------------ kernel identity

@pytest.mark.parametrize("width", [8 * 512, 1000, 999, 7, 13])
def test_mesh_encode_matches_reference(pmesh8, rmesh8, width):
    """Every width, divisible by the mesh or not (the padded path), gives
    the reference mesh's parity, and the members' digests add up to the
    rows' byte sums."""
    rng = np.random.default_rng(width)
    data = rng.integers(0, 256, (10, width), dtype=np.uint8)
    handle = pmesh8.encode_async(data)
    got = pmesh8.materialize(handle)
    assert got.shape == (4, width)
    assert np.array_equal(got, rmesh8.encode(data))
    assert np.array_equal(got, pgf.encode_parity(data, 4))
    want = [int(r.sum(dtype=np.uint64)) & 0xFFFFFFFF
            for r in [*data, *got]]
    assert pmesh8.row_digests(handle).tolist() == want


def test_mesh_rebuild_all_gather_matches_reference(pmesh8, rmesh8):
    """Row-sharded survivors, all-gathered, reconstruct the reference's
    rows (an odd width: padded column slices too)."""
    missing = (0, 7, 10, 12)
    rows, present, survivors = _survivors(10, 4, 4999, missing, 21)
    got = pmesh8.materialize(
        pmesh8.rec_apply_async(present, missing)(survivors))
    want = rmesh8.materialize(
        rmesh8.rec_apply_async(present, missing)(survivors))
    assert np.array_equal(got, want)
    for row, victim in zip(got, missing):
        assert np.array_equal(row, rows[victim]), victim


@pytest.mark.parametrize("width", [8 * 512, 999, 7])
def test_mesh_xorsched_matches_reference(width):
    pm = pmesh.MeshCoder(10, 4, devices=CPU8, formulation="xorsched")
    rm = RMeshCoder(10, 4, n_devices=8, method="xorsched")
    rng = np.random.default_rng(width + 1)
    data = rng.integers(0, 256, (10, width), dtype=np.uint8)
    got = pm.encode(data)
    assert got.shape == (4, width)
    assert np.array_equal(got, rm.encode(data))


def test_mesh_xorsched_wide_geometry_and_rebuild():
    pm = pmesh.MeshCoder(20, 4, devices=CPU8, formulation="xorsched")
    rm = RMeshCoder(20, 4, n_devices=8, method="xorsched")
    missing = (2, 21)
    rows, present, survivors = _survivors(20, 4, 1013, missing, 99)
    data = np.stack(rows[:20])
    assert np.array_equal(pm.encode(data), rm.encode(data))
    got = pm.materialize(pm.rec_apply_async(present, missing)(survivors))
    want = rm.materialize(rm.rec_apply_async(present, missing)(survivors))
    assert np.array_equal(got, want)
    for row, victim in zip(got, missing):
        assert np.array_equal(row, rows[victim]), victim


def test_mesh_formulation_env_pin(monkeypatch):
    """The WEED_EC_FORMULATION pin reaches the mesh as it reaches the
    reference's; the port's mesh, like TorchCoder, has no retune hook
    (its formulation stays pinned). The reference's "pallas" is the
    port's bitplane; a formulation without a kernel raises."""
    monkeypatch.setenv("WEED_EC_FORMULATION", "xorsched")
    pm = pmesh.MeshCoder(10, 4, devices=CPU8)
    assert pm.formulation == "xorsched"
    assert all(mb.formulation == "xorsched" for mb in pm.members)
    assert RMeshCoder(10, 4, n_devices=8).method == "xorsched"
    assert not hasattr(pm, "retune_formulation")
    monkeypatch.delenv("WEED_EC_FORMULATION")
    assert pmesh.MeshCoder(10, 4, devices=CPU8,
                           formulation="pallas").formulation == "bitplane"
    with pytest.raises(ValueError):
        pmesh.MeshCoder(10, 4, devices=CPU8, formulation="lut")


def test_one_device_request_degenerates_to_torchcoder(monkeypatch,
                                                      stub_cards):
    """A request that resolves to one card gives the single-card
    TorchCoder; "all" and N clamp to the cards present, as the
    reference's rules do over its eight devices."""
    real = pcoder.TorchCoder
    monkeypatch.setattr(pmesh, "TorchCoder",
                        lambda k, m, device="cpu", formulation=None:
                        real(k, m, device="cpu", formulation=formulation))
    stub_cards(8)
    monkeypatch.setenv("WEED_EC_MESH_DEVICES", "1")
    c = pmesh.coder(10, 4)
    assert type(c) is pcoder.TorchCoder
    for raw in ("all", "16"):
        monkeypatch.setenv("WEED_EC_MESH_DEVICES", raw)
        c = pmesh.coder(10, 4)
        assert isinstance(c, pmesh.MeshCoder) and c.mesh_devices == 8
        assert pmesh.mesh_device_count() == r_mesh_count() == 8
    monkeypatch.setenv("WEED_EC_MESH_DEVICES", "0")
    assert pmesh.mesh_device_count() == r_mesh_count() == 0
    stub_cards(1)
    monkeypatch.setenv("WEED_EC_MESH_DEVICES", "all")
    assert pmesh.mesh_device_count() == 0
    assert type(pmesh.coder(10, 4)) is pcoder.TorchCoder


def test_get_coder_mesh_raises_without_a_card():
    """No CPU fallback: "mesh" raises where there is no card, as "auto"
    does."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcoder.get_coder("mesh", 10, 4)
    with pytest.raises(ValueError):
        pcoder.get_coder("mesh", 10, 4, device="cpu")


# --------------------------------------------------- pipeline identity

def test_stream_encode_mesh_matches_reference_odd_batch(tmp_path, pmesh8,
                                                        rmesh8):
    """stream_encode through the mesh at an odd batch width (999 does not
    divide over 8: every batch takes the padded path) writes the
    reference mesh's shard files and marker, and the numpy writer's
    shards."""
    base = _write_dat(tmp_path, "p_1", 61_007, seed=3)
    ref = _twin(base, "r_1")
    numpy_ref = _twin(base, "n_1")
    ppipe.stream_encode(base, pmesh8, PGEO, batch_size=999)
    rpipe.stream_encode(ref, rmesh8, RGEO, batch_size=999)
    rec.write_ec_files(numpy_ref, rec.get_coder("numpy", 10, 4), RGEO,
                       buffer_size=100)
    for i in range(14):
        ext = pgeo.to_ext(i)
        assert _sha(base + ext) == _sha(ref + ext) == \
            _sha(numpy_ref + ext), i
    with open(base + ".ecm", "rb") as f, open(ref + ".ecm", "rb") as g:
        assert f.read() == g.read()


def test_stream_rebuild_mesh_matches_reference(tmp_path, pmesh8, rmesh8):
    base = _write_dat(tmp_path, "p_1", 47_501, seed=5)
    ref = _twin(base, "r_1")
    ppipe.stream_encode(base, pmesh8, PGEO, batch_size=1000)
    rpipe.stream_encode(ref, rmesh8, RGEO, batch_size=1000)
    golden = {i: _sha(ref + pgeo.to_ext(i)) for i in range(14)}
    victims = [0, 5, 11, 13]
    for v in victims:
        os.remove(base + pgeo.to_ext(v))
        os.remove(ref + pgeo.to_ext(v))
    assert sorted(ppipe.stream_rebuild(base, pmesh8, PGEO,
                                       batch_size=512)) == victims
    assert sorted(rpipe.stream_rebuild(ref, rmesh8, RGEO,
                                       batch_size=512)) == victims
    for i in range(14):
        ext = pgeo.to_ext(i)
        assert _sha(base + ext) == _sha(ref + ext) == golden[i], i


def test_device_sink_digests_match_shards_on_mesh(tmp_path, pmesh8,
                                                  rmesh8):
    """The windowed digest sinks with column-sliced staging compute the
    parity and the rebuilt rows the fan-out path writes, and the
    reference mesh's digests."""
    base = _write_dat(tmp_path, "1", 30_001, seed=9)
    ppipe.stream_encode(base, pmesh8, PGEO, batch_size=1000)
    dig = ppipe.stream_encode_device_sink(base, pmesh8, PGEO,
                                          batch_size=1000)
    assert np.array_equal(np.asarray(dig),
                          ppipe.parity_file_digest(base, PGEO))
    assert np.array_equal(np.asarray(dig), np.asarray(
        rpipe.stream_encode_device_sink(base, rmesh8, RGEO,
                                        batch_size=1000)))
    victims = (0, 3, 7, 12)
    got = ppipe.stream_rebuild_device_sink(base, pmesh8, victims, PGEO,
                                           batch_size=1000)
    assert np.array_equal(np.asarray(got),
                          ppipe.shard_file_digest(base, victims))


def test_governed_mesh_run_exports_chips(tmp_path, pmesh8, rmesh8):
    """A governed mesh encode (no batch size) plans with the coder's
    member count and exports feed_mesh_devices, as the reference's; each
    chip's staging counters grow."""
    reg = pmesh.metrics_mod.shared("ec")
    before = [reg.value("feed_chip_staged_bytes", {"chip": str(i)})
              for i in range(8)]
    base = _write_dat(tmp_path, "1", 20_001, seed=13)
    ref = _twin(base, "r_1")
    ppipe.stream_encode(base, pmesh8, PGEO)
    rpipe.stream_encode(ref, rmesh8, RGEO)
    assert pgov.get().metrics.value("feed_mesh_devices") == 8
    assert rgov.get().metrics.value("feed_mesh_devices") == 8
    after = [reg.value("feed_chip_staged_bytes", {"chip": str(i)})
             for i in range(8)]
    assert all(a > b for a, b in zip(after, before))
    for i in range(14):
        ext = pgeo.to_ext(i)
        assert _sha(base + ext) == _sha(ref + ext), i


# ------------------------------------------- mixed-geometry mesh window

def test_generate_many_mixed_geometries_on_mesh(tmp_path, monkeypatch,
                                                stub_cards):
    """RS(10,4) and RS(20,4) volumes through one ec_generate_many window
    on a store that WEED_EC_MESH_DEVICES lifts onto the mesh: each
    geometry streams through its own MeshCoder and every shard equals the
    reference's numpy writer's."""
    stub_cards(8)
    monkeypatch.setenv("WEED_EC_MESH_DEVICES", "8")
    vol_dir = tmp_path / "vols"
    vol_dir.mkdir()
    spec = "default=10+4,wide=20+4"
    store = pstore.Store([str(vol_dir)], coder_name="auto",
                         geometry_policy=pgeo.GeometryPolicy.parse(spec))
    try:
        for col in ("", "wide"):
            c = store.coder(store.geometry_for(col))
            assert isinstance(c, pmesh.MeshCoder) and c.mesh_devices == 8
        for vid, collection in ((3, ""), (4, "wide")):
            store.add_volume(vid, collection=collection)
            for i in range(3):
                store.write_needle(vid, PNeedle(
                    id=i + 1, cookie=1, data=bytes([vid, i]) * 1500))
        refs = {}
        for vid in (3, 4):
            v = store.find_volume(vid)
            v.sync()
            refs[vid] = str(tmp_path / f"ref_{vid}")
            shutil.copyfile(v.base_file_name() + ".dat",
                            refs[vid] + ".dat")
        out = store.ec_generate_many([3, 4])
        assert out[3] == list(range(14))
        assert out[4] == list(range(24))
        rpolicy = rec.GeometryPolicy.parse(spec)
        for vid, collection in ((3, ""), (4, "wide")):
            g = rpolicy.for_collection(collection)
            rec.write_ec_files(refs[vid], rec.get_coder(
                "numpy", g.data_shards, g.parity_shards), g)
            base = store.find_volume(vid).base_file_name()
            for sid in range(g.total_shards):
                ext = pgeo.to_ext(sid)
                assert _sha(base + ext) == _sha(refs[vid] + ext), (vid, sid)
    finally:
        store.close()


@pytest.mark.parametrize("kwargs", [{"coder_name": "numpy"},
                                    {"coder_name": "torch",
                                     "device": "cpu"}],
                         ids=["numpy", "torch_cpu"])
def test_store_explicit_backend_never_meshed(tmp_path, monkeypatch,
                                             stub_cards, kwargs):
    """An explicit host coder stays what was asked for with the mesh env
    set, as the reference keeps an explicit numpy coder."""
    stub_cards(8)
    monkeypatch.setenv("WEED_EC_MESH_DEVICES", "8")
    store = pstore.Store([str(tmp_path)], **kwargs)
    try:
        c = store.coder()
        assert not isinstance(c, pmesh.MeshCoder)
        assert type(c).__name__ == ("NumpyCoder"
                                    if kwargs["coder_name"] == "numpy"
                                    else "TorchCoder")
    finally:
        store.close()


# ------------------------------------------------- mid-encode teardown

def test_mid_encode_failure_recycles_staging_and_unblocks_pool(
        tmp_path, monkeypatch):
    """A mesh dispatch that dies mid-encode propagates, joins every
    reader-pool thread, and leaves no staging buffer lent out."""
    monkeypatch.setenv("WEED_EC_MMAP", "0")  # pooled staging
    base = _write_dat(tmp_path, "1", 50_001, seed=17)
    feeds: list = []
    real_open = pfeed.open_feed

    def capture_open(*args, **kwargs):
        kwargs.setdefault("readers", 4)
        src = real_open(*args, **kwargs)
        feeds.append(src)
        return src

    monkeypatch.setattr(ppipe.feed_mod, "open_feed", capture_open)

    class Dying(pmesh.MeshCoder):
        def __init__(self):
            super().__init__(10, 4, devices=CPU8)
            self.calls = 0

        def encode_async(self, data):
            self.calls += 1
            if self.calls >= 2:
                raise RuntimeError("injected mid-encode death")
            return super().encode_async(data)

    with pytest.raises(RuntimeError, match="injected"):
        ppipe.stream_encode(base, Dying(), PGEO, batch_size=999)
    assert len(feeds) == 1
    src = feeds[0]
    with src._lent_lock:
        assert not src._lent
    assert src._rpool is None
    assert src.pool._closed.is_set()
    assert not os.path.exists(base + ".ecm")


# -------------------------------------------------------- status faces

def test_mesh_status_reports_chips_after_staging(monkeypatch):
    monkeypatch.setenv("WEED_EC_MESH_DEVICES", "8")
    mc = pmesh.MeshCoder(10, 4, devices=CPU8)
    mc.stage_async(np.zeros((10, 800), dtype=np.uint8))
    st = pmesh.mesh_status()
    assert st["requested"] == "8"
    assert st["mesh_devices"] == 8
    assert len(st["chips"]) == 8
    assert all("staged_bytes" in c and "stage_seconds" in c
               for c in st["chips"].values())
    assert st["devices"] == []  # no card on this host
    monkeypatch.delenv("WEED_EC_MESH_DEVICES")
    pmesh.metrics_mod.shared("ec").gauge("feed_mesh_devices", 0)
    assert pmesh.mesh_status()["devices"] is None


# ---------------------------------------------- the batched kernel surface

@pytest.fixture(scope="module")
def pmesh_sharded():
    return psharded.make_mesh(devices=CPU8)


@pytest.fixture(scope="module")
def rmesh_sharded():
    return rsharded.make_mesh(8)


@pytest.mark.parametrize("formulation,use_pallas",
                         [("bitplane", False), ("xorsched", True)])
def test_sharded_encode_matches_reference(pmesh_sharded, rmesh_sharded,
                                          formulation, use_pallas):
    """[B, k, n] batches over the mesh, against the reference's (its XLA
    bit-plane step, and its Pallas kernel in interpret mode)."""
    rng = np.random.default_rng(30 if not use_pallas else 31)
    data = rng.integers(0, 256, (16, 10, 512), dtype=np.uint8)
    got = psharded.sharded_encode(pmesh_sharded, data,
                                  formulation=formulation)
    want = np.asarray(rsharded.sharded_encode(rmesh_sharded, data,
                                              use_pallas=use_pallas))
    assert got.shape == (16, 4, 512)
    assert np.array_equal(got, want)
    for b in range(16):
        assert np.array_equal(got[b], pgf.encode_parity(data[b], 4)), b


def test_sharded_rebuild_all_gather_matches_reference(pmesh_sharded,
                                                      rmesh_sharded):
    k, m = 10, 4
    rng = np.random.default_rng(32)
    data = rng.integers(0, 256, (k, 2048), dtype=np.uint8)
    shards = list(data) + list(pgf.encode_parity(data, m))
    holed = [None if i in (2, 7, 10, 13) else s
             for i, s in enumerate(shards)]
    got = psharded.sharded_rebuild(pmesh_sharded, holed, k, m)
    want = rsharded.sharded_rebuild(rmesh_sharded, holed, k, m,
                                    use_pallas=False)
    for i in range(k + m):
        assert np.array_equal(got[i], np.asarray(want[i])), i
        assert np.array_equal(got[i], shards[i]), i


def test_mesh_status_over_http_and_shell(monkeypatch):
    """GET /admin/ec/mesh_status on the port's volume server and the
    shell's ec.mesh.status answer with the requested mesh, its size and
    the cards (none on this host), one entry per node."""
    from seaweedfs_torch.client import Client, _get_json
    from seaweedfs_torch.server.local_cluster import LocalCluster
    from seaweedfs_torch.shell import commands as pcommands

    monkeypatch.setenv("WEED_EC_MESH_DEVICES", "all")
    pmesh.MeshCoder(10, 4, devices=CPU8)   # a live mesh in this process
    cl = LocalCluster(2, coder_name="numpy", geometry=PGEO,
                      volume_size_limit_mb=1, pulse=0.15)
    try:
        cl.wait_for_nodes(2)
        st = _get_json(f"http://{cl.url(0)}/admin/ec/mesh_status")
        assert st["requested"] == "all"
        assert st["mesh_devices"] == 8
        assert st["devices"] == []
        pcommands._register_all()
        env = pcommands.CommandEnv(Client(cl.master_url), PGEO)
        out = pcommands.run_command(env, ["ec.mesh.status"])
        assert sorted(out["nodes"]) == sorted([cl.url(0), cl.url(1)])
        for node in out["nodes"].values():
            assert {"requested", "mesh_devices", "devices"} <= set(node)
        one = pcommands.run_command(env, ["ec.mesh.status", "-node",
                                          cl.url(1)])
        assert list(one["nodes"]) == [cl.url(1)]
    finally:
        cl.shutdown()
