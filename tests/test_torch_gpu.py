"""Card-only tests of the port: the CUDA kernels, the CUDA coder under
both formulations, the page-locked O_DIRECT staging, a governed encode
and the C CRC-32C, each against the port's plain versions or pinned
runs.

Every test is marked ``gpu`` and decides inside its body whether a card
(or the CUDA toolkit) is present, skipping here. This file imports
neither jax nor the JAX package, so it also runs on a machine that has
only PyTorch:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

(tests/conftest.py imports jax; the plain versions themselves are held
against the JAX reference by the other tests/test_torch_*.py files.)
"""

import os

import numpy as np
import pytest
import torch

from seaweedfs_torch.ec import coder as pcoder
from seaweedfs_torch.ops import gf256, rs_cuda, rs_torch
from seaweedfs_torch.ops import xor_schedule
from seaweedfs_torch.storage import crc

GEOMETRIES = [(10, 4), (12, 4), (20, 4), (6, 3)]
VICTIMS = (0, 3, 7, 12)


def _need_card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only there")


def _padded_rec(k: int, m: int) -> np.ndarray:
    victims = tuple(v for v in VICTIMS if v < k + m)[:m]
    present = tuple(i for i in range(k + m) if i not in victims)[:k]
    rec = gf256.reconstruction_matrix(k, m, present, victims)
    return np.vstack([rec, np.zeros((m - rec.shape[0], k), np.uint8)])


@pytest.mark.gpu
@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_kernel_matches_plain(k, m):
    _need_card()
    rng = np.random.default_rng(50 + k)
    for n in [1, 100, 1023, 1025, 1 << 20, (1 << 20) + 5]:
        x = torch.from_numpy(
            rng.integers(0, 256, (k, n), dtype=np.uint8)).cuda()
        for mat in [gf256.parity_matrix(k, m), _padded_rec(k, m),
                    _padded_rec(k, m)[:1]]:
            w = rs_torch.load_matrix(mat, "cuda")
            got = rs_cuda.gf_apply(w, x)
            torch.cuda.synchronize()
            assert torch.equal(got, rs_torch.gf_apply(w, x)), (n, mat.shape)


@pytest.mark.gpu
def test_kernel_takes_offset_views_and_counts():
    _need_card()
    rng = np.random.default_rng(60)
    x = torch.from_numpy(rng.integers(0, 256, (10, 4099), dtype=np.uint8))
    w = rs_torch.load_matrix(gf256.parity_matrix(10, 4), "cuda")
    before = rs_cuda.gf_apply.launches
    # row starts not 16-byte aligned: the wrapper makes them contiguous
    got = rs_cuda.gf_apply(w, x.cuda()[:, 3:]).cpu()
    assert torch.equal(got, rs_torch.gf_apply(w.cpu(), x[:, 3:]))
    assert rs_cuda.gf_apply.launches == before + 1
    assert rs_cuda.gf_apply(w, x.cuda()[:, :0]).shape == (4, 0)
    assert rs_cuda.gf_apply.launches == before + 1
    with pytest.raises(ValueError):
        rs_cuda.gf_apply(w, x[:6].cuda())


@pytest.mark.gpu
@pytest.mark.parametrize("k,m", [(10, 4), (20, 4)])
def test_cuda_coder_matches_numpy_coder(k, m):
    _need_card()
    coder = pcoder.get_coder("auto", k, m)
    ref = pcoder.NumpyCoder(k, m)
    assert coder.pinned_host
    rng = np.random.default_rng(k)
    data = rng.integers(0, 256, (k, 100_003), dtype=np.uint8)
    parity = coder.encode(data)
    assert np.array_equal(parity, ref.encode(data))
    shards = [data[i] for i in range(k)] + [parity[j] for j in range(m)]
    assert coder.verify(shards)
    for drop in [(0,), (0, 3, 7, 12), (k, k + 1)]:
        holed = [None if i in drop else s for i, s in enumerate(shards)]
        got = coder.reconstruct(holed)
        for i in range(k + m):
            assert np.array_equal(got[i], shards[i]), (drop, i)
        present = tuple(i for i in range(k + m) if i not in drop)[:k]
        survivors = np.stack([shards[i] for i in present])
        out = coder.materialize(
            coder.rec_apply_async(present, drop)(survivors))
        for row, v in enumerate(drop):
            assert np.array_equal(out[row], shards[v])


@pytest.mark.gpu
@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_xorsched_kernel_matches_plain_and_gf_apply(k, m):
    _need_card()
    rng = np.random.default_rng(70 + k)
    for n in [1, 31, 33, 1023, 1025, 1 << 20, (1 << 20) + 5]:
        x = torch.from_numpy(
            rng.integers(0, 256, (k, n), dtype=np.uint8)).cuda()
        for mat in [gf256.parity_matrix(k, m), _padded_rec(k, m),
                    _padded_rec(k, m)[:1]]:
            prog = xor_schedule.lower_schedule_grouped(
                xor_schedule.schedule_for_matrix(mat)).to("cuda")
            got = rs_cuda.gf_apply_xorsched(prog, x)
            torch.cuda.synchronize()
            assert torch.equal(got, rs_torch.gf_apply_xorsched(
                prog.sched, x)), (n, mat.shape)
            w = rs_torch.load_matrix(mat, "cuda")
            assert torch.equal(got, rs_cuda.gf_apply(w, x)), (n, mat.shape)


@pytest.mark.gpu
def test_xorsched_kernel_takes_offset_views_and_counts():
    _need_card()
    rng = np.random.default_rng(61)
    x = torch.from_numpy(rng.integers(0, 256, (10, 4099), dtype=np.uint8))
    pm = gf256.parity_matrix(10, 4)
    sched = xor_schedule.schedule_for_matrix(pm)
    prog = xor_schedule.lower_schedule_grouped(sched)
    progd = prog.to("cuda")
    before = rs_cuda.gf_apply_xorsched.launches
    got = rs_cuda.gf_apply_xorsched(progd, x.cuda()[:, 3:]).cpu()
    assert torch.equal(got, rs_torch.gf_apply_xorsched(prog.sched,
                                                       x[:, 3:]))
    assert rs_cuda.gf_apply_xorsched.launches == before + 1
    assert rs_cuda.gf_apply_xorsched(progd, x.cuda()[:, :0]).shape == (4, 0)
    assert rs_cuda.gf_apply_xorsched.launches == before + 1
    with pytest.raises(ValueError):
        rs_cuda.gf_apply_xorsched(progd, x[:6].cuda())
    with pytest.raises(ValueError):
        rs_cuda.gf_apply_xorsched(prog, x.cuda())  # program on the CPU
    with pytest.raises(ValueError):  # one op at a time: not the kernel's
        rs_cuda.gf_apply_xorsched(
            xor_schedule.lower_schedule(sched).to("cuda"), x.cuda())


@pytest.mark.gpu
@pytest.mark.parametrize("k,m", [(10, 4), (20, 4)])
def test_xorsched_coder_matches_numpy_coder(k, m):
    _need_card()
    coder = pcoder.TorchCoder(k, m, formulation="xorsched")
    ref = pcoder.NumpyCoder(k, m)
    rng = np.random.default_rng(k + 1)
    data = rng.integers(0, 256, (k, 100_003), dtype=np.uint8)
    before = rs_cuda.gf_apply_xorsched.launches
    parity = coder.encode(data)
    assert rs_cuda.gf_apply_xorsched.launches == before + 1
    assert np.array_equal(parity, ref.encode(data))
    shards = [data[i] for i in range(k)] + [parity[j] for j in range(m)]
    for drop in [(0,), (0, 3, 7, 12), (k, k + 1)]:
        holed = [None if i in drop else s for i, s in enumerate(shards)]
        got = coder.reconstruct(holed)
        for i in range(k + m):
            assert np.array_equal(got[i], shards[i]), (drop, i)
        present = tuple(i for i in range(k + m) if i not in drop)[:k]
        survivors = np.stack([shards[i] for i in present])
        out = coder.materialize(
            coder.rec_apply_async(present, drop)(survivors))
        for row, v in enumerate(drop):
            assert np.array_equal(out[row], shards[v])
        staged = [coder.stage_async(survivors)]
        digest = coder.materialize(
            coder.rec_digest_window_async(present, drop, staged))
        assert digest.tolist() == [
            int(shards[v].astype(np.uint64).sum()) & 0xFFFFFFFF
            for v in drop]


@pytest.mark.gpu
def test_native_crc_matches_python_twin():
    if crc._native() is None:
        pytest.skip("no CUDA toolkit: the C CRC-32C is built with the "
                    "kernels")
    lib = crc._native()
    for n in [0, 1, 7, 8, 9, 4096, 1 << 20]:
        data = os.urandom(n)
        assert lib.sw_crc32c_update(0, data, n) == \
            crc.crc32c_update_py(0, data)
        assert lib.sw_crc32c_update(0x12345678, data, n) == \
            crc.crc32c_update_py(0x12345678, data)


@pytest.mark.gpu
@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_mxu_kernel_matches_plain_and_gf_apply(k, m):
    _need_card()
    rng = np.random.default_rng(80 + k)
    mats = [gf256.parity_matrix(k, m), _padded_rec(k, m),
            _padded_rec(k, m)[:1],
            rng.integers(0, 256, (32, 32)).astype(np.uint8)]
    for n in [1, 31, 129, 1023, 1025, 1 << 20, (1 << 20) + 5]:
        for mat in mats:
            x = torch.from_numpy(rng.integers(
                0, 256, (mat.shape[1], n + 3), dtype=np.uint8)).cuda()
            w = rs_torch.load_matrix(mat, "cuda")
            # contiguous rows starting 3 bytes past an aligned address
            flat = torch.from_numpy(rng.integers(
                0, 256, mat.shape[1] * n + 3, dtype=np.uint8)).cuda()
            skewed = flat[3:].view(mat.shape[1], n)
            assert skewed.is_contiguous() and skewed.data_ptr() % 4
            for xv in (x[:, :n].contiguous(), x[:, 3:], skewed):
                before = rs_cuda.gf_apply_mxu.launches
                got = rs_cuda.gf_apply(w, xv, repack="mxu")
                torch.cuda.synchronize()
                assert rs_cuda.gf_apply_mxu.launches == before + 1
                assert torch.equal(got, rs_torch.gf_apply_mxu(
                    w, xv.contiguous())), (n, mat.shape)
                assert torch.equal(got, rs_cuda.gf_apply(w, xv)), (
                    n, mat.shape)
                assert torch.equal(
                    rs_cuda.gf_apply_mxu(w, xv, instr="mma"), got), (
                    n, mat.shape)


@pytest.mark.gpu
def test_mxu_entry_checks_and_counts():
    _need_card()
    w = rs_torch.load_matrix(gf256.parity_matrix(10, 4), "cuda")
    x = torch.zeros((10, 64), dtype=torch.uint8, device="cuda")
    before = (rs_cuda.gf_apply.launches, rs_cuda.gf_apply_mxu.launches)
    assert rs_cuda.gf_apply(w, x[:, :0], repack="mxu").shape == (4, 0)
    assert (rs_cuda.gf_apply.launches,
            rs_cuda.gf_apply_mxu.launches) == before
    with pytest.raises(ValueError):
        rs_cuda.gf_apply(w, x, repack="vmx")
    with pytest.raises(ValueError):
        rs_cuda.gf_apply(w, x[:6], repack="mxu")
    with pytest.raises(TypeError):
        rs_cuda.gf_apply(w.to(torch.int32), x, repack="mxu")


@pytest.mark.gpu
def test_pinned_odirect_staging_is_page_aligned():
    _need_card()
    from seaweedfs_torch.ec import feed
    pool = feed.BufferPool(10, 8192, count=3, aligned=True, pinned=True)
    for _ in range(3):
        buf = pool.acquire()
        assert buf.ctypes.data % feed._ALIGN == 0
        assert buf.shape == (10, 8192)
        assert torch.from_numpy(buf).is_pinned()


@pytest.mark.gpu
def test_governed_auto_encode_equals_pinned_run(tmp_path):
    _need_card()
    from seaweedfs_torch import observe
    from seaweedfs_torch.ec import geometry, governor, pipeline
    from seaweedfs_torch.observe import wideevents
    governor.reset()
    observe.reset()
    wideevents.reset()
    g = geometry.Geometry(large_block_size=1 << 20, small_block_size=65536)
    shas = {}
    for run in ("pinned", "governed"):
        d = tmp_path / run
        d.mkdir()
        base = str(d / "1")
        with open(base + ".dat", "wb") as f:
            f.write(np.random.default_rng(91).bytes(23 << 20))
        coder = pcoder.get_coder("auto", 10, 4)
        before = rs_cuda.gf_apply.launches
        if run == "pinned":
            pipeline.stream_encode(base, coder, g, batch_size=8 << 20,
                                   depth=4)
        else:
            pipeline.stream_encode(base, coder, g)
            assert governor.get().runs == 1
            trace = wideevents.events(svc="ec")[-1]["trace"]
            totals = observe.stage_totals(trace, prefix="ec.")
            assert {"ec.read", "ec.dispatch", "ec.kernel", "ec.digest",
                    "ec.write"} <= set(totals)
        assert rs_cuda.gf_apply.launches > before
        shas[run] = [open(base + geometry.to_ext(i), "rb").read()
                     for i in range(14)]
    assert shas["pinned"] == shas["governed"]


@pytest.mark.gpu
@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_kernel_digests_match_plain(k, m):
    """Both redesigned kernels' digest epilogue ([C + R] sums, added to
    the buffer), with and without output stores, against the plain
    digests; the grouped XOR program also against gf_apply's output."""
    _need_card()
    rng = np.random.default_rng(90 + k)
    for n in [1, 31, 1023, 1025, 1 << 20, (1 << 20) + 5]:
        x = torch.from_numpy(
            rng.integers(0, 256, (k, n), dtype=np.uint8)).cuda()
        for mat in [gf256.parity_matrix(k, m), _padded_rec(k, m),
                    _padded_rec(k, m)[:1]]:
            w = rs_torch.load_matrix(mat, "cuda")
            want, want_d = rs_torch.gf_apply_digest(w, x)
            prog = xor_schedule.lower_schedule_grouped(
                xor_schedule.schedule_for_matrix(mat)).to("cuda")
            for kernel, operand in [(rs_cuda.gf_apply, w),
                                    (rs_cuda.gf_apply_xorsched, prog)]:
                d = rs_cuda.new_digest(k + mat.shape[0], "cuda")
                got = kernel(operand, x, digest=d)
                assert kernel(operand, x, digest=d, out=False) is None
                torch.cuda.synchronize()
                assert torch.equal(got, want), (kernel.__name__, n)
                assert torch.equal(rs_cuda.digest_values(d),
                                   (2 * want_d) & 0xFFFFFFFF), (
                    kernel.__name__, n, mat.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("formulation", ["bitplane", "xorsched"])
def test_cuda_coder_row_digests(formulation):
    _need_card()
    coder = pcoder.TorchCoder(10, 4, formulation=formulation)
    rng = np.random.default_rng(93)
    data = rng.integers(0, 256, (10, 100_003), dtype=np.uint8)
    handle = coder.encode_async(data)
    parity = coder.materialize(handle)
    assert np.array_equal(parity, pcoder.NumpyCoder(10, 4).encode(data))
    assert coder.row_digests(handle).tolist() == [
        int(r.astype(np.uint64).sum()) & 0xFFFFFFFF
        for r in [*data, *parity]]


def _store_volume(st, vid: int, collection: str) -> None:
    """Seeded needles of the five kinds of the fused warm-down's tests,
    about a third of them deleted, written through the Store."""
    from seaweedfs_torch.storage.needle import Needle
    from seaweedfs_torch.utils import compression
    rng = np.random.default_rng(vid)
    st.add_volume(vid, collection=collection)
    for i in range(400):
        kind = i % 5
        data = (b"compressible text block " * int(rng.integers(1, 400))
                if kind == 0 else
                rng.bytes(int(rng.integers(1, 9000))) if kind == 1 else
                b"x" * int(rng.integers(1, 7)) if kind == 2 else
                compression.compress(b"already " * 600) if kind == 3 else
                b"padme" * int(rng.integers(100, 5000)))
        st.write_needle(vid, Needle(cookie=i, id=i + 1, data=data))
    for i in range(0, 400, 3):
        st.delete_needle(vid, Needle(cookie=i, id=i + 1))


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
def test_auto_store_encode_equals_numpy_store(tmp_path, monkeypatch, fused):
    """Store(coder_name="auto") encodes (ec_generate, and
    ec_fused_generate at RS(20,4) under the default policy's archive
    collection) on the card through gf_apply, and its files equal the
    "numpy" Store's on a copy of the same directory."""
    _need_card()
    import json
    import shutil
    from seaweedfs_torch.ec import geometry
    from seaweedfs_torch.storage.store import Store
    monkeypatch.delenv("WEED_EC_GEOMETRY", raising=False)
    monkeypatch.delenv("WEED_EC_FORMULATION", raising=False)
    collection = "archive" if fused else ""
    src = tmp_path / "src"
    st = Store([str(src)], coder_name="numpy")
    _store_volume(st, 5, collection)
    st.close()
    files = {}
    for name in ("numpy", "auto"):
        d = tmp_path / name
        shutil.copytree(src, d)
        st = Store([str(d)], coder_name=name)
        before = rs_cuda.gf_apply.launches
        try:
            if fused:
                assert st.ec_fused_generate(5) == list(range(24))
            else:
                assert st.ec_generate(5) == list(range(14))
        finally:
            st.close()
        if name == "auto":
            assert rs_cuda.gf_apply.launches > before
        g = geometry.GeometryPolicy.from_env().for_collection(collection)
        base = str(d / (f"{collection}_5" if collection else "5"))
        files[name] = [open(base + ext, "rb").read() for ext in
                       [geometry.to_ext(i) for i in range(g.total_shards)]
                       + [".ecx"]]
        files[name].append(json.load(open(base + ".ecm")))
    assert files["auto"] == files["numpy"]


@pytest.mark.gpu
def test_auto_cluster_encode_equals_numpy_store(tmp_path, monkeypatch):
    """A 3-server port cluster with Store(coder_name="auto") encodes a
    small volume through the shell (generate on the card, spread, mount,
    retire), and its shard files, gathered from the three directories,
    equal those of a "numpy" Store on a copy of the sealed volume."""
    _need_card()
    import json
    import random
    import shutil
    from seaweedfs_torch.client import Client
    from seaweedfs_torch.ec import geometry
    from seaweedfs_torch.server.local_cluster import LocalCluster
    from seaweedfs_torch.shell.ec_commands import EcCommands
    from seaweedfs_torch.storage.store import Store
    monkeypatch.delenv("WEED_EC_GEOMETRY", raising=False)
    monkeypatch.delenv("WEED_EC_FORMULATION", raising=False)
    g = geometry.Geometry(10, 4, 64 * 1024, 4 * 1024)
    cl = LocalCluster(3, coder_name="auto", geometry=g,
                      volume_size_limit_mb=4, pulse=0.15,
                      directory=str(tmp_path / "cluster"))
    try:
        client = Client(cl.master_url)
        vid = client.grow(count=1, collection="c")["volume_ids"][0]
        rng = random.Random(5)
        fids = {}
        for _ in range(60):
            a = client.assign(collection="c")
            assert int(a["fid"].split(",")[0]) == vid
            fids[a["fid"]] = rng.randbytes(rng.randint(100, 40000))
            client.upload_blob(a["url"], a["fid"], fids[a["fid"]])
        src = cl.index_of(client.lookup(vid)[0])
        client.volume_admin(cl.url(src), "volume/readonly",
                            {"volume_id": vid, "read_only": True})
        vol = cl.store(src).find_volume(vid)
        vol.sync()
        ref = tmp_path / "numpy"
        ref.mkdir()
        for ext in (".dat", ".idx"):
            shutil.copyfile(vol.base_file_name() + ext,
                            ref / f"c_{vid}{ext}")
        before = rs_cuda.gf_apply.launches
        EcCommands(client, g).encode(vid, "c")
        assert rs_cuda.gf_apply.launches > before
        info = client.ec_lookup(vid)
        assert len({u for us in info["shards"].values() for u in us}) == 3
        st = Store([str(ref)], coder_name="numpy", geometry=g)
        assert st.ec_generate(vid) == list(range(14))
        st.close()
        for sid, urls in info["shards"].items():
            d = cl.nodes[cl.index_of(urls[0])][3]
            ext = geometry.to_ext(int(sid))
            with open(os.path.join(d, f"c_{vid}{ext}"), "rb") as got, \
                    open(ref / f"c_{vid}{ext}", "rb") as want:
                assert got.read() == want.read(), sid
            with open(os.path.join(d, f"c_{vid}.ecm")) as got, \
                    open(ref / f"c_{vid}.ecm") as want:
                assert json.load(got) == json.load(want)
        client._vid_cache.clear()
        for fid, data in fids.items():
            assert client.download(fid) == data
    finally:
        cl.shutdown()


@pytest.mark.gpu
def test_replicated_vacuumed_cluster_encode_equals_numpy_store(
        tmp_path, monkeypatch):
    """A port cluster with Store(coder_name="auto") on one rack: uploads
    to a 001 collection, deletes, a /vol/vacuum that compacts both
    copies, then the shell's ec.encode on the card, which retires both
    copies. The shard files equal those of a "numpy" Store over a copy of
    the compacted, sealed volume."""
    _need_card()
    import json
    import random
    import shutil
    from seaweedfs_torch.client import Client
    from seaweedfs_torch.ec import geometry
    from seaweedfs_torch.server.local_cluster import LocalCluster
    from seaweedfs_torch.shell.ec_commands import EcCommands
    from seaweedfs_torch.storage.store import Store
    monkeypatch.delenv("WEED_EC_GEOMETRY", raising=False)
    monkeypatch.delenv("WEED_EC_FORMULATION", raising=False)
    g = geometry.Geometry(10, 4, 64 * 1024, 4 * 1024)
    cl = LocalCluster(3, coder_name="auto", geometry=g,
                      volume_size_limit_mb=4, pulse=0.15, racks=1,
                      directory=str(tmp_path / "cluster"))
    try:
        client = Client(cl.master_url)
        vid = client.grow(count=1, collection="c",
                          replication="001")["volume_ids"][0]
        rng = random.Random(6)
        fids = {}
        for _ in range(60):
            a = client.assign(collection="c", replication="001")
            assert int(a["fid"].split(",")[0]) == vid
            fids[a["fid"]] = rng.randbytes(rng.randint(100, 40000))
            client.upload_blob(a["url"], a["fid"], fids[a["fid"]])
        for fid in list(fids)[::3]:
            client.delete(fid)
            del fids[fid]
        assert client.vacuum(0.2)["compacted"] == [vid]
        holders = client.lookup(vid)
        assert len(holders) == 2
        src = cl.index_of(holders[0])
        for url in holders:
            client.volume_admin(url, "volume/readonly",
                                {"volume_id": vid, "read_only": True})
        vol = cl.store(src).find_volume(vid)
        assert vol.super_block.compaction_revision == 1
        vol.sync()
        ref = tmp_path / "numpy"
        ref.mkdir()
        for ext in (".dat", ".idx"):
            shutil.copyfile(vol.base_file_name() + ext,
                            ref / f"c_{vid}{ext}")
        before = rs_cuda.gf_apply.launches
        EcCommands(client, g).encode(vid, "c")
        assert rs_cuda.gf_apply.launches > before
        assert all(cl.store(i).find_volume(vid) is None for i in range(3))
        info = client.ec_lookup(vid)
        st = Store([str(ref)], coder_name="numpy", geometry=g)
        assert st.ec_generate(vid) == list(range(14))
        st.close()
        for sid, urls in info["shards"].items():
            d = cl.nodes[cl.index_of(urls[0])][3]
            ext = geometry.to_ext(int(sid))
            with open(os.path.join(d, f"c_{vid}{ext}"), "rb") as got, \
                    open(ref / f"c_{vid}{ext}", "rb") as want:
                assert got.read() == want.read(), sid
            with open(os.path.join(d, f"c_{vid}.ecm")) as got, \
                    open(ref / f"c_{vid}.ecm") as want:
                assert json.load(got) == json.load(want)
        client._vid_cache.clear()
        for fid, data in fids.items():
            assert client.download(fid) == data
    finally:
        cl.shutdown()


@pytest.mark.gpu
def test_auto_cluster_scrub_then_heal(tmp_path, monkeypatch):
    """The self-healing loop on the card: a 4-server port cluster with
    Store(coder_name="auto") and the repair daemon on; a shard of an
    encoded volume has one byte flipped, the scrubber reports exactly it
    (having checked every shard mounted there), and the master drops and
    rebuilds it through gf_apply to the original bytes."""
    _need_card()
    import hashlib
    import random
    import time
    from seaweedfs_torch.client import Client
    from seaweedfs_torch.ec import geometry
    from seaweedfs_torch.server.local_cluster import LocalCluster
    from seaweedfs_torch.shell.ec_commands import EcCommands
    monkeypatch.delenv("WEED_EC_GEOMETRY", raising=False)
    monkeypatch.delenv("WEED_EC_FORMULATION", raising=False)
    g = geometry.Geometry(10, 4, 64 * 1024, 4 * 1024)
    cl = LocalCluster(4, coder_name="auto", geometry=g,
                      volume_size_limit_mb=4, pulse=0.15,
                      directory=str(tmp_path / "cluster"))
    try:
        client = Client(cl.master_url)
        rng = random.Random(8)
        fids = {}
        for _ in range(30):
            data = rng.randbytes(rng.randint(100, 40000))
            fids[client.upload(data, collection="s")] = data
        vids = {int(f.split(",")[0]) for f in fids}
        assert len(vids) == 1
        vid = vids.pop()
        # the shell's spread holds the admin lock: the repair daemon
        # keeps away from it
        EcCommands(client, g).encode(vid, "s")
        holders: dict = {}
        for sid, urls in client.ec_lookup(vid)["shards"].items():
            for u in urls:
                holders.setdefault(u, []).append(int(sid))
        url, sids = sorted(holders.items())[0]
        node = cl.nodes[cl.index_of(url)]
        path = os.path.join(node[3], f"s_{vid}") + geometry.to_ext(sids[0])
        with open(path, "rb") as f:
            want = hashlib.sha256(f.read()).hexdigest()
        with open(path, "r+b") as f:
            f.seek(7)
            b = f.read(1)
            f.seek(7)
            f.write(bytes([b[0] ^ 0x5A]))
        checked = node[0].metrics.value("scrub_shards_checked")
        before = rs_cuda.gf_apply.launches
        out = client.volume_admin(url, "ec/scrub", {"throttle_seconds": 0})
        assert out["bad"] == {str(vid): [sids[0]]}
        assert node[0].metrics.value("scrub_shards_checked") - checked \
            == len(sids)
        deadline = time.monotonic() + 60
        while cl.master.metrics.value("repairs_succeeded",
                                      {"kind": "ec"}) < 1:
            assert time.monotonic() < deadline, "no repair"
            time.sleep(0.05)
        assert rs_cuda.gf_apply.launches > before
        info = client.ec_lookup(vid)["shards"]
        assert len(info) == 14
        holder = cl.nodes[cl.index_of(info[str(sids[0])][0])][3]
        with open(os.path.join(holder, f"s_{vid}")
                  + geometry.to_ext(sids[0]), "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == want
        client._vid_cache.clear()
        for fid, data in fids.items():
            assert client.download(fid) == data
    finally:
        cl.shutdown()


@pytest.mark.gpu
@pytest.mark.parametrize("formulation", ["bitplane", "xorsched"])
def test_mesh_coder_on_the_card_equals_single_card(formulation):
    """A two-member MeshCoder on the card (the one card twice where there
    is only one, each member on its own stream) gives the single-card
    coder's parity, row digests and rebuilt rows at an odd width, its
    formulation's kernel launched once per member per call."""
    _need_card()
    from seaweedfs_torch.parallel import mesh_coder
    n = torch.cuda.device_count()
    devices = ([torch.device("cuda", i) for i in range(2)] if n >= 2
               else [torch.device("cuda", 0)] * 2)
    mesh = mesh_coder.MeshCoder(10, 4, devices=devices,
                                formulation=formulation)
    single = pcoder.TorchCoder(10, 4, formulation=formulation)
    kernel = (rs_cuda.gf_apply_xorsched if formulation == "xorsched"
              else rs_cuda.gf_apply)
    rng = np.random.default_rng(71)
    data = rng.integers(0, 256, (10, (1 << 20) + 7), dtype=np.uint8)
    before = kernel.launches
    handle = mesh.encode_async(data)
    parity = mesh.materialize(handle)
    assert kernel.launches - before == 2
    want = single.encode_async(data)
    assert np.array_equal(parity, single.materialize(want))
    assert np.array_equal(mesh.row_digests(handle),
                          single.row_digests(want))
    rows = [*data, *parity]
    present = tuple(i for i in range(14) if i not in VICTIMS)[:10]
    survivors = np.stack([rows[i] for i in present])
    got = mesh.materialize(mesh.rec_apply_async(present, VICTIMS)(survivors))
    for row, victim in zip(got, VICTIMS):
        assert np.array_equal(row, rows[victim]), victim


@pytest.mark.gpu
def test_ec_encode_crash_sweep_on_the_card():
    """The ec_encode crash workload through stream_encode with the card's
    coder: zero violations, gf_apply launched."""
    _need_card()
    from seaweedfs_torch.crashsim import sweep
    from seaweedfs_torch.crashsim import workloads
    from seaweedfs_torch.ec import geometry, pipeline
    before = rs_cuda.gf_apply.launches
    w = workloads.make_ec_workload(
        coder=pcoder.get_coder("auto", 10, 4),
        geometry=geometry.Geometry(large_block_size=262144,
                                   small_block_size=16384),
        dat_size=4 << 20,
        dat_source=lambda n: np.random.default_rng(72).bytes(n),
        encode=pipeline.stream_encode)
    r = sweep(w, seed=1, points=8)
    assert r.points == 8 and r.ok, r.violations
    assert rs_cuda.gf_apply.launches > before
