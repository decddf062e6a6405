"""The port's xorsched formulation against the JAX reference.

- ``xor_schedule.build_schedule`` / ``schedule_for_matrix`` give the
  reference's schedules (ops, out_ids, XOR counts) for parity and
  reconstruction matrices: the schedule is the kernel's program;
- ``pack_planes`` / ``unpack_planes`` give the reference's words;
- the lowered program (``lower_schedule``), emulated in numpy slot by slot
  exactly as ``csrc/gf_xorsched.cu`` walks it, gives
  ``apply_schedule_numpy``'s planes, so slot reuse is checked without a
  card;
- the plain ``rs_torch.gf_apply_xorsched`` equals the Pallas xorsched
  kernel in interpret mode and ``rs_jax.gf_apply_xorsched``;
- ``TorchCoder(device="cpu", formulation="xorsched")`` encodes, serves
  degraded reads and rebuilds byte-identically to the reference;
- the ``WEED_EC_FORMULATION`` pin follows the reference's rules.

The tolerance everywhere is bit equality.
"""

import hashlib
import os
import shutil

import numpy as np
import pytest
import torch

from seaweedfs_torch.ec import coder as pcoder
from seaweedfs_torch.ec import ec_volume as pecv
from seaweedfs_torch.ec import geometry as pgeo
from seaweedfs_torch.ec import pipeline as ppipe
from seaweedfs_torch.ec import striping as pstrip
from seaweedfs_torch.ops import gf256 as pgf
from seaweedfs_torch.ops import rs_cuda, rs_torch
from seaweedfs_torch.ops import xor_schedule as pxs
from seaweedfs_tpu import ec as rec
from seaweedfs_tpu.ec import pipeline as rpipe
from seaweedfs_tpu.ops import gf256, rs_jax, rs_pallas
from seaweedfs_tpu.ops import xor_schedule as rxs

# the plain version runs at test sizes: one thread keeps this worker
# from crowding the others under pytest-xdist
torch.set_num_threads(1)

VICTIMS = (0, 3, 7, 12)


def _rec_matrix(k: int, m: int, victims: tuple) -> np.ndarray:
    present = tuple(i for i in range(k + m) if i not in victims)[:k]
    return gf256.reconstruction_matrix(k, m, present, victims)


MATRICES = {
    "parity_10_4": lambda: gf256.parity_matrix(10, 4),
    "parity_20_4": lambda: gf256.parity_matrix(20, 4),
    "parity_6_3": lambda: gf256.parity_matrix(6, 3),
    "rec_one_row": lambda: _rec_matrix(10, 4, (3,)),
    "rec_four_rows": lambda: _rec_matrix(10, 4, VICTIMS),
}


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_schedule_matches_reference(name):
    mat = MATRICES[name]()
    want = rxs.schedule_for_matrix(mat)
    got = pxs.schedule_for_matrix(mat)
    assert got.ops == want.ops
    assert got.out_ids == want.out_ids
    assert (got.n_in, got.n_rows) == (want.n_in, want.n_rows)
    assert (got.dense_xors, got.sched_xors) == (want.dense_xors,
                                                want.sched_xors)
    assert pxs.build_schedule(rs_torch.bitplane_matrix(mat)) == got
    assert pxs.schedule_for_matrix(mat) is got  # cached


def test_schedule_of_zero_rows_and_identity():
    """An all-zero row gives None; a row that is one input plane names it
    directly, with no XOR."""
    w = np.zeros((3, 4), dtype=np.int8)
    w[1, 2] = 1
    got = pxs.build_schedule(w)
    assert got == rxs.build_schedule(w)
    assert got.out_ids == (None, 2, None) and got.ops == ()


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000])
def test_pack_unpack_match_reference(n):
    rng = np.random.default_rng(100 + n)
    x = rng.integers(0, 256, (10, n), dtype=np.uint8)
    planes = pxs.pack_planes(torch.from_numpy(x))
    assert planes.dtype == torch.int32
    assert tuple(planes.shape) == (80, pxs.packed_width(n))
    want = np.asarray(rxs.pack_planes(x))
    assert np.array_equal(planes.numpy().view(np.uint32), want)
    back = pxs.unpack_planes(planes, n).numpy()
    assert np.array_equal(back, x)
    assert np.array_equal(
        back, np.asarray(rxs.unpack_planes(want, n)))


def _emulate_program(prog: pxs.XorProgram, bits: np.ndarray) -> np.ndarray:
    """The kernel's walk over its slots: inputs in slots 0..n_in-1, each
    op reads two slots and writes a third, outputs read from out_slots."""
    n = bits.shape[1]
    slots = np.full((prog.n_slots, n), 0xEE, dtype=np.uint8)  # garbage
    slots[:prog.sched.n_in] = bits
    for dst, a, b in prog.code.numpy().tolist():
        slots[dst] = slots[a] ^ slots[b]
    out = np.zeros((prog.sched.n_rows, n), dtype=np.uint8)
    for r, s in enumerate(prog.out_slots.numpy().tolist()):
        if s >= 0:
            out[r] = slots[s]
    return out


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_lowered_program_emulation_matches_schedule(name):
    mat = MATRICES[name]()
    sched = pxs.schedule_for_matrix(mat)
    prog = pxs.lower_schedule(sched)
    assert prog.code.dtype == torch.int16
    assert tuple(prog.code.shape) == (len(sched.ops), 3)
    assert prog.out_slots.dtype == torch.int16
    assert sched.n_in <= prog.n_slots < sched.n_in + len(sched.ops)
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, (sched.n_in, 257), dtype=np.uint8)
    assert np.array_equal(_emulate_program(prog, bits),
                          rxs.apply_schedule_numpy(sched, bits))


def test_lowered_program_reuses_slots():
    """The RS(10,4) parity program keeps about 209 values live out of the
    579 the reference keeps alive."""
    sched = pxs.schedule_for_matrix(gf256.parity_matrix(10, 4))
    prog = pxs.lower_schedule(sched)
    assert prog.n_slots < 0.4 * (sched.n_in + len(sched.ops))
    threads, smem = rs_cuda.xorsched_launch(prog)
    # as many threads as the slots (209 words, an odd row each) leave
    # room for: 256, against 128 in the first design
    assert threads == 256 and threads <= rs_cuda.XORSCHED_THREADS
    assert smem <= rs_cuda.SMEM_LIMIT < smem + 32 * 4 * prog.n_slots


def test_lowered_program_with_zero_rows_and_plain_inputs():
    mat = np.zeros((3, 4), dtype=np.uint8)
    mat[1] = [0, 1, 0, 0]  # out row 1 = input row 1: plain input planes
    mat[2] = [5, 0, 9, 1]
    prog = pxs.lower_schedule(pxs.schedule_for_matrix(mat))
    assert (prog.out_slots.numpy()[:8] == -1).all()
    rng = np.random.default_rng(8)
    x = rng.integers(0, 256, (4, 50), dtype=np.uint8)
    bits = ((x[:, None, :] >> np.arange(8)[None, :, None]) & 1).reshape(32,
                                                                       50)
    planes = _emulate_program(prog, bits.astype(np.uint8)).reshape(3, 8, 50)
    got = (planes.astype(np.uint16) << np.arange(8)[None, :, None]).sum(1)
    assert np.array_equal(got.astype(np.uint8), pgf.gf_matrix_apply(mat, x))


def test_slot_count_that_does_not_fit_raises():
    sched = pxs.schedule_for_matrix(gf256.parity_matrix(10, 4))
    prog = pxs.lower_schedule(sched)._replace(n_slots=2000)
    with pytest.raises(ValueError, match="do not fit"):
        rs_cuda.xorsched_launch(prog)


@pytest.mark.parametrize("k,m", [(10, 4), (20, 4), (6, 3)])
def test_plain_matches_pallas_interpret_and_rs_jax(k, m):
    rng = np.random.default_rng(200 + k)
    pm = gf256.parity_matrix(k, m)
    sched = pxs.schedule_for_matrix(pm)
    pallas = rs_pallas.gf_apply_pallas(pm, tile=512, interpret=True,
                                       formulation="xorsched")
    jx = rs_jax.gf_apply_xorsched(pm)
    for n in [1, 1000, 1025]:
        x = rng.integers(0, 256, (k, n), dtype=np.uint8)
        got = rs_torch.gf_apply_xorsched(sched, torch.from_numpy(x)).numpy()
        assert np.array_equal(got, np.asarray(pallas(x))), n
        assert np.array_equal(got, np.asarray(jx(x))), n
        assert np.array_equal(got, gf256.encode_parity(x, m)), n


@pytest.mark.parametrize("victims", [(3,), VICTIMS, (13, 2)])
def test_plain_reconstruction_matches_rs_jax(victims):
    rng = np.random.default_rng(300 + len(victims))
    mat = _rec_matrix(10, 4, victims)
    sched = pxs.schedule_for_matrix(mat)
    for n in [1, 1000, 1025]:
        x = rng.integers(0, 256, (10, n), dtype=np.uint8)
        got = rs_torch.gf_apply_xorsched(sched, torch.from_numpy(x)).numpy()
        assert np.array_equal(got, np.asarray(
            rs_jax.gf_apply_xorsched(mat)(x))), n
        assert np.array_equal(got, pgf.gf_matrix_apply(mat, x)), n


def test_wrapper_on_cpu_is_plain_and_does_not_count():
    rng = np.random.default_rng(25)
    x = torch.from_numpy(rng.integers(0, 256, (10, 333), dtype=np.uint8))
    pm = gf256.parity_matrix(10, 4)
    prog = pxs.lower_schedule(pxs.schedule_for_matrix(pm))
    before = rs_cuda.gf_apply_xorsched.launches
    got = rs_cuda.gf_apply_xorsched(prog, x)
    assert torch.equal(got, rs_torch.gf_apply_xorsched(prog.sched, x))
    assert torch.equal(got, rs_torch.gf_apply(
        rs_torch.load_matrix(pm, "cpu"), x))
    assert rs_cuda.gf_apply_xorsched.launches == before
    with pytest.raises(ValueError):
        rs_torch.gf_apply_xorsched(prog.sched, x[:6])


# --- the coder and the slice --------------------------------------------

@pytest.mark.parametrize("k,m", [(10, 4), (6, 3)])
def test_xorsched_coder_matches_reference(k, m):
    coder = pcoder.TorchCoder(k, m, device="cpu", formulation="xorsched")
    ref = rec.get_coder("numpy", k, m)
    assert coder.formulation == "xorsched"
    rng = np.random.default_rng(k)
    data = rng.integers(0, 256, (k, 1531), dtype=np.uint8)
    parity = coder.encode(data)
    assert np.array_equal(parity, ref.encode(data))
    shards = [data[i] for i in range(k)] + [parity[j] for j in range(m)]
    assert coder.verify(shards)
    for drop in [(0,), (0, 3, 7, 12)[:m], (k, 1)]:
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
    # the padded rebuild program: zero rows past the victims
    w = coder._rec_w(tuple(range(1, k + 1)), (0,), rows=m)
    assert isinstance(w, pxs.XorProgram)
    assert (w.out_slots.numpy()[8:] == -1).all()


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_xorsched_slice_matches_reference(tmp_path):
    """stream_encode shards, .ecx and .ecm byte-identical to the
    reference's write_ec_files; degraded reads through the coder; and
    stream_rebuild restores the lost shards."""
    from seaweedfs_torch.storage.needle import Needle
    from seaweedfs_torch.storage.volume import Volume
    geo = {"large_block_size": 262144, "small_block_size": 16384}
    pg, rg = pgeo.Geometry(**geo), rec.Geometry(**geo)
    src = str(tmp_path / "src")
    os.mkdir(src)
    rng = np.random.default_rng(11)
    vol = Volume(src, "", 1, create=True)
    sizes = {}
    for nid in range(1, 40):
        size = int(rng.integers(100, 200_000))
        vol.write_needle(Needle(cookie=nid * 7919, id=nid,
                                data=np.random.default_rng(nid).bytes(size)))
        sizes[nid] = size
    vol.close()
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    shutil.copytree(src, port)
    shutil.copytree(src, ref)
    pbase, rbase = os.path.join(port, "1"), os.path.join(ref, "1")
    coder = pcoder.TorchCoder(10, 4, device="cpu", formulation="xorsched")
    ppipe.stream_encode(pbase, coder, pg, batch_size=65536, depth=2)
    pstrip.write_sorted_ecx_from_idx(pbase)
    rec.write_ec_files(rbase, rec.get_coder("numpy", 10, 4), rg)
    rec.write_sorted_ecx_from_idx(rbase)
    rpipe_digests = rpipe.stamp_shard_digests(rbase, rg)
    for ext in [pgeo.to_ext(i) for i in range(14)] + [".ecx"]:
        assert _sha(pbase + ext) == _sha(rbase + ext), ext
    assert ppipe.read_stamped_digests(pbase) == rpipe_digests
    with open(pbase + ".ecm") as f, open(rbase + ".ecm") as g:
        assert f.read() == g.read()

    want = {v: _sha(pbase + pgeo.to_ext(v)) for v in VICTIMS}
    for v in VICTIMS:
        os.remove(pbase + pgeo.to_ext(v))
    calls = []
    real = coder._rec_apply

    def counting(present, missing):
        calls.append(missing)
        return real(present, missing)

    coder._rec_apply = counting
    ev = pecv.EcVolume(port, "", 1, pg, coder=coder)
    try:
        for sid in range(14):
            if sid not in VICTIMS:
                ev.add_shard(sid)
        for nid, size in sizes.items():
            got = ev.read_needle(nid, cookie=nid * 7919)
            assert got.data == np.random.default_rng(nid).bytes(size), nid
    finally:
        ev.close()
    assert calls and all(len(m) == 1 and m[0] in VICTIMS for m in calls)
    del coder._rec_apply
    assert ppipe.stream_rebuild(pbase, coder, pg, batch_size=65536,
                                depth=2) == list(VICTIMS)
    for v in VICTIMS:
        assert _sha(pbase + pgeo.to_ext(v)) == want[v], v


# --- the WEED_EC_FORMULATION pin ------------------------------------------

def test_formulation_env_pin(monkeypatch):
    monkeypatch.delenv("WEED_EC_FORMULATION", raising=False)
    assert rs_torch.formulation_env() is None
    assert pcoder.TorchCoder(10, 4, device="cpu").formulation == "bitplane"
    monkeypatch.setenv("WEED_EC_FORMULATION", " XorSched ")
    assert rs_torch.formulation_env() == rs_jax.formulation_env() == \
        "xorsched"
    assert pcoder.TorchCoder(10, 4, device="cpu").formulation == "xorsched"
    # an explicit formulation wins over the pin, as in PallasCoder
    assert pcoder.TorchCoder(10, 4, device="cpu",
                             formulation="bitplane").formulation == \
        "bitplane"
    monkeypatch.setenv("WEED_EC_FORMULATION", "lut")
    assert rs_torch.formulation_env() == rs_jax.formulation_env() == "lut"
    assert pcoder.TorchCoder(10, 4, device="cpu").formulation == "bitplane"


def test_formulation_env_rejects_unknown(monkeypatch):
    monkeypatch.setenv("WEED_EC_FORMULATION", "turbo")
    with pytest.raises(ValueError, match="turbo"):
        rs_torch.formulation_env()
    with pytest.raises(ValueError, match="turbo"):
        rs_jax.formulation_env()
    with pytest.raises(ValueError, match="turbo"):
        pcoder.TorchCoder(10, 4, device="cpu")
    monkeypatch.delenv("WEED_EC_FORMULATION")
    with pytest.raises(ValueError, match="unknown formulation"):
        pcoder.TorchCoder(10, 4, device="cpu", formulation="lut")
