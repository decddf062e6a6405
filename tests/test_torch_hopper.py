"""The Hopper redesign of the port's two main-path kernels, and their fused
digest, against the JAX reference.

- a numpy replica of ``csrc/gf_apply.cu``'s packed product table (four
  output rows' products per 32-bit word, built from the bit-plane operand
  W) equals the reference GF(2^8) products for every R <= 32 and C <= 32,
  the parity matrices, and zero-padded and one-row reconstruction
  matrices; a replica of its 16-column main loop (row pairs, the zero
  padding row of an odd C, the __byte_perm transposes, the __dp4a digest)
  equals the reference encode and sums;
- ``lower_schedule_grouped``: groups of four with no intra-group
  read-after-write or write-after-write, its grouped emulation equal to
  the reference schedule and to the Pallas xorsched kernel in interpret
  mode, and no more slots than ``lower_schedule``;
- the plain digests wrap mod 2^32 as the reference's uint32 sums do, and
  the wrappers' digest and digest-only paths on the CPU;
- ``stream_encode`` through ``TorchCoder(device="cpu")`` under each
  formulation: shards and .ecm digests equal the reference's, with the
  digests taken from the coder (the host sum is not called); the device
  sinks accumulate their digest buffer across windows.

Bit equality everywhere.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from seaweedfs_torch.ec import coder as pcoder
from seaweedfs_torch.ec import geometry as pgeo
from seaweedfs_torch.ec import pipeline as ppipe
from seaweedfs_torch.ops import rs_cuda, rs_torch
from seaweedfs_torch.ops import xor_schedule as pxs
from seaweedfs_tpu import ec as rec
from seaweedfs_tpu.ec import pipeline as rpipe
from seaweedfs_tpu.ops import gf256, rs_pallas
from seaweedfs_tpu.ops import xor_schedule as rxs

torch.set_num_threads(1)

VICTIMS = (0, 3, 7, 12)
MASK = 0xFFFFFFFF


def _rec_matrix(k: int, m: int, victims: tuple) -> np.ndarray:
    present = tuple(i for i in range(k + m) if i not in victims)[:k]
    return gf256.reconstruction_matrix(k, m, present, victims)


def _padded_rec(k: int, m: int) -> np.ndarray:
    rec_m = _rec_matrix(k, m, VICTIMS[:2])
    return np.vstack([rec_m, np.zeros((m - 2, k), np.uint8)])


MATRICES = {
    "parity_10_4": lambda: gf256.parity_matrix(10, 4),
    "parity_20_4": lambda: gf256.parity_matrix(20, 4),
    "parity_6_3": lambda: gf256.parity_matrix(6, 3),
    "rec_one_row": lambda: _rec_matrix(10, 4, (3,)),
    "rec_four_rows": lambda: _rec_matrix(10, 4, VICTIMS),
    "rec_zero_padded": lambda: _padded_rec(10, 4),
}


# --- csrc/gf_apply.cu: the packed product table --------------------------

def _product_table(w: np.ndarray, rows: int, cols: int, q: int) -> np.ndarray:
    """The kernel's build_table for row group q: [Cp, 256] uint32, Cp = C
    rounded up to even (the padding row zero). bp[c, j] packs the bytes
    that bit j of x[c] contributes to rows 4q .. 4q+3 (W[8r+i, 8c+j] is
    bit i of that byte); a byte's product XORs its set bits'."""
    bp = np.zeros((cols, 8), dtype=np.uint32)
    for rr in range(4):
        r = 4 * q + rr
        if r >= rows:
            break
        bits = w[8 * r:8 * r + 8].reshape(8, cols, 8).astype(np.uint32) & 1
        byte = (bits << np.arange(8, dtype=np.uint32)[:, None, None]).sum(0)
        bp |= byte.astype(np.uint32) << np.uint32(8 * rr)
    cp = (cols + 1) & ~1
    table = np.zeros((cp, 256), dtype=np.uint32)
    v = np.arange(256)
    for j in range(8):
        sel = ((v >> j) & 1).astype(bool)
        table[:cols, sel] ^= bp[:, j:j + 1]
    return table


@pytest.mark.parametrize("rows", range(1, 33))
def test_product_table_matches_reference_products(rows):
    """Every R <= 32 with C = 33 - R (so every C <= 32 too): byte rr of
    T[c][v] is M[4q + rr, c] * v over GF(2^8), zero past R and in the
    padding row."""
    cols = 33 - rows
    rng = np.random.default_rng(rows)
    mat = rng.integers(0, 256, (rows, cols), dtype=np.uint8)
    w = rs_torch.bitplane_matrix(mat)
    mul = gf256.mul_table()
    for q in range((rows + 3) // 4):
        table = _product_table(w, rows, cols, q)
        for rr in range(4):
            got = (table >> np.uint32(8 * rr)) & 0xFF
            r = 4 * q + rr
            want = np.zeros_like(got)
            if r < rows:
                want[:cols] = mul[mat[r][:, None], np.arange(256)[None, :]]
            assert np.array_equal(got, want), (q, rr)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_product_table_of_coding_matrices(name):
    mat = MATRICES[name]()
    rows, cols = mat.shape
    w = rs_torch.bitplane_matrix(mat)
    mul = gf256.mul_table()
    for q in range((rows + 3) // 4):
        table = _product_table(w, rows, cols, q)
        for rr in range(min(4, rows - 4 * q)):
            want = mul[mat[4 * q + rr][:, None], np.arange(256)[None, :]]
            got = (table[:cols] >> np.uint32(8 * rr)) & 0xFF
            assert np.array_equal(got, want)


def _byte_perm(x: np.ndarray, y: np.ndarray, sel: int) -> np.ndarray:
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of
    the eight bytes of (y:x)."""
    src = np.stack([(x >> np.uint32(8 * i)) & 0xFF for i in range(4)]
                   + [(y >> np.uint32(8 * i)) & 0xFF for i in range(4)])
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << np.uint32(8 * i)
    return out


def _vec16_replica(w: np.ndarray, rows: int, cols: int,
                   x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """gf_apply_vec16 over every 16-column group at once: (out [R, n],
    digest [C + R])."""
    n = x.shape[1]
    words = x.reshape(cols, n // 16, 4, 4).view(np.uint32)  # [C, g, 4 words]
    words = words.reshape(cols, n // 16, 4)
    cp = (cols + 1) & ~1
    out = np.zeros((rows, n), dtype=np.uint8)
    for q in range((rows + 3) // 4):
        table = _product_table(w, rows, cols, q)
        acc = np.zeros((n // 16, 16), dtype=np.uint32)
        for c in range(0, cp, 2):
            for cc in (c, c + 1):
                src = words[min(cc, cols - 1)]  # the padding row rereads C-1
                for qq in range(4):
                    for b in range(4):
                        byte = (src[:, qq] >> np.uint32(8 * b)) & 0xFF
                        acc[:, 4 * qq + b] ^= table[cc][byte]
        for p in range(4):
            a, b_, c_, d = (acc[:, 4 * p + i] for i in range(4))
            t0, t1 = _byte_perm(a, b_, 0x5140), _byte_perm(c_, d, 0x5140)
            t2, t3 = _byte_perm(a, b_, 0x7362), _byte_perm(c_, d, 0x7362)
            row_words = [_byte_perm(t0, t1, 0x5410),
                         _byte_perm(t0, t1, 0x7632),
                         _byte_perm(t2, t3, 0x5410),
                         _byte_perm(t2, t3, 0x7632)]
            for rr in range(4):
                r = 4 * q + rr
                if r < rows:
                    view = out[r].reshape(n // 16, 4, 4)
                    view[:, p, :] = row_words[rr].view(np.uint8).reshape(
                        -1, 4)
    digest = np.concatenate([x.astype(np.uint64).sum(1),
                             out.astype(np.uint64).sum(1)]) & MASK
    return out, digest


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_vec16_replica_matches_reference(name):
    mat = MATRICES[name]()
    rows, cols = mat.shape
    rng = np.random.default_rng(len(name))
    x = rng.integers(0, 256, (cols, 16 * 37), dtype=np.uint8)
    out, digest = _vec16_replica(rs_torch.bitplane_matrix(mat), rows, cols,
                                 x)
    want = gf256.gf_matmul(mat, x)
    assert np.array_equal(out, want)
    assert digest.tolist() == [int(v) & MASK for v in np.concatenate(
        [x.astype(np.uint64).sum(1), want.astype(np.uint64).sum(1)])]


@pytest.mark.parametrize("cols", [1, 3, 7])
def test_vec16_replica_odd_widths_pad_with_zero_row(cols):
    rng = np.random.default_rng(cols)
    mat = rng.integers(0, 256, (5, cols), dtype=np.uint8)
    x = rng.integers(0, 256, (cols, 64), dtype=np.uint8)
    out, _ = _vec16_replica(rs_torch.bitplane_matrix(mat), 5, cols, x)
    assert np.array_equal(out, gf256.gf_matmul(mat, x))


# --- ops/xor_schedule.py: the grouped lowering ---------------------------

def _groups(prog: pxs.XorProgram) -> np.ndarray:
    return prog.code.numpy().reshape(-1, prog.group, 3)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_grouped_lowering_has_no_intra_group_hazards(name):
    prog = pxs.lower_schedule_grouped(
        pxs.schedule_for_matrix(MATRICES[name]()))
    assert prog.group == 4 and prog.code.shape[0] % 4 == 0
    for group in _groups(prog):
        dsts = group[:, 0].tolist()
        assert len(set(dsts)) == len(dsts)  # no write-after-write
        for i, (dst, _, _) in enumerate(group):
            for j, (_, a, b) in enumerate(group):
                if i != j:
                    assert dst not in (a, b)  # no read of another's write


def _emulate_grouped(prog: pxs.XorProgram, bits: np.ndarray) -> np.ndarray:
    """The kernel's grouped walk: per group every operand read, then every
    result written."""
    n = bits.shape[1]
    slots = np.full((prog.n_slots, n), 0xEE, dtype=np.uint8)  # garbage
    slots[:prog.sched.n_in] = bits
    for group in _groups(prog):
        vals = [slots[a] ^ slots[b] for _, a, b in group]
        for (dst, _, _), v in zip(group, vals):
            slots[dst] = v
    out = np.zeros((prog.sched.n_rows, n), dtype=np.uint8)
    for r, s in enumerate(prog.out_slots.numpy().tolist()):
        if s >= 0:
            out[r] = slots[s]
    return out


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_grouped_emulation_matches_reference_schedule(name):
    mat = MATRICES[name]()
    sched = pxs.schedule_for_matrix(mat)
    prog = pxs.lower_schedule_grouped(sched)
    rng = np.random.default_rng(9)
    bits = rng.integers(0, 2, (sched.n_in, 129), dtype=np.uint8)
    assert np.array_equal(
        _emulate_grouped(prog, bits),
        rxs.apply_schedule_numpy(rxs.schedule_for_matrix(mat), bits))


@pytest.mark.parametrize("k,m", [(10, 4), (6, 3)])
def test_grouped_emulation_matches_pallas_interpret(k, m):
    """Bytes through the grouped program (planes packed as the kernel's
    bytes_to_planes lays them) equal the Pallas xorsched kernel's."""
    pm = gf256.parity_matrix(k, m)
    prog = pxs.lower_schedule_grouped(pxs.schedule_for_matrix(pm))
    pallas = rs_pallas.gf_apply_pallas(pm, tile=512, interpret=True,
                                       formulation="xorsched")
    rng = np.random.default_rng(400 + k)
    for n in [1, 1000]:
        x = rng.integers(0, 256, (k, n), dtype=np.uint8)
        bits = ((x[:, None, :] >> np.arange(8)[None, :, None]) & 1).reshape(
            8 * k, n).astype(np.uint8)
        planes = _emulate_grouped(prog, bits).reshape(m, 8, n)
        got = (planes.astype(np.uint16) << np.arange(8)[None, :, None]).sum(
            1).astype(np.uint8)
        assert np.array_equal(got, np.asarray(pallas(x))), n


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_grouped_lowering_needs_no_more_slots(name):
    sched = pxs.schedule_for_matrix(MATRICES[name]())
    seq, grouped = pxs.lower_schedule(sched), pxs.lower_schedule_grouped(
        sched)
    assert grouped.n_slots <= seq.n_slots
    assert rs_cuda.xorsched_launch(grouped)[0] >= \
        rs_cuda.xorsched_launch(seq)[0]


def test_grouped_lowering_of_rs_10_4_parity():
    """The RS(10,4) parity program: 499 ops in 126 groups (5 no-ops), 152
    slots against 209, so 352 threads fit a block against 256 (320 with
    the digest's 14 sums per thread)."""
    sched = pxs.schedule_for_matrix(gf256.parity_matrix(10, 4))
    prog = pxs.lower_schedule_grouped(sched)
    assert len(sched.ops) == 499 and prog.code.shape[0] == 4 * 126
    assert prog.n_slots == 152
    assert pxs.lower_schedule(sched).n_slots == 209
    assert rs_cuda.xorsched_launch(prog)[0] == 352
    assert rs_cuda.xorsched_launch(prog, digest=True)[0] == 320


def test_grouped_lowering_keeps_zero_rows_and_plain_inputs():
    mat = np.zeros((3, 4), dtype=np.uint8)
    mat[1] = [0, 1, 0, 0]
    mat[2] = [5, 0, 9, 1]
    prog = pxs.lower_schedule_grouped(pxs.schedule_for_matrix(mat))
    assert (prog.out_slots.numpy()[:8] == -1).all()
    rng = np.random.default_rng(8)
    x = rng.integers(0, 256, (4, 50), dtype=np.uint8)
    bits = ((x[:, None, :] >> np.arange(8)[None, :, None]) & 1).reshape(32,
                                                                       50)
    planes = _emulate_grouped(prog, bits.astype(np.uint8)).reshape(3, 8, 50)
    got = (planes.astype(np.uint16) << np.arange(8)[None, :, None]).sum(1)
    assert np.array_equal(got.astype(np.uint8), gf256.gf_matmul(mat, x))


# --- the digests ----------------------------------------------------------

def test_plain_digest_wraps_mod_2_32():
    """A row of 0xFF past 2^32 / 255 bytes: the plain digest is the
    reference's wrapping uint32 sum."""
    n = (1 << 32) // 255 + 1000
    row = np.full((1, n), 0xFF, dtype=np.uint8)
    got = rs_torch.row_digest(torch.from_numpy(row))
    assert 255 * n > 1 << 32
    assert got.tolist() == [int(np.sum(row, dtype=np.uint32))]
    assert got.tolist() == [(255 * n) & MASK]


@pytest.mark.parametrize("repeats", [1, 7])
def test_wrapper_digest_accumulates_and_wraps_on_cpu(repeats):
    """gf_apply and gf_apply_xorsched on CPU tensors add the plain digest
    ([C + R]) to the int32 buffer, wrapping mod 2^32 as the reference's
    encode_digest_async accumulator does (7 launches pass 2^32 and 2^31);
    out=False returns None."""
    pm = gf256.parity_matrix(2, 2)
    w = rs_torch.load_matrix(pm, "cpu")
    prog = pxs.lower_schedule_grouped(pxs.schedule_for_matrix(pm))
    x = np.full((2, 3 << 20), 0xFF, dtype=np.uint8)
    xt = torch.from_numpy(x)
    ref = rec.NumpyCoder(2, 2)
    for kernel, operand in [(rs_cuda.gf_apply, w),
                            (rs_cuda.gf_apply_xorsched, prog)]:
        d = rs_cuda.new_digest(4, "cpu")
        racc = None
        before = (rs_cuda.gf_apply.launches,
                  rs_cuda.gf_apply_xorsched.launches)
        for i in range(repeats):
            got = kernel(operand, xt, digest=d, out=i % 2 == 0)
            assert (got is None) == (i % 2 == 1)
            racc = ref.encode_digest_async(x, racc)
        assert before == (rs_cuda.gf_apply.launches,
                          rs_cuda.gf_apply_xorsched.launches)
        vals = rs_cuda.digest_values(d).tolist()
        assert vals[2:] == np.asarray(racc).tolist()
        assert vals[:2] == [(repeats * 255 * (3 << 20)) & MASK] * 2


def test_wrapper_digest_checks_on_cpu():
    w = rs_torch.load_matrix(gf256.parity_matrix(10, 4), "cpu")
    x = torch.zeros((10, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="digest"):
        rs_cuda.gf_apply(w, x, digest=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="digest"):
        rs_cuda.gf_apply(w, x, digest=torch.zeros(14, dtype=torch.int64))
    with pytest.raises(ValueError, match="mxu"):
        rs_cuda.gf_apply(w, x, repack="mxu", digest=rs_cuda.new_digest(
            14, "cpu"))
    with pytest.raises(ValueError, match="mxu"):
        rs_cuda.gf_apply(w, x, repack="mxu", out=False)


@pytest.mark.parametrize("formulation", ["bitplane", "xorsched"])
def test_coder_row_digests(formulation):
    """encode_async handles carry the [k + m] digest, equal to the
    reference's sums; reconstruction handles carry none."""
    coder = pcoder.TorchCoder(10, 4, device="cpu", formulation=formulation)
    rng = np.random.default_rng(31)
    data = rng.integers(0, 256, (10, 4099), dtype=np.uint8)
    handle = coder.encode_async(data)
    parity = coder.materialize(handle)
    assert np.array_equal(parity, rec.NumpyCoder(10, 4).encode(data))
    want = [int(r.astype(np.uint64).sum()) & MASK for r in [*data, *parity]]
    got = coder.row_digests(handle)
    assert got.dtype == np.uint32 and got.tolist() == want
    survivors = np.stack([data[i] for i in range(1, 10)] + [parity[0]])
    rh = coder.rec_apply_async(tuple(range(1, 11)), (0,))(survivors)
    assert np.array_equal(coder.materialize(rh)[0], data[0])
    assert coder.row_digests(rh) is None
    assert pcoder.NumpyCoder(10, 4).row_digests(parity) is None


# --- the slice: stream_encode's digests from the coder ---------------------

def _write_dat(path: str, size: int, seed: int) -> None:
    with open(path, "wb") as f:
        f.write(np.random.default_rng(seed).integers(
            0, 256, size, dtype=np.uint8).tobytes())


@pytest.mark.parametrize("formulation", ["bitplane", "xorsched"])
def test_stream_encode_takes_digests_from_the_coder(tmp_path, monkeypatch,
                                                   formulation):
    """Shards and .ecm byte-identical to the reference stream_encode's; the
    port's host sum is never called for TorchCoder (it is for
    NumpyCoder)."""
    geo = {"large_block_size": 262144, "small_block_size": 16384}
    pg, rg = pgeo.Geometry(**geo), rec.Geometry(**geo)
    os.mkdir(tmp_path / "port")
    os.mkdir(tmp_path / "ref")
    os.mkdir(tmp_path / "numpy")
    base = {k: str(tmp_path / k / "1") for k in ("port", "ref", "numpy")}
    _write_dat(base["ref"] + ".dat", 3_000_017, 41)
    for k in ("port", "numpy"):
        shutil.copyfile(base["ref"] + ".dat", base[k] + ".dat")
    rpipe.stream_encode(base["ref"], rec.get_coder("numpy", 10, 4), rg,
                        batch_size=65536, depth=2)
    real = ppipe.host_row_digests
    calls = []

    def refuse(rows):
        raise AssertionError("host sum reached for TorchCoder")

    monkeypatch.setattr(ppipe, "host_row_digests", refuse)
    coder = pcoder.TorchCoder(10, 4, device="cpu", formulation=formulation)
    ppipe.stream_encode(base["port"], coder, pg, batch_size=65536, depth=2)

    def counting(rows):
        calls.append(len(rows))
        return real(rows)

    monkeypatch.setattr(ppipe, "host_row_digests", counting)
    ppipe.stream_encode(base["numpy"], pcoder.NumpyCoder(10, 4), pg,
                        batch_size=65536, depth=2)
    assert calls and set(calls) == {14}
    for i in range(14):
        ext = pgeo.to_ext(i)
        with open(base["port"] + ext, "rb") as f, \
                open(base["ref"] + ext, "rb") as g:
            assert f.read() == g.read(), ext
    stamped = ppipe.read_stamped_digests(base["port"])
    assert stamped == rpipe.read_stamped_digests(base["ref"])
    assert stamped == ppipe.read_stamped_digests(base["numpy"])
    assert list(ppipe.shard_file_digest(base["port"], range(14))) == [
        stamped[i] for i in range(14)]
    with open(base["port"] + ".ecm") as f, open(base["ref"] + ".ecm") as g:
        assert json.load(f) == json.load(g)


@pytest.mark.parametrize("formulation", ["bitplane", "xorsched"])
def test_digest_window_accumulates_one_buffer(formulation):
    """The sinks' window hook adds every batch's digest-only launch into
    one [C + R] int32 buffer, across windows, equal to the reference's
    window digests."""
    coder = pcoder.TorchCoder(10, 4, device="cpu", formulation=formulation)
    ref = rec.NumpyCoder(10, 4)
    rng = np.random.default_rng(77)
    batches = [rng.integers(0, 256, (10, 5000), dtype=np.uint8)
               for _ in range(5)]
    acc = coder.encode_digest_window_async(
        [coder.stage_async(b) for b in batches[:2]])
    buf = acc.acc
    acc = coder.encode_digest_window_async(
        [coder.stage_async(b) for b in batches[2:]], acc)
    assert acc.acc is buf and buf.dtype == torch.int32
    assert buf.shape == (14,)
    racc = ref.encode_digest_window_async(batches)
    assert coder.materialize(acc).tolist() == np.asarray(racc).tolist()
    present = tuple(range(1, 11))
    parity = [ref.encode(b) for b in batches]
    stacks = [np.vstack([b[1:], p[:1]]) for b, p in zip(batches, parity)]
    racc = ref.rec_digest_window_async(present, (0,), stacks)
    got = coder.rec_digest_window_async(
        present, (0,), [coder.stage_async(s) for s in stacks])
    assert coder.materialize(got).tolist() == np.asarray(racc).tolist()


# --- the walk serves every matrix ------------------------------------------

@pytest.mark.parametrize("k,m", [(10, 4), (20, 4), (6, 3)])
def test_walk_fits_every_geometry_with_and_without_digest(k, m):
    """The kernel walks the grouped program of every geometry's parity and
    reconstruction matrices (the policy's 10+4 and 20+4 among them), with
    and without the digest's C + R sums per thread: a block of at least
    128 threads fits the shared memory, and the grouped program fits no
    fewer threads than the one-op-at-a-time lowering."""
    for mat in [gf256.parity_matrix(k, m), _rec_matrix(k, m, VICTIMS[:m]),
                _rec_matrix(k, m, (0,))]:
        sched = pxs.schedule_for_matrix(mat)
        prog = pxs.lower_schedule_grouped(sched)
        for digest in (False, True):
            threads, smem = rs_cuda.xorsched_launch(prog, digest)
            assert threads >= 128 and threads % 32 == 0
            assert smem <= rs_cuda.SMEM_LIMIT
            assert threads >= rs_cuda.xorsched_launch(
                pxs.lower_schedule(sched), digest)[0]
