"""The port's MXU-repack variant against the JAX reference.

``rs_torch.gf_apply_mxu`` (the plain version of ``csrc/gf_mxu.cu``) must
give the reference's ``gf_apply_pallas(..., repack="mxu")`` in Pallas
interpret mode on the cases of tests/test_rs_pallas.py, and the port's
``gf_apply`` at the edges of the kernel's range (R = 1, C = 32, ragged
widths). ``mxu_replica`` repeats the kernel's register arithmetic in
numpy lane by lane -- the 32-bit row loads, the A registers (a byte
broadcast and a bit mask) in the kernel's K order, the column mapping of
a 64-column span, W and the repack weights as the kernel lays them out
in shared memory (scaled so that every product term is 128 times a bit)
and read back through wgmma's canonical layout, each warp's 16 rows of
the m64nNk32 fragments (the mma.sync m16n8k32 layouts), the
accumulators fed to the repack as its A registers, and the packed output
words -- so that the index
arithmetic of the CUDA source is held against the plain version on the
CPU. Bit equality everywhere.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from seaweedfs_torch.ops import gf256 as pgf
from seaweedfs_torch.ops import rs_cuda, rs_torch
from seaweedfs_tpu.ops import gf256, rs_pallas

# the constants of csrc/gf_mxu.cu
SPAN, GROUP = 64, 4  # columns per warp step; output rows per grid.y group
LO_BITS, HI_BITS = 0x08040201, 0x80402010
TILE_BYTES = 1024  # one k-tile of W' in shared memory
B2_BYTES = 256  # one output row's repack weights


def _w_offset(n, k):
    """Byte offset of W'[n, k] in a k-tile: wgmma's K-major interleaved
    layout, core matrices of 8 n x 16 k bytes, n-groups 128 bytes apart,
    k-halves 512."""
    return (k >> 4) * 512 + (n >> 3) * 128 + (n & 7) * 16 + (k & 15)


def _b2_offset(n, k):
    return (k >> 4) * 128 + n * 16 + (k & 15)


def _lanes():
    lane = np.arange(32)
    return lane >> 2, lane & 3


def _fragment_maps():
    """(A rows, A cols) [32, 16], (B k, B n) [32, 8], (D row, D col)
    [32, 4] of one m16n8k32 8-bit product, per the PTX ISA's fragment
    layouts (element i of a lane is byte i of its registers)."""
    g, t = _lanes()
    i = np.arange(16)[None, :]
    a_row = np.where((i < 4) | ((i >= 8) & (i < 12)), g[:, None],
                     g[:, None] + 8)
    a_col = t[:, None] * 4 + (i & 3) + np.where(i >= 8, 16, 0)
    i = np.arange(8)[None, :]
    b_k = t[:, None] * 4 + (i & 3) + np.where(i >= 4, 16, 0)
    b_n = np.broadcast_to(g[:, None], b_k.shape)
    e = np.arange(4)[None, :]
    d_row = g[:, None] + 8 * (e >> 1)
    d_col = 2 * t[:, None] + (e & 1)
    return (a_row, a_col), (b_k, b_n), (d_row, d_col)


FRAG = _fragment_maps()


def _mma(acc: np.ndarray, a: np.ndarray, b0: np.ndarray,
         b1: np.ndarray, dtype=np.uint8) -> np.ndarray:
    """acc [32, 4] += the m16n8k32 product of the warp's fragments, their
    bytes read as `dtype` (uint8: the kernel's .u8.u8; int8: .s8.s8)."""
    (a_row, a_col), (b_k, b_n), (d_row, d_col) = FRAG
    A = np.zeros((16, 32), np.int64)
    A[a_row, a_col] = a.astype("<u4").view(dtype).reshape(32, 16)
    B = np.zeros((32, 8), np.int64)
    B[b_k, b_n] = np.stack([b0, b1], 1).astype("<u4").view(
        dtype).reshape(32, 8)
    return acc + (A @ B)[d_row, d_col]


def _word(byte_cols: list) -> np.ndarray:
    """Four per-lane byte arrays -> the per-lane words (byte q = item q)."""
    return sum(np.asarray(v, np.uint32) << (8 * q)
               for q, v in enumerate(byte_cols)).astype(np.uint32)


def _byte_perm(x: np.ndarray, y: np.ndarray, sel: int) -> np.ndarray:
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of
    the 8 bytes {y, x} (x the low four)."""
    both = (np.asarray(y, np.uint64) << 32) | np.asarray(x, np.uint64)
    return _word([(both >> np.uint64(8 * ((sel >> (4 * i)) & 7)))
                  & np.uint64(0xFF) for i in range(4)])


def k_order(cols: int) -> np.ndarray:
    """The kernel's K order: for k in [0, 32 * ceil(C/4)) the port column
    8c + j of W that k stands for (k = 32(c/4) + 16(j/4) + 4(c%4) + j%4),
    -1 where c is the padding past C."""
    k = np.arange(32 * -(-cols // 4))
    c = 4 * (k >> 5) + ((k >> 2) & 3)
    j = 4 * ((k >> 4) & 1) + (k & 3)
    return np.where(c < cols, 8 * c + j, -1)


def _load_word(x: np.ndarray, c: np.ndarray, col: np.ndarray) -> np.ndarray:
    """Per lane, bytes col..col+3 of row c (zeros past n or C)."""
    C, n = x.shape
    return _word([np.where((c < C) & (col + b < n),
                           x[np.minimum(c, C - 1), np.minimum(col + b, n - 1)],
                           0) for b in range(4)])


def mxu_replica(w: np.ndarray, x: np.ndarray) -> np.ndarray:
    """csrc/gf_mxu.cu's arithmetic in numpy, lane by lane: W [8R, 8C] int8
    (the port's order) applied to x [C, n] uint8 -> [R, n] uint8."""
    R, C, n = w.shape[0] // 8, x.shape[0], x.shape[1]
    KT = -(-C // 4)
    order = k_order(C)
    wb = w.view(np.uint8).astype(np.uint32)
    g, t = _lanes()
    out = np.zeros((R, n), np.uint8)
    # B2 of output row u in shared memory: k2 = 4tq goes to column 2u
    # and k2 = 16 + 4tq to column 2u + 1, weighted 2^(2tq), zero
    # elsewhere; its B fragments read back through the layout
    sB2 = np.zeros(GROUP * B2_BYTES, np.uint32)
    for idx in range(GROUP * B2_BYTES):
        u, nn, k = idx >> 8, (idx >> 5) & 7, idx & 31
        if k & 3 == 0 and nn == 2 * u + (k >> 4):
            sB2[u * B2_BYTES + _b2_offset(nn, k)] = 1 << (2 * ((k >> 2) & 3))
    b2 = [[_word([sB2[u * B2_BYTES + _b2_offset(g, 16 * s + 4 * t + q)]
                  for q in range(4)]) for s in range(2)]
          for u in range(GROUP)]
    for gy in range(-(-R // GROUP)):
        r0 = GROUP * gy
        # W' in shared memory, as the kernel fills it: B[k, n] for
        # n = 8nt + i is W[8r + i, 8c + j] << (7 - j), with 8c + j the
        # column that k_order gives k; the B fragment of n-tile nt is read
        # back through the layout (k = 16s + 4t + q, n = g)
        sW = np.zeros(KT * TILE_BYTES, np.uint32)
        for idx in range(KT * TILE_BYTES):
            kt, nn, k = idx >> 10, (idx >> 5) & 31, idx & 31
            r, col = r0 + (nn >> 3), order[32 * kt + k]  # col = 8c + j
            if r < R and col >= 0:
                sW[kt * TILE_BYTES + _w_offset(nn, k)] = (
                    wb[8 * r + (nn & 7), col] << (7 - (col & 7))) & 0xFF
        b = np.zeros((KT, GROUP, 2, 32), np.uint32)
        for kt in range(KT):
            for nt in range(GROUP):
                for s in range(2):
                    b[kt, nt, s] = _word([
                        sW[kt * TILE_BYTES + _w_offset(8 * nt + g,
                                                       16 * s + 4 * t + q)]
                        for q in range(4)])
        for base in range(0, n, SPAN):
            # a lane's words: columns base + 4g + 32h .. +3 of row 4kt + t
            wv = [[_load_word(x, 4 * kt + t, base + 4 * g + 32 * h)
                   for h in range(2)] for kt in range(KT)]
            o = [None] * 2
            for e in range(4):
                acc = np.zeros((GROUP, 32, 4), np.int64)
                for kt in range(KT):
                    u0 = _byte_perm(wv[kt][0], 0, 0x1111 * e)
                    u1 = _byte_perm(wv[kt][1], 0, 0x1111 * e)
                    a = np.stack([u0 & LO_BITS, u1 & LO_BITS, u0 & HI_BITS,
                                  u1 & HI_BITS], 1)
                    for nt in range(GROUP):
                        acc[nt] = _mma(acc[nt], a, b[kt, nt, 0],
                                       b[kt, nt, 1])
                assert not (acc % 128).any()
                # the repack of output row u takes its four accumulators
                # as its A registers as they are (byte 0 = 128 * the bit,
                # bytes 1-3 meet zero weights)
                d = np.zeros((32, 4), np.int64)
                for u in range(GROUP):
                    d = _mma(d, acc[u] & 0xFFFFFFFF, b2[u][0], b2[u][1])
                assert d.max() <= 128 * 170 and not (d % 128).any()
                for h in range(2):
                    v = (d[:, h] + 2 * d[:, 2 + h]).astype(np.uint32)
                    o[h] = v >> 7 if e == 0 else (o[h] + (v << (8 * e - 7))
                                                   ) & 0xFFFFFFFF
            # lane t stores row r0 + t, columns base + 32h + 4g .. +3,
            # masked past R and n
            for h in range(2):
                row = r0 + t
                col = base + 32 * h + 4 * g
                for lane in np.flatnonzero(row < R):
                    for byte in range(4):
                        if col[lane] + byte < n:
                            out[row[lane], col[lane] + byte] = (
                                int(o[h][lane]) >> (8 * byte)) & 0xFF
    return out


def _operands(mat: np.ndarray, x: np.ndarray):
    return rs_torch.load_matrix(mat, "cpu"), torch.from_numpy(x)


def test_nibble_weights_match_reference():
    for rows in (1, 4, 5, 32):
        assert np.array_equal(rs_torch.nibble_weights(rows),
                              rs_pallas._nibble_weights(rows))


def test_plain_mxu_matches_pallas_interpret():
    """The two cases of test_rs_pallas.py's mxu test: RS(10,4) parity on
    [10, 2048] and a random [5, 9] matrix on [9, 1024]."""
    rng = np.random.default_rng(23)
    data = rng.integers(0, 256, (10, 2048), dtype=np.uint8)
    pm = gf256.parity_matrix(10, 4)
    want = np.asarray(rs_pallas.gf_apply_pallas(
        pm, tile=1024, interpret=True, repack="mxu")(data))
    got = rs_torch.gf_apply_mxu(*_operands(pm, data)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, gf256.encode_parity(data, 4))
    mat = rng.integers(0, 256, (5, 9)).astype(np.uint8)
    d2 = rng.integers(0, 256, (9, 1024), dtype=np.uint8)
    want2 = np.asarray(rs_pallas.gf_apply_pallas(
        mat, tile=1024, interpret=True, repack="mxu")(d2))
    got2 = rs_torch.gf_apply(*_operands(mat, d2), repack="mxu").numpy()
    assert np.array_equal(got2, want2)
    assert np.array_equal(got2, pgf.gf_matrix_apply(mat, d2))


@pytest.mark.parametrize("rows,cols,n", [(1, 32, 777), (32, 32, 300),
                                         (4, 10, 1), (3, 7, 1025)])
def test_plain_mxu_matches_gf_apply_at_the_edges(rows, cols, n):
    rng = np.random.default_rng(rows * 100 + cols)
    mat = rng.integers(0, 256, (rows, cols)).astype(np.uint8)
    x = rng.integers(0, 256, (cols, n), dtype=np.uint8)
    w, xt = _operands(mat, x)
    got = rs_torch.gf_apply_mxu(w, xt)
    assert torch.equal(got, rs_torch.gf_apply(w, xt))
    assert np.array_equal(got.numpy(), pgf.gf_matrix_apply(mat, x))


@pytest.mark.parametrize("rows,cols,n", [(4, 10, 256), (1, 10, 131),
                                         (1, 32, 100), (32, 32, 128),
                                         (17, 3, 260), (5, 9, 1),
                                         (9, 10, 200), (32, 10, 70),
                                         (4, 20, 190), (4, 32, 129),
                                         (2, 1, 67), (6, 13, 3)])
def test_kernel_replica_matches_plain(rows, cols, n):
    """The kernel's register arithmetic (numpy) against the plain
    version: one and several 64-column spans and widths that are not a
    multiple of one (ragged tails), row groups on grid.y (R = 9, 17, 32:
    3, 5 and 8 groups; R = 1, 2, 5, 6 a part group), K padded to whole row
    groups (C = 1, 3, 9, 10, 13) and K = 160 and 256 (C = 20, 32)."""
    rng = np.random.default_rng(rows * 1000 + cols * 10 + n)
    mat = rng.integers(0, 256, (rows, cols)).astype(np.uint8)
    x = rng.integers(0, 256, (cols, n), dtype=np.uint8)
    w, xt = _operands(mat, x)
    got = mxu_replica(w.numpy(), x)
    assert np.array_equal(got, rs_torch.gf_apply_mxu(w, xt).numpy())


@pytest.mark.parametrize("rows,cols", [(4, 10), (4, 20), (3, 7), (2, 32)])
def test_kernel_k_order_is_the_reference_plane_major_regrouped(rows, cols):
    """The kernel's W' (W's columns gathered in its K order, pads zero)
    holds, at k = 32(c/4) + 16(j/4) + 4(c%4) + j%4, column j*C + c of the
    reference's
    plane-major matrix (rs_pallas._plane_major_matrix) with its rows put
    back in the port's order: the two orders are one permutation of the
    port's W apart."""
    rng = np.random.default_rng(rows * 100 + cols)
    mat = rng.integers(0, 256, (rows, cols)).astype(np.uint8)
    w = rs_torch.bitplane_matrix(mat)
    order = k_order(cols)
    w_kernel = np.where(order >= 0, w[:, np.maximum(order, 0)], 0)
    pm = rs_pallas._plane_major_matrix(mat)
    back = np.empty_like(pm)
    back[[r * 8 + i for i in range(8) for r in range(rows)]] = pm
    k = np.arange(order.size)
    c, j = 4 * (k >> 5) + ((k >> 2) & 3), 4 * ((k >> 4) & 1) + (k & 3)
    from_ref = np.where(c < cols, back[:, np.minimum(j * cols + c,
                                                     pm.shape[1] - 1)], 0)
    assert np.array_equal(w_kernel, from_ref)
    assert sorted(order[order >= 0]) == list(range(8 * cols))


def test_u8_fragment_product_matches_matmul():
    """_mma with u8 operands (the kernel's .u8.u8 products) equals the
    16x32 by 32x8 product of the matrices its fragments hold, for bytes up
    to 255 (the repack's weight 128 is negative as s8)."""
    rng = np.random.default_rng(5)
    A = rng.integers(0, 256, (16, 32))
    B = rng.integers(0, 256, (32, 8))
    (a_row, a_col), (b_k, b_n), (d_row, d_col) = FRAG
    a = A[a_row, a_col].astype(np.uint8).reshape(32, 4, 4)
    a = a.view("<u4").reshape(32, 4)
    bb = B[b_k, b_n].astype(np.uint8).reshape(32, 2, 4).view(
        "<u4").reshape(32, 2)
    got = _mma(np.zeros((32, 4), np.int64), a, bb[:, 0], bb[:, 1])
    assert np.array_equal(got, (A @ B)[d_row, d_col])
    signed = _mma(np.zeros((32, 4), np.int64), a, bb[:, 0], bb[:, 1],
                  dtype=np.int8)
    assert not np.array_equal(signed, got)


def test_cuda_entry_on_cpu_runs_plain_and_counts_nothing():
    rng = np.random.default_rng(3)
    pm = gf256.parity_matrix(10, 4)
    x = rng.integers(0, 256, (10, 999), dtype=np.uint8)
    w, xt = _operands(pm, x)
    before = (rs_cuda.gf_apply.launches, rs_cuda.gf_apply_mxu.launches)
    got = rs_cuda.gf_apply(w, xt, repack="mxu")
    assert np.array_equal(got.numpy(), gf256.encode_parity(x, 4))
    assert torch.equal(rs_cuda.gf_apply_mxu(w, xt), got)
    assert (rs_cuda.gf_apply.launches,
            rs_cuda.gf_apply_mxu.launches) == before
    for fn in (rs_cuda.gf_apply, rs_torch.gf_apply):
        with pytest.raises(ValueError):
            fn(w, xt, repack="int4")


@pytest.mark.parametrize("instr", rs_cuda.MXU_INSTRS)
def test_cuda_entry_instr_on_cpu_runs_plain(instr):
    """Either products' instruction gives the plain version on the CPU and
    counts nothing; an unknown one raises before anything runs."""
    rng = np.random.default_rng(4)
    mat = rng.integers(0, 256, (5, 13)).astype(np.uint8)
    x = rng.integers(0, 256, (13, 333), dtype=np.uint8)
    w, xt = _operands(mat, x)
    before = rs_cuda.gf_apply_mxu.launches
    got = rs_cuda.gf_apply_mxu(w, xt, instr=instr)
    assert np.array_equal(got.numpy(), pgf.gf_matrix_apply(mat, x))
    assert rs_cuda.gf_apply_mxu.launches == before
    with pytest.raises(ValueError):
        rs_cuda.gf_apply_mxu(w, xt, instr="hmma")


def _fake_sass(name: str, body: list) -> str:
    """A cuobjdump -sass dump of one function whose loop is `body`."""
    lines = [f"\n        Function : {name}",
             "        /*0000*/    MOV R1, c[0x0][0x28] ;"]
    for i, op in enumerate(body):
        lines.append(f"        /*{16 * (i + 1):04x}*/    {op} ;")
    lines.append(f"        /*{16 * (len(body) + 1):04x}*/    BRA 0x10 ;")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("wgmma", [True, False])
def test_sass_counts_per_16_columns(wgmma):
    """scripts/torch_sass_ops.py's mxu_counts on a made-up dump: a loop of
    two m-tiles at 3 k-tiles (7 wgmma or 16 mma.sync each, 10 integer
    instructions, one load) gives 32 columns and the counts per 16."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    import torch_sass_ops as so
    mma = ("IGMMA.64x32x32.U8.U8 R24, R56, gdesc[UR12], R24, gsb0"
           if wgmma else "IMMA.16832.U8.U8 R4, R8, R12, R4")
    tile = [mma] * (7 if wgmma else 16) + ["LOP3.LUT R1, R2, R3, RZ"] * 10
    tile += ["LDG.E R5, desc[UR4][R6.64]"]
    name = f"_ZN9_GLOBAL13gf_mxu_kernelILi3ELb{int(wgmma)}EEEvPKaiiPKhPhxi"
    got = so.mxu_counts(_fake_sass(name, tile * 2), wgmma=wgmma)
    assert got["columns_per_loop"] == 32
    assert got["mma"] == (7 if wgmma else 16)
    assert got["alu"] == 10 and got["global_or_local"] == 1
