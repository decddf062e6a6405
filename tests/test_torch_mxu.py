"""The port's MXU-repack variant against the JAX reference.

``rs_torch.gf_apply_mxu`` (the plain version of ``csrc/gf_mxu.cu``) must
give the reference's ``gf_apply_pallas(..., repack="mxu")`` in Pallas
interpret mode on the cases of tests/test_rs_pallas.py, and the port's
``gf_apply`` at the edges of the kernel's range (R = 1, C = 32, ragged
widths). ``mxu_replica`` repeats the kernel's tile arithmetic in numpy
step by step -- the bit-plane expansion, K and M padding, the mma.sync
m16n8k32 fragment layouts, the ``& 1`` relayout into the repack's operand
and the nibble weights in the port's row order -- so that the index
arithmetic of the CUDA source is held against the plain version on the
CPU. Bit equality everywhere.
"""

import numpy as np
import pytest
import torch

from seaweedfs_torch.ops import gf256 as pgf
from seaweedfs_torch.ops import rs_cuda, rs_torch
from seaweedfs_tpu.ops import gf256, rs_pallas

# the constants of csrc/gf_mxu.cu
TILE_N, WARPS, SKEW = 128, 4, 16
WARP_N = TILE_N // WARPS
NT = WARP_N // 8


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _lanes():
    lane = np.arange(32)
    return lane >> 2, lane & 3


def _fragment_maps():
    """(A rows, A cols) [32, 16], (B k, B n) [32, 8], (D row, D col)
    [32, 4] of one m16n8k32 s8 product, per the PTX ISA's fragment
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


def _ld32(buf: np.ndarray, off: np.ndarray) -> np.ndarray:
    return (buf[off].astype(np.uint32) | buf[off + 1].astype(np.uint32) << 8
            | buf[off + 2].astype(np.uint32) << 16
            | buf[off + 3].astype(np.uint32) << 24)


def _load_a(s: np.ndarray, stride: int, row0: int, k0: int) -> np.ndarray:
    g, t = _lanes()
    p = (row0 + g) * stride + k0 + 4 * t
    return np.stack([_ld32(s, p), _ld32(s, p + 8 * stride),
                     _ld32(s, p + 16), _ld32(s, p + 8 * stride + 16)], 1)


def _mma(acc: np.ndarray, a: np.ndarray, b0: np.ndarray,
         b1: np.ndarray) -> np.ndarray:
    """acc [32, 4] += the m16n8k32 product of the warp's fragments."""
    (a_row, a_col), (b_k, b_n), (d_row, d_col) = FRAG
    A = np.zeros((16, 32), np.int64)
    A[a_row, a_col] = a.astype("<u4").view(np.int8).reshape(32, 16)
    B = np.zeros((32, 8), np.int64)
    B[b_k, b_n] = np.stack([b0, b1], 1).astype("<u4").view(
        np.int8).reshape(32, 8)
    return acc + (A @ B)[d_row, d_col]


def mxu_replica(w: np.ndarray, x: np.ndarray) -> np.ndarray:
    """csrc/gf_mxu.cu's arithmetic in numpy: W [8R, 8C] int8 (the port's
    order) applied to x [C, n] uint8 -> [R, n] uint8."""
    R, C, n = w.shape[0] // 8, x.shape[0], x.shape[1]
    m1, k1 = _round_up(8 * R, 16), _round_up(8 * C, 32)
    m2, k2 = _round_up(R, 16), _round_up(4 * R, 32)
    sw = sb = k1 + SKEW
    sw2 = sl = k2 + SKEW
    sW = np.zeros(m1 * sw, np.uint8)
    for m in range(8 * R):
        sW[m * sw:m * sw + 8 * C] = w[m].view(np.uint8)
    sW2 = np.zeros(m2 * sw2, np.uint8)
    for i in range(4 * R):
        sW2[(i // 4) * sw2 + i] = 1 << (i % 4)
    sB = np.zeros(TILE_N * sb, np.uint8)
    sL = np.zeros(2 * TILE_N * sl, np.uint8)
    out = np.zeros((R, n), np.uint8)
    g, t = _lanes()
    for col0 in range(0, n, TILE_N):
        # 1. expansion: bytes 8c..8c+7 of column col are bits 0..7
        tile = np.zeros((C, TILE_N), np.uint32)
        tile[:, :min(TILE_N, n - col0)] = x[:, col0:col0 + TILE_N]
        lo = ((tile & 0xF) * 0x00204081) & 0x01010101
        hi = ((tile >> 4) * 0x00204081) & 0x01010101
        words = np.stack([lo, hi], -1).astype("<u4")       # [C, N, 2]
        planes = words.view(np.uint8).reshape(C, TILE_N, 8)
        for c in range(C):
            for col in range(TILE_N):
                sB[col * sb + 8 * c:col * sb + 8 * c + 8] = planes[c, col]
        # 2-3. product and & 1 relayout, warp by warp
        for warp in range(WARPS):
            ncol0 = warp * WARP_N
            for mt in range(m1 // 16):
                acc = np.zeros((NT, 32, 4), np.int64)
                for kt in range(k1 // 32):
                    a = _load_a(sW, sw, mt * 16, kt * 32)
                    for j in range(NT):
                        p = (ncol0 + 8 * j + g) * sb + kt * 32 + 4 * t
                        acc[j] = _mma(acc[j], a, _ld32(sB, p),
                                      _ld32(sB, p + 16))
                # row mt*16 + g + 8*(e>>1) is W row 8r + g, r = 2mt + e>>1
                lsb = ((g >> 2) * TILE_N + ncol0 + 2 * t) * sl + (g & 3)
                for j in range(NT):
                    for e in range(4):
                        r = 2 * mt + (e >> 1)
                        if r < R:
                            sL[lsb + (8 * j + (e & 1)) * sl + 4 * r] = (
                                acc[j, :, e] & 1)
        # 4. nibble products and the byte
        s_out = np.zeros((R, TILE_N), np.uint8)
        for warp in range(WARPS):
            ncol0 = warp * WARP_N
            for mt in range(m2 // 16):
                los = np.zeros((NT, 32, 4), np.int64)
                his = np.zeros((NT, 32, 4), np.int64)
                for kt in range(k2 // 32):
                    a = _load_a(sW2, sw2, mt * 16, kt * 32)
                    for j in range(NT):
                        p = (ncol0 + 8 * j + g) * sl + kt * 32 + 4 * t
                        q = TILE_N * sl + p
                        los[j] = _mma(los[j], a, _ld32(sL, p),
                                      _ld32(sL, p + 16))
                        his[j] = _mma(his[j], a, _ld32(sL, q),
                                      _ld32(sL, q + 16))
                for j in range(NT):
                    for e in range(4):
                        r = mt * 16 + g + 8 * (e >> 1)
                        col = ncol0 + 8 * j + 2 * t + (e & 1)
                        ok = r < R
                        s_out[r[ok], col[ok]] = (
                            los[j, :, e] | (his[j, :, e] << 4))[ok]
        width = min(TILE_N, n - col0)
        out[:, col0:col0 + width] = s_out[:, :width]
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
                                         (17, 3, 260), (5, 9, 1)])
def test_kernel_replica_matches_plain(rows, cols, n):
    """The kernel's tile arithmetic (numpy) against the plain version:
    one and several tiles, ragged tails, M padded (R = 1, 17) and K padded
    (C = 3, 9, 10), two repack m-tiles (R = 17, 32)."""
    rng = np.random.default_rng(rows * 1000 + cols * 10 + n)
    mat = rng.integers(0, 256, (rows, cols)).astype(np.uint8)
    x = rng.integers(0, 256, (cols, n), dtype=np.uint8)
    w, xt = _operands(mat, x)
    got = mxu_replica(w.numpy(), x)
    assert np.array_equal(got, rs_torch.gf_apply_mxu(w, xt).numpy())


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
