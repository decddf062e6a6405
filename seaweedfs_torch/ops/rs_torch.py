"""Plain PyTorch GF(2^8) matrix application by bit-plane expansion.

The port's counterpart of ``seaweedfs_tpu/ops/rs_jax.py``'s
``bitplane_matrix`` / ``gf_apply_bitplane_dyn``: multiplication by a
GF(2^8) constant is linear over GF(2), so a coefficient matrix [R, C]
expands to a binary matrix W [8R, 8C] acting on the bit-planes of the
input bytes, and applying the code is one integer product, ``& 1`` and a
byte repack.

W is the port's matrix operand: ``load_matrix`` turns a coefficient
matrix (as the reference produces it, numpy) into W on a device, and both
this plain version and the hand-written kernel (``rs_cuda.gf_apply``)
take it as runtime data, so one kernel serves the parity matrix and every
reconstruction matrix. This module is the plain version: the CPU tests
and the on-card comparison use it; the coder runs it only for tensors on
the CPU.

``gf_apply_mxu`` (or ``gf_apply(..., repack="mxu")``) is the plain
version of the reference's MXU-repack variant (``rs_pallas.py:
_gf_kernel_mxu_repack``): the same product and ``& 1``, then the byte
repack as two nibble products with ``nibble_weights``; its kernel is
``rs_cuda.gf_apply_mxu``. No coder selects it, as none of the reference's
does.

``gf_apply_xorsched`` is the plain version of the second formulation
(``rs_jax.gf_apply_xorsched``): the same output from the matrix's XOR
schedule (``xor_schedule``) run over packed bit-plane words; its kernel
is ``rs_cuda.gf_apply_xorsched``. ``formulation_env`` reads the
``WEED_EC_FORMULATION`` pin by the reference's rules.

``row_digest`` is the plain version of both kernels' digest epilogue: the
wrapping uint32 byte sum of each row (the reference's shard digest), as
int64 values in [0, 2^32). ``gf_apply_digest`` and
``gf_apply_xorsched_digest`` return a product with its [C + R] digest,
the input rows' sums first, as the kernels lay it out.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import gf256, xor_schedule

# the formulations the WEED_EC_FORMULATION pin may name, as in the
# reference's rs_jax.FORMULATIONS (the port's coder runs bitplane and
# xorsched; lut pins the bitplane kernel, as it does for PallasCoder)
FORMULATIONS = ("bitplane", "lut", "xorsched")

# the byte repacks of the bit-plane kernel, as the reference's
# gf_apply_pallas(repack=) names them: an 8-step shift/or chain, or two
# nibble products on the matrix unit
REPACKS = ("vpu", "mxu")

# columns per product: bounds the [8C, chunk] float32 bit-plane temporary
# (at C = 32 and 2^20 columns, 1 GiB)
_CHUNK = 1 << 20


def bitplane_matrix(matrix: np.ndarray) -> np.ndarray:
    """Expand a GF(2^8) coefficient matrix [R, C] to binary [8R, 8C] int8.

    W[r*8+i, c*8+j] = bit i of (matrix[r,c] * 2^j in GF(2^8)), so for byte
    vectors x: bit i of out[r] = sum_{c,j} W[r*8+i, c*8+j] * bit j of x[c]
    mod 2. Same layout as the reference's ``rs_jax.bitplane_matrix``.
    """
    matrix = np.asarray(matrix, dtype=np.uint8)
    r, c = matrix.shape
    prods = gf256.mul_table()[matrix[:, :, None],
                              (1 << np.arange(8))[None, None, :]]  # [R,C,j]
    bits = (prods[:, :, :, None] >> np.arange(8)) & 1             # [R,C,j,i]
    return bits.transpose(0, 3, 1, 2).reshape(r * 8, c * 8).astype(np.int8)


def pad_rows(matrix: np.ndarray, rows: int | None) -> np.ndarray:
    """The coefficient matrix [R, C] zero-padded to `rows` rows (when
    rows > R): zero rows rebuild zeros, which is how a reconstruction
    matrix for fewer victims than parity shards takes the parity matrix's
    [m, k] shape (the caller slices the pad rows off)."""
    matrix = np.asarray(matrix, dtype=np.uint8)
    if rows is not None and rows > matrix.shape[0]:
        matrix = np.vstack([matrix, np.zeros(
            (rows - matrix.shape[0], matrix.shape[1]), dtype=np.uint8)])
    return matrix


def load_matrix(matrix: np.ndarray, device: torch.device | str,
                rows: int | None = None) -> torch.Tensor:
    """Coefficient matrix [R, C] (numpy, as the reference produces it) ->
    the port's operand W [8*rows, 8C] int8 on `device`, zero-padded to
    `rows` rows by ``pad_rows``."""
    return torch.from_numpy(bitplane_matrix(pad_rows(matrix, rows))).to(
        device)


def unpack_bits(x: torch.Tensor) -> torch.Tensor:
    """[C, n] uint8 -> [8C, n] int32 bit-planes (bit j of byte c at row
    c*8+j)."""
    c, n = x.shape
    shifts = torch.arange(8, dtype=torch.int32, device=x.device)
    bits = (x.to(torch.int32)[:, None, :] >> shifts[None, :, None]) & 1
    return bits.reshape(c * 8, n)


def pack_bits(bits: torch.Tensor, rows: int) -> torch.Tensor:
    """[8R, n] int 0/1 planes -> [R, n] uint8 (planes are disjoint bit
    positions, so the weighted sum is an OR)."""
    n = bits.shape[1]
    shifts = torch.arange(8, dtype=torch.int32, device=bits.device)
    b = bits.reshape(rows, 8, n).to(torch.int32) << shifts[None, :, None]
    return b.sum(dim=1).to(torch.uint8)


def nibble_weights(rows: int) -> np.ndarray:
    """[rows, 4*rows] int8 selector of the MXU repack, as the reference's
    ``rs_pallas._nibble_weights``: out[r] = sum_i 2^i * planes[i*rows+r]
    over 4 plane-major planes (two of these products cover the 8)."""
    w2 = np.zeros((rows, 4 * rows), dtype=np.int8)
    for i in range(4):
        for r in range(rows):
            w2[r, i * rows + r] = 1 << i
    return w2


def _check_operands(w: torch.Tensor, x: torch.Tensor) -> None:
    if w.dim() != 2 or x.dim() != 2 or w.shape[1] != 8 * x.shape[0]:
        raise ValueError(
            f"gf_apply: W {tuple(w.shape)} does not fit x {tuple(x.shape)}")


def gf_apply(w: torch.Tensor, x: torch.Tensor,
             repack: str = "vpu") -> torch.Tensor:
    """Plain version: W [8R, 8C] int8 applied to x [C, n] uint8 -> [R, n]
    uint8, on x's device. repack="mxu" is ``gf_apply_mxu``.

    The integer product runs as a float32 matrix product: every term is a
    0/1 product and every row sum is at most 8C <= 256, which float32 (and
    TF32, whose 10-bit mantissa holds 0 and 1 exactly and which
    accumulates in float32) represents exactly; PyTorch has no integer
    matrix product on CUDA. ``& 1`` then recovers the XOR."""
    if repack not in REPACKS:
        raise ValueError(f"gf_apply: unknown repack {repack!r}; have "
                         f"{REPACKS}")
    if repack == "mxu":
        return gf_apply_mxu(w, x)
    _check_operands(w, x)
    rows = w.shape[0] // 8
    n = x.shape[1]
    wf = w.to(device=x.device, dtype=torch.float32)
    out = torch.empty((rows, n), dtype=torch.uint8, device=x.device)
    for lo in range(0, n, _CHUNK):
        hi = min(lo + _CHUNK, n)
        acc = wf @ unpack_bits(x[:, lo:hi]).to(torch.float32)
        out[:, lo:hi] = pack_bits(acc.to(torch.int32) & 1, rows)
    return out


def gf_apply_mxu(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the MXU-repack variant: the product and ``& 1`` of
    ``gf_apply``, then the planes in plane-major order (i*R + r, as the
    reference's kernel holds them) repacked by two nibble products,
    ``lo = W2 . planes[:4R]`` and ``hi = W2 . planes[4R:]``, out = lo | hi
    << 4. The products run in float32, which holds these sums (at most 15)
    exactly."""
    _check_operands(w, x)
    rows = w.shape[0] // 8
    n = x.shape[1]
    wf = w.to(device=x.device, dtype=torch.float32)
    w2 = torch.from_numpy(nibble_weights(rows)).to(device=x.device,
                                                   dtype=torch.float32)
    out = torch.empty((rows, n), dtype=torch.uint8, device=x.device)
    for lo in range(0, n, _CHUNK):
        hi = min(lo + _CHUNK, n)
        acc = wf @ unpack_bits(x[:, lo:hi]).to(torch.float32)
        lsb = (acc.to(torch.int32) & 1).reshape(rows, 8, hi - lo)
        planes = lsb.transpose(0, 1).reshape(8 * rows, hi - lo).to(
            torch.float32)
        low = (w2 @ planes[:4 * rows]).to(torch.int32)
        high = (w2 @ planes[4 * rows:]).to(torch.int32)
        out[:, lo:hi] = (low | (high << 4)).to(torch.uint8)
    return out


def gf_apply_xorsched(sched: xor_schedule.XorSchedule,
                      x: torch.Tensor) -> torch.Tensor:
    """Plain version of the XOR-schedule kernel: x [C, n] uint8 ->
    [R, n] uint8 on x's device, where the schedule was built for a
    coefficient matrix [R, C] (``xor_schedule.schedule_for_matrix``):
    pack the bit-planes, run the schedule, unpack."""
    if x.dim() != 2 or 8 * x.shape[0] != sched.n_in:
        raise ValueError(f"gf_apply_xorsched: schedule for {sched.n_in} "
                         f"input planes does not fit x {tuple(x.shape)}")
    n = x.shape[1]
    planes = xor_schedule.pack_planes(x)
    out = xor_schedule.run_schedule(sched, planes)
    return xor_schedule.unpack_planes(out, n)


def row_digest(t: torch.Tensor) -> torch.Tensor:
    """[rows, n] uint8 -> [rows] int64: each row's byte sum mod 2^32."""
    return t.sum(dim=1, dtype=torch.int64) & 0xFFFFFFFF


def gf_apply_digest(w: torch.Tensor,
                    x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``gf_apply`` with its digest epilogue: (out [R, n]
    uint8, digest [C + R] int64), the digest being the input rows' and then
    the output rows' byte sums mod 2^32."""
    out = gf_apply(w, x)
    return out, torch.cat([row_digest(x), row_digest(out)])


def gf_apply_xorsched_digest(sched: xor_schedule.XorSchedule,
                             x: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``gf_apply_xorsched`` with its digest epilogue,
    laid out as ``gf_apply_digest``'s."""
    out = gf_apply_xorsched(sched, x)
    return out, torch.cat([row_digest(x), row_digest(out)])


def formulation_env() -> str | None:
    """The WEED_EC_FORMULATION pin (lut|bitplane|xorsched), or None when
    unset. An unknown value raises rather than silently ignoring the
    operator's intent."""
    raw = os.environ.get("WEED_EC_FORMULATION", "").strip().lower()
    if not raw:
        return None
    if raw not in FORMULATIONS:
        raise ValueError(f"WEED_EC_FORMULATION={raw!r}: valid values are "
                         f"{sorted(FORMULATIONS)}")
    return raw
