"""The hand-written GF(2^8) kernels' wrappers.

- ``gf_apply`` (``csrc/gf_apply.cu``), counterpart of
  ``seaweedfs_tpu/ops/rs_pallas.py:_gf_kernel``: takes the same operands
  as the plain version ``rs_torch.gf_apply`` (W [8R, 8C] int8, x [C, n]
  uint8).
- ``gf_apply_mxu`` (``csrc/gf_mxu.cu``), counterpart of
  ``rs_pallas.py:_gf_kernel_mxu_repack``: the same operands as
  ``gf_apply``, both products on the int8 tensor cores (``wgmma`` by
  default; ``instr="mma"`` runs the same kernel on ``mma.sync``); reached
  as ``gf_apply(w, x, repack="mxu")``, the reference's argument. No coder
  selects it.
- ``gf_apply_xorsched`` (``csrc/gf_xorsched.cu``), counterpart of
  ``rs_pallas.py:_gf_kernel_xorsched``: takes the lowered XOR program
  in groups of four ops (``xor_schedule.lower_schedule_grouped``) and x;
  on the CPU any lowering of the schedule will do. Its plain version is
  ``rs_torch.gf_apply_xorsched``.

``gf_apply`` and ``gf_apply_xorsched`` carry the digest epilogue: given
``digest``, a [C + R] int32 tensor on x's device (``new_digest``), they
add the input rows' and then the output rows' wrapping uint32 byte sums
to it (int32 holds the uint32 bits; ``digest_values`` reads them back),
and with ``out=False`` they store no output and return None: a
digest-only launch. The mxu kernel has no epilogue.

On a CPU tensor each wrapper computes its plain version, and only there;
on a CUDA tensor it launches its kernel on the current stream or raises --
there is no fallback. Each keeps its own ``.launches`` count of kernel
launches, so a run can show that its path went through the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build, rs_torch, xor_schedule

MAX_ROWS = 32  # R and C limit of the kernels (k + m <= 32 shards)
# shared memory a block may use on the H100 (227 KB) and the most threads
# a block of the XOR-schedule kernel takes (its __launch_bounds__)
SMEM_LIMIT = 232448
XORSCHED_THREADS = 512
# the ops per group of the programs that the XOR-schedule kernel walks
# (xor_schedule.lower_schedule_grouped's default)
XORSCHED_GROUP = 4
# the tensor-core kernel's instructions for its two products
MXU_INSTRS = ("wgmma", "mma")


def new_digest(rows: int, device: torch.device | str) -> torch.Tensor:
    """A zeroed digest buffer: [rows] int32 holding uint32 sums."""
    return torch.zeros(rows, dtype=torch.int32, device=device)


def digest_values(digest: torch.Tensor) -> torch.Tensor:
    """A digest buffer's sums as int64 values in [0, 2^32)."""
    return digest.to(torch.int64) & 0xFFFFFFFF


def _digest_ptr(name: str, digest: Optional[torch.Tensor], rows: int,
                device: torch.device) -> int:
    """The data pointer of a digest buffer checked against [rows] int32
    contiguous on `device` (0 for no digest)."""
    if digest is None:
        return 0
    if (digest.device != device or digest.dtype != torch.int32
            or tuple(digest.shape) != (rows,) or not digest.is_contiguous()):
        raise ValueError(f"{name}: digest must be [{rows}] int32 contiguous "
                         f"on {device}, got {tuple(digest.shape)} "
                         f"{digest.dtype} on {digest.device}")
    return digest.data_ptr()


def _plain(name: str, x: torch.Tensor, result: tuple,
           digest: Optional[torch.Tensor],
           out: bool) -> Optional[torch.Tensor]:
    """The CPU path: the plain version's (out, digest) added into the
    caller's digest buffer mod 2^32, as the kernels add."""
    o, d = result
    if digest is not None:
        _digest_ptr(name, digest, len(d), x.device)
        total = (digest_values(digest) + d) & 0xFFFFFFFF
        digest.copy_(torch.where(total >= 1 << 31, total - (1 << 32),
                                 total))
    return o if out else None


def _device_index(x: torch.Tensor) -> int:
    return (x.device.index if x.device.index is not None
            else torch.cuda.current_device())


def _check_bitplane(name: str, w: torch.Tensor,
                    x: torch.Tensor) -> tuple[int, int, int]:
    """Check the bit-plane operands W [8R, 8C] int8 and x [C, n] uint8 on
    one card; returns (R, C, n)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if w.device != x.device:
        raise ValueError(f"{name}: W on {w.device}, x on {x.device}")
    if w.dtype != torch.int8 or x.dtype != torch.uint8:
        raise TypeError(f"{name}: want int8 W and uint8 x, got "
                        f"{w.dtype} and {x.dtype}")
    if (w.dim() != 2 or x.dim() != 2 or w.shape[0] % 8
            or w.shape[1] != 8 * x.shape[0]):
        raise ValueError(
            f"{name}: W {tuple(w.shape)} does not fit x {tuple(x.shape)}")
    rows, cols, n = w.shape[0] // 8, x.shape[0], x.shape[1]
    if not (1 <= rows <= MAX_ROWS and 1 <= cols <= MAX_ROWS):
        raise ValueError(f"{name}: [{rows}, {cols}] exceeds the kernel's "
                         f"{MAX_ROWS} rows or columns")
    return rows, cols, n


def gf_apply(w: torch.Tensor, x: torch.Tensor, repack: str = "vpu",
             digest: Optional[torch.Tensor] = None,
             out: bool = True) -> Optional[torch.Tensor]:
    """W [8R, 8C] int8 applied to x [C, n] uint8 -> [R, n] uint8 on x's
    device (None with out=False); kernel launches run on the current CUDA
    stream. `digest` ([C + R] int32) gains the rows' byte sums. repack is
    the reference's argument: "vpu" runs ``csrc/gf_apply.cu``, "mxu" the
    tensor-core kernel ``gf_apply_mxu`` (no digest), anything else raises."""
    if repack not in rs_torch.REPACKS:
        raise ValueError(f"gf_apply: unknown repack {repack!r}; have "
                         f"{rs_torch.REPACKS}")
    if repack == "mxu":
        if digest is not None or not out:
            raise ValueError("gf_apply: the mxu kernel has no digest "
                             "epilogue")
        return gf_apply_mxu(w, x)
    if x.device.type == "cpu":
        return _plain("gf_apply", x, rs_torch.gf_apply_digest(w, x), digest,
                      out)
    rows, cols, n = _check_bitplane("gf_apply", w, x)
    dptr = _digest_ptr("gf_apply", digest, cols + rows, x.device)
    w, x = w.contiguous(), x.contiguous()
    result = (torch.empty((rows, n), dtype=torch.uint8, device=x.device)
              if out else None)
    if n == 0:
        return result
    err = _build.library().sw_gf_apply(
        w.data_ptr(), rows, cols, x.data_ptr(),
        result.data_ptr() if out else 0, n, dptr, _device_index(x),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"gf_apply kernel launch failed: cudaError {err}")
    gf_apply.launches += 1
    return result


gf_apply.launches = 0


def gf_apply_mxu(w: torch.Tensor, x: torch.Tensor,
                 instr: str = "wgmma") -> torch.Tensor:
    """``gf_apply`` with both the product and the byte repack on the int8
    tensor cores (``csrc/gf_mxu.cu``, counterpart of ``rs_pallas.py:
    _gf_kernel_mxu_repack``): the same operands and result; its plain
    version is ``rs_torch.gf_apply_mxu``. `instr` is the products'
    instruction, "wgmma" or "mma" (mma.sync); anything else raises. Counts
    its own launches."""
    if instr not in MXU_INSTRS:
        raise ValueError(f"gf_apply_mxu: unknown instr {instr!r}; have "
                         f"{MXU_INSTRS}")
    if x.device.type == "cpu":
        return rs_torch.gf_apply_mxu(w, x)
    rows, cols, n = _check_bitplane("gf_apply_mxu", w, x)
    w, x = w.contiguous(), x.contiguous()
    result = torch.empty((rows, n), dtype=torch.uint8, device=x.device)
    if n == 0:
        return result
    err = _build.library().sw_gf_mxu(
        w.data_ptr(), rows, cols, x.data_ptr(), result.data_ptr(), n,
        int(instr == "wgmma"), _device_index(x),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"gf_apply_mxu kernel launch failed: cudaError {err}")
    gf_apply_mxu.launches += 1
    return result


gf_apply_mxu.launches = 0


def xorsched_launch(prog: xor_schedule.XorProgram,
                    digest: bool = False) -> tuple[int, int]:
    """(threads per block, dynamic shared-memory bytes) for a program: the
    program's and the output planes' byte offsets, then a row of S words
    per thread (its slots, plus C + R digest sums for a digest launch, S
    made odd so that a warp's accesses to one slot fall on 32 banks). As
    many threads as fit, up to XORSCHED_THREADS; raises when not even 32
    do."""
    rows, cols = prog.sched.n_rows // 8, prog.sched.n_in // 8
    prog_bytes = 4 * ((3 * prog.code.shape[0] + 8 * rows + 3) & ~3)
    stride = (prog.n_slots + (cols + rows if digest else 0)) | 1
    threads = min(XORSCHED_THREADS,
                  (SMEM_LIMIT - prog_bytes) // (4 * stride) // 32 * 32)
    if threads < 32:
        raise ValueError(
            f"gf_apply_xorsched: {prog.n_slots} slots and a "
            f"{prog_bytes}-byte program do not fit 32 threads in "
            f"{SMEM_LIMIT} bytes of shared memory")
    return threads, prog_bytes + 4 * stride * threads


def gf_apply_xorsched(prog: xor_schedule.XorProgram, x: torch.Tensor,
                      digest: Optional[torch.Tensor] = None,
                      out: bool = True) -> Optional[torch.Tensor]:
    """The lowered XOR program of a matrix [R, C] applied to x [C, n]
    uint8 -> [R, n] uint8 on x's device (None with out=False); kernel
    launches run on the current CUDA stream. `digest` ([C + R] int32)
    gains the rows' byte sums."""
    if x.device.type == "cpu":
        return _plain("gf_apply_xorsched", x,
                      rs_torch.gf_apply_xorsched_digest(prog.sched, x),
                      digest, out)
    if x.device.type != "cuda":
        raise ValueError(f"gf_apply_xorsched: unsupported device {x.device}")
    if prog.code.device != x.device or prog.out_slots.device != x.device:
        raise ValueError(f"gf_apply_xorsched: program on "
                         f"{prog.code.device}, x on {x.device}")
    if (prog.code.dtype != torch.int16 or prog.out_slots.dtype != torch.int16
            or x.dtype != torch.uint8):
        raise TypeError(f"gf_apply_xorsched: want an int16 program and "
                        f"uint8 x, got {prog.code.dtype} and {x.dtype}")
    sched = prog.sched
    if (x.dim() != 2 or 8 * x.shape[0] != sched.n_in or sched.n_rows % 8
            or prog.code.dim() != 2 or prog.code.shape[1] != 3
            or prog.code.shape[0] % prog.group
            or tuple(prog.out_slots.shape) != (sched.n_rows,)):
        raise ValueError(f"gf_apply_xorsched: program for {sched.n_in} "
                         f"input planes does not fit x {tuple(x.shape)}")
    if prog.group != XORSCHED_GROUP:
        raise ValueError(f"gf_apply_xorsched: the kernel walks ops in groups "
                         f"of {XORSCHED_GROUP}, the program has groups of "
                         f"{prog.group} (lower it with "
                         f"xor_schedule.lower_schedule_grouped)")
    rows, cols, n = sched.n_rows // 8, x.shape[0], x.shape[1]
    if not (1 <= rows <= MAX_ROWS and 1 <= cols <= MAX_ROWS):
        raise ValueError(f"gf_apply_xorsched: [{rows}, {cols}] exceeds the "
                         f"kernel's {MAX_ROWS} rows or columns")
    dptr = _digest_ptr("gf_apply_xorsched", digest, cols + rows, x.device)
    x = x.contiguous()
    result = (torch.empty((rows, n), dtype=torch.uint8, device=x.device)
              if out else None)
    if n == 0:
        return result
    threads, smem = xorsched_launch(prog, digest is not None)
    err = _build.library().sw_gf_xorsched(
        prog.code.data_ptr(), prog.code.shape[0], prog.out_slots.data_ptr(),
        prog.n_slots, prog.group, rows, cols, x.data_ptr(),
        result.data_ptr() if out else 0, n, dptr, threads, smem,
        _device_index(x), torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"gf_apply_xorsched kernel launch failed: cudaError {err}")
    gf_apply_xorsched.launches += 1
    return result


gf_apply_xorsched.launches = 0
