"""The hand-written GF(2^8) kernels' wrappers.

- ``gf_apply`` (``csrc/gf_apply.cu``), counterpart of
  ``seaweedfs_tpu/ops/rs_pallas.py:_gf_kernel``: takes the same operands
  as the plain version ``rs_torch.gf_apply`` (W [8R, 8C] int8, x [C, n]
  uint8).
- ``gf_apply_mxu`` (``csrc/gf_mxu.cu``), counterpart of
  ``rs_pallas.py:_gf_kernel_mxu_repack``: the same operands as
  ``gf_apply``, both products on the int8 tensor cores; reached as
  ``gf_apply(w, x, repack="mxu")``, the reference's argument. No coder
  selects it.
- ``gf_apply_xorsched`` (``csrc/gf_xorsched.cu``), counterpart of
  ``rs_pallas.py:_gf_kernel_xorsched``: takes the lowered XOR program
  (``xor_schedule.lower_schedule``) and x; its plain version is
  ``rs_torch.gf_apply_xorsched``.

On a CPU tensor each wrapper computes its plain version, and only there;
on a CUDA tensor it launches its kernel on the current stream or raises --
there is no fallback. Each keeps its own ``.launches`` count of kernel
launches, so a run can show that its path went through the kernel.
"""

from __future__ import annotations

import torch

from . import _build, rs_torch, xor_schedule

MAX_ROWS = 32  # R and C limit of the kernels (k + m <= 32 shards)
# shared memory a block may use on the H100 (227 KB) and the block size
# the XOR-schedule kernel aims for
SMEM_LIMIT = 232448
XORSCHED_THREADS = 128


def _launch(name: str, entry: str, w: torch.Tensor,
            x: torch.Tensor) -> torch.Tensor:
    """Check the bit-plane operands W [8R, 8C] int8 and x [C, n] uint8 on
    one card and launch `entry` of the library on the current stream."""
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
    w, x = w.contiguous(), x.contiguous()
    out = torch.empty((rows, n), dtype=torch.uint8, device=x.device)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(x.device)
    err = getattr(_build.library(), entry)(
        w.data_ptr(), rows, cols, x.data_ptr(), out.data_ptr(), n,
        x.device.index if x.device.index is not None
        else torch.cuda.current_device(), stream.cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return out


def gf_apply(w: torch.Tensor, x: torch.Tensor,
             repack: str = "vpu") -> torch.Tensor:
    """W [8R, 8C] int8 applied to x [C, n] uint8 -> [R, n] uint8 on x's
    device; kernel launches run on the current CUDA stream. repack is the
    reference's argument: "vpu" runs ``csrc/gf_apply.cu``, "mxu" the
    tensor-core kernel ``gf_apply_mxu``, anything else raises."""
    if repack not in rs_torch.REPACKS:
        raise ValueError(f"gf_apply: unknown repack {repack!r}; have "
                         f"{rs_torch.REPACKS}")
    if repack == "mxu":
        return gf_apply_mxu(w, x)
    if x.device.type == "cpu":
        return rs_torch.gf_apply(w, x)
    out = _launch("gf_apply", "sw_gf_apply", w, x)
    if out.shape[1]:
        gf_apply.launches += 1
    return out


gf_apply.launches = 0


def gf_apply_mxu(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``gf_apply`` with both the product and the byte repack on the int8
    tensor cores (``csrc/gf_mxu.cu``, counterpart of ``rs_pallas.py:
    _gf_kernel_mxu_repack``): the same operands and result; its plain
    version is ``rs_torch.gf_apply_mxu``. Counts its own launches."""
    if x.device.type == "cpu":
        return rs_torch.gf_apply_mxu(w, x)
    out = _launch("gf_apply_mxu", "sw_gf_mxu", w, x)
    if out.shape[1]:
        gf_apply_mxu.launches += 1
    return out


gf_apply_mxu.launches = 0


def xorsched_launch(prog: xor_schedule.XorProgram) -> tuple[int, int]:
    """(threads per block, dynamic shared-memory bytes) for a program:
    the program itself, then one 4-byte slot per value per thread. Raises
    when the slots do not fit even 32 threads."""
    rows = prog.sched.n_rows // 8
    prog_bytes = 4 * ((3 * prog.code.shape[0] + 8 * rows + 1) // 2)
    per_thread = 4 * prog.n_slots
    threads = min(XORSCHED_THREADS,
                  (SMEM_LIMIT - prog_bytes) // per_thread // 32 * 32)
    if threads < 32:
        raise ValueError(
            f"gf_apply_xorsched: {prog.n_slots} slots and a "
            f"{prog_bytes}-byte program do not fit 32 threads in "
            f"{SMEM_LIMIT} bytes of shared memory")
    return threads, prog_bytes + per_thread * threads


def gf_apply_xorsched(prog: xor_schedule.XorProgram,
                      x: torch.Tensor) -> torch.Tensor:
    """The lowered XOR program of a matrix [R, C] applied to x [C, n]
    uint8 -> [R, n] uint8 on x's device; kernel launches run on the
    current CUDA stream."""
    if x.device.type == "cpu":
        return rs_torch.gf_apply_xorsched(prog.sched, x)
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
            or tuple(prog.code.shape) != (len(sched.ops), 3)
            or tuple(prog.out_slots.shape) != (sched.n_rows,)):
        raise ValueError(f"gf_apply_xorsched: program for {sched.n_in} "
                         f"input planes does not fit x {tuple(x.shape)}")
    rows, cols, n = sched.n_rows // 8, x.shape[0], x.shape[1]
    if not (1 <= rows <= MAX_ROWS and 1 <= cols <= MAX_ROWS):
        raise ValueError(f"gf_apply_xorsched: [{rows}, {cols}] exceeds the "
                         f"kernel's {MAX_ROWS} rows or columns")
    threads, smem = xorsched_launch(prog)
    x = x.contiguous()
    out = torch.empty((rows, n), dtype=torch.uint8, device=x.device)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(x.device)
    err = _build.library().sw_gf_xorsched(
        prog.code.data_ptr(), prog.code.shape[0], prog.out_slots.data_ptr(),
        prog.n_slots, rows, cols, x.data_ptr(), out.data_ptr(), n, threads,
        smem, x.device.index if x.device.index is not None
        else torch.cuda.current_device(), stream.cuda_stream)
    if err:
        raise RuntimeError(
            f"gf_apply_xorsched kernel launch failed: cudaError {err}")
    gf_apply_xorsched.launches += 1
    return out


gf_apply_xorsched.launches = 0
