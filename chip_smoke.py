#!/usr/bin/env python3
"""Smoke run of the seaweedfs_torch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. the card's name, count and power limit, and the kernels' build (one
   nvcc per source, all at once, from the sources in this checkout);
2. each hand-written GF(2^8) kernel against its plain PyTorch version on
   the card: RS(10,4), RS(20,4) and RS(6,3); widths 1, 1023, 64 KiB + 3,
   1 MiB + 5, 8 MiB and 16 MiB; the parity matrix, a zero-padded
   reconstruction matrix for victims {0, 3, 7, 12} (rebuild) and the
   unpadded one-row matrix for victim 0 (a degraded read); bit equality
   required, 54 cases per kernel: (2) ``gf_apply`` (bit-plane matrix
   operand), (2b) ``gf_apply_xorsched`` (the matrix's grouped XOR
   program) and (2c) ``gf_apply_mxu`` (the same operand, both products on
   the tensor cores, on wgmma and again on mma.sync), which must also
   equal ``gf_apply`` on the same inputs; the first two also with their
   digest epilogue, with and without output stores, whose [C + R] sums
   must equal the plain ones;
3. the main path at full size under the default ``bitplane``
   formulation: a 1 GiB volume (seeded needles, log-uniform 1 KiB ..
   4 MiB, about 5% deleted) written with the port's Volume,
   ``stream_encode`` with ``get_coder("auto", 10, 4)`` under the default
   RS(10,4) geometry (1 GiB large / 1 MiB small blocks), the sorted .ecx,
   the parity held against the plain version over the whole volume, every
   live needle read through ``EcVolume``, the same with shards
   {0, 3, 7, 12} deleted (degraded reads through the kernel),
   ``stream_rebuild`` (sha256 of the rebuilt shards), ``write_dat_file``
   (the decoded .dat equals the source), and (3c) the device sinks
   ``stream_encode_device_sink`` and ``stream_rebuild_device_sink`` of the
   four victims, whose digests must equal the shard files' and the .ecm's
   stamped ones. The encode's .ecm digests come from the kernels' digest
   epilogue (the host sum is never called: counted) and must equal the
   shard files'; the sinks call no ``torch.sum`` (counted). All three
   kernels' launch counts are set to 0 before
   each step and read after it; only the formulation's kernel may run
   (the tensor-core kernel never does, as in the reference);
   (3b) the same with ``TorchCoder(10, 4, formulation="xorsched")`` on a
   copy of the same volume (written once from the seed: needle records
   carry their append time, so two writes differ): its 14 shard files
   must equal the bitplane run's by sha256, and only the XOR-schedule
   kernel may run;
   ``get_coder("auto")`` under ``WEED_EC_FORMULATION=xorsched`` must give
   the xorsched coder;
   (3d) the governed pipeline on a copy of the same volume, with the
   governor, the span ring and the wide events reset first: three
   ``stream_encode(base, coder)`` runs with no batch size or depth (one
   line each: the planned operating point, the ``ec.*`` span totals,
   GB/s, the staging pool's allocation time, the feed), a fourth under
   ``torch.profiler`` (the device's kernel, copy and busy seconds and its
   idle share over the run); then on each feed, mmap, ``WEED_EC_MMAP=0``
   and ``WEED_EC_ODIRECT=1`` (whether O_DIRECT engaged), one
   ``stream_encode_many`` over two copies and one governed
   ``stream_rebuild`` of the four victims, and a governed encode on the
   last two; all with shards equal by sha256 to the pinned run's; a fault drill on the preadv feed
   (``ec.feed.read`` armed as an error: ``FaultError`` and no .ecm; after
   ``faults.clear()`` the next run succeeds); the tensor-core kernel's
   entry, ``rs_cuda.gf_apply(w, x, repack="mxu")``, applied to every
   [10, 8 MiB] batch of the data shards, equal to the parity shards; the
   "ec" metrics registry on one line;
4. the same as 3/3b at a mixed-tier layout (262144 / 16384 blocks, 4 MiB
   volume), under both formulations;
6. (run before 5) ``Store(coder_name="auto")`` under the default policy
   (no ``WEED_EC_GEOMETRY``: ``default=10+4,archive=20+4``) and the
   default formulation. (6a) the default collection, RS(10,4): a 1 GiB
   volume written with ``Store.write_needle`` (phase 3's generator,
   about 5% deleted), ``ec_generate`` (parity held against the plain
   version over the whole volume, .ecm digests from the kernels' epilogue
   equal to the shard files'), ``close`` and a new Store that finds the
   EC volume with 14 shards, every needle read, ``ec_delete_shards`` of
   {0, 3, 7, 12} and every needle read again (degraded), ``ec_blob_delete``
   of 8 needles (refused after, journaled in .ecj), ``ec_rebuild``
   (rebuilt shards' sha256 equal, .ecj folded into .ecx),
   ``ec_to_volume`` (the decoded .dat equals the source up to its last
   live needle; every needle reads from the restored volume). (6b) the
   ``archive`` collection, RS(20,4): a 1 GiB volume of the fused
   warm-down tests' five payload kinds, 30% tombstoned (upstream's default
   vacuum garbageThreshold), ``ec_fused_generate`` (24 shards, a marker
   naming RS(20,4), the decoded .dat equal to the sequential
   per-needle-read-and-gzip chain's, parity equal to the plain version's,
   .ecm digests equal to the files', no staging file left, every 8th
   needle (a fixed sample: the first and each 8th after it) read back
   decompressed through an ``EcVolume`` with 4 shards lost, or refused
   when deleted), with one line of the pass's wall time, GB/s of the source
   volume, stats and ``ec.*`` span totals. Every step's launches are
   counted: only ``gf_apply`` may run, and it must in the coder's steps;
7. (run after 6) the same path through the port's servers, the EC shell
   and the CLI, under the default policy: (7a) a master and 3 volume
   servers in this process (``LocalCluster``, each server its own
   directory and ``Store(coder_name="auto")``, master volume size limit
   1024 MB), on loopback ports; one volume of collection ``ecsmoke`` grown
   and filled over HTTP through the port's ``Client`` (phase 3's
   generator, about 5% deleted with HTTP DELETE), its sealed .dat copied,
   the shell's ``EcCommands.encode`` (14 shards spread 5/5/4, the volume
   retired; the shard files gathered from the three directories: parity
   equal to the plain version's, data shards decoding to the sealed
   copy), every needle read over HTTP, again with one data shard of the
   4-shard server deleted, again with that server stopped and pruned (4
   shards lost; survivors fetched from the peer over
   ``/admin/ec/shard_read``), ``EcCommands.rebuild`` (sha256 of the
   rebuilt shards equal), ``EcCommands.decode`` and reads of the decoded
   volume; every step's launches counted: ``gf_apply`` must run in the
   encode, both degraded reads and the rebuild, and nothing else
   anywhere; (7b) ``python3 -m seaweedfs_torch.cli`` master and ``volume
   -coder auto`` as processes, 48 uploads into a 64 MB-limit volume,
   ``shell ec.encode``, one shard deleted, every needle read back, the
   processes stopped at the end. The servers are aiohttp applications on
   one event loop, on one rack. The master runs with
   ``repair_enabled=False`` (the CLI's with ``-maintenance_interval 0``):
   the shell heals phases 7 and 8, and the repair daemon would race it;
8. (run inside 7a's cluster, before 7b) the hot tier in front of the
   warm one: a fresh server takes the place of the one 7a lost; a 1 GiB
   volume of collection ``repsmoke`` at replication ``001`` (upstream's
   "one more copy on the same rack") filled over HTTP with phase 3's
   generator (each 201 means both copies are written: both holders count
   every needle, and every needle reads back from each); needles deleted
   until ``/admin/vacuum/check`` reads at
   least 0.3 on both holders; ``/vol/vacuum?garbageThreshold=0.3`` while
   64 more uploads (assigned before) run against the volume, so that the
   compaction replays writes that land during its copy; each holder's
   .dat shrank by at least its deleted bytes; every live needle read from
   each holder, each deleted one 404; the replica's server stopped, a
   fresh server with an empty directory started, the shell's
   ``volume.fix.replication -force`` copies the volume back and every
   needle reads from the new copy; ``ec.encode`` retires both copies and
   spreads the shards 5/5/4; reads with the 4-shard server lost;
   ``ec.rebuild``. ``gf_apply`` must launch in the encode, the degraded
   reads and the rebuild, and nowhere else in the phase;
9. (run after 7b) the self-driving warm tier, in its own ``LocalCluster``:
   a master with the repair daemon and the lifecycle rules (warm after 10
   s idle, an evaluation every 0.5 s, decode back at a decayed read rate
   of 270 reads/s, collection ``lctmp`` expiring 3 s after its last write
   plus 1 s of grace; heat half-life 2 s) and 4 volume servers on one
   rack (``Store(coder_name="auto")``, the scrub loop off, pulse 0.5 s),
   no operator command from step 2 on: (1) two volumes of ``lcsmoke``
   allocated on one server, filled at once over HTTP with phase 3's
   generator to 1 GiB each, 5% deleted, the first copied aside; (2) the
   daemon seals both and warms them down in one ``ec/fused`` window of
   two (the master's ``lifecycle_encode_windows`` counter), spreads each
   4/4/3/3, reads 14/14 back and retires the originals; the 14 shards
   equal by sha256 a direct ``Store.ec_fused_generate`` of the copy;
   every needle reads back; (3) one byte of a shard flipped on disk:
   ``/admin/ec/scrub`` reports exactly that shard, having checked every
   shard mounted there; the master drops and rebuilds it to its sha256;
   a scrub of every holder checks all 28 shards and finds nothing;
   (4) the server holding 3 shards of the second volume stopped: reads of
   that volume once the master has pruned it (degraded until the
   rebuild), both volumes rebuilt to 14/14 on the survivors, reads of
   both; (5) a 64 MiB volume of ``lcrep`` at ``001``, one holder's copy
   deleted: copied back, every needle read from both holders; (6) a 64
   MiB volume of ``lctmp`` gone from the lookup and the disks after its
   TTL; (7) 8 threads read the first volume's 256 smallest needles until
   the daemon decodes it (``unec``), then its needles read from the
   decoded volume. A read of step 7 may fail only in the decode's window
   (the volume already normal on one holder, the shard set being
   dropped, until the decode's outcome is recorded); the failures are
   counted, by answer, in the ``lifecycle.hot_again`` line. Steps 4 and 7 read a fixed sample: the first needle
   and each 4th after it, in upload order. Each step's line has its
   wall time, GB/s where bytes moved, read p50/p99, launches, the time
   from its trigger to the daemon's action and the card's name and power
   limit. ``gf_apply`` must launch in steps 2-4 (and in the direct
   warm-down and the degraded reads) and nowhere else in the phase;
10. (run after 9) the multi-card coder and the crash sweeps, on two mesh
   members: distinct cards where the host has two or more, else the one
   card twice (two members, each on its own stream). Every line has the
   card's name and power limit. (10a) ``MeshCoder`` against the kernel:
   RS(10,4), RS(20,4) and RS(6,3); widths 1, 1023, 64 KiB + 3 and 8 MiB +
   5 (the pad path); both formulations; the parity matrix and the rebuild
   of victims {0, 3, 7, 12} ({0, 3, 7} at RS(6,3)); every output equal to
   single-card ``gf_apply`` and to the plain version, and the
   formulation's kernel launched once per member per call;
   ``sharded_encode`` and ``sharded_rebuild`` the same bytes. (10b) a
   1 GiB volume from phase 3's generator, ``stream_encode`` governed,
   single-card and through the two-member mesh (bitplane, then xorsched):
   the 14 shard files equal by sha256, the plan's ``chips`` 2 and both
   members' staging counters grown, ``stream_rebuild`` of the four
   victims equal by sha256, both device sinks' digests equal to the
   shard files' and the .ecm's; only the formulation's kernel runs, once
   per member per batch (counted); wall time and GB/s per step. (10c)
   under ``WEED_EC_MESH_DEVICES=all``, ``Store(coder_name="auto")`` lifts
   its coder onto a ``MeshCoder`` over every card (a ``TorchCoder`` on a
   one-card host); ``/admin/ec/mesh_status`` of a port volume server and
   shell ``ec.mesh.status`` answer with ``requested``, ``mesh_devices``
   and ``devices``, which names the card. (10d) crash sweeps
   (``seaweedfs_torch.crashsim``) at 2 seeds x 20 crash points each:
   ``ec_encode`` (RS(10,4) at 262144 / 16384 blocks, a 64 MiB seeded .dat,
   ``stream_encode`` with ``get_coder("auto")``), ``fused_warmdown``
   (RS(20,4), a 64 MiB volume of phase 6b's payload kinds, 30%
   tombstoned) and ``volume_append``: zero violations, ``gf_apply``
   launched in both EC sweeps; points, violations and wall time per
   workload;
5. the kernels' times and the plain versions' (CUDA events, median of
   windows after warm-up) and the wrappers' host time per call at the
   shapes the main path gives them (RS(20,4) at [20, 8 MiB] and at the
   fused pass's [20, 4 MiB] too), with and without the digest epilogue
   (beside the kernel-then-``sum`` pass the epilogue replaces), and the
   bound: bytes at the memory rate, or the function's operations at their
   rate, whichever takes longer. For ``gf_apply`` and the XOR-schedule
   kernel (one function) the operations are the XORs of the matrix's
   schedule, one 32-bit word operation per XOR per 32 columns, at the
   32-bit integer rate (132 SMs x 64 per clock x the SM clock nvidia-smi
   reports): a count of the function, not of either kernel's design.
   ``gf_apply``'s own integer instructions per column, counted from the
   built library's SASS, are reported beside it (``ops_per_column``), and
   so are the tensor-core kernel's mma and integer instructions per 16
   columns at RS(10,4) (``sass_per_16_columns``, on wgmma and on
   mma.sync, whose time is ``mma_sync_ms``), whose bound counts the
   int8 operations the function needs (the GF product and the repack,
   without the design's padding) at the tensor-core rate. The
   ``kernels`` line, the nvidia-smi line, and the result line.

It needs one card, exits non-zero without one, and works in a scratch
directory inside the checkout that it removes at the end.
"""

from __future__ import annotations

import collections
import functools
import hashlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from seaweedfs_torch import faults, observe
from seaweedfs_torch.client import Client, ClientError
from seaweedfs_torch.client import _get_json as http_get_json
from seaweedfs_torch.crashsim import harness as crash_harness
from seaweedfs_torch.crashsim import workloads as crash_wl
from seaweedfs_torch.ec import coder as coder_mod
from seaweedfs_torch.ec import ec_volume, feed, geometry, governor
from seaweedfs_torch.ec import pipeline, striping
from seaweedfs_torch.observe import wideevents
from seaweedfs_torch.lifecycle import LifecycleConfig
from seaweedfs_torch.parallel import mesh_coder as mesh_mod
from seaweedfs_torch.parallel import sharded
from seaweedfs_torch.ops import _build, gf256, rs_cuda, rs_torch
from seaweedfs_torch.ops import xor_schedule
from seaweedfs_torch.server import http
from seaweedfs_torch.server.local_cluster import LocalCluster
from seaweedfs_torch.shell import commands as shell_commands
from seaweedfs_torch.shell.ec_commands import EcCommands
from seaweedfs_torch.storage import store as store_mod
from seaweedfs_torch.storage import types as st_types
from seaweedfs_torch.storage.file_id import FileId
from seaweedfs_torch.storage.needle import (FLAG_HAS_MIME, FLAG_HAS_NAME,
                                            FLAG_IS_COMPRESSED, Needle)
from seaweedfs_torch.storage.superblock import SuperBlock
from seaweedfs_torch.storage.volume import Volume
from seaweedfs_torch.utils import compression, metrics

REPO = Path(__file__).resolve().parent
WORK = REPO / ".chip_smoke_work"
SEED = 20261016
VICTIMS = (0, 3, 7, 12)
MIB = 1 << 20
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, data sheet
INT8_OPS_PER_S = 1979e12      # H100 SXM dense int8 tensor rate
# 32-bit integer add and logic results per clock per SM at compute
# capability 9.0 (CUDA C Programming Guide, arithmetic instructions)
INT32_RESULTS_PER_CLOCK_PER_SM = 64
# set in main(): the card's 32-bit integer rate (word_ops_per_s),
# gf_apply's SASS instruction counts and the tensor-core kernel's per 16
# columns (sass_ops)
WORD_OPS = [0.0]
SASS_OPS: dict = {}
MXU_SASS: dict = {}
KERNELS = {
    "gf_apply": {
        "name": "gf_apply",
        "route": "cuda",
        "source": "seaweedfs_torch/csrc/gf_apply.cu",
        "replaces": "seaweedfs_tpu/ops/rs_pallas.py:46",
    },
    "gf_apply_xorsched": {
        "name": "gf_apply_xorsched",
        "route": "cuda",
        "source": "seaweedfs_torch/csrc/gf_xorsched.cu",
        "replaces": "seaweedfs_tpu/ops/rs_pallas.py:65",
    },
    "gf_apply_mxu": {
        "name": "gf_apply_mxu",
        "route": "cuda",
        "source": "seaweedfs_torch/csrc/gf_mxu.cu",
        "replaces": "seaweedfs_tpu/ops/rs_pallas.py:109",
    },
}
WRAPPERS = {"gf_apply": rs_cuda.gf_apply,
            "gf_apply_xorsched": rs_cuda.gf_apply_xorsched,
            "gf_apply_mxu": rs_cuda.gf_apply_mxu}
FORMULATION_KERNEL = {"bitplane": "gf_apply",
                      "xorsched": "gf_apply_xorsched"}


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def word_ops_per_s() -> float:
    """The card's 32-bit integer add/logic rate: its SMs x 64 results per
    clock x the SM clock (nvidia-smi clocks.max.sm, MHz)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    mhz = float(out.stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_RESULTS_PER_CLOCK_PER_SM * mhz * 1e6


def sass_ops(lib: Path) -> tuple[dict, dict]:
    """From the built library's SASS (scripts/torch_sass_ops.py):
    gf_apply_vec16's integer-pipe instructions -- the row-pair loop's (two
    input rows of 16 columns: the loop with global loads and the most
    shared loads) and the rest of the enclosing column-group loop's (16
    columns: the transposes, stores and digest) -- and the tensor-core
    kernel's instructions per 16 columns and row group at RS(10,4), by
    class (mma, alu, ...), on wgmma and on mma.sync."""
    sys.path.insert(0, str(REPO / "scripts"))
    import torch_sass_ops as so
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    insns = next(v for k, v in so.kernels(sass).items()
                 if "gf_apply_vec16" in k)

    def count(span, cls):
        return sum(1 for a, op, _ in insns
                   if span[0] <= a <= span[1] and so.classify(op) == cls)

    spans = so.loops(insns)
    # the innermost of the loops with the most shared loads and any
    # global load
    inner = max((sp for sp in spans if count(sp, "global_or_local")),
                key=lambda sp: (count(sp, "shared"), sp[0] - sp[1]))
    outer = min((sp for sp in spans if sp != inner and sp[0] <= inner[0]
                 and inner[1] <= sp[1]), key=lambda sp: sp[1] - sp[0])
    return ({"row_pair_loop": count(inner, "alu"),
             "column_group_rest": count(outer, "alu") - count(inner, "alu")},
            {"wgmma": so.mxu_counts(sass, wgmma=True),
             "mma.sync": so.mxu_counts(sass, wgmma=False)})


def gf_apply_ops_per_column(cols: int) -> float | None:
    """Integer instructions per byte column (one row group of up to four
    output rows) at C input rows, from the SASS counts."""
    if not SASS_OPS:
        return None
    pairs = (cols + 1) // 2
    return (pairs * SASS_OPS["row_pair_loop"]
            + SASS_OPS["column_group_rest"]) / 16


def bound_ms_mxu(rows: int, cols: int, n: int) -> tuple[float, str]:
    """Least time for the tensor-core variant: the same bytes, against
    the int8 operations the function needs at the tensor-core rate: the
    GF product's 2*8R*8C*n and the repack's 2*R*8R*n (the kernel's one u8
    product and the reference's two nibble products 2*2*R*4R*n alike),
    with none of the design's padding of K or N counted."""
    t_bytes = (cols + rows) * n / HBM_BYTES_PER_S * 1e3
    t_ops = (2 * (8 * rows) * (8 * cols) * n + 2 * rows * (8 * rows) * n
             ) / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ms(sched, rows: int, cols: int, n: int) -> tuple[float, str]:
    """Least time for a matrix [R, C] applied to [C, n] (gf_apply and
    the XOR-schedule kernel): input read once and output written once at
    the memory rate, against the XORs of the matrix's schedule, one 32-bit
    word operation per XOR per 32 columns, at the 32-bit integer rate."""
    t_bytes = (cols + rows) * n / HBM_BYTES_PER_S * 1e3
    t_ops = (sched.sched_xors * xor_schedule.packed_width(n)
             / WORD_OPS[0] * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def program(mat: np.ndarray, device: torch.device):
    """The grouped XOR program of a coefficient matrix (the coder's
    operand), on `device`."""
    return xor_schedule.lower_schedule_grouped(
        xor_schedule.schedule_for_matrix(mat)).to(device)


def time_cuda(fn, reps: int, warm: int = 3,
              windows: int = 5) -> tuple[float, float]:
    """(ms per call on the device, us per call on the host): CUDA events
    and the host clock (before the closing synchronize), medians over
    `windows` windows of `reps` back-to-back calls each, after `warm`
    calls of warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    per_call, host = [], []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host.append((time.perf_counter() - t0) / reps * 1e6)
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return float(np.median(per_call)), float(np.median(host))


class call_counter:
    """Count the calls of obj.name during a block, and keep what they
    returned; the function itself still runs."""

    def __init__(self, obj, name: str):
        self.obj, self.name, self.calls, self.results = obj, name, 0, []

    def __enter__(self):
        self.real = getattr(self.obj, self.name)

        def counting(*args, **kwargs):
            self.calls += 1
            result = self.real(*args, **kwargs)
            self.results.append(result)
            return result

        setattr(self.obj, self.name, counting)
        return self

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.real)


def lost(k: int, m: int) -> tuple[tuple, tuple]:
    """(survivors, victims) when shards VICTIMS are lost."""
    victims = tuple(v for v in VICTIMS if v < k + m)[:m]
    return tuple(i for i in range(k + m) if i not in victims)[:k], victims


def padded_rec(k: int, m: int) -> np.ndarray:
    present, victims = lost(k, m)
    rec = gf256.reconstruction_matrix(k, m, present, victims)
    return np.vstack([rec, np.zeros((m - rec.shape[0], k), np.uint8)])


def one_row_rec(k: int, m: int) -> np.ndarray:
    """The unpadded [1, k] matrix that a degraded read of an interval on
    one lost shard gives the kernel."""
    present, victims = lost(k, m)
    return gf256.reconstruction_matrix(k, m, present, victims[:1])


# --- phase 2: the kernels against their plain versions ------------------

def check_digests(w, prog, x: torch.Tensor, case: str) -> None:
    """Both digest kernels' [C + R] sums, with and without output stores
    (the second launch adds to the first), against the plain digest."""
    want = rs_torch.gf_apply_digest(w, x)[1]
    for name, kernel, operand in [
            ("gf_apply", rs_cuda.gf_apply, w),
            ("gf_apply_xorsched", rs_cuda.gf_apply_xorsched, prog)]:
        d = rs_cuda.new_digest(len(want), x.device)
        kernel(operand, x, digest=d)
        once = rs_cuda.digest_values(d)
        if kernel(operand, x, digest=d, out=False) is not None:
            raise AssertionError(f"{name}: out=False returned an output")
        twice = rs_cuda.digest_values(d)
        if not (torch.equal(once, want)
                and torch.equal(twice, (2 * want) & 0xFFFFFFFF)):
            raise AssertionError(f"{name} digest != plain at {case}")


def check_kernels(device: torch.device) -> dict:
    """Every kernel against its plain version (and the XOR-schedule and
    tensor-core kernels against gf_apply) on the same inputs, and the
    digest epilogues against the plain digests; returns, per kernel, the
    largest absolute difference and the number of cases."""
    rng = np.random.default_rng(SEED)
    worst = {name: 0 for name in KERNELS}
    cases = 0
    for k, m in [(10, 4), (20, 4), (6, 3)]:
        for n in [1, 1023, 64 * 1024 + 3, MIB + 5, 8 * MIB, 16 * MIB]:
            x = torch.from_numpy(
                rng.integers(0, 256, (k, n), dtype=np.uint8)).to(device)
            for mat in [gf256.parity_matrix(k, m), padded_rec(k, m),
                        one_row_rec(k, m)]:
                w = rs_torch.load_matrix(mat, device)
                prog = program(mat, device)
                got = rs_cuda.gf_apply(w, x)
                got_x = rs_cuda.gf_apply_xorsched(prog, x)
                got_m = rs_cuda.gf_apply(w, x, repack="mxu")
                got_s = rs_cuda.gf_apply_mxu(w, x, instr="mma")
                torch.cuda.synchronize()
                pairs = {"gf_apply": (got, rs_torch.gf_apply(w, x)),
                         "gf_apply_xorsched": (got_x, rs_torch.
                                               gf_apply_xorsched(
                                                   prog.sched, x)),
                         "gf_apply_mxu": (got_m,
                                          rs_torch.gf_apply_mxu(w, x))}
                for name, (a, b) in pairs.items():
                    err = int((a.int() - b.int()).abs().max())
                    worst[name] = max(worst[name], err)
                    if err:
                        raise AssertionError(
                            f"{name} != plain at RS({k},{m}) n={n} "
                            f"matrix {mat.shape}: max abs err {err}")
                for name, other in [("gf_apply_xorsched", got_x),
                                    ("gf_apply_mxu", got_m),
                                    ("gf_apply_mxu on mma.sync", got_s)]:
                    if not torch.equal(got, other):
                        raise AssertionError(
                            f"{name} != gf_apply at RS({k},{m}) n={n} "
                            f"matrix {mat.shape}")
                check_digests(w, prog, x, f"RS({k},{m}) n={n} matrix "
                              f"{mat.shape}")
                cases += 1
    log({"phase": "kernels_vs_plain", "cases_per_kernel": cases,
         "bit_equal": True, "xorsched_equals_gf_apply": True,
         "mxu_equals_gf_apply": True, "mxu_mma_sync_equals_gf_apply": True,
         "max_abs_err": worst,
         "digests_equal_plain": ["gf_apply", "gf_apply_xorsched"],
         "digest_only_launches_equal_plain": True})
    return {"max_abs_err": worst, "cases": cases}


def time_kernels(device: torch.device, shapes: list) -> dict:
    """Each kernel's and its plain version's times at main-path shapes
    [(label, R, C, n)], on the same inputs, and the two digest kernels'
    launches with the epilogue beside the kernel-then-sum pass it
    replaces; {kernel: [rows]}."""
    rng = np.random.default_rng(SEED + 1)
    out: dict = {name: [] for name in KERNELS}
    for label, rows, cols, n in shapes:
        x = torch.from_numpy(
            rng.integers(0, 256, (cols, n), dtype=np.uint8)).to(device)
        mat = (gf256.parity_matrix(cols, rows)
               if label.startswith(("encode", "archive"))
               else padded_rec(cols, rows) if label == "rebuild"
               else one_row_rec(cols, 4))
        w = rs_torch.load_matrix(mat, device)
        prog = program(mat, device)
        d = rs_cuda.new_digest(rows + cols, device)
        runs = {
            "gf_apply": (lambda: rs_cuda.gf_apply(w, x),
                         lambda: rs_torch.gf_apply(w, x),
                         bound_ms(prog.sched, rows, cols, n)),
            "gf_apply_xorsched": (
                lambda: rs_cuda.gf_apply_xorsched(prog, x),
                lambda: rs_torch.gf_apply_xorsched(prog.sched, x),
                bound_ms(prog.sched, rows, cols, n)),
            "gf_apply_mxu": (lambda: rs_cuda.gf_apply(w, x, repack="mxu"),
                             lambda: rs_torch.gf_apply_mxu(w, x),
                             bound_ms_mxu(rows, cols, n)),
        }
        digest_runs = {
            "gf_apply": (
                lambda: rs_cuda.gf_apply(w, x, digest=d),
                lambda: rs_cuda.gf_apply(w, x, digest=d, out=False),
                lambda: rs_cuda.gf_apply(w, x).sum(dim=1,
                                                   dtype=torch.int64)),
            "gf_apply_xorsched": (
                lambda: rs_cuda.gf_apply_xorsched(prog, x, digest=d),
                lambda: rs_cuda.gf_apply_xorsched(prog, x, digest=d,
                                                  out=False),
                lambda: rs_cuda.gf_apply_xorsched(prog, x).sum(
                    dim=1, dtype=torch.int64)),
        }
        # a window moves about 20 GB through the kernel (some ms of work)
        reps = max(50, min(2000, int(2e10 // max(n * (rows + cols), 1))))
        for name, (kernel, plain, (b_ms, b_by)) in runs.items():
            ms, host_us = time_cuda(kernel, reps, warm=reps)
            plain_ms, _ = time_cuda(plain, max(3, reps // 40), warm=1,
                                    windows=3)
            row = {"phase": "kernel_time", "kernel": name, "shape": label,
                   "in": [cols, n], "out": [rows, n], "ms": ms,
                   "host_us": host_us, "plain_ms": plain_ms,
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                   "reps": reps}
            if name == "gf_apply":
                row["ops_per_column"] = gf_apply_ops_per_column(cols)
            if name == "gf_apply_mxu":
                row["sass_per_16_columns"] = MXU_SASS or None
                # the same kernel on mma.sync, beside it
                row["mma_sync_ms"], _ = time_cuda(
                    lambda: rs_cuda.gf_apply_mxu(w, x, instr="mma"), reps,
                    warm=reps)
            if name in digest_runs:
                with_d, only_d, then_sum = digest_runs[name]
                row["digest_ms"], row["digest_host_us"] = time_cuda(
                    with_d, reps, warm=reps)
                row["digest_only_ms"], _ = time_cuda(only_d, reps, warm=reps)
                # the digest part's yardstick: the kernel, then one
                # PyTorch row sum over its output
                row["digest_library_ms"], _ = time_cuda(then_sum, reps,
                                                        warm=reps)
            log(row)
            out[name].append(row)
    return out


# --- phases 3 and 4: the main path ------------------------------------

def payload(seed: int, nid: int, size: int) -> bytes:
    return np.random.default_rng((seed, nid)).bytes(size)


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(16 * MIB)
            if not chunk:
                return h.hexdigest()
            h.update(chunk)


def write_needles(write, delete, size_now, total: int, max_needle: int,
                  seed: int) -> tuple[dict, set]:
    """Seeded needles, log-uniform 1 KiB .. max_needle, written with
    `write` until size_now() reaches `total`; then about 5% deleted."""
    rng = np.random.default_rng(seed)
    sizes: dict = {}
    nid = 0
    while size_now() < total:
        nid += 1
        size = int(np.exp(rng.uniform(np.log(1024), np.log(max_needle))))
        size = min(size, total - size_now())
        write(Needle(cookie=nid * 7919 & 0xFFFFFFFF, id=nid,
                     data=payload(seed, nid, size)))
        sizes[nid] = size
    deleted = {int(i) for i in rng.choice(
        sorted(sizes), size=max(1, len(sizes) // 20), replace=False)}
    for d in sorted(deleted):
        delete(Needle(cookie=d * 7919 & 0xFFFFFFFF, id=d))
    return sizes, deleted


def write_volume(directory: str, total: int, max_needle: int,
                 seed: int) -> tuple[dict, set]:
    """write_needles into volume 1 of `directory` through the Volume."""
    vol = Volume(directory, "", 1, create=True)
    try:
        return write_needles(vol.write_needle, vol.delete_needle,
                             vol.data_file_size, total, max_needle, seed)
    finally:
        vol.close()


def read_all(vol, sizes: dict, deleted: set, seed: int) -> dict:
    """Every live needle byte-identical, every deleted one refused;
    returns the bytes read and each live read's latency."""
    nbytes, lat = 0, []
    for nid, size in sizes.items():
        if nid in deleted:
            try:
                vol.read_needle(nid)
            except KeyError:
                continue
            raise AssertionError(f"deleted needle {nid} still readable")
        t0 = time.perf_counter()
        n = vol.read_needle(nid, cookie=nid * 7919 & 0xFFFFFFFF)
        lat.append(time.perf_counter() - t0)
        if n.data != payload(seed, nid, size):
            raise AssertionError(f"needle {nid} reads back wrong")
        nbytes += size
    return {"bytes": nbytes, "latencies": lat}


def latency_summary(lat: list) -> dict:
    ms = np.sort(np.asarray(lat)) * 1e3
    return {"reads": len(ms), "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "max_ms": float(ms[-1])}


def needles_on(vol, sizes: dict, deleted: set, shards: tuple) -> int:
    """Live needles with at least one interval on the given shards."""
    count = 0
    for nid in sizes:
        if nid in deleted:
            continue
        _, _, intervals = vol.locate(nid)
        if any(iv.to_shard_id_and_offset(vol.g)[0] in shards
               for iv in intervals):
            count += 1
    return count


def check_parity_with(base: str, g: geometry.Geometry,
                      device: torch.device, apply=rs_torch.gf_apply) -> int:
    """Every parity byte on disk equals apply(W, data) of the data shards
    on disk in [k, 8 MiB] batches, computed on `device` (the plain
    version by default)."""
    w = rs_torch.load_matrix(gf256.parity_matrix(g.data_shards,
                                                 g.parity_shards), device)
    files = [open(base + geometry.to_ext(i), "rb")
             for i in range(g.total_shards)]
    try:
        size = os.path.getsize(base + geometry.to_ext(0))
        for off in range(0, size, 8 * MIB):
            rows = [np.frombuffer(f.read(min(8 * MIB, size - off)), np.uint8)
                    for f in files]
            data = torch.from_numpy(np.stack(rows[:g.data_shards]))
            want = apply(w, data.to(device)).cpu().numpy()
            if not np.array_equal(want, np.stack(rows[g.data_shards:])):
                raise AssertionError(f"parity differs from {apply.__name__}"
                                     f" at shard offset {off}")
        return size
    finally:
        for f in files:
            f.close()


def timed(name: str, fn, nbytes_fn=None, extra=None):
    """Run one step, log its wall time (and GB/s over nbytes)."""
    t0 = time.perf_counter()
    result = fn()
    secs = time.perf_counter() - t0
    row = {"phase": name, "seconds": secs}
    nbytes = nbytes_fn(result) if nbytes_fn else None
    if nbytes:
        row["bytes"] = nbytes
        row["gbps"] = nbytes / secs / 1e9
    row.update(extra(result) if extra else {})
    log(row)
    return result


def counted(fn):
    """(result, {kernel: launches during fn}) with every count set to 0
    first."""
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    result = fn()
    return result, {name: w.launches for name, w in WRAPPERS.items()}


def check_sinks(base: str, coder, g: geometry.Geometry, tag: str) -> dict:
    """Both device sinks on the finished volume: the encode digest must
    equal the parity files' and the .ecm's, the rebuild digest of the
    four victims the victims' files' and the .ecm's; neither runs a
    torch.sum (the digest-only launches add into one buffer). Returns
    launches."""
    stamped = pipeline.read_stamped_digests(base)
    launches = {}
    stats: dict = {}
    with call_counter(torch.Tensor, "sum") as sums:
        digest, launches["encode_sink"] = timed(
            f"{tag}encode_device_sink",
            lambda: counted(lambda: pipeline.stream_encode_device_sink(
                base, coder, g, stats=stats)),
            lambda r: os.path.getsize(base + ".dat"),
            lambda r: {"launches": r[1], "stats": stats})
    if sums.calls:
        raise AssertionError(f"encode sink ran {sums.calls} torch.sum")
    want = pipeline.parity_file_digest(base, g)
    if not (np.array_equal(digest, want) and digest.tolist() == [
            stamped[i] for i in range(g.data_shards, g.total_shards)]):
        raise AssertionError(f"encode sink digest {digest.tolist()} != "
                             f"files {want.tolist()} / .ecm {stamped}")
    stats = {}
    with call_counter(torch.Tensor, "sum") as sums:
        digest, launches["rebuild_sink"] = timed(
            f"{tag}rebuild_device_sink",
            lambda: counted(lambda: pipeline.stream_rebuild_device_sink(
                base, coder, VICTIMS, g, stats=stats)),
            lambda r: os.path.getsize(base + geometry.to_ext(1))
            * g.data_shards, lambda r: {"launches": r[1], "stats": stats})
    if sums.calls:
        raise AssertionError(f"rebuild sink ran {sums.calls} torch.sum")
    want = pipeline.shard_file_digest(base, VICTIMS)
    if not (np.array_equal(digest, want)
            and digest.tolist() == [stamped[v] for v in VICTIMS]):
        raise AssertionError(f"rebuild sink digest {digest.tolist()} != "
                             f"files {want.tolist()} / .ecm {stamped}")
    return launches


def source_volume(work: Path, total: int, max_needle: int, seed: int,
                  tag: str) -> dict:
    """Write one seeded volume that each formulation's run copies (needle
    records carry their append time, so two writes of one seed differ)."""
    work.mkdir(parents=True, exist_ok=True)
    sizes, deleted = timed(
        f"{tag}write_volume",
        lambda: write_volume(str(work), total, max_needle, seed),
        lambda r: os.path.getsize(os.path.join(str(work), "1.dat")),
        lambda r: {"needles": len(r[0]), "deleted": len(r[1])})
    return {"dir": work, "sizes": sizes, "deleted": deleted, "seed": seed}


def run_main_path(work: Path, coder, g: geometry.Geometry, volume: dict,
                  device: torch.device, tag: str,
                  min_on_victims: int = 1) -> tuple[dict, dict]:
    """Encode, verify, serve (whole and degraded), rebuild, decode and
    sink a copy of a source volume; returns the launches of both kernels
    per step and the sha256 of each shard file as encoded."""
    shutil.copytree(volume["dir"], work)
    directory = str(work)
    base = os.path.join(directory, "1")
    sizes, deleted, seed = volume["sizes"], volume["deleted"], volume["seed"]
    launches = {}
    dat_size = os.path.getsize(base + ".dat")
    src_sha = sha256_file(base + ".dat")

    # the .ecm digests come from the kernels' digest epilogue: the host
    # sum is never called
    with call_counter(pipeline, "host_row_digests") as host_sums:
        _, launches["encode"] = timed(
            f"{tag}stream_encode",
            lambda: counted(lambda: pipeline.stream_encode(base, coder, g)),
            lambda r: dat_size, lambda r: {"launches": r[1]})
    stamped = pipeline.read_stamped_digests(base)
    files = pipeline.shard_file_digest(base, range(g.total_shards))
    if host_sums.calls or [stamped.get(i) for i in range(g.total_shards)] \
            != files.tolist():
        raise AssertionError(f"{tag}encode digests: {host_sums.calls} host "
                             f"sums; .ecm {stamped} != files "
                             f"{files.tolist()}")
    log({"phase": f"{tag}ecm_digests", "from": "kernel digest epilogue",
         "host_sum_calls": host_sums.calls,
         "equal_shard_file_digest": True})
    striping.write_sorted_ecx_from_idx(base)
    shard_sha = {i: sha256_file(base + geometry.to_ext(i))
                 for i in range(g.total_shards)}
    timed(f"{tag}parity_vs_plain",
          lambda: check_parity_with(base, g, device),
          lambda shard: shard * g.total_shards)

    vol = ec_volume.EcVolume(directory, "", 1, g, coder=coder)
    try:
        for sid in range(g.total_shards):
            vol.add_shard(sid)
        timed(f"{tag}read_all_shards",
              lambda: read_all(vol, sizes, deleted, seed),
              lambda r: r["bytes"],
              lambda r: latency_summary(r["latencies"]))
        on_victims = needles_on(vol, sizes, deleted, VICTIMS)
    finally:
        vol.close()

    for v in VICTIMS:
        os.remove(base + geometry.to_ext(v))
    vol = ec_volume.EcVolume(directory, "", 1, g, coder=coder)
    try:
        for sid in range(g.total_shards):
            if sid not in VICTIMS:
                vol.add_shard(sid)
        _, launches["degraded_read"] = timed(
            f"{tag}read_degraded",
            lambda: counted(lambda: read_all(vol, sizes, deleted, seed)),
            lambda r: r[0]["bytes"],
            lambda r: {"launches": r[1], "needles_on_victims": on_victims,
                       **latency_summary(r[0]["latencies"])})
    finally:
        vol.close()
    if on_victims < min_on_victims:
        raise AssertionError(
            f"degraded reads: {on_victims} needles on the lost shards "
            f"(want {min_on_victims})")

    rebuilt, launches["rebuild"] = timed(
        f"{tag}stream_rebuild",
        lambda: counted(lambda: pipeline.stream_rebuild(base, coder, g)),
        lambda r: os.path.getsize(base + geometry.to_ext(1))
        * g.data_shards, lambda r: {"launches": r[1]})
    if rebuilt != list(VICTIMS):
        raise AssertionError(f"rebuilt {rebuilt}, expected {VICTIMS}")
    for v in VICTIMS:
        if sha256_file(base + geometry.to_ext(v)) != shard_sha[v]:
            raise AssertionError(f"rebuilt shard {v} differs")

    os.replace(base + ".dat", base + ".dat.src")
    timed(f"{tag}write_dat_file",
          lambda: striping.write_dat_file(base, dat_size, g),
          lambda r: dat_size)
    if (os.path.getsize(base + ".dat") != dat_size
            or sha256_file(base + ".dat") != src_sha):
        raise AssertionError("decoded .dat differs from the source")
    found = striping.find_dat_file_size(base, st_types.CURRENT_VERSION)
    if not 0 < found <= dat_size:
        raise AssertionError(f"find_dat_file_size {found} > {dat_size}")
    launches.update(check_sinks(base, coder, g, tag))
    # every step ran the coder's kernel and no other
    mine = FORMULATION_KERNEL[coder.formulation]
    for step, counts in launches.items():
        if counts[mine] == 0 or any(n for name, n in counts.items()
                                    if name != mine):
            raise AssertionError(f"{tag}{step}: launches {counts}, want "
                                 f"only {mine}")
    log({"phase": f"{tag}summary", "formulation": coder.formulation,
         "dat_bytes": dat_size, "needles": len(sizes),
         "deleted": len(deleted), "needles_on_victims": on_victims,
         "launches": launches, "rebuilt_sha256_equal": True,
         "decoded_equal": True, "sink_digests_equal": True})
    return launches, shard_sha


class env_set:
    """Set environment variables in this process for a block (None
    unsets one), and restore them after."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        for k, v in self.values.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


class feed_recorder:
    """Record the feeds the pipeline opens during a block (the objects
    open_feed and ShardFeed return, whose class and O_DIRECT flags say
    what ran)."""

    def __enter__(self):
        self.feeds = []
        self.real = (feed.open_feed, feed.ShardFeed)

        def recorder(make):
            def recording(*args, **kwargs):
                f = make(*args, **kwargs)
                # mapped files, at open (close() drops the maps)
                mapped = (any(v is not None for v in f._views)
                          if hasattr(f, "_views")
                          else getattr(f, "_mm", None) is not None)
                self.feeds.append((f, mapped))
                return f
            return recording

        pipeline.feed_mod.open_feed = recorder(self.real[0])
        pipeline.feed_mod.ShardFeed = recorder(self.real[1])
        return self

    def __exit__(self, *exc):
        pipeline.feed_mod.open_feed, pipeline.feed_mod.ShardFeed = self.real

    def describe(self) -> list:
        out = []
        for f, mapped in self.feeds:
            readers = getattr(f, "_rds", None) or (
                [f._rd] if hasattr(f, "_rd") else [])
            out.append({"feed": type(f).__name__, "readers": f.readers,
                        "pinned": f.pool.pinned, "mapped": mapped,
                        "odirect_engaged": bool(readers) and all(
                            rd.direct for rd in readers)})
        return out


def shard_shas(base: str, g: geometry.Geometry) -> dict:
    return {i: sha256_file(base + geometry.to_ext(i))
            for i in range(g.total_shards)}


def last_stage_totals() -> dict:
    """The ec.* span totals (count, seconds) of the trace of the last
    wide event: the run that just ended."""
    trace = wideevents.events(svc="ec")[-1]["trace"]
    return {k: {"count": c, "seconds": us / 1e6} for k, (c, us) in
            sorted(observe.stage_totals(trace, prefix="ec.").items())}


def governed_encode(label: str, base: str, coder, g: geometry.Geometry,
                    want_sha: dict) -> dict:
    """One stream_encode(base, coder) with no batch size or depth; logs
    the planned operating point, the run's ec.* span totals, GB/s, the
    staging pool's allocation time and the feed, and checks the shards."""
    dat_size = os.path.getsize(base + ".dat")
    reg = metrics.shared("ec")
    # plan() is a pure function of the governor's state: this preview is
    # the point the run plans
    op = governor.get().plan(dat_size, g.data_shards)
    alloc0 = (reg.value("feed_pool_alloc_seconds"),
              reg.value("feed_pool_alloc_bytes"))
    with feed_recorder() as rec, \
            call_counter(pipeline, "host_row_digests") as host_sums:
        t0 = time.perf_counter()
        _, launches = counted(lambda: pipeline.stream_encode(base, coder, g))
        secs = time.perf_counter() - t0
    totals = last_stage_totals()
    same = shard_shas(base, g) == want_sha and host_sums.calls == 0
    row = {"phase": f"governed.{label}", "seconds": secs, "bytes": dat_size,
           "gbps": dat_size / secs / 1e9,
           "plan": {"batch_size": op.batch_size, "depth": op.depth,
                    "write_depth": op.write_depth, "readers": op.readers,
                    "formulation": op.formulation,
                    "steered_formulation": pipeline._steer_formulation(
                        coder, op).formulation,
                    "coder_formulation": coder.formulation},
           "stage_totals": totals,
           "pool_alloc_s": reg.value("feed_pool_alloc_seconds") - alloc0[0],
           "pool_alloc_bytes": reg.value("feed_pool_alloc_bytes")
           - alloc0[1],
           "feeds": rec.describe(), "launches": launches,
           "host_digest_calls": host_sums.calls,
           "sha256_equal_pinned": same}
    log(row)
    if not same:
        raise AssertionError(f"governed {label}: shards differ from the "
                             f"pinned run's, or the host summed digests")
    return row


def device_busy(fn, trace_path: Path) -> tuple:
    """(fn's result, the device's busy ledger over fn): fn runs under
    torch.profiler (CPU and CUDA activities); the exported Chrome trace's
    kernel and memcpy/memset events give the device's time, their union
    the busy time, and the host clock around fn the window."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(str(trace_path))
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = {"kernel": [], "gpu_memcpy": [], "gpu_memset": []}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in spans:
            spans[e["cat"]].append((float(e["ts"]),
                                    float(e["ts"]) + float(e["dur"])))
    intervals = sorted(iv for ivs in spans.values() for iv in ivs)
    busy, end = 0.0, None
    for a, b in intervals:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    ledger = {"wall_s": wall,
              "kernel_s": sum(b - a for a, b in spans["kernel"]) / 1e6,
              "memcpy_s": sum(b - a for a, b in spans["gpu_memcpy"]) / 1e6,
              "kernels": len(spans["kernel"]),
              "memcpys": len(spans["gpu_memcpy"]),
              "busy_s": busy / 1e6}
    ledger["idle_share"] = (1 - ledger["busy_s"] / wall if intervals
                            else "not measured")
    return result, ledger


def run_governed(work: Path, coder, g: geometry.Geometry, volume: dict,
                 want_sha: dict, device: torch.device) -> dict:
    """The governed pipeline on copies of a source volume (phase 3d);
    returns the launches per step."""
    governor.reset()
    observe.reset()
    wideevents.reset()
    faults.clear()
    shutil.copytree(volume["dir"], work / "a")
    base = str(work / "a" / "1")
    launches = {}
    for i in range(3):
        launches[f"governed_encode_{i}"] = governed_encode(
            f"encode_{i}", base, coder, g, want_sha)["launches"]

    # a fourth governed run under torch.profiler: the device's busy and
    # idle share over an encode (the profiler's own cost included)
    (_, launches["governed_encode_profiled"]), ledger = device_busy(
        lambda: counted(lambda: pipeline.stream_encode(base, coder, g)),
        work / "trace.json")
    same = shard_shas(base, g) == want_sha
    log({"phase": "governed.encode_profiled", **ledger,
         "launches": launches["governed_encode_profiled"],
         "sha256_equal_pinned": same})
    if not same:
        raise AssertionError("profiled governed encode differs")

    # encode_many over two copies and a governed rebuild of the four
    # victims on each feed (the mmap feed's plain encodes ran above)
    (work / "b").mkdir()
    base_b = str(work / "b" / "1")
    shutil.copyfile(base + ".dat", base_b + ".dat")
    for tag, env in [("", {}), ("_preadv", {"WEED_EC_MMAP": "0"}),
                     ("_odirect", {"WEED_EC_ODIRECT": "1"})]:
        with env_set(**env):
            if tag:
                launches[f"governed_encode{tag}"] = governed_encode(
                    f"encode{tag}", base, coder, g, want_sha)["launches"]
            with feed_recorder() as rec:
                t0 = time.perf_counter()
                n, launches[f"governed_encode_many{tag}"] = counted(
                    lambda: pipeline.stream_encode_many([base, base_b],
                                                        coder, g))
                secs = time.perf_counter() - t0
            same = (n == 2 and shard_shas(base, g) == want_sha
                    and shard_shas(base_b, g) == want_sha)
            log({"phase": f"governed.encode_many{tag}", "volumes": n,
                 "seconds": secs,
                 "gbps": 2 * os.path.getsize(base + ".dat") / secs / 1e9,
                 "stage_totals": last_stage_totals(),
                 "feeds": rec.describe(),
                 "launches": launches[f"governed_encode_many{tag}"],
                 "sha256_equal_pinned": same})
            if not same:
                raise AssertionError(f"stream_encode_many{tag} shards "
                                     f"differ")
            for v in VICTIMS:
                os.remove(base + geometry.to_ext(v))
            with feed_recorder() as rec:
                rebuilt, launches[f"governed_rebuild{tag}"] = timed(
                    f"governed.stream_rebuild{tag}",
                    lambda: counted(
                        lambda: pipeline.stream_rebuild(base, coder, g)),
                    lambda r: os.path.getsize(base + geometry.to_ext(1))
                    * g.data_shards,
                    lambda r: {"launches": r[1],
                               "stage_totals": last_stage_totals(),
                               "feeds": rec.describe()})
            if rebuilt != list(VICTIMS) or shard_shas(base, g) != want_sha:
                raise AssertionError(f"governed rebuild{tag} of {rebuilt} "
                                     f"differs")
    shutil.rmtree(work / "b")

    # the fault drill, on the preadv feed (every read passes the hook)
    with env_set(WEED_EC_MMAP="0"):
        os.remove(base + ".ecm")
        faults.set_fault("ec.feed.read", "error")
        try:
            pipeline.stream_encode(base, coder, g)
        except faults.FaultError as e:
            raised = repr(e)
        else:
            raise AssertionError("armed ec.feed.read did not fail the run")
        finally:
            armed = faults.active()
            faults.clear()
        if os.path.exists(base + ".ecm"):
            raise AssertionError("a failed encode left a .ecm")
        pipeline.stream_encode(base, coder, g)
    same = os.path.exists(base + ".ecm") and shard_shas(base, g) == want_sha
    log({"phase": "governed.fault_drill", "raised": raised,
         "fired": armed[0]["fired"] if armed else 0,
         "no_ecm_after_fault": True, "after_clear_sha256_equal": same})
    if not same:
        raise AssertionError("encode after faults.clear() differs")

    # the tensor-core kernel's entry at the main path's batch shape
    rows, launches["mxu_entry"] = timed(
        "mxu_entry.parity_vs_shards",
        lambda: counted(lambda: check_parity_with(
            base, g, device,
            apply=lambda w, x: rs_cuda.gf_apply(w, x, repack="mxu"))),
        lambda r: r[0] * g.total_shards, lambda r: {"launches": r[1]})
    log({"phase": "governed.metrics",
         "ec_registry": metrics.render_shared().strip().splitlines()})
    shutil.rmtree(work, ignore_errors=True)
    return launches


# --- phase 6: the Store EC lifecycle and the fused warm-down -----------

class StoreReader:
    """read_all's view of one volume id of a Store."""

    def __init__(self, store, vid: int):
        self.store, self.vid = store, vid

    def read_needle(self, nid: int, cookie=None):
        return self.store.read_needle(self.vid, nid, cookie=cookie)


# steps of phase 6 that run the coder (gf_apply must launch there); every
# other step launches no kernel at all
STORE_CODER_STEPS = ("store.ec_generate", "store.read_degraded",
                     "store.ec_rebuild", "fused.ec_fused_generate",
                     "fused.read_degraded")


def check_store_launches(launches: dict) -> None:
    for step, counts in launches.items():
        others = {k: n for k, n in counts.items() if k != "gf_apply" and n}
        if others or (step in STORE_CODER_STEPS) != (counts["gf_apply"] > 0):
            raise AssertionError(f"{step}: launches {counts}")


def check_ecm_digests(base: str, g: geometry.Geometry, tag: str) -> None:
    stamped = pipeline.read_stamped_digests(base)
    files = pipeline.shard_file_digest(base, range(g.total_shards))
    if [stamped.get(i) for i in range(g.total_shards)] != files.tolist():
        raise AssertionError(f"{tag}: .ecm digests {stamped} != shard "
                             f"files {files.tolist()}")


def run_store_default(work: Path, device: torch.device,
                      total: int = 1 << 30,
                      min_on_victims: int = 200) -> dict:
    """(6a) The default collection, RS(10,4), through Store(coder_name=
    "auto"): write, ec_generate, reopen, reads, degraded reads,
    ec_blob_delete, ec_rebuild, ec_to_volume. Returns launches per step."""
    work.mkdir(parents=True)
    directory = str(work)
    base = os.path.join(directory, "1")
    seed = SEED + 6
    launches = {}
    # the governor's plan starts afresh, not from phase 3's retuning
    governor.reset()
    observe.reset()
    wideevents.reset()
    st = store_mod.Store([directory], coder_name="auto")
    g = st.geometry_for("")
    if (g.data_shards, g.parity_shards) != (10, 4):
        raise AssertionError(f"default collection geometry {g}")
    st.add_volume(1)
    sizes, deleted = timed(
        "store.write_volume",
        lambda: write_needles(lambda n: st.write_needle(1, n),
                              lambda n: st.delete_needle(1, n),
                              st.find_volume(1).data_file_size, total,
                              4 * MIB, seed),
        lambda r: st.find_volume(1).data_file_size(),
        lambda r: {"needles": len(r[0]), "deleted": len(r[1])})
    st.find_volume(1).sync()
    dat_size = os.path.getsize(base + ".dat")
    shutil.copyfile(base + ".dat", str(work / "source.dat"))
    with call_counter(pipeline, "host_row_digests") as host_sums:
        shard_ids, launches["store.ec_generate"] = timed(
            "store.ec_generate", lambda: counted(lambda: st.ec_generate(1)),
            lambda r: dat_size, lambda r: {"launches": r[1]})
    if shard_ids != list(range(14)) or host_sums.calls:
        raise AssertionError(f"ec_generate gave {shard_ids}, "
                             f"{host_sums.calls} host digest sums")
    check_ecm_digests(base, g, "store.ec_generate")
    timed("store.parity_vs_plain",
          lambda: check_parity_with(base, g, device),
          lambda shard: shard * g.total_shards)
    shard_sha = shard_shas(base, g)
    # the shards take over: the volume goes, the reopened store finds
    # the EC volume through load_existing
    st.delete_volume(1)
    st.close()
    st = store_mod.Store([directory], coder_name="auto")
    try:
        ev = st.find_ec_volume(1)
        if ev is None or ev.shard_ids() != list(range(14)):
            raise AssertionError("reopened store: EC volume 1 has shards "
                                 f"{ev and ev.shard_ids()}")
        reader = StoreReader(st, 1)
        _, launches["store.read"] = timed(
            "store.read_all_shards",
            lambda: counted(lambda: read_all(reader, sizes, deleted, seed)),
            lambda r: r[0]["bytes"],
            lambda r: {"launches": r[1],
                       **latency_summary(r[0]["latencies"])})
        on_victims = needles_on(ev, sizes, deleted, VICTIMS)
        st.ec_delete_shards(1, "", list(VICTIMS))
        if ev.shard_ids() != [i for i in range(14) if i not in VICTIMS] \
                or any(os.path.exists(base + geometry.to_ext(v))
                       for v in VICTIMS):
            raise AssertionError("ec_delete_shards left shards")
        _, launches["store.read_degraded"] = timed(
            "store.read_degraded",
            lambda: counted(lambda: read_all(reader, sizes, deleted, seed)),
            lambda r: r[0]["bytes"],
            lambda r: {"launches": r[1], "needles_on_victims": on_victims,
                       **latency_summary(r[0]["latencies"])})
        if on_victims < min_on_victims:
            raise AssertionError(f"{on_victims} needles on the lost shards")
        live = sorted(n for n in sizes if n not in deleted)
        gone = set(live[:8])
        _, launches["store.ec_blob_delete"] = counted(
            lambda: [st.ec_blob_delete(1, nid) for nid in sorted(gone)])
        for nid in gone:
            try:
                st.read_needle(1, nid)
            except KeyError:
                continue
            raise AssertionError(f"blob-deleted needle {nid} readable")
        if os.path.getsize(base + ".ecj") != 8 * len(gone):
            raise AssertionError(".ecj does not journal the deletes")
        rebuilt, launches["store.ec_rebuild"] = timed(
            "store.ec_rebuild", lambda: counted(lambda: st.ec_rebuild(1)),
            lambda r: os.path.getsize(base + geometry.to_ext(1))
            * g.data_shards, lambda r: {"launches": r[1]})
        if rebuilt != list(VICTIMS) or any(
                sha256_file(base + geometry.to_ext(v)) != shard_sha[v]
                for v in VICTIMS):
            raise AssertionError(f"ec_rebuild of {rebuilt} differs")
        folded = all(st_types.size_is_deleted(ev.find_needle(nid)[1])
                     for nid in gone)
        if os.path.exists(base + ".ecj") or not folded:
            raise AssertionError(".ecj not folded into the .ecx")
        _, launches["store.ec_to_volume"] = timed(
            "store.ec_to_volume",
            lambda: counted(lambda: st.ec_to_volume(1)),
            lambda r: dat_size)
        decoded = os.path.getsize(base + ".dat")
        # the decoded .dat ends at the last live needle (FindDatFileSize):
        # the source's tail past it is the deletes' tombstone records
        with open(base + ".dat", "rb") as a, \
                open(str(work / "source.dat"), "rb") as b:
            while True:
                chunk = a.read(16 * MIB)
                if chunk != b.read(len(chunk)):
                    raise AssertionError("decoded .dat differs from the "
                                         "source")
                if not chunk:
                    break
        if st.find_volume(1) is None or st.find_ec_volume(1) is not None:
            raise AssertionError("ec_to_volume did not restore the volume")
        _, launches["store.read_restored"] = timed(
            "store.read_restored",
            lambda: counted(lambda: read_all(reader, sizes,
                                             deleted | gone, seed)),
            lambda r: r[0]["bytes"], lambda r: {"launches": r[1]})
    finally:
        st.close()
    check_store_launches(launches)
    log({"phase": "store.summary", "geometry": "RS(10,4)",
         "dat_bytes": dat_size, "decoded_dat_bytes": decoded,
         "needles": len(sizes), "deleted": len(deleted),
         "blob_deleted": len(gone), "needles_on_victims": on_victims,
         "reopen_found_shards": 14, "rebuilt_sha256_equal": True,
         "decoded_equal_source_prefix": True, "launches": launches})
    shutil.rmtree(work, ignore_errors=True)
    return launches


@functools.cache
def already_gzipped() -> bytes:
    return compression.compress(b"already " * 600)


def archive_needle(seed: int, nid: int) -> Needle:
    """The fused warm-down tests' five payload kinds
    (tests/test_fused_warmdown.py:95-126): compressible text, random
    bytes, tiny, already gzipped, bulky; names and mimes on every third."""
    rng = np.random.default_rng((seed, nid))
    kind = nid % 5
    if kind == 0:
        data = b"compressible text block " * int(rng.integers(1, 400))
    elif kind == 1:
        data = rng.bytes(int(rng.integers(1, 9000)))
    elif kind == 2:
        data = b"x" * int(rng.integers(1, 7))
    elif kind == 3:
        data = already_gzipped()
    else:
        data = b"padme" * int(rng.integers(100, 5000))
    n = Needle(cookie=nid * 7919 & 0xFFFFFFFF, id=nid, data=data)
    if kind == 3:
        n.set_flag(FLAG_IS_COMPRESSED)
    if nid % 3 == 0:
        n.name = f"file-{nid}.txt".encode()
        n.mime = b"text/plain"
        n.set_flag(FLAG_HAS_NAME)
        n.set_flag(FLAG_HAS_MIME)
    return n


def sequential_compact(volume, dst_dat: str, gzip_level: int = 1) -> int:
    """The chain the fused pass replaces, up to its .dat: per-needle reads
    of the live needles in offset order and the same gzip rule
    (tests/test_fused_warmdown.py:48-92). Returns the .dat size."""
    with volume._lock:
        snapshot = sorted((nv for nv in volume.nm.values()
                           if st_types.size_is_valid(nv.size)),
                          key=lambda nv: nv.offset)
        sb = SuperBlock(
            version=volume.super_block.version,
            replica_placement=volume.super_block.replica_placement,
            ttl=volume.super_block.ttl,
            compaction_revision=volume.super_block.compaction_revision + 1,
            extra=volume.super_block.extra)
    with open(dst_dat, "wb") as dat:
        dat.write(sb.to_bytes())
        offset = len(sb.to_bytes())
        for nv in snapshot:
            n = volume.read_needle_at(st_types.stored_to_offset(nv.offset),
                                      nv.size)
            if n.data and not n.is_compressed:
                head = n.data[:4096]
                trial = compression.compress(head, level=gzip_level)
                if len(trial) * 10 < len(head) * 9:
                    comp = compression.compress(n.data, level=gzip_level)
                    if len(comp) * 10 < len(n.data) * 9:
                        n.data = comp
                        n.set_flag(FLAG_IS_COMPRESSED)
            pad = (-offset) % st_types.NEEDLE_PADDING_SIZE
            dat.write(bytes(pad))
            record = n.to_bytes(volume.version)
            dat.write(record)
            offset += pad + len(record)
    return offset


# 6b reads every 8th needle (about 21000 of 168000 live ones, the first
# needle and each 8th after it): reading all took 135 s of the smoke
FUSED_READ_STRIDE = 8


def run_store_archive(work: Path, device: torch.device,
                      total: int = 1 << 30) -> dict:
    """(6b) The archive collection, RS(20,4), through the fused warm-down
    of Store(coder_name="auto"). Returns launches per step."""
    work.mkdir(parents=True)
    directory = str(work)
    base = os.path.join(directory, "archive_2")
    seed = SEED + 7
    launches = {}
    governor.reset()
    observe.reset()
    wideevents.reset()
    st = store_mod.Store([directory], coder_name="auto")
    try:
        g = st.geometry_for("archive")
        if (g.data_shards, g.parity_shards) != (20, 4):
            raise AssertionError(f"archive collection geometry {g}")
        vol = st.add_volume(2, collection="archive")

        def fill() -> tuple[int, set]:
            nid = 0
            while vol.data_file_size() < total:
                nid += 1
                st.write_needle(2, archive_needle(seed, nid))
            rng = np.random.default_rng(seed)
            # upstream's default vacuum garbageThreshold, 0.3
            gone = {int(i) + 1 for i in rng.choice(nid, size=int(0.3 * nid),
                                                   replace=False)}
            for d in sorted(gone):
                st.delete_needle(2, Needle(cookie=d * 7919 & 0xFFFFFFFF,
                                           id=d))
            return nid, gone

        count, deleted = timed(
            "fused.write_volume", fill, lambda r: vol.data_file_size(),
            lambda r: {"needles": r[0], "deleted": len(r[1])})
        src_bytes = vol.data_file_size()
        seq_size = timed(
            "fused.sequential_reference",
            lambda: sequential_compact(vol, str(work / "seq.dat")),
            lambda r: src_bytes)
        with call_counter(store_mod.ec_fused,
                          "fused_vacuum_gzip_encode") as rec:
            t0 = time.perf_counter()
            shard_ids, launches["fused.ec_fused_generate"] = counted(
                lambda: st.ec_fused_generate(2))
            secs = time.perf_counter() - t0
        stats = rec.results[0]
        marker = striping.read_marker_geometry(base)
        if shard_ids != list(range(24)) or marker != g:
            raise AssertionError(f"ec_fused_generate gave {shard_ids}, "
                                 f"marker {marker}")
        log({"phase": "fused.ec_fused_generate", "seconds": secs,
             "src_bytes": src_bytes, "gbps": src_bytes / secs / 1e9,
             **{k: stats[k] for k in (
                 "live_needles", "gzipped_needles", "gzip_s",
                 "gzip_workers", "compacted_bytes", "batch_size",
                 "readers", "commit_s")},
             "stage_totals": last_stage_totals(),
             "launches": launches["fused.ec_fused_generate"]})
        if stats["live_needles"] != count - len(deleted) or \
                not stats["gzipped_needles"]:
            raise AssertionError(f"fused stats {stats}")
        leftovers = [n for n in os.listdir(directory) if ".fusing" in n]
        if leftovers:
            raise AssertionError(f"staging files left: {leftovers}")
        check_ecm_digests(base, g, "fused")
        timed("fused.parity_vs_plain",
              lambda: check_parity_with(base, g, device),
              lambda shard: shard * g.total_shards)
        # decode a copy of the data shards: equal to the sequential chain
        (work / "decode").mkdir()
        dec = str(work / "decode" / "2")
        for i in range(g.data_shards):
            os.link(base + geometry.to_ext(i), dec + geometry.to_ext(i))
        with open(base + ".ecm") as f:
            dat_size = json.load(f)["dat_size"]
        striping.write_dat_file(dec, dat_size, g)
        if dat_size != seq_size or \
                sha256_file(dec + ".dat") != sha256_file(str(work /
                                                             "seq.dat")):
            raise AssertionError(f"fused .dat ({dat_size} bytes) differs "
                                 f"from the sequential chain's ({seq_size})")
        shutil.rmtree(work / "decode")
        # every live needle through an EcVolume with 4 shards lost
        ev = ec_volume.EcVolume(directory, "archive", 2, g,
                                coder=st.coder(g))

        def read_back() -> dict:
            nbytes, lat, on_victims = 0, [], 0
            for nid in range(1, count + 1, FUSED_READ_STRIDE):
                if nid in deleted:
                    try:
                        ev.read_needle(nid)
                    except KeyError:
                        continue
                    raise AssertionError(f"deleted needle {nid} readable")
                _, _, ivs = ev.locate(nid)
                on_victims += any(iv.to_shard_id_and_offset(g)[0]
                                  in VICTIMS for iv in ivs)
                t0 = time.perf_counter()
                n = ev.read_needle(nid, cookie=nid * 7919 & 0xFFFFFFFF)
                lat.append(time.perf_counter() - t0)
                want = archive_needle(seed, nid)
                got = (compression.decompress(n.data) if n.is_compressed
                       else n.data)
                if got != (compression.decompress(want.data)
                           if want.is_compressed else want.data):
                    raise AssertionError(f"needle {nid} reads back wrong")
                nbytes += len(got)
            return {"bytes": nbytes, "latencies": lat,
                    "on_victims": on_victims}

        try:
            for sid in range(g.total_shards):
                if sid not in VICTIMS:
                    ev.add_shard(sid)
            _, launches["fused.read_degraded"] = timed(
                "fused.read_degraded", lambda: counted(read_back),
                lambda r: r[0]["bytes"],
                lambda r: {"launches": r[1],
                           "needles_on_victims": r[0]["on_victims"],
                           **latency_summary(r[0]["latencies"])})
        finally:
            ev.close()
    finally:
        st.close()
    check_store_launches(launches)
    log({"phase": "fused.summary", "geometry": "RS(20,4)",
         "src_bytes": src_bytes, "compacted_bytes": dat_size,
         "needles": count, "deleted": len(deleted),
         "decoded_equal_sequential": True, "parity_equal_plain": True,
         "ecm_digests_equal_files": True, "launches": launches})
    shutil.rmtree(work, ignore_errors=True)
    return launches


# --- phase 7: the cluster through the port's servers -------------------

CLUSTER_COLLECTION = "ecsmoke"
# steps of phases 7 and 8 that run the coder (gf_apply must launch
# there); every other step launches no kernel at all
CLUSTER_CODER_STEPS = ("cluster.ec_encode", "cluster.read_one_shard_lost",
                       "cluster.read_server_lost", "cluster.ec_rebuild",
                       "replicated.ec_encode",
                       "replicated.read_server_lost",
                       "replicated.ec_rebuild")


def upload_needles(client, vid: int, size_now, total: int,
                   max_needle: int, seed: int, collection: str,
                   replication: str = "",
                   delete_share: int = 20) -> tuple[dict, set]:
    """write_needles over HTTP: each needle assigned by the master and
    POSTed to the volume server (which fans it out to the volume's other
    holders); then one in `delete_share` deleted with HTTP DELETE, none
    when it is 0. Returns fid -> (payload seed id, size), and the
    deleted fids."""
    rng = np.random.default_rng(seed)
    fids: dict = {}
    nid = 0
    while size_now() < total:
        nid += 1
        size = int(np.exp(rng.uniform(np.log(1024), np.log(max_needle))))
        size = min(size, total - size_now())
        a = client.assign(collection=collection, replication=replication)
        if int(a["fid"].split(",")[0]) != vid:
            raise AssertionError(f"assigned {a['fid']}, not volume {vid}")
        client.upload_blob(a["url"], a["fid"], payload(seed, nid, size))
        fids[a["fid"]] = (nid, size)
    deleted: set = set()
    if delete_share:
        deleted = {str(fid) for fid in rng.choice(
            sorted(fids), size=max(1, len(fids) // delete_share),
            replace=False)}
    for fid in sorted(deleted):
        client.delete(fid)
    return fids, deleted


def http_read_all(client, fids: dict, deleted: set, seed: int,
                  url: str = "") -> dict:
    """Every live needle read back over HTTP byte-identical (from the
    holder `url`, or the holder from the master's lookup), every deleted
    one refused with 404; returns the bytes read and each live read's
    latency."""
    client._vid_cache.clear()
    nbytes, lat = 0, []
    for fid, (nid, size) in fids.items():
        if fid in deleted:
            try:
                client.download(fid, url=url)
            except ClientError as e:
                if "HTTP 404" not in str(e):
                    raise
                continue
            raise AssertionError(f"deleted needle {fid} still readable")
        t0 = time.perf_counter()
        data = client.download(fid, url=url)
        lat.append(time.perf_counter() - t0)
        if data != payload(seed, nid, size):
            raise AssertionError(f"needle {fid} reads back wrong")
        nbytes += size
    return {"bytes": nbytes, "latencies": lat}


def needles_on_shards(ev, fids: dict, deleted: set, shards) -> int:
    return needles_on(ev, {FileId.parse(f).key: 0 for f in fids},
                      {FileId.parse(f).key for f in deleted}, tuple(shards))


def wait_until(cond, what: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


def check_cluster_launches(launches: dict) -> None:
    for step, counts in launches.items():
        others = {k: n for k, n in counts.items() if k != "gf_apply" and n}
        if others or (step in CLUSTER_CODER_STEPS) != (counts["gf_apply"]
                                                       > 0):
            raise AssertionError(f"{step}: launches {counts}")


def run_cluster(work: Path, device: torch.device, total: int = 1 << 30,
                pulse: float = 0.5) -> dict:
    """(7a) A master and 3 volume servers in this process
    (``Store(coder_name="auto")`` each) on loopback ports; the client,
    the shell's EcCommands and every server-to-server call go over HTTP.
    Returns launches per step."""
    work.mkdir(parents=True)
    seed = SEED + 8
    col = CLUSTER_COLLECTION
    launches = {}
    governor.reset()
    observe.reset()
    wideevents.reset()
    # the shell's rebuild and fix, not the repair daemon, heal phases 7
    # and 8 (the daemon would race them and change what they measure)
    cl = LocalCluster(3, coder_name="auto", volume_size_limit_mb=1024,
                      pulse=pulse, directory=str(work), racks=1,
                      master_kwargs={"repair_enabled": False})
    try:
        client = Client(cl.master_url)
        grown = client.grow(count=1, collection=col)
        if grown.get("count") != 1:
            raise AssertionError(f"/vol/grow: {grown}")
        vid = grown["volume_ids"][0]
        src = cl.index_of(client.lookup(vid)[0])
        vol = cl.store(src).find_volume(vid)
        fids, deleted = timed(
            "cluster.upload",
            lambda: upload_needles(client, vid, vol.data_file_size, total,
                                   4 * MIB, seed, col),
            lambda r: vol.data_file_size(),
            lambda r: {"needles": len(r[0]), "deleted": len(r[1]),
                       "volume_id": vid})
        # the sealed .dat, copied before the encode
        client.volume_admin(cl.url(src), "volume/readonly",
                            {"volume_id": vid, "read_only": True})
        vol.sync()
        dat_size = vol.data_file_size()
        sealed = str(work / "sealed.dat")
        shutil.copyfile(vol.base_file_name() + ".dat", sealed)
        shell = EcCommands(client)
        result, launches["cluster.ec_encode"] = timed(
            "cluster.ec_encode", lambda: counted(
                lambda: shell.encode(vid, col)),
            lambda r: dat_size, lambda r: {"launches": r[1]})
        info = client.ec_lookup(vid)
        holders: dict = {}
        for sid, urls in info["shards"].items():
            for u in urls:
                holders.setdefault(u, []).append(int(sid))
        spread = sorted(len(s) for s in holders.values())
        if len(info["shards"]) != 14 or spread != [4, 5, 5]:
            raise AssertionError(f"shards {info['shards']}")
        if any(cl.store(i).find_volume(vid) is not None for i in range(3)):
            raise AssertionError("the original volume is still mounted")
        # the shards gathered from the three directories: the parity
        # equals the plain version's over the data shards, and the data
        # shards decode to the sealed copy
        g = geometry.DEFAULT
        gather = work / "gather"
        gather.mkdir()
        base = str(gather / f"{col}_{vid}")
        for url, sids in holders.items():
            node_base = os.path.join(cl.nodes[cl.index_of(url)][3],
                                     f"{col}_{vid}")
            for sid in sids:
                os.symlink(node_base + geometry.to_ext(sid),
                           base + geometry.to_ext(sid))
        timed("cluster.parity_vs_plain",
              lambda: check_parity_with(base, g, device),
              lambda shard: shard * g.total_shards)
        striping.write_dat_file(base, dat_size, g)
        if sha256_file(base + ".dat") != sha256_file(sealed):
            raise AssertionError("the data shards do not decode to the "
                                 "sealed .dat")
        orig_sha = shard_shas(base, g)
        shutil.rmtree(gather)
        os.remove(sealed)
        log({"phase": "cluster.spread", "shards_per_server": spread,
             "parity_equal_plain": True, "data_equal_sealed": True,
             "volume_retired": True})

        def read_step(name: str, **extra):
            _, launches[name] = timed(
                name, lambda: counted(
                    lambda: http_read_all(client, fids, deleted, seed)),
                lambda r: r[0]["bytes"],
                lambda r: {"launches": r[1], **extra,
                           **latency_summary(r[0]["latencies"])})

        read_step("cluster.read_all_shards")
        # one data shard of the server with 4 goes (the SURVEY section 7
        # exit test), then that server: 4 shards lost in all
        lost_url = next(u for u, s in holders.items() if len(s) == 4)
        lost = cl.index_of(lost_url)
        victim = min(holders[lost_url])
        reader = cl.index_of(client.lookup(vid)[0])
        on_victim = needles_on_shards(cl.store(reader).find_ec_volume(vid),
                                      fids, deleted, [victim])
        client.volume_admin(lost_url, "ec/delete_shards",
                            {"volume_id": vid, "collection": col,
                             "shard_ids": [victim]})
        read_step("cluster.read_one_shard_lost", lost_shard=victim,
                  needles_on_lost=on_victim)
        on_lost = needles_on_shards(cl.store(reader).find_ec_volume(vid),
                                    fids, deleted, holders[lost_url])
        cl.stop_volume_server(lost)
        wait_until(lambda: lost_url not in {
            u for us in client.ec_lookup(vid)["shards"].values()
            for u in us}, "the master to prune the stopped server")
        read_step("cluster.read_server_lost", lost_shards=holders[lost_url],
                  needles_on_lost=on_lost)
        if on_victim < 20 or on_lost < 200:
            raise AssertionError(f"{on_victim} / {on_lost} needles on the "
                                 "lost shards")
        rb, launches["cluster.ec_rebuild"] = timed(
            "cluster.ec_rebuild", lambda: counted(
                lambda: shell.rebuild(vid, col)),
            lambda r: shard_size_of(r[0], cl, col, vid) * g.data_shards,
            lambda r: {"launches": r[1], "rebuilder": r[0]["rebuilder"],
                       "rebuilt": r[0]["rebuilt"]})
        if sorted(rb["rebuilt"]) != sorted(holders[lost_url]):
            raise AssertionError(f"rebuilt {rb['rebuilt']}")
        rb_dir = cl.nodes[cl.index_of(rb["rebuilder"])][3]
        for sid in rb["rebuilt"]:
            got = sha256_file(os.path.join(rb_dir, f"{col}_{vid}")
                              + geometry.to_ext(sid))
            if got != orig_sha[sid]:
                raise AssertionError(f"rebuilt shard {sid} differs")
        if len(client.ec_lookup(vid)["shards"]) != 14:
            raise AssertionError("14 shards not mounted after ec.rebuild")
        _, launches["cluster.ec_decode"] = timed(
            "cluster.ec_decode", lambda: counted(
                lambda: shell.decode(vid, col)),
            lambda r: dat_size, lambda r: {"launches": r[1]})
        if client.ec_lookup(vid).get("shards"):
            raise AssertionError("shards left after ec.decode")
        read_step("cluster.read_decoded")
        log({"phase": "cluster.summary", "servers": 3,
             "geometry": "RS(10,4)", "volume_size_limit_mb": 1024,
             "dat_bytes": dat_size, "needles": len(fids),
             "deleted": len(deleted), "shards_per_server": spread,
             "lost_shard": victim, "lost_server_shards": holders[lost_url],
             "rebuilt_sha256_equal": True, "decoded_reads_back": True,
             "launches": dict(launches)})
        # phase 8 in the same cluster
        launches.update(run_replicated(cl, client, total, seed + 100))
    finally:
        cl.shutdown()
    check_cluster_launches(launches)
    shutil.rmtree(work, ignore_errors=True)
    return launches


# --- phase 8: the hot tier: replication, vacuum, repair, then EC --------

REPL_COLLECTION = "repsmoke"
# upstream's "one more copy on the same rack"
REPL_PLACEMENT = "001"
# upstream's default -garbageThreshold
GARBAGE_THRESHOLD = 0.3
# uploads that run while the vacuum compacts (the makeup-diff replay)
MAKEUP_UPLOADS = 64


def fresh_lookup(client, vid: int) -> list:
    client._vid_cache.clear()
    return client.lookup(vid)


def holder_volume(cl, url: str, vid: int):
    return cl.store(cl.index_of(url)).find_volume(vid)


def holders_of(info: dict) -> dict:
    """url -> shard ids, from a /col/lookup/ec answer."""
    out: dict = {}
    for sid, urls in info["shards"].items():
        for u in urls:
            out.setdefault(u, []).append(int(sid))
    return out


def garbage_level(url: str, vid: int) -> float:
    status, body = http.get_json(
        f"http://{url}/admin/vacuum/check?volume_id={vid}")
    if status != 200:
        raise AssertionError(f"vacuum check on {url}: {body}")
    return body["garbage_level"]


def run_replicated(cl, client, total: int, seed: int) -> dict:
    """(8) In phase 7's cluster, on one rack: a 1 GiB volume of
    collection repsmoke at replication 001 filled over HTTP (every 201
    means both copies are written) and read back from each holder,
    needles deleted until both holders' garbage is at least 0.3,
    /vol/vacuum with 64 uploads running against the volume, every live
    needle read from each holder, one holder
    replaced by a fresh server and restored with volume.fix.replication,
    every needle read from the new copy, then ec.encode (both copies
    retired, shards spread 5/5/4), reads with the 4-shard server lost and
    ec.rebuild. Returns launches per step."""
    col = REPL_COLLECTION
    launches = {}
    for _ in range(3 - cl.node_count()):
        # phase 7 lost a server: a fresh one takes its place
        cl.add_volume_server()
    cl.wait_for_nodes(3)
    grown = client.grow(count=1, collection=col, replication=REPL_PLACEMENT)
    if grown.get("count") != 1:
        raise AssertionError(f"/vol/grow replication 001: {grown}")
    vid = grown["volume_ids"][0]
    primary, replica = client.lookup(vid)
    # fids for the uploads that run during the vacuum, assigned while
    # the volume is writable (the vacuum parks it out of assignment)
    late = [client.assign(collection=col, replication=REPL_PLACEMENT)
            for _ in range(MAKEUP_UPLOADS)]
    if any(int(a["fid"].split(",")[0]) != vid for a in late):
        raise AssertionError("late fids on another volume")
    vol = holder_volume(cl, primary, vid)
    (fids, _), launches["replicated.upload"] = timed(
        "replicated.upload", lambda: counted(lambda: upload_needles(
            client, vid, vol.data_file_size, total, 4 * MIB, seed, col,
            replication=REPL_PLACEMENT, delete_share=0)),
        lambda r: vol.data_file_size(),
        lambda r: {"needles": len(r[0][0]), "volume_id": vid,
                   "replication": REPL_PLACEMENT, "launches": r[1]})
    for url in (primary, replica):
        held = holder_volume(cl, url, vid).file_count()
        if held != len(fids):
            raise AssertionError(f"{url} holds {held} of {len(fids)} "
                                 "needles")
    deleted: set = set()

    def read_step(name: str, url: str = "", **extra):
        _, launches[name] = timed(
            name, lambda: counted(lambda: http_read_all(
                client, fids, deleted, seed, url=url)),
            lambda r: r[0]["bytes"],
            lambda r: {"launches": r[1], **extra,
                       **latency_summary(r[0]["latencies"])})

    # every acknowledged write, from each holder, before the vacuum
    read_step("replicated.read_primary_pre", primary, holder="primary")
    read_step("replicated.read_replica_pre", replica, holder="replica")

    def delete_to_threshold() -> set:
        order = list(np.random.default_rng(seed).permutation(sorted(fids)))
        gone: set = set()
        while min(garbage_level(u, vid) for u in (primary, replica)) \
                < GARBAGE_THRESHOLD:
            if len(gone) == len(order):
                raise AssertionError("every needle deleted, garbage under "
                                     f"{GARBAGE_THRESHOLD}")
            for fid in order[len(gone):len(gone) + 20]:
                client.delete(fid)
                gone.add(fid)
        return gone

    deleted, launches["replicated.delete"] = timed(
        "replicated.delete", lambda: counted(delete_to_threshold), None,
        lambda r: {"deleted": len(r[0]), "launches": r[1],
                   "garbage_levels": [garbage_level(u, vid)
                                      for u in (primary, replica)]})
    before = {u: (holder_volume(cl, u, vid).data_file_size(),
                  holder_volume(cl, u, vid).deleted_size())
              for u in (primary, replica)}
    rng = np.random.default_rng(seed + 1)
    late_fids = {}
    for j, a in enumerate(late):
        size = int(np.exp(rng.uniform(np.log(1024), np.log(4 * MIB))))
        late_fids[a["fid"]] = (10 ** 6 + j, size)
    spans: list = []

    def vacuum_with_uploads() -> dict:
        box: dict = {}

        def run() -> None:
            t0 = time.perf_counter()
            box["result"] = client.vacuum(GARBAGE_THRESHOLD)
            box["span"] = (t0, time.perf_counter())

        th = threading.Thread(target=run, name="smoke-vacuum")
        th.start()
        try:
            for a in late:
                nid, size = late_fids[a["fid"]]
                t0 = time.perf_counter()
                client.upload_blob(a["url"], a["fid"],
                                   payload(seed, nid, size))
                spans.append((t0, time.perf_counter()))
        finally:
            th.join()
        return box

    # GB/s of the vacuum: over both holders' .dat bytes before it
    box, launches["replicated.vacuum"] = timed(
        "replicated.vacuum", lambda: counted(vacuum_with_uploads),
        lambda r: sum(size for size, _ in before.values()),
        lambda r: {"compacted": r[0]["result"]["compacted"],
                   "launches": r[1]})
    if vid not in box["result"]["compacted"]:
        raise AssertionError(f"/vol/vacuum compacted "
                             f"{box['result']['compacted']}, not {vid}")
    v0, v1 = box["span"]
    overlapped = sum(1 for a, b in spans if b > v0 and a < v1)
    fids.update(late_fids)
    reclaimed = {}
    for url in (primary, replica):
        v = holder_volume(cl, url, vid)
        if v.super_block.compaction_revision != 1:
            raise AssertionError(f"{url}: volume {vid} not compacted")
        sizes = dict(v.nm.live_entries())
        added = sum(st_types.get_actual_size(
            sizes[FileId.parse(f).key], v.version) for f in late_fids)
        size_before, deleted_before = before[url]
        reclaimed[url] = size_before + added - v.data_file_size()
        if reclaimed[url] < deleted_before:
            raise AssertionError(f"{url} reclaimed {reclaimed[url]} of "
                                 f"{deleted_before} deleted bytes")
        if v.file_count() != len(fids) - len(deleted):
            raise AssertionError(f"{url} holds {v.file_count()} needles "
                                 "after the vacuum")
    log({"phase": "replicated.reclaimed",
         "reclaimed_bytes": list(reclaimed.values()),
         "deleted_bytes": [before[u][1] for u in (primary, replica)],
         "dat_bytes_before": [before[u][0] for u in (primary, replica)],
         "dat_bytes_after": [holder_volume(cl, u, vid).data_file_size()
                             for u in (primary, replica)],
         "uploads_during_vacuum": overlapped})
    if not overlapped:
        raise AssertionError("no upload overlapped the vacuum")

    read_step("replicated.read_primary", primary, holder="primary")
    read_step("replicated.read_replica", replica, holder="replica")
    # the replica's server is lost; a fresh one, with an empty
    # directory, takes its place
    cl.stop_volume_server(cl.index_of(replica))
    fresh = cl.add_volume_server()
    wait_until(lambda: fresh_lookup(client, vid) == [primary]
               and cl.node_count() == 3,
               "the master to prune the lost holder")
    shell_commands._register_all()
    env = shell_commands.CommandEnv(client)
    out, launches["replicated.fix_replication"] = timed(
        "replicated.fix_replication", lambda: counted(
            lambda: shell_commands.run_command(
                env, ["volume.fix.replication", "-force"])),
        lambda r: holder_volume(cl, primary, vid).data_file_size(),
        lambda r: {"plan": r[0]["plan"], "launches": r[1],
                   "fresh_server": fresh})
    added = [a for a in out["plan"] if a["volume_id"] == vid]
    if [a["action"] for a in added] != ["add"] or sorted(
            fresh_lookup(client, vid)) != sorted([primary, added[0]["to"]]):
        raise AssertionError(f"volume.fix.replication: {out}")
    new_copy = added[0]["to"]
    read_step("replicated.read_new_copy", new_copy,
              holder="volume.fix.replication's copy")
    shell = EcCommands(client)
    dat_size = holder_volume(cl, primary, vid).data_file_size()
    _, launches["replicated.ec_encode"] = timed(
        "replicated.ec_encode", lambda: counted(
            lambda: shell.encode(vid, col)),
        lambda r: dat_size, lambda r: {"launches": r[1]})
    holders = holders_of(client.ec_lookup(vid))
    spread = sorted(len(s) for s in holders.values())
    if spread != [4, 5, 5] or any(
            n[2] is not None and n[2].find_volume(vid) is not None
            for n in cl.nodes):
        raise AssertionError(f"ec.encode left {holders} and the copies")
    lost_url = next(u for u, s in holders.items() if len(s) == 4)
    cl.stop_volume_server(cl.index_of(lost_url))
    wait_until(lambda: lost_url not in holders_of(client.ec_lookup(vid)),
               "the master to prune the 4-shard server")
    read_step("replicated.read_server_lost", lost_shards=holders[lost_url])
    rb, launches["replicated.ec_rebuild"] = timed(
        "replicated.ec_rebuild", lambda: counted(
            lambda: shell.rebuild(vid, col)),
        lambda r: shard_size_of(r[0], cl, col, vid)
        * geometry.DEFAULT.data_shards,
        lambda r: {"launches": r[1], "rebuilt": r[0]["rebuilt"]})
    if sorted(rb["rebuilt"]) != holders[lost_url] or \
            len(client.ec_lookup(vid)["shards"]) != 14:
        raise AssertionError(f"ec.rebuild: {rb}")
    log({"phase": "replicated.summary", "replication": REPL_PLACEMENT,
         "volume_id": vid, "needles": len(fids), "deleted": len(deleted),
         "late_uploads": MAKEUP_UPLOADS, "uploads_during_vacuum": overlapped,
         "reclaimed_bytes": list(reclaimed.values()),
         "shards_per_server": spread, "launches": launches})
    return launches


# --- phase 9: the self-driving warm tier ---------------------------------

LC_COLLECTION = "lcsmoke"
LC_REP = "lcrep"
LC_TMP = "lctmp"
# the lifecycle rules of phase 9 (LifecycleConfig)
LC_WARM_AFTER = 10.0
LC_INTERVAL = 0.5
LC_TTL, LC_TTL_GRACE = 3.0, 1.0
# decayed read rate (reads/s) at which a warm volume decodes back: above
# what steps 2-4 drive (every needle read in turn, mean needle 0.5 MB:
# 106-269 reads/s on the card's hosts) and below what step 7's 8 threads
# drive on 256 small needles read from their shards' holders
LC_HOT_READ_RATE = 400.0
# steps 4 and 7 read a fixed sample: the first needle of each volume
# (in upload order) and each LC_SAMPLE-th after it
LC_SAMPLE = 4
# the volume servers' heat half-life (WEED_LIFECYCLE_HEAT_HALFLIFE, s)
LC_HALFLIFE = "2"
# the longest step 7's reads may take to turn the volume hot
LC_HOT_TIMEOUT = 300.0
# steps of phase 9 that run the coder (gf_apply must launch there, and in
# no other step of the phase)
LIFECYCLE_CODER_STEPS = ("lifecycle.warm_down", "lifecycle.bit_rot",
                         "lifecycle.holder_death")
# launches counted beside the steps': the direct warm-down of the
# snapshot (a check), and the degraded reads inside step 4; both must
# run the coder, and neither adds to the main path's count
LIFECYCLE_CHECKS = ("lifecycle.warm_down_check", "lifecycle.read_degraded")
SMI = [""]


def lc_log(step: str, secs: float, nbytes: int = 0, lat=None,
           launches=None, **extra) -> None:
    """One phase-9 line: wall s, GB/s where bytes moved, read p50/p99,
    launches, and the card beside them."""
    row = {"phase": step, "seconds": secs}
    if nbytes:
        row.update(bytes=nbytes, gbps=nbytes / secs / 1e9)
    if lat:
        row.update(latency_summary(lat))
    if launches is not None:
        row["launches"] = launches
    row.update(extra)
    row["card"] = SMI[0]
    log(row)


def fill_pair(client, url: str, vols: dict, total: int, max_needle: int,
              seed: int) -> tuple[dict, dict]:
    """Phase 3's generator over HTTP into two volumes of one server at
    once, each needle to the emptier volume (the master mints its key and
    cookie), until both hold `total` bytes; then one needle in 20 of each
    deleted. Returns vid -> {fid: (nid, size)} and vid -> deleted fids."""
    rng = np.random.default_rng(seed)
    fids: dict = {vid: {} for vid in vols}
    nid = 0
    while True:
        open_vids = [v for v, vol in vols.items()
                     if vol.data_file_size() < total]
        if not open_vids:
            break
        vid = min(open_vids, key=lambda v: vols[v].data_file_size())
        nid += 1
        size = int(np.exp(rng.uniform(np.log(1024), np.log(max_needle))))
        size = min(size, total - vols[vid].data_file_size())
        minted = FileId.parse(client.assign(collection=LC_COLLECTION)["fid"])
        fid = str(FileId(vid, minted.key, minted.cookie))
        client.upload_blob(url, fid, payload(seed, nid, size))
        fids[vid][fid] = (nid, size)
    deleted = {}
    for vid, f in fids.items():
        deleted[vid] = {str(x) for x in rng.choice(
            sorted(f), size=max(1, len(f) // 20), replace=False)}
        for fid in sorted(deleted[vid]):
            client.delete(fid)
    return fids, deleted


def lc_read(client, step: str, fids: dict, deleted: set, seed: int,
            vid: int, launches: dict, url: str = "",
            stride: int = 1) -> dict:
    """Every needle of one volume over HTTP (or the first and each
    `stride`-th after it, in upload order), counted launches, with the
    master's decayed read rate for the volume after it."""
    fids = {f: v for i, (f, v) in enumerate(fids.items())
            if i % stride == 0}
    t0 = time.perf_counter()
    out, launches[step] = counted(
        lambda: http_read_all(client, fids, deleted, seed, url=url))
    heat = client.volume_heat(vid)["volumes"]
    lc_log(step, time.perf_counter() - t0, out["bytes"], out["latencies"],
           launches[step], volume_id=vid,
           reads_per_s=len(out["latencies"]) / (time.perf_counter() - t0),
           heat_read_rate=heat[0]["read_rate"] if heat else None,
           sampled_every=stride)
    return out


def ec_holders(client, vid: int) -> dict:
    """url -> sorted shard ids of an EC volume ({} when it has none)."""
    info = client.ec_lookup(vid)
    if not info.get("shards"):
        return {}
    return {u: sorted(s) for u, s in holders_of(info).items()}


def holds_normal(cl, vid: int) -> bool:
    return any(n[2] is not None and n[2].find_volume(vid) is not None
               for n in cl.nodes)


def warm_outcomes(client) -> list:
    return [(e["kind"], e["volume"], e["outcome"])
            for e in client.lifecycle_status()["recent"]]


def mounted_on(url: str) -> int:
    return sum(len(s["shard_ids"])
               for s in http.get_json(f"http://{url}/status")[1]
               ["ec_shards"])


def scrub(cl, client, url: str) -> tuple[dict, float]:
    """One scrub pass on `url`: its answer and the shards it checked."""
    vs = cl.nodes[cl.index_of(url)][0]
    before = vs.metrics.value("scrub_shards_checked")
    out = client.volume_admin(url, "ec/scrub", {"throttle_seconds": 0})
    return out, vs.metrics.value("scrub_shards_checked") - before


def shard_file(cl, url: str, col: str, vid: int, sid: int) -> str:
    return os.path.join(cl.nodes[cl.index_of(url)][3],
                        f"{col}_{vid}") + geometry.to_ext(sid)


def run_lifecycle(work: Path, total: int = 1 << 30,
                  small: int = 64 * MIB, max_needle: int = 4 * MIB,
                  limit_mb: int = 1024, pulse: float = 0.5,
                  hot_rate: float = LC_HOT_READ_RATE,
                  coder_name: str = "auto", device=None,
                  hot_threads: int = 8) -> dict:
    """(9) The self-driving warm tier, in its own cluster: a master with
    the lifecycle rules and the repair daemon, and 4 volume servers on
    one rack (``Store(coder_name="auto")`` each, the scrub loop off). No
    operator command from step 2 on: two full idle volumes warm down in
    one fused window, bit rot and a dead holder heal, a lost replica
    comes back, a TTL volume expires, a hot volume decodes back. Returns
    launches per step; those of ``LIFECYCLE_CHECKS`` are also counted in
    a step's or are a check's own."""
    work.mkdir(parents=True)
    seed = SEED + 9
    col = LC_COLLECTION
    launches: dict = {}
    governor.reset()
    observe.reset()
    wideevents.reset()
    cfg = LifecycleConfig(warm_after=LC_WARM_AFTER, interval=LC_INTERVAL,
                          hot_read_rate=hot_rate,
                          collection_ttls={LC_TMP: LC_TTL},
                          ttl_grace=LC_TTL_GRACE)
    with env_set(WEED_LIFECYCLE_HEAT_HALFLIFE=LC_HALFLIFE):
        cl = LocalCluster(
            4, coder_name=coder_name, device=device,
            volume_size_limit_mb=limit_mb, pulse=pulse,
            directory=str(work / "cluster"), racks=1,
            master_kwargs={"lifecycle_config": cfg,
                           "maintenance_interval_seconds": pulse},
            volume_kwargs={"scrub_interval_seconds": 0})
    try:
        client = Client(cl.master_url)
        m = cl.master.metrics
        # 1. two volumes of lcsmoke on one server, filled at once
        src = cl.url(0)
        vids = [1, 2]
        for vid in vids:
            client.volume_admin(src, "assign_volume",
                                {"volume_id": vid, "collection": col})
        vols = {vid: cl.store(0).find_volume(vid) for vid in vids}
        t0 = time.perf_counter()
        (fids, deleted), launches["lifecycle.fill"] = counted(
            lambda: fill_pair(client, src, vols, total, max_needle, seed))
        src_bytes = sum(v.data_file_size() for v in vols.values())
        lc_log("lifecycle.fill", time.perf_counter() - t0, src_bytes,
               launches=launches["lifecycle.fill"],
               volumes=vids, needles=[len(fids[v]) for v in vids],
               deleted=[len(deleted[v]) for v in vids])
        # the last access of both at one instant, so that both turn idle
        # in one pass: the smallest live needle of each, read
        for vid in vids:
            live = [f for f in fids[vid] if f not in deleted[vid]]
            client.download(min(live, key=lambda f: fids[vid][f][1]))
        t_touch = time.monotonic()
        snap = work / "snapshot"
        snap.mkdir()
        vols[vids[0]].sync()
        base0 = vols[vids[0]].base_file_name()
        for ext in (".dat", ".idx"):
            shutil.copyfile(base0 + ext, snap / f"{col}_{vids[0]}{ext}")
        copied_s = time.monotonic() - t_touch
        if copied_s >= LC_WARM_AFTER or any(v.read_only
                                            for v in vols.values()):
            raise AssertionError(f"the snapshot took {copied_s} s")

        # 2. warm-down with no command: seal, one fused window of both,
        # spread 4/4/3/3, 14/14 verified, the originals retired
        def warmed() -> bool:
            return all(len(client.ec_lookup(v).get("shards", {})) == 14
                       and not holds_normal(cl, v) for v in vids)

        def wait_warm():
            wait_until(warmed, "the daemon's warm-down", timeout=900)
            wait_until(lambda: sorted(o for o in warm_outcomes(client)
                                      if o[0] == "warm")
                       == [("warm", v, "ok") for v in vids],
                       "the warm transitions' outcomes")

        _, launches["lifecycle.warm_down"] = counted(wait_warm)
        t_warm = time.monotonic()
        windows = {k: m.value("lifecycle_encode_windows",
                              {"volumes": str(k)}) for k in (1, 2)}
        if windows != {1: 0, 2: 1}:
            raise AssertionError(f"encode windows {windows}, want one "
                                 "of two volumes")
        spreads = {v: sorted(map(len, ec_holders(client, v).values()))
                   for v in vids}
        if any(s != [3, 3, 4, 4] for s in spreads.values()):
            raise AssertionError(f"spreads {spreads}")
        lc_log("lifecycle.warm_down", t_warm - t_touch, src_bytes,
               launches=launches["lifecycle.warm_down"],
               trigger_to_action_s=t_warm - t_touch - LC_WARM_AFTER,
               windows_of_two=windows[2], shards_per_server=spreads[1],
               snapshot_copy_s=copied_s)
        # the direct warm-down of the snapshot: the same 14 shards
        st = store_mod.Store([str(snap)], coder_name=coder_name,
                             device=device)
        try:
            t0 = time.perf_counter()
            _, launches["lifecycle.warm_down_check"] = counted(
                lambda: st.ec_fused_generate(vids[0]))
            check_s = time.perf_counter() - t0
        finally:
            st.close()
        holders0 = ec_holders(client, vids[0])
        for url, sids in holders0.items():
            for sid in sids:
                want = sha256_file(str(snap / f"{col}_{vids[0]}")
                                   + geometry.to_ext(sid))
                if sha256_file(shard_file(cl, url, col, vids[0],
                                          sid)) != want:
                    raise AssertionError(f"shard {sid} differs from "
                                         "ec_fused_generate's")
        shutil.rmtree(snap)
        log({"phase": "lifecycle.warm_down_check", "seconds": check_s,
             "shards_sha256_equal": 14,
             "launches": launches["lifecycle.warm_down_check"],
             "card": SMI[0]})
        for vid in vids:
            lc_read(client, f"lifecycle.read_warm_{vid}", fids[vid],
                    deleted[vid], seed, vid, launches)
        states = {v["volume"]: v["state"]
                  for v in client.volume_heat()["volumes"]}
        if [states.get(v) for v in vids] != ["warm", "warm"]:
            raise AssertionError(f"volume.heat states {states}")

        # 3. bit rot: one byte of a shard flipped, found by the scrub,
        # dropped and rebuilt by the repair daemon
        a, b = vids
        url, sids = max(sorted(ec_holders(client, a).items()),
                        key=lambda kv: len(kv[1]))
        sid = sids[-1]
        path = shard_file(cl, url, col, a, sid)
        want = sha256_file(path)
        ok0 = m.value("repairs_succeeded", {"kind": "ec"})
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0xFF]))
        t_flip = time.monotonic()

        def heal_rot():
            out, checked = scrub(cl, client, url)
            if out["bad"] != {str(a): [sid]} or \
                    checked != mounted_on(url):
                raise AssertionError(f"scrub of {url}: {out}, checked "
                                     f"{checked} of {mounted_on(url)}")
            wait_until(lambda: m.value("repairs_succeeded",
                                       {"kind": "ec"}) > ok0
                       and len(client.ec_lookup(a)["shards"]) == 14,
                       "the rotten shard dropped and rebuilt",
                       timeout=600)

        _, launches["lifecycle.bit_rot"] = counted(heal_rot)
        healed_s = time.monotonic() - t_flip
        holder = next(u for u, s in ec_holders(client, a).items()
                      if sid in s)
        if sha256_file(shard_file(cl, holder, col, a, sid)) != want:
            raise AssertionError(f"healed shard {sid} differs")
        checked, mounted = 0, 0
        for u in sorted({u for v in vids for u in ec_holders(client, v)}):
            out, n = scrub(cl, client, u)
            if out["bad"]:
                raise AssertionError(f"scrub of {u} after healing: {out}")
            checked += n
            mounted += mounted_on(u)
        if checked != mounted or mounted != 28:
            raise AssertionError(f"scrub checked {checked} of {mounted}")
        lc_log("lifecycle.bit_rot", healed_s,
               launches=launches["lifecycle.bit_rot"],
               trigger_to_action_s=healed_s, shard=sid, flipped_on=url,
               rebuilt_on=holder, sha256_equal=True,
               scrub_shards_checked=checked,
               scrub_shards_dropped=m.value("scrub_shards_dropped"))
        lc_read(client, "lifecycle.read_healed", fids[a], deleted[a], seed,
                a, launches)

        # 4. a holder dies: degraded reads, then the rebuild on the
        # survivors with no command
        lost_url = sorted(u for u, s in ec_holders(client, b).items()
                          if len(s) == 3)[0]
        lost_shards = {v: ec_holders(client, v).get(lost_url, [])
                       for v in vids}
        cl.stop_volume_server(cl.index_of(lost_url))
        t_stop = time.monotonic()

        def heal_death():
            # once the master has pruned the dead holder (a deleted
            # needle must answer 404, not a refused connection), its
            # shards are read degraded until the rebuild mounts them; the
            # reads' launches overlap the rebuild's and count in the step's
            wait_until(lambda: lost_url not in ec_holders(client, b),
                       "the master to prune the dead holder")
            lc_read(client, "lifecycle.read_degraded", fids[b], deleted[b],
                    seed, b, launches, stride=LC_SAMPLE)
            wait_until(lambda: all(
                len(client.ec_lookup(v).get("shards", {})) == 14
                and lost_url not in ec_holders(client, v) for v in vids),
                "the dead holder's shards rebuilt", timeout=600)

        _, launches["lifecycle.holder_death"] = counted(heal_death)
        death_s = time.monotonic() - t_stop
        lc_log("lifecycle.holder_death", death_s,
               launches=launches["lifecycle.holder_death"],
               trigger_to_action_s=death_s, lost=lost_url,
               lost_shards=lost_shards,
               shards_per_server={v: sorted(map(len, ec_holders(
                   client, v).values())) for v in vids})
        for vid in vids:
            lc_read(client, f"lifecycle.read_rebuilt_{vid}", fids[vid],
                    deleted[vid], seed, vid, launches, stride=LC_SAMPLE)

        # 5. a replica lost: the repair daemon copies it back where the
        # placement holds
        vid = client.grow(count=1, collection=LC_REP,
                          replication="001")["volume_ids"][0]
        pair = fresh_lookup(client, vid)
        first = holder_volume(cl, pair[0], vid)
        t0 = time.perf_counter()
        (rfids, _), launches["lifecycle.replica_upload"] = counted(
            lambda: upload_needles(client, vid, first.data_file_size,
                                   small, max_needle, seed + 1, LC_REP,
                                   "001", delete_share=0))
        lc_log("lifecycle.replica_upload", time.perf_counter() - t0,
               first.data_file_size(),
               launches=launches["lifecycle.replica_upload"],
               volume_id=vid, needles=len(rfids))
        client.volume_admin(pair[1], "volume/delete", {"volume_id": vid})
        t_del = time.monotonic()

        def two_copies():
            wait_until(lambda: len(fresh_lookup(client, vid)) == 2,
                       "the lost replica copied back", timeout=300)

        _, launches["lifecycle.replica_lost"] = counted(two_copies)
        back_s = time.monotonic() - t_del
        now = fresh_lookup(client, vid)
        lc_log("lifecycle.replica_lost", back_s,
               holder_volume(cl, now[0], vid).data_file_size(),
               launches=launches["lifecycle.replica_lost"],
               trigger_to_action_s=back_s, holders=now,
               replaced=pair[1])
        for i, url in enumerate(now):
            lc_read(client, f"lifecycle.read_replica_{i}", rfids, set(),
                    seed + 1, vid, launches, url=url)

        # 6. TTL expiry of a whole volume of lctmp
        vid = client.grow(count=1, collection=LC_TMP)["volume_ids"][0]
        url = fresh_lookup(client, vid)[0]
        tvol = holder_volume(cl, url, vid)
        t0 = time.perf_counter()
        (tfids, _), launches["lifecycle.ttl_upload"] = counted(
            lambda: upload_needles(client, vid, tvol.data_file_size,
                                   small, max_needle, seed + 2, LC_TMP,
                                   delete_share=0))
        t_last = time.monotonic()
        lc_log("lifecycle.ttl_upload", time.perf_counter() - t0,
               tvol.data_file_size(),
               launches=launches["lifecycle.ttl_upload"], volume_id=vid,
               needles=len(tfids))
        files = [os.path.join(n[3], f"{LC_TMP}_{vid}{ext}")
                 for n in cl.nodes if n[0] is not None
                 for ext in (".dat", ".idx")]

        def expired() -> bool:
            r = http.request("GET", f"http://{cl.master_url}/dir/lookup"
                             f"?volumeId={vid}")
            return r.status == 404 and not any(map(os.path.exists, files))

        def gone():
            wait_until(expired, "the TTL volume gone", timeout=300)

        _, launches["lifecycle.ttl_expiry"] = counted(gone)
        gone_s = time.monotonic() - t_last
        wait_until(lambda: ("expire", vid, "ok") in warm_outcomes(client),
                   "the expiry's outcome")
        lc_log("lifecycle.ttl_expiry", gone_s,
               launches=launches["lifecycle.ttl_expiry"],
               trigger_to_action_s=gone_s - LC_TTL - LC_TTL_GRACE,
               ttl_s=LC_TTL, grace_s=LC_TTL_GRACE, volume_id=vid)

        # 7. hot again: reads above the rate decode the warm volume; each
        # of its 256 smallest one-interval needles is read from the
        # holder of its shard, so that no read takes a peer's hop
        local = {}
        for u, sids in ec_holders(client, a).items():
            ev = cl.store(cl.index_of(u)).find_ec_volume(a)
            local.update({sid: (u, ev) for sid in sids})
        hot = {}
        for f in sorted((f for f in fids[a] if f not in deleted[a]),
                        key=lambda f: fids[a][f][1]):
            ev = next(iter(local.values()))[1]
            ivs = ev.locate(FileId.parse(f).key)[2]
            if len(ivs) == 1:
                hot[f] = local[ivs[0].to_shard_id_and_offset(ev.g)[0]][0]
            if len(hot) == 256:
                break
        hot_fids = sorted(hot)
        want_hot = {f: payload(seed, *fids[a][f]) for f in hot}
        stop = threading.Event()
        reads = [0] * hot_threads
        errors: list = []
        # (unix time, holder, error) of every read that failed
        failed: list = []

        def hammer(i: int) -> None:
            n = 0
            while not stop.is_set():
                fid = hot_fids[(i + n * hot_threads) % len(hot_fids)]
                n += 1
                try:
                    if client.download(fid, url=hot[fid]) != want_hot[fid]:
                        errors.append(f"{fid} reads back wrong")
                        return
                    reads[i] += 1
                except ClientError as e:
                    failed.append((time.time(), hot[fid], str(e)[:200]))
                    # a read may fail only where it was sent to a shard
                    # holder, and only once ec/to_volume has made the
                    # volume normal on one holder (the shards are then
                    # dropped everywhere); it then goes through the
                    # master's lookup, where no read may fail
                    if not hot[fid]:
                        errors.append(f"{fid} failed through the "
                                      f"lookup: {e}")
                        return
                    if not holds_normal(cl, a):
                        errors.append(f"{fid} failed before the decode: "
                                      f"{e}")
                        return
                    hot[fid] = ""
                    client._vid_cache.pop(a)

        def decode_hot():
            threads = [threading.Thread(target=hammer, args=(i,),
                                        daemon=True)
                       for i in range(hot_threads)]
            for t in threads:
                t.start()
            try:
                wait_until(lambda: holds_normal(cl, a) and not client
                           .ec_lookup(a).get("shards") or errors,
                           "the hot volume decoded", timeout=LC_HOT_TIMEOUT)
            finally:
                stop.set()
                for t in threads:
                    t.join(60)
                heat = client.volume_heat(a)["volumes"]
                log({"phase": "lifecycle.hot_reads", "reads": sum(reads),
                     "seconds": time.monotonic() - t_hot,
                     "heat_read_rate": heat[0]["read_rate"] if heat
                     else None, "card": SMI[0]})
            if errors or any(t.is_alive() for t in threads):
                raise AssertionError(f"hot reads: {errors[:3]}")

        t_hot = time.monotonic()
        _, launches["lifecycle.hot_again"] = counted(decode_hot)
        hot_s = time.monotonic() - t_hot
        wait_until(lambda: ("unec", a, "ok") in warm_outcomes(client),
                   "the decode's outcome")
        decoded_at = next(e["at"] for e in client.lifecycle_status()["recent"]
                          if (e["kind"], e["volume"], e["outcome"])
                          == ("unec", a, "ok"))
        lc_log("lifecycle.hot_again", hot_s,
               launches=launches["lifecycle.hot_again"],
               trigger_to_action_s=hot_s, reads=sum(reads),
               reads_per_s=sum(reads) / hot_s, hot_read_rate=hot_rate,
               threads=hot_threads, failed_reads=len(failed),
               failed_window_s=(decoded_at - failed[0][0] if failed
                                else 0.0),
               failed_after_outcome=sum(f[0] > decoded_at for f in failed),
               failed_by_answer=dict(collections.Counter(
                   f[2].rsplit(": ", 1)[-1] for f in failed)))
        lc_read(client, "lifecycle.read_decoded", fids[a], deleted[a],
                seed, a, launches, stride=LC_SAMPLE)
        states = {v["volume"]: v["state"]
                  for v in client.volume_heat()["volumes"]}
        log({"phase": "lifecycle.summary", "servers": 4,
             "volume_size_limit_mb": limit_mb, "volumes": vids,
             "warm_after_s": LC_WARM_AFTER, "interval_s": LC_INTERVAL,
             "hot_read_rate": hot_rate, "heat_halflife_s": LC_HALFLIFE,
             "collection_ttl_s": LC_TTL, "ttl_grace_s": LC_TTL_GRACE,
             "states": states, "outcomes": warm_outcomes(client),
             "repairs_succeeded": {k: m.value("repairs_succeeded",
                                              {"kind": k})
                                   for k in ("ec", "replica")},
             "repairs_failed": {k: m.value("repairs_failed", {"kind": k})
                                for k in ("ec", "replica")},
             "card": SMI[0]})
        if states.get(a) != "hot" or states.get(b) != "warm":
            raise AssertionError(f"states after phase 9: {states}")
    finally:
        cl.shutdown()
    shutil.rmtree(work, ignore_errors=True)
    return launches


def check_lifecycle_launches(launches: dict) -> None:
    """gf_apply in the coder's steps (and the direct warm-down check),
    nothing in any other step, no other kernel anywhere."""
    for step, counts in launches.items():
        others = {k: n for k, n in counts.items() if k != "gf_apply" and n}
        coder = step in LIFECYCLE_CODER_STEPS + LIFECYCLE_CHECKS
        if others or coder != (counts["gf_apply"] > 0):
            raise AssertionError(f"{step}: launches {counts}")


def shard_size_of(rb: dict, cl, col: str, vid: int) -> int:
    d = cl.nodes[cl.index_of(rb["rebuilder"])][3]
    return os.path.getsize(os.path.join(d, f"{col}_{vid}")
                           + geometry.to_ext(rb["rebuilt"][0]))


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_cli(work: Path, needles: int = 48) -> None:
    """(7b) ``python3 -m seaweedfs_torch.cli`` master and volume (``-coder
    auto``) as processes; uploads to a 64 MB volume, ``shell ec.encode``,
    one shard deleted, every needle read back."""
    work.mkdir(parents=True)
    seed = SEED + 9
    col = "clismoke"
    mport, vport = free_port(), free_port()
    cli = [sys.executable, "-m", "seaweedfs_torch.cli"]
    procs = []
    t0 = time.perf_counter()
    try:
        # no maintenance daemon: a deleted shard stays deleted
        for args in (["master", "-port", str(mport),
                      "-volumeSizeLimitMB", "64", "-pulse", "1",
                      "-maintenance_interval", "0"],
                     ["volume", "-port", str(vport), "-dir", str(work),
                      "-mserver", f"127.0.0.1:{mport}", "-pulse", "1",
                      "-coder", "auto"]):
            procs.append(subprocess.Popen(
                cli + args, cwd=str(REPO), stdout=subprocess.DEVNULL,
                stderr=open(work / f"{args[0]}.log", "wb")))
        client = Client(f"127.0.0.1:{mport}")

        def listed() -> bool:
            if any(p.poll() is not None for p in procs):
                raise AssertionError("a server process exited")
            try:
                return len(client.dir_status()["nodes"]) == 1
            except (OSError, ClientError):
                return False

        wait_until(listed, "the CLI cluster", timeout=120)
        started = time.perf_counter() - t0
        rng = np.random.default_rng(seed)
        fids = {}
        for nid in range(1, needles + 1):
            size = int(np.exp(rng.uniform(np.log(1024), np.log(MIB))))
            fids[client.upload(payload(seed, nid, size),
                               collection=col)] = (nid, size)
        vids = {int(f.split(",")[0]) for f in fids}
        if len(vids) != 1:
            raise AssertionError(f"uploads spread over volumes {vids}")
        vid = vids.pop()
        t1 = time.perf_counter()
        out = subprocess.run(
            cli + ["shell", "-server", f"127.0.0.1:{mport}", "ec.encode",
                   "-volumeId", str(vid), "-collection", col],
            cwd=str(REPO), capture_output=True, text=True, timeout=300)
        encode_s = time.perf_counter() - t1
        if out.returncode != 0:
            raise AssertionError(f"shell ec.encode: {out.stderr[-2000:]}")
        plan = json.loads(out.stdout.strip().splitlines()[-1])
        info = client.ec_lookup(vid)
        if len(info["shards"]) != 14:
            raise AssertionError(f"CLI encode mounted {info}")
        client.volume_admin(f"127.0.0.1:{vport}", "ec/delete_shards",
                            {"volume_id": vid, "collection": col,
                             "shard_ids": [3]})
        read = http_read_all(client, fids, set(), seed)
        log({"phase": "cli.exit_test", "seconds": time.perf_counter() - t0,
             "startup_s": started, "shell_ec_encode_s": encode_s,
             "needles": len(fids), "volume_id": vid,
             "plan": {u: len(s) for u, s in plan["plan"].items()},
             "lost_shard": 3, "read_back": len(read["latencies"]),
             **latency_summary(read["latencies"])})
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    shutil.rmtree(work, ignore_errors=True)


# --- phase 10: the multi-card coder and the crash sweeps ----------------

MESH_GEOMETRIES = ((10, 4), (20, 4), (6, 3))
MESH_WIDTHS = (1, 1023, 64 * 1024 + 3, 8 * MIB + 5)
# the crash sweeps: sweep_all's defaults, and the volumes' sizes
CRASH_SEEDS, CRASH_POINTS = 2, 20
CRASH_DAT_BYTES = 64 * MIB


def mesh_log(row: dict) -> None:
    log({**row, "card": SMI[0]})


def mesh_devices(count: int) -> list:
    """Two members: distinct cards where the host has them, else the one
    card twice (each member still on its own stream)."""
    return ([torch.device("cuda", i) for i in range(2)] if count >= 2
            else [torch.device("cuda", 0)] * 2)


def only_kernel(counts: dict, kernel: str, n: int, what: str) -> None:
    """`kernel` launched exactly n times and no other kernel at all."""
    if counts[kernel] != n or any(c for name, c in counts.items()
                                  if name != kernel):
        raise AssertionError(f"{what}: launches {counts}, want {n} of "
                             f"{kernel} and nothing else")


def check_mesh_kernels(devices: list) -> int:
    """(10a) The mesh's encode and rebuild, and the batched surface,
    bit-equal to single-card gf_apply and to the plain version; returns
    the cases checked."""
    dev = devices[0]
    smesh = sharded.make_mesh(devices=devices)
    cases = 0
    t0 = time.perf_counter()
    for k, m in MESH_GEOMETRIES:
        present, victims = lost(k, m)
        w_par = rs_torch.load_matrix(gf256.parity_matrix(k, m), dev)
        w_rec = rs_torch.load_matrix(gf256.reconstruction_matrix(
            k, m, present, victims), dev)
        meshes = {f: mesh_mod.MeshCoder(k, m, devices=devices,
                                        formulation=f)
                  for f in FORMULATION_KERNEL}
        for width in MESH_WIDTHS:
            rng = np.random.default_rng((SEED, k, width))
            data = rng.integers(0, 256, (k, width), dtype=np.uint8)
            flipped = np.ascontiguousarray(data[::-1])
            parity, flipped_parity = (
                rs_cuda.gf_apply(w_par, torch.from_numpy(x).to(dev))
                .cpu().numpy() for x in (data, flipped))
            rows = [*data, *parity]
            surv = np.stack([rows[i] for i in present])
            sd = torch.from_numpy(surv).to(dev)
            rebuilt = rs_cuda.gf_apply(w_rec, sd).cpu().numpy()
            plain = (rs_torch.gf_apply(w_par, torch.from_numpy(data)
                                       .to(dev)).cpu().numpy(),
                     rs_torch.gf_apply(w_rec, sd).cpu().numpy())
            if not (np.array_equal(parity, plain[0])
                    and np.array_equal(rebuilt, plain[1])
                    and np.array_equal(rebuilt, np.stack(
                        [rows[v] for v in victims]))):
                raise AssertionError(f"RS({k},{m}) width {width}: gf_apply "
                                     "differs from the plain version")
            holed = [None if i in victims else r for i, r in enumerate(rows)]
            for f, mesh in meshes.items():
                kernel = FORMULATION_KERNEL[f]
                what = f"mesh RS({k},{m}) {f} width {width}"
                got, n = counted(lambda: mesh.encode(data))
                only_kernel(n, kernel, len(devices), what + " encode")
                if not np.array_equal(got, parity):
                    raise AssertionError(what + ": parity differs")
                got, n = counted(lambda: mesh.materialize(
                    mesh.rec_apply_async(present, victims)(surv)))
                only_kernel(n, kernel, len(devices), what + " rebuild")
                if not np.array_equal(got, rebuilt):
                    raise AssertionError(what + ": rebuild differs")
                # one stripe per member, the two kinds alternating
                got, n = counted(lambda: sharded.sharded_encode(
                    smesh, np.stack([(data, flipped)[i % 2]
                                     for i in range(len(devices))]), m, f))
                only_kernel(n, kernel, len(devices), what + " sharded")
                if not all(np.array_equal(g, (parity, flipped_parity)[i % 2])
                           for i, g in enumerate(got)):
                    raise AssertionError(what + ": sharded_encode differs")
                out, n = counted(lambda: sharded.sharded_rebuild(
                    smesh, holed, k, m, f))
                only_kernel(n, kernel, len(devices),
                            what + " sharded_rebuild")
                if not all(np.array_equal(out[v], rows[v])
                           for v in victims):
                    raise AssertionError(what + ": sharded_rebuild differs")
                cases += 1
    mesh_log({"phase": "mesh.kernels_vs_single_and_plain", "cases": cases,
              "members": [str(d) for d in devices],
              "geometries": [f"RS({k},{m})" for k, m in MESH_GEOMETRIES],
              "widths": list(MESH_WIDTHS),
              "formulations": list(FORMULATION_KERNEL),
              "bit_equal": True, "seconds": time.perf_counter() - t0})
    return cases


def chip_staged(n: int) -> list:
    reg = metrics.shared("ec")
    return [reg.value("feed_chip_staged_bytes", {"chip": str(i)})
            for i in range(n)]


def run_mesh_path(work: Path, devices: list, device: torch.device,
                  total: int = 1 << 30) -> dict:
    """(10b) A 1 GiB volume through stream_encode single-card and through
    the mesh over `devices` in each formulation, rebuild and sinks;
    returns launches per step."""
    volume = source_volume(work / "src", total, 4 * MIB, SEED + 10,
                           "mesh.")
    g = geometry.DEFAULT
    members = len(devices)
    launches = {}
    single = coder_mod.TorchCoder(g.data_shards, g.parity_shards,
                                  device=device)
    shutil.copytree(volume["dir"], work / "single")
    base = str(work / "single" / "1")
    dat_size = os.path.getsize(base + ".dat")
    governor.reset()
    _, launches["mesh.single_stream_encode"] = timed(
        "mesh.single_stream_encode",
        lambda: counted(lambda: pipeline.stream_encode(base, single, g)),
        lambda r: dat_size, lambda r: {"launches": r[1], "card": SMI[0]})
    want = shard_shas(base, g)
    shutil.rmtree(work / "single")
    for f, kernel in FORMULATION_KERNEL.items():
        mesh = mesh_mod.MeshCoder(g.data_shards, g.parity_shards,
                                  devices=devices, formulation=f)
        tag = f"mesh.{f}."
        shutil.copytree(volume["dir"], work / f)
        base = str(work / f / "1")
        governor.reset()
        op = governor.get().plan(dat_size, g.data_shards,
                                 chips=pipeline.coder_chips(mesh))
        before = chip_staged(members)
        with call_counter(mesh, "_stage_cols") as staged:
            _, n = timed(
                f"{tag}stream_encode",
                lambda: counted(lambda: pipeline.stream_encode(base, mesh,
                                                               g)),
                lambda r: dat_size,
                lambda r: {"launches": r[1], "card": SMI[0],
                           "plan": {"chips": op.chips,
                                    "batch_size": op.batch_size,
                                    "depth": op.depth}})
        grown = [a - b for a, b in zip(chip_staged(members), before)]
        gauge = governor.get().metrics.value("feed_mesh_devices")
        mesh_log({"phase": f"{tag}plan", "chips": op.chips,
                  "feed_mesh_devices": gauge, "batches": staged.calls,
                  "chip_staged_bytes": grown})
        if op.chips != members or gauge != members or min(grown) <= 0:
            raise AssertionError(f"{tag}: plan chips {op.chips}, gauge "
                                 f"{gauge}, staged per chip {grown}")
        only_kernel(n, kernel, members * staged.calls,
                    f"{tag}stream_encode")
        launches[f"{tag}stream_encode"] = n
        if shard_shas(base, g) != want:
            raise AssertionError(f"{tag}: shards differ from the "
                                 "single-card run's")
        for v in VICTIMS:
            os.remove(base + geometry.to_ext(v))
        with call_counter(mesh, "_stage_rows") as staged:
            (rebuilt, n) = timed(
                f"{tag}stream_rebuild",
                lambda: counted(lambda: pipeline.stream_rebuild(base, mesh,
                                                                g)),
                lambda r: os.path.getsize(base + geometry.to_ext(1))
                * g.data_shards, lambda r: {"launches": r[1],
                                            "card": SMI[0]})
        only_kernel(n, kernel, members * staged.calls,
                    f"{tag}stream_rebuild")
        launches[f"{tag}stream_rebuild"] = n
        if rebuilt != list(VICTIMS) or shard_shas(base, g) != want:
            raise AssertionError(f"{tag}: rebuilt shards differ")
        with call_counter(mesh, "_stage_cols") as staged:
            sinks = check_sinks(base, mesh, g, tag)
        only_kernel({k: sum(c[k] for c in sinks.values())
                     for k in WRAPPERS}, kernel, members * staged.calls,
                    f"{tag}device sinks")
        launches.update({f"{tag}{k}": c for k, c in sinks.items()})
        shutil.rmtree(work / f)
        mesh_log({"phase": f"{tag}summary", "members":
                  [str(d) for d in devices], "shards_sha256_equal": True,
                  "rebuilt_sha256_equal": True, "sink_digests_equal": True})
    shutil.rmtree(work, ignore_errors=True)
    return launches


def run_mesh_surface(work: Path, card: str, count: int) -> None:
    """(10c) WEED_EC_MESH_DEVICES=all: the Store's lift, and the mesh
    status over HTTP and through the shell."""
    work.mkdir(parents=True)
    with env_set(WEED_EC_MESH_DEVICES="all"):
        st = store_mod.Store([str(work / "lift")], coder_name="auto")
        try:
            c = st.coder()
        finally:
            st.close()
        lifted = (isinstance(c, mesh_mod.MeshCoder)
                  and c.mesh_devices == count) if count >= 2 else (
            type(c) is coder_mod.TorchCoder and c.device.type == "cuda")
        if not lifted:
            raise AssertionError(f"Store coder under WEED_EC_MESH_DEVICES="
                                 f"all on {count} card(s): {c!r}")
        cl = LocalCluster(1, coder_name="auto", volume_size_limit_mb=64,
                          pulse=0.5, directory=str(work / "cluster"))
        try:
            cl.wait_for_nodes(1)
            http_status = http_get_json(
                f"http://{cl.url(0)}/admin/ec/mesh_status")
            shell_commands._register_all()
            env = shell_commands.CommandEnv(Client(cl.master_url))
            shell = shell_commands.run_command(env, ["ec.mesh.status"])
        finally:
            cl.shutdown()
    for answer in (http_status, *shell["nodes"].values()):
        if (answer.get("requested") != "all" or "mesh_devices" not in answer
                or card not in [d["name"] for d in answer["devices"]]):
            raise AssertionError(f"mesh status {answer}")
    mesh_log({"phase": "mesh.surface", "store_coder": type(c).__name__,
              "mesh_devices": getattr(c, "mesh_devices", 1),
              "http": {k: http_status[k] for k in
                       ("requested", "mesh_devices", "devices")},
              "shell_nodes": len(shell["nodes"])})
    shutil.rmtree(work, ignore_errors=True)


def crash_workloads(device: torch.device) -> list:
    """(10d) The three crash workloads at the card's sizes: ec_encode on
    phase 4's mixed tiers, fused_warmdown on phase 6b's payload kinds,
    volume_append at its defaults."""
    seed = SEED + 11
    mixed = geometry.Geometry(large_block_size=262144,
                              small_block_size=16384)
    ec_encode = crash_wl.make_ec_workload(
        coder=coder_mod.get_coder("auto", 10, 4), geometry=mixed,
        dat_size=CRASH_DAT_BYTES,
        dat_source=lambda n: np.random.default_rng(seed).bytes(n),
        encode=pipeline.stream_encode)
    count, stored = 0, 0
    while stored < CRASH_DAT_BYTES:
        count += 1
        stored += len(archive_needle(seed, count).data)
    rng = np.random.default_rng(seed)
    gone = {int(i) + 1 for i in rng.choice(count, size=int(0.3 * count),
                                           replace=False)}
    fused = crash_wl.make_fused_warmdown_workload(
        coder=coder_mod.get_coder("auto", 20, 4),
        geometry=geometry.Geometry(20, 4), needles=count, deleted=gone,
        make_needle=lambda nid: archive_needle(seed, nid))
    return [ec_encode, fused, crash_wl.make_volume_workload()]


def run_crash_sweeps(work: Path, device: torch.device) -> dict:
    """(10d) Each workload at CRASH_SEEDS x CRASH_POINTS; zero violations,
    gf_apply launched in both EC sweeps. Returns launches per sweep."""
    work.mkdir(parents=True)
    launches = {}
    for w in crash_workloads(device):
        t0 = time.perf_counter()
        summary, n = counted(lambda: crash_harness.sweep_all(
            seeds=CRASH_SEEDS, points=CRASH_POINTS, workloads=[w],
            scratch_dir=str(work)))
        secs = time.perf_counter() - t0
        runs = summary["workloads"][w.name]
        mesh_log({"phase": f"crash.{w.name}", "seconds": secs,
                  "points": summary["total_points"],
                  "violations": summary["total_violations"],
                  "ops": [r["ops"] for r in runs], "launches": n,
                  "first_violations": [v for r in runs
                                       for v in r["violations"]][:3]})
        if not summary["ok"] or summary["total_points"] != \
                CRASH_SEEDS * CRASH_POINTS:
            raise AssertionError(f"crash sweep {w.name}: {summary}")
        ec_sweep = w.name != "volume_append"
        if (ec_sweep != (n["gf_apply"] > 0)
                or any(c for k, c in n.items() if k != "gf_apply")):
            raise AssertionError(f"crash.{w.name}: launches {n}")
        launches[f"crash.{w.name}"] = n
    shutil.rmtree(work, ignore_errors=True)
    return launches


def run_mesh(work: Path, device: torch.device, card: str,
             count: int) -> dict:
    """Phase 10; returns the main path's launches per step."""
    devices = mesh_devices(count)
    t0 = time.perf_counter()
    check_mesh_kernels(devices)
    launches = run_mesh_path(work / "path", devices, device)
    run_mesh_surface(work / "surface", card, count)
    launches.update(run_crash_sweeps(work / "crash", device))
    mesh_log({"phase": "mesh.summary", "seconds": time.perf_counter() - t0,
              "members": [str(d) for d in devices], "launches": launches})
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    SMI[0] = smi
    log({"phase": "device", "name": card, "count": count, "nvidia_smi": smi,
         "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    lib = _build.build()
    log({"phase": "build", "seconds": time.perf_counter() - t0,
         "library": lib.name})
    WORD_OPS[0] = word_ops_per_s()
    try:
        apply_ops, mxu_ops = sass_ops(lib)
        SASS_OPS.update(apply_ops)
        MXU_SASS.update(mxu_ops)
    except (OSError, subprocess.CalledProcessError, StopIteration,
            ValueError) as e:
        # ops_per_column then reads None
        log({"phase": "sass_ops", "error": repr(e)})
    log({"phase": "rates", "int32_ops_per_s": WORD_OPS[0],
         "gf_apply_sass_alu": SASS_OPS or "not measured",
         "gf_apply_mxu_sass_per_16_columns": MXU_SASS or "not measured",
         "gf_apply_ops_per_column_rs10_4": gf_apply_ops_per_column(10)})

    checked = check_kernels(device)
    with env_set(WEED_EC_FORMULATION=None):
        coder = coder_mod.get_coder("auto", 10, 4)
    with env_set(WEED_EC_FORMULATION="xorsched"):
        auto_x = coder_mod.get_coder("auto", 10, 4)
    if not isinstance(coder, coder_mod.TorchCoder) or \
            coder.device.type != "cuda" or coder.formulation != "bitplane":
        raise AssertionError(f"auto coder is {coder!r}")
    if not isinstance(auto_x, coder_mod.TorchCoder) or \
            auto_x.formulation != "xorsched":
        raise AssertionError("auto coder under WEED_EC_FORMULATION="
                             "xorsched is not the xorsched coder")
    log({"phase": "auto_coder", "unpinned": coder.formulation,
         "pinned_xorsched": auto_x.formulation})
    coder_x = coder_mod.TorchCoder(10, 4, formulation="xorsched")

    shutil.rmtree(WORK, ignore_errors=True)
    launches = {}
    try:
        volume = source_volume(WORK / "src", 1 << 30, 4 * MIB, SEED, "")
        log({"phase": "disk", "free_bytes": shutil.disk_usage(WORK).free})
        launches["bitplane"], sha_b = run_main_path(
            WORK / "default", coder, geometry.DEFAULT, volume, device, "",
            min_on_victims=200)
        shutil.rmtree(WORK / "default", ignore_errors=True)
        launches["xorsched"], sha_x = run_main_path(
            WORK / "xorsched", coder_x, geometry.DEFAULT, volume, device,
            "xorsched.", min_on_victims=200)
        shutil.rmtree(WORK / "xorsched", ignore_errors=True)
        if sha_x != sha_b:
            raise AssertionError("xorsched shard files differ from the "
                                 "bitplane run's")
        log({"phase": "formulations_agree", "shards": len(sha_b),
             "sha256_equal": True})
        launches["governed"] = run_governed(
            WORK / "governed", coder, geometry.DEFAULT, volume, sha_b,
            device)
        shutil.rmtree(WORK / "src", ignore_errors=True)
        mixed = geometry.Geometry(large_block_size=262144,
                                  small_block_size=16384)
        volume = source_volume(WORK / "mixed_src", 4 * MIB, 256 * 1024,
                               SEED + 1, "mixed_tier.")
        sha = {}
        for tag, c in [("mixed_tier.", coder),
                       ("mixed_tier.xorsched.", coder_x)]:
            _, sha[tag] = run_main_path(WORK / tag, c, mixed, volume,
                                        device, tag)
        if sha["mixed_tier."] != sha["mixed_tier.xorsched."]:
            raise AssertionError("mixed-tier xorsched shards differ")
        shutil.rmtree(WORK, ignore_errors=True)
        # phase 6 under the default policy and formulation
        with env_set(WEED_EC_GEOMETRY=None, WEED_EC_FORMULATION=None,
                     WEED_EC_MESH_DEVICES=None):
            launches["store"] = run_store_default(WORK / "store", device)
            launches["fused"] = run_store_archive(WORK / "fused", device)
            # phase 7: the same path through the servers, the shell and
            # the CLI
            launches["cluster"] = run_cluster(WORK / "cluster", device)
            run_cli(WORK / "cli")
            # phase 9: the self-driving warm tier, its own cluster
            launches["lifecycle"] = run_lifecycle(WORK / "lifecycle")
            check_lifecycle_launches(launches["lifecycle"])
            # phase 10: the multi-card coder and the crash sweeps
            launches["mesh"] = run_mesh(WORK / "mesh", device, card, count)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    # every governed step ran gf_apply and nothing else (TorchCoder has no
    # formulation hook, so the governor never switches its kernel); the
    # mxu entry ran the tensor-core kernel and nothing else
    for step, counts in launches["governed"].items():
        mine = "gf_apply_mxu" if step == "mxu_entry" else "gf_apply"
        if counts[mine] == 0 or any(n for name, n in counts.items()
                                    if name != mine):
            raise AssertionError(f"governed.{step}: launches {counts}, "
                                 f"want only {mine}")

    # main-path shapes: encode and rebuild batches are [10, 8 MiB] (the
    # feed joins consecutive 1 MiB small-block segments up to the batch
    # size); a degraded read is one interval, R = 1; the archive
    # collection's RS(20,4) at 8 MiB, and at the 4 MiB the governor plans
    # for k = 20 within its staging budget (the fused pass's batches)
    times = time_kernels(device, [("encode", 4, 10, 8 * MIB),
                                  ("rebuild", 4, 10, 8 * MIB),
                                  ("encode_1mib", 4, 10, MIB),
                                  ("degraded_read", 1, 10, 64 * 1024),
                                  ("archive", 4, 20, 8 * MIB),
                                  ("archive_4mib", 4, 20, 4 * MIB)])
    log(smi)
    kernels = []
    main_steps = {**launches["bitplane"], **{
        f"xorsched.{k}": v for k, v in launches["xorsched"].items()}, **{
        f"governed.{k}": v for k, v in launches["governed"].items()
        if k != "mxu_entry"}, **launches["store"], **launches["fused"],
        **launches["cluster"], **{
        k: v for k, v in launches["lifecycle"].items()
        if k not in LIFECYCLE_CHECKS}, **launches["mesh"]}
    for kernel in KERNELS:
        by_phase = {step: counts[kernel]
                    for step, counts in main_steps.items()}
        enc = times[kernel][0]
        row = {**KERNELS[kernel], "launches": sum(by_phase.values()),
               "launches_mesh": sum(counts[kernel] for step, counts in
                                    launches["mesh"].items()
                                    if step.startswith("mesh.")),
               "max_abs_err": checked["max_abs_err"][kernel],
               "ms": enc["ms"], "plain_ms": enc["plain_ms"],
               "bound_ms": enc["bound_ms"], "bound_by": enc["bound_by"],
               "library_ms": None, "shape": "[10,8MiB] -> [4,8MiB]",
               "host_us": enc["host_us"],
               "launches_by_phase": by_phase, "bit_equal": True,
               "library_note": "no single PyTorch call computes a GF(2^8) "
                               "matrix product"}
        for key in ("ops_per_column", "sass_per_16_columns", "mma_sync_ms",
                    "digest_ms", "digest_only_ms", "digest_library_ms"):
            if key in enc:
                row[key] = enc[key]
        for label, key, shape in [
                ("archive", "rs20_4", "[20,8MiB] -> [4,8MiB]"),
                ("archive_4mib", "rs20_4_4mib", "[20,4MiB] -> [4,4MiB]")]:
            arc = next(r for r in times[kernel] if r["shape"] == label)
            row[key] = {"shape": shape, **{k: arc[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "host_us")}}
        if kernel == "gf_apply_mxu":
            # no main-path step runs it (none does in the reference): its
            # launches are those of its own entry, the repack="mxu"
            # argument, over the volume's [10, 8 MiB] batches
            row["launches"] = launches["governed"]["mxu_entry"][kernel]
            row["launches_main_path"] = sum(by_phase.values())
            row["launches_entry"] = row["launches"]
        kernels.append(row)
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": card,
                                "count": count}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
