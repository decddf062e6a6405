#!/usr/bin/env python3
"""Time the port's GF(2^8) kernels of one checkout on the card.

    python3 scripts/torch_kernel_times.py [--root CHECKOUT] [--label NAME]
                                          [--kernel NAME ...]

Imports ``seaweedfs_torch`` from CHECKOUT (default: this script's
repository), builds its kernels, and prints one JSON line per kernel and
shape: the device time per launch (CUDA events, the median of windows of
back-to-back launches after warm-up) and the host time per wrapper call
(the host clock over the same launches, before the closing
synchronize). The main path's shapes: [10, 8 MiB] -> [4, 8 MiB] and
[10, 1 MiB] -> [4, 1 MiB] with the RS(10,4) parity matrix (an encode),
[20, 8 MiB] -> [4, 8 MiB] with RS(20,4)'s, [10, 8 MiB] -> [4, 8 MiB]
with the reconstruction matrix of shards 0, 3, 7 and 12 (a rebuild),
and [10, 64 KiB] -> [1, 64 KiB] with a one-row reconstruction matrix (a
degraded read). The tensor-core kernel (``gf_apply_mxu``) is timed at
each shape too, and where its wrapper takes ``instr`` also on mma.sync.
Where the checkout's wrappers take a digest it also
times the launch with the digest epilogue, the digest-only launch and
the digest's second pass (``out.sum(dim=1, dtype=torch.int64)`` after
the kernel), which is what the epilogue replaces. At the encode shape it
also times ``gf_apply`` on input rows of one constant byte: every lane of
a warp then looks up the same product-table word (a broadcast), so the
difference from random bytes is what the table's shared-memory bank
conflicts cost. Running it on two checkouts in one call (parent, change,
change, parent) compares two versions on one card. The last line is the
card's name and power limit as nvidia-smi gives them. --kernel (one or
more names, as printed) times only those runs.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def time_launches(fn, reps: int, windows: int = 5) -> tuple[float, float]:
    """(device ms per call, host us per call) over `windows` windows of
    `reps` calls, medians, after `reps` calls of warm-up."""
    import torch
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    dev, host = [], []
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
        dev.append(start.elapsed_time(end) / reps)
    return float(np.median(dev)), float(np.median(host))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--kernel", nargs="*", default=None,
                    help="time only these runs (names as printed)")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch
    from seaweedfs_torch.ops import _build, gf256, rs_cuda, rs_torch
    from seaweedfs_torch.ops import xor_schedule
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    _build.build()
    dev = torch.device("cuda", 0)
    lower = getattr(xor_schedule, "lower_schedule_grouped",
                    xor_schedule.lower_schedule)
    has_digest = "digest" in inspect.signature(rs_cuda.gf_apply).parameters
    rng = np.random.default_rng(20261016)
    present = tuple(i for i in range(14) if i not in (0, 3, 7, 12))
    rebuild = gf256.reconstruction_matrix(10, 4, present, (0, 3, 7, 12))
    shapes = [("encode", gf256.parity_matrix(10, 4), 8 << 20),
              ("encode_20_4", gf256.parity_matrix(20, 4), 8 << 20),
              ("rebuild", rebuild, 8 << 20),
              ("encode_1mib", gf256.parity_matrix(10, 4), 1 << 20),
              ("degraded_read",
               gf256.reconstruction_matrix(10, 4, present, (0,)), 64 << 10)]
    for label, mat, n in shapes:
        rows, cols = mat.shape
        x = torch.from_numpy(
            rng.integers(0, 256, (cols, n), dtype=np.uint8)).to(dev)
        w = rs_torch.load_matrix(mat, dev)
        prog = lower(xor_schedule.schedule_for_matrix(mat)).to(dev)
        reps = max(50, min(2000, int(2e10 // (n * (rows + cols)))))
        runs = {"gf_apply": lambda: rs_cuda.gf_apply(w, x),
                "gf_apply_xorsched": lambda: rs_cuda.gf_apply_xorsched(
                    prog, x),
                "gf_apply_mxu": lambda: rs_cuda.gf_apply_mxu(w, x)}
        if "instr" in inspect.signature(rs_cuda.gf_apply_mxu).parameters:
            runs["gf_apply_mxu mma.sync"] = lambda: rs_cuda.gf_apply_mxu(
                w, x, instr="mma")
        if label == "encode":
            xc = torch.full_like(x, 0x5A)
            runs["gf_apply constant bytes"] = lambda: rs_cuda.gf_apply(w, xc)
        if has_digest:
            d = rs_cuda.new_digest(rows + cols, dev)
            runs.update({
                "gf_apply+digest": lambda: rs_cuda.gf_apply(w, x, digest=d),
                "gf_apply digest-only": lambda: rs_cuda.gf_apply(
                    w, x, digest=d, out=False),
                "gf_apply_xorsched+digest": lambda: rs_cuda.gf_apply_xorsched(
                    prog, x, digest=d),
                "gf_apply_xorsched digest-only":
                    lambda: rs_cuda.gf_apply_xorsched(prog, x, digest=d,
                                                      out=False),
                "gf_apply then sum": lambda: rs_cuda.gf_apply(w, x).sum(
                    dim=1, dtype=torch.int64)})
        for name, fn in runs.items():
            if args.kernel is not None and name not in args.kernel:
                continue
            ms, host_us = time_launches(fn, reps)
            print(json.dumps({"label": args.label, "kernel": name,
                              "shape": label, "in": [cols, n],
                              "out": [rows, n], "ms": ms,
                              "host_us": host_us, "reps": reps}),
                  flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
