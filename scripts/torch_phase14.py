#!/usr/bin/env python3
"""Phase 14 of chip_smoke.py alone: the filer and the S3 lifecycle (two
filers, bucket rules that expire and warm down, degraded reads through
the filer, the fs.* shell, a filer restart and the CLI filer), on one
CUDA card; then the filer_kv crash sweep of phase 10d.

    python3 scripts/torch_phase14.py

Builds the kernels, runs ``chip_smoke.run_filer`` under the default EC
policy and formulation, which holds its launches to the phase's rule
(gf_apply in 14b's warm-downs and 14c's degraded reads only; no other
kernel), sweeps ``filer_kv`` at 2 seeds x 10 points (0 violations), and
prints one JSON line per step and a total. It needs a card, exits 2
without one, and removes its scratch directory at the end.
"""

import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from seaweedfs_torch.crashsim import harness, workloads  # noqa: E402
from seaweedfs_torch.ops import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_phase14: no CUDA device", file=sys.stderr)
        return 2
    cs.SMI[0] = cs.nvidia_smi_line()
    cs.log({"phase": "device", "name": torch.cuda.get_device_name(0),
            "smi": cs.SMI[0], "torch": torch.__version__,
            "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    _build.build()
    cs.log({"phase": "build", "seconds": time.perf_counter() - t0})
    shutil.rmtree(cs.WORK, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        with cs.env_set(WEED_EC_GEOMETRY=None, WEED_EC_FORMULATION=None,
                        WEED_EC_MESH_DEVICES=None):
            launches = cs.run_filer(cs.WORK / "filer")
        (cs.WORK / "crash").mkdir(parents=True)
        t1 = time.perf_counter()
        summary = harness.sweep_all(
            seeds=cs.CRASH_SEEDS, points=cs.MESH_CRASH_POINTS,
            workloads=[workloads.make_filer_kv_workload()],
            scratch_dir=str(cs.WORK / "crash"))
        cs.log({"phase": "crash.filer_kv",
                "seconds": time.perf_counter() - t1,
                "points": summary["total_points"],
                "violations": summary["total_violations"]})
        if not summary["ok"]:
            raise AssertionError(f"filer_kv sweep: {summary}")
    finally:
        shutil.rmtree(cs.WORK, ignore_errors=True)
    cs.log({"phase": "phase14_total", "seconds": time.perf_counter() - t0,
            "launches": launches})
    return 0


if __name__ == "__main__":
    sys.exit(main())
