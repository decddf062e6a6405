#!/usr/bin/env python3
"""Phase 19 of chip_smoke.py alone: the cross-cluster planes (two
clusters, each a master with its geo daemon, 2 volume servers and the
CLI filer on leveldb2; the CLI S3 gateway on the primary): a versioned
bucket replicated to the second cluster by the geo daemon's backfill and
tail with 4 shards lost at the source, the replica's filer killed and
restarted, an active/active bucket, the notification spool drained by
``filer.replicate -from_queue``, and every object and version read back
from the replica through the client's and the gateway's failover with 4
shards lost there, on one CUDA card; then offset_commit's crash sweep.

    python3 scripts/torch_phase19.py

Builds the kernels, runs ``chip_smoke.run_geo`` under the default EC
policy and formulation, which holds its launches to the phase's rule
(gf_apply in the encodes, the backfill and the failover reads only; no
other kernel), and prints one JSON line per step and a total. It needs a
card, exits 2 without one, and removes its scratch directory at the end.
"""

import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from seaweedfs_torch.ops import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_phase19: no CUDA device", file=sys.stderr)
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
            launches = cs.run_geo(cs.WORK / "geo")
    finally:
        shutil.rmtree(cs.WORK, ignore_errors=True)
    cs.log({"phase": "phase19_total", "seconds": time.perf_counter() - t0,
            "launches": launches})
    return 0


if __name__ == "__main__":
    sys.exit(main())
