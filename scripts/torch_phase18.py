#!/usr/bin/env python3
"""Phase 18 of chip_smoke.py alone: the filer's client surfaces (a master,
2 volume servers, the CLI filer on leveldb2 and the CLI WebDAV gateway):
files written through WebDAV, through the mount (an in-process WFS, and
the CLI mount on a kernel mount point where the host serves one),
through the fsspec adapter, and JSON documents queried on the volume
servers' ``/admin/query``; then every volume encoded on the card with the
shell's ``ec.encode`` and everything read back through each surface with
4 shards lost, on one CUDA card.

    python3 scripts/torch_phase18.py

Builds the kernels, runs ``chip_smoke.run_dav`` under the default EC
policy and formulation, which holds its launches to the phase's rule
(gf_apply in 18's encode and its reads with 4 shards lost only; no other
kernel), and prints one JSON line per step and a total. It needs a card,
exits 2 without one, and removes its scratch directory at the end.
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
        print("torch_phase18: no CUDA device", file=sys.stderr)
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
            launches = cs.run_dav(cs.WORK / "dav")
    finally:
        shutil.rmtree(cs.WORK, ignore_errors=True)
    cs.log({"phase": "phase18_total", "seconds": time.perf_counter() - t0,
            "launches": launches})
    return 0


if __name__ == "__main__":
    sys.exit(main())
