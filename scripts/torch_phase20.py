#!/usr/bin/env python3
"""Phase 20 of chip_smoke.py alone: the gRPC planes and the message
broker (a master and 3 volume servers with their gRPC ports, the volume
servers beating over gRPC; a CLI filer whose notifications go to two
CLI ``msg.broker`` processes registered over its gRPC KeepConnected):
Assign, Lookup and KeepConnected over gRPC, uploads replicated through
the broker topic, the volumes encoded, degraded-read, queried and
rebuilt over the volume servers' gRPC, a broker SIGKILLed mid-stream,
and the events drained again through the in-repo Kafka broker, on one
CUDA card.

    python3 scripts/torch_phase20.py

Builds the kernels, runs ``chip_smoke.run_grpc`` under the default EC
policy and formulation, which holds its launches to the phase's rule
(gf_apply in the encodes, the rebuild, the reads and Query, and the
topic's replay where a segment lies on a lost shard; no other kernel),
and prints one JSON line per step and a total. It needs a card, exits 2
without one, and removes its scratch directory at the end.
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
        print("torch_phase20: no CUDA device", file=sys.stderr)
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
            launches = cs.run_grpc(cs.WORK / "grpc")
    finally:
        shutil.rmtree(cs.WORK, ignore_errors=True)
    cs.log({"phase": "phase20_total", "seconds": time.perf_counter() - t0,
            "launches": launches})
    return 0


if __name__ == "__main__":
    sys.exit(main())
