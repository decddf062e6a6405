#!/usr/bin/env python3
"""chip_smoke.py's multi-card coder checks over every card of the host.

    python3 scripts/torch_mesh_cards.py

Runs phase 10's mesh steps with one ``MeshCoder`` member per card (at
least two distinct cards; chip_smoke.py itself uses two members, the one
card twice on a one-card host): (10a) the mesh's encode and rebuild and
``sharded_encode`` / ``sharded_rebuild`` bit-equal to single-card
``gf_apply`` and to the plain version, the formulation's kernel launched
once per member per call; (10b) a 1 GiB volume through ``stream_encode``
single-card and through the mesh in both formulations, ``stream_rebuild``
of four shards (the all-gather crossing cards) and both device sinks,
shards equal by sha256 and launches once per member per batch; (10c)
``Store(coder_name="auto")`` under ``WEED_EC_MESH_DEVICES=all`` lifted to
a ``MeshCoder`` over every card, and the mesh status over HTTP and the
shell. It prints chip_smoke's JSON lines, the cards' names and whether
each pair can reach the other's memory directly, and exits non-zero on
any failed check or with fewer than two cards.
"""

from __future__ import annotations

import shutil
import sys
import time
import traceback
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from seaweedfs_torch.ops import _build  # noqa: E402


def main() -> int:
    count = torch.cuda.device_count()
    if count < 2:
        print("torch_mesh_cards: needs two or more cards", file=sys.stderr)
        return 2
    card = torch.cuda.get_device_name(0)
    cs.SMI[0] = cs.nvidia_smi_line()
    cs.log({"phase": "device", "count": count,
            "names": [torch.cuda.get_device_name(i) for i in range(count)],
            "peer_access": [[torch.cuda.can_device_access_peer(i, j)
                             if i != j else None for j in range(count)]
                            for i in range(count)],
            "nvidia_smi": cs.SMI[0]})
    _build.build()
    devices = [torch.device("cuda", i) for i in range(count)]
    work = cs.REPO / ".chip_smoke_work" / "mesh_cards"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        cs.check_mesh_kernels(devices)
        launches = cs.run_mesh_path(work / "path", devices, devices[0])
        cs.run_mesh_surface(work / "surface", card, count)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cs.mesh_log({"phase": "mesh_cards.summary", "members": count,
                 "seconds": time.perf_counter() - t0,
                 "launches": launches})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
