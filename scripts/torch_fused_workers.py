#!/usr/bin/env python3
"""What binds the port's fused warm-down: its compaction pool's width,
swept on one archive volume.

    python3 scripts/torch_fused_workers.py [--bytes N] [--workers 1,2,4,8]

Writes one volume of chip_smoke.py phase 6b's kind (the fused warm-down
tests' five payload kinds, 30% of the needles deleted; 1 GiB by default)
into the ``archive`` collection of a ``Store(coder_name="auto")``, then
runs ``fused_vacuum_gzip_encode`` on it at RS(20,4) once per pool width
in the order given and again in reverse (``WEED_EC_GZIP_WORKERS`` with
the governor reset before each run), one JSON line each: wall seconds,
GB/s of the source volume and the run's ``ec.*`` span totals. Then, on
one thread, the per-needle costs of the pass's record transform over the
first 20000 live needles: the CRC alone, the gzip attempts alone, and
``_transform_record`` whole. It needs a card, works in
``.chip_smoke_work/fused_workers`` and removes it; the last line is the
card's name and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from seaweedfs_torch import observe  # noqa: E402
from seaweedfs_torch.ec import fused, governor  # noqa: E402
from seaweedfs_torch.observe import wideevents  # noqa: E402
from seaweedfs_torch.storage import store as store_mod  # noqa: E402
from seaweedfs_torch.storage import types as t  # noqa: E402
from seaweedfs_torch.storage.needle import (crc32c_update,  # noqa: E402
                                            crc_value)
from seaweedfs_torch.utils import compression  # noqa: E402

WORK = REPO / ".chip_smoke_work" / "fused_workers"
SEED = chip_smoke.SEED + 7


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def write_archive_volume(st, total: int):
    vol = st.add_volume(2, collection="archive")
    nid = 0
    while vol.data_file_size() < total:
        nid += 1
        st.write_needle(2, chip_smoke.archive_needle(SEED, nid))
    rng = np.random.default_rng(SEED)
    for d in sorted(int(i) + 1 for i in rng.choice(nid, size=int(0.3 * nid),
                                                   replace=False)):
        st.delete_needle(2, chip_smoke.Needle(cookie=d * 7919 & 0xFFFFFFFF,
                                              id=d))
    vol.read_only = True
    vol.sync()
    return vol, nid


def one_run(vol, coder, g, workers: int) -> dict:
    os.environ["WEED_EC_GZIP_WORKERS"] = str(workers)
    os.environ["WEED_EC_GZIP_MAX"] = str(max(workers, 1))
    governor.reset()
    observe.reset()
    wideevents.reset()
    dst = str(WORK / "fused")
    t0 = time.perf_counter()
    stats = fused.fused_vacuum_gzip_encode(vol, dst, coder, g)
    wall = time.perf_counter() - t0
    trace = wideevents.events(svc="ec")[-1]["trace"]
    totals = {k: {"count": c, "seconds": us / 1e6} for k, (c, us) in
              sorted(observe.stage_totals(trace, prefix="ec.").items())}
    fused._cleanup_dst(dst, g)
    return {"phase": "fused_workers", "gzip_workers": stats["gzip_workers"],
            "seconds": wall, "src_bytes": stats["src_bytes"],
            "gbps": stats["src_bytes"] / wall / 1e9,
            "live_needles": stats["live_needles"],
            "gzipped_needles": stats["gzipped_needles"],
            "compacted_bytes": stats["compacted_bytes"],
            "stage_totals": totals}


def per_needle_costs(vol, count: int = 20000) -> dict:
    """Single-thread us per needle of the record transform's parts."""
    live = sorted((t.stored_to_offset(nv.offset), nv.size)
                  for nv in vol.nm.values() if t.size_is_valid(nv.size))
    live = live[:count]
    fd = vol._dat.fileno()
    raws = [os.pread(fd, t.get_actual_size(size, vol.version), off)
            for off, size in live]
    datas = [bytes(raw[20:20 + t.get_u32(raw, 16)]) for raw in raws]

    def crc_only():
        for d in datas:
            crc_value(crc32c_update(0, d))

    def gzip_only():
        # the transform's attempts: a 4 KiB sniff, then the whole payload
        # where the sniff shrank by a tenth (flagged payloads skipped)
        for raw, d in zip(raws, datas):
            if not d or raw[20 + len(d)] & 0x01:
                continue
            head = d[:4096]
            if len(compression.compress(head, level=1)) * 10 < len(head) * 9:
                compression.compress(d, level=1)

    def transform():
        for raw, (_, size) in zip(raws, live):
            fused._transform_record(raw, size, vol.version, 1)

    out = {"needles": len(live),
           "bytes": int(sum(len(d) for d in datas))}
    for name, fn in (("crc", crc_only), ("gzip", gzip_only),
                     ("transform_record", transform)):
        t0 = time.perf_counter()
        fn()
        out[f"{name}_us_per_needle"] = ((time.perf_counter() - t0)
                                        / len(live) * 1e6)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bytes", type=int, default=1 << 30)
    ap.add_argument("--workers", default="1,2,4,8")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fused_workers: no CUDA device", file=sys.stderr)
        return 2
    widths = [int(w) for w in args.workers.split(",")]
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    os.environ.pop("WEED_EC_GEOMETRY", None)
    st = store_mod.Store([str(WORK)], coder_name="auto")
    try:
        g = st.geometry_for("archive")
        t0 = time.perf_counter()
        vol, count = write_archive_volume(st, args.bytes)
        log({"phase": "write_volume", "seconds": time.perf_counter() - t0,
             "bytes": vol.data_file_size(), "needles": count,
             "geometry": [g.data_shards, g.parity_shards]})
        coder = st.coder(g)
        for w in widths + widths[::-1]:
            log(one_run(vol, coder, g, w))
        log({"phase": "per_needle_costs", **per_needle_costs(vol)})
    finally:
        st.close()
        shutil.rmtree(WORK, ignore_errors=True)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
