#!/usr/bin/env python3
"""What one filer write costs in the port's `sqlite` store, on this host's
disk: the cost that bounds chip_smoke phase 15's creates and handoff
pushes (each is one `Filer.create_entry`, one commit, under the filer's
lock).

    python3 scripts/torch_filer_commits.py [--entries N]

Prints one JSON line each for: entries inserted one commit each, entries
inserted in one transaction, and entries created through `Filer` by 16
threads at once (the filer's lock serializes them). Then the host's
`nvidia-smi` line when there is one. It writes only under
`.chip_smoke_work/` in the checkout and removes it at the end.
"""

import argparse
import json
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from seaweedfs_torch.filer.abstract_sql import SqliteStore  # noqa: E402
from seaweedfs_torch.filer.entry import new_file  # noqa: E402
from seaweedfs_torch.filer.filer import Filer  # noqa: E402

WORK = REPO / ".chip_smoke_work" / "filer_commits"


def per_commit(store, n: int) -> dict:
    lat = []
    for i in range(n):
        t = time.perf_counter()
        store.insert_entry(new_file(f"/one/d{i % 50:02d}/f{i:05d}"))
        lat.append(time.perf_counter() - t)
    lat.sort()
    return {"step": "one_commit_each", "entries": n,
            "seconds": sum(lat), "mean_ms": 1e3 * sum(lat) / n,
            "p50_ms": 1e3 * lat[n // 2], "p99_ms": 1e3 * lat[n * 99 // 100]}


def one_transaction(store, n: int) -> dict:
    t = time.perf_counter()
    store.begin()
    for i in range(n):
        store.insert_entry(new_file(f"/txn/d{i % 50:02d}/f{i:05d}"))
    store.commit()
    secs = time.perf_counter() - t
    return {"step": "one_transaction", "entries": n, "seconds": secs,
            "mean_ms": 1e3 * secs / n}


def through_filer(filer, n: int, threads: int = 16) -> dict:
    def run(k: int) -> None:
        for i in range(k, n, threads):
            filer.create_entry(new_file(f"/par/d{i % 50:02d}/f{i:05d}"))

    workers = [threading.Thread(target=run, args=(k,))
               for k in range(threads)]
    t = time.perf_counter()
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    secs = time.perf_counter() - t
    return {"step": "filer_16_threads", "entries": n, "seconds": secs,
            "entries_per_s": n / secs}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--entries", type=int, default=2000)
    n = ap.parse_args().entries
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    try:
        store = SqliteStore(path=str(WORK / "filer.db"))
        filer = Filer(store)
        for row in (per_commit(store, n), one_transaction(store, n),
                    through_filer(filer, n)):
            print(json.dumps(row), flush=True)
        filer.close()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = ""
    print(json.dumps({"step": "host", "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
