#!/usr/bin/env python3
"""chip_smoke.py of several checkouts, one after another on one host, each
timed as a whole command, so that two commits compare on the same card.

    python3 scripts/torch_smoke_ab.py DIR [DIR ...]

Each DIR holds a checkout, say the parent's and the change's ``git
archive`` unpacked into a directory that .gitignore lists. The script runs
``python3 chip_smoke.py`` from each in the order given (parent, change),
writes its output and errors to ``smoke_ab.log`` and ``smoke_ab.err`` in
that directory, and prints one JSON line per run: the directory, the exit
code, the seconds of command (the clock around the process, the kernels' build
included), the smoke's own ``phase_seconds`` line and its last line. It
prints the card's name and power limit first, exits 2 without a card, and
1 if any run failed.
"""

import json
import subprocess
import sys
import time
from pathlib import Path


def main(dirs: list) -> int:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
    except OSError:
        smi = None
    if smi is None or smi.returncode != 0:
        print("torch_smoke_ab: no CUDA device", file=sys.stderr)
        return 2
    print(smi.stdout.strip(), flush=True)
    failed = 0
    for d in dirs:
        log, err = Path(d) / "smoke_ab.log", Path(d) / "smoke_ab.err"
        with open(log, "wb") as o, open(err, "wb") as e:
            t0 = time.perf_counter()
            rc = subprocess.call([sys.executable, "chip_smoke.py"],
                                 cwd=d, stdout=o, stderr=e)
            secs = time.perf_counter() - t0
        lines = log.read_text(errors="replace").splitlines()
        phases = next((json.loads(x) for x in reversed(lines)
                       if x.startswith('{"phase": "phase_seconds"')), None)
        print(json.dumps({"dir": str(d), "rc": rc, "command_s": secs,
                          "phase_seconds": phases,
                          "last_line": lines[-1] if lines else ""}),
              flush=True)
        failed |= rc != 0
    return int(failed)


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
