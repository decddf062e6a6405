"""CI mode: run the per-subsystem crash sweep at a fixed seed budget.

    python -m seaweedfs_torch.crashsim [--seeds N] [--points N]
                                       [--workloads a,b,...] [--json]

Exit codes: 0 = every crash point satisfied the durability contract,
1 = violations (printed), 2 = usage error.
"""

from __future__ import annotations

import argparse
import json
import sys

from .harness import sweep_all


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m seaweedfs_torch.crashsim")
    ap.add_argument("--seeds", type=int, default=2,
                    help="seeds per workload (default 2)")
    ap.add_argument("--points", type=int, default=20,
                    help="crash points per seed (default 20)")
    ap.add_argument("--workloads", default="",
                    help="comma-separated subset (default: all)")
    ap.add_argument("--json", action="store_true",
                    help="emit the full summary as JSON")
    args = ap.parse_args(argv)
    if args.seeds < 1 or args.points < 1:
        ap.print_usage(sys.stderr)
        return 2

    names = [n for n in args.workloads.split(",") if n] or None
    summary = sweep_all(seeds=args.seeds, points=args.points,
                        workload_names=names)
    if names and not summary["workloads"]:
        print(f"no workloads matched {names}", file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps(summary, indent=1, default=repr))
    for name, runs in summary["workloads"].items():
        pts = sum(r["points"] for r in runs)
        ops = runs[0]["ops"] if runs else 0
        bad = [v for r in runs for v in r["violations"]]
        status = "ok" if not bad else f"{len(bad)} VIOLATIONS"
        print(f"{name:18s} {pts:4d} crash points over {ops:5d} ops: "
              f"{status}")
        for v in bad:
            print(f"    crash@{v['crash']}: {v['error']}")
    print(f"crashsim: {summary['total_points']} crash points, "
          f"{summary['total_violations']} violations")
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
