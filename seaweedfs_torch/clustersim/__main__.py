"""Sweep seeds x scenarios, check determinism, exit 1 on a violation.

    python -m seaweedfs_torch.clustersim --seeds 2 --nodes 1000
    python -m seaweedfs_torch.clustersim --scenarios skew --seed-base 7 --json

The port's copy of seaweedfs_tpu/clustersim/__main__.py. Every
(scenario, seed) cell runs twice; differing digests are reported as a
determinism violation, so a failure's seed is a complete reproduction
(replay one cell with ``--seeds 1 --seed-base N``).
"""

from __future__ import annotations

import argparse
import json
import sys

from .scenarios import SCENARIOS, run_scenario


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m seaweedfs_torch.clustersim",
        description="deterministic control-plane simulator sweep")
    ap.add_argument("--seeds", type=int, default=2,
                    help="seeds per scenario (default 2)")
    ap.add_argument("--seed-base", type=int, default=0,
                    help="first seed (replay a failed cell with "
                         "--seeds 1 --seed-base N)")
    ap.add_argument("--nodes", type=int, default=1000,
                    help="virtual nodes per run (default 1000)")
    ap.add_argument("--scenarios", default=",".join(SCENARIOS),
                    help=f"comma list of {','.join(SCENARIOS)}")
    ap.add_argument("--json", action="store_true",
                    help="emit the full report list as JSON")
    args = ap.parse_args(argv)

    names = [s for s in args.scenarios.split(",") if s]
    unknown = [s for s in names if s not in SCENARIOS]
    if unknown:
        ap.error(f"unknown scenario(s): {', '.join(unknown)}")

    reports, failed = [], 0
    for name in names:
        for seed in range(args.seed_base, args.seed_base + args.seeds):
            rep = run_scenario(name, seed, nodes=args.nodes)
            replay = run_scenario(name, seed, nodes=args.nodes)
            if replay["digest"] != rep["digest"]:
                rep["violations"].append(
                    f"NONDETERMINISTIC: seed {seed} produced digests "
                    f"{rep['digest'][:12]} and {replay['digest'][:12]}")
            reports.append(rep)
            status = "ok" if not rep["violations"] else "FAIL"
            if rep["violations"]:
                failed += 1
            print(f"[{status}] {name} seed={seed} nodes={rep['nodes']} "
                  f"ticks={rep['ticks']} moves={rep['moves']} "
                  f"repairs={rep['repairs']} "
                  f"digest={rep['digest'][:12]}", file=sys.stderr)
            for v in rep["violations"]:
                print(f"       violation: {v}", file=sys.stderr)
    if args.json:
        print(json.dumps(reports, indent=2, sort_keys=True))
    print(f"clustersim: {len(reports) - failed}/{len(reports)} cells "
          f"clean", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
