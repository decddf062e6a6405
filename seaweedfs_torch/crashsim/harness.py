"""Sweep runner: record a workload once, replay many crash prefixes,
restart the subsystem on each reconstructed tree and hold it to the
durability contract.

The port's copy of seaweedfs_tpu/crashsim/harness.py; ``sweep_all`` also
takes workload instances (``workloads.registry``'s defaults otherwise),
so a caller can sweep the workloads at its own coder and sizes.

The contract, uniformly across subsystems:

1. every write ACKED before the crash point is present and intact
   (byte-exact) after recovery;
2. no torn/corrupt state loads silently — recovery either sees a
   complete committed state or detects-and-repairs, never serves
   garbage;
3. recovery converges: reopening the subsystem on ANY crash tree
   succeeds (no unhandled exception), and a second open of the
   recovered tree is clean.

Workloads declare acked state through the ``ack(key, value)`` callback,
which pins the (key -> expected value) pair to the current op-log
watermark: a crash at index i must preserve every ack whose watermark
is <= i. ``value=None`` means "durably deleted".

Un-acked mutations are *allowed* (not required) to surface after a
crash — a write that reached the kernel before the power cut may
legitimately be complete on the platter even though nobody was told so.
Workloads register those with ``ack.candidate(key, value)`` BEFORE
issuing the mutation; the checker then accepts either the last acked
value or any candidate declared after it — but never a third, torn,
state.
"""

from __future__ import annotations

import os
import random
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Optional

from .replay import build_crash_state
from .shim import DiskRecorder


@dataclass
class CrashWorkload:
    name: str
    # build the pre-recording durable baseline tree
    setup: Callable[[str], None]
    # run mutations under recording; ack(key, value) after barriers
    run: Callable[[str, Callable, random.Random], None]
    # reopen the subsystem on a crash tree; return {key: value} of the
    # recovered state; raising = recovery failure (a violation)
    recover: Callable[[str], dict]
    # optional extra integrity probe: (crash_dir, observed, expected)
    # -> [violation strings]
    check: Optional[Callable[[str, dict, dict], list]] = None


@dataclass
class SweepResult:
    workload: str
    seed: int
    points: int = 0
    ops: int = 0
    violations: list = field(default_factory=list)   # (crash_idx, msg)
    elapsed_s: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        return {"workload": self.workload, "seed": self.seed,
                "points": self.points, "ops": self.ops,
                "violations": [
                    {"crash": c, "error": m[:500]}
                    for c, m in self.violations],
                "elapsed_s": round(self.elapsed_s, 3)}


class AckLog:
    """The callback handed to workload.run: records durable promises
    (``ack(key, value)``) and in-flight mutations
    (``ack.candidate(key, value)``) pinned to op-log watermarks."""

    def __init__(self, rec: DiskRecorder):
        self._rec = rec
        self._seq = 0               # declaration order (ops may tie)
        self.acks: list = []        # (mark, seq, key, value)
        self.candidates: list = []  # (mark, seq, key, value)

    def __call__(self, key, value) -> None:
        self._seq += 1
        self.acks.append((self._rec.mark(), self._seq, key, value))

    def candidate(self, key, value) -> None:
        self._seq += 1
        self.candidates.append((self._rec.mark(), self._seq, key, value))


def _check_contract(log: AckLog, crash: int, observed: dict) -> list:
    """Violations of the durability contract at crash index `crash`."""
    out = []
    by_key: dict = {}
    for mark, seq, key, value in log.acks:
        if mark <= crash:
            by_key[key] = (seq, value)
    for key, (seq, value) in by_key.items():
        allowed = [value] + [
            cv for cm, cseq, ck, cv in log.candidates
            if ck == key and cseq > seq and cm <= crash]
        got = observed.get(key, "<missing>")
        if not any(got == a for a in allowed):
            out.append(f"acked {key!r} lost or corrupt: expected "
                       f"{value!r} (or a later in-flight value), got "
                       f"{got!r}"[:400])
    return out


def sweep(workload: CrashWorkload, seed: int, points: int,
          scratch_dir: Optional[str] = None) -> SweepResult:
    """Record `workload` once, then check `points` random crash
    prefixes (plus the two boundary prefixes: nothing happened /
    everything happened)."""
    t0 = time.monotonic()
    result = SweepResult(workload=workload.name, seed=seed)
    own_scratch = scratch_dir is None
    scratch = scratch_dir or tempfile.mkdtemp(prefix="crashsim-")
    try:
        record_root = os.path.join(scratch, "record")
        os.makedirs(record_root, exist_ok=True)
        workload.setup(record_root)

        rec = DiskRecorder(record_root)
        log = AckLog(rec)
        run_rng = random.Random(seed)
        with rec:
            workload.run(record_root, log, run_rng)
        result.ops = len(rec.ops)

        rng = random.Random(seed * 1_000_003 + 17)
        crash_points = [0, len(rec.ops)] + [
            rng.randrange(len(rec.ops) + 1)
            for _ in range(max(0, points - 2))]
        for i, crash in enumerate(crash_points):
            crash_dir = os.path.join(scratch, f"crash-{i}")
            decide_rng = random.Random((seed << 20) ^ (crash * 2654435761))
            build_crash_state(rec.baseline, rec.ops, crash, decide_rng,
                              crash_dir)
            try:
                observed = workload.recover(crash_dir)
            except Exception:
                result.violations.append(
                    (crash, "recovery raised:\n"
                     + traceback.format_exc(limit=6)))
                shutil.rmtree(crash_dir, ignore_errors=True)
                result.points += 1
                continue
            for msg in _check_contract(log, crash, observed):
                result.violations.append((crash, msg))
            if workload.check is not None:
                expected = {k: v for m, _s, k, v in log.acks
                            if m <= crash}
                for msg in workload.check(crash_dir, observed, expected):
                    result.violations.append((crash, msg))
            shutil.rmtree(crash_dir, ignore_errors=True)
            result.points += 1
    finally:
        if own_scratch:
            shutil.rmtree(scratch, ignore_errors=True)
    result.elapsed_s = time.monotonic() - t0
    return result


def sweep_all(seeds: int = 2, points: int = 20,
              workload_names: Optional[list] = None,
              workloads: Optional[list] = None,
              scratch_dir: Optional[str] = None) -> dict:
    """Run every workload (`workloads`, default every registered one at
    its defaults) at `seeds` seeds x `points` crash points; returns a
    JSON-ready summary (the ``python -m seaweedfs_torch.crashsim`` gate
    consumes it). `scratch_dir` holds each sweep's trees (default: a
    temporary directory per sweep)."""
    from . import workloads as wl
    summary: dict = {"workloads": {}, "total_points": 0,
                     "total_violations": 0, "ok": True}
    for w in (workloads if workloads is not None else wl.registry()):
        if workload_names and w.name not in workload_names:
            continue
        runs = []
        for seed in range(1, seeds + 1):
            scratch = None
            if scratch_dir is not None:
                scratch = os.path.join(scratch_dir, f"{w.name}-{seed}")
                os.makedirs(scratch, exist_ok=True)
            try:
                r = sweep(w, seed=seed, points=points, scratch_dir=scratch)
            finally:
                if scratch is not None:
                    shutil.rmtree(scratch, ignore_errors=True)
            runs.append(r.to_dict())
            summary["total_points"] += r.points
            summary["total_violations"] += len(r.violations)
            if not r.ok:
                summary["ok"] = False
        summary["workloads"][w.name] = runs
    return summary
