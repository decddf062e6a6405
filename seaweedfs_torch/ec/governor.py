"""Adaptive operating-point governor for the EC host feed.

The port's copy of seaweedfs_tpu/ec/governor.py. The binding stage of the
streaming pipeline is a property of the host (page-cache copies, disk,
the link to the card), so the batch size and queue depths follow from
measured stage times, not from constants:

- every governed ``stream_encode``/``stream_rebuild`` emits per-batch
  ``ec.read`` / ``ec.dispatch`` / ``ec.kernel`` / ``ec.write`` spans into
  the observe ring; ``finish_run`` aggregates them
  (``observe.stage_totals``) into a per-stage time model;
- the model retunes the operating point within hard bounds: the batch
  grows while per-batch reads are overhead-dominated, the reader pool
  widens and the queues deepen when reads, the card or the writers bind,
  and everything is clamped so pooled staging memory stays under a
  budget;
- the chosen point and the stage model are exported as gauges in the
  shared "ec" metrics registry.

Tuning applies BETWEEN runs (the point persists across volumes in the
process), never mid-stream. On the card ``ec.kernel`` is the wait for a
batch's copies and kernel (the materialize), as in the reference, not
the kernel's own time.

Env knobs (all optional):
  WEED_EC_GOVERNOR=0            disable adaptation (fixed defaults/env)
  WEED_EC_BATCH_BYTES           starting batch size   (default 8 MiB)
  WEED_EC_DEPTH                 starting queue depth  (default 4)
  WEED_EC_BATCH_MIN/MAX         batch bounds          (1 MiB / 64 MiB)
  WEED_EC_DEPTH_MIN/MAX         depth bounds          (2 / 8)
  WEED_EC_HOST_BUDGET_MB        pooled staging budget (512 MiB)
  WEED_EC_READERS               starting reader-pool width (cores, <=4)
  WEED_EC_READERS_MIN/MAX       reader bounds         (1 / min(8, cores))
  WEED_EC_GZIP_WORKERS          fused compaction/gzip pool (cores, <=4)
  WEED_EC_GZIP_MIN/MAX          gzip-worker bounds    (1 / min(8, cores))
  WEED_EC_MMAP=0                force the preadv feed (see ec/feed.py)
  WEED_EC_ODIRECT=1             page-cache-bypassing reads (ec/feed.py)
  WEED_EC_FORMULATION           pin the GF kernel formulation
                                (lut|bitplane|xorsched, ops/rs_torch.py);
                                unset, the governor explores bitplane vs
                                xorsched per geometry on coders with a
                                retune hook and exploits the faster
                                measured kernel rate
"""

from __future__ import annotations

import os
import threading
from typing import NamedTuple

from .. import observe
from ..ops import rs_torch
from ..utils import metrics as metrics_mod
from . import feed as feed_mod

MB = 1024 * 1024


def _env_int(name: str, default: int) -> int:
    try:
        v = int(os.environ.get(name, ""))
        return v if v > 0 else default
    except ValueError:
        return default


class OperatingPoint(NamedTuple):
    batch_size: int
    depth: int        # read + materialize queue depth
    write_depth: int  # per-shard-file writer queue depth
    readers: int = 1  # feed reader-pool width (ec/feed.py)
    chips: int = 1    # device count a batch splits over (multi-card coder)
    gzip_workers: int = 1  # fused warm-down compaction/gzip pool
    # GF kernel formulation (rs_torch.FORMULATIONS); "" on runs whose
    # coder exposes no retune hook, so finish_run never mis-attributes
    formulation: str = "bitplane"


# per-batch read time below this is dispatch/syscall-overhead-dominated:
# widen the batch so fixed costs amortize
_READ_OVERHEAD_S = 0.02
# stage share above which a stage counts as "binding"
_BIND_FRACTION = 0.5


class FeedGovernor:
    """Process-global tuner; one instance via get()."""

    # formulation candidates explored per geometry; lut is reachable only
    # by the env pin
    _FORM_CANDIDATES = ("bitplane", "xorsched")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.enabled = os.environ.get("WEED_EC_GOVERNOR", "1") not in (
            "0", "false", "no")
        self.batch_min = _env_int("WEED_EC_BATCH_MIN", 1 * MB)
        self.batch_max = _env_int("WEED_EC_BATCH_MAX", 64 * MB)
        self.depth_min = _env_int("WEED_EC_DEPTH_MIN", 2)
        self.depth_max = _env_int("WEED_EC_DEPTH_MAX", 8)
        self.budget = _env_int("WEED_EC_HOST_BUDGET_MB", 512) * MB
        self.readers_min = _env_int("WEED_EC_READERS_MIN", 1)
        self.readers_max = _env_int(
            "WEED_EC_READERS_MAX", max(1, min(8, os.cpu_count() or 1)))
        self.gzip_min = _env_int("WEED_EC_GZIP_MIN", 1)
        self.gzip_max = _env_int(
            "WEED_EC_GZIP_MAX", max(1, min(8, os.cpu_count() or 1)))
        self._batch = min(max(_env_int("WEED_EC_BATCH_BYTES", 8 * MB),
                              self.batch_min), self.batch_max)
        self._depth = min(max(_env_int("WEED_EC_DEPTH", 4),
                              self.depth_min), self.depth_max)
        self._write_depth = self._depth
        self._readers = min(max(feed_mod.reader_count_default(),
                                self.readers_min), self.readers_max)
        self._gzip_workers = min(
            max(feed_mod.env_thread_count("WEED_EC_GZIP_WORKERS", 64),
                self.gzip_min), self.gzip_max)
        self.metrics = metrics_mod.shared("ec")
        self.stage_gbps: dict[str, float] = {}
        # measured kernel-stage rate per (k, formulation): the
        # formulation axis's model, fed by finish_run
        self.form_gbps: dict[tuple[int, str], float] = {}
        self._form_by_k: dict[int, str] = {}
        self.runs = 0

    # --- planning ---

    def plan(self, nbytes: int, k: int, chips: int = 1) -> OperatingPoint:
        """The operating point for the next run, memory-clamped. The
        pooled staging footprint is (depth + 2) buffers of k * batch
        bytes (depth queued + one assembling + one in flight). `chips` is
        the number of devices each batch's columns split over: the batch
        is clamped no smaller than one reasonable slice per device."""
        with self._lock:
            batch, depth = self._batch, self._depth
            floor = min(max(self.batch_min, self.batch_min * max(chips, 1)),
                        self.batch_max)
            batch = max(batch, floor)
            while (depth + 2) * k * batch > self.budget:
                if batch > floor:
                    batch = max(batch // 2, floor)
                elif batch > self.batch_min:
                    batch = max(batch // 2, self.batch_min)
                elif depth > self.depth_min:
                    depth -= 1
                else:
                    break
            op = OperatingPoint(batch, depth, self._write_depth,
                                self._readers, max(chips, 1),
                                self._gzip_workers,
                                self._plan_formulation(k))
            self._export(op)
            return op

    def _plan_formulation(self, k: int) -> str:
        """The kernel formulation for the next run at geometry k (lock
        held): an operator pin (WEED_EC_FORMULATION) always wins; else
        explore each candidate once, then exploit the argmax of the EMA'd
        measured kernel rate."""
        pin = rs_torch.formulation_env()
        if pin is not None:
            self._form_by_k[k] = pin
            return pin
        if not self.enabled:
            return self._form_by_k.get(k, "bitplane")
        for cand in self._FORM_CANDIDATES:
            if (k, cand) not in self.form_gbps:
                self._form_by_k[k] = cand
                return cand
        best = max(self._FORM_CANDIDATES,
                   key=lambda f: self.form_gbps[(k, f)])
        self._form_by_k[k] = best
        return best

    # --- measurement + retune ---

    _STAGES = {"read": "ec.read", "dispatch": "ec.dispatch",
               "kernel": "ec.kernel", "write": "ec.write",
               # the fused warm-down's stages (a later slice)
               "compact": "ec.compact", "gzip": "ec.gzip",
               "digest": "ec.digest"}

    def finish_run(self, trace_id: str, op: OperatingPoint,
                   nbytes: int, k: int) -> None:
        """Fold one run's spans into the model and retune for the next.
        The observe ring is bounded, so rates use the bytes COVERED by
        the spans counted (count * batch bytes), never the volume size."""
        totals = observe.stage_totals(trace_id, prefix="ec.")
        stages: dict[str, tuple[int, float]] = {}
        for stage, span_name in self._STAGES.items():
            count, total_us = totals.get(span_name, (0, 0))
            stages[stage] = (count, total_us / 1e6)
        batch_bytes = k * op.batch_size
        with self._lock:
            self.runs += 1
            kernel_gbps = None
            for stage, (count, secs) in stages.items():
                covered = min(count * batch_bytes, nbytes)
                if secs > 1e-6 and covered:
                    gbps = covered / secs / 1e9
                    if stage == "kernel":
                        kernel_gbps = gbps
                    prev = self.stage_gbps.get(stage)
                    self.stage_gbps[stage] = (
                        gbps if prev is None else 0.5 * prev + 0.5 * gbps)
                self.metrics.gauge("feed_stage_seconds", round(secs, 6),
                                   labels={"stage": stage})
                g = self.stage_gbps.get(stage)
                if g is not None:
                    self.metrics.gauge("feed_stage_gbps", round(g, 3),
                                       labels={"stage": stage})
            if kernel_gbps is not None and op.formulation:
                fkey = (k, op.formulation)
                prev = self.form_gbps.get(fkey)
                self.form_gbps[fkey] = (
                    kernel_gbps if prev is None
                    else 0.5 * prev + 0.5 * kernel_gbps)
                self.metrics.gauge(
                    "feed_formulation_gbps",
                    round(self.form_gbps[fkey], 3),
                    labels={"k": str(k), "formulation": op.formulation})
            if self.enabled:
                self._retune(stages, op)
            self._export(OperatingPoint(
                self._batch, self._depth, self._write_depth,
                self._readers, op.chips, self._gzip_workers,
                self._form_by_k.get(k, op.formulation)))

    def _retune(self, stages: dict[str, tuple[int, float]],
                op: OperatingPoint) -> None:
        """One bounded step toward the measured bottleneck (lock held)."""
        total = sum(s for _, s in stages.values())
        if total <= 1e-6:
            return
        slowest = max(stages, key=lambda st: stages[st][1])
        count, secs = stages[slowest]
        share = secs / total
        if slowest == "read":
            per_batch = secs / max(count, 1)
            if per_batch < _READ_OVERHEAD_S and op.batch_size < self.batch_max:
                # reads finish faster than their fixed per-batch costs:
                # wider batches amortize syscalls and dispatches
                self._batch = min(op.batch_size * 2, self.batch_max)
            elif share > _BIND_FRACTION and op.readers < self.readers_max:
                # read-bound: widen the reader pool first (parallel reads
                # add disk bandwidth; depth only smooths bursts)
                self._readers = min(max(op.readers * 2, 2),
                                    self.readers_max)
            elif share > _BIND_FRACTION and op.depth < self.depth_max:
                self._depth = min(op.depth + 1, self.depth_max)
        elif slowest in ("kernel", "dispatch"):
            if (share > _BIND_FRACTION and op.chips > 1
                    and op.batch_size < self.batch_max):
                # several devices: each sees batch/chips columns, so the
                # batch scales with them before queues deepen
                self._batch = min(op.batch_size * 2, self.batch_max)
            elif share > _BIND_FRACTION and op.depth < self.depth_max:
                # the device is the slow stage: keep more host batches
                # queued so it never waits on the feed
                self._depth = min(op.depth + 1, self.depth_max)
        elif slowest in ("gzip", "compact"):
            if share > _BIND_FRACTION and op.gzip_workers < self.gzip_max:
                self._gzip_workers = min(max(op.gzip_workers * 2, 2),
                                         self.gzip_max)
        elif slowest == "write":
            if share > _BIND_FRACTION:
                # deeper writer queues absorb disk jitter; capped at the
                # staging pool size (depth + 2), since queued rows hold
                # pooled batches
                self._write_depth = min(max(op.write_depth * 2, 2),
                                        self._depth + 2)

    def _export(self, op: OperatingPoint) -> None:
        if op.formulation:
            for f in self._FORM_CANDIDATES:
                self.metrics.gauge(
                    "feed_formulation_active",
                    1.0 if f == op.formulation else 0.0,
                    labels={"formulation": f})
        self.metrics.gauge("feed_batch_bytes", op.batch_size)
        self.metrics.gauge("feed_queue_depth", op.depth,
                           labels={"queue": "read"})
        self.metrics.gauge("feed_queue_depth", op.depth,
                           labels={"queue": "materialize"})
        self.metrics.gauge("feed_queue_depth", op.write_depth,
                           labels={"queue": "write"})
        self.metrics.gauge("feed_reader_threads", op.readers)
        self.metrics.gauge("feed_mesh_devices", op.chips)
        self.metrics.gauge("feed_gzip_workers", op.gzip_workers)
        self.metrics.gauge("feed_governor_enabled", 1.0 if self.enabled
                           else 0.0)
        self.metrics.gauge("feed_runs", self.runs)


_GOV: FeedGovernor | None = None
_GOV_LOCK = threading.Lock()


def get() -> FeedGovernor:
    global _GOV
    with _GOV_LOCK:
        if _GOV is None:
            _GOV = FeedGovernor()
        return _GOV


def reset() -> None:
    """Drop the singleton (tests re-read env bounds)."""
    global _GOV
    with _GOV_LOCK:
        _GOV = None
