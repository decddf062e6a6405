"""Leader-only geo daemon: owns per-bucket replication state.

The port's copy of seaweedfs_tpu/geo/daemon.py. Runs on the master as a
sibling of the repair and lifecycle daemons and keeps their discipline:
leader-only (two masters must never both drive one bucket's replication:
double appliers would fight over offsets), CLASS_BG priority bound for
the loop and every job task, jittered scan interval.

Each pass scans ``/buckets`` on the configured filer for bucket entries
carrying a replication configuration (geo/rules.py, written by S3
PutBucketReplication), reconciles the running job set against the
enabled rules (start on rule create, which triggers the backfill; stop
on rule delete or disable or on leadership loss), and exports per-bucket
lag gauges. The jobs themselves are
:class:`~seaweedfs_torch.geo.replicate.BucketReplicator` tasks on the
master's loop.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

import aiohttp

from .. import observe, overload
from ..lifecycle import jittered
from . import GeoConfig
from . import rules as rules_mod
from .replicate import BucketReplicator

log = logging.getLogger("geo")


class GeoDaemon:
    def __init__(self, master, cfg: Optional[GeoConfig] = None):
        self.master = master
        self.cfg = cfg or GeoConfig.from_env()
        self.jobs: dict[str, BucketReplicator] = {}
        self.passes = 0
        self.last_pass = 0.0

    # --- loop ---

    async def run_loop(self) -> None:
        # geo work is background by definition: rule scans, backfills,
        # and every replication write shed first under load
        overload.set_priority(overload.CLASS_BG)
        while True:
            await asyncio.sleep(jittered(self.cfg.interval))
            try:
                await self.pass_once()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                log.warning("geo pass failed: %s", e)

    async def aclose(self) -> None:
        for job in list(self.jobs.values()):
            await job.stop()
        self.jobs.clear()

    # --- one reconcile pass ---

    async def pass_once(self) -> dict:
        master = self.master
        if not master.raft.is_leader or not await master.raft.ensure_ready():
            # a deposed leader must stop driving replication NOW: the
            # new leader's jobs own the offsets from here.  The stopped
            # jobs stay in the dict (state "stopped") so a transient
            # readiness blip — loop lag under a storm, an election in
            # flight — restarts them with their cumulative stats
            # carried instead of silently zeroing the counters.
            for job in list(self.jobs.values()):
                await job.stop()
            return {"skipped": "not leader"}
        self.passes += 1
        self.last_pass = time.time()
        rules = await self._scan_rules()
        started, stopped = [], []
        for bucket, rule in rules.items():
            old = self.jobs.get(bucket)
            if old is not None and old.rule == rule and old.running:
                continue
            if old is not None:
                await old.stop()
            job = BucketReplicator(
                self.cfg.filer, bucket, rule, self.cfg,
                metrics=master.metrics,
                leader_check=lambda: master.raft.is_leader)
            if old is not None and old.rule == rule:
                # a dead job restarting under the same rule: carry the
                # cumulative stats (and say so — a silently-resetting
                # applied counter hides the death)
                job.applied, job.skipped = old.applied, old.skipped
                job.poisoned = old.poisoned
                job.backfilled = old.backfilled
                job.restarts = old.restarts + 1
                log.warning("geo: job for bucket %s restarted "
                            "(last error: %s)", bucket,
                            old.last_error or "none")
            self.jobs[bucket] = job
            job.start()
            started.append(bucket)
        for bucket in list(self.jobs):
            if bucket not in rules:
                await self.jobs.pop(bucket).stop()
                stopped.append(bucket)
        self.export_gauges()
        return {"buckets": sorted(rules), "started": started,
                "stopped": stopped}

    async def _scan_rules(self) -> dict[str, dict]:
        """bucket -> active replication rule, read off the filer's
        bucket entries (paginated — bucket #1001's rule is enforced
        exactly like bucket #1's)."""
        out: dict[str, dict] = {}
        start = ""
        while True:
            with observe.span("geo.scan_rules"):
                entries = await self._filer_list("/buckets", start)
            for e in entries:
                name = e["path"].rsplit("/", 1)[-1]
                if name.startswith("."):
                    continue
                raw = (e.get("extended") or {}).get(rules_mod.BUCKET_ATTR)
                if not raw:
                    continue
                rule = rules_mod.active_rule(
                    rules_mod.rules_from_json(raw))
                if rule is not None:
                    out[name] = rule
            if len(entries) < 512:
                return out
            start = entries[-1]["path"].rsplit("/", 1)[-1]

    async def _filer_list(self, dir_path: str, start: str) -> list[dict]:
        async with self.master._maint_http().get(
                f"http://{self.cfg.filer}/__meta__/list",
                params={"dir": dir_path, "start": start, "limit": "512"},
                timeout=aiohttp.ClientTimeout(total=60)) as r:
            if r.status != 200:
                # a failed scan must ABORT the pass (run_loop retries
                # next interval) — reporting "no rules" here would make
                # pass_once stop every live replication job on one
                # transient filer 5xx
                raise RuntimeError(
                    f"geo rule scan: filer list {dir_path}: "
                    f"HTTP {r.status}")
            return (await r.json()).get("entries", [])

    # --- observability ---

    def export_gauges(self) -> None:
        m = self.master.metrics
        m.gauge("geo_jobs", len(self.jobs))
        for bucket, job in self.jobs.items():
            m.gauge("geo_replication_lag_s", job.current_lag_s(),
                    labels={"bucket": bucket})

    def status(self) -> dict:
        return {
            "enabled": self.cfg.enabled,
            "is_leader": self.master.raft.is_leader,
            "filer": self.cfg.filer,
            "peer": self.cfg.peer,
            "passes": self.passes,
            "last_pass": self.last_pass,
            "jobs": {b: j.status()
                     for b, j in sorted(self.jobs.items())},
        }
