"""The lifecycle daemon: executes what policy.py plans.

The port's reduced copy of seaweedfs_tpu/lifecycle/daemon.py. It runs on
the master as a sibling of the repair daemon and shares its discipline:

* the same concurrency semaphore (``master._repair_sem``), so warm-downs
  and rebuilds compete for one bounded budget;
* the same per-key exponential backoff (``master._repair_backoff``), so
  a transition that keeps failing retries at 2^n * interval, capped at
  300 s.
* the same pause: while an operator holds the admin lock (the shell's
  commands that move volumes do), no pass runs;
* the same leadership: a pass runs on the raft leader alone, once its
  term's no-op has committed and while its lease is live
  (``master.leader_ready``), and a transition re-checks leadership
  between its steps, so a deposed leader stops instead of racing the new
  one.

Transitions are crash-safe by ordering, not by a journal: the original
volume is deleted only after every shard is verified mounted on its
target (a ``/status`` read-back, not a trusted response), so a crash at
any point leaves either the original volume or a complete shard set,
never neither, and the next pass converges (shards already live: retire
the original; shards incomplete: encode again). The fault points
``lifecycle.warm``, ``lifecycle.encode``, ``lifecycle.unec`` and
``lifecycle.expire`` kill a transition at its worst moment in tests.

The S3 pass (``_s3_pass``), with ``cfg.filer`` set, runs first in each
pass: it pages through ``/buckets`` on the filer's ``/__meta__/list``, and
for a bucket entry whose ``extended`` attribute holds enabled rules
(s3_rules.py) walks its objects (at most ``cfg.scan_limit`` a pass): one
past its rule's Expiration days (``cfg.day_seconds`` each) is deleted
through ``/__meta__/delete`` (the filer frees its chunks), one past its
Transition days is marked ``WARM`` through ``/__meta__/update_entry`` and
its chunks' volumes join ``warm_requested``, so the same pass plans their
warm-down. Each action is recorded as ``s3_expire`` / ``s3_transition``.

Every call to a volume server or the filer is an awaited aiohttp call on
the master's loop. Left out: the overload plane's background priority
and spans' trace propagation.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from collections import deque
from dataclasses import asdict
from typing import Optional

import aiohttp

from .. import faults, observe
from ..shell.ec_commands import collect_ec_nodes, plan_shard_spread
from ..storage.file_id import FileId
from . import jittered
from . import s3_rules
from .policy import LifecycleConfig, Transition, plan_transitions

log = logging.getLogger("lifecycle")


class _EncodeBatcher:
    """Warm transitions that reach their encode step together coalesce
    into ONE multi-volume ``ec/fused`` (or ``ec/generate``) POST per
    source server, so the volume server streams the whole window through
    one governed pass (``Store.ec_fused_generate_many``). The window is
    at most ``WEED_EC_ENCODE_WINDOW`` volumes (8); a short linger lets
    near-simultaneous transitions land in one window."""

    def __init__(self, daemon: "LifecycleDaemon", linger: float = 0.5):
        self.daemon = daemon
        self.linger = linger
        try:
            self.max_window = max(
                1, int(os.environ.get("WEED_EC_ENCODE_WINDOW", "8")))
        except ValueError:
            self.max_window = 8
        # (source url, fused?) -> [(vid, future)] awaiting the next
        # window; fused and plain encodes hit different endpoints, so
        # they window separately
        self._waiting: dict[tuple, list] = {}

    async def encode(self, source: str, vid: int,
                     fused: bool = False) -> None:
        fut = asyncio.get_running_loop().create_future()
        key = (source, fused)
        batch = self._waiting.setdefault(key, [])
        batch.append((vid, fut))
        if len(batch) >= self.max_window:
            self._waiting.pop(key, None)
            await self._post(key, batch)
        elif len(batch) == 1:
            task = asyncio.create_task(self._flush_after(key, batch))
            self.daemon.tasks.add(task)
            task.add_done_callback(self.daemon.tasks.discard)
        await fut

    async def _flush_after(self, key: tuple, batch: list) -> None:
        await asyncio.sleep(self.linger)
        # flush only this batch: if a full window already flushed it and
        # a newer batch is forming, this linger must not fire that early
        if self._waiting.get(key) is batch:
            self._waiting.pop(key, None)
            await self._post(key, batch)

    async def _post(self, key: tuple, batch: list) -> None:
        source, fused = key
        vids = [vid for vid, _ in batch]
        body = ({"volume_id": vids[0]} if len(vids) == 1
                else {"volume_ids": vids})
        # windows by size: what a warm-down storm coalesced into
        self.daemon.master.metrics.count(
            "lifecycle_encode_windows", labels={"volumes": str(len(vids))})
        log.info("encode window on %s: volumes %s (%s)", source, vids,
                 "fused" if fused else "plain")
        try:
            await self.daemon.master._admin_post(
                source, "ec/fused" if fused else "ec/generate", body,
                timeout=900.0 * len(vids))
        except Exception as e:
            # every waiter of the window fails with the window's error
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)
        else:
            for _, fut in batch:
                if not fut.done():
                    fut.set_result(None)


class LifecycleDaemon:
    def __init__(self, master, cfg: Optional[LifecycleConfig] = None):
        self.master = master
        self.cfg = cfg or LifecycleConfig.from_env()
        # key -> monotonic start time of the in-flight transition
        self._inflight: dict[tuple, float] = {}
        self.tasks: set = set()
        self.recent: deque = deque(maxlen=64)
        self.last_pass = 0.0
        self.passes = 0
        # vid -> reason: volumes to warm regardless of idleness, fed by
        # S3 Transition rules
        self.warm_requested: dict[int, str] = {}
        self._encode_batcher = _EncodeBatcher(self)

    # --- loop ---
    async def run_loop(self) -> None:
        while True:
            await asyncio.sleep(jittered(self.cfg.interval))
            if self.master.daemons_paused():
                # an operator's command is moving volumes, or will
                continue
            try:
                await self.pass_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                # the daemon must outlive any one pass
                log.warning("lifecycle pass failed", exc_info=True)

    # --- one evaluation pass ---
    async def pass_once(self) -> dict:
        if not await self.master.leader_ready():
            return {"skipped": "not leader"}
        now = time.time()
        self.last_pass = now
        self.passes += 1
        s3 = {}
        if self.cfg.filer:
            try:
                s3 = await self._s3_pass(now)
            except Exception as e:
                # a bucket's malformed rules must not stall the heat-
                # and TTL-driven transitions planned below
                log.warning("lifecycle s3 pass failed: %s", e)
                s3 = {"error": str(e)}
        topology = self.master.topology
        heat = topology.heat_view(now)
        plan = plan_transitions(topology, heat, self.cfg, now,
                                self.warm_requested)
        launched = []
        for tr in plan:
            if not self._due(tr.key):
                continue
            self._launch(tr)
            launched.append({"kind": tr.kind, "volume": tr.vid,
                             "reason": tr.reason})
        self.export_gauges(heat)
        return {"planned": len(plan), "launched": launched, "s3": s3}

    def moving_vids(self) -> set:
        """Volumes with a transition in flight (the repair daemon leaves
        them to it)."""
        return {vid for _, vid in self._inflight}

    def _due(self, key: tuple) -> bool:
        if key in self._inflight:
            return False
        back = self.master._repair_backoff.get(key)
        return back is None or time.monotonic() >= back[1]

    def _launch(self, tr: Transition) -> None:
        self._inflight[tr.key] = time.monotonic()
        task = asyncio.create_task(self._run_transition(tr))
        self.tasks.add(task)
        task.add_done_callback(self.tasks.discard)

    async def _run_transition(self, tr: Transition) -> None:
        key = tr.key
        fn = {"warm": self._warm, "unec": self._unec,
              "expire": self._expire}[tr.kind]
        try:
            async with self.master._repair_sem:
                paused = self.master.daemons_paused()
                if paused:
                    # queued when an operator asked for the lease
                    log.info("lifecycle %s of volume %s deferred: %s",
                             tr.kind, tr.vid, paused)
                    return
                worker = self.master._checkout_worker()
                log.info("encode worker %d: lifecycle %s of volume %s",
                         worker, tr.kind, tr.vid)
                try:
                    with observe.span(f"lifecycle.{tr.kind}",
                                      tags={"vid": tr.vid,
                                            "reason": tr.reason,
                                            "worker": worker}):
                        await fn(tr)
                finally:
                    self.master._checkin_worker(worker)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # any failure of a step backs the transition off
            failures = self.master._repair_backoff.get(key, (0, 0.0))[0] + 1
            delay = min(self.cfg.interval * (2 ** failures), 300.0)
            self.master._repair_backoff[key] = (failures,
                                                time.monotonic() + delay)
            self._record(tr.kind, tr.vid, "failed", error=str(e))
            log.warning("lifecycle %s of volume %d failed (attempt %d, "
                        "next in %.1fs): %s", tr.kind, tr.vid, failures,
                        delay, e)
        else:
            self.master._repair_backoff.pop(key, None)
            if tr.kind == "warm":
                self.warm_requested.pop(tr.vid, None)
            self._record(tr.kind, tr.vid, "ok", reason=tr.reason)
            log.info("lifecycle %s of volume %d done (%s)", tr.kind,
                     tr.vid, tr.reason)
        finally:
            self._inflight.pop(key, None)

    def _record(self, kind: str, vid, outcome: str, reason: str = "",
                error: str = "") -> None:
        self.master.metrics.count("lifecycle_transitions",
                                  labels={"kind": kind,
                                          "outcome": outcome})
        entry = {"kind": kind, "volume": vid, "outcome": outcome,
                 "at": time.time()}
        if reason:
            entry["reason"] = reason
        if error:
            entry["error"] = error
        self.recent.appendleft(entry)

    def _check_leader(self) -> None:
        if not self.master.raft.is_leader:
            raise RuntimeError("lost leadership mid-transition")

    async def _get_json(self, url: str, path: str,
                        timeout: float = 30.0) -> dict:
        async with self.master._maint_http().get(
                f"http://{url}{path}",
                timeout=aiohttp.ClientTimeout(total=timeout)) as r:
            out = await r.json()
            if r.status != 200:
                raise RuntimeError(f"{url}{path}: "
                                   f"{out.get('error', r.status)}")
            return out

    # --- hot -> warm: seal, warm down, spread, verify, retire ---
    async def _warm(self, tr: Transition) -> None:
        master = self.master
        vid, collection = tr.vid, tr.collection
        if await faults.fire_async("lifecycle.warm"):
            raise RuntimeError("injected drop at lifecycle.warm")
        total = master.ec_total_shards_for(collection)
        # resumable finish: a prior attempt already produced the full
        # shard set, only the original is left to retire. The topology
        # can be stale (an un-EC that just deleted every shard still
        # lists them until heartbeats land), so nothing is destroyed on
        # its word: each holder's /status is read back first
        shards = master.topology.lookup_ec_shards(vid)
        if len(shards) >= total:
            holders = {n.url for nodes in shards.values() for n in nodes}
            mounted = await self._mounted_shards(vid, holders)
            if len(mounted) < total:
                raise RuntimeError(
                    f"volume {vid}: topology lists a full shard set but "
                    f"only {sorted(mounted)} verified mounted; retrying "
                    f"after the next heartbeats")
            await self._finish_warm(vid, tr.holders)
            return
        holders = tr.holders
        if not holders:
            raise RuntimeError(f"volume {vid} has no holders")
        source = holders[0]
        node = master.topology.nodes.get(source)
        sealed = (node is not None and vid in node.volumes
                  and node.volumes[vid].read_only)
        if not self.cfg.ec_fused and not sealed:
            # the chained path (WEED_EC_FUSED=0) vacuums first, when the
            # compaction would shrink the .dat: the port compacts no
            # read-only volume (ROADMAP Queue 3, D3), so unlike the
            # reference it vacuums before it seals (a volume an earlier
            # attempt sealed is encoded as it stands)
            try:
                garbage = (await self._get_json(
                    source, f"/admin/vacuum/check?volume_id={vid}")
                )["garbage_level"]
            except (aiohttp.ClientError, asyncio.TimeoutError,
                    RuntimeError, KeyError, ValueError):
                garbage = 0.0
            if garbage > 0.01:
                await master._admin_post(source, "vacuum",
                                         {"volume_id": vid},
                                         timeout=600.0)
        # 1. seal every replica: the volume takes no more writes
        for url in holders:
            self._check_leader()
            await master._admin_post(url, "volume/readonly",
                                     {"volume_id": vid, "read_only": True})
        # 2+3. the fused warm-down (WEED_EC_FUSED, default on) compacts,
        # gzips, encodes and digests in one pass on the source, else the
        # encode alone; either through the batcher. The source volume
        # stays untouched until the shards are verified
        self._check_leader()
        await self._encode_batcher.encode(source, vid,
                                          fused=self.cfg.ec_fused)
        # 4. spread with the shell's balanced plan
        plan = plan_shard_spread(
            collect_ec_nodes(master.topology.to_dict()), total, source)
        for target, sids in plan.items():
            self._check_leader()
            if target != source:
                await master._admin_post(
                    target, "ec/copy",
                    {"volume_id": vid, "collection": collection,
                     "shard_ids": sids, "source": source,
                     "copy_ecx_file": True}, timeout=600.0)
            await master._admin_post(
                target, "ec/mount",
                {"volume_id": vid, "collection": collection,
                 "shard_ids": sids})
        # verify every shard by reading each target's /status back: a
        # mount's answer does not tell "already mounted" from "missing"
        mounted = await self._mounted_shards(vid, plan)
        if len(mounted) < total:
            raise RuntimeError(
                f"volume {vid}: only shards {sorted(mounted)} mounted "
                f"({len(mounted)}/{total}); keeping the original")
        # 5. retire the original everywhere, then the source's surplus
        # shard files (the encode left all of them there)
        await self._finish_warm(vid, holders)
        surplus = [s for s in range(total) if s not in plan.get(source, [])]
        if surplus:
            await master._admin_post(
                source, "ec/delete_shards",
                {"volume_id": vid, "collection": collection,
                 "shard_ids": surplus})

    async def _mounted_shards(self, vid: int, targets) -> set:
        """Shard ids actually mounted for `vid`, read back from each
        target's /status: the only evidence trusted before a delete."""
        mounted: set[int] = set()
        for target in targets:
            st = await self._get_json(target, "/status")
            for s in st.get("ec_shards", []):
                if s.get("id") == vid:
                    mounted.update(s.get("shard_ids", []))
        return mounted

    async def _finish_warm(self, vid: int, holders: list) -> None:
        """The last step of a warm transition, shared by the fresh and
        the resume path so both cross the same fault point: the worst
        crash is "full shard set live, original not yet retired", where
        both copies exist and a retry converges."""
        if await faults.fire_async("lifecycle.encode"):
            raise RuntimeError("injected drop at lifecycle.encode")
        for url in holders:
            self._check_leader()
            await self.master._admin_post(url, "volume/delete",
                                          {"volume_id": vid})

    # --- warm -> hot: decode a hot EC volume (the ec.decode flow) ---
    async def _unec(self, tr: Transition) -> None:
        master = self.master
        vid, collection = tr.vid, tr.collection
        if await faults.fire_async("lifecycle.unec"):
            raise RuntimeError("injected drop at lifecycle.unec")
        shards = master.topology.lookup_ec_shards(vid)
        if not shards:
            raise RuntimeError(f"no shards for volume {vid}")
        total = master.ec_total_shards_for(collection)
        holder_count: dict[str, int] = {}
        for nodes in shards.values():
            for n in nodes:
                holder_count[n.url] = holder_count.get(n.url, 0) + 1
        target = max(holder_count, key=holder_count.get)
        need = [sid for sid, nodes in sorted(shards.items())
                if target not in {n.url for n in nodes}]
        for sid in need:
            self._check_leader()
            await master._admin_post(
                target, "ec/copy",
                {"volume_id": vid, "collection": collection,
                 "shard_ids": [sid], "source": shards[sid][0].url},
                timeout=600.0)
        self._check_leader()
        await master._admin_post(target, "ec/to_volume",
                                 {"volume_id": vid,
                                  "collection": collection},
                                 timeout=900.0)
        # the decoded volume is live on the target: drop the shard files
        # everywhere (the target's were consumed by the decode)
        urls = {n.url for nodes in shards.values() for n in nodes}
        urls.add(target)
        for url in sorted(urls):
            await master._admin_post(
                url, "ec/delete_shards",
                {"volume_id": vid, "collection": collection,
                 "shard_ids": list(range(total))})

    # --- TTL expiry: whole volumes, every holder at once ---
    async def _expire(self, tr: Transition) -> None:
        master = self.master
        if await faults.fire_async("lifecycle.expire"):
            raise RuntimeError("injected drop at lifecycle.expire")
        for url in tr.holders:
            self._check_leader()
            await master._admin_post(url, "volume/delete",
                                     {"volume_id": tr.vid})
        # an expired collection that was EC-encoded loses its shards too
        shards = master.topology.lookup_ec_shards(tr.vid)
        urls = {n.url for nodes in shards.values() for n in nodes}
        for url in sorted(urls):
            await master._admin_post(
                url, "ec/delete_shards",
                {"volume_id": tr.vid, "collection": tr.collection,
                 "shard_ids": list(range(
                     master.ec_total_shards_for(tr.collection)))})

    # --- S3 bucket rules: Expiration and Transition(WARM), via the filer
    async def _filer_get(self, path: str, params: dict) -> tuple[int, dict]:
        async with self.master._maint_http().get(
                f"http://{self.cfg.filer}{path}", params=params,
                timeout=aiohttp.ClientTimeout(total=60)) as r:
            return r.status, await r.json()

    async def _filer_post(self, path: str, body: dict) -> tuple[int, dict]:
        async with self.master._maint_http().post(
                f"http://{self.cfg.filer}{path}", json=body,
                timeout=aiohttp.ClientTimeout(total=60)) as r:
            return r.status, await r.json()

    async def _s3_pass(self, now: float) -> dict:
        stats = {"expired": 0, "transitioned": 0, "scanned": 0}
        # the bucket listing pages too: a rule on bucket 1001 is
        # enforced like one on bucket 1
        start = ""
        while True:
            status, body = await self._filer_get(
                "/__meta__/list", {"dir": "/buckets", "start": start,
                                   "limit": "512"})
            if status != 200:
                return stats
            entries = body.get("entries", [])
            for bucket_entry in entries:
                name = bucket_entry["path"].rsplit("/", 1)[-1]
                if name.startswith("."):
                    continue
                raw = (bucket_entry.get("extended") or {}).get(
                    s3_rules.BUCKET_ATTR)
                if not raw:
                    continue
                rules = [r for r in s3_rules.rules_from_json(raw)
                         if r.get("status") == "Enabled"]
                if not rules:
                    continue
                with observe.span("lifecycle.s3", tags={"bucket": name}):
                    await self._apply_bucket_rules(
                        name, bucket_entry["path"], rules, now, stats)
            if len(entries) < 512:
                return stats
            start = entries[-1]["path"].rsplit("/", 1)[-1]

    async def _apply_bucket_rules(self, bucket: str, base: str,
                                  rules: list, now: float,
                                  stats: dict) -> None:

        async def walk(dir_path: str, key_prefix: str) -> None:
            start = ""
            while True:
                if stats["scanned"] >= self.cfg.scan_limit:
                    # a bounded pass: the rest ages into the next one
                    log.info("lifecycle s3 scan limit %d hit in %s",
                             self.cfg.scan_limit, bucket)
                    return
                status, body = await self._filer_get(
                    "/__meta__/list", {"dir": dir_path, "start": start,
                                       "limit": "512"})
                entries = body.get("entries", []) if status == 200 else []
                for e in entries:
                    name = e["path"].rsplit("/", 1)[-1]
                    if bool(e.get("attr", {}).get("mode", 0) & 0o40000):
                        await walk(e["path"], key_prefix + name + "/")
                        continue
                    stats["scanned"] += 1
                    await self._apply_object_rules(
                        bucket, key_prefix + name, e, rules, now, stats)
                if len(entries) < 512:
                    return
                start = entries[-1]["path"].rsplit("/", 1)[-1]

        await walk(base, "")

    async def _apply_object_rules(self, bucket: str, key: str, entry: dict,
                                  rules: list, now: float,
                                  stats: dict) -> None:
        mtime = float(entry.get("attr", {}).get("mtime", 0) or 0)
        age = now - mtime if mtime else 0.0
        for rule in rules:
            prefix = rule.get("prefix") or ""
            if prefix and not key.startswith(prefix):
                continue
            exp = rule.get("expire_days")
            if exp is not None and age >= exp * self.cfg.day_seconds:
                await self._filer_post("/__meta__/delete",
                                       {"path": entry["path"]})
                self._record("s3_expire", f"{bucket}/{key}", "ok")
                stats["expired"] += 1
                return  # the entry is gone; no further rule applies
            tdays = rule.get("transition_days")
            ext = entry.get("extended") or {}
            if (tdays is not None
                    and age >= tdays * self.cfg.day_seconds
                    and ext.get(s3_rules.STORAGE_CLASS_ATTR)
                    != s3_rules.WARM_CLASS):
                ext[s3_rules.STORAGE_CLASS_ATTR] = s3_rules.WARM_CLASS
                entry["extended"] = ext
                await self._filer_post("/__meta__/update_entry",
                                       {"entry": entry})
                # the warm tier is volume-grained: every volume holding
                # one of the object's chunks warms down whole
                for c in entry.get("chunks", []):
                    try:
                        vid = FileId.parse(c["fid"]).volume_id
                    except (KeyError, ValueError):
                        continue
                    self.warm_requested.setdefault(
                        vid, f"s3 transition {bucket}/{prefix or '*'}")
                self._record("s3_transition", f"{bucket}/{key}", "ok")
                stats["transitioned"] += 1

    # --- observability ---
    def export_gauges(self, heat_view: Optional[dict] = None) -> None:
        m = self.master.metrics
        m.gauge("lifecycle_inflight", len(self._inflight))
        m.gauge("lifecycle_warm_requested", len(self.warm_requested))
        if heat_view is None:
            heat_view = self.master.topology.heat_view()
        top = sorted(heat_view.items(),
                     key=lambda kv: kv[1].get("read_rate", 0.0),
                     reverse=True)[:self.cfg.heat_export_top]
        for vid, h in top:
            m.gauge("volume_heat_read_rate", h.get("read_rate", 0.0),
                    labels={"volume": str(vid)})
            m.gauge("volume_heat_reads", h.get("reads", 0),
                    labels={"volume": str(vid)})

    def status(self) -> dict:
        now = time.monotonic()
        return {
            "enabled": self.cfg.enabled,
            "is_leader": self.master.raft.is_leader,
            "last_pass": self.last_pass,
            "passes": self.passes,
            "pending": [{"kind": k, "volume": v,
                         "for_s": round(now - t0, 1)}
                        for (k, v), t0 in sorted(self._inflight.items(),
                                                 key=lambda kv: str(kv[0]))],
            "recent": list(self.recent),
            "warm_requested": {str(v): r
                               for v, r in self.warm_requested.items()},
            "config": {k: v for k, v in asdict(self.cfg).items()
                       if k != "force_enabled"},
        }

    def heat_status(self) -> dict:
        now = time.time()
        topology = self.master.topology
        heat = topology.heat_view(now)
        vols: dict[int, dict] = {}
        for node in topology.nodes.values():
            for vid, vi in node.volumes.items():
                rec = vols.setdefault(vid, {
                    "volume": vid, "collection": vi.collection,
                    "state": "hot", "ttl": vi.ttl, "size": vi.size,
                    "read_only": vi.read_only, "holders": []})
                rec["holders"].append(node.url)
            for vid, si in node.ec_shards.items():
                rec = vols.setdefault(vid, {
                    "volume": vid, "collection": si.collection,
                    "state": "warm", "ttl": "", "size": 0,
                    "read_only": True, "holders": []})
                if rec["state"] == "hot":
                    rec["state"] = "transitioning"
                if node.url not in rec["holders"]:
                    rec["holders"].append(node.url)
        for vid, rec in vols.items():
            h = heat.get(vid, {})
            rec.update({
                "reads": h.get("reads", 0),
                "writes": h.get("writes", 0),
                "read_rate": h.get("read_rate", 0.0),
                "idle_s": round(now - max(h.get("last_access", 0.0),
                                          h.get("first_seen", now)), 1),
            })
        return {"now": now,
                "volumes": [vols[v] for v in sorted(vols)]}
