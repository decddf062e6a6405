"""The balancer daemon: executes what balance/planner.py plans.

The port's reduced copy of seaweedfs_tpu/balance/daemon.py. It runs on
the master beside the repair and lifecycle daemons and shares their
discipline:

* the same concurrency semaphore (``master._repair_sem``) and numbered
  worker slots, so balance moves, rebuilds and warm-downs drain through
  one bounded budget;
* the same per-key exponential backoff (``master._repair_backoff``, key
  ``("balance", vid)``);
* the same pause: while an operator holds the admin lease, or a fresh
  lease waits for the daemons' jobs, no pass launches anything, and
  volumes another daemon is moving (a repair, a lifecycle transition)
  are not moved. The reference's balancer checks neither, and seals
  nothing before it copies (ROADMAP Queue 3, D8);
* two-pass confirmation, cooldown and the ping-pong veto in
  ``PlannerState``, the object clustersim replays;
* the same leadership: a pass runs on the raft leader alone, once its
  term's no-op has committed and while its lease is live
  (``master.leader_ready``; a deposed leader forgets its two-pass
  sightings), and a move re-checks leadership before each step that
  changes a volume server.

Moves are crash-safe by ordering, not by a journal: seal every holder
read-only (the copy is a snapshot with no tail: a write acknowledged
after it would be lost with the source), copy the volume to the
destination, read both sides' ``/status`` back and compare them, seal
the copy, wait until the master's own topology lists the new location
(so reads route to both sides), and only then delete the source. A
move that fails before its copy lifts the seals it set; after the copy
they stay. A crash at any point leaves the source or the destination
complete, never neither, and the next pass converges (destination
live: retire the source; incomplete: copy again).

The fault points ``master.balance.plan`` (a planning pass) and
``master.balance.move`` (each move, before its copy) kill a pass or a
move at its worst moment in tests; each move runs in a ``balance.move``
span. Left out: the overload plane's background priority.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from dataclasses import asdict
from typing import Optional

import aiohttp

from .. import faults, observe
from ..lifecycle import jittered
from . import BalanceConfig
from .planner import Move, PlannerState, node_rates, plan_moves

log = logging.getLogger("balance")


class BalancerDaemon:
    def __init__(self, master, cfg: Optional[BalanceConfig] = None):
        self.master = master
        self.cfg = cfg or BalanceConfig.from_env()
        self.state = PlannerState(self.cfg)
        # key -> monotonic start time of the in-flight move
        self._inflight: dict[tuple, float] = {}
        self.tasks: set = set()
        self.recent: deque = deque(maxlen=64)
        self.last_pass = 0.0
        self.passes = 0
        self.moves_done = 0
        self.moved_bytes = 0

    # --- loop ---
    async def run_loop(self) -> None:
        while True:
            await asyncio.sleep(jittered(self.cfg.interval))
            try:
                await self.pass_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                # the daemon must outlive any one pass
                log.warning("balance pass failed", exc_info=True)

    def stop(self) -> None:
        for task in list(self.tasks):
            task.cancel()

    def moving_vids(self) -> set:
        """Volumes with a move in flight."""
        return {vid for _, vid in self._inflight}

    # --- one planning pass ---
    async def pass_once(self) -> dict:
        master = self.master
        if not await master.leader_ready():
            # a re-elected leader confirms its moves from scratch
            self.state.reset()
            return {"skipped": "not leader"}
        if await faults.fire_async("master.balance.plan"):
            return {"skipped": "injected drop at master.balance.plan"}
        paused = master.daemons_paused()
        if paused:
            # an operator's command is moving volumes: what it shows half
            # done must be confirmed afresh once it is over
            self.state.reset()
            return {"skipped": paused}
        # prune first and plan against the same view; the planner also
        # filters on last_seen, so a dead node is invisible either way
        for ev in master.topology.prune_dead_nodes():
            master.metrics.count("dead_nodes_pruned")
            log.info("pruned dead node %s", ev["url"])
        now = time.time()
        self.last_pass = now
        self.passes += 1
        # volumes another daemon is moving stay where they are (D8)
        busy = master.daemon_moving_vids() - self.moving_vids()
        frozen = self.state.frozen(now) | busy
        # the seed is fixed: two-pass confirmation needs consecutive
        # passes to agree on (src, dst), which a rotating tie-break
        # among equally cold destinations would prevent
        plan = plan_moves(master.topology, self.cfg, now,
                          seed=0, frozen=frozenset(frozen))
        confirmed = self.state.confirm(plan, now)
        launched = []
        for mv in confirmed:
            if not self._due(mv.key):
                continue
            self._launch(mv)
            launched.append(mv.to_dict())
        master.metrics.gauge("balance_inflight", len(self._inflight))
        return {"planned": len(plan), "confirmed": len(confirmed),
                "frozen": len(frozen), "launched": launched}

    def _due(self, key: tuple) -> bool:
        if key in self._inflight:
            return False
        back = self.master._repair_backoff.get(key)
        return back is None or time.monotonic() >= back[1]

    def _launch(self, mv: Move) -> None:
        self._inflight[mv.key] = time.monotonic()
        task = asyncio.create_task(self._run_move(mv))
        self.tasks.add(task)
        task.add_done_callback(self.tasks.discard)

    async def _run_move(self, mv: Move) -> None:
        key = mv.key
        try:
            async with self.master._repair_sem:
                paused = self.master.daemons_paused()
                if paused:
                    # queued when an operator asked for the lease
                    log.info("balance move of volume %d deferred: %s",
                             mv.vid, paused)
                    return
                worker = self.master._checkout_worker()
                log.info("worker %d: balance move of volume %d %s -> %s",
                         worker, mv.vid, mv.src, mv.dst)
                try:
                    with observe.span("balance.move",
                                      tags={"vid": mv.vid, "src": mv.src,
                                            "dst": mv.dst,
                                            "worker": worker}):
                        await self._execute_move(mv)
                finally:
                    self.master._checkin_worker(worker)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            failures = self.master._repair_backoff.get(key, (0, 0.0))[0] + 1
            delay = min(self.cfg.interval * (2 ** failures), 300.0)
            self.master._repair_backoff[key] = (failures,
                                                time.monotonic() + delay)
            self._record(mv, "failed", error=str(e))
            log.warning("balance move of volume %d failed (attempt %d, "
                        "next in %.1fs): %s", mv.vid, failures, delay, e)
        else:
            self.master._repair_backoff.pop(key, None)
            self.state.record_done(mv, time.time())
            self.moves_done += 1
            self.moved_bytes += mv.bytes
            self._record(mv, "ok")
            log.info("balance move of volume %d %s -> %s done (%s)",
                     mv.vid, mv.src, mv.dst, mv.reason)
        finally:
            self._inflight.pop(key, None)

    def _record(self, mv: Move, outcome: str, error: str = "") -> None:
        self.master.metrics.count("balance_moves",
                                  labels={"outcome": outcome})
        entry = {"volume": mv.vid, "src": mv.src, "dst": mv.dst,
                 "outcome": outcome, "at": time.time(),
                 "reason": mv.reason}
        if error:
            entry["error"] = error
        self.recent.appendleft(entry)

    # --- the move itself: seal -> copy -> verify -> retire ---
    async def _volume_status(self, url: str, vid: int) -> Optional[dict]:
        """The volume's entry in ``url``'s ``/status``, None when that
        server holds no copy. A read-back, never a trusted copy
        response: nothing is destroyed on trust."""
        async with self.master._maint_http().get(
                f"http://{url}/status",
                timeout=aiohttp.ClientTimeout(total=30)) as r:
            st = await r.json()
            if r.status != 200:
                raise RuntimeError(f"{url}/status: {r.status}")
        for v in st.get("volumes", []):
            if v.get("id") == vid:
                return v
        return None

    def _check_leader(self) -> None:
        if not self.master.raft.is_leader:
            raise RuntimeError("lost leadership mid-move")

    async def _set_read_only(self, url: str, vid: int,
                             read_only: bool) -> bool:
        """Flip one holder's write gate; returns whether the holder was
        read-only before."""
        self._check_leader()
        out = await self.master._admin_post(
            url, "volume/readonly", {"volume_id": vid,
                                     "read_only": read_only})
        return bool(out.get("was_read_only"))

    async def _seal(self, mv: Move) -> list:
        """Seal every holder of the volume before the copy (D8): a copy
        is a snapshot with no tail, so a write acknowledged after it
        would live on the source alone and go with it. Each volume
        server flips the gate under the volume's lock (a write in flight
        lands first) and beats, so the master stops assigning to the
        volume at once. Returns the holders this move sealed."""
        urls = [mv.src_url] + sorted(
            n.url for n in self.master.topology.lookup(mv.vid)
            if n.url != mv.src_url)
        sealed: list = []
        try:
            for url in urls:
                if not await self._set_read_only(url, mv.vid, True):
                    sealed.append(url)
        except Exception:
            await self._unseal(mv, sealed)
            raise
        return sealed

    async def _unseal(self, mv: Move, urls: list) -> None:
        """Lift the seals a move set, when it fails before its copy."""
        for url in urls:
            try:
                await self._set_read_only(url, mv.vid, False)
            except Exception as e:
                log.warning("volume %d: lifting the seal on %s failed: "
                            "%s", mv.vid, url, e)

    async def _execute_move(self, mv: Move) -> None:
        master = self.master
        if await faults.fire_async("master.balance.move"):
            raise RuntimeError("injected drop at master.balance.move")
        sealed = await self._seal(mv)
        copied = False
        try:
            src = await self._volume_status(mv.src_url, mv.vid)
            if src is None:
                raise RuntimeError(
                    f"volume {mv.vid}: source {mv.src} no longer holds "
                    f"it; stale plan")
            dst = await self._volume_status(mv.dst_url, mv.vid)
            # resume path: an earlier attempt crashed after the copy
            # (its seals stay), so the destination already holds the
            # whole volume and only the retire is left (volume/copy
            # would answer 409 on it)
            if dst is None:
                self._check_leader()
                await master._admin_post(mv.dst_url, "volume/copy",
                                         {"volume_id": mv.vid,
                                          "collection": mv.collection,
                                          "source": mv.src_url},
                                         timeout=600.0)
                dst = await self._volume_status(mv.dst_url, mv.vid)
            if not _same_copy(src, dst):
                raise RuntimeError(
                    f"volume {mv.vid}: the copy on {mv.dst} does not "
                    f"match the sealed source ({src.get('size')} bytes, "
                    f"{src.get('file_count')} files); keeping the source")
            copied = True
            # a copy mounts writable: the seal travels with the volume
            await self._set_read_only(mv.dst_url, mv.vid, True)
            # wait until the master's own topology lists the
            # destination, so lookups route to both sides before the
            # source goes; bounded: a destination whose heartbeat never
            # lands fails the move
            pulse = master.topology.pulse_seconds
            for _ in range(20):
                if any(n.id == mv.dst
                       for n in master.topology.lookup(mv.vid)):
                    break
                await asyncio.sleep(max(pulse / 2.0, 0.05))
            else:
                raise RuntimeError(
                    f"volume {mv.vid}: destination {mv.dst} verified on "
                    f"disk but its heartbeat never registered the copy; "
                    f"keeping the source")
            self._check_leader()
            await master._admin_post(mv.src_url, "volume/delete",
                                     {"volume_id": mv.vid})
        except Exception:
            # before the copy the volume goes back to taking writes;
            # after it both sides stay sealed, so the copy stays whole
            # for the next pass's resume path
            if not copied:
                await self._unseal(mv, sealed)
            raise

    # --- heat-aware /dir/assign ---
    def assign_rank(self) -> Optional[dict]:
        """node id -> heat score for find_empty_slots' coldest-first
        placement; None when heat-aware assignment is off."""
        if not (self.cfg.enabled and self.cfg.assign_heat_aware):
            return None
        return node_rates(self.master.topology, time.time())

    # --- observability ---
    def status(self) -> dict:
        now = time.monotonic()
        return {
            "enabled": self.cfg.enabled,
            "is_leader": self.master.raft.is_leader,
            "last_pass": self.last_pass,
            "passes": self.passes,
            "moves_done": self.moves_done,
            "moved_bytes": self.moved_bytes,
            "node_rates": {nid: round(r, 4) for nid, r in sorted(
                node_rates(self.master.topology, time.time()).items())},
            "pending": [{"volume": v, "for_s": round(now - t0, 1)}
                        for (_, v), t0 in sorted(self._inflight.items(),
                                                 key=lambda kv: kv[0][1])],
            "state": self.state.to_dict(),
            "recent": list(self.recent),
            "config": {k: v for k, v in asdict(self.cfg).items()
                       if k != "force_enabled"},
        }


def _same_copy(src: dict, dst: Optional[dict]) -> bool:
    """A destination copy of the sealed source: the same byte size and
    the same live needle count."""
    return (dst is not None
            and int(dst.get("size", -1)) == int(src.get("size", -2))
            and dst.get("file_count") == src.get("file_count"))
