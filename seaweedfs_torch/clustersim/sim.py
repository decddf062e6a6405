"""ClusterSim: a scripted substrate under the port's real control plane.

The port's copy of seaweedfs_tpu/clustersim/sim.py. Real here (the
port's production code, not models): ``Topology`` (heartbeat intake,
layouts, pruning, heat merge, all on the injected virtual clock),
``plan_moves`` and ``PlannerState`` exactly as the balancer daemon runs
them, ``pick_replica_target`` (the repair daemon's placement rule), and
the ``sim.heartbeat`` fault point, which flap drills arm.

Modeled: volume servers are ``SimNode`` records (volumes, read rates,
aliveness), and the master's shared ``_repair_sem`` budget is a slot
pool that drains repairs before balance moves. A job holds a slot for a
fixed number of ticks and changes the SimNodes when it completes, so
the next heartbeats, through the real intake, show the control plane
the consequences of its own decisions: convergence, oscillation and
starvation come from the real planner, not from the model.

Every externally visible action is appended to ``events``; ``digest()``
is the sha256 of the canonical JSON event log, so one seed gives one
digest.
"""

from __future__ import annotations

import hashlib
import json
from collections import deque
from typing import Optional

from .. import faults
from ..balance import BalanceConfig, PlannerState, plan_moves
from ..balance.planner import node_rates, pick_replica_target
from ..storage.superblock import ReplicaPlacement
from ..topology.topology import Topology
from .clock import VirtualClock

MB = 1 << 20


class SimNode:
    """A modeled volume server: what the real Topology hears from it."""

    __slots__ = ("id", "url", "dc", "rack", "max_volumes", "alive",
                 "volumes", "rates", "needs_full", "stagger")

    def __init__(self, node_id: str, dc: str, rack: str,
                 max_volumes: int, stagger: int):
        self.id = node_id
        self.url = node_id
        self.dc = dc
        self.rack = rack
        self.max_volumes = max_volumes
        self.alive = True
        # vid -> volume dict, exactly the heartbeat payload shape
        self.volumes: dict[int, dict] = {}
        # vid -> steady read rate (reads/s) this node serves
        self.rates: dict[int, float] = {}
        self.needs_full = True   # next beat must be a full registration
        self.stagger = stagger   # spreads periodic full beats over ticks


class ClusterSim:
    def __init__(self, nodes: int = 1000, seed: int = 0, *,
                 dcs: int = 2, racks_per_dc: int = 5,
                 volumes_per_node: int = 4, replication: str = "010",
                 volume_bytes: int = MB,
                 cfg: Optional[BalanceConfig] = None,
                 slots: int = 16, tick_seconds: float = 1.0,
                 pulse_seconds: float = 5.0,
                 balance_every: int = 5, repair_every: int = 5,
                 refresh_every: int = 5, job_ticks: int = 3):
        self.seed = seed
        self.tick_seconds = tick_seconds
        self.balance_every = balance_every
        self.repair_every = repair_every
        self.refresh_every = refresh_every
        self.job_ticks = job_ticks
        self.slots = slots
        self.volume_bytes = volume_bytes
        self.replication = replication
        self.clock = VirtualClock()
        self.topology = Topology(volume_size_limit=30 * MB,
                                 pulse_seconds=pulse_seconds,
                                 clock=self.clock.now)
        self.cfg = cfg or BalanceConfig(
            interval=tick_seconds * balance_every, cooldown=30.0,
            max_moves=8, min_rate=0.05)
        self.state = PlannerState(self.cfg)
        self.tick_no = 0
        self.balance_passes = 0
        self.events: list = []
        # scripted events: tick -> [(op, args...)]
        self.script: dict[int, list[tuple]] = {}
        # slot pool (the shared worker budget): repair drains first
        self.repair_queue: deque = deque()
        self.balance_queue: deque = deque()
        self.running: list[dict] = []
        self._repair_seen: dict[int, int] = {}   # vid -> consecutive passes
        self._repair_inflight: set[int] = set()
        self._balance_inflight: set[int] = set()
        self._pending_dst: dict[str, int] = {}   # node -> inflight adds
        # stats the scenarios assert on
        self.completed_moves: list[tuple] = []   # (tick, vid, src, dst, b)
        self.completed_repairs: list[tuple] = []  # (tick, vid, dst)
        self.moved_bytes = 0
        self.repaired_bytes = 0
        self.balance_start_while_repair_pending = 0

        # --- deterministic layout: nodes round-robin over DCs/racks,
        # volumes placed primary + rack-spread replicas ---
        self.nodes: list[SimNode] = []
        for i in range(nodes):
            dc = f"dc{i % dcs}"
            rack = f"r{(i // dcs) % racks_per_dc}"
            self.nodes.append(SimNode(
                f"{dc}.{rack}.n{i:04d}:8080", dc, rack,
                max_volumes=volumes_per_node * 4,
                stagger=i % refresh_every))
        copies = ReplicaPlacement.parse(replication).copy_count()
        total_volumes = nodes * volumes_per_node // copies
        self.total_bytes = total_volumes * copies * volume_bytes
        vid = 0
        for v in range(total_volumes):
            vid += 1
            holders = [self.nodes[v % nodes]]
            j = (v + 1) % nodes
            while len(holders) < copies:
                cand = self.nodes[j % nodes]
                if all((cand.dc, cand.rack) != (h.dc, h.rack)
                       for h in holders) and cand not in holders:
                    holders.append(cand)
                j += 1
            for h in holders:
                h.volumes[vid] = {"id": vid, "collection": "",
                                  "size": volume_bytes,
                                  "read_only": True,
                                  "replica_placement": replication,
                                  "ttl": ""}
        self._by_id = {n.id: n for n in self.nodes}

    # --- scripting ---

    def at(self, tick: int, op: str, *args) -> None:
        self.script.setdefault(tick, []).append((op, args))

    def node(self, idx: int) -> SimNode:
        return self.nodes[idx]

    def _apply_op(self, op: str, args: tuple) -> None:
        if op == "kill":
            n = self.nodes[args[0]]
            n.alive = False
            self._log("kill", node=n.id)
        elif op == "revive":
            n = self.nodes[args[0]]
            n.alive = True
            n.needs_full = True
            self._log("revive", node=n.id)
        elif op == "rack_loss":
            dc, rack = args
            for n in self.nodes:
                if n.alive and (n.dc, n.rack) == (dc, rack):
                    n.alive = False
            self._log("rack_loss", dc=dc, rack=rack)
        elif op == "heat":
            idx, vid, rate = args
            n = self.nodes[idx]
            if rate > 0.0 and vid in n.volumes:
                n.rates[vid] = float(rate)
            else:
                n.rates.pop(vid, None)
            self._log("heat", node=n.id, vid=vid, rate=round(rate, 6))
        elif op == "fault":
            point, action, p, count, fseed = args
            faults.set_fault(point, action, p=p, count=count, seed=fseed)
            self._log("fault_armed", point=point, action=action, p=p)
        else:
            raise ValueError(f"unknown scripted op {op!r}")

    # --- event log ---

    def _log(self, kind: str, **kw) -> None:
        self.events.append({"t": self.tick_no, "e": kind, **kw})

    def digest(self) -> str:
        blob = json.dumps(self.events, sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()

    # --- one tick ---

    def tick(self) -> None:
        self.tick_no += 1
        self.clock.advance(self.tick_seconds)
        now = self.clock.now()
        for op, args in self.script.get(self.tick_no, []):
            self._apply_op(op, args)
        # heartbeats through the REAL intake, gated by sim.heartbeat.
        # Full registration when the node's volume set changed (or on
        # its staggered refresh slot); otherwise the cheap beat path a
        # real idle node takes: liveness touch + changed-heat merge.
        for n in self.nodes:
            if not n.alive:
                continue
            if faults.fire("sim.heartbeat"):
                self._log("beat_lost", node=n.id)
                continue
            heat = [{"id": vid, "reads": int(rate * self.tick_seconds),
                     "writes": 0, "last_access": now, "read_rate": rate}
                    for vid, rate in sorted(n.rates.items())]
            dn = self.topology.nodes.get(n.id)
            if (n.needs_full or dn is None
                    or self.tick_no % self.refresh_every == n.stagger):
                ev = self.topology.register_heartbeat(
                    n.id, n.url, n.url, n.dc, n.rack, n.max_volumes,
                    {"volumes": [n.volumes[v] for v in sorted(n.volumes)],
                     "ec_shards": [], "heat": heat})
                n.needs_full = False
                if ev["new_vids"] or ev["deleted_vids"]:
                    self._log("loc_delta", node=n.id,
                              added=len(ev["new_vids"]),
                              removed=len(ev["deleted_vids"]))
            else:
                dn.last_seen = now
                if heat:
                    self.topology.merge_heat(n.url, heat)
        for ev in self.topology.prune_dead_nodes():
            self._log("pruned", node=ev["url"],
                      vids=len(ev["deleted_vids"]))
        if self.tick_no % self.repair_every == 0:
            self._repair_pass(now)
        if self.tick_no % self.balance_every == 0:
            self._balance_pass(now)
        self._drive_jobs()

    def run(self, ticks: int) -> None:
        for _ in range(ticks):
            self.tick()

    # --- repair planning: two-pass deficit confirmation, the repair-
    #     daemon discipline, placing through the REAL target rule ---

    def _repair_pass(self, now: float) -> None:
        deficits: dict[int, tuple] = {}
        for (coll, repl, ttl), layout in sorted(self.topology.layouts.items()):
            need = ReplicaPlacement.parse(repl).copy_count()
            for vid, locs in sorted(layout.locations.items()):
                if len(locs) < need and locs \
                        and vid not in self._repair_inflight:
                    deficits.setdefault(vid, (repl, locs))
        fresh: dict[int, int] = {}
        for vid, (repl, locs) in sorted(deficits.items()):
            count = self._repair_seen.get(vid, 0) + 1
            if count < 2:   # a deficit must be seen on consecutive passes
                fresh[vid] = count
                continue
            target = pick_replica_target(self.topology, repl, locs,
                                         pending=self._pending_dst)
            if target is None:
                self._log("repair_unplaceable", vid=vid)
                continue
            self._repair_inflight.add(vid)
            self._pending_dst[target.id] = \
                self._pending_dst.get(target.id, 0) + 1
            self.repair_queue.append({
                "kind": "repair", "vid": vid, "src": locs[0].id,
                "dst": target.id, "bytes": self.volume_bytes})
            self._log("repair_planned", vid=vid, src=locs[0].id,
                      dst=target.id)
        self._repair_seen = fresh

    # --- balance planning: the real planner + oscillation guard ---

    def _balance_pass(self, now: float) -> None:
        self.balance_passes += 1
        frozen = frozenset(self.state.frozen(now)
                           | self._balance_inflight)
        # seed FIXED at 0, mirroring the live daemon: the two-pass
        # confirmation needs consecutive passes to agree on (src, dst)
        plan = plan_moves(self.topology, self.cfg, now,
                          seed=0, frozen=frozen)
        confirmed = self.state.confirm(plan, now)
        for mv in confirmed:
            if mv.vid in self._balance_inflight:
                continue
            self._balance_inflight.add(mv.vid)
            self.balance_queue.append({
                "kind": "balance", "vid": mv.vid, "src": mv.src,
                "dst": mv.dst, "bytes": mv.bytes, "move": mv})
        if plan:
            self._log("balance_plan", proposed=len(plan),
                      confirmed=len(confirmed))

    # --- the shared worker-slot pool: repair drains before balance ---

    def _drive_jobs(self) -> None:
        for job in list(self.running):
            job["left"] -= 1
            if job["left"] <= 0:
                self.running.remove(job)
                self._complete(job)
        free = self.slots - len(self.running)
        while free > 0 and self.repair_queue:
            job = self.repair_queue.popleft()
            job["left"] = self.job_ticks
            self.running.append(job)
            self._log("repair_start", vid=job["vid"], dst=job["dst"])
            free -= 1
        while free > 0 and self.balance_queue:
            if self.repair_queue:
                # structurally unreachable (repair drained first) —
                # counted so the storm scenario can assert it stayed 0
                self.balance_start_while_repair_pending += 1
            job = self.balance_queue.popleft()
            job["left"] = self.job_ticks
            self.running.append(job)
            self._log("move_start", vid=job["vid"], src=job["src"],
                      dst=job["dst"],
                      repair_pending=len(self.repair_queue))
            free -= 1

    def _find(self, node_id: str) -> Optional[SimNode]:
        return self._by_id.get(node_id)

    def _complete(self, job: dict) -> None:
        vid = job["vid"]
        src = self._find(job["src"])
        dst = self._find(job["dst"])
        if job["kind"] == "repair":
            self._repair_inflight.discard(vid)
            self._pending_dst[job["dst"]] = max(
                self._pending_dst.get(job["dst"], 1) - 1, 0)
            if dst is None or not dst.alive \
                    or len(dst.volumes) >= dst.max_volumes:
                self._log("repair_failed", vid=vid, dst=job["dst"])
                return
            donor = src if src is not None and vid in src.volumes else None
            if donor is None:
                for n in self.nodes:
                    if n.alive and vid in n.volumes:
                        donor = n
                        break
            if donor is None:
                self._log("repair_failed", vid=vid, dst=job["dst"])
                return
            dst.volumes[vid] = dict(donor.volumes[vid])
            dst.needs_full = True
            self.completed_repairs.append((self.tick_no, vid, dst.id))
            self.repaired_bytes += job["bytes"]
            self._log("repair_done", vid=vid, dst=dst.id)
        else:
            self._balance_inflight.discard(vid)
            if (src is None or dst is None or not src.alive
                    or not dst.alive or vid not in src.volumes
                    or len(dst.volumes) >= dst.max_volumes):
                self._log("move_failed", vid=vid, src=job["src"],
                          dst=job["dst"])
                return
            # the move: volume AND its heat follow to the destination —
            # the next heartbeats (real intake) show the planner the
            # consequence of its own decision
            dst.volumes[vid] = src.volumes.pop(vid)
            rate = src.rates.pop(vid, 0.0)
            if rate > 0.0:
                dst.rates[vid] = rate
            src.needs_full = dst.needs_full = True
            self.state.record_done(job["move"], self.clock.now())
            self.completed_moves.append(
                (self.tick_no, vid, src.id, dst.id, job["bytes"]))
            self.moved_bytes += job["bytes"]
            self._log("move_done", vid=vid, src=src.id, dst=dst.id)

    # --- inspection helpers the scenarios assert with ---

    def max_node_rate(self) -> float:
        rates = node_rates(self.topology, self.clock.now())
        return max(rates.values()) if rates else 0.0

    def final_plan(self) -> list:
        """A fixpoint probe: what would the planner still move now?"""
        return plan_moves(self.topology, self.cfg, self.clock.now(),
                          seed=0, frozen=frozenset())

    def deficit_count(self) -> int:
        out = 0
        for (_, repl, _), layout in self.topology.layouts.items():
            need = ReplicaPlacement.parse(repl).copy_count()
            for vid, locs in layout.locations.items():
                if len(locs) < need:
                    out += 1
        return out
