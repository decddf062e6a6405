"""Master server: assignment, lookup, topology, growth, vacuum, the EC
registry, and the raft plane of an HA group.

The port's reduced copy of seaweedfs_tpu/server/master.py (upstream
weed/server/master_server.go:113-129, master_server_handlers.go,
weed/server/raft_server.go, weed/topology/topology_vacuum.go), an aiohttp
application with the reference's wire:

  GET  /dir/assign?count&collection&replication&ttl&dataCenter
  GET  /dir/lookup?volumeId=|fileId=&collection=   (every replica)
  GET  /dir/status         (topology, the EC geometry policy, the
                            metadata log's status, the filer ring)
  GET  /dir/ring           (the filer ring's membership, DirectoryRing's
                            wire form)
  POST /dir/ring/join, /dir/ring/leave   ({"peer": host:port}, through
                            raft)
  GET  /vol/grow?count&collection&replication&ttl&dataCenter
  GET  /vol/vacuum?garbageThreshold=
  GET  /vol/list
  GET  /col/lookup/ec?volumeId=
  POST /heartbeat          (volume servers report in, JSON Store payload,
                            with the volumes' access-heat deltas)
  POST /ec/scrub_report    (a volume server's scrubber: rotten shards)
  GET  /vol/heat?volumeId=, POST /vol/heat/report
  GET  /lifecycle/status, POST /lifecycle/run
  GET  /balance/status, POST /balance/run
  GET  /geo/status, POST /geo/run
  POST /cluster/lock, /cluster/unlock   (the admin lease)
  GET  /cluster/status     (is_leader, leader, peers, raft_term)
  GET  /cluster/watch      (ndjson: a location snapshot, then deltas)
  POST /cluster/raft/vote, /cluster/raft/append   (raft, peers only)
  GET  /healthz, /metrics

Masters form a raft group (``peers``: every master's host:port, at most
5 as upstream's ``weed master -peers``; cluster/raft.py), each with its
state in ``raft_state_dir`` (``-mdir``). A master alone elects itself at
once. Followers answer ``/healthz``, ``/metrics``, ``/cluster/status`` and
raft themselves and proxy every other request to the leader (503 "no
leader elected" while there is none). The replicated state is the
metadata log (metaring/masterlog.py): each ``/dir/assign`` batch is a log
entry whose apply mints the keys, growth logs ``max_volume_id`` and the
volume's registry row before it allocates, a collection's first assign
stamps its EC geometry, and a heartbeat key above the counter is logged
as a floor. A leader killed mid-assign therefore never lets its successor
re-issue or skip a key. The topology is rebuilt on the leader from the
heartbeats, which the volume servers send to the leader the replies name.

Background tasks on its loop, each acting only on the leader, once it
has led for ``settle_seconds()`` (in a group: three pulses, and at least
one admin lease period, so the volume servers have beaten to it and a
lease held at its predecessor has been renewed here), after its first
no-op of the term has committed, and while a majority answered it within
an election timeout (``RaftNode.lease_valid``):

- the maintenance daemon, every ``maintenance_interval_seconds``
  (default: the pulse; 0 disables it): it prunes nodes whose heartbeats
  stopped (pulse x 5), so a stopped volume server leaves the lookups,
  then, while ``repair_enabled`` (the default), plans repairs: an EC
  volume short of live shards (scrub-flagged copies do not count) is
  rebuilt as the shell's ``ec.rebuild`` would, and a volume short of
  copies gains one where its placement holds. A deficit must be seen on
  two consecutive passes; failures back off ``min(interval * 2^n,
  300)`` s; at most ``repair_concurrency`` repairs run at once (the
  argument, else ``WEED_EC_ENCODE_WORKERS``, else 2); a repair re-checks
  leadership between its steps;
- the cluster-exclusive admin lock (LeaseAdminToken,
  weed/server/master_grpc_server_admin.go:21-138): a lease of
  ``admin_lease_seconds`` (10 s) that the shell holds, renewed, while a
  command moves volumes. While it is held, no daemon launches anything:
  a command's half-done states (an encode mid-spread, a decode dropping
  shards) are not deficits. A fresh lease waits, up to
  ``admin_lease_wait_seconds`` (30 s), for the daemons' jobs in flight
  (repairs, lifecycle transitions, balance moves) to finish, so a shell
  command never acts on a volume a daemon is moving; while it waits the
  daemons start nothing (a job queued for a slot gives way); while jobs
  still run past that bound it is refused as a lease another client
  holds (the reference grants it at once, ROADMAP Queue 3, F5). The lease
  lives in the leader's memory, as upstream's: a new leader adopts it at
  the holder's next renewal, which presents its token, and starts no
  daemon job before that renewal can have come (ROADMAP Queue 3, D14).
  Direct ``/admin/*`` calls stay unguarded, as in the reference (D6);
- the lifecycle daemon (lifecycle/daemon.py), only when a rule is
  configured (``WEED_LIFECYCLE_*``): it warms idle full volumes down,
  decodes hot EC volumes and expires TTL'd collections, sharing the
  repairs' semaphore and backoff;
- the geo daemon (geo/daemon.py), only when a source filer is
  configured (``geo_config``, else ``WEED_GEO_FILER``): it runs one
  cross-cluster replication job per bucket whose PutBucketReplication
  rule is enabled, on the leader only, and stops them at shutdown;
- the balancer (balance/daemon.py), on unless
  ``WEED_BALANCE_ENABLED=0``: every ``WEED_BALANCE_INTERVAL`` it moves
  sealed volumes off nodes whose read rate is hot, with the repairs'
  semaphore and backoff; while it is on, ``/dir/assign`` grows new
  volumes on the coldest nodes first;
- the vacuum, every ``vacuum_interval_seconds`` (900 s, upstream's 15
  minutes), of every volume whose garbage is at least
  ``garbage_threshold`` (0.3, upstream's ``-garbageThreshold``) on all
  its replicas. Only the leader vacuums, as upstream; the reference
  vacuums from every master, a deposed one's stale topology included
  (ROADMAP Queue 3, D13).

Every call of the master to a volume server or a peer is an awaited
aiohttp client call, so masters and volume servers share a loop safely.

The filer ring's membership (metaring/ring.py) is replicated state
too: ``/dir/ring/join`` and ``/dir/ring/leave`` propose ``ring_add`` /
``ring_remove`` entries (followers proxy them to the leader like every
other request), every master applies them in log order, and snapshots
carry the ring's wire form under ``ring`` (the reference's snapshots
restore here and the port's there). Its starting membership is
``ring_config`` (else ``WEED_FILER_RING_*``).

The watch stream (KeepConnected's location half, upstream
weed/server/master_grpc_server.go:178-233): ``GET /cluster/watch`` sends
a snapshot of every volume's holders (normal and EC) and the ring, then
one ``update`` line ({url, new_vids, deleted_vids}) per heartbeat or
prune that changed a node's set and one ``ring`` line per membership
change. A subscriber that falls ``watch_queue_depth`` lines behind is
dropped with a ``resync`` line and redials for a snapshot (the
reference drops an overflowing ring line instead). Followers answer it
with a 307 to the leader. The filer's vid cache and its ring follow it.

The sequencer: by default the metadata log's (``LogSequencer``). A
``sequencer=`` that is not ``replicated``, such as a ``KvSequencer`` on
an external KV (upstream's etcd sequencer, for masters without raft),
mints the keys itself; the master keeps the reference's key ceiling in
the raft log beside it (``max_file_key`` entries, ``_key_bound``),
raises the sequencer to that ceiling once a term (``set_max``) and to
every heartbeat's ``max_file_key``. A ``blocking`` sequencer's calls go
to the executor, never on the loop.

With ``grpc_port`` the master also serves the Master gRPC service
(server/master_grpc.py; the CLI's ``-grpc_port``, HTTP port + 10000 by
default): the heartbeat stream through ``apply_heartbeat``,
KeepConnected off the watch stream's subscriber queues with the leader
hint, assign, lookup, the admin lease and listings.

Left out, each with its later home (ROADMAP Queue 1 A): guard/JWT and
gRPC over TLS, the overload plane's priorities and the fastpath
listener (3), the HTTP ``/col/delete`` (4, with the shell's rest).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from typing import Optional

import aiohttp
from aiohttp import web

from .. import observe, overload
from ..balance import BalanceConfig
from ..balance.daemon import BalancerDaemon
from ..balance.planner import pick_replica_target
from ..cluster.raft import RaftNode, _endpoint_ips
from ..ec.geometry import GeometryPolicy
from ..geo import GeoConfig
from ..geo.daemon import GeoDaemon
from ..lifecycle.daemon import LifecycleDaemon
from ..lifecycle.policy import LifecycleConfig
from ..metaring import DirectoryRing, MasterMetaLog, RingConfig
from ..storage.file_id import FileId, new_cookie
from ..storage.superblock import ReplicaPlacement
from ..topology.sequence import LogSequencer
from ..topology.topology import Topology
from ..utils import metrics as metrics_mod
from . import http

log = logging.getLogger("master")

# ceiling on /dir/assign?count=N, as in the reference
MAX_ASSIGN_COUNT = 10000
# the largest request body
MAX_BODY = 64 * 1024 * 1024

# the routes every master answers itself; a follower proxies every other
# request to the leader (proxyToLeader, weed/server/master_server.go:156)
# (/cluster/watch streams: a follower answers it with a 307 to the leader
# rather than buffer the stream through its proxy)
_LOCAL_PATHS = ("/healthz", "/metrics", "/cluster/status", "/cluster/watch",
                "/cluster/raft/vote", "/cluster/raft/append")


def _error(msg: str, status: int) -> web.Response:
    return web.json_response({"error": msg}, status=status)


class MasterServer:
    def __init__(self, volume_size_limit_mb: int = 30 * 1024,
                 default_replication: str = "000",
                 pulse_seconds: float = 5.0,
                 garbage_threshold: float = 0.3,
                 vacuum_interval_seconds: float = 900.0,
                 url: str = "",
                 maintenance_interval_seconds: Optional[float] = None,
                 repair_concurrency: Optional[int] = None,
                 repair_enabled: bool = True,
                 lifecycle_config: Optional[LifecycleConfig] = None,
                 balance_config: Optional[BalanceConfig] = None,
                 geo_config: Optional[GeoConfig] = None,
                 peers: Optional[list[str]] = None,
                 raft_state_dir: Optional[str] = None,
                 election_timeout: tuple[float, float] = (0.3, 0.6),
                 raft_heartbeat: float = 0.1,
                 ring_config: Optional[RingConfig] = None,
                 sequencer=None,
                 grpc_port: int = 0):
        # the Master gRPC service's port (0: none; the CLI's default is
        # the HTTP port + 10000)
        self.grpc_port = grpc_port
        self._grpc_server = None
        self.topology = Topology(
            volume_size_limit=volume_size_limit_mb * 1024 * 1024,
            pulse_seconds=pulse_seconds)
        # the replicated metadata log: assign batches, the volume
        # registry and the geometry stamps ride raft, so a new leader
        # replays to the exact assignment state; the default sequencer
        # is its read-only face (minting is an assign_batch entry)
        self.metalog = MasterMetaLog()
        self.sequencer = sequencer or LogSequencer(self.metalog)
        self._replicated = getattr(self.sequencer, "replicated", False)
        # a sequencer of its own: the raft-committed key ceiling, raised
        # one step of keys a round, and the term it was last synced in
        self._key_bound = 0
        self._key_bound_step = 10000
        self._seq_synced_term = -1
        # one seq_floor proposal at a time
        self._floor_inflight = False
        # the filer ring's membership: served at /dir/ring, changed
        # through raft, pushed to the filers over /cluster/watch
        rc = ring_config or RingConfig.from_env()
        self.ring = DirectoryRing(peers=rc.peers, vnodes=rc.vnodes,
                                  replicas=rc.replicas)
        self.default_replication = default_replication
        self.garbage_threshold = garbage_threshold
        self.vacuum_interval_seconds = vacuum_interval_seconds
        self.url = url
        self.raft = RaftNode(url or "self", peers or [], self._raft_apply,
                             election_timeout=election_timeout,
                             heartbeat_interval=raft_heartbeat,
                             state_dir=raft_state_dir,
                             capture_fn=self._raft_capture,
                             restore_fn=self._raft_restore)
        # raft's RPCs are accepted from the configured peers alone
        self._peer_strings = list(peers or [])
        self._peer_ips = self._resolve_peer_ips(self._peer_strings)
        self._peer_resolve_ts = 0.0
        self._proxy_session: Optional[aiohttp.ClientSession] = None
        # a bad WEED_EC_GEOMETRY kills the master at startup
        self.ec_policy = GeometryPolicy.from_env()
        # the maintenance daemon's period (prune + repair planner;
        # default: the pulse; 0 disables the daemon)
        self.maintenance_interval_seconds = (
            maintenance_interval_seconds
            if maintenance_interval_seconds is not None
            else max(pulse_seconds, 0.05))
        # WEED_EC_ENCODE_WORKERS is a default, never an override of an
        # explicit argument (cli -repair_concurrency, tests)
        if repair_concurrency is None:
            try:
                env_workers = int(
                    os.environ.get("WEED_EC_ENCODE_WORKERS", ""))
            except ValueError:
                env_workers = 0
            repair_concurrency = env_workers if env_workers > 0 else 2
        self.repair_concurrency = max(1, repair_concurrency)
        # pruning always runs with the daemon; the repair planner can be
        # paused (planned maintenance, drives of the manual ec.rebuild)
        self.repair_enabled = repair_enabled
        self.metrics = metrics_mod.Registry("master")
        # the topology is touched on the loop's thread only; growth and
        # vacuum passes await volume servers and are each serialized
        self._grow_lock: Optional[asyncio.Lock] = None
        self._vacuum_lock: Optional[asyncio.Lock] = None
        self._tasks: list[asyncio.Task] = []
        self._maint_session: Optional[aiohttp.ClientSession] = None
        # one budget for repairs and lifecycle transitions alike
        self._repair_sem = asyncio.Semaphore(self.repair_concurrency)
        # numbered worker slots, checked out under the semaphore, for
        # the logs and the repair_workers_busy gauge
        self._repair_worker_free = list(range(self.repair_concurrency))
        self._repairs_inflight: set = set()     # (kind, vid) keys
        self._repair_tasks: set = set()
        # per-key failure backoff: key -> (failures, next attempt, mono)
        self._repair_backoff: dict = {}
        # deficits seen on consecutive passes (two before a repair)
        self._ec_deficit_seen: dict[int, int] = {}
        self._replica_deficit_seen: dict[int, int] = {}
        # scrub-reported bad shards: vid -> holder url -> shard ids
        self._scrub_bad: dict[int, dict[str, set]] = {}
        # name -> (token, holder, expiry unix s): the admin leases
        self._admin_locks: dict[str, tuple[int, str, float]] = {}
        self.admin_lease_seconds = 10.0
        # how long a fresh lease waits for the daemons' jobs in flight,
        # and how many fresh leases wait now (the daemons launch nothing
        # meanwhile, as under a held lease)
        self.admin_lease_wait_seconds = 30.0
        self._lease_waiters = 0
        # the lifecycle daemon runs only when a rule can fire
        self.lifecycle = LifecycleDaemon(
            self, lifecycle_config or LifecycleConfig.from_env())
        # the geo daemon runs only when a source filer is configured
        self.geo = GeoDaemon(self, geo_config or GeoConfig.from_env())
        # the balancer moves sealed volumes off heat-hot nodes; its
        # planner's node rates also make /dir/assign heat-aware
        self.balancer = BalancerDaemon(
            self, balance_config or BalanceConfig.from_env())
        # the watch stream's subscriber queues, each bounded
        self.watch_queue_depth = 1024
        self._watchers: set = set()
        self.app = self._build_app()

    # --- the replicated state machine ---
    _METALOG_CMDS = ("assign_batch", "seq_floor", "volume_create",
                     "volume_retire", "geometry_stamp")

    def _raft_apply(self, cmd: dict):
        """Apply one committed entry: the volume-id counter (upstream's
        MaxVolumeIdCommand, weed/topology/cluster_commands.go:8-31), the
        metadata log's commands and the filer ring's membership; returns
        an assign batch's first key. A reference log's key ceiling
        (``max_file_key``, from before its metadata log) folds in as a
        floor."""
        if "max_volume_id" in cmd:
            self.topology.max_volume_id = max(self.topology.max_volume_id,
                                              cmd["max_volume_id"])
        if cmd.get("max_file_key"):
            self._key_bound = max(self._key_bound, cmd["max_file_key"])
            self.metalog.apply({"seq_floor": cmd["max_file_key"]})
        result = None
        if any(k in cmd for k in self._METALOG_CMDS):
            result = self.metalog.apply(cmd)
        if "ring_add" in cmd and self.ring.add_peer(cmd["ring_add"]):
            self._broadcast_ring()
        if "ring_remove" in cmd and \
                self.ring.remove_peer(cmd["ring_remove"]):
            self._broadcast_ring()
        return result

    def _raft_capture(self) -> dict:
        """The applied state, for log compaction."""
        return {"max_volume_id": self.topology.max_volume_id,
                "max_file_key": self._key_bound,
                "metalog": self.metalog.capture(),
                "ring": self.ring.to_dict()}

    def _raft_restore(self, state: dict) -> None:
        """Reinstate a snapshot, the reference's too; a ring newer than
        this master's replaces it."""
        self.topology.max_volume_id = max(self.topology.max_volume_id,
                                          state.get("max_volume_id", 0))
        if state.get("metalog"):
            self.metalog.restore(state["metalog"])
        if state.get("max_file_key"):
            self._key_bound = max(self._key_bound, state["max_file_key"])
            self.metalog.apply({"seq_floor": state["max_file_key"]})
        ring = state.get("ring")
        if ring and ring.get("version", 0) > self.ring.version:
            self.ring = DirectoryRing.from_dict(ring)
            self._broadcast_ring()

    def _build_app(self) -> web.Application:
        @web.middleware
        async def leader_proxy_mw(request: web.Request, handler):
            # followers proxy to the leader (proxyToLeader,
            # weed/server/master_server.go:156-180)
            if self.raft.is_leader or request.path in _LOCAL_PATHS:
                return await handler(request)
            leader = self.raft.leader_id
            if not leader or leader == self.raft.id:
                return _error("no leader elected", 503)
            return await self._proxy_to(leader, request)

        app = web.Application(client_max_size=MAX_BODY,
                              middlewares=[http.errors_as_json,
                                           leader_proxy_mw])
        app.router.add_get("/dir/assign", self.dir_assign)
        app.router.add_get("/dir/lookup", self.dir_lookup)
        app.router.add_get("/dir/status", self.dir_status)
        app.router.add_get("/dir/ring", self.dir_ring)
        app.router.add_post("/dir/ring/join", self.ring_join)
        app.router.add_post("/dir/ring/leave", self.ring_leave)
        app.router.add_get("/vol/grow", self.vol_grow)
        app.router.add_get("/vol/vacuum", self.vol_vacuum)
        app.router.add_get("/vol/list", self.vol_list)
        app.router.add_get("/col/lookup/ec", self.ec_lookup)
        app.router.add_post("/heartbeat", self.heartbeat)
        app.router.add_post("/ec/scrub_report", self.ec_scrub_report)
        app.router.add_get("/vol/heat", self.vol_heat)
        app.router.add_post("/vol/heat/report", self.vol_heat_report)
        app.router.add_get("/lifecycle/status", self.lifecycle_status)
        app.router.add_post("/lifecycle/run", self.lifecycle_run)
        app.router.add_get("/balance/status", self.balance_status)
        app.router.add_post("/balance/run", self.balance_run)
        app.router.add_get("/geo/status", self.geo_status)
        app.router.add_post("/geo/run", self.geo_run)
        app.router.add_post("/cluster/lock", self.cluster_lock)
        app.router.add_post("/cluster/unlock", self.cluster_unlock)
        app.router.add_get("/cluster/status", self.cluster_status)
        app.router.add_get("/cluster/watch", self.cluster_watch)
        app.router.add_post("/cluster/raft/vote", self.raft_vote)
        app.router.add_post("/cluster/raft/append", self.raft_append)
        app.router.add_get("/metrics", self.metrics_handler)
        app.router.add_get("/healthz", self.healthz)
        app.on_startup.append(self._on_startup)
        # raft stops first: a leader whose listener is gone must not go
        # on heartbeating its peers
        app.on_shutdown.append(self._on_shutdown)
        app.on_cleanup.append(self._on_cleanup)
        return app

    async def _on_startup(self, app) -> None:
        self._grow_lock = asyncio.Lock()
        self._vacuum_lock = asyncio.Lock()
        self._tasks = []
        await self.raft.start()
        if self.maintenance_interval_seconds > 0:
            self._tasks.append(
                asyncio.create_task(self._maintenance_loop()))
        if self.vacuum_interval_seconds > 0:
            self._tasks.append(asyncio.create_task(self._vacuum_loop()))
        if self.lifecycle.cfg.enabled:
            self._tasks.append(
                asyncio.create_task(self.lifecycle.run_loop()))
        if self.balancer.cfg.enabled:
            self._tasks.append(
                asyncio.create_task(self.balancer.run_loop()))
        if self.geo.cfg.enabled:
            self._tasks.append(asyncio.create_task(self.geo.run_loop()))
        if self.grpc_port:
            from .master_grpc import serve_master_grpc
            host = self.url.rsplit(":", 1)[0] or "127.0.0.1"
            self._grpc_server = await serve_master_grpc(self, host,
                                                        self.grpc_port)

    async def _on_cleanup(self, app) -> None:
        if self._grpc_server is not None:
            await self._grpc_server.stop(grace=0.5)
            self._grpc_server = None
        tasks = (self._tasks + list(self._repair_tasks)
                 + list(self.lifecycle.tasks) + list(self.balancer.tasks))
        for task in tasks:
            task.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        self._tasks = []
        await self.geo.aclose()
        for attr in ("_maint_session", "_proxy_session"):
            session = getattr(self, attr)
            if session is not None:
                await session.close()
                setattr(self, attr, None)
        if not self.raft._stopped:
            await self.raft.stop()
        close = getattr(self.sequencer, "close", None)
        if close is not None:
            close()

    async def _on_shutdown(self, app) -> None:
        await self.raft.stop()
        # end the watch streams: their subscribers redial another master
        for q in list(self._watchers):
            self._push(q, None)

    async def leader_ready(self) -> bool:
        """The gate of every leader-only pass: this master leads, has led
        for ``settle_seconds()``, its term's no-op has committed (every
        earlier entry is applied) and its lease is live, so a leader cut
        off from the majority stops acting on its stale topology."""
        return (self.raft.is_leader
                and time.monotonic() - self.raft.leader_since
                >= self.settle_seconds()
                and await self.raft.ensure_ready()
                and self.raft.lease_valid())

    def settle_seconds(self) -> float:
        """How long a newly elected master of a group waits before its
        daemons act: its topology fills from the volume servers' next
        beats (three pulses), and an admin lease its predecessor held is
        renewed here, and adopted, within one lease period (D14), so no
        daemon job starts under an operator's command. A master alone
        waits for nothing."""
        if not self.raft.peers:
            return 0.0
        return max(3 * self.topology.pulse_seconds,
                   self.admin_lease_seconds)

    def _awaiting_heartbeats(self) -> bool:
        """Whether this master has led for less than three pulses: the
        volume servers of a failover may not have beaten to it yet."""
        return (len(self.raft.peers) > 0 and time.monotonic()
                - self.raft.leader_since < 3 * self.topology.pulse_seconds)

    def _unheard_volumes(self, collection: str, replication: str,
                         ttl: str) -> list[int]:
        """Volumes of this layout in the replicated registry that no
        volume server has reported to this master."""
        rp = str(ReplicaPlacement.parse(replication))
        return [vid for vid, rec in self.metalog.volumes.items()
                if rec.get("collection", "") == collection
                and rec.get("ttl", "") == ttl
                and str(ReplicaPlacement.parse(
                    rec.get("replication") or "000")) == rp
                and not self.topology.lookup(vid)
                and not self.topology.lookup_ec_shards(vid)]

    # --- the raft plane's plumbing ---
    @staticmethod
    def _resolve_peer_ips(peers) -> set:
        """Every configured peer's host, literal and resolved: a
        request's remote is an address, and peers may be named."""
        ips = set()
        for p in peers:
            ips |= _endpoint_ips(p)[0]
        return ips

    async def _refresh_peer_ips(self, remote: str) -> bool:
        """Resolve the peers again (a rescheduled peer may have a new
        address), at most every 2 s and off the loop; whether `remote`
        is a peer now. Merged, never replaced: a resolver's blip must not
        evict a known peer."""
        if not self._peer_strings:
            return False
        now = time.monotonic()
        if now - self._peer_resolve_ts < 2.0:
            return False
        self._peer_resolve_ts = now
        resolved = await asyncio.get_running_loop().run_in_executor(
            None, self._resolve_peer_ips, self._peer_strings)
        self._peer_ips |= resolved
        return remote in self._peer_ips

    async def _raft_peer_check(self, request: web.Request):
        """Raft's RPCs come from configured peers only (a master alone
        refuses them all): anyone else could depose a leader or inject
        entries."""
        remote = request.remote or ""
        if remote not in self._peer_ips and \
                not await self._refresh_peer_ips(remote):
            return _error("not a raft peer", 403)
        return None

    async def raft_vote(self, request: web.Request) -> web.Response:
        denied = await self._raft_peer_check(request)
        if denied is not None:
            return denied
        return web.json_response(
            await self.raft.handle_vote(await request.json()))

    async def raft_append(self, request: web.Request) -> web.Response:
        denied = await self._raft_peer_check(request)
        if denied is not None:
            return denied
        return web.json_response(
            await self.raft.handle_append(await request.json()))

    async def _proxy_to(self, leader: str,
                        request: web.Request) -> web.Response:
        """Forward a request to the leader and return its answer; 503
        when the leader cannot be reached, so clients rotate."""
        body = await request.read()
        if self._proxy_session is None or self._proxy_session.closed:
            # one keep-alive pool for the follower -> leader hop; a long
            # timeout: a proxied admin lease may wait 30 s for daemons
            self._proxy_session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=600))
        try:
            async with self._proxy_session.request(
                    request.method, f"http://{leader}{request.path_qs}",
                    data=body or None,
                    headers={k: v for k, v in request.headers.items()
                             if k.lower() not in ("host",
                                                  "content-length")}) as r:
                payload = await r.read()
                return web.Response(
                    body=payload, status=r.status,
                    content_type=r.content_type or "application/json")
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as e:
            return _error(f"leader proxy to {leader} failed: {e}", 503)

    # --- the maintenance daemon: prune, then plan repairs (the
    #     reference's maintenance loop, weed/server/master_server.go:
    #     187-257) ---
    async def _maintenance_loop(self) -> None:
        while True:
            await asyncio.sleep(self.maintenance_interval_seconds)
            try:
                await self._maintenance_pass()
            except asyncio.CancelledError:
                raise
            except Exception:
                # the daemon must outlive any one pass
                log.warning("maintenance pass failed", exc_info=True)

    async def _maintenance_pass(self) -> None:
        """Prune, then plan repairs: on the leader alone. A follower's
        topology is empty or stale, and two masters must never repair one
        volume."""
        if not await self.leader_ready():
            # a re-elected leader confirms its deficits from scratch
            self._ec_deficit_seen.clear()
            self._replica_deficit_seen.clear()
            return
        for ev in self.topology.prune_dead_nodes():
            self.metrics.count("dead_nodes_pruned")
            log.info("pruned dead node %s", ev["url"])
            self._broadcast_location(ev)
        if not self.repair_enabled:
            return
        if self.daemons_paused():
            # an operator's command is moving volumes: the deficits its
            # steps show must be confirmed afresh once it is done
            self._ec_deficit_seen.clear()
            self._replica_deficit_seen.clear()
            return
        await self._repair_pass()

    def _live_ec_shards(self, vid: int) -> set:
        """Shard ids with at least one holder whose copy is not
        scrub-flagged as rotten."""
        bad = self._scrub_bad.get(vid, {})
        live = set()
        for sid, nodes in self.topology.lookup_ec_shards(vid).items():
            if any(sid not in bad.get(n.url, ()) for n in nodes):
                live.add(sid)
        return live

    def _repair_due(self, key, seen: dict, vid: int) -> bool:
        """Deficit gating: two consecutive sightings (heartbeat lag or an
        encode mid-spread must not trigger), the in-flight guard, and
        the per-key backoff after failures."""
        if key in self._repairs_inflight:
            return False
        count = seen.get(vid, 0) + 1
        seen[vid] = count
        if count < 2:
            return False
        back = self._repair_backoff.get(key)
        if back is not None and time.monotonic() < back[1]:
            return False
        # launching: the passes right after a repair (which may still see
        # the pre-heartbeat view) must confirm a deficit from scratch
        seen.pop(vid, None)
        return True

    def ec_total_shards_for(self, collection: str = "") -> int:
        """A collection's full shard count, from the policy geometry
        (WEED_EC_GEOMETRY="20+4" must steer the daemons too, or they
        would count 14 of 24 shards as complete)."""
        return self.ec_policy.for_collection(collection).total_shards

    async def _repair_pass(self) -> None:
        # a volume the lifecycle daemon is moving (a warm-down mid-spread,
        # an un-EC dropping its shards, an expiry) looks short of shards
        # or copies for as long as the move takes: it is the transition's
        # to finish, not the repairs' (the reference repairs it meanwhile,
        # ROADMAP Queue 3, F3); the same for a balance move
        moving = (self.lifecycle.moving_vids()
                  | self.balancer.moving_vids())
        # EC volumes below their full shard count
        ec_vids: dict[int, str] = {}
        for node in self.topology.nodes.values():
            for vid, info in node.ec_shards.items():
                ec_vids.setdefault(vid, info.collection)
        for vid in list(self._ec_deficit_seen):
            if vid not in ec_vids:
                self._ec_deficit_seen.pop(vid, None)
        for vid, collection in ec_vids.items():
            if vid in moving or len(self._live_ec_shards(vid)) >= \
                    self.ec_total_shards_for(collection):
                self._ec_deficit_seen.pop(vid, None)
                self._repair_backoff.pop(("ec", vid), None)
                continue
            if self._repair_due(("ec", vid), self._ec_deficit_seen, vid):
                self._launch_repair(("ec", vid), self._repair_ec, vid,
                                    collection)
        # volumes short of copies
        seen_vids = set()
        for key, layout in list(self.topology.layouts.items()):
            need = ReplicaPlacement.parse(layout.replication).copy_count()
            if need <= 1:
                continue
            for vid, nodes in list(layout.locations.items()):
                seen_vids.add(vid)
                if not nodes or len(nodes) >= need or vid in moving:
                    self._replica_deficit_seen.pop(vid, None)
                    self._repair_backoff.pop(("replica", vid), None)
                    continue
                if self._repair_due(("replica", vid),
                                    self._replica_deficit_seen, vid):
                    self._launch_repair(
                        ("replica", vid), self._repair_replica, vid,
                        key[0], layout.replication, list(nodes))
        for vid in list(self._replica_deficit_seen):
            if vid not in seen_vids:
                self._replica_deficit_seen.pop(vid, None)

    def daemon_jobs(self) -> set:
        """(kind, vid) of every daemon job in flight: repairs, lifecycle
        transitions and balance moves, queued or running."""
        return (set(self._repairs_inflight) | set(self.lifecycle._inflight)
                | set(self.balancer._inflight))

    def daemon_moving_vids(self) -> set:
        """Volumes some daemon job is moving."""
        return {vid for _, vid in self.daemon_jobs()}

    def _launch_repair(self, key, fn, *args) -> None:
        self._repairs_inflight.add(key)
        task = asyncio.create_task(self._run_repair(key, fn, *args))
        self._repair_tasks.add(task)
        task.add_done_callback(self._repair_tasks.discard)

    async def _run_repair(self, key, fn, *args) -> None:
        """One repair under the shared semaphore: waiting for a slot (a
        warm-down window may hold both) is not a failure; a failure backs
        the key off for min(interval * 2^n, 300) s."""
        kind, vid = key
        try:
            async with self._repair_sem:
                paused = self.daemons_paused()
                if paused:
                    # queued when an operator asked for the lease: the
                    # next passes see the deficit again afterwards
                    log.info("%s repair of volume %s deferred: %s", kind,
                             vid, paused)
                    return
                worker = self._checkout_worker()
                log.info("repair worker %d: %s repair of volume %s",
                         worker, kind, vid)
                try:
                    self.metrics.count("repairs_started",
                                       labels={"kind": kind})
                    with observe.span(f"master.repair.{kind}",
                                      tags={"vid": vid, "worker": worker}):
                        ok = await fn(*args)
                finally:
                    self._checkin_worker(worker)
            if not ok:
                raise RuntimeError(f"{kind} repair of {vid} incomplete")
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # any failure of a volume server or of the plan backs off
            failures = self._repair_backoff.get(key, (0, 0.0))[0] + 1
            delay = min(self.maintenance_interval_seconds
                        * (2 ** failures), 300.0)
            self._repair_backoff[key] = (failures,
                                         time.monotonic() + delay)
            self.metrics.count("repairs_failed", labels={"kind": kind})
            log.warning("%s repair of volume %d failed (attempt %d, next "
                        "in %.1fs): %s", kind, vid, failures, delay, e)
        else:
            self._repair_backoff.pop(key, None)
            self.metrics.count("repairs_succeeded", labels={"kind": kind})
            log.info("%s repair of volume %d succeeded", kind, vid)
        finally:
            self._repairs_inflight.discard(key)

    def _checkout_worker(self) -> int:
        """A numbered worker slot (the caller holds _repair_sem, so the
        list is empty only if a caller bypassed it: slot -1)."""
        worker = (self._repair_worker_free.pop()
                  if self._repair_worker_free else -1)
        self.metrics.gauge("repair_workers", self.repair_concurrency)
        self.metrics.gauge(
            "repair_workers_busy",
            self.repair_concurrency - len(self._repair_worker_free))
        return worker

    def _checkin_worker(self, worker: int) -> None:
        if worker >= 0:
            self._repair_worker_free.append(worker)
        self.metrics.gauge(
            "repair_workers_busy",
            self.repair_concurrency - len(self._repair_worker_free))

    def _maint_http(self) -> aiohttp.ClientSession:
        if self._maint_session is None or self._maint_session.closed:
            self._maint_session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=300))
        return self._maint_session

    async def _admin_post(self, url: str, op: str, body: dict,
                          timeout: float = 60.0) -> dict:
        async with self._maint_http().post(
                f"http://{url}/admin/{op}", json=body,
                timeout=aiohttp.ClientTimeout(total=timeout)) as r:
            out = await r.json()
            if r.status != 200:
                raise RuntimeError(f"{url}/admin/{op}: "
                                   f"{out.get('error', r.status)}")
            return out

    async def _repair_ec(self, vid: int, collection: str) -> bool:
        """The automatic ec.rebuild: drop scrub-flagged shard copies,
        then the shell's plan (copy survivors to the richest holder,
        rebuild, mount, drop the borrowed copies)."""
        from ..shell.ec_commands import collect_ec_nodes, plan_rebuild
        bad = self._scrub_bad.get(vid, {})
        live_urls = {n.url for n in self.topology.nodes.values()}
        for url, sids in list(bad.items()):
            if url not in live_urls:
                # the flagged holder died: its rotten copies went with it
                bad.pop(url, None)
                continue
            if not self.raft.is_leader:
                return False
            await self._admin_post(url, "ec/delete_shards",
                                   {"volume_id": vid,
                                    "collection": collection,
                                    "shard_ids": sorted(sids)})
            bad.pop(url, None)
            self.metrics.count("scrub_shards_dropped", value=len(sids))
        if not bad:
            self._scrub_bad.pop(vid, None)
        rebuilder, missing, copy_plan = plan_rebuild(
            collect_ec_nodes(self.topology.to_dict()), vid,
            self.ec_total_shards_for(collection))
        if not missing:
            return True
        copied: list[int] = []
        for src, sids in copy_plan.items():
            # a deposed leader stops between steps, not racing the new one
            if not self.raft.is_leader:
                return False
            await self._admin_post(rebuilder, "ec/copy",
                                   {"volume_id": vid,
                                    "collection": collection,
                                    "shard_ids": sids, "source": src},
                                   timeout=600.0)
            copied.extend(sids)
        if not self.raft.is_leader:
            return False
        out = await self._admin_post(rebuilder, "ec/rebuild",
                                     {"volume_id": vid,
                                      "collection": collection},
                                     timeout=600.0)
        # mount every missing shard, not only what this rebuild made: an
        # interrupted repair may have left a shard file unmounted, and a
        # rebuild reports only the files it had to create
        await self._admin_post(rebuilder, "ec/mount",
                               {"volume_id": vid,
                                "collection": collection,
                                "shard_ids": sorted(
                                    set(out.get("rebuilt", []))
                                    | set(missing))})
        if copied:
            await self._admin_post(rebuilder, "ec/delete_shards",
                                   {"volume_id": vid,
                                    "collection": collection,
                                    "shard_ids": copied})
        return True

    async def _repair_replica(self, vid: int, collection: str,
                              replication: str, holders: list) -> bool:
        """Copy an under-replicated volume onto a node where the
        placement holds (balance/planner.py); False when there is none."""
        target = pick_replica_target(self.topology, replication, holders)
        if target is None or not self.raft.is_leader:
            return False
        await self._admin_post(target.url, "volume/copy",
                               {"volume_id": vid,
                                "collection": collection,
                                "source": holders[0].url},
                               timeout=600.0)
        return True

    async def ec_scrub_report(self, request: web.Request) -> web.Response:
        """A volume server reports shards whose bytes no longer match
        their stamped digest; the repair daemon drops and rebuilds them."""
        body = await request.json()
        try:
            vid = int(body["volume_id"])
            url = body["url"]
            bad = {int(s) for s in body.get("bad_shards", [])}
        except (KeyError, ValueError, TypeError):
            return _error("bad report", 400)
        if bad:
            per_node = self._scrub_bad.setdefault(vid, {})
            per_node[url] = per_node.get(url, set()) | bad
            self.metrics.count("scrub_reports")
            log.warning("scrub: %s reports bad shards %s of volume %d",
                        url, sorted(bad), vid)
        return web.json_response({"ok": True})

    # --- the lifecycle plane: heat view and daemon state ---
    async def vol_heat(self, request: web.Request) -> web.Response:
        """Per-volume access heat and lifecycle state (``volume.heat``)."""
        out = self.lifecycle.heat_status()
        vid = request.query.get("volumeId", "")
        if vid:
            try:
                want = int(vid)
            except ValueError:
                return _error("invalid volumeId", 400)
            out["volumes"] = [v for v in out["volumes"]
                              if v["volume"] == want]
        return web.json_response(out)

    async def vol_heat_report(self, request: web.Request) -> web.Response:
        """Heat deltas delivered outside a heartbeat."""
        try:
            body = await request.json()
        except ValueError:
            return _error("bad json", 400)
        ok = self.topology.merge_heat(body.get("node_id", ""),
                                      body.get("heat") or [])
        return web.json_response({"ok": ok})

    async def lifecycle_status(self, request: web.Request) -> web.Response:
        """Pending and recent transitions with outcomes
        (``lifecycle.status``)."""
        return web.json_response(self.lifecycle.status())

    async def lifecycle_run(self, request: web.Request) -> web.Response:
        """One evaluation pass now (``lifecycle.run``)."""
        out = await self.lifecycle.pass_once()
        return web.json_response({"ok": True, **out})

    # --- the balance plane ---
    async def balance_status(self, request: web.Request) -> web.Response:
        """Per-node heat rates, pending and recent moves, the two-pass
        and cooldown bookkeeping (``cluster.balance.status``)."""
        return web.json_response(self.balancer.status())

    async def balance_run(self, request: web.Request) -> web.Response:
        """One planning pass now, the timer's (``cluster.balance.run``);
        confirmed moves launch through the shared worker slots."""
        out = await self.balancer.pass_once()
        return web.json_response({"ok": True, **out})

    # --- the geo plane: cross-cluster replication jobs ---
    async def geo_status(self, request: web.Request) -> web.Response:
        """Per-bucket replication job state: offsets, lag, applied,
        skipped and poisoned counts (``geo.status``)."""
        return web.json_response(self.geo.status())

    async def geo_run(self, request: web.Request) -> web.Response:
        """One rule-scan and reconcile pass now, the timer's
        (``geo.sync``): a fresh rule starts its job and backfill at once."""
        with overload.priority(overload.CLASS_BG):
            out = await self.geo.pass_once()
        return web.json_response({"ok": True, **out})

    # --- handlers ---
    async def dir_assign(self, request: web.Request) -> web.Response:
        """Assign a write target (dirAssignHandler,
        weed/server/master_server_handlers.go:96-150)."""
        self.metrics.count("assign")
        if not await self.ensure_assign_ready():
            return _error("not the leader / not ready", 503)
        q = request.query
        try:
            count = int(q.get("count", 1))
        except ValueError:
            return _error("invalid count", 400)
        resp, status = await self.assign_api(
            count=count,
            collection=q.get("collection", ""),
            replication=q.get("replication", self.default_replication),
            ttl=q.get("ttl", ""),
            data_center=q.get("dataCenter", ""))
        return web.json_response(resp, status=status)

    async def _sequencer_call(self, fn, *args):
        """`fn(*args)` of the sequencer: in the executor when it blocks
        (a KV round trip), else here."""
        if getattr(self.sequencer, "blocking", False):
            return await asyncio.get_running_loop().run_in_executor(
                None, fn, *args)
        return fn(*args)

    async def ensure_assign_ready(self) -> bool:
        """The leader's readiness barrier (every earlier entry applied),
        then, once a term, a sequencer of its own raised to the
        committed key ceiling: a new leader's sequencer mints nothing at
        or below a key an earlier one may have handed out. The metadata
        log's sequencer needs no sync: its replay is the counter."""
        if not await self.raft.ensure_ready():
            return False
        if self._seq_synced_term != self.raft.term:
            if not self._replicated:
                await self._sequencer_call(self.sequencer.set_max,
                                           self._key_bound)
            self._seq_synced_term = self.raft.term
        return True

    async def assign_api(self, count: int = 1, collection: str = "",
                         replication: str = "", ttl: str = "",
                         data_center: str = "") -> tuple[dict, int]:
        if count < 1:
            # a negative count would roll the sequencer backwards
            return {"error": "invalid count"}, 400
        if count > MAX_ASSIGN_COUNT:
            return {"error": f"count exceeds {MAX_ASSIGN_COUNT}"}, 400
        replication = replication or self.default_replication
        picked = self.topology.pick_for_write(collection, replication, ttl)
        if picked is None and self._awaiting_heartbeats() and \
                self._unheard_volumes(collection, replication, ttl):
            # a new leader learns the volumes from the servers' next
            # beats: growing now would add a volume beside a writable
            # one the log registered and no server has reported yet
            return ({"error": "new leader: waiting for the volume "
                              "servers' heartbeats"}, 503)
        if picked is None:
            async with self._grow_lock:
                picked = self.topology.pick_for_write(collection,
                                                      replication, ttl)
                if picked is None:
                    grown = await self._grow(1, collection, replication,
                                             ttl, data_center)
                    if grown is None:
                        return ({"error": "lost leadership during grow"},
                                503)
                    if not grown:
                        return ({"error":
                                 "no writable volumes and cannot grow"},
                                500)
                    picked = self.topology.pick_for_write(
                        collection, replication, ttl)
        if picked is None:
            return {"error": "no writable volumes"}, 500
        vid, nodes = picked
        g = self.ec_policy.for_collection(collection)
        geometry = f"{g.data_shards}+{g.parity_shards}"
        if self._replicated:
            # the batch is a log entry whose apply mints the keys: a
            # leader killed now either committed it (its successor
            # replays past it) or consumed nothing; a collection's first
            # assign under its geometry stamps it in the same entry
            cmd: dict = {"assign_batch": {"count": count}}
            if self.metalog.geometry.get(collection or "") != geometry:
                cmd["geometry_stamp"] = {"collection": collection or "",
                                         "geometry": geometry}
            ok, key = await self.raft.propose_apply(cmd)
            if not ok or key is None:
                return {"error": "lost leadership during assign"}, 503
        else:
            key = await self._sequencer_call(self.sequencer.next_file_id,
                                             count)
            # no key past the committed ceiling: a failover before the
            # ceiling moves could otherwise mint the same keys again
            if key + count > self._key_bound:
                bound = key + count + self._key_bound_step
                if not await self.raft.propose({"max_file_key": bound}):
                    return {"error": "lost leadership during assign"}, 503
        fid = FileId(vid, key, new_cookie())
        node = nodes[0]
        return {
            "fid": str(fid),
            "url": node.url,
            "publicUrl": node.public_url,
            "count": count,
            "replicas": [n.url for n in nodes[1:]],
            # the RS(k,m) this collection's volumes will seal into
            "ecGeometry": geometry,
        }, 200

    async def dir_lookup(self, request: web.Request) -> web.Response:
        q = request.query
        vid_str = q.get("volumeId", q.get("fileId", ""))
        try:
            vid = (FileId.parse(vid_str).volume_id if "," in vid_str
                   else int(vid_str))
        except ValueError:
            return _error("invalid fileId" if "," in vid_str
                          else "invalid volumeId", 400)
        nodes = self.topology.lookup(vid, q.get("collection", ""))
        if not nodes:
            # EC volumes are located through the shard registry
            urls: list[str] = []
            for nlist in self.topology.lookup_ec_shards(vid).values():
                for n in nlist:
                    if n.url not in urls:
                        urls.append(n.url)
            if urls:
                return web.json_response({
                    "volumeId": str(vid),
                    "locations": [{"url": u, "publicUrl": u}
                                  for u in urls],
                    "ec": True})
            return web.json_response(
                {"volumeId": str(vid), "error": "volume not found"},
                status=404)
        return web.json_response({
            "volumeId": str(vid),
            "locations": [{"url": n.url, "publicUrl": n.public_url}
                          for n in nodes]})

    async def dir_status(self, request: web.Request) -> web.Response:
        d = self.topology.to_dict()
        d["ec_geometry"] = self.ec_policy.to_dict()
        d["metalog"] = self.metalog.status()
        d["ring"] = self.ring.to_dict()
        return web.json_response(d)

    # --- the filer ring's membership (metaring plane) ---
    async def dir_ring(self, request: web.Request) -> web.Response:
        """The ring's wire form: filers start from it and follow the
        watch stream's ring lines."""
        return web.json_response(self.ring.to_dict())

    async def ring_join(self, request: web.Request) -> web.Response:
        """Add a filer to the ring, through raft (every master serves the
        same membership after a failover); the filers run the partition
        handoff off the pushed ring line."""
        return await self._ring_change(request, "ring_add")

    async def ring_leave(self, request: web.Request) -> web.Response:
        return await self._ring_change(request, "ring_remove")

    async def _ring_change(self, request: web.Request,
                           op: str) -> web.Response:
        try:
            peer = (await request.json())["peer"]
        except (ValueError, KeyError, TypeError):
            return _error("missing peer", 400)
        if not await self.raft.ensure_ready():
            return _error("not the leader / not ready", 503)
        if (op == "ring_add") == (peer in self.ring.peers):
            # a join of a member, a leave of a stranger: the ring as is
            return web.json_response({"ok": True, "unchanged": True,
                                      "ring": self.ring.to_dict()})
        if not await self.raft.propose({op: peer}):
            return _error("lost leadership during ring change", 503)
        return web.json_response({"ok": True, "ring": self.ring.to_dict()})

    def _broadcast_ring(self) -> None:
        """Push the ring to every watch subscriber; one that is full is
        dropped with a ``resync`` line (its redial's snapshot carries the
        ring)."""
        msg = {"type": "ring", "ring": self.ring.to_dict()}
        # a snapshot restored while raft starts comes before any watcher
        for q in list(getattr(self, "_watchers", ())):
            try:
                q.put_nowait(msg)
            except asyncio.QueueFull:
                self._watchers.discard(q)
                self.metrics.count("watchers_overflowed")
                self._push(q, {"type": "resync"})

    async def vol_grow(self, request: web.Request) -> web.Response:
        q = request.query
        try:
            count = int(q.get("count", 1))
        except ValueError:
            return _error("invalid count", 400)
        if count < 1:
            return _error("invalid count", 400)
        async with self._grow_lock:
            grown = await self._grow(
                count, q.get("collection", ""),
                q.get("replication", self.default_replication),
                q.get("ttl", ""), q.get("dataCenter", ""))
        if grown is None:
            return _error("lost leadership during grow", 503)
        if not grown:
            return _error("growth failed", 500)
        return web.json_response({"count": len(grown),
                                  "volume_ids": grown})

    async def _grow(self, count: int, collection: str, replication: str,
                    ttl: str, data_center: str = "") -> Optional[list[int]]:
        """AutomaticGrowByType (weed/topology/volume_growth.go:70-208):
        pick placement-satisfying nodes, log the new volume id and its
        registry row through raft, allocate on each node. None when
        leadership is lost (the callers answer 503, so clients rotate).
        The caller holds _grow_lock; each volume server's allocation
        heartbeat lands here while the call is awaited."""
        grown: list[int] = []
        # every earlier term's max_volume_id is applied before the next
        # id is chosen, so no id repeats across a failover
        if not await self.raft.ensure_ready():
            return None
        # heat-aware placement while the balancer is on: new volumes go
        # to the coldest nodes, so no heat lands that it must move later
        heat_rank = self.balancer.assign_rank()
        async with aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=30)) as session:
            for _ in range(count):
                nodes = self.topology.find_empty_slots(
                    replication, data_center, heat_rank=heat_rank)
                if not nodes:
                    break
                # MaxVolumeIdCommand (weed/topology/cluster_commands.go:
                # 8-31) with the registry row, committed before the
                # allocation
                vid = self.topology.max_volume_id + 1
                if not await self.raft.propose(
                        {"max_volume_id": vid,
                         "volume_create": {"vid": vid,
                                           "collection": collection,
                                           "replication": replication,
                                           "ttl": ttl}}):
                    log.warning("lost leadership while growing volume %d",
                                vid)
                    return None
                ok = True
                for node in nodes:
                    try:
                        async with session.post(
                                f"http://{node.url}/admin/assign_volume",
                                json={"volume_id": vid,
                                      "collection": collection,
                                      "replication": replication,
                                      "ttl": ttl},
                                timeout=aiohttp.ClientTimeout(
                                    total=10)) as r:
                            if r.status != 200:
                                log.warning("allocate %d on %s: HTTP %d",
                                            vid, node.url, r.status)
                                ok = False
                                break
                    except (aiohttp.ClientError,
                            asyncio.TimeoutError) as e:
                        log.warning("allocate %d on %s failed: %s", vid,
                                    node.url, e)
                        ok = False
                        break
                if ok:
                    grown.append(vid)
                    self.metrics.count("volumes_grown")
        return grown

    async def vol_list(self, request: web.Request) -> web.Response:
        """VolumeList (weed/server/master_grpc_server_volume.go:117)."""
        return web.json_response({
            "volume_size_limit_mb":
                self.topology.volume_size_limit // (1024 * 1024),
            "nodes": [{
                "url": n.url, "public_url": n.public_url,
                "data_center": n.data_center, "rack": n.rack,
                "max_volume_count": n.max_volume_count,
                "volumes": [vars(v) for v in n.volumes.values()],
                "ec_shards": [{
                    "id": e.id, "collection": e.collection,
                    "shard_ids": e.shard_ids,
                    "shard_size": e.shard_size,
                } for e in n.ec_shards.values()],
            } for n in self.topology.nodes.values()]})

    # --- vacuum (weed/topology/topology_vacuum.go:17-171) ---
    async def vol_vacuum(self, request: web.Request) -> web.Response:
        """Manual vacuum: compact every volume whose garbage level is at
        least the threshold on all its replicas."""
        try:
            threshold = float(request.query.get("garbageThreshold",
                                                self.garbage_threshold))
        except ValueError:
            return _error("invalid garbageThreshold", 400)
        done = await self._vacuum_pass(threshold)
        return web.json_response({"ok": True, "compacted": done})

    async def _vacuum_loop(self) -> None:
        """The periodic scan (topology_event_handling.go:12 kicks it
        every 15 minutes)."""
        while True:
            await asyncio.sleep(self.vacuum_interval_seconds)
            if not await self.leader_ready():
                # as upstream (topology_event_handling.go: only the leader
                # vacuums); the reference vacuums from every master (D13)
                continue
            try:
                await self._vacuum_pass(self.garbage_threshold)
            except (aiohttp.ClientError, asyncio.TimeoutError) as e:
                log.warning("vacuum pass failed: %s", e)

    async def _vacuum_pass(self, threshold: float) -> list[int]:
        """One orchestrated cycle per volume over the threshold: check
        all replicas, compact all (each server replays the writes that
        land meanwhile), commit all, clean up on failure. The volume is
        parked in layout.vacuuming, out of the writable set, for the
        cycle (batchVacuumVolumeCompact/Commit, topology_vacuum.go:
        17-103). Passes are serialized; a failure on one volume never
        aborts the rest of the scan. Read-only volumes, and volumes with
        fewer holders than their placement asks for, are skipped."""
        compacted: list[int] = []
        async with self._vacuum_lock, aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=300)) as s:
            for layout in list(self.topology.layouts.values()):
                copies = ReplicaPlacement.parse(
                    layout.replication).copy_count()
                for vid, nodes in list(layout.locations.items()):
                    if len(nodes) < copies or any(
                            n.volumes[vid].read_only for n in nodes
                            if vid in n.volumes):
                        # as upstream's vacuumOneVolumeLayout, and
                        # unlike the reference: a read-only volume (one
                        # being EC-encoded, say) is never compacted
                        # under its reader, nor one short of copies
                        continue
                    try:
                        if await self._vacuum_one(
                                s, layout, vid, [n.url for n in nodes],
                                threshold):
                            compacted.append(vid)
                            self.metrics.count("volumes_vacuumed")
                    except (aiohttp.ClientError, asyncio.TimeoutError,
                            ValueError, KeyError) as e:
                        log.warning("vacuum of volume %d failed: %s", vid,
                                    e)
        return compacted

    async def _vacuum_one(self, s: aiohttp.ClientSession, layout,
                          vid: int, urls: list[str],
                          threshold: float) -> bool:
        levels = []
        for u in urls:
            async with s.get(f"http://{u}/admin/vacuum/check",
                             params={"volume_id": str(vid)}) as r:
                if r.status != 200:
                    return False
                levels.append((await r.json())["garbage_level"])
        if not levels or min(levels) < threshold:
            return False
        layout.vacuuming.add(vid)
        was_writable = vid in layout.writable
        layout.writable.discard(vid)
        ok = False
        try:
            # a failed commit stops the phase: the holders after it keep
            # their old files, and the cleanup below aborts their copies
            ok = (await self._vacuum_step(s, urls, "compact", vid)
                  and await self._vacuum_step(s, urls, "commit", vid))
            return ok
        finally:
            if not ok:
                # on a refusal or a raised error alike (a holder that
                # died mid-pass): every holder drops its open compaction;
                # one that already committed takes it as a no-op
                for u in urls:
                    try:
                        async with s.post(
                                f"http://{u}/admin/vacuum/cleanup",
                                json={"volume_id": vid}):
                            pass
                    except (aiohttp.ClientError, asyncio.TimeoutError):
                        pass
            layout.vacuuming.discard(vid)
            if was_writable:
                layout.writable.add(vid)

    @staticmethod
    async def _vacuum_step(s: aiohttp.ClientSession, urls: list[str],
                           step: str, vid: int) -> bool:
        """POST one vacuum step to each holder in turn; False at the
        first that refuses it."""
        for u in urls:
            async with s.post(f"http://{u}/admin/vacuum/{step}",
                              json={"volume_id": vid}) as r:
                if r.status != 200:
                    return False
        return True

    async def ec_lookup(self, request: web.Request) -> web.Response:
        """LookupEcVolume (weed/server/master_grpc_server_volume.go:148)."""
        try:
            vid = int(request.query.get("volumeId", ""))
        except ValueError:
            return _error("invalid volumeId", 400)
        shards = self.topology.lookup_ec_shards(vid)
        if not shards:
            return _error("ec volume not found", 404)
        return web.json_response({
            "volumeId": vid,
            "shards": {str(sid): [n.url for n in nodes]
                       for sid, nodes in shards.items()}})

    async def heartbeat(self, request: web.Request) -> web.Response:
        """Heartbeat intake (weed/server/master_grpc_server.go:20-176).
        Body: {node_id, url, public_url, data_center, rack,
               max_volume_count, max_file_key, volumes, ec_shards}."""
        self.metrics.count("heartbeat")
        return web.json_response(self.apply_heartbeat(await request.json()))

    def apply_heartbeat(self, body: dict) -> dict:
        event = self.topology.register_heartbeat(
            node_id=body["node_id"],
            url=body["url"],
            public_url=body.get("public_url", body["url"]),
            data_center=body.get("data_center", ""),
            rack=body.get("rack", ""),
            max_volume_count=body.get("max_volume_count", 8),
            payload=body)
        # a key a volume holds above the counter (a cold start over
        # existing volumes) is logged as a floor, or raises a sequencer
        # of its own
        seen = body.get("max_file_key", 0)
        if self._replicated:
            self._maybe_propose_floor(seen)
        elif seen:
            self._watch(self._sequencer_call(self.sequencer.set_max, seen),
                        f"sequencer set_max({seen})")
        self._broadcast_location(event)
        return {"volume_size_limit": self.topology.volume_size_limit,
                "leader": self.raft.leader_id or ""}

    def _maybe_propose_floor(self, seen: int) -> None:
        """Log a heartbeat's key as a ``seq_floor`` when it would raise
        the counter: rare, one proposal at a time, its failure logged."""
        if not seen or seen < self.sequencer.peek() \
                or not self.raft.is_leader or self._floor_inflight:
            return
        self._floor_inflight = True

        async def run() -> None:
            try:
                if not await self.raft.propose({"seq_floor": seen}):
                    log.warning("seq_floor(%d) lost leadership", seen)
            finally:
                self._floor_inflight = False

        self._watch(run(), f"seq_floor({seen})")

    def _watch(self, coro, what: str) -> None:
        """Run `coro` as one of the master's tasks; its failure is
        logged (a lost floor or set_max would mint duplicates later)."""
        def done(t: asyncio.Task) -> None:
            if t in self._tasks:
                self._tasks.remove(t)
            if not t.cancelled() and t.exception() is not None:
                log.error("%s failed: %s", what, t.exception())

        task = asyncio.get_running_loop().create_task(coro)
        self._tasks.append(task)
        task.add_done_callback(done)

    # --- the admin lock (the reference's lease, upstream
    #     master_grpc_server_admin.go:21-138) ---
    def lease_admin_token(self, name: str, client: str,
                          previous_token: int) -> tuple[dict, int]:
        """Lease the lock; renew by presenting the previous token. A
        holder that stops renewing loses it after
        ``admin_lease_seconds``. A fresh lease is refused, as one another
        client holds, while a daemon job is in flight (F5;
        ``cluster_lock`` waits for them first). A renewal that finds no
        live lease here (a new leader: the lease lived in its
        predecessor's memory) adopts the presented token, so the holder's
        next renewals keep it (D14); while a daemon job runs it is
        refused as a fresh lease would be."""
        name = name or "admin"
        now = time.time()
        held = self._admin_locks.get(name)
        live = bool(held and held[2] > now)
        if live and held[0] != previous_token:
            return ({"error": f"lock {name} held by {held[1]}",
                     "holder": held[1]}, 409)
        renewal = bool(live and previous_token)
        jobs = self.daemon_jobs()
        if jobs and not renewal:
            return ({"error": f"lock {name} held by daemon jobs "
                              f"{sorted(jobs, key=str)}",
                     "holder": "daemons"}, 409)
        token = previous_token or int(now * 1e9)
        expires = now + self.admin_lease_seconds
        self._admin_locks[name] = (token, client, expires)
        return {"token": token, "expires_at": expires}, 200

    def release_admin_token(self, name: str, token: int) -> bool:
        name = name or "admin"
        held = self._admin_locks.get(name)
        if held and held[0] == token:
            del self._admin_locks[name]
            return True
        return False

    def admin_lock_holder(self) -> Optional[str]:
        """The holder of a live admin lease, else None."""
        now = time.time()
        for _token, holder, expires in self._admin_locks.values():
            if expires > now:
                return holder or "?"
        return None

    def daemons_paused(self) -> Optional[str]:
        """Why no daemon may start a job now, else None: a live admin
        lease, or a fresh one waiting for the jobs in flight (F5). The
        daemons check it before they plan, and each job again once it
        holds its slot of ``_repair_sem``, so a job queued for a slot
        when the lease is asked for gives way instead of running."""
        holder = self.admin_lock_holder()
        if holder:
            return f"admin lease held by {holder}"
        if self._lease_waiters:
            return "an admin lease waits for the daemons' jobs"
        return None

    async def _daemon_jobs_drained(self, bound: float) -> None:
        """Until no daemon job is in flight, or `bound` seconds."""
        deadline = time.monotonic() + bound
        while self.daemon_jobs() and time.monotonic() < deadline:
            await asyncio.sleep(0.05)

    async def request_admin_lease(self, name: str, client: str,
                                  previous_token: int
                                  ) -> tuple[dict, int]:
        """``lease_admin_token`` for ``/cluster/lock``: a fresh lease
        that no one holds first waits, up to ``admin_lease_wait_seconds``,
        for the daemons' jobs in flight, and pauses the daemons while it
        waits, so their backlog cannot hold it off."""
        held = self._admin_locks.get(name or "admin")
        if not previous_token and not (held and held[2] > time.time()):
            self._lease_waiters += 1
            try:
                await self._daemon_jobs_drained(
                    self.admin_lease_wait_seconds)
            finally:
                self._lease_waiters -= 1
        return self.lease_admin_token(name, client, previous_token)

    async def cluster_lock(self, request: web.Request) -> web.Response:
        body = await request.json()
        resp, status = await self.request_admin_lease(
            body.get("name", "admin"), body.get("client", ""),
            body.get("previous_token", 0))
        return web.json_response(resp, status=status)

    async def cluster_unlock(self, request: web.Request) -> web.Response:
        body = await request.json()
        if self.release_admin_token(body.get("name", "admin"),
                                    body.get("token", 0)):
            return web.json_response({"ok": True})
        return web.json_response({"error": "not the holder"}, status=409)

    async def cluster_status(self, request: web.Request) -> web.Response:
        return web.json_response({
            "is_leader": self.raft.is_leader,
            "leader": self.raft.leader_id or "",
            "peers": self.raft.peers,
            "raft_term": self.raft.term,
            "topology": self.topology.to_dict()})

    async def healthz(self, request: web.Request) -> web.Response:
        return web.json_response({"ok": True})

    # --- the watch stream (KeepConnected's location half,
    #     weed/server/master_grpc_server.go:178-233,
    #     wdclient/masterclient.go) ---
    @staticmethod
    def _push(q: asyncio.Queue, msg: Optional[dict]) -> None:
        """Queue `msg`, dropping the oldest line when full, so a closing
        marker always fits."""
        try:
            q.put_nowait(msg)
        except asyncio.QueueFull:
            try:
                q.get_nowait()
            except asyncio.QueueEmpty:
                pass
            q.put_nowait(msg)

    def _broadcast_location(self, event: Optional[dict]) -> None:
        """Push a location delta to every subscriber. A subscriber whose
        queue is full is dropped with a trailing ``resync`` line: deltas
        are incremental, so a skipped one would leave its cache wrong,
        while a redial fetches a fresh snapshot."""
        if not event or (not event["new_vids"]
                         and not event["deleted_vids"]):
            return
        msg = dict(event)
        msg["type"] = "update"
        for q in list(self._watchers):
            try:
                q.put_nowait(msg)
            except asyncio.QueueFull:
                self._watchers.discard(q)
                self.metrics.count("watchers_overflowed")
                self._push(q, {"type": "resync"})

    def _location_snapshot(self) -> dict:
        """Every volume's holders, normal and EC: the stream's first
        line."""
        vols: dict[str, list] = {}
        for node in self.topology.nodes.values():
            for vid in node.volumes:
                vols.setdefault(str(vid), []).append(
                    {"url": node.url, "publicUrl": node.public_url})
            for vid in node.ec_shards:
                entry = {"url": node.url, "publicUrl": node.public_url}
                if entry not in vols.setdefault(str(vid), []):
                    vols[str(vid)].append(entry)
        return {"type": "snapshot", "volumes": vols,
                "leader": self.raft.leader_id or "",
                "ring": self.ring.to_dict()}

    async def cluster_watch(self, request: web.Request
                            ) -> web.StreamResponse:
        """A long-lived JSON-lines stream of location deltas; followers
        answer with a 307 to the leader (they get no heartbeats)."""
        if not self.raft.is_leader:
            leader = self.raft.leader_id
            if not leader or leader == self.raft.id:
                return _error("no leader elected", 503)
            raise web.HTTPTemporaryRedirect(
                location=f"http://{leader}/cluster/watch")
        resp = web.StreamResponse(
            headers={"Content-Type": "application/x-ndjson"})
        await resp.prepare(request)
        q: asyncio.Queue = asyncio.Queue(maxsize=self.watch_queue_depth)
        self._watchers.add(q)
        try:
            await resp.write(
                json.dumps(self._location_snapshot()).encode() + b"\n")
            while True:
                msg = await q.get()
                if msg is None:
                    break
                await resp.write(json.dumps(msg).encode() + b"\n")
                if msg.get("type") == "resync":
                    # the broadcaster dropped this subscriber: end the
                    # stream so it redials for a snapshot
                    break
        except (ConnectionResetError, asyncio.CancelledError):
            pass
        finally:
            self._watchers.discard(q)
        return resp

    async def metrics_handler(self, request: web.Request) -> web.Response:
        return web.Response(
            text=self.metrics.render() + metrics_mod.render_shared(),
            content_type="text/plain")


async def run_master(host: str = "127.0.0.1", port: int = 0,
                     sock=None, **kwargs
                     ) -> tuple[MasterServer, web.AppRunner]:
    """Serve a master on host:port (0 picks a free port), or on `sock`, a
    socket bound already (an HA group needs every port before the first
    master starts), on the running loop; returns the master
    (``master.url`` is host:port) and its runner. ``await
    runner.cleanup()`` stops it, raft first."""
    if sock is None:
        sock = http.listen_socket(host, port)
    master = MasterServer(url=f"{host}:{sock.getsockname()[1]}", **kwargs)
    runner = await http.start_app(master.app, sock)
    log.info("master listening on %s", master.url)
    return master, runner
