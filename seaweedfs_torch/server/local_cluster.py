"""Masters and N volume servers in one process, on loopback ports.

What ``weed server`` is to upstream, for drives and tests: the servers
are aiohttp applications served by ``AppRunner``s on one event loop, run
in a daemon thread (tests/cluster_util.py does the same for the
reference), each bound to a free port. Each volume server has its own
directory and its own ``Store`` (the coder named by ``coder_name``,
"auto" by default: the CUDA kernels, which need a card), and the servers
talk to each other over HTTP exactly as separate processes would. Volume
server i sits in data center "dc1", rack "rack{i % racks}"; ``racks=1``
puts them all on one rack. ``master_kwargs`` and ``volume_kwargs`` go to
the master's and each volume server's constructor (as tests/
cluster_util.py takes them for the reference): the lifecycle config, the
maintenance interval, ``repair_enabled``, the scrub interval;
``store_kwargs`` go to each server's ``Store`` (its ``needle_map_kind``,
``min_free_space_percent``, ``preallocate``). ``restart_volume_server``
brings a stopped server back on its directory and its port, as a
process restart would.

``n_masters`` > 1 starts an HA group (upstream's ``weed master -peers``):
every master knows every other's address, keeps its raft state in its
own directory (``m{i}`` under the cluster's), and the volume servers and
``master_url`` get the whole comma list. ``master`` is the first master
(``masters[i]`` each, None while stopped), ``leader()`` the one that
leads now, ``wait_for_leader`` waits for one; ``stop_master(i)`` stops
master i as a crash would leave it to its peers (raft first, then its
listener), ``restart_master(i)`` starts it again on its directory and
port. Raft's timings go in ``master_kwargs`` (``election_timeout``,
``raft_heartbeat``). ``sequencer`` is a factory of the masters' key
sequencer (``lambda: KvSequencer(host, port)``), called at every start
and restart of a master, as a process would make its own; without it a
master mints through its metadata log. ``add_filer(store_name=, chunk_size=,
store_kwargs=, port=)`` starts a filer (server/filer_server.py) against
the masters (after tests/cluster_util.py's ``add_filer``),
``restart_filer(fs)`` starts it again on its port and store (a process
restart), ``stop_filer(fs)`` stops it. A filer ring: ``ring_sockets(n)``
binds n free ports (held until each member serves on its socket, so no
other socket takes one meanwhile), and ``add_filer(sock=s,
ring_peers=[...], ring_replicas=2)`` starts each member with the whole
membership (the
master's starting ring is ``master_kwargs={"ring_config":
RingConfig(...)}``, or empty until ``/dir/ring/join``). ``add_s3(fs,
**kw)`` starts an S3 gateway (s3/s3_server.py) in front of a filer (its
``iam``, ``access_key`` and ``secret_key`` in `kw`), ``stop_s3(gw)``
stops it; ``add_webdav(fs)`` and ``stop_webdav(gw)`` do the same for a
WebDAV gateway (server/webdav_server.py). The callers
drive the cluster synchronously, from their own threads, through the
port's client.

``with_grpc`` starts every master, volume server and filer on a port
whose twin (port + 10000) is free and serves their gRPC services there,
as the CLI does by default; ``use_grpc_heartbeat`` (which implies it)
has the volume servers beat over the master's gRPC Heartbeat stream.
``add_filer(with_grpc=)`` overrides the cluster's choice for one filer,
and ``master_grpc_port`` serves the one master's gRPC elsewhere than
its HTTP port + 10000 (the volume servers' beats dial it there).
``ring_sockets`` bind ports whose twin is free too, so that CLI filers
can take them.
"""

from __future__ import annotations

import asyncio
import os
import tempfile
import threading
import time
from typing import Callable, Optional

from ..ec.geometry import DEFAULT, Geometry
from ..metaring import RingConfig
from ..storage.store import Store
from . import http
from ..s3.s3_server import run_s3
from .filer_server import run_filer
from .master import run_master
from .volume_server import run_volume_server
from .webdav_server import run_webdav

# volumes each server may hold
MAX_VOLUMES = 16
# the longest a server's start or stop may take
CALL_TIMEOUT = 120.0


class LocalCluster:
    def __init__(self, n_volume_servers: int = 3,
                 coder_name: str = "auto", device: Optional[str] = None,
                 geometry: Geometry = DEFAULT,
                 volume_size_limit_mb: int = 30 * 1024,
                 pulse: float = 5.0,
                 directory: Optional[str] = None,
                 racks: int = 2,
                 master_kwargs: Optional[dict] = None,
                 volume_kwargs: Optional[dict] = None,
                 store_kwargs: Optional[dict] = None,
                 n_masters: int = 1,
                 sequencer: Optional[Callable[[], object]] = None,
                 with_grpc: bool = False,
                 use_grpc_heartbeat: bool = False,
                 master_grpc_port: int = 0):
        self.coder_name = coder_name
        # every master and volume server (and filers by default) also
        # serves gRPC on its port + 10000; the volume servers beat over
        # the master's Heartbeat stream
        self.with_grpc = with_grpc or use_grpc_heartbeat
        self.use_grpc_heartbeat = use_grpc_heartbeat
        # the one master's gRPC port when not its HTTP port + 10000; the
        # volume servers' beats are dialled there
        self.master_grpc_port = master_grpc_port
        self.device = device
        self.geometry = geometry
        self.pulse = pulse
        self.racks = racks
        self.volume_kwargs = volume_kwargs or {}
        self.store_kwargs = store_kwargs or {}
        self._sequencer = sequencer
        self._tmp = None
        if directory is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="weedtorch_")
            directory = self._tmp.name
        self.directory = directory
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self.loop.run_forever,
                                        name="local-cluster", daemon=True)
        self._thread.start()
        # [volume server, its runner, its store, its directory]; a
        # stopped one keeps its slot with the first three set to None
        self.nodes: list[list] = []
        self._stopped_urls: dict[int, str] = {}
        self.master = self.master_runner = None
        # filer -> [its runner, its port, its constructor's kwargs]
        self.filers: dict = {}
        self.gateways: dict = {}
        # per master: [server, runner, port, its constructor's kwargs]
        self.master_slots: list[list] = []
        try:
            base = dict(volume_size_limit_mb=volume_size_limit_mb,
                        pulse_seconds=pulse, **(master_kwargs or {}))
            if n_masters == 1:
                self.start_master(**base)
            else:
                self._start_group(n_masters, base)
            for _ in range(n_volume_servers):
                self.add_volume_server()
            self.wait_for_nodes(n_volume_servers)
        except BaseException:
            self.shutdown()
            raise

    def call(self, coro):
        """Run a coroutine on the cluster's loop; wait for its result."""
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            CALL_TIMEOUT)

    @property
    def masters(self) -> list:
        return [slot[0] for slot in self.master_slots]

    def _listen(self, port: int, grpc: bool):
        """(socket or None, gRPC port) of a server to start on `port`
        (0: a free one, with a free gRPC twin when `grpc`)."""
        if not grpc:
            return None, 0
        sock = (http.listen_socket_with_grpc_twin() if port == 0
                else None)
        if sock is not None:
            port = sock.getsockname()[1]
        return sock, port + 10000

    def start_master(self, port: int = 0, **kwargs) -> None:
        """Start the one master (on `port`, or a free one)."""
        sock, grpc_port = self._listen(port, self.with_grpc)
        grpc_port = self.master_grpc_port or grpc_port
        if grpc_port:
            kwargs = dict(kwargs, grpc_port=grpc_port)
        self.master, self.master_runner = self.call(
            run_master("127.0.0.1", port, sock=sock,
                       **self._with_sequencer(kwargs)))
        self.master_url = self.master.url
        self.master_slots = [[self.master, self.master_runner,
                              int(self.master.url.rsplit(":", 1)[1]),
                              kwargs]]

    def _start_group(self, n: int, kwargs: dict) -> None:
        socks = [self._listen(0, True)[0] if self.with_grpc
                 else http.listen_socket("127.0.0.1", 0) for _ in range(n)]
        urls = [f"127.0.0.1:{s.getsockname()[1]}" for s in socks]
        self.master_url = ",".join(urls)
        for i, sock in enumerate(socks):
            state_dir = os.path.join(self.directory, f"m{i}")
            os.makedirs(state_dir, exist_ok=True)
            slot_kwargs = dict(kwargs, peers=urls, raft_state_dir=state_dir)
            if self.with_grpc:
                slot_kwargs["grpc_port"] = sock.getsockname()[1] + 10000
            self.master_slots.append(
                [None, None, sock.getsockname()[1], slot_kwargs])
        for i, sock in enumerate(socks):
            self._run_slot(i, sock)
        self.master = self.master_slots[0][0]
        self.master_runner = self.master_slots[0][1]
        self.wait_for_leader()

    def _run_slot(self, i: int, sock=None) -> None:
        slot = self.master_slots[i]
        slot[0], slot[1] = self.call(run_master(
            "127.0.0.1", slot[2], sock=sock,
            **self._with_sequencer(slot[3])))

    def _with_sequencer(self, kwargs: dict) -> dict:
        if self._sequencer is None:
            return kwargs
        return dict(kwargs, sequencer=self._sequencer())

    def leader(self):
        """The master that leads now, else None."""
        return next((m for m in self.masters
                     if m is not None and m.raft.is_leader), None)

    def wait_for_leader(self, timeout: float = 30.0, exclude=()):
        """Until one running master leads (not one of `exclude`);
        returns it."""
        deadline = time.monotonic() + timeout
        while True:
            m = self.leader()
            if m is not None and m not in exclude:
                return m
            if time.monotonic() > deadline:
                raise TimeoutError("no master leads")
            time.sleep(0.02)

    def stop_master(self, i: int = 0) -> None:
        """Stop master i: raft first (a leader whose listener is gone
        must not go on heartbeating), then its listener and tasks."""
        slot = self.master_slots[i] if self.master_slots else None
        if slot is None or slot[1] is None:
            return
        master, runner = slot[0], slot[1]

        async def halt() -> None:
            await master.raft.stop()
            await runner.cleanup()

        self.call(halt())
        slot[0] = slot[1] = None
        if i == 0:
            self.master = self.master_runner = None

    def restart_master(self, i: int):
        """Stop master i if it runs, then start it again on its port and
        its state directory, as a process restart would; returns it."""
        self.stop_master(i)
        self._run_slot(i)
        if i == 0:
            self.master, self.master_runner = self.master_slots[0][:2]
        return self.master_slots[i][0]

    def add_volume_server(self) -> str:
        """Start one more volume server, on a fresh directory; returns
        its url."""
        i = len(self.nodes)
        d = os.path.join(self.directory, f"vs{i}")
        os.makedirs(d, exist_ok=True)
        self.nodes.append([None, None, None, d])
        return self._start_volume_server(i, 0)

    def _start_volume_server(self, i: int, port: int) -> str:
        d = self.nodes[i][3]
        store = Store([d], max_volume_counts=[MAX_VOLUMES],
                      coder_name=self.coder_name, geometry=self.geometry,
                      device=self.device, **self.store_kwargs)
        sock, grpc_port = self._listen(port, self.with_grpc)
        kwargs = dict(self.volume_kwargs)
        if grpc_port:
            kwargs.update(grpc_port=grpc_port,
                          use_grpc_heartbeat=self.use_grpc_heartbeat)
            if self.master_grpc_port:
                kwargs["master_grpc_target"] = \
                    f"127.0.0.1:{self.master_grpc_port}"
        try:
            vs, runner = self.call(run_volume_server(
                "127.0.0.1", port, store, self.master_url, sock=sock,
                data_center="dc1", rack=f"rack{i % self.racks}",
                pulse_seconds=self.pulse, **kwargs))
        except BaseException:
            store.close()
            raise
        self.nodes[i][:3] = [vs, runner, store]
        return vs.url

    def restart_volume_server(self, i: int) -> str:
        """Stop server i (if it runs) and start it again on the same
        directory and port: its store reopens every volume from disk."""
        url = self.nodes[i][0].url if self.nodes[i][0] is not None \
            else self._stopped_urls[i]
        self.stop_volume_server(i)
        return self._start_volume_server(i, int(url.rsplit(":", 1)[1]))

    def url(self, i: int) -> str:
        return self.nodes[i][0].url

    def index_of(self, url: str) -> int:
        return next(i for i, n in enumerate(self.nodes)
                    if n[0] is not None and n[0].url == url)

    def store(self, i: int) -> Store:
        return self.nodes[i][2]

    def stop_volume_server(self, i: int) -> None:
        """Stop one volume server as a crash would leave it to its
        peers: no more heartbeats, its port and kept connections closed
        (its store is closed too)."""
        vs, runner, _, _ = self.nodes[i]
        if vs is None:
            return
        self._stopped_urls[i] = vs.url
        self.call(runner.cleanup())
        self.nodes[i][:3] = [None, None, None]

    def node_count(self) -> int:
        """The volume servers the leader lists (through any master)."""
        for url in self.master_url.split(","):
            try:
                status, body = http.get_json(f"http://{url}/dir/status")
            except OSError:
                continue
            if status == 200:
                return len(body.get("nodes", []))
        return -1

    def wait_for_nodes(self, n: int, timeout: float = 30.0) -> None:
        """Until the master lists exactly n volume servers."""
        deadline = time.monotonic() + timeout
        while self.node_count() != n:
            if time.monotonic() > deadline:
                raise TimeoutError(f"the master did not list {n} nodes")
            time.sleep(0.05)

    @staticmethod
    def ring_sockets(n: int) -> list:
        """n sockets bound to free loopback ports, for the members of a
        filer ring (their urls must be known before the first one
        starts); ``add_filer(sock=)`` serves on one."""
        return [http.listen_socket_with_grpc_twin() for _ in range(n)]

    def add_filer(self, store_name: str = "memory",
                  chunk_size: int = 16 * 1024,
                  store_kwargs: Optional[dict] = None, port: int = 0,
                  ring_peers: Optional[list[str]] = None,
                  ring_replicas: int = 2, sock=None,
                  with_grpc: Optional[bool] = None, **kwargs):
        """Start a filer on `port` (0: a free one) or on the bound `sock`
        with the named store (a sqlite or leveldb store's ``path`` goes
        in `store_kwargs`), a member of the filer ring of `ring_peers`
        when given, serving gRPC on its port + 10000 with `with_grpc`
        (default: the cluster's); returns it (``fs.url`` is
        host:port)."""
        grpc = self.with_grpc if with_grpc is None else with_grpc
        if grpc and sock is None:
            sock, kwargs["grpc_port"] = self._listen(port, True)
        elif grpc:
            kwargs["grpc_port"] = sock.getsockname()[1] + 10000
        if ring_peers:
            kwargs["ring_config"] = RingConfig(peers=list(ring_peers),
                                               replicas=ring_replicas)
        kwargs = dict(kwargs, store_name=store_name, chunk_size=chunk_size,
                      store_kwargs=store_kwargs)
        fs, runner = self.call(run_filer("127.0.0.1", port,
                                         self.master_url, sock=sock,
                                         **kwargs))
        self.filers[fs] = [runner, int(fs.url.rsplit(":", 1)[1]), kwargs]
        return fs

    def stop_filer(self, fs) -> None:
        """Stop a filer: its listener, its tasks, then its store."""
        runner = self.filers[fs][0]
        if runner is not None:
            self.call(runner.cleanup())
            self.filers[fs][0] = None

    def restart_filer(self, fs):
        """Stop `fs` and start a new filer on its port and its store, as
        a process restart would; returns the new one."""
        self.stop_filer(fs)
        _, port, kwargs = self.filers.pop(fs)
        new, runner = self.call(run_filer("127.0.0.1", port,
                                          self.master_url, **kwargs))
        self.filers[new] = [runner, port, kwargs]
        return new

    def add_s3(self, fs, **kwargs):
        """Start an S3 gateway on a free port in front of the filer `fs`;
        returns it (``gw.url`` is host:port)."""
        gw, runner = self.call(run_s3("127.0.0.1", 0, fs.url, **kwargs))
        self.gateways[gw] = runner
        return gw

    def stop_s3(self, gw) -> None:
        self._stop_gateway(gw)

    def add_webdav(self, fs, **kwargs):
        """Start a WebDAV gateway on a free port in front of the filer
        `fs`; returns it (``gw.url`` is host:port)."""
        gw, runner = self.call(run_webdav("127.0.0.1", 0, fs.url, **kwargs))
        self.gateways[gw] = runner
        return gw

    def stop_webdav(self, gw) -> None:
        self._stop_gateway(gw)

    def _stop_gateway(self, gw) -> None:
        runner = self.gateways.pop(gw, None)
        if runner is not None:
            self.call(runner.cleanup())

    def shutdown(self) -> None:
        try:
            for gw in list(self.gateways):
                self._stop_gateway(gw)
            for fs in list(self.filers):
                self.stop_filer(fs)
            for i in range(len(self.nodes)):
                self.stop_volume_server(i)
            for i in range(len(self.master_slots)):
                self.stop_master(i)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._thread.join(CALL_TIMEOUT)
            self.loop.close()
            if self._tmp is not None:
                self._tmp.cleanup()
