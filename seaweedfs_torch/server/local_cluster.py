"""A master and N volume servers in one process, on loopback ports.

What ``weed server`` is to upstream, for drives and tests: each volume
server has its own directory and its own ``Store`` (the coder named by
``coder_name``, "auto" by default: the CUDA kernels, which need a card),
and the servers talk to each other over HTTP exactly as separate
processes would. Volume server i sits in data center "dc1", rack
"rack{i % 2}".
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Optional

from ..ec.geometry import DEFAULT, Geometry
from ..storage.store import Store
from . import http
from .master import run_master
from .volume_server import run_volume_server

# volumes each server may hold
MAX_VOLUMES = 16


class LocalCluster:
    def __init__(self, n_volume_servers: int = 3,
                 coder_name: str = "auto", device: Optional[str] = None,
                 geometry: Geometry = DEFAULT,
                 volume_size_limit_mb: int = 30 * 1024,
                 pulse: float = 5.0,
                 directory: Optional[str] = None):
        self.coder_name = coder_name
        self.device = device
        self.geometry = geometry
        self.pulse = pulse
        self._tmp = None
        if directory is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="weedtorch_")
            directory = self._tmp.name
        self.directory = directory
        self.master, self.master_server = run_master(
            volume_size_limit_mb=volume_size_limit_mb,
            pulse_seconds=pulse)
        self.master_url = self.master_server.url
        # [volume server, its HTTP server, its store, its directory];
        # a stopped one keeps its slot with the servers set to None
        self.nodes: list[list] = []
        try:
            for _ in range(n_volume_servers):
                self.add_volume_server()
            self.wait_for_nodes(n_volume_servers)
        except BaseException:
            self.shutdown()
            raise

    def add_volume_server(self) -> str:
        i = len(self.nodes)
        d = os.path.join(self.directory, f"vs{i}")
        os.makedirs(d, exist_ok=True)
        store = Store([d], max_volume_counts=[MAX_VOLUMES],
                      coder_name=self.coder_name, geometry=self.geometry,
                      device=self.device)
        vs, server = run_volume_server(
            "127.0.0.1", 0, store, self.master_url, data_center="dc1",
            rack=f"rack{i % 2}", pulse_seconds=self.pulse)
        self.nodes.append([vs, server, store, d])
        return vs.url

    def url(self, i: int) -> str:
        return self.nodes[i][0].url

    def index_of(self, url: str) -> int:
        return next(i for i, n in enumerate(self.nodes)
                    if n[0] is not None and n[0].url == url)

    def store(self, i: int) -> Store:
        return self.nodes[i][2]

    def stop_volume_server(self, i: int) -> None:
        """Stop one volume server as a crash would leave it to its
        peers: no more heartbeats, its port closed."""
        vs, server, store, _ = self.nodes[i]
        if vs is None:
            return
        vs.stop()
        server.shutdown()
        store.close()
        self.nodes[i][:3] = [None, None, None]

    def node_count(self) -> int:
        _, body = http.get_json(f"http://{self.master_url}/dir/status")
        return len(body.get("nodes", []))

    def wait_for_nodes(self, n: int, timeout: float = 30.0) -> None:
        """Until the master lists exactly n volume servers."""
        deadline = time.monotonic() + timeout
        while self.node_count() != n:
            if time.monotonic() > deadline:
                raise TimeoutError(f"the master did not list {n} nodes")
            time.sleep(0.05)

    def shutdown(self) -> None:
        for i in range(len(self.nodes)):
            self.stop_volume_server(i)
        self.master.stop()
        self.master_server.shutdown()
        if self._tmp is not None:
            self._tmp.cleanup()
