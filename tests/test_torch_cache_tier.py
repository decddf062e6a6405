"""The port's read-path tier (seaweedfs_torch/cache/) against the
reference's: the cases of tests/test_cache_tier.py that concern
``TieredChunkCache``, ``Singleflight`` and ``HttpPool``, each run on both
packages (parametrised by ``pkg``; the reference's test module is
imported and its names bound to the package under test):

- the tiered cache's LRU order, size classes, TTL and invalidation, its
  disk tier, and its metrics and ``cache.lookup`` spans;
- singleflight's collapse of concurrent fetches, errors passed on and
  then forgotten, the ``singleflight.wait`` span, the asyncio variant;
- the pool's connection reuse, its stale-connection retry and its
  survival of a server restart;

then ``test_ec_cold_interval_reads_coalesce`` on the port's
``EcVolume`` (one reconstruction for six readers through the cache's
``Singleflight``, named ``ec.read``), a shed answer retried by the pool,
and the pool's fault points.
"""

import http.server
import os
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

import test_cache_tier as ref
from seaweedfs_torch import cache as pcache
from seaweedfs_torch import faults as pfaults
from seaweedfs_torch import observe as pobserve
from seaweedfs_torch.utils import metrics as pmetrics
from seaweedfs_tpu import cache as rcache
from seaweedfs_tpu import observe as robserve
from seaweedfs_tpu.utils import metrics as rmetrics

PKGS = {
    "reference": {"TieredChunkCache": rcache.TieredChunkCache,
                  "Singleflight": rcache.Singleflight,
                  "AsyncSingleflight": rcache.AsyncSingleflight,
                  "HttpPool": rcache.HttpPool,
                  "observe": robserve, "metrics_mod": rmetrics},
    "port": {"TieredChunkCache": pcache.TieredChunkCache,
             "Singleflight": pcache.Singleflight,
             "AsyncSingleflight": pcache.AsyncSingleflight,
             "HttpPool": pcache.HttpPool,
             "observe": pobserve, "metrics_mod": pmetrics},
}

CASES = ["test_lru_eviction_order", "test_size_class_accounting",
         "test_ttl_expiry_and_invalidation", "test_disk_tier_round_trip",
         "test_cache_metrics_and_spans",
         "test_singleflight_collapses_concurrent_fetches",
         "test_singleflight_propagates_errors_and_forgets",
         "test_singleflight_wait_emits_span",
         "test_async_singleflight_collapses",
         "test_http_pool_reuses_connections",
         "test_http_pool_retries_stale_connection"]


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("case", CASES)
def test_reference_case(case, pkg, monkeypatch, tmp_path):
    for name, value in PKGS[pkg].items():
        monkeypatch.setattr(ref, name, value)
    fn = getattr(ref, case)
    if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        fn(tmp_path)
    else:
        fn()


def test_cache_exports_match_the_reference():
    assert sorted(pcache.__all__) == sorted(rcache.__all__)
    for name in rcache.__all__:
        assert hasattr(pcache, name)


def test_ec_cold_interval_reads_coalesce(tmp_path):
    """N concurrent reads of a needle on a missing EC shard share one
    reconstruction (the cache's singleflight on the EC interval reader,
    flight "ec.read")."""
    from seaweedfs_torch import ec
    from seaweedfs_torch.storage.needle import Needle
    from seaweedfs_torch.storage.volume import Volume

    geo = ec.Geometry(data_shards=10, parity_shards=4,
                      large_block_size=10000, small_block_size=100)
    rng = random.Random(7)
    v = Volume(str(tmp_path), "", 1, create=True)
    payloads = {}
    for i in range(1, 20):
        data = bytes(rng.getrandbits(8) for _ in range(200))
        payloads[i] = data
        v.write_needle(Needle(cookie=0x9000 + i, id=i, data=data))
    v.close()
    base = os.path.join(str(tmp_path), "1")
    coder = ec.get_coder("numpy", 10, 4)
    ec.write_ec_files(base, coder, geo, buffer_size=100)
    ec.write_sorted_ecx_from_idx(base)

    ev = ec.EcVolume(str(tmp_path), "", 1, geo, coder=coder)
    for sid in range(14):
        ev.add_shard(sid)
    assert isinstance(ev.read_flight, pcache.Singleflight)
    assert ev.read_flight.name == "ec.read"
    victim_nid = next(nid for nid in payloads
                      if ev.locate(nid)[2][0].to_shard_id_and_offset(
                          geo)[0] == 0)
    ev.delete_shard(0)

    reconstructs = []
    real = ev._reconstruct_interval

    def counting(*a, **k):
        reconstructs.append(1)
        time.sleep(0.1)  # hold the flight open for followers
        return real(*a, **k)

    ev._reconstruct_interval = counting
    with ThreadPoolExecutor(max_workers=6) as ex:
        results = list(ex.map(
            lambda _: ev.read_needle(victim_nid).data, range(6)))
    assert all(r == payloads[victim_nid] for r in results)
    assert len(reconstructs) == 1  # one reconstruction served all six
    assert ev.read_flight.stats()["shared"] >= 5
    ev.close()


def _shed_server():
    """Answers the first GET with a shed 503 (Retry-After 0), then 200."""
    state = {"requests": 0}

    class H(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_GET(self):
            state["requests"] += 1
            shed = state["requests"] == 1
            body = b"shed" if shed else b"ok"
            self.send_response(503 if shed else 200)
            if shed:
                self.send_header("Retry-After", "0")
                self.send_header("X-Seaweed-Shed", "1")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, state


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_http_pool_retries_a_shed_answer(pkg):
    srv, state = _shed_server()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/x"
        r = PKGS[pkg]["HttpPool"]().request("GET", url)
        assert (r.status, r.data, state["requests"]) == (200, b"ok", 2)
        state["requests"] = 0
        r = PKGS[pkg]["HttpPool"](shed_retries=0).request("GET", url)
        assert (r.status, r.headers["x-seaweed-shed"]) == (503, "1")
    finally:
        srv.shutdown()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_http_pool_survives_server_restart(pkg):
    """tests/test_cache_tier.py::test_http_pool_survives_server_restart
    without its race for the port: the "restart" closes every connection
    the server accepted (as a dead process's sockets close) while its
    listener stays bound, so the pool holds only dead connections. The
    stale-retry must flush the idle stack and dial fresh."""
    import socket
    conns = []

    class H(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def setup(self):
            conns.append(self.request)
            super().setup()

        def do_GET(self):
            body = b'{"ok": true}'
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    pool = PKGS[pkg]["HttpPool"]()
    url = f"http://127.0.0.1:{srv.server_address[1]}/x"
    try:
        with ThreadPoolExecutor(max_workers=2) as ex:
            list(ex.map(lambda _: pool.request("GET", url), range(2)))
        assert pool.idle_count() >= 2
        for c in list(conns):
            c.shutdown(socket.SHUT_RDWR)
        time.sleep(0.05)
        r = pool.request("GET", url)
        assert r.status == 200 and r.json() == {"ok": True}
    finally:
        pool.close()
        srv.shutdown()


def test_http_pool_fault_points():
    """http_pool.request (error / drop) and http_pool.response (corrupt)
    are known points of the port's faults, and the pool fires them."""
    assert {"http_pool.request", "http_pool.response"} <= \
        pfaults.KNOWN_POINTS
    srv, _ = ref._start_server()
    url = f"http://127.0.0.1:{srv.server_address[1]}/x"
    pool = pcache.HttpPool()
    try:
        pfaults.set_fault("http_pool.request", "error", count=1)
        with pytest.raises(pfaults.FaultError):
            pool.request("GET", url)
        pfaults.set_fault("http_pool.request", "drop", count=1)
        with pytest.raises(ConnectionResetError):
            pool.request("GET", url)
        pfaults.set_fault("http_pool.response", "corrupt", count=1, seed=3)
        assert pool.request("GET", url).data != b'{"ok": true}'
        assert pool.request("GET", url).data == b'{"ok": true}'
    finally:
        pfaults.clear()
        pool.close()
        srv.shutdown()


def test_shared_pool_is_one_pool_with_the_shared_breaker():
    from seaweedfs_torch.utils import retry
    pool = pcache.shared_pool()
    assert pool is pcache.shared_pool()
    assert pool.breaker is retry.shared_breaker()
