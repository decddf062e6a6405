"""The port's geo plane (seaweedfs_torch/geo/, the master's geo daemon,
replica failover in the gateway and the client) against the reference's.

The eight cases of tests/test_geo_replication.py, each run against a
pair of clusters of each package (parametrised by ``pkg``: the
reference's on ``cluster_util.Cluster``, the port's on ``LocalCluster``)
with the reference's inputs: the replica-kill drill, an injected
``geo.apply`` fault, S3 versioning replicated with its history, the
gateway's replica failover, an active/active pair that stops moving,
the prefix rule, the shell's ``geo.*`` commands, and deletes with
overwrites. Beside them: the client's replica failover (a download whose
primary is gone is served by the replica cluster and marked stale; a 404
from a live primary never fails over), ``GeoConfig.from_env`` on the same
environments, and the offset entry's path for the same rules. Every
comparison is exact.

The port's volume servers run the kernel's plain version
(``coder_name="torch", device="cpu"``).
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest

from cluster_util import Cluster, free_port
from seaweedfs_torch import faults as pfaults
from seaweedfs_torch import geo as pgeo
from seaweedfs_torch.geo import replicate as preplicate
from seaweedfs_torch.geo import rules as prules
from seaweedfs_torch.server.local_cluster import LocalCluster
from seaweedfs_tpu import faults as rfaults
from seaweedfs_tpu import geo as rgeo
from seaweedfs_tpu.geo import replicate as rreplicate
from seaweedfs_tpu.geo import rules as rrules

PKGS = ("reference", "port")


# ---------------------------------------------------------------- helpers
# (the reference's, tests/test_geo_replication.py)

def filer_put(filer: str, path: str, data: bytes) -> None:
    req = urllib.request.Request(
        f"http://{filer}{urllib.parse.quote(path)}", data=data,
        method="PUT",
        headers={"Content-Type": "application/octet-stream"})
    urllib.request.urlopen(req, timeout=30).close()


def filer_get(filer: str, path: str):
    try:
        with urllib.request.urlopen(
                f"http://{filer}{urllib.parse.quote(path)}",
                timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, b""
    except OSError:
        return -1, b""


def meta(filer: str, op: str, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://{filer}/__meta__/{op}",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.load(r)


def meta_lookup(filer: str, path: str):
    try:
        with urllib.request.urlopen(
                f"http://{filer}/__meta__/lookup?"
                + urllib.parse.urlencode({"path": path}),
                timeout=30) as r:
            return json.load(r)
    except (urllib.error.HTTPError, OSError):
        return None


def make_bucket(filer: str, name: str, rule: dict | None = None,
                rules_mod=rrules) -> None:
    extended = {}
    if rule is not None:
        extended[rules_mod.BUCKET_ATTR] = rules_mod.rules_to_json([rule])
    meta(filer, "create_entry", {"entry": {
        "path": f"/buckets/{name}",
        "attr": {"mode": 0o40770, "mtime": time.time(),
                 "crtime": time.time()},
        "chunks": [], "extended": extended}})


def wait_until(fn, timeout: float = 30.0, interval: float = 0.1,
               what: str = "condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(interval)
    raise TimeoutError(f"timed out waiting for {what}")


def _s3_req(addr: str, method: str, path: str, data: bytes = None,
            headers: dict | None = None):
    req = urllib.request.Request(f"http://{addr}{path}", data=data,
                                 method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


# ---------------------------------------------------------------- fixture

class GeoPair:
    """Primary + replica cluster of one package, the replica filer
    restartable in place (same port, same leveldb store)."""

    def __init__(self, pkg: str, tmpdir: str):
        self.pkg = pkg
        self.ref = pkg == "reference"
        self.geo = rgeo if self.ref else pgeo
        self.faults = rfaults if self.ref else pfaults
        self.rules = rrules if self.ref else prules
        self.primary = self._cluster()
        self.replica = self._cluster()
        self.src = self.add_filer(self.primary)
        self.replica_store = {"path": f"{tmpdir}/replica.ldb"}
        self.replica_port = free_port()
        self.dst = None
        self._dst_runner = None
        self.start_replica_filer()

    def _cluster(self):
        if self.ref:
            return Cluster(n_volume_servers=1)
        return LocalCluster(1, coder_name="torch", device="cpu",
                            pulse=0.15,
                            master_kwargs={"repair_enabled": False})

    def add_filer(self, cluster, **kw):
        if self.ref:
            return cluster.add_filer(**kw)
        return cluster.add_filer("memory", 16 * 1024, **kw)

    def start_replica_filer(self):
        if self.ref:
            self.dst = self.replica.add_filer(
                store_name="leveldb", store_kwargs=dict(self.replica_store),
                port=self.replica_port)
            self._dst_runner = self.replica.runners[-1]
        else:
            self.dst = self.replica.add_filer(
                "leveldb", 16 * 1024, dict(self.replica_store),
                port=self.replica_port)
        return self.dst

    def kill_filer(self, cluster, fs, runner=None):
        if not self.ref:
            cluster.stop_filer(fs)
            return

        async def halt():
            await runner.cleanup()

        cluster.call(halt())
        cluster.runners.remove(runner)

    def kill_replica_filer(self):
        self.kill_filer(self.replica, self.dst, self._dst_runner)
        self._dst_runner = None

    def make_bucket(self, filer: str, name: str, rule=None) -> None:
        make_bucket(filer, name, rule, self.rules)

    def geo_daemon(self, **cfg_kwargs):
        """Configure + return the primary master's geo daemon (tests
        drive pass_once explicitly)."""
        master = self.primary.master
        cfg_kwargs.setdefault("filer", self.src.url)
        cfg_kwargs.setdefault("interval", 0.5)
        cfg_kwargs.setdefault("appliers", 2)
        master.geo.cfg = self.geo.GeoConfig(**cfg_kwargs)
        return master.geo

    def run_geo_pass(self) -> dict:
        return self.primary.call(self.primary.master.geo.pass_once())

    def stop_geo(self) -> None:
        self.primary.call(self.primary.master.geo.aclose())

    def serve_s3(self, cluster, filer, **kwargs) -> str:
        if self.ref:
            from seaweedfs_tpu.s3.s3_server import S3Server
            port = free_port()
            s3 = S3Server(filer.url, url=f"127.0.0.1:{port}", **kwargs)
            cluster.serve(s3.app, port)
            return f"127.0.0.1:{port}"
        return cluster.add_s3(filer, **kwargs).url

    def shutdown(self):
        try:
            self.stop_geo()
        except Exception:
            pass
        self.primary.shutdown()
        self.replica.shutdown()


@pytest.fixture(scope="module", params=PKGS)
def pair(request, tmp_path_factory):
    p = GeoPair(request.param, str(tmp_path_factory.mktemp("geo")))
    yield p
    p.shutdown()


def _rule(pair: GeoPair, dest_bucket: str, prefix: str = "") -> dict:
    return {"id": "r1", "status": "Enabled", "prefix": prefix,
            "dest_bucket": dest_bucket, "endpoint": pair.dst.url}


# ------------------------------------------- the reference's eight cases

def test_replicates_and_survives_replica_kill(pair):
    """Backfill + live tail, kill the replica filer mid-replication,
    restart it, converge byte-identical with zero loss, zero poison and
    bounded re-apply."""
    bucket = "geo"
    payload = {f"k{i:03d}": f"geo payload {i}".encode() * 20
               for i in range(10)}
    pair.make_bucket(pair.src.url, bucket, rule=_rule(pair, bucket))
    pair.make_bucket(pair.dst.url, bucket)
    for k in list(payload)[:5]:
        filer_put(pair.src.url, f"/buckets/{bucket}/{k}", payload[k])

    daemon = pair.geo_daemon(max_event_retries=10)
    out = pair.run_geo_pass()
    assert bucket in out["started"]

    def replicated(keys):
        def check():
            return all(filer_get(pair.dst.url,
                                 f"/buckets/{bucket}/{k}")[0] == 200
                       for k in keys)
        return check

    wait_until(replicated(list(payload)[:5]), timeout=30,
               what="backfill of 5 pre-rule objects")
    for k in list(payload)[5:7]:
        filer_put(pair.src.url, f"/buckets/{bucket}/{k}", payload[k])
    wait_until(replicated(list(payload)[5:7]), timeout=30,
               what="live tail of 2 objects")

    pair.kill_replica_filer()
    for k in list(payload)[7:]:
        filer_put(pair.src.url, f"/buckets/{bucket}/{k}", payload[k])
    time.sleep(1.0)
    pair.start_replica_filer()

    wait_until(replicated(list(payload)), timeout=40,
               what="convergence after replica restart")
    for k, want in payload.items():
        st, got = filer_get(pair.dst.url, f"/buckets/{bucket}/{k}")
        assert st == 200 and got == want, k
    job = daemon.jobs[bucket]
    s = job.status()
    assert s["poisoned"] == 0
    mutations = len(payload)
    window = daemon.cfg.appliers * daemon.cfg.queue_depth
    assert s["applied"] + s["backfilled"] <= mutations + window + 5
    assert meta_lookup(pair.src.url, job._offset_path()) is not None
    pair.stop_geo()


def test_injected_apply_fault_recovers_without_loss(pair):
    """A count-budgeted geo.apply error tears the stream down and the
    retry-from-offset path re-delivers: zero loss, zero poison."""
    bucket = "geofault"
    pair.make_bucket(pair.src.url, bucket, rule=_rule(pair, bucket))
    pair.make_bucket(pair.dst.url, bucket)
    pair.geo_daemon(max_event_retries=10)
    pair.run_geo_pass()
    pair.faults.set_fault("geo.apply", "error", count=2)
    try:
        for i in range(6):
            filer_put(pair.src.url, f"/buckets/{bucket}/f{i}",
                      f"fault body {i}".encode())
        wait_until(
            lambda: all(
                filer_get(pair.dst.url, f"/buckets/{bucket}/f{i}")[0]
                == 200 for i in range(6)),
            timeout=30, what="convergence through injected faults")
    finally:
        pair.faults.clear("geo.apply")
    job = pair.primary.master.geo.jobs[bucket]
    assert job.status()["poisoned"] == 0
    pair.stop_geo()


def test_s3_versioning_e2e_and_replicated_history(pair):
    """Overwrite -> both versions listable and GET-able; delete ->
    marker; the replica cluster shows the same version history."""
    bucket = "vbuck"
    s3 = pair.serve_s3(pair.primary, pair.src)
    assert _s3_req(s3, "PUT", f"/{bucket}")[0] == 200
    rule_xml = (
        "<ReplicationConfiguration><Rule><Status>Enabled</Status>"
        f"<Destination><Bucket>arn:aws:s3:::{bucket}</Bucket>"
        f"<Endpoint>{pair.dst.url}</Endpoint></Destination>"
        "</Rule></ReplicationConfiguration>").encode()
    assert _s3_req(s3, "PUT", f"/{bucket}?replication",
                   rule_xml)[0] == 200
    st, _, body = _s3_req(s3, "GET", f"/{bucket}?replication")
    assert st == 200 and b"Endpoint" in body
    ver_xml = (b"<VersioningConfiguration>"
               b"<Status>Enabled</Status></VersioningConfiguration>")
    assert _s3_req(s3, "PUT", f"/{bucket}?versioning", ver_xml)[0] == 200

    st, h1, _ = _s3_req(s3, "PUT", f"/{bucket}/doc", b"version ONE")
    assert st == 200
    v1 = h1["x-amz-version-id"]
    st, h2, _ = _s3_req(s3, "PUT", f"/{bucket}/doc", b"version TWO!")
    v2 = h2["x-amz-version-id"]
    assert v1 != v2
    st, h, body = _s3_req(s3, "GET", f"/{bucket}/doc")
    assert st == 200 and body == b"version TWO!" \
        and h["x-amz-version-id"] == v2
    st, h, _ = _s3_req(s3, "DELETE", f"/{bucket}/doc")
    assert st == 204 and h["x-amz-delete-marker"] == "true"
    marker = h["x-amz-version-id"]
    assert _s3_req(s3, "GET", f"/{bucket}/doc")[0] == 404
    st, _, _ = _s3_req(s3, "DELETE", f"/{bucket}/doc?versionId={marker}")
    assert st == 204
    st, _, body = _s3_req(s3, "GET", f"/{bucket}/doc")
    assert st == 200 and body == b"version TWO!"

    pair.make_bucket(pair.dst.url, bucket)
    pair.geo_daemon()
    pair.run_geo_pass()
    s3_replica = pair.serve_s3(pair.replica, pair.dst)

    def replica_history_matches():
        st, _, body = _s3_req(s3_replica, "GET", f"/{bucket}?versions")
        if st != 200:
            return False
        text = body.decode()
        return v1 in text and v2 in text
    wait_until(replica_history_matches, timeout=30,
               what="replicated version history")
    st, _, body = _s3_req(s3_replica, "GET",
                          f"/{bucket}/doc?versionId={v1}")
    assert st == 200 and body == b"version ONE"
    st, _, body = _s3_req(s3_replica, "GET", f"/{bucket}/doc")
    assert st == 200 and body == b"version TWO!"
    pair.stop_geo()


def test_active_passive_failover_serves_reads(pair):
    """Primary filer dies -> S3 GETs served from the replica cluster,
    marked stale-ok; the primary's breaker opens and later reads fail
    fast into the replica path."""
    if pair.ref:
        from seaweedfs_tpu.utils.retry import shared_breaker
    else:
        from seaweedfs_torch.utils.retry import shared_breaker
    bucket = "fob"
    doomed = pair.add_filer(pair.primary)
    doomed_runner = pair.primary.runners[-1] if pair.ref else None
    pair.make_bucket(doomed.url, bucket,
                     rule={"id": "r", "status": "Enabled", "prefix": "",
                           "dest_bucket": bucket,
                           "endpoint": pair.dst.url})
    pair.make_bucket(pair.dst.url, bucket)
    filer_put(doomed.url, f"/buckets/{bucket}/obj", b"survives the DR")
    pair.geo_daemon(filer=doomed.url)
    pair.run_geo_pass()
    wait_until(lambda: filer_get(pair.dst.url,
                                 f"/buckets/{bucket}/obj")[0] == 200,
               timeout=30, what="failover object replication")
    pair.stop_geo()

    s3 = pair.serve_s3(pair.primary, doomed,
                       replica_filer_url=pair.dst.url)
    st, h, body = _s3_req(s3, "GET", f"/{bucket}/obj")
    assert st == 200 and body == b"survives the DR"
    assert "X-Seaweed-Stale-Ok" not in h

    pair.kill_filer(pair.primary, doomed, doomed_runner)
    for _ in range(6):  # enough failures to open the primary's breaker
        st, h, body = _s3_req(s3, "GET", f"/{bucket}/obj")
        assert st == 200 and body == b"survives the DR"
        assert h.get("X-Seaweed-Stale-Ok") == "1"
    assert shared_breaker().is_open(doomed.url)
    st, h, _ = _s3_req(s3, "GET", f"/{bucket}/obj")
    assert st == 200 and h.get("X-Seaweed-Stale-Ok") == "1"


def test_active_active_pair_converges_without_looping(pair):
    """Both clusters replicate the same bucket at each other: writes on
    either side land on both, and signature-based loop prevention stops
    the ping-pong: applied counts stabilize."""
    bucket = "geoaa"
    pair.make_bucket(pair.src.url, bucket,
                     rule={"id": "a2b", "status": "Enabled", "prefix": "",
                           "dest_bucket": bucket,
                           "endpoint": pair.dst.url})
    pair.make_bucket(pair.dst.url, bucket,
                     rule={"id": "b2a", "status": "Enabled", "prefix": "",
                           "dest_bucket": bucket,
                           "endpoint": pair.src.url})
    pair.geo_daemon()
    pair.run_geo_pass()
    rmaster = pair.replica.master
    rmaster.geo.cfg = pair.geo.GeoConfig(filer=pair.dst.url, interval=0.5,
                                         appliers=2)
    pair.replica.call(rmaster.geo.pass_once())
    try:
        filer_put(pair.src.url, f"/buckets/{bucket}/from-a", b"A wrote")
        filer_put(pair.dst.url, f"/buckets/{bucket}/from-b", b"B wrote")
        for filer in (pair.src.url, pair.dst.url):
            wait_until(
                lambda f=filer: (
                    filer_get(f, f"/buckets/{bucket}/from-a")
                    == (200, b"A wrote")
                    and filer_get(f, f"/buckets/{bucket}/from-b")
                    == (200, b"B wrote")),
                timeout=30, what=f"active/active convergence on {filer}")
        jobs = (pair.primary.master.geo.jobs[bucket],
                rmaster.geo.jobs[bucket])
        counts = [j.status()["applied"] for j in jobs]
        time.sleep(2.0)
        assert [j.status()["applied"] for j in jobs] == counts
        assert all(j.status()["poisoned"] == 0 for j in jobs)
    finally:
        pair.replica.call(rmaster.geo.aclose())
        pair.stop_geo()


def test_prefix_rule_bounds_replication_and_backfill(pair):
    """A Prefix=logs/ rule replicates only keys under logs/, not a file
    merely NAMED 'log', nor out-of-prefix keys, in both the backfill and
    the live tail."""
    bucket = "geopfx"
    pair.make_bucket(pair.src.url, bucket,
                     rule=_rule(pair, bucket, prefix="logs/"))
    pair.make_bucket(pair.dst.url, bucket)
    filer_put(pair.src.url, f"/buckets/{bucket}/logs/in1", b"in one")
    filer_put(pair.src.url, f"/buckets/{bucket}/other/out1", b"out")
    filer_put(pair.src.url, f"/buckets/{bucket}/log", b"name trap")
    pair.geo_daemon()
    pair.run_geo_pass()
    wait_until(lambda: filer_get(pair.dst.url,
                                 f"/buckets/{bucket}/logs/in1")[0]
               == 200, timeout=30, what="prefix backfill")
    filer_put(pair.src.url, f"/buckets/{bucket}/logs/in2", b"in two")
    filer_put(pair.src.url, f"/buckets/{bucket}/other/out2", b"out2")
    wait_until(lambda: filer_get(pair.dst.url,
                                 f"/buckets/{bucket}/logs/in2")[0]
               == 200, timeout=30, what="prefix live tail")
    assert filer_get(pair.dst.url,
                     f"/buckets/{bucket}/other/out1")[0] == 404
    assert filer_get(pair.dst.url,
                     f"/buckets/{bucket}/other/out2")[0] == 404
    assert filer_get(pair.dst.url, f"/buckets/{bucket}/log")[0] == 404
    pair.stop_geo()


def test_geo_shell_commands(pair):
    """geo.status / geo.sync drive the master's /geo endpoints."""
    if pair.ref:
        from seaweedfs_tpu.client import Client
        from seaweedfs_tpu.shell.commands import (CommandEnv,
                                                  _register_all,
                                                  run_command)
        master = f"127.0.0.1:{pair.primary.master_port}"
    else:
        from seaweedfs_torch.client import Client
        from seaweedfs_torch.shell.commands import (CommandEnv,
                                                    _register_all,
                                                    run_command)
        master = pair.primary.master_url
    _register_all()
    bucket = "geoshell"
    pair.make_bucket(pair.src.url, bucket, rule=_rule(pair, bucket))
    pair.make_bucket(pair.dst.url, bucket)
    pair.geo_daemon()
    env = CommandEnv(Client(master), filer=pair.src.url)
    out = run_command(env, "geo.sync")
    assert out["ok"] and bucket in out["started"]
    st = run_command(env, "geo.status")
    assert st["enabled"] and bucket in st["jobs"]
    st = run_command(env, ["geo.status", "-bucket", bucket])
    assert list(st["jobs"]) == [bucket]
    pair.stop_geo()


def test_deletes_and_overwrites_replicate(pair):
    bucket = "geomut"
    pair.make_bucket(pair.src.url, bucket, rule=_rule(pair, bucket))
    pair.make_bucket(pair.dst.url, bucket)
    pair.geo_daemon()
    pair.run_geo_pass()
    filer_put(pair.src.url, f"/buckets/{bucket}/a", b"v1")
    wait_until(lambda: filer_get(pair.dst.url,
                                 f"/buckets/{bucket}/a")[0] == 200,
               timeout=30, what="create replication")
    filer_put(pair.src.url, f"/buckets/{bucket}/a", b"v2-overwritten")
    wait_until(lambda: filer_get(pair.dst.url,
                                 f"/buckets/{bucket}/a")[1]
               == b"v2-overwritten", timeout=30,
               what="overwrite replication")
    meta(pair.src.url, "delete", {"path": f"/buckets/{bucket}/a"})
    wait_until(lambda: filer_get(pair.dst.url,
                                 f"/buckets/{bucket}/a")[0] == 404,
               timeout=30, what="delete replication")
    pair.stop_geo()


# -------------------------------------------------- the port's own cases

def test_client_fails_over_only_when_the_primary_is_unreachable():
    """Client(replica_masters=) reads a blob from the replica cluster when
    the primary's master is gone (marked stale); a 404 from a live primary
    is authoritative and never fails over."""
    from seaweedfs_torch.client import Client, ClientError
    primary = LocalCluster(1, coder_name="torch", device="cpu", pulse=0.15,
                           master_kwargs={"repair_enabled": False})
    replica = LocalCluster(1, coder_name="torch", device="cpu", pulse=0.15,
                           master_kwargs={"repair_enabled": False})
    try:
        fid = Client(replica.master_url).upload(b"only on the replica")
        c = Client(primary.master_url, replica_masters=replica.master_url)
        with pytest.raises(ClientError):
            c.download(fid)  # the primary answers: no such volume
        assert c.last_read_stale is False
        primary.stop_master()
        assert c.download(fid) == b"only on the replica"
        assert c.last_read_stale is True
        # without a replica the unreachable primary's error stands
        with pytest.raises(OSError):
            Client(primary.master_url).download(fid)
    finally:
        primary.shutdown()
        replica.shutdown()


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_d26_replica_client_has_no_replica_of_its_own(pkg, monkeypatch):
    """D26: with WEED_GEO_REPLICA_MASTERS set, the reference's replica
    client reads the variable too and gets a replica of its own, so a
    download with both clusters down fails over again at every level
    (no end but the recursion limit); the port's replica client has
    none, and failover is one hop."""
    monkeypatch.setenv("WEED_GEO_REPLICA_MASTERS", "127.0.0.1:1")
    if pkg == "reference":
        from seaweedfs_tpu.client import Client
    else:
        from seaweedfs_torch.client import Client
    c = Client("127.0.0.1:2")
    assert c._replica_masters == "127.0.0.1:1"
    second = c._replica()._replica()
    if pkg == "reference":
        assert second is not None
        assert second._replica_masters == "127.0.0.1:1"
    else:
        assert second is None


def test_d26_both_clusters_down_is_unreachable(monkeypatch):
    """With the variable set and every master of both clusters refusing
    the dial, the port's download fails once over to the replica and
    then raises ClientUnreachable."""
    from seaweedfs_torch.client import Client, ClientUnreachable
    dead = [f"127.0.0.1:{free_port()}" for _ in range(4)]
    monkeypatch.setenv("WEED_GEO_REPLICA_MASTERS", ",".join(dead[2:]))
    c = Client(",".join(dead[:2]))
    t0 = time.perf_counter()
    with pytest.raises(ClientUnreachable):
        c.download("3,01637037d6")
    assert time.perf_counter() - t0 < 30
    assert c.last_read_stale is False


@pytest.mark.parametrize("env", [
    {},
    {"WEED_GEO_FILER": "h:8888", "WEED_GEO_INTERVAL": "0.01",
     "WEED_GEO_APPLIERS": "0", "WEED_GEO_BACKFILL": "no"},
    {"WEED_GEO_ENABLED": "1", "WEED_GEO_QUEUE": "x",
     "WEED_GEO_STREAM_IDLE": "0.5", "WEED_GEO_MAX_EVENT_RETRIES": "7"},
    {"WEED_GEO_FILER": "h:1", "WEED_GEO_ENABLED": "false",
     "WEED_GEO_PEER": "p:2"},
])
def test_geo_config_from_env_matches(env):
    ours = pgeo.GeoConfig.from_env(env)
    theirs = rgeo.GeoConfig.from_env(env)
    assert ours.__dict__ == theirs.__dict__
    assert ours.enabled == theirs.enabled
    assert pgeo.OFFSET_DIR == rgeo.OFFSET_DIR


@pytest.mark.parametrize("rule", [
    {"id": "r", "status": "Enabled", "prefix": "", "dest_bucket": "b",
     "endpoint": "127.0.0.1:8888"},
    {"id": "r", "status": "Enabled", "prefix": "logs/a",
     "dest_bucket": "", "endpoint": ""},
])
def test_offset_path_matches(rule):
    """The per-job offset entry is keyed alike, so a job resumes from the
    other package's offset on the same source filer."""
    cfg = dict(filer="f:1", peer="peer:9")
    ours = preplicate.BucketReplicator("f:1", "bkt", rule,
                                       pgeo.GeoConfig(**cfg))
    theirs = rreplicate.BucketReplicator("f:1", "bkt", rule,
                                         rgeo.GeoConfig(**cfg))
    assert ours._offset_path() == theirs._offset_path()
    assert ours.status() == theirs.status()
