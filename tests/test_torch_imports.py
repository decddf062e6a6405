"""The port imports neither JAX nor the JAX package.

tests/conftest.py imports jax into every test process, so the import
check runs in a fresh subprocess: it imports every module of
seaweedfs_torch and chip_smoke.py (whose main does not run on import) and
asserts that no jax or seaweedfs_tpu module got loaded. A static scan of
the sources (and of the card-only test file, which runs where there is
no jax) checks the same for modules the import might not reach.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "seaweedfs_torch"
FORBIDDEN = ("jax", "jaxlib", "seaweedfs_tpu")

_PROBE = """
import importlib, json, pkgutil, sys
sys.path.insert(0, %r)
import seaweedfs_torch
names = [m.name for m in pkgutil.walk_packages(seaweedfs_torch.__path__,
                                               "seaweedfs_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "seaweedfs_tpu"))
print(json.dumps({"modules": len(names), "names": names,
                  "forbidden": bad}))
""" % str(REPO)


def test_port_imports_without_jax():
    # -I: no PYTHONPATH or user site hooks that could preload jax
    out = subprocess.run([sys.executable, "-I", "-c", _PROBE],
                         cwd=str(REPO), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["modules"] >= 25
    for name in ("seaweedfs_torch.ops.xor_schedule",
                 "seaweedfs_torch.ops.rs_cuda",
                 "seaweedfs_torch.ec.pipeline",
                 "seaweedfs_torch.ec.governor",
                 "seaweedfs_torch.ec.feed",
                 "seaweedfs_torch.observe",
                 "seaweedfs_torch.observe.profiler",
                 "seaweedfs_torch.observe.wideevents",
                 "seaweedfs_torch.faults",
                 "seaweedfs_torch.utils.metrics",
                 "seaweedfs_torch.ec.fused",
                 "seaweedfs_torch.storage.store",
                 "seaweedfs_torch.utils.compression",
                 "seaweedfs_torch.storage.file_id",
                 "seaweedfs_torch.topology.sequence",
                 "seaweedfs_torch.topology.topology",
                 "seaweedfs_torch.server.http",
                 "seaweedfs_torch.server.master",
                 "seaweedfs_torch.server.volume_server",
                 "seaweedfs_torch.server.local_cluster",
                 "seaweedfs_torch.utils.multipart",
                 "seaweedfs_torch.client",
                 "seaweedfs_torch.shell.commands",
                 "seaweedfs_torch.shell.ec_commands",
                 "seaweedfs_torch.shell.ec_shell",
                 "seaweedfs_torch.shell.volume_commands",
                 "seaweedfs_torch.storage.backend",
                 "seaweedfs_torch.lifecycle",
                 "seaweedfs_torch.lifecycle.heat",
                 "seaweedfs_torch.lifecycle.policy",
                 "seaweedfs_torch.lifecycle.daemon",
                 "seaweedfs_torch.balance",
                 "seaweedfs_torch.balance.planner",
                 "seaweedfs_torch.balance.daemon",
                 "seaweedfs_torch.shell.balance_commands",
                 "seaweedfs_torch.clustersim",
                 "seaweedfs_torch.clustersim.__main__",
                 "seaweedfs_torch.clustersim.clock",
                 "seaweedfs_torch.clustersim.sim",
                 "seaweedfs_torch.clustersim.scenarios",
                 "seaweedfs_torch.metaring",
                 "seaweedfs_torch.metaring.ring",
                 "seaweedfs_torch.utils.retry",
                 "seaweedfs_torch.parallel",
                 "seaweedfs_torch.parallel.mesh_coder",
                 "seaweedfs_torch.parallel.sharded",
                 "seaweedfs_torch.crashsim",
                 "seaweedfs_torch.crashsim.__main__",
                 "seaweedfs_torch.crashsim.shim",
                 "seaweedfs_torch.crashsim.replay",
                 "seaweedfs_torch.crashsim.harness",
                 "seaweedfs_torch.crashsim.workloads",
                 "seaweedfs_torch.storage.needle_map",
                 "seaweedfs_torch.storage.volume_backup",
                 "seaweedfs_torch.s3",
                 "seaweedfs_torch.s3.sigv4",
                 "seaweedfs_torch.cli",
                 "seaweedfs_torch.cache",
                 "seaweedfs_torch.cache.ttl",
                 "seaweedfs_torch.cache.singleflight",
                 "seaweedfs_torch.filer",
                 "seaweedfs_torch.filer.chunks",
                 "seaweedfs_torch.filer.entry",
                 "seaweedfs_torch.filer.stores",
                 "seaweedfs_torch.filer.abstract_sql",
                 "seaweedfs_torch.filer.leveldb_store",
                 "seaweedfs_torch.filer.leveldb2_store",
                 "seaweedfs_torch.filer.filer",
                 "seaweedfs_torch.filer.manifest",
                 "seaweedfs_torch.filer.assign_lease",
                 "seaweedfs_torch.filer.upload_window",
                 "seaweedfs_torch.server.filer_server",
                 "seaweedfs_torch.lifecycle.s3_rules",
                 "seaweedfs_torch.shell.fs_commands",
                 "seaweedfs_torch.metaring.router",
                 "seaweedfs_torch.metaring.coordinator",
                 "seaweedfs_torch.metaring.invalidation",
                 "seaweedfs_torch.metaring.handoff",
                 "seaweedfs_torch.shell.ring_commands",
                 "seaweedfs_torch.filer.netutil",
                 "seaweedfs_torch.filer.bson_lite",
                 "seaweedfs_torch.filer.redis_store",
                 "seaweedfs_torch.filer.redis2_store",
                 "seaweedfs_torch.filer.etcd_store",
                 "seaweedfs_torch.filer.mongodb_store",
                 "seaweedfs_torch.filer.elastic_store",
                 "seaweedfs_torch.filer.cassandra_store",
                 "seaweedfs_torch.filer.fake_redis",
                 "seaweedfs_torch.filer.fake_etcd",
                 "seaweedfs_torch.filer.fake_mongo",
                 "seaweedfs_torch.filer.fake_elastic",
                 "seaweedfs_torch.filer.fake_cassandra",
                 "seaweedfs_torch.overload",
                 "seaweedfs_torch.overload.bucket",
                 "seaweedfs_torch.overload.sampler",
                 "seaweedfs_torch.overload.admission",
                 "seaweedfs_torch.geo",
                 "seaweedfs_torch.geo.rules",
                 "seaweedfs_torch.geo.versioning",
                 "seaweedfs_torch.s3.auth",
                 "seaweedfs_torch.s3.sigv2",
                 "seaweedfs_torch.s3.s3_server",
                 "seaweedfs_torch.shell.bucket_commands",
                 "seaweedfs_torch.query",
                 "seaweedfs_torch.query.json_query",
                 "seaweedfs_torch.cache.tiered",
                 "seaweedfs_torch.cache.http_pool",
                 "seaweedfs_torch.mount",
                 "seaweedfs_torch.mount.dirty_pages",
                 "seaweedfs_torch.mount.meta_cache",
                 "seaweedfs_torch.mount.wfs",
                 "seaweedfs_torch.mount.fuse_ctypes",
                 "seaweedfs_torch.mount.fuse_mount",
                 "seaweedfs_torch.server.webdav_server",
                 "seaweedfs_torch.integrations",
                 "seaweedfs_torch.integrations.fsspec_fs",
                 "seaweedfs_torch.ec.shard_bits",
                 "seaweedfs_torch.pb",
                 "seaweedfs_torch.pb.rpc",
                 "seaweedfs_torch.pb.master_pb2",
                 "seaweedfs_torch.pb.volume_server_pb2",
                 "seaweedfs_torch.pb.filer_pb2",
                 "seaweedfs_torch.pb.messaging_pb2",
                 "seaweedfs_torch.server.master_grpc",
                 "seaweedfs_torch.server.volume_grpc",
                 "seaweedfs_torch.server.filer_grpc",
                 "seaweedfs_torch.utils.log_buffer",
                 "seaweedfs_torch.messaging",
                 "seaweedfs_torch.messaging.broker",
                 "seaweedfs_torch.messaging.broker_grpc",
                 "seaweedfs_torch.messaging.client",
                 "seaweedfs_torch.messaging.kafka_wire",
                 "seaweedfs_torch.messaging.fake_kafka"):
        assert name in result["names"]
    assert result["forbidden"] == []


_NO_FSSPEC = """
import importlib, json, pkgutil, sys
sys.path.insert(0, %r)
sys.modules["fsspec"] = None  # an import of fsspec now fails
import seaweedfs_torch
names = [m.name for m in pkgutil.walk_packages(seaweedfs_torch.__path__,
                                               "seaweedfs_torch.")]
for name in names:
    if name != "seaweedfs_torch.integrations.fsspec_fs":
        importlib.import_module(name)
import chip_smoke
try:
    importlib.import_module("seaweedfs_torch.integrations.fsspec_fs")
    adapter = "imported"
except ImportError:
    adapter = "refused"
print(json.dumps({"modules": len(names), "adapter": adapter}))
""" % str(REPO)


def test_port_imports_without_fsspec():
    """Only the fsspec adapter needs fsspec: every other port module, and
    chip_smoke.py, imports with it hidden."""
    out = subprocess.run([sys.executable, "-I", "-c", _NO_FSSPEC],
                         cwd=str(REPO), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["modules"] >= 25 and result["adapter"] == "refused"


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py"))
    + [REPO / "chip_smoke.py", REPO / "tests" / "test_torch_gpu.py"],
    ids=lambda p: str(p.relative_to(REPO)))
def test_sources_name_no_jax(path):
    assert not _imported_roots(path) & set(FORBIDDEN)
    text = path.read_text()
    for word in ("import jax", "from jax", "import seaweedfs_tpu",
                 "from seaweedfs_tpu"):
        assert word not in text, word


SERVING = sorted([*PORT.glob("server/*.py"), *PORT.glob("shell/*.py"),
                  *PORT.glob("cluster/*.py"),
                  *PORT.glob("topology/*.py"), *PORT.glob("lifecycle/*.py"),
                  *PORT.glob("balance/*.py"), *PORT.glob("clustersim/*.py"),
                  *PORT.glob("metaring/*.py"), *PORT.glob("filer/*.py"),
                  *PORT.glob("cache/*.py"), *PORT.glob("overload/*.py"),
                  *PORT.glob("geo/*.py"), *PORT.glob("s3/*.py"),
                  *PORT.glob("mount/*.py"), *PORT.glob("query/*.py"),
                  *PORT.glob("notification/*.py"),
                  *PORT.glob("replication/*.py"),
                  *PORT.glob("pb/*.py"), *PORT.glob("messaging/*.py"),
                  PORT / "utils" / "log_buffer.py",
                  PORT / "utils" / "retry.py", PORT / "utils" / "config.py",
                  PORT / "client.py",
                  PORT / "cli.py", PORT / "utils" / "multipart.py",
                  PORT / "storage" / "file_id.py"])


@pytest.mark.parametrize("path", SERVING,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_serving_layer_imports_only_stdlib_torch_numpy(path):
    """The servers and their daemons (lifecycle, balance) are aiohttp
    applications, and clustersim runs the same control plane on a
    virtual clock; the client, the shell and the CLI use the standard
    library's HTTP client: the serving layer
    imports the standard library, aiohttp, torch, numpy and the port,
    nothing else (the mount tries fusepy, ``fuse``, before its own
    libfuse2 binding). The gRPC planes add grpcio and protobuf, each only
    to the files that import it: the generated messages (``google``),
    the service plumbing, the volume server's gRPC face and the volume
    server itself, whose survivor fetch imports grpc inside the fetch
    (``grpc``); every other gRPC module reaches grpc through pb/rpc.py,
    and a server imports its gRPC module only when a gRPC port is set."""
    allowed = set(sys.stdlib_module_names) | {"aiohttp", "torch", "numpy",
                                              "seaweedfs_torch"}
    if path.name == "fuse_mount.py":
        allowed.add("fuse")
    rel = str(path.relative_to(PORT))
    if rel.startswith("pb/") and rel.endswith("_pb2.py"):
        allowed.add("google")
    if rel in GRPC_IMPORTERS:
        allowed.add("grpc")
    assert _imported_roots(path) <= allowed


# the serving modules that import grpc themselves
GRPC_IMPORTERS = frozenset({"pb/rpc.py", "server/volume_grpc.py",
                            "server/volume_server.py"})


def test_servers_import_grpc_only_with_a_grpc_port():
    """Importing the servers, the CLI and the messaging client loads no
    grpc: a host without grpcio still runs every HTTP surface."""
    probe = (f"import sys; sys.path.insert(0, {str(REPO)!r}); "
             "sys.modules['grpc'] = None; "
             "import seaweedfs_torch.server.master, "
             "seaweedfs_torch.server.volume_server, "
             "seaweedfs_torch.server.filer_server, "
             "seaweedfs_torch.server.local_cluster, seaweedfs_torch.cli, "
             "seaweedfs_torch.messaging, "
             "seaweedfs_torch.notification.queues, "
             "seaweedfs_torch.replication.sub; print('ok')")
    out = subprocess.run([sys.executable, "-I", "-c", probe],
                         cwd=str(REPO), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
