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
                 "seaweedfs_torch.parallel",
                 "seaweedfs_torch.parallel.mesh_coder",
                 "seaweedfs_torch.parallel.sharded",
                 "seaweedfs_torch.crashsim",
                 "seaweedfs_torch.crashsim.__main__",
                 "seaweedfs_torch.crashsim.shim",
                 "seaweedfs_torch.crashsim.replay",
                 "seaweedfs_torch.crashsim.harness",
                 "seaweedfs_torch.crashsim.workloads",
                 "seaweedfs_torch.cli"):
        assert name in result["names"]
    assert result["forbidden"] == []


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
                  *PORT.glob("topology/*.py"), *PORT.glob("lifecycle/*.py"),
                  *PORT.glob("balance/*.py"), PORT / "client.py",
                  PORT / "cli.py", PORT / "utils" / "multipart.py",
                  PORT / "storage" / "file_id.py"])


@pytest.mark.parametrize("path", SERVING,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_serving_layer_imports_only_stdlib_torch_numpy(path):
    """The servers and their daemons (lifecycle, balance) are aiohttp
    applications; the client, the shell and the CLI use the standard
    library's HTTP client: the serving layer
    imports the standard library, aiohttp, torch, numpy and the port,
    nothing else."""
    allowed = set(sys.stdlib_module_names) | {"aiohttp", "torch", "numpy",
                                              "seaweedfs_torch"}
    assert _imported_roots(path) <= allowed
