"""The port's fs.* shell commands against the reference's, on each
package's own cluster and filer (after tests/test_shell_commands.py's
fs cases): the same files, the same command lines, equal answers (times
masked); ``fs.meta.save`` from one filer and ``fs.meta.load`` into a
second gives equal listings; and the port's CLI shell with ``-filer``
prints a listing and a file's bytes.
"""

import json
import subprocess
import sys
import urllib.error
from pathlib import Path

import pytest

from cluster_util import Cluster
from seaweedfs_torch.client import Client as PClient
from seaweedfs_torch.client import ClientError as PClientError
from seaweedfs_torch.server import http as phttp
from seaweedfs_torch.server.local_cluster import LocalCluster
from seaweedfs_torch.shell import commands as pcmds
from seaweedfs_tpu.client import ClientError as RClientError
from seaweedfs_tpu.shell import commands as rcmds

REPO = Path(__file__).resolve().parent.parent
FILES = {"/shelltest/hello.txt": b"shell fs data",
         "/shelltest/sub/a.bin": bytes(range(256)) * 80,
         "/shelltest/sub/deeper/b.txt": b"b" * 17,
         "/shelltest/z.txt": b""}


@pytest.fixture(scope="module")
def envs():
    ref = Cluster(n_volume_servers=2)
    port = LocalCluster(2, coder_name="numpy", volume_size_limit_mb=1,
                        pulse=0.15)
    try:
        rcmds._register_all()
        pcmds._register_all()
        out = {}
        for pkg, c, cmds, client in (
                ("reference", ref, rcmds, ref.client),
                ("port", port, pcmds, PClient(port.master_url))):
            fs_a = c.add_filer(chunk_size=4096)
            fs_b = c.add_filer(chunk_size=4096)
            for path, data in FILES.items():
                r = phttp.request("PUT", f"http://{fs_a.url}{path}", data)
                assert r.status == 201, r.data
            out[pkg] = (cmds, client, fs_a, fs_b, c)
        yield out
    finally:
        ref.shutdown()
        port.shutdown()


def _mask(obj):
    if isinstance(obj, dict):
        return {k: "*" if k in ("mtime", "crtime", "fid", "etag", "file")
                else _mask(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def _script(pkg, cmds, client, fs_a, fs_b, tmp):
    # the reference's filer_get lets urllib's HTTPError through; the
    # port answers every refusal with its ClientError
    err = PClientError if pkg == "port" else (RClientError,
                                              urllib.error.HTTPError)
    env = cmds.CommandEnv(client, filer=fs_a.url)
    run = lambda *argv: _mask(cmds.run_command(env, list(argv)))  # noqa
    out = [run("fs.ls", "/shelltest"), run("fs.ls", "-l", "/shelltest"),
           run("fs.du", "/shelltest"), run("fs.du", "/shelltest/sub"),
           run("fs.cat", "/shelltest/sub/a.bin") == FILES[
               "/shelltest/sub/a.bin"],
           run("fs.cat", "/shelltest/hello.txt"),
           run("fs.tree", "/shelltest"),
           run("fs.meta.cat", "/shelltest/hello.txt")]
    run("fs.mv", "/shelltest/hello.txt", "/shelltest/renamed.txt")
    out.append(run("fs.ls", "/shelltest"))
    out.append(run("fs.cd", "/shelltest/sub"))
    out.append(run("fs.pwd"))
    out.append(run("fs.ls"))
    out.append(run("fs.ls", "deeper"))
    out.append(run("fs.cat", "../renamed.txt"))
    out.append(run("fs.mkdir", "made"))
    out.append(run("fs.ls", "-l", "."))
    run("fs.mv", "/shelltest/sub/deeper", "/shelltest/moved")
    out.append(run("fs.cat", "/shelltest/moved/b.txt"))
    for argv in (["fs.cd", "/nope"], ["fs.cd", "/shelltest/renamed.txt"],
                 ["fs.meta.cat", "/nope"]):
        with pytest.raises(err):
            cmds.run_command(env, argv)
    saved = tmp / f"{pkg}.jsonl"
    out.append(run("fs.meta.save", "-o", str(saved), "/shelltest"))
    env_b = cmds.CommandEnv(client, filer=fs_b.url)
    out.append(_mask(cmds.run_command(env_b, ["fs.meta.load",
                                              str(saved)])))
    listing = {}
    for e in (env, env_b):
        listing[e.filer] = _mask(cmds.run_command(
            e, ["fs.ls", "-l", "/shelltest/sub"]))
    out.append(listing[fs_a.url] == listing[fs_b.url])
    # the loaded entries point at the same chunks: B reads A's bytes
    out.append(cmds.run_command(env_b, ["fs.cat", "/shelltest/sub/a.bin"])
               == FILES["/shelltest/sub/a.bin"])
    run("fs.rm", "-r", "/shelltest")
    out.append(run("fs.ls", "/shelltest"))
    out.append(run("fs.du", "/"))
    return out


def test_fs_commands_equal(envs, tmp_path):
    got = {pkg: _script(pkg, *vals[:4], tmp_path)
           for pkg, vals in envs.items()}
    assert got["port"] == got["reference"]
    assert got["port"][2]["bytes"] == sum(len(d) for d in FILES.values())


def test_cli_shell_with_filer(envs):
    """`python -m seaweedfs_torch.cli shell -filer`: fs.ls prints JSON,
    fs.cat writes the file's bytes as they are."""
    _, _, fs_a, _, c = envs["port"]
    phttp.request("PUT", f"http://{fs_a.url}/cli/x.bin", b"\x00cli\xff")
    cli = ("import sys; sys.path.insert(0, %r); "
           "from seaweedfs_torch.cli import main; main()" % str(REPO))

    def shell(*argv):
        return subprocess.run(
            [sys.executable, "-I", "-c", cli, "shell", "-master",
             c.master_url, "-filer", fs_a.url, *argv],
            capture_output=True, timeout=120)

    out = shell("fs.ls", "/cli")
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["entries"] == ["x.bin"]
    out = shell("fs.cat", "/cli/x.bin")
    assert out.returncode == 0 and out.stdout == b"\x00cli\xff"
