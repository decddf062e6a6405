"""The port's WebDAV gateway (seaweedfs_torch/server/webdav_server.py)
against the reference's.

- the reference's 15 cases of tests/test_webdav.py, each run against a
  gateway of each package (parametrised by ``pkg``: the reference's on
  ``cluster_util.Cluster``, the port's on ``LocalCluster.add_webdav``);
  ``test_lock_expiry`` on each package's ``LockManager``;
- one seeded script of DAV requests (MKCOL, PUT, PROPFIND at depth 0 and
  1, GET and HEAD, MOVE and COPY with ``Overwrite``, LOCK with and
  without ``If:``, a refresh, UNLOCK, PROPPATCH, DELETE, the ``If:`` and
  ``Destination`` forms clients send) against both gateways: equal
  statuses and equal bodies (the multistatus and lock XML, the bytes)
  once lock tokens, lock timeouts and dates are normalised;
- the reserved ops routes: ``PUT /healthz`` answered 405 by both, and the
  debug routes reserved (405) on the port's.
"""

import random
import re
import time
import urllib.error
import urllib.request

import pytest

import test_webdav as ref
from cluster_util import Cluster as RCluster
from cluster_util import free_port
from seaweedfs_torch.server import webdav_server as pdav
from seaweedfs_torch.server.local_cluster import LocalCluster
from seaweedfs_tpu.server import webdav_server as rdav

PKGS = ("reference", "port")
CASES = ["test_options_advertises_dav", "test_put_get_roundtrip",
         "test_propfind_depth1_lists_children", "test_propfind_missing_is_404",
         "test_mkcol_and_collection_propfind", "test_move",
         "test_copy_file_and_tree", "test_delete", "test_lock_enforcement",
         "test_lock_depth_infinity_covers_children",
         "test_delete_ancestor_of_locked_child_is_423",
         "test_delete_with_token_releases_lock",
         "test_move_with_token_releases_source_subtree_locks",
         "test_move_overwrite_releases_destination_locks"]


class Stack:
    """One package's cluster (one volume server), a filer and a WebDAV
    gateway in front of it."""

    def __init__(self, pkg: str):
        if pkg == "reference":
            self.cluster = RCluster(n_volume_servers=1, pulse=0.15)
            filer = self.cluster.add_filer(chunk_size=16 * 1024)
            port = free_port()
            gw = rdav.WebDavServer(filer.url)
            self.cluster.runners.append(self.cluster.serve(gw.app, port))
            self.url = f"127.0.0.1:{port}"
        else:
            self.cluster = LocalCluster(1, coder_name="torch", device="cpu",
                                        pulse=0.15)
            filer = self.cluster.add_filer("memory", 16 * 1024)
            self.gw = self.cluster.add_webdav(filer)
            self.url = self.gw.url

    def shutdown(self) -> None:
        self.cluster.shutdown()


@pytest.fixture(scope="module", params=PKGS)
def stack(request):
    s = Stack(request.param)
    yield s
    s.shutdown()


@pytest.mark.parametrize("case", CASES)
def test_reference_case(case, stack):
    getattr(ref, case)(stack.url)


@pytest.mark.parametrize("lib", [rdav, pdav], ids=PKGS)
def test_lock_expiry(lib):
    """tests/test_webdav.py::test_lock_expiry on each package."""
    lm = lib.LockManager()
    lk = lm.acquire("/x", timeout=0.05)
    assert lk is not None
    assert lm.acquire("/x", timeout=10) is None  # still held
    time.sleep(0.06)
    assert lm.holder("/x") is None  # expired
    lk2 = lm.acquire("/x", timeout=10)
    assert lk2 is not None and lk2.token != lk.token


def _call(url: str, method: str, path: str, body: bytes = None,
          headers: dict = None) -> tuple:
    req = urllib.request.Request(f"http://{url}{path}", data=body,
                                 method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_reserved_ops_routes(stack):
    status, _, _ = _call(stack.url, "PUT", "/healthz", b"shadow")
    assert status == 405
    status, _, _ = _call(stack.url, "GET", "/healthz")
    assert status == 200
    # the PUT did not create a file that the ops route would shadow
    status, _, _ = _call(stack.url, "PROPFIND", "/healthz",
                         headers={"Depth": "0"})
    assert status == 405
    if hasattr(stack, "gw"):
        for path in ("/debug/trace", "/debug/profile", "/debug/pprof",
                     "/debug/events"):
            assert _call(stack.url, "GET", path)[0] == 405
        status, _, text = _call(stack.url, "GET", "/metrics")
        assert status == 200 and b"webdav_request_total" in text


_TOKEN = re.compile(rb"opaquelocktoken:[0-9a-f-]+")


def _norm(body: bytes) -> bytes:
    body = _TOKEN.sub(b"opaquelocktoken:T", body)
    body = re.sub(rb"Second-\d+", b"Second-N", body)
    return re.sub(rb"<D:getlastmodified>[^<]*</D:getlastmodified>",
                  b"<D:getlastmodified/>", body)


def _script(url: str, seed: int) -> list:
    """Seeded DAV requests; (method, path, status, normalised body,
    Lock-Token present) of each."""
    rng = random.Random(seed)
    out = []
    tokens = {}

    def call(method, path, body=None, headers=None):
        status, hdrs, data = _call(url, method, path, body, headers)
        if method == "LOCK" and "Lock-Token" in hdrs:
            tokens[path] = hdrs["Lock-Token"].strip("<>")
        out.append((method, path, status, _norm(data),
                    "Lock-Token" in hdrs))
        return status

    root = f"/s{seed}"
    call("MKCOL", root)
    call("MKCOL", root + "/a")
    call("MKCOL", root + "/a")  # exists: 405
    call("MKCOL", root + "/b/")
    names = []
    for i in range(12):
        d = rng.choice(["a", "b"])
        name = f"{root}/{d}/f{i:02d}.txt"
        call("PUT", name, rng.randbytes(rng.randrange(0, 40000)),
             {"Content-Type": rng.choice(["text/plain",
                                          "application/octet-stream"])})
        names.append(name)
    call("PUT", f"{root}/deep/er/file.bin", b"auto-created parents")
    for path in (root, root + "/a", root + "/b/", names[0], root + "/none"):
        call("PROPFIND", path, headers={"Depth": "1"})
        call("PROPFIND", path, headers={"Depth": "0"})
    for name in names[:4]:
        call("GET", name)
        call("HEAD", name)
        call("GET", name, headers={"Range": "bytes=5-99"})
    # Destination forms: absolute URL, a bare path, percent-encoding, a
    # trailing slash; Overwrite: F onto an existing name
    call("MOVE", names[0], headers={"Destination":
                                    f"http://{url}{root}/a/moved%20one.txt"})
    call("MOVE", names[1], headers={"Destination": f"{root}/b/moved2.txt"})
    call("MOVE", names[2], headers={"Destination": f"{root}/b/moved2.txt",
                                    "Overwrite": "F"})
    call("MOVE", names[2], headers={"Destination": f"{root}/b/moved2.txt"})
    call("MOVE", root + "/nothing", headers={"Destination": root + "/x"})
    call("MOVE", names[3])  # no Destination: 400
    call("COPY", names[4], headers={"Destination": f"{root}/b/copy.txt"})
    call("COPY", names[4], headers={"Destination": f"{root}/b/copy.txt",
                                    "Overwrite": "F"})
    call("COPY", root + "/a", headers={"Destination":
                                       f"http://{url}{root}/a2/"})
    call("PROPFIND", root + "/a2", headers={"Depth": "1"})
    call("PROPFIND", root + "/b", headers={"Depth": "1"})
    # locks: a depth-infinity lock on a collection covers its children;
    # the If: forms clients send; a refresh; a wrong and a right UNLOCK
    lock_body = ref._LOCKINFO
    target = names[5]
    call("LOCK", target, lock_body, {"Timeout": "Second-600"})
    call("LOCK", target, lock_body)  # conflict: 423
    call("PUT", target, b"no token")
    call("DELETE", target)
    call("PUT", target, b"with token", {"If": f"(<{tokens[target]}>)"})
    call("PUT", target, b"tagged list",
         {"If": f"<http://{url}{target}> (<{tokens[target]}>)"})
    call("LOCK", target, None, {"If": f"(<{tokens[target]}>)",
                                "Timeout": "Second-900"})
    call("LOCK", target, None, {"If": "(<opaquelocktoken:nope>)"})
    call("PROPPATCH", target, b"<x/>")
    call("PROPPATCH", target, b"<x/>", {"If": f"(<{tokens[target]}>)"})
    call("UNLOCK", target, None, {"Lock-Token": "<opaquelocktoken:wrong>"})
    call("UNLOCK", target, None, {"Lock-Token": f"<{tokens[target]}>"})
    call("UNLOCK", target, None, {"Lock-Token": f"<{tokens[target]}>"})
    call("UNLOCK", target)  # no token: 400
    call("LOCK", root + "/b", lock_body, {"Depth": "infinity"})
    call("PUT", root + "/b/under.txt", b"x")
    call("DELETE", root)  # an ancestor of a locked collection: 423
    call("MOVE", root + "/a", headers={"Destination": root + "/b/a"})
    call("PUT", root + "/b/under.txt", b"x",
         {"If": f"(<{tokens[root + '/b']}>)"})
    call("LOCK", root + "/a/zero.txt", lock_body, {"Depth": "0"})
    call("GET", target)
    call("DELETE", root + "/a2")
    call("GET", root + "/a2/" + names[6].rsplit("/", 1)[1])
    call("DELETE", root, None, {"If": f"(<{tokens[root + '/b']}>)"})
    call("PROPFIND", root, headers={"Depth": "0"})
    call("PUT", root + "/b/under.txt", b"lock gone with the tree")
    call("GET", root + "/b/under.txt")
    call("OPTIONS", "/")
    call("PATCH", root)
    return out


def test_seeded_dav_script_equal():
    stacks = [Stack(pkg) for pkg in PKGS]
    try:
        got = [_script(s.url, 19) for s in stacks]
    finally:
        for s in stacks:
            s.shutdown()
    assert len(got[0]) == len(got[1])
    for a, b in zip(*got):
        assert a == b
    statuses = {row[2] for row in got[0]}
    assert {201, 204, 207, 400, 405, 412, 423} <= statuses
