"""The port's query engine (seaweedfs_torch/query/) and the volume server's
``/admin/query`` against the reference's.

- unit parity: ``get_path``, ``QueryFilter`` (the eight operators, the
  numeric coercion, an unknown operator), ``project_doc`` and
  ``query_json_lines`` of both packages on seeded documents, with equal
  outputs;
- the reference's ``test_query_engine`` (tests/test_backup_tail.py) run
  against each package's module;
- ``POST /admin/query`` on a port cluster and on a reference cluster
  (one volume server each) that took the same documents: equal NDJSON,
  in the order of the fids, a fid that cannot be read skipped by both;
  ``Client.query`` of each package equal too;
- the same queries on the port over an EC volume with shards {0, 3, 7,
  12} dropped (``coder_name="torch", device="cpu"``), equal to the
  answers before the encode.
"""

import json
import random

import pytest

import test_backup_tail as ref_backup_tail
from cluster_util import Cluster as RCluster
from seaweedfs_torch.query import json_query as pquery
from seaweedfs_torch.client import Client as PClient
from seaweedfs_torch.ec import geometry as pgeo
from seaweedfs_torch.server import http as phttp
from seaweedfs_torch.server.local_cluster import LocalCluster
from seaweedfs_torch.shell import commands as shell_commands
from seaweedfs_tpu.query import json_query as rquery
from seaweedfs_tpu.client import Client as RClient

PG = pgeo.Geometry(10, 4, large_block_size=64 * 1024,
                   small_block_size=4 * 1024)
VICTIMS = (0, 3, 7, 12)
OPS = ("=", "==", "!=", "<", "<=", ">", ">=", "contains")
QUERIES = [
    ({"field": "n", "op": "<", "value": 500}, ["id", "n"]),
    ({"field": "a.b", "op": "=", "value": 7}, ["id", "a.b"]),
    ({"field": "tag", "op": "contains", "value": "x"}, ["id", "tag"]),
    ({"field": "n", "op": ">=", "value": "900"}, None),
    ({"field": "list.1", "op": "!=", "value": 3}, ["list.0", "a"]),
    (None, ["id"]),
]


def _value(rng: random.Random, depth: int = 0):
    kind = rng.randrange(7 if depth < 2 else 5)
    if kind == 0:
        return rng.randrange(-50, 1000)
    if kind == 1:
        return rng.choice(["x", "abc", "wxyz", "", "7", "500"])
    if kind == 2:
        return rng.random() * 100
    if kind == 3:
        return rng.choice([True, False, None])
    if kind == 4:
        return str(rng.randrange(1000))
    if kind == 5:
        return [_value(rng, depth + 1) for _ in range(rng.randrange(4))]
    return {k: _value(rng, depth + 1)
            for k in rng.sample(["a", "b", "c", "0", "1"], rng.randrange(4))}


def _docs(seed: int, n: int) -> list:
    """Seeded documents: the query smoke's shape (id, n, a.b, tag, list)
    with values of every JSON kind mixed in."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        doc = {"id": i, "n": rng.randrange(1000),
               "a": {"b": rng.randrange(10), "c": _value(rng)},
               "tag": "".join(rng.choice("abcdwxyz") for _ in range(6)),
               "list": [rng.randrange(5) for _ in range(rng.randrange(4))]}
        if rng.random() < 0.3:
            doc["extra"] = _value(rng)
        if rng.random() < 0.1:
            doc = [doc, {"id": -i, "n": _value(rng)}]
        out.append(doc)
    return out


def _paths(rng: random.Random) -> str:
    return rng.choice(["id", "n", "a", "a.b", "a.c", "a.c.0", "a.c.a",
                       "tag", "list", "list.0", "list.1", "list.x",
                       "extra", "extra.0", "missing", "", "a.b.c"])


@pytest.mark.parametrize("seed", range(6))
def test_get_path_filter_project_parity(seed):
    rng = random.Random(1000 + seed)
    docs = _docs(seed, 60)
    for doc in docs:
        for _ in range(8):
            path = _paths(rng)
            assert pquery.get_path(doc, path) == rquery.get_path(doc, path)
            proj = [_paths(rng) for _ in range(rng.randrange(4))] or None
            assert pquery.project_doc(doc, proj) == \
                rquery.project_doc(doc, proj)
            field, op, value = _paths(rng), rng.choice(OPS), _value(rng)
            assert pquery.QueryFilter(field, op, value).matches(doc) == \
                rquery.QueryFilter(field, op, value).matches(doc)
    for lib in (pquery, rquery):
        with pytest.raises(ValueError, match="unsupported op"):
            lib.QueryFilter("n", "~", 1).matches({"n": 1})


@pytest.mark.parametrize("seed", range(4))
def test_query_json_lines_parity(seed):
    rng = random.Random(seed)
    payloads = [json.dumps(d).encode() for d in _docs(seed, 80)]
    payloads += [b"not json", b"\xff\xfe", b"[]", b"3", b'"s"']
    rng.shuffle(payloads)
    for flt, proj in QUERIES:
        outs = []
        for lib in (pquery, rquery):
            f = None if flt is None else lib.QueryFilter(
                flt["field"], flt["op"], flt["value"])
            outs.append(list(lib.query_json_lines(payloads, f, proj)))
        assert outs[0] == outs[1]


@pytest.mark.parametrize("lib", [rquery, pquery], ids=["reference", "port"])
def test_reference_query_engine(lib, monkeypatch):
    """tests/test_backup_tail.py::test_query_engine on each package."""
    monkeypatch.setattr(ref_backup_tail, "QueryFilter", lib.QueryFilter)
    monkeypatch.setattr(ref_backup_tail, "query_json_lines",
                        lib.query_json_lines)
    ref_backup_tail.test_query_engine()


# --- /admin/query on both clusters ---

def _payloads() -> list:
    docs = [json.dumps(d).encode() for d in _docs(77, 120)]
    docs[5] = b"not json at all"
    docs[9] = json.dumps([{"id": 900, "n": 1}, {"id": 901, "n": 2}]).encode()
    return docs


@pytest.fixture(scope="module")
def clusters():
    rc = RCluster(n_volume_servers=1, pulse=0.15)
    pc = LocalCluster(1, coder_name="torch", device="cpu", geometry=PG,
                      pulse=0.15, master_kwargs={"repair_enabled": False})
    try:
        payloads = _payloads()
        sides = {}
        for name, client in (("reference", RClient(rc.master_url)),
                             ("port", PClient(pc.master_url))):
            fids = [client.upload(p, collection="docs") for p in payloads]
            sides[name] = (client, fids)
        yield rc, pc, sides
    finally:
        pc.shutdown()
        rc.shutdown()


def _admin_query(client, fids: list, flt, proj) -> bytes:
    url = client.lookup(int(fids[0].split(",")[0]))[0]
    body = json.dumps({"fids": fids, "filter": flt,
                       "projections": proj}).encode()
    r = phttp.request("POST", f"http://{url}/admin/query", body,
                      {"Content-Type": "application/json"})
    assert r.status == 200
    assert r.headers["Content-Type"].startswith("application/x-ndjson")
    return r.data


@pytest.mark.parametrize("q", range(len(QUERIES)))
def test_admin_query_ndjson_equal(clusters, q):
    _, _, sides = clusters
    flt, proj = QUERIES[q]
    bodies = []
    for name in ("reference", "port"):
        client, fids = sides[name]
        vid = fids[0].split(",")[0]
        # an unreadable fid (wrong cookie) and a malformed one are skipped
        bad = [f"{vid},{int(fids[3].split(',')[1][:-8], 16):x}00000000",
               "nonsense"]
        bodies.append(_admin_query(client, bad + fids, flt, proj))
    assert bodies[0] == bodies[1]
    assert bodies[0].count(b"\n") > 0


def test_client_query_equal(clusters):
    _, _, sides = clusters
    for flt, proj in QUERIES:
        got = [client.query(fids, flt, proj)
               for client, fids in (sides["reference"], sides["port"])]
        assert got[0] == got[1]


def test_query_over_ec_volume_with_four_shards_lost(clusters):
    """The port's documents' volume EC-encoded with the shell, shards
    {0, 3, 7, 12} dropped: every query answers as before the encode, so
    no document is lost to the degraded reads."""
    _, pc, sides = clusters
    client, fids = sides["port"]
    before = [client.query(fids, flt, proj) for flt, proj in QUERIES]
    vid = int(fids[0].split(",")[0])
    assert {int(f.split(",")[0]) for f in fids} == {vid}
    shell_commands._register_all()
    env = shell_commands.CommandEnv(PClient(pc.master_url))
    shell_commands.run_command(env, ["ec.encode", "-volumeId", str(vid),
                                     "-collection", "docs"])
    ev = pc.store(0).find_ec_volume(vid)
    assert ev is not None and pc.store(0).find_volume(vid) is None
    on_victims = sum(
        any(iv.to_shard_id_and_offset(ev.g)[0] in VICTIMS
            for iv in ev.locate(int(f.split(",")[1][:-8], 16))[2])
        for f in fids)
    assert on_victims > 0
    status, out = phttp.post_json(
        f"http://{pc.url(0)}/admin/ec/delete_shards",
        {"volume_id": vid, "collection": "docs",
         "shard_ids": list(VICTIMS)})
    assert status == 200, out
    fresh = PClient(pc.master_url)
    after = [fresh.query(fids, flt, proj) for flt, proj in QUERIES]
    assert after == before
    assert sum(len(a) for a in after) > 0
