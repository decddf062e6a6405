"""The port's volume tail, incremental backup and `fix` against the
reference's.

A port cluster and a reference cluster (one volume server each, in this
process) take the same uploads and deletes, with the same needle ids and
cookies, under one deterministic append clock: ``GET /admin/tail``
streams the same frames from both, whole and from a point in the middle.
Then the backup runs both ways, the reference's client and
``volume_backup`` pulling the port server's tail into a reference volume
and the port's pulling the reference server's into a port volume, in two
rounds: the two replicas are the same bytes, and the port's applies
exactly the new records of each round (D10: the reference's pulls the
whole volume again when its replica's last record is a delete). ``rebuild_idx`` gives the reference's .idx, and
CLI ``backup`` and ``fix`` run through the port's entry point.
"""

import contextlib
import io
import json
import os
import random
import shutil
import time
import types

import pytest

from cluster_util import Cluster as RCluster
from seaweedfs_torch import cli as pcli
from seaweedfs_torch.client import Client as PClient
from seaweedfs_torch.ec import geometry as pgeo
from seaweedfs_torch.server import volume_server as pvs
from seaweedfs_torch.server.local_cluster import LocalCluster
from seaweedfs_torch.storage import volume as pvolume
from seaweedfs_torch.storage import volume_backup as pbackup
from seaweedfs_torch.storage.file_id import FileId
from seaweedfs_torch.storage.volume import Volume as PVolume
from seaweedfs_tpu.client import Client as RClient
from seaweedfs_tpu.server import volume_server as rvs
from seaweedfs_tpu.storage import volume as rvolume
from seaweedfs_tpu.storage import volume_backup as rbackup
from seaweedfs_tpu.storage.volume import Volume as RVolume

PG = pgeo.Geometry(10, 4, large_block_size=64 * 1024,
                   small_block_size=4 * 1024)
EPOCH = 1_780_000_000


class _Clock:
    """A deterministic clock for the volume engine (append_at_ns) and the
    write handler (last_modified): each package's run sees the same
    sequence of times."""

    def __init__(self):
        self.ns = EPOCH * 10**9

    def time_ns(self) -> int:
        self.ns += 1000
        return self.ns

    def module(self, real=time):
        return types.SimpleNamespace(
            time_ns=self.time_ns, time=lambda: float(EPOCH),
            monotonic=real.monotonic, perf_counter=real.perf_counter,
            sleep=real.sleep)


def _ops(seed: int, first: int, n_put: int, n_del: int) -> list:
    rng = random.Random(seed)
    ops = [("put", first + i, rng.randbytes(rng.randint(50, 6000)))
           for i in range(n_put)]
    victims = rng.sample([k for _, k, _ in ops], n_del)
    ops += [("delete", k, None) for k in victims]
    return ops


def _cookie(key: int) -> int:
    return (key * 2654435761) & 0xFFFFFFFF


def _apply(upload_blob, delete, vid: int, url: str, ops) -> None:
    for op, key, data in ops:
        fid = str(FileId(vid, key, _cookie(key)))
        if op == "put":
            upload_blob(url, fid, data, filename="b.bin")
        else:
            delete(fid)


def _tail_bytes(url: str, vid: int, since_ns: int = 0) -> bytes:
    import urllib.request
    with urllib.request.urlopen(
            f"http://{url}/admin/tail?volume_id={vid}&since_ns={since_ns}",
            timeout=60) as r:
        return r.read()


def _frames(raw: bytes) -> list:
    out, off = [], 0
    while off < len(raw):
        n = int.from_bytes(raw[off:off + 4], "big")
        out.append(raw[off + 4:off + 4 + n])
        off += 4 + n
    assert off == len(raw)
    return out


@pytest.fixture()
def clusters(tmp_path, monkeypatch):
    """Both clusters with the same volume written under the same clock;
    yields {name: (cluster, client, vid, url)} and a function that
    applies more operations to both."""
    clock = _Clock()
    monkeypatch.setattr(pvolume, "time", clock.module())
    monkeypatch.setattr(rvolume, "time", clock.module())
    monkeypatch.setattr(pvs, "time", clock.module())
    monkeypatch.setattr(rvs, "time", clock.module())
    port = LocalCluster(1, coder_name="numpy", geometry=PG,
                        volume_size_limit_mb=64, pulse=0.15,
                        directory=str(tmp_path / "port"))
    ref = None
    try:
        ref = RCluster(1)
        out = {}
        for name, cl, client in (("port", port, PClient(port.master_url)),
                                 ("ref", ref, RClient(ref.master_url))):
            vid = client.grow(count=1, collection="bk")["volume_ids"][0]
            out[name] = (cl, client, vid, client.lookup(vid)[0])
        pclient = out["port"][1]

        def apply(ops):
            # the same clock sequence for each package: one clock each run
            start = clock.ns
            for name in ("port", "ref"):
                clock.ns = start
                _, client, vid, url = out[name]
                _apply(pclient.upload_blob, client.delete, vid, url, ops)
            return start

        yield out, apply
    finally:
        port.shutdown()
        if ref is not None:
            ref.shutdown()


def test_tail_frames_equal_reference(clusters):
    out, apply = clusters
    apply(_ops(1, 1, 80, 15))
    mid = apply(_ops(2, 500, 20, 5))
    streams = {}
    for name, (_, _, vid, url) in out.items():
        streams[name] = (_tail_bytes(url, vid), _tail_bytes(url, vid, mid))
    full, since = streams["port"]
    assert full == streams["ref"][0] and since == streams["ref"][1]
    assert len(_frames(full)) == 80 + 15 + 20 + 5
    assert len(_frames(since)) == 25


def test_incremental_backup_both_ways(clusters, tmp_path):
    """Round 1 pulls the whole volume, round 2 what came after: the
    port's tail into a reference volume, the reference's tail into a
    port volume. After round 1 the two replicas are the same bytes;
    after round 2 both hold the source's live set."""
    out, apply = clusters
    apply(_ops(3, 1, 60, 10))
    vp, vr = out["port"][2], out["ref"][2]
    dirs = {"r_from_p": tmp_path / "r_from_p",
            "p_from_r": tmp_path / "p_from_r"}
    applied = {k: [] for k in dirs}
    for ops in (None, _ops(4, 900, 25, 8)):
        if ops is not None:
            apply(ops)
        for key, d in dirs.items():
            vid = vp if key == "r_from_p" else vr
            os.makedirs(d, exist_ok=True)
            create = not (d / f"bk_{vid}.dat").exists()
            if key == "r_from_p":
                v = RVolume(str(d), "bk", vid, create=create)
                client = RClient(out["port"][0].master_url)
                n = rbackup.incremental_backup(
                    v, 0, lambda s: client.tail_volume(vid, s))
            else:
                v = PVolume(str(d), "bk", vid, create=create)
                client = PClient(out["ref"][0].master_url)
                n = pbackup.incremental_backup(
                    v, 0, lambda s: client.tail_volume(vid, s))
            applied[key].append(n)
            v.close()
        if ops is None:
            for ext in (".dat", ".idx"):
                a = (dirs["r_from_p"] / f"bk_{vp}{ext}").read_bytes()
                b = (dirs["p_from_r"] / f"bk_{vr}{ext}").read_bytes()
                assert a == b, ext
    # the round-1 replica ends in a delete: reopened, the reference's
    # volume has no last append time and pulls all 103 records again
    # (appending again the needles deleted since), the port's pulls the
    # 33 new ones (ROADMAP Queue 3, D10)
    assert applied["r_from_p"] == [70, 103]
    assert applied["p_from_r"] == [70, 33]
    src = out["port"][0].store(0).find_volume(vp)
    want = {k: src.read_needle(k).data for k, _ in src.nm.live_entries()}
    for key, vid in (("r_from_p", vp), ("p_from_r", vr)):
        rep = PVolume(str(dirs[key]), "bk", vid)
        try:
            assert {k: rep.read_needle(k).data
                    for k, _ in rep.nm.live_entries()} == want, key
        finally:
            rep.close()


def test_rebuild_idx_matches_reference(clusters, tmp_path):
    out, apply = clusters
    apply(_ops(5, 1, 50, 12))
    vid = out["port"][2]
    src = out["port"][0].store(0).find_volume(vid)
    src.sync()
    results = {}
    for name, mod in (("ref", rbackup), ("port", pbackup)):
        d = tmp_path / f"fix_{name}"
        d.mkdir()
        shutil.copyfile(src.base_file_name() + ".dat", d / f"bk_{vid}.dat")
        count = mod.rebuild_idx(str(d), "bk", vid)
        results[name] = (count, (d / f"bk_{vid}.idx").read_bytes())
    assert results["port"] == results["ref"]
    # the count is the reference's: records with a body the scan found
    # (the deleted needles' writes included), not the live needles
    assert results["port"][0] == 50
    # the rebuilt index serves the same live set as the source
    v = PVolume(str(tmp_path / "fix_port"), "bk", vid)
    try:
        assert v.nm.live_entries() == src.nm.live_entries()
    finally:
        v.close()


def _cli(*argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        pcli.main(list(argv))
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cli_backup_and_fix(tmp_path):
    cl = LocalCluster(1, coder_name="numpy", geometry=PG,
                      volume_size_limit_mb=64, pulse=0.15,
                      directory=str(tmp_path / "cl"),
                      store_kwargs={"needle_map_kind": "leveldb"})
    try:
        client = PClient(cl.master_url)
        rng = random.Random(9)
        fids = {}
        for _ in range(40):
            data = rng.randbytes(rng.randint(100, 5000))
            fids[client.upload(data, collection="c")] = data
        vid = int(next(iter(fids)).split(",")[0])
        d = str(tmp_path / "backup")
        args = ("backup", "-server", cl.master_url, "-dir", d,
                "-collection", "c", "-volumeId", str(vid))
        first = _cli(*args)
        assert first == {"volume": vid, "applied": 40, "file_count": 40}
        more = {}
        for _ in range(12):
            data = rng.randbytes(rng.randint(100, 5000))
            more[client.upload(data, collection="c")] = data
        gone = sorted(fids)[:5]
        for fid in gone:
            client.delete(fid)
        second = _cli(*args)
        assert second == {"volume": vid, "applied": 17, "file_count": 47}
        live = {**{f: b for f, b in fids.items() if f not in gone}, **more}
        os.remove(os.path.join(d, f"c_{vid}.idx"))
        fixed = _cli("fix", "-dir", d, "-collection", "c",
                     "-volumeId", str(vid))
        assert fixed == {"volume": vid, "live_needles": 52}
        v = PVolume(d, "c", vid)
        try:
            got = {}
            for fid in list(live) + gone:
                key = FileId.parse(fid).key
                try:
                    got[fid] = v.read_needle(key).data
                except KeyError:
                    pass
            assert got == live
        finally:
            v.close()
    finally:
        cl.shutdown()


@pytest.mark.parametrize("version_last", ["delete", "write"])
def test_last_append_time_after_reopen(tmp_path, version_last):
    """D10: reopened, a volume whose last record is a delete knows that
    record's append time in the port (upstream's
    verifyDeletedNeedleIntegrity) and 0 in the reference; after a write
    both know it."""
    from seaweedfs_torch.storage.needle import Needle as PNeedle
    from seaweedfs_tpu.storage.needle import Needle as RNeedle
    got = {}
    for name, vmod, needle in (("ref", RVolume, RNeedle),
                               ("port", PVolume, PNeedle)):
        d = str(tmp_path / name)
        os.makedirs(d)
        v = vmod(d, "", 1, create=True)
        for i in range(1, 6):
            v.write_needle(needle(cookie=i, id=i, data=b"x" * i))
        v.delete_needle(needle(cookie=2, id=2))
        if version_last == "write":
            v.write_needle(needle(cookie=9, id=9, data=b"last"))
        last = v.last_append_at_ns
        v.close()
        v = vmod(d, "", 1)
        got[name] = (last, v.last_append_at_ns)
        v.close()
    assert got["port"][1] == got["port"][0] > 0
    assert got["ref"][1] == (0 if version_last == "delete"
                             else got["ref"][0])
