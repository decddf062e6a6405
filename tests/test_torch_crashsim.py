"""The port's crash-simulation plane (seaweedfs_torch/crashsim) and the
durability of its writers, as the reference's tests/test_crashsim.py
holds the reference's.

Shim and replay mechanics (round trip, dropped or torn un-synced writes,
revocable renames), the negative control (the sweep flags a non-durable
writer), the sweep over the port's workloads with zero violations
(raft_snapshot, filer_kv and offset_commit beside the reference's),
torn-tail volume recovery, the disk.* fault points; then the port's own
seams (the EC fan-out's os.writev writer threads, a deferred close of a
pinned shard) and two cases against the reference: one op log replayed by
both packages' build_crash_state gives identical trees, and the port's EC
workloads at their defaults ack the reference's bytes.
`test_crc_mismatch_triggers_read_repair_from_replica` waits for the
volume server's read repair (ROADMAP Queue 1 A.4).
"""

import json
import os
import random
import shutil

import numpy as np
import pytest
import torch

from seaweedfs_torch import faults
from seaweedfs_torch.crashsim import (DiskRecorder, build_crash_state,
                                      harness, sweep)
from seaweedfs_torch.crashsim import workloads as wl
from seaweedfs_torch.crashsim.harness import AckLog, CrashWorkload
from seaweedfs_torch.ec import ec_volume as pecv
from seaweedfs_torch.ec import geometry as pgeo
from seaweedfs_torch.ec import pipeline as ppipe
from seaweedfs_torch.ec.coder import NumpyCoder
from seaweedfs_torch.storage.needle import CrcError, Needle
from seaweedfs_torch.storage.volume import Volume
from seaweedfs_torch.utils import durable
from seaweedfs_tpu.crashsim import DiskRecorder as RDiskRecorder
from seaweedfs_tpu.crashsim import build_crash_state as r_build_crash_state
from seaweedfs_tpu.crashsim import harness as rharness
from seaweedfs_tpu.crashsim import workloads as rwl
from seaweedfs_tpu.crashsim.harness import AckLog as RAckLog

torch.set_num_threads(1)

COOKIE = 0xBEEF


# ------------------------------------------------------ shim + replay

def _crash_tree(rec, crash, seed, dest):
    build_crash_state(rec.baseline, rec.ops, crash, random.Random(seed),
                      dest)


def _tree(root) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_shim_records_and_full_replay_roundtrips(tmp_path):
    root = tmp_path / "r"
    root.mkdir()
    (root / "base.txt").write_bytes(b"baseline")
    rec = DiskRecorder(str(root))
    with rec:
        with open(root / "a.bin", "wb") as f:
            f.write(b"hello ")
            f.write(b"world")
            f.flush()
            os.fsync(f.fileno())
        durable.write_atomic(str(root / "b.json"), b'{"k": 1}')
    kinds = [op.kind for op in rec.ops]
    assert "create" in kinds and "write" in kinds
    assert "fsync" in kinds and "rename" in kinds and "dirsync" in kinds
    # a crash after everything: every barrier passed, the tree is exact
    dest = tmp_path / "crash"
    _crash_tree(rec, len(rec.ops), 7, str(dest))
    assert (dest / "base.txt").read_bytes() == b"baseline"
    assert (dest / "a.bin").read_bytes() == b"hello world"
    assert (dest / "b.json").read_bytes() == b'{"k": 1}'


def test_unsynced_write_can_drop_or_tear(tmp_path):
    root = tmp_path / "r"
    root.mkdir()
    (root / "f.bin").write_bytes(b"S" * 1024)   # durable baseline
    rec = DiskRecorder(str(root))
    with rec:
        with open(root / "f.bin", "r+b") as f:
            f.seek(1024)
            f.write(b"U" * 2048)              # never fsynced
    outcomes = set()
    for seed in range(40):
        dest = tmp_path / f"c{seed}"
        _crash_tree(rec, len(rec.ops), seed, str(dest))
        got = (dest / "f.bin").read_bytes()
        assert got[:1024] == b"S" * 1024      # the synced prefix holds
        tail = got[1024:]
        if not tail:
            outcomes.add("dropped")
        elif tail == b"U" * 2048:
            outcomes.add("kept")
        else:
            outcomes.add("torn")
            assert len(tail) <= 2048
    assert {"dropped", "kept", "torn"} <= outcomes


def test_rename_without_dirsync_is_revocable_with_durable_it_is_not(
        tmp_path):
    root = tmp_path / "r"
    root.mkdir()
    (root / "live").write_bytes(b"old")
    rec = DiskRecorder(str(root))
    with rec:   # the bad recipe: fsync the file, rename, no dirsync
        with open(root / "live.tmp", "wb") as f:
            f.write(b"new")
            f.flush()
            os.fsync(f.fileno())
        os.replace(str(root / "live.tmp"), str(root / "live"))
    seen = set()
    for seed in range(30):
        dest = tmp_path / f"bad{seed}"
        _crash_tree(rec, len(rec.ops), seed, str(dest))
        seen.add((dest / "live").read_bytes())
    assert seen == {b"old", b"new"}           # revocable, never torn

    (root / "live").write_bytes(b"old")
    rec = DiskRecorder(str(root))
    with rec:   # the durable recipe: the rename survives every crash
        durable.write_atomic(str(root / "live"), b"new")
    for seed in range(30):
        dest = tmp_path / f"good{seed}"
        _crash_tree(rec, len(rec.ops), seed, str(dest))
        assert (dest / "live").read_bytes() == b"new"


def test_harness_flags_a_non_durable_writer():
    """Negative control: the sweep must detect a writer with no fsync, or
    every green sweep is vacuous."""

    def setup(root):
        pass

    def run(root, ack, rng):
        for i in range(1, 6):
            tmp = os.path.join(root, "pos.tmp")
            with open(tmp, "w") as f:
                json.dump({"v": i}, f)
            os.replace(tmp, os.path.join(root, "pos"))  # no fsyncs
            ack("pos", i)

    def recover(crash_dir):
        try:
            with open(os.path.join(crash_dir, "pos")) as f:
                return {"pos": json.load(f)["v"]}
        except (OSError, ValueError):
            return {}

    w = CrashWorkload("bad_writer", setup, run, recover)
    violations = 0
    for seed in range(1, 8):
        violations += len(sweep(w, seed=seed, points=25).violations)
    assert violations > 0


# ---------------------------------------------- the acceptance sweeps

def _stream_ec_workload():
    """ec_encode through the pipeline: _FanOut's writer threads append
    the shards with os.writev and the .ecm carries their digests."""
    return wl.make_ec_workload(encode=ppipe.stream_encode)


@pytest.mark.parametrize("make", [wl.make_volume_workload,
                                  wl.make_ec_workload,
                                  wl.make_fused_warmdown_workload,
                                  _stream_ec_workload,
                                  wl.make_group_commit_workload,
                                  wl.make_needle_map_workload,
                                  wl.make_filer_kv_workload],
                         ids=["volume_append", "ec_encode",
                              "fused_warmdown", "ec_encode_stream",
                              "volume_group_commit", "needle_map_flush",
                              "filer_kv"])
def test_subsystem_sweep_zero_violations(make):
    """Per-subsystem power-loss sweep: every acked write survives, no
    corrupt state loads silently, recovery converges."""
    workload = make()
    for seed in (1, 2):
        r = sweep(workload, seed=seed, points=17)
        assert r.points == 17
        assert r.ops > 0
        assert r.ok, "\n".join(f"crash@{c}: {m}" for c, m in r.violations)


def test_sweep_all_counts_points():
    summary = harness.sweep_all(seeds=1, points=3,
                                workload_names=["volume_append"])
    assert summary["ok"]
    assert summary["total_points"] == 3
    assert list(summary["workloads"]) == ["volume_append"]
    summary = harness.sweep_all(seeds=2, points=2)
    assert sorted(summary["workloads"]) == ["ec_encode", "filer_kv",
                                            "fused_warmdown",
                                            "needle_map_flush",
                                            "offset_commit",
                                            "raft_snapshot",
                                            "volume_append",
                                            "volume_group_commit"]
    assert summary["total_points"] == 32 and summary["ok"]


@pytest.mark.parametrize("package", ["reference", "port"])
def test_raft_snapshot_sweep_has_no_violations(package):
    """raft_snapshot (term, vote, log and the metadata log's snapshot
    folds, each save a barrier) at 2 seeds x 20 crash points: zero
    violations in the port, beside the reference's sweep of its own
    workload of that name."""
    run = harness if package == "port" else rharness
    summary = run.sweep_all(seeds=2, points=20,
                            workload_names=["raft_snapshot"])
    assert list(summary["workloads"]) == ["raft_snapshot"]
    assert summary["ok"], summary
    assert summary["total_points"] == 40
    assert summary["total_violations"] == 0


def test_crashsim_cli_json(capsys):
    from seaweedfs_torch.crashsim.__main__ import main
    assert main(["--seeds", "1", "--points", "2", "--workloads",
                 "ec_encode", "--json"]) == 0
    out = capsys.readouterr().out
    assert "crashsim: 2 crash points, 0 violations" in out
    assert main(["--points", "0"]) == 2
    assert main(["--workloads", "nope"]) == 2


# ------------------------------------------- the port's writer seams

def test_fanout_writev_threads_are_recorded(tmp_path):
    """stream_encode's shard writers (os.open + os.writev + os.fsync on
    their own threads) go through the patched functions: a full replay of
    the log rebuilds every shard and the marker byte for byte."""
    root = tmp_path / "r"
    root.mkdir()
    g = pgeo.Geometry(3, 2, large_block_size=8192, small_block_size=1024)
    with open(root / "7.dat", "wb") as f:
        f.write(np.random.default_rng(3).bytes(50_000))
    rec = DiskRecorder(str(root))
    with rec:
        ppipe.stream_encode(str(root / "7"), NumpyCoder(3, 2), g,
                            batch_size=1024)
    writes = {op.path for op in rec.ops if op.kind == "write"}
    assert {f"7{pgeo.to_ext(i)}" for i in range(5)} <= writes
    fsynced = {op.path for op in rec.ops if op.kind == "fsync"}
    assert {f"7{pgeo.to_ext(i)}" for i in range(5)} <= fsynced
    dest = tmp_path / "crash"
    _crash_tree(rec, len(rec.ops), 1, str(dest))
    assert _tree(dest) == _tree(root)


def test_fd_map_survives_a_deferred_shard_close(tmp_path):
    """An EC shard's descriptor closes only after its last pinned read;
    the deferred os.close still drops the fd from the recorder's map, so
    a file that reuses the fd number gets its own barrier."""
    root = tmp_path / "r"
    root.mkdir()
    (root / "1.ec00").write_bytes(b"s" * 4096)
    rec = DiskRecorder(str(root))
    with rec:
        shard = pecv.EcShard(str(root / "1"), 0)
        pin = shard._pin
        assert pin.enter()
        shard.close()                      # deferred: a read holds it
        fd = shard._fd
        assert rec._fds.get(fd) == "1.ec00"
        pin.exit()                         # the last read: closed now
        assert fd not in rec._fds
        with open(root / "other.bin", "wb") as f:
            f.write(b"x")
            os.fsync(f.fileno())
    syncs = [op.path for op in rec.ops if op.kind == "fsync"]
    assert syncs == ["other.bin"]


# ------------------------------------------- torn-tail volume recovery

def _fill_volume(vdir, n_synced=8, n_unsynced=3):
    v = Volume(str(vdir), "", 9, create=True)
    acked = {}
    for nid in range(1, n_synced + 1):
        data = bytes([nid]) * (500 + 37 * nid)
        v.write_needle(Needle(cookie=COOKIE, id=nid, data=data))
        acked[nid] = data
    v.sync()
    for nid in range(100, 100 + n_unsynced):
        v.write_needle(Needle(cookie=COOKIE, id=nid, data=b"x" * 700))
    return v, acked


def test_torn_dat_tail_recovery_byte_exact(tmp_path):
    v, acked = _fill_volume(tmp_path)
    base = v.base_file_name()
    with open(base + ".swm") as f:
        wm = json.load(f)["synced_size"]
    v.nm.close()
    v._dat.close()
    # tear the un-synced tail: chop mid-record and garbage the stump
    assert os.path.getsize(base + ".dat") > wm
    with open(base + ".dat", "r+b") as f:
        f.truncate(wm + 300)
        f.seek(wm + 120)
        f.write(bytes(range(180)))
    v2 = Volume(str(tmp_path), "", 9)
    assert v2.data_file_size() == wm
    for nid, data in acked.items():
        assert v2.read_needle(nid).data == data
    for nid in (100, 101, 102):
        with pytest.raises(KeyError):
            v2.read_needle(nid)
    v2.write_needle(Needle(cookie=COOKIE, id=200, data=b"after-crash"))
    v2.sync()
    v2.close()
    v3 = Volume(str(tmp_path), "", 9)
    assert v3.read_needle(200).data == b"after-crash"
    v3.close()


def test_torn_idx_tail_truncated_and_journal_validated(tmp_path):
    v, acked = _fill_volume(tmp_path, n_unsynced=0)
    base = v.base_file_name()
    v.close()
    with open(base + ".idx", "ab") as f:
        f.write(bytes(range(16)))   # a garbage entry (un-synced region)
        f.write(b"\xff" * 7)        # a torn partial entry
    v2 = Volume(str(tmp_path), "", 9)
    assert os.path.getsize(base + ".idx") % 16 == 0
    for nid, data in acked.items():
        assert v2.read_needle(nid).data == data
    assert len(v2.nm) == len(acked)
    v2.close()


def test_interrupted_compaction_rolls_forward_and_back(tmp_path):
    v, acked = _fill_volume(tmp_path, n_unsynced=0)
    v.delete_needle(Needle(cookie=COOKIE, id=1))
    del acked[1]
    v.sync()
    base = v.base_file_name()
    v.close()
    # (a) a crash before the swap: .cpd + .cpx left behind -> roll back
    with open(base + ".cpd", "wb") as f:
        f.write(b"partial compaction")
    with open(base + ".cpx", "wb") as f:
        f.write(b"partial index")
    v2 = Volume(str(tmp_path), "", 9)
    assert not os.path.exists(base + ".cpd")
    assert not os.path.exists(base + ".cpx")
    for nid, data in acked.items():
        assert v2.read_needle(nid).data == data
    v2.close()
    # (b) a crash between the two renames: the fresh .dat landed, the
    # .idx is still old, the fsynced .cpx waits -> roll forward
    v3 = Volume(str(tmp_path), "", 9)
    v3.begin_compact()
    shutil.copy(base + ".cpx", base + ".cpx.keep")
    v3.commit_compact()
    v3.close()
    with open(base + ".idx", "rb") as f:
        compacted_idx = f.read()
    os.replace(base + ".cpx.keep", base + ".cpx")
    with open(base + ".idx", "wb") as f:
        f.write(b"\0" * 16)
    os.remove(base + ".swm")
    v4 = Volume(str(tmp_path), "", 9)
    with open(base + ".idx", "rb") as f:
        assert f.read() == compacted_idx
    for nid, data in acked.items():
        assert v4.read_needle(nid).data == data
    v4.close()


def test_clean_shutdown_skips_recovery_scan(tmp_path):
    v, acked = _fill_volume(tmp_path, n_unsynced=2)
    base = v.base_file_name()
    v.close()    # the durability barrier acks everything, the tail too
    with open(base + ".swm") as f:
        wm = json.load(f)
    assert wm["synced_size"] == os.path.getsize(base + ".dat")
    assert wm["idx_synced_size"] == os.path.getsize(base + ".idx")
    v2 = Volume(str(tmp_path), "", 9)
    assert v2.read_needle(100).data == b"x" * 700
    v2.close()


# ------------------------------------------------ the disk fault points

def test_disk_fault_points_registered():
    assert "disk.write" in faults.KNOWN_POINTS
    assert "disk.sync" in faults.KNOWN_POINTS


def test_disk_sync_fault_crashes_at_the_barrier(tmp_path):
    v, _ = _fill_volume(tmp_path, n_synced=2, n_unsynced=0)
    faults.set_fault("disk.sync", "error", count=1)
    try:
        with pytest.raises(faults.FaultError):
            v.sync()
    finally:
        faults.clear("disk.sync")
        v.close()


def test_disk_write_corrupt_flips_stored_bytes(tmp_path):
    v = Volume(str(tmp_path), "", 3, create=True)
    faults.set_fault("disk.write", "corrupt", count=1, seed=5)
    try:
        v.write_needle(Needle(cookie=COOKIE, id=1, data=b"p" * 4000))
    finally:
        faults.clear("disk.write")
    with pytest.raises((CrcError, ValueError)):
        v.read_needle(1)
    v.nm.close()
    v._dat.close()


# ----------------------------------------------- against the reference

def test_both_replays_build_identical_trees(tmp_path):
    """One op log (the port's fused warm-down, recorded), replayed by both
    packages' build_crash_state at the same crash points and seeds, gives
    the same trees."""
    w = wl.make_fused_warmdown_workload()
    root = tmp_path / "record"
    root.mkdir()
    w.setup(str(root))
    rec = DiskRecorder(str(root))
    with rec:
        w.run(str(root), AckLog(rec), random.Random(1))
    rng = random.Random(99)
    points = [0, len(rec.ops)] + [rng.randrange(len(rec.ops) + 1)
                                  for _ in range(10)]
    for i, crash in enumerate(points):
        seed = (7 << 20) ^ (crash * 2654435761)
        mine, theirs = tmp_path / f"p{i}", tmp_path / f"r{i}"
        build_crash_state(rec.baseline, rec.ops, crash,
                          random.Random(seed), str(mine))
        r_build_crash_state(rec.baseline, rec.ops, crash,
                            random.Random(seed), str(theirs))
        assert _tree(mine) == _tree(theirs), crash


@pytest.mark.parametrize("package", ["reference", "port"])
def test_filer_kv_sweep_has_no_violations(package):
    """filer_kv (the filer's LevelDbStore: KV puts in its flushed WAL,
    each segment compaction a barrier) at 2 seeds x 20 crash points:
    zero violations in the port, beside the reference's sweep of its
    own workload of that name."""
    run = harness if package == "port" else rharness
    summary = run.sweep_all(seeds=2, points=20,
                            workload_names=["filer_kv"])
    assert list(summary["workloads"]) == ["filer_kv"]
    assert summary["ok"], summary
    assert summary["total_points"] == 40
    assert summary["total_violations"] == 0


@pytest.mark.parametrize("package", ["reference", "port"])
def test_offset_commit_sweep_has_no_violations(package):
    """offset_commit (a FileQueueInput's position and a Replicator's
    resume offset, each save a barrier) at 2 seeds x 20 crash points:
    zero violations in the port, beside the reference's sweep of its own
    workload of that name."""
    run = harness if package == "port" else rharness
    summary = run.sweep_all(seeds=2, points=20,
                            workload_names=["offset_commit"])
    assert list(summary["workloads"]) == ["offset_commit"]
    assert summary["ok"], summary
    assert summary["total_points"] == 40
    assert summary["total_violations"] == 0


@pytest.mark.parametrize("name", ["ec_encode", "fused_warmdown",
                                  "filer_kv", "offset_commit"])
def test_workloads_ack_the_reference_bytes(tmp_path, name):
    """The port's EC workloads at their defaults ack the reference's
    bytes: one source tree (the port's setup), copied, each package's run
    recorded by its own recorder on its copy; the acked (key, value)
    sequences are equal."""
    mine = {w.name: w for w in wl.registry()}[name]
    theirs = {w.name: w for w in rwl.registry()}[name]
    p_root, r_root = tmp_path / "p", tmp_path / "r"
    p_root.mkdir()
    mine.setup(str(p_root))
    shutil.copytree(p_root, r_root)
    acks = {}
    for w, root, recorder, acklog in ((mine, p_root, DiskRecorder, AckLog),
                                      (theirs, r_root, RDiskRecorder,
                                       RAckLog)):
        rec = recorder(str(root))
        log = acklog(rec)
        with rec:
            w.run(str(root), log, random.Random(1))
        acks[root.name] = [(key, value) for _m, _s, key, value in log.acks]
    assert acks["p"] == acks["r"]
    if name == "filer_kv":
        # every compacted watermark is acked, the WAL tail is not
        assert len(acks["p"]) == 13
    elif name == "offset_commit":
        # seven positions and seven resume offsets, alternating
        assert [k for k, _ in acks["p"]] == ["file_pos", "geo_since"] * 7
    else:
        assert any(key == "ecm" for key, _ in acks["p"])


def test_group_commit_log_replays_identically_in_both(tmp_path,
                                                      monkeypatch):
    """The group-commit workload: the port and the reference record the
    same acknowledgements and the same operation log (the append clock
    pinned, each run on its own copy of one setup), and both packages'
    build_crash_state make the same trees from the port's log."""
    state = {"t": 0}

    def time_ns():
        state["t"] += 1000
        return 1_700_000_000_000_000_000 + state["t"]

    monkeypatch.setattr("time.time_ns", time_ns)
    mine = wl.make_group_commit_workload()
    theirs = {w.name: w for w in rwl.registry()}["volume_group_commit"]
    p_root, r_root = tmp_path / "p", tmp_path / "r"
    p_root.mkdir()
    mine.setup(str(p_root))
    shutil.copytree(p_root, r_root)
    runs = {}
    for w, root, recorder, acklog in ((mine, p_root, DiskRecorder, AckLog),
                                      (theirs, r_root, RDiskRecorder,
                                       RAckLog)):
        state["t"] = 0
        rec = recorder(str(root))
        log = acklog(rec)
        with rec:
            w.run(str(root), log, random.Random(3))
        runs[root.name] = (rec, [(k, v) for _m, _s, k, v in log.acks])
    rec, acks = runs["p"]
    assert acks == runs["r"][1] and len(acks) > 3
    ops = [(op.kind, op.path, op.offset, op.data) for op in rec.ops]
    assert ops == [(op.kind, op.path, op.offset, op.data)
                   for op in runs["r"][0].ops]
    # one barrier per acknowledged group (four), one for the tail
    assert sum(op.kind == "fsync" for op in rec.ops) >= 5
    rng = random.Random(5)
    points = [0, len(rec.ops)] + [rng.randrange(len(rec.ops) + 1)
                                  for _ in range(12)]
    for i, crash in enumerate(points):
        seed = (9 << 20) ^ (crash * 2654435761)
        a, b = tmp_path / f"pa{i}", tmp_path / f"rb{i}"
        build_crash_state(rec.baseline, rec.ops, crash,
                          random.Random(seed), str(a))
        r_build_crash_state(rec.baseline, rec.ops, crash,
                            random.Random(seed), str(b))
        assert _tree(a) == _tree(b), crash
