"""The port's gRPC planes against the reference's.

Modelled on tests/test_grpc_plane.py: the master's Assign, Lookup,
Heartbeat stream, KeepConnected push and admin lease; the volume
server's unary admin surface, its CopyFile / VolumeTail /
VolumeEcShardRead streams and the degraded read's survivor fetch over
gRPC; the filer's entry CRUD, assignment, statistics and
SubscribeMetadata; ShardBits. The port's servers run in this process
(``LocalCluster(with_grpc=True)``, or ``use_grpc_heartbeat=True``).

Cross-wire: the tests that call the port's servers run once with each
package's stubs (the wire names are the reference's, letter for
letter); the port's stubs also call the reference's servers; the same
requests give equal response messages from both; and one seeded volume,
copied into a port and a reference volume server and driven over gRPC
(mount, EcShardsGenerate, EcShardRead, EcShardsDelete of {0, 3, 7, 12},
EcShardsRebuild), gives byte-equal shard reads and rebuilt shards on the
port's plain torch coder and the reference's numpy coder.

Left out: the reference's test_grpc_plane_enforces_ip_whitelist (the
port has no guard yet; ROADMAP Queue 1 A.3).
"""

import functools
import os
import shutil
import signal
import threading
import time

import grpc
import numpy as np
import pytest
import torch

from cluster_util import TEST_GEOMETRY, Cluster, free_port
from seaweedfs_torch import faults as pfaults
from seaweedfs_torch.client import Client as PClient
from seaweedfs_torch.ec import shard_bits as pbits
from seaweedfs_torch.pb import filer_pb2 as pfpb
from seaweedfs_torch.pb import master_pb2 as pmpb
from seaweedfs_torch.pb import rpc as prpc
from seaweedfs_torch.pb import volume_server_pb2 as pvpb
from seaweedfs_torch.server.local_cluster import LocalCluster
from seaweedfs_torch.shell.ec_commands import EcCommands as PEcCommands
from seaweedfs_torch.storage.needle import Needle as PNeedle
from seaweedfs_torch.storage.store import Store as PStore
from seaweedfs_tpu.ec import shard_bits as rbits
from seaweedfs_tpu.pb import master_pb2 as rmpb
from seaweedfs_tpu.pb import rpc as rrpc

torch.set_num_threads(1)

NO_REPAIR = {"repair_enabled": False}
# each package's client stubs
STUBS = {"port": prpc, "reference": rrpc}
LOST = (0, 3, 7, 12)


def within(seconds: int):
    """Fail the test with TimeoutError after `seconds`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            def fire(signum, frame):
                raise TimeoutError(f"{fn.__name__}: over {seconds} s")

            old = signal.signal(signal.SIGALRM, fire)
            signal.alarm(seconds)
            try:
                return fn(*args, **kwargs)
            finally:
                signal.alarm(0)
                signal.signal(signal.SIGALRM, old)
        return wrapper
    return deco


def _wait(pred, timeout: float = 10.0, what: str = "condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise TimeoutError(what)
        time.sleep(0.05)


def _grpc(url: str) -> str:
    return prpc.grpc_address(url)


# --- ShardBits ---

@pytest.mark.parametrize("seed", range(4))
def test_shard_bits_algebra_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        a = [int(i) for i in rng.choice(14, rng.integers(0, 15), False)]
        b = [int(i) for i in rng.choice(14, rng.integers(0, 15), False)]
        pa, pb_ = pbits.from_ids(a), pbits.from_ids(b)
        assert pa == rbits.from_ids(a) and pb_ == rbits.from_ids(b)
        assert pbits.to_ids(pa) == rbits.to_ids(pa) == sorted(a)
        for op in ("plus", "minus"):
            assert getattr(pbits, op)(pa, pb_) == getattr(rbits, op)(pa, pb_)
        assert pbits.minus_parity_shards(pa, 10) == \
            rbits.minus_parity_shards(pa, 10)
        assert pbits.count(pa) == rbits.count(pa) == len(a)


def test_rpc_tables_match_reference():
    """The wire names, the RPC kinds and message types, and the retry
    rule are the reference's."""
    for name in ("MASTER", "VOLUME", "FILER", "MESSAGING"):
        assert getattr(prpc, f"{name}_SERVICE") == \
            getattr(rrpc, f"{name}_SERVICE")
        pspec, rspec = (getattr(m, f"{name}_SPEC") for m in (prpc, rrpc))
        assert {k: (v[0], v[1].DESCRIPTOR.full_name,
                    v[2].DESCRIPTOR.full_name) for k, v in pspec.items()} \
            == {k: (v[0], v[1].DESCRIPTOR.full_name,
                    v[2].DESCRIPTOR.full_name) for k, v in rspec.items()}
    assert prpc._RETRYABLE_RPCS == rrpc._RETRYABLE_RPCS
    for destructive in ("VolumeEcShardsDelete", "VacuumVolumeCommit",
                        "VolumeDelete"):
        assert destructive not in prpc._RETRYABLE_RPCS
    assert prpc.grpc_address("10.0.0.1:8080") == \
        rrpc.grpc_address("10.0.0.1:8080") == "10.0.0.1:18080"
    # one descriptor pool: the generated modules are the reference's bytes
    assert pmpb.AssignRequest is rmpb.AssignRequest


# --- the master ---

@pytest.fixture(scope="module")
def mcluster():
    c = LocalCluster(1, coder_name="numpy", geometry=TEST_GEOMETRY,
                     volume_size_limit_mb=1, pulse=0.15,
                     use_grpc_heartbeat=True)
    c.client = PClient(c.master_url)
    c.grpc_target = _grpc(c.master_url)
    yield c
    c.shutdown()


@within(60)
def test_grpc_heartbeat_registers_node(mcluster):
    c = mcluster
    _wait(lambda: c.node_count() == 1, what="the node")
    nodes = list(c.master.topology.nodes.values())
    assert [n.url for n in nodes] == [c.url(0)]
    assert c.nodes[0][0].use_grpc_heartbeat


@pytest.mark.parametrize("stubs", STUBS)
@within(60)
def test_grpc_assign_and_lookup(mcluster, stubs):
    c = mcluster
    with grpc.insecure_channel(c.grpc_target) as ch:
        stub = STUBS[stubs].MasterStub(ch)
        a = stub.Assign(pmpb.AssignRequest(count=1))
        assert a.error == "", a.error
        assert a.fid and a.url
        vid = int(a.fid.split(",")[0])
        lk = stub.Lookup(pmpb.LookupRequest(volume_id=vid))
        assert [loc.url for loc in lk.locations] == [a.url]
        by_fid = stub.Lookup(pmpb.LookupRequest(file_id=a.fid))
        assert by_fid.volume_id == vid
        assert stub.Lookup(pmpb.LookupRequest(volume_id=9999)).error
        assert stub.Lookup(pmpb.LookupRequest(file_id="bad")).error
        st = stub.ClusterStatus(pmpb.ClusterStatusRequest())
        assert st.is_leader and st.leader == c.master_url


def _keepconnected(c, stub):
    fid = c.client.upload(b"grpc-push")
    vid = int(fid.split(",")[0])
    _wait(lambda: any(vid in n.volumes
                      for n in c.master.topology.nodes.values()))
    stream = stub.KeepConnected(
        pmpb.KeepConnectedRequest(client_name="test"), timeout=20)
    first = next(stream)
    assert first.is_snapshot and vid in first.new_vids
    assert first.leader == c.master_url
    threading.Thread(target=lambda: c.client.grow(1), daemon=True).start()
    delta = set()
    for msg in stream:
        if not msg.is_snapshot and msg.new_vids:
            delta.update(msg.new_vids)
            assert msg.leader == c.master_url
            break
    stream.cancel()
    return delta


@pytest.mark.parametrize("stubs", STUBS)
@within(60)
def test_grpc_keepconnected_snapshot_and_delta(mcluster, stubs):
    with grpc.insecure_channel(mcluster.grpc_target) as ch:
        delta = _keepconnected(mcluster, STUBS[stubs].MasterStub(ch))
    assert delta, "no delta pushed after growth"


@pytest.mark.parametrize("stubs", STUBS)
@within(60)
def test_grpc_admin_lease(mcluster, stubs):
    with grpc.insecure_channel(mcluster.grpc_target) as ch:
        stub = STUBS[stubs].MasterStub(ch)
        name = f"locktest-{stubs}"
        lease = stub.LeaseAdminToken(
            pmpb.LeaseAdminTokenRequest(name=name, client="t1"))
        assert lease.token and not lease.error
        other = stub.LeaseAdminToken(
            pmpb.LeaseAdminTokenRequest(name=name, client="t2"))
        assert other.error
        renew = stub.LeaseAdminToken(pmpb.LeaseAdminTokenRequest(
            name=name, client="t1", previous_token=lease.token))
        assert renew.token == lease.token
        rel = stub.ReleaseAdminToken(
            pmpb.ReleaseAdminTokenRequest(name=name, token=lease.token))
        assert rel.ok


@within(60)
def test_grpc_heartbeat_disconnect_unregisters(mcluster):
    """Dropping the stream unregisters the node at once
    (master_grpc_server.go:22-49), long before the pulse prune."""
    c = mcluster
    _wait(lambda: c.node_count() == 1)
    c.master.topology.pulse_seconds = 60.0     # no prune in this test
    try:
        c.stop_volume_server(0)
        _wait(lambda: c.node_count() == 0, timeout=5,
              what="unregistered on stream loss")
    finally:
        c.master.topology.pulse_seconds = 0.15


@pytest.mark.parametrize("stubs", STUBS)
@within(60)
def test_grpc_master_admin_surface(mcluster, stubs):
    """VolumeList, Statistics, CollectionList, GetMasterConfiguration
    and CollectionDelete (weed/pb/master.proto:18-30)."""
    c = mcluster
    if c.node_count() == 0:
        c.add_volume_server()
        c.wait_for_nodes(1)
    c.client.upload(b"adm-surface")
    fid = c.client.upload(b"doomed", collection=f"gone{stubs}")
    vid = int(fid.split(",")[0])
    _wait(lambda: any(v.file_count for n in c.master.topology.nodes.values()
                      for v in n.volumes.values()))
    _wait(lambda: any(vid in n.volumes
                      for n in c.master.topology.nodes.values()))
    with grpc.insecure_channel(c.grpc_target) as ch:
        stub = STUBS[stubs].MasterStub(ch)
        vl = stub.VolumeList(pmpb.VolumeListRequest())
        assert vl.volume_size_limit_mb == 1
        assert len(vl.nodes) == 1 and vl.nodes[0].volumes
        st = stub.Statistics(pmpb.StatisticsRequest())
        assert st.total_size > 0 and st.file_count >= 1
        cl = stub.CollectionList(pmpb.CollectionListRequest())
        assert {"", f"gone{stubs}"} <= set(cl.collections)
        cfg = stub.GetMasterConfiguration(
            pmpb.GetMasterConfigurationRequest())
        assert cfg.volume_size_limit_mb == vl.volume_size_limit_mb
        assert cfg.garbage_threshold == pytest.approx(0.3)
        refused = stub.CollectionDelete(pmpb.CollectionDeleteRequest())
        assert not refused.ok and "required" in refused.error
        gone = stub.CollectionDelete(
            pmpb.CollectionDeleteRequest(name=f"gone{stubs}"))
        assert gone.ok, gone.error
    assert c.store(len(c.nodes) - 1).find_volume(vid) is None


@within(60)
def test_grpc_heartbeat_heat_rides_the_side_channel():
    """A gRPC-heartbeat node's heat deltas reach the master over
    /vol/heat/report (the message has no heat field); the master's gRPC
    port is an explicit one, not the HTTP port + 10000."""
    c = LocalCluster(1, coder_name="numpy", geometry=TEST_GEOMETRY,
                     volume_size_limit_mb=1, pulse=0.15,
                     use_grpc_heartbeat=True, master_grpc_port=free_port())
    try:
        vs = c.nodes[0][0]
        reports = []
        orig = vs._report_heat

        async def report() -> None:
            # called only between the gRPC stream's beats
            reports.append(1)
            await orig()

        vs._report_heat = report
        client = PClient(c.master_url)
        fid = client.upload(b"grpc-heat" * 64)
        vid = int(fid.split(",")[0])
        assert client.download(fid) == b"grpc-heat" * 64
        _wait(lambda: c.master.topology.heat_view().get(vid, {}).get(
            "reads", 0) >= 1, timeout=15,
            what="heat deltas via /vol/heat/report")
        assert reports, "the gRPC beats never ran"
    finally:
        c.shutdown()


@within(60)
def test_grpc_fault_points_gate_each_rpc(mcluster):
    """``rpc.<Method>``: a drop answers UNAVAILABLE (and a retryable
    RPC is retried through it), an error INTERNAL."""
    with grpc.insecure_channel(mcluster.grpc_target) as ch:
        stub = prpc.MasterStub(ch)
        try:
            pfaults.set_fault("rpc.ClusterStatus", "drop", count=1)
            assert stub.ClusterStatus(pmpb.ClusterStatusRequest()).is_leader
            pfaults.set_fault("rpc.ReleaseAdminToken", "drop", count=1)
            with pytest.raises(grpc.RpcError) as e:
                stub.ReleaseAdminToken(pmpb.ReleaseAdminTokenRequest())
            assert e.value.code() == grpc.StatusCode.UNAVAILABLE
            pfaults.set_fault("rpc.VolumeList", "error", count=1)
            with pytest.raises(grpc.RpcError) as e:
                stub.VolumeList(pmpb.VolumeListRequest())
            assert e.value.code() == grpc.StatusCode.INTERNAL
        finally:
            pfaults.clear()


@within(60)
def test_grpc_keepconnected_follower_answers_the_leader(tmp_path):
    """A follower's KeepConnected names the leader and ends; its
    Heartbeat answers carry the leader hint a volume server follows."""
    c = LocalCluster(1, coder_name="numpy", geometry=TEST_GEOMETRY,
                     volume_size_limit_mb=1, pulse=0.15, n_masters=3,
                     with_grpc=True, use_grpc_heartbeat=True,
                     master_kwargs={"election_timeout": (0.15, 0.3),
                                    "raft_heartbeat": 0.05})
    try:
        leader = c.wait_for_leader()
        follower = next(m for m in c.masters if m is not leader)
        with grpc.insecure_channel(_grpc(follower.url)) as ch:
            msgs = list(prpc.MasterStub(ch).KeepConnected(
                pmpb.KeepConnectedRequest(client_name="t"), timeout=10))
        assert [(m.leader, m.is_snapshot) for m in msgs] == \
            [(leader.url, False)]
        _wait(lambda: len(leader.topology.nodes) == 1, timeout=15)
        assert c.nodes[0][0].master_url == leader.url
    finally:
        c.shutdown()


@within(120)
def test_grpc_heartbeats_follow_a_new_leader_and_reads_survive():
    """Volume servers on gRPC heartbeats lose their stream with the
    leader, fall back to HTTP, follow the new leader's hint and redial
    its gRPC port; degraded reads of an EC volume with 4 shards lost go
    on through the election (D28's wait and the D21/D24 map rules stay
    as they are)."""
    c = LocalCluster(4, coder_name="numpy", geometry=TEST_GEOMETRY,
                     volume_size_limit_mb=1, pulse=0.15, n_masters=3,
                     use_grpc_heartbeat=True,
                     master_kwargs={"election_timeout": (0.15, 0.3),
                                    "raft_heartbeat": 0.05,
                                    "repair_enabled": False})
    try:
        client = PClient(c.master_url)
        rng = np.random.default_rng(8)
        fids = {client.upload(rng.bytes(3000 + 100 * i),
                              collection="ha"): None for i in range(6)}
        fids = {f: client.download(f) for f in fids}
        vid = int(next(iter(fids)).split(",")[0])
        fids = {f: d for f, d in fids.items()
                if int(f.split(",")[0]) == vid}
        PEcCommands(client, TEST_GEOMETRY).encode(vid, "ha", apply=True)
        for sid in LOST:
            h = _holder(c, vid, sid)
            c.store(h).ec_delete_shards(vid, "ha", [sid])
        old = c.wait_for_leader()
        c.stop_master(c.masters.index(old))
        new = c.wait_for_leader(exclude=(old,))
        _wait(lambda: len(new.topology.nodes) == 4
              and all(c.nodes[i][0].master_url == new.url
                      for i in range(4)), timeout=30,
              what="every volume server beating to the new leader")
        for fid, data in fids.items():
            assert client.download(fid) == data
        assert all(c.nodes[i][0].use_grpc_heartbeat for i in range(4))
    finally:
        c.shutdown()


# --- the volume server ---

@pytest.fixture(scope="module")
def vcluster():
    c = LocalCluster(1, coder_name="torch", device="cpu",
                     geometry=TEST_GEOMETRY, volume_size_limit_mb=1,
                     pulse=0.15, with_grpc=True, master_kwargs=NO_REPAIR)
    c.client = PClient(c.master_url)
    yield c
    c.shutdown()


@pytest.mark.parametrize("stubs", STUBS)
@within(60)
def test_grpc_volume_service_lifecycle(vcluster, stubs):
    """Status, needle status, batch delete, read-only and writable, the
    vacuum check, allocate and delete: the unary admin surface."""
    c = vcluster
    data = b"grpc-volume-payload " * 10
    fid = c.client.upload(data, collection=f"life{stubs}")
    vid = int(fid.split(",")[0])
    store = c.store(0)
    _wait(lambda: store.find_volume(vid) is not None)
    key = int(fid.split(",")[1][:-8], 16)
    with grpc.insecure_channel(_grpc(c.url(0))) as ch:
        stub = STUBS[stubs].VolumeServerStub(ch)
        st = stub.VolumeStatus(pvpb.VolumeRef(volume_id=vid))
        assert st.error == "" and st.file_count == 1
        ns = stub.VolumeNeedleStatus(pvpb.NeedleStatusRequest(
            volume_id=vid, needle_id=key))
        assert ns.error == "" and ns.size == len(data)
        vc = stub.VacuumVolumeCheck(pvpb.VolumeRef(volume_id=vid))
        assert vc.error == "" and vc.garbage_ratio == 0.0
        assert stub.VolumeMarkReadonly(pvpb.VolumeRef(volume_id=vid)).ok
        assert store.find_volume(vid).read_only
        assert stub.VolumeMarkWritable(pvpb.VolumeRef(volume_id=vid)).ok
        assert not store.find_volume(vid).read_only
        bd = stub.BatchDelete(pvpb.BatchDeleteRequest(fids=[fid]))
        assert bd.results[0].error == "" and bd.results[0].size > 0
        srv = stub.VolumeServerStatus(pvpb.Empty())
        assert srv.volume_count >= 1 and srv.disk_statuses
        fst = stub.ReadVolumeFileStatus(pvpb.VolumeRef(volume_id=vid))
        assert fst.error == "" and fst.dat_file_size > 0
        new = 900 + len(stubs)
        assert stub.AllocateVolume(pvpb.AllocateVolumeRequest(
            volume_id=new, collection="alloc")).ok
        assert store.find_volume(new) is not None
        assert stub.VolumeDelete(pvpb.VolumeRef(volume_id=new)).ok
        assert store.find_volume(new) is None
        assert not stub.VolumeDelete(pvpb.VolumeRef(volume_id=new)).ok


@pytest.mark.parametrize("stubs", STUBS)
@within(60)
def test_grpc_copyfile_and_tail_streams(vcluster, stubs):
    """CopyFile streams the raw .dat; VolumeTail streams needle records
    (volume_grpc_copy.go / volume_grpc_tail.go)."""
    c = vcluster
    payload = f"tail-me-{stubs} ".encode() * 64
    fid = c.client.upload(payload, collection=f"tail{stubs}")
    vid = int(fid.split(",")[0])
    v = c.store(0).find_volume(vid)
    with grpc.insecure_channel(_grpc(c.url(0))) as ch:
        stub = STUBS[stubs].VolumeServerStub(ch)
        buf = bytearray()
        for chunk in stub.CopyFile(pvpb.CopyFileRequest(
                volume_id=vid, collection=f"tail{stubs}", ext=".dat")):
            assert chunk.error == "", chunk.error
            buf += chunk.data
            if chunk.is_last:
                break
        with open(v.base_file_name() + ".dat", "rb") as f:
            assert bytes(buf) == f.read()
        records = []
        for chunk in stub.VolumeTail(pvpb.TailRequest(volume_id=vid)):
            assert chunk.error == "", chunk.error
            if chunk.is_last:
                break
            records.append(bytes(chunk.data))
    needles = [PNeedle.from_bytes(r, v.version) for r in records]
    assert any(n.data == payload for n in needles)


@pytest.mark.parametrize("stubs", STUBS)
@within(60)
def test_grpc_copyfile_rejects_traversal(vcluster, stubs):
    """A crafted collection must not escape the data directory."""
    with grpc.insecure_channel(_grpc(vcluster.url(0))) as ch:
        stub = STUBS[stubs].VolumeServerStub(ch)
        chunks = list(stub.CopyFile(pvpb.CopyFileRequest(
            volume_id=1, collection="../../../etc", ext=".conf")))
        assert chunks[0].error and chunks[0].is_last
        ok = stub.VolumeCopy(pvpb.VolumeCopyRequest(
            volume_id=77, collection="../esc",
            source_data_node="127.0.0.1:1"))
        assert not ok.ok and "collection" in ok.error


@within(60)
def test_grpc_volume_copy_and_tail_receiver(vcluster):
    """VolumeCopy pulls a whole volume over the source's CopyFile stream;
    VolumeTailReceiver appends what the source gained since."""
    c = vcluster
    if len(c.nodes) < 2:
        c.add_volume_server()
        c.wait_for_nodes(2)
    fid = c.client.upload(b"copy-me" * 100, collection="copied")
    vid = int(fid.split(",")[0])
    src = next(i for i in range(len(c.nodes))
               if c.store(i).find_volume(vid) is not None)
    dst = 1 - src
    with grpc.insecure_channel(_grpc(c.url(dst))) as ch:
        stub = prpc.VolumeServerStub(ch)
        ok = stub.VolumeCopy(pvpb.VolumeCopyRequest(
            volume_id=vid, collection="copied",
            source_data_node=c.url(src)))
        assert ok.ok, ok.error
        copy = c.store(dst).find_volume(vid)
        assert copy.read_needle(int(fid.split(",")[1][:-8], 16)).data == \
            b"copy-me" * 100
        since = copy.last_append_at_ns
        more = c.client.upload_blob(c.url(src), f"{vid},{'ab' * 4}00000001",
                                    b"later")
        assert more
        ok = stub.VolumeTailReceiver(pvpb.TailReceiverRequest(
            volume_id=vid, since_ns=since, source_volume_server=c.url(src)))
        assert ok.ok, ok.error
    assert copy.file_count() == 2


@pytest.fixture(scope="module")
def eccluster():
    """Four gRPC volume servers (the kernels' plain versions): shards
    spread, a seeded collection encoded through the shell."""
    c = LocalCluster(4, coder_name="torch", device="cpu",
                     geometry=TEST_GEOMETRY, volume_size_limit_mb=1,
                     pulse=0.15, with_grpc=True, master_kwargs=NO_REPAIR)
    c.client = PClient(c.master_url)
    rng = np.random.default_rng(5)
    c.fids = {}
    for i in range(8):
        data = rng.bytes(2048 + 512 * i)
        c.fids[c.client.upload(data, collection="gec")] = data
    c.vid = int(next(iter(c.fids)).split(",")[0])
    c.fids = {f: d for f, d in c.fids.items()
              if int(f.split(",")[0]) == c.vid}
    _wait(lambda: any(c.store(i).find_volume(c.vid) is not None
                      and c.store(i).find_volume(c.vid).file_count()
                      == len(c.fids) for i in range(4)))
    PEcCommands(c.client, TEST_GEOMETRY).encode(c.vid, "gec", apply=True)
    yield c
    c.shutdown()


def _holder(c, vid, sid):
    return next(i for i in range(len(c.nodes))
                if c.store(i).find_ec_volume(vid) is not None
                and sid in c.store(i).find_ec_volume(vid).shards)


@pytest.mark.parametrize("stubs", STUBS)
@within(90)
def test_grpc_ec_shard_read_and_degraded_read(eccluster, stubs):
    """A shard range read over VolumeEcShardRead equals the holder's
    file; degraded reads fetch every survivor over gRPC, never over
    /admin/ec/shard_read."""
    c = eccluster
    h = _holder(c, c.vid, 1)
    local = c.store(h).ec_shard_read(c.vid, 1, 0, 512)
    with grpc.insecure_channel(_grpc(c.url(h))) as ch:
        stub = STUBS[stubs].VolumeServerStub(ch)
        buf = bytearray()
        for chunk in stub.VolumeEcShardRead(pvpb.EcShardReadRequest(
                volume_id=c.vid, shard_id=1, offset=0, size=512)):
            assert chunk.error == "", chunk.error
            buf += chunk.data
        assert bytes(buf) == local
        past = list(stub.VolumeEcShardRead(pvpb.EcShardReadRequest(
            volume_id=c.vid, shard_id=1, offset=1 << 30, size=16)))
        assert past[-1].is_last and "short read" in past[-1].error
    before = {i: c.nodes[i][0].metrics.value(
        "ec_shard_fetch", {"route": r}) for i in range(4)
        for r in ("grpc", "http")}
    c.client._vid_cache.clear()
    for fid, data in c.fids.items():
        assert c.client.download(fid) == data
    grpc_n = sum(c.nodes[i][0].metrics.value(
        "ec_shard_fetch", {"route": "grpc"}) for i in range(4))
    http_n = sum(c.nodes[i][0].metrics.value(
        "ec_shard_fetch", {"route": "http"}) for i in range(4))
    assert grpc_n > sum(v for k, v in before.items())
    assert http_n == 0


@within(90)
def test_grpc_degraded_read_falls_back_to_http_without_a_grpc_port(
        eccluster):
    """The survivor reader fetches over gRPC; a peer whose gRPC port
    failed is read over /admin/ec/shard_read for a while; the bytes are
    the holder's either way."""
    c = eccluster
    reader = c.nodes[0][0]
    ev = c.store(0).find_ec_volume(c.vid)
    sid = next(s for s in range(14) if s not in ev.shards)
    h = _holder(c, c.vid, sid)
    want = c.store(h).ec_shard_read(c.vid, sid, 100, 700)
    read = reader._make_shard_reader(ev)

    def count(route):
        return reader.metrics.value("ec_shard_fetch", {"route": route})

    g0, h0 = count("grpc"), count("http")
    assert read(sid, 100, 700) == want
    assert (count("grpc"), count("http")) == (g0 + 1, h0)
    try:
        reader._peer_grpc_dead[c.url(h)] = time.time() + 60
        assert read(sid, 100, 700) == want
        assert (count("grpc"), count("http")) == (g0 + 1, h0 + 1)
    finally:
        reader._peer_grpc_dead.clear()


@within(120)
def test_grpc_ec_lost_shards_rebuild_bit_exact_against_reference(tmp_path):
    """One seeded volume, copied into a port volume server (plain torch
    coder) and a reference one (numpy coder), each driven over gRPC by
    the other package's stubs: EcShardsGenerate, EcShardRead of every
    shard, EcShardsDelete of {0, 3, 7, 12}, EcShardsRebuild: reads and
    rebuilt shard files byte-equal."""
    src = tmp_path / "src"
    src.mkdir()
    st = PStore([str(src)], coder_name="numpy", geometry=TEST_GEOMETRY)
    st.add_volume(7, collection="bx")
    rng = np.random.default_rng(21)
    for nid in range(1, 120):
        st.write_needle(7, PNeedle(cookie=nid * 31, id=nid,
                                   data=rng.bytes(int(rng.integers(
                                       100, 9000)))))
    st.close()
    pc = LocalCluster(1, coder_name="torch", device="cpu",
                      geometry=TEST_GEOMETRY, volume_size_limit_mb=64,
                      pulse=0.15, with_grpc=True, master_kwargs=NO_REPAIR)
    rc = Cluster(n_volume_servers=0, coder_name="numpy")
    rc.master.repair_enabled = False
    try:
        rvs = rc.add_volume_server(with_grpc=True)
        sides = {"port": (pc.nodes[0][3], _grpc(pc.url(0)), rrpc),
                 "reference": (rvs.store.locations[0].directory,
                               f"127.0.0.1:{rvs.grpc_port}", prpc)}
        out = {}
        for side, (d, target, stubs) in sides.items():
            for name in os.listdir(src):
                shutil.copy(src / name, os.path.join(d, name))
            with grpc.insecure_channel(target) as ch:
                stub = stubs.VolumeServerStub(ch)
                ref = pvpb.VolumeRef(volume_id=7, collection="bx")
                assert stub.VolumeMount(ref).ok
                assert stub.VolumeEcShardsGenerate(pvpb.EcGenerateRequest(
                    volume_id=7, collection="bx")).ok
                assert stub.VolumeEcShardsMount(pvpb.EcShardsRequest(
                    volume_id=7, collection="bx",
                    shard_ids=list(range(14)))).ok
                reads = []
                for sid in range(14):
                    reads.append(b"".join(
                        ch_.data for ch_ in stub.VolumeEcShardRead(
                            pvpb.EcShardReadRequest(volume_id=7,
                                                    shard_id=sid,
                                                    offset=1000,
                                                    size=5000))))
                assert stub.VolumeEcShardsDelete(pvpb.EcShardsRequest(
                    volume_id=7, collection="bx", shard_ids=LOST)).ok
                rb = stub.VolumeEcShardsRebuild(pvpb.EcRebuildRequest(
                    volume_id=7, collection="bx"))
                assert rb.error == "" and sorted(rb.rebuilt_shard_ids) == \
                    list(LOST)
            files = {}
            for sid in range(14):
                with open(os.path.join(d, f"bx_7.ec{sid:02d}"), "rb") as f:
                    files[sid] = f.read()
            out[side] = (reads, files)
        assert out["port"][0] == out["reference"][0]
        assert all(len(r) == 5000 for r in out["port"][0])
        assert out["port"][1] == out["reference"][1]
    finally:
        rc.shutdown()
        pc.shutdown()


# --- cross-wire: the port's stubs on the reference's servers, and equal
#     answers from both ---

@pytest.fixture(scope="module")
def pair():
    """A reference cluster and a port cluster, each master with one
    gRPC-heartbeat volume server, a volume of one needle on each."""
    rport = free_port()
    rc = Cluster(n_volume_servers=0, master_grpc_port=rport)
    rc.add_volume_server(use_grpc_heartbeat=True, with_grpc=True)
    rc.wait_for_nodes(1)
    pc = LocalCluster(1, coder_name="numpy", geometry=TEST_GEOMETRY,
                      volume_size_limit_mb=1, pulse=0.15,
                      use_grpc_heartbeat=True)
    out = {"reference": {"master": f"127.0.0.1:{rport}",
                         "volume": (f"127.0.0.1:"
                                    f"{rc.volume_servers[0].grpc_port}"),
                         "cluster": rc, "client": rc.client},
           "port": {"master": _grpc(pc.master_url),
                    "volume": _grpc(pc.url(0)), "cluster": pc,
                    "client": PClient(pc.master_url)}}
    for side in out.values():
        fid = side["client"].upload(b"same" * 50, collection="eq")
        side["vid"] = int(fid.split(",")[0])
        side["key"] = int(fid.split(",")[1][:-8], 16)
    yield out
    rc.shutdown()
    pc.shutdown()


@within(60)
def test_port_stubs_drive_the_reference_servers(pair):
    ref = pair["reference"]
    with grpc.insecure_channel(ref["master"]) as ch:
        stub = prpc.MasterStub(ch)
        a = stub.Assign(pmpb.AssignRequest(count=1))
        assert a.error == "" and a.fid
        lk = stub.Lookup(pmpb.LookupRequest(volume_id=ref["vid"]))
        assert lk.locations and not lk.error
        assert stub.ClusterStatus(pmpb.ClusterStatusRequest()).is_leader
        stream = stub.KeepConnected(pmpb.KeepConnectedRequest(), timeout=10)
        first = next(stream)
        stream.cancel()
        assert first.is_snapshot and ref["vid"] in first.new_vids
    with grpc.insecure_channel(ref["volume"]) as ch:
        stub = prpc.VolumeServerStub(ch)
        st = stub.VolumeStatus(pvpb.VolumeRef(volume_id=ref["vid"]))
        assert st.error == "" and st.file_count == 1
        data = b"".join(c.data for c in stub.CopyFile(pvpb.CopyFileRequest(
            volume_id=ref["vid"], collection="eq", ext=".idx")))
        assert len(data) == 16


def _normalized(msg):
    """A response message's fields, apart from those that name a node
    or hold a size that depends on append times."""
    d = {f.name: v for f, v in msg.ListFields()}
    for key in ("url", "public_url", "leader", "peers", "fid", "dir",
                "disk_statuses", "version", "volume_size", "all", "used",
                "free", "dat_file_size", "last_modified", "expires_at",
                "cookie",
                "token", "raft_term"):
        d.pop(key, None)
    return d


REQUESTS = [
    ("master", "Lookup", lambda s: pmpb.LookupRequest(volume_id=9999)),
    ("master", "Lookup", lambda s: pmpb.LookupRequest(file_id="bad")),
    ("master", "LookupEc", lambda s: pmpb.LookupEcRequest(volume_id=9999)),
    ("master", "ClusterStatus", lambda s: pmpb.ClusterStatusRequest()),
    ("master", "GetMasterConfiguration",
     lambda s: pmpb.GetMasterConfigurationRequest()),
    ("master", "CollectionDelete", lambda s: pmpb.CollectionDeleteRequest()),
    ("master", "ReleaseAdminToken",
     lambda s: pmpb.ReleaseAdminTokenRequest(name="none", token=5)),
    ("volume", "VolumeStatus", lambda s: pvpb.VolumeRef(volume_id=s["vid"])),
    ("volume", "VolumeStatus", lambda s: pvpb.VolumeRef(volume_id=9999)),
    ("volume", "VolumeNeedleStatus", lambda s: pvpb.NeedleStatusRequest(
        volume_id=s["vid"], needle_id=s["key"])),
    ("volume", "VacuumVolumeCheck",
     lambda s: pvpb.VolumeRef(volume_id=s["vid"])),
    ("volume", "VolumeSyncStatus",
     lambda s: pvpb.VolumeRef(volume_id=9999)),
    ("volume", "VolumeMarkReadonly",
     lambda s: pvpb.VolumeRef(volume_id=9999)),
    ("volume", "VolumeEcBlobDelete",
     lambda s: pvpb.EcBlobDeleteRequest(volume_id=9999, file_key=1)),
    ("volume", "VolumeEcShardsRebuild",
     lambda s: pvpb.EcRebuildRequest(volume_id=9999)),
]


@pytest.mark.parametrize("service,method,make", REQUESTS,
                         ids=[f"{r[1]}-{i}" for i, r in enumerate(REQUESTS)])
@within(60)
def test_same_requests_equal_responses(pair, service, method, make):
    got = {}
    for side, s in pair.items():
        with grpc.insecure_channel(s[service]) as ch:
            stub = (prpc.MasterStub if service == "master"
                    else prpc.VolumeServerStub)(ch)
            got[side] = getattr(stub, method)(make(s))
    p, r = (_normalized(got[k]) for k in ("port", "reference"))
    if "error" in r:
        # both answer an error; the wording may name the port's types
        assert bool(p.pop("error", "")) and bool(r.pop("error"))
    assert p == r


# --- the filer ---

@pytest.fixture(scope="module")
def fcluster():
    c = LocalCluster(1, coder_name="numpy", geometry=TEST_GEOMETRY,
                     volume_size_limit_mb=1, pulse=0.15, with_grpc=True)
    c.fs = c.add_filer()
    c.client = PClient(c.master_url)
    c.filer_grpc_target = _grpc(c.fs.url)
    yield c
    c.shutdown()


@pytest.mark.parametrize("stubs", STUBS)
@within(60)
def test_grpc_filer_entry_crud(fcluster, stubs):
    c = fcluster
    d = f"/grpc{stubs}"
    with grpc.insecure_channel(c.filer_grpc_target) as ch:
        stub = STUBS[stubs].FilerStub(ch)
        ok = stub.CreateEntry(pfpb.EntryRequest(entry=pfpb.Entry(
            path=f"{d}/a.txt",
            attr=pfpb.FuseAttributes(mode=0o100660, mtime=1.0),
            chunks=[pfpb.FileChunk(fid="9,deadbeef01", offset=0,
                                   size=11)])))
        assert ok.ok, ok.error
        got = stub.LookupDirectoryEntry(
            pfpb.LookupEntryRequest(directory=d, name="a.txt"))
        assert got.error == "" and got.entry.path == f"{d}/a.txt"
        assert got.entry.chunks[0].fid == "9,deadbeef01"
        names = [r.entry.path for r in stub.ListEntries(
            pfpb.ListEntriesRequest(directory=d))]
        assert names == [f"{d}/a.txt"]
        dup = stub.CreateEntry(pfpb.EntryRequest(
            entry=pfpb.Entry(path=f"{d}/a.txt",
                             attr=pfpb.FuseAttributes(mode=0o100660)),
            o_excl=True))
        assert not dup.ok
        app = stub.AppendToEntry(pfpb.AppendToEntryRequest(
            path=f"{d}/a.txt",
            chunks=[pfpb.FileChunk(fid="9,deadbeef02", size=5)]))
        assert app.ok, app.error
        grown = stub.LookupDirectoryEntry(
            pfpb.LookupEntryRequest(directory=d, name="a.txt"))
        assert [(x.fid, x.offset) for x in grown.entry.chunks] == \
            [("9,deadbeef01", 0), ("9,deadbeef02", 11)]
        ren = stub.AtomicRenameEntry(pfpb.RenameEntryRequest(
            old_path=f"{d}/a.txt", new_path=f"{d}/b.txt"))
        assert ren.ok, ren.error
        assert stub.LookupDirectoryEntry(
            pfpb.LookupEntryRequest(directory=d, name="a.txt")).error
        dele = stub.DeleteEntry(pfpb.DeleteEntryRequest(
            path=f"{d}/b.txt", is_delete_data=False))
        assert dele.ok, dele.error
        assert stub.KvPut(pfpb.KvRequest(key=b"k1", value=b"v1")).ok
        assert stub.KvGet(pfpb.KvRequest(key=b"k1")).value == b"v1"
        assert stub.KvGet(pfpb.KvRequest(key=b"nope")).error
        cfg = stub.GetFilerConfiguration(pfpb.Empty())
        assert list(cfg.masters) == [c.master_url]
        assert cfg.dir_buckets == "/buckets"
        assert cfg.signature == c.fs.filer.signature != 0


@pytest.mark.parametrize("stubs", STUBS)
@within(60)
def test_grpc_filer_assign_and_lookup_volume(fcluster, stubs):
    with grpc.insecure_channel(fcluster.filer_grpc_target) as ch:
        stub = STUBS[stubs].FilerStub(ch)
        a = stub.AssignVolume(pfpb.AssignVolumeRequest(count=1))
        assert a.error == "" and a.fid and a.url
        vid = a.fid.split(",")[0]
        lk = stub.LookupVolume(pfpb.LookupVolumeRequest(
            volume_or_file_ids=[vid, a.fid]))
        assert lk.locations_map[vid].urls == [a.url]
        assert lk.locations_map[a.fid].urls == [a.url]
        assert "" in stub.CollectionList(pfpb.Empty()).collections


@pytest.mark.parametrize("stubs", STUBS)
@within(60)
def test_grpc_filer_subscribe_metadata(fcluster, stubs):
    """SubscribeMetadata replays, then pushes live events: the gRPC twin
    of /__meta__/subscribe (filer_grpc_server_sub_meta.go)."""
    d = f"/sub{stubs}"
    with grpc.insecure_channel(fcluster.filer_grpc_target) as ch:
        stub = STUBS[stubs].FilerStub(ch)
        assert stub.CreateEntry(pfpb.EntryRequest(entry=pfpb.Entry(
            path=f"{d}/replayed.txt",
            attr=pfpb.FuseAttributes(mode=0o100660)))).ok
        stream = stub.SubscribeMetadata(pfpb.SubscribeMetadataRequest(
            client_name="t", path_prefix=d, since_ns=0), timeout=20)
        paths = []
        for ev in stream:
            if ev.new_entry.path == f"{d}/replayed.txt":
                break
            paths.append(ev.new_entry.path)
        assert stub.CreateEntry(pfpb.EntryRequest(entry=pfpb.Entry(
            path=f"{d}/live.txt",
            attr=pfpb.FuseAttributes(mode=0o100660)))).ok
        ev = next(stream)
        stream.cancel()
    assert ev.new_entry.path == f"{d}/live.txt"
    assert all(p.startswith(d) for p in paths)


@within(60)
def test_grpc_filer_statistics_reports_usage(fcluster):
    c = fcluster
    c.client.upload(b"stats-payload " * 100)
    _wait(lambda: any(v.file_count for n in c.master.topology.nodes.values()
                      for v in n.volumes.values()))
    with grpc.insecure_channel(c.filer_grpc_target) as ch:
        st = prpc.FilerStub(ch).Statistics(pfpb.StatisticsRequest())
    assert st.total_size > 0 and st.file_count >= 1 and st.used_size > 0


@within(60)
def test_grpc_filer_keepconnected_registers_brokers(fcluster):
    """A ``broker@`` KeepConnected stream registers the broker for
    LocateBroker and /__meta__/brokers until the stream ends."""
    from seaweedfs_torch.server import http
    c = fcluster
    stop = threading.Event()

    def beats():
        yield pfpb.KeepConnectedRequest(name="broker@127.0.0.1:17001",
                                        resources=["ns/t/0", "ns/t/1"])
        stop.wait(20)

    with grpc.insecure_channel(c.filer_grpc_target) as ch:
        stub = prpc.FilerStub(ch)
        stream = stub.KeepConnected(beats())
        next(stream)
        loc = stub.LocateBroker(pfpb.LocateBrokerRequest(resource="x"))
        assert loc.found
        assert [(r.grpc_address, r.resource_count)
                for r in loc.resources] == [("127.0.0.1:17001", 2)]
        status, body = http.get_json(f"http://{c.fs.url}/__meta__/brokers")
        assert status == 200 and body == {"brokers": ["127.0.0.1:17001"]}
        stop.set()
        stream.cancel()
    _wait(lambda: not c.fs.broker_registry, what="deregistered")
    with grpc.insecure_channel(c.filer_grpc_target) as ch:
        assert not prpc.FilerStub(ch).LocateBroker(
            pfpb.LocateBrokerRequest()).found


def test_dial_refuses_a_tls_security_config(tmp_path, monkeypatch):
    """A security.toml asking for TLS or a whitelist is refused, never
    dialled in plain text."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(prpc, "_security_checked", False)
    (tmp_path / "security.toml").write_text(
        '[tls]\ncert_file = "c.pem"\nkey_file = "k.pem"\n')
    with pytest.raises(RuntimeError, match="TLS"):
        prpc.dial("127.0.0.1:1")
    (tmp_path / "security.toml").write_text(
        '[guard]\nwhite_list = "10.0.0.1"\n')
    with pytest.raises(RuntimeError, match="whitelist"):
        prpc.dial("127.0.0.1:1")
    (tmp_path / "security.toml").write_text("")
    prpc.dial("127.0.0.1:1").close()
