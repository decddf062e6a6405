"""Per-subsystem crash workloads over the port's persistence paths.

The port's copy of seaweedfs_tpu/crashsim/workloads.py, with the
workloads whose modules the port has. Each drives the production code
(not a model of it), acks state at its durability barriers, and reopens
the subsystem on the reconstructed crash tree:

- volume_append  -- .dat append + .idx journal + .swm watermark; torn-tail
                    truncation and index re-derivation on open;
- volume_group_commit -- the group commit's one pwritev and one fsync
                    barrier: acked groups survive crashes between the
                    barrier and the index appends;
- needle_map_flush -- the disk needle map's delta merges into its .sdx
                    (temp file, fsync, one rename) beside the .idx
                    journal: a crash anywhere leaves a sidecar that is
                    adopted only while it matches the journal, and every
                    synced entry;
- ec_encode      -- shard files + the .ecm commit marker, written by
                    ``striping.write_ec_files`` (or any encoder with its
                    signature, such as ``pipeline.stream_encode``, whose
                    ``_FanOut`` writer threads append with ``os.writev``);
- fused_warmdown -- the one-pass warm-down (ec/fused.py) through staging
                    and the store's promote: a crash anywhere leaves the
                    source volume readable or a fully committed shard set;
- raft_snapshot  -- a master's raft state (cluster/raft.py): term, vote,
                    log and the metadata log's snapshot folds, each save
                    a barrier; a crash leaves the last acked state or the
                    one being saved, never a torn or older file;
- filer_kv       -- the filer's LevelDbStore: KV puts into its flushed
                    WAL, each segment compaction (temp file, fsync, one
                    rename) a barrier; every compacted key survives;
- offset_commit  -- replication's consume positions: a FileQueueInput's
                    (file, offset) and a Replicator's resume offset, each
                    save a barrier; a crash leaves an acked position or
                    the one being saved, never a torn one.

The EC workloads take the coder, the geometry and the source size; their
defaults are the reference's own (RS(3,2) with 8192 / 1024 blocks, a
41,000-byte .dat, 24 needles, ``NumpyCoder``), so at the defaults they
ack the reference's bytes. All eight of the reference's workloads are
ported.
"""

from __future__ import annotations

import json
import os
import random as random_mod
from typing import Callable, Iterable, Optional

import numpy as np

from .harness import CrashWorkload

_COOKIE = 0x00C0FFEE


# --------------------------------------------------------------- volume

def _volume_payload(rng, nid: int) -> bytes:
    size = rng.choice([96, 700, 2300, 5100])
    body = bytes(rng.randrange(256) for _ in range(64))
    reps = size // len(body) + 1
    return (body * reps)[:size] + nid.to_bytes(4, "big")


def make_volume_workload() -> CrashWorkload:
    from ..storage.needle import Needle
    from ..storage.volume import Volume

    def setup(root):
        v = Volume(root, "", 1, create=True)
        for nid in (1, 2, 3):
            v.write_needle(Needle(cookie=_COOKIE, id=nid,
                                  data=b"baseline-%d" % nid))
        v.close()

    def run(root, ack, rng):
        v = Volume(root, "", 1)
        for nid in (1, 2, 3):
            ack(f"n{nid}", b"baseline-%d" % nid)
        nid = 100
        for _round in range(4):
            batch = {}
            for _ in range(3):
                nid += 1
                data = _volume_payload(rng, nid)
                batch[nid] = data
                ack.candidate(f"n{nid}", data)
                v.write_needle(Needle(cookie=_COOKIE, id=nid, data=data))
            v.sync()
            for bid, data in batch.items():
                ack(f"n{bid}", data)
        # a synced delete must stay deleted
        ack.candidate("n1", None)
        v.delete_needle(Needle(cookie=_COOKIE, id=1))
        v.sync()
        ack("n1", None)
        # un-synced tail: never acked, may tear; recovery must truncate
        for _ in range(3):
            nid += 1
            data = _volume_payload(rng, nid)
            ack.candidate(f"n{nid}", data)
            v.write_needle(Needle(cookie=_COOKIE, id=nid, data=data))
        # the crash: abandon the handles without the close() barrier
        v.nm.close()
        v._dat.close()

    def read_all(vdir):
        v = Volume(vdir, "", 1)
        observed = {}
        for nv in v.nm.values():
            if nv.size > 0:
                # every live map entry must read back CRC-clean: an entry
                # pointing at torn bytes is silent corruption
                observed[f"n{nv.key}"] = v.read_needle(nv.key).data
            else:
                observed[f"n{nv.key}"] = None
        v.close()
        return observed

    def recover(crash_dir):
        observed = read_all(crash_dir)
        # convergence: a second open of the recovered tree must agree
        if read_all(crash_dir) != observed:
            raise AssertionError("recovery did not converge: "
                                 "second open disagrees")
        return observed

    return CrashWorkload("volume_append", setup, run, recover)


# --------------------------------------------------------- group commit

def make_group_commit_workload() -> CrashWorkload:
    """A crash mid group commit: ``write_needles_batch(group_commit=True)``
    writes a batch with one pwritev and one fsync, and the server acks
    the whole group when the call returns. The sweep proves both sides:
    a crash before or inside the pwritev, or before the fsync, loses only
    candidates, and a crash after the barrier, even mid index append,
    loses nothing acked (the recovery at open re-derives the entries
    from the synced .dat)."""
    from ..storage.needle import Needle
    from ..storage.volume import Volume

    def setup(root):
        v = Volume(root, "", 1, create=True)
        for nid in (1, 2, 3):
            v.write_needle(Needle(cookie=_COOKIE, id=nid,
                                  data=b"baseline-%d" % nid))
        v.close()

    def run(root, ack, rng):
        v = Volume(root, "", 1)
        for nid in (1, 2, 3):
            ack(f"n{nid}", b"baseline-%d" % nid)
        nid = 200
        for _round in range(4):
            group = []
            batch = {}
            for _ in range(rng.randrange(2, 6)):
                nid += 1
                data = _volume_payload(rng, nid)
                batch[nid] = data
                ack.candidate(f"n{nid}", data)
                group.append(Needle(cookie=_COOKIE, id=nid, data=data))
            results = v.write_needles_batch(group, group_commit=True)
            for n, res in zip(group, results):
                if isinstance(res, Exception):
                    raise res
                # the group barrier ran: this is the server's 201
                ack(f"n{n.id}", batch[n.id])
        # a trailing group the crash lands before: its needles stay
        # candidates
        tail = []
        for _ in range(3):
            nid += 1
            data = _volume_payload(rng, nid)
            ack.candidate(f"n{nid}", data)
            tail.append(Needle(cookie=_COOKIE, id=nid, data=data))
        v.write_needles_batch(tail, group_commit=True)
        # the crash: abandon the handles without the close() barrier
        v.nm.close()
        v._dat.close()

    def read_all(vdir):
        v = Volume(vdir, "", 1)
        observed = {}
        for nv in v.nm.values():
            if nv.size > 0:
                observed[f"n{nv.key}"] = v.read_needle(nv.key).data
            else:
                observed[f"n{nv.key}"] = None
        v.close()
        return observed

    def recover(crash_dir):
        observed = read_all(crash_dir)
        if read_all(crash_dir) != observed:
            raise AssertionError("recovery did not converge: "
                                 "second open disagrees")
        return observed

    return CrashWorkload("volume_group_commit", setup, run, recover)


# ----------------------------------------------------------- needle map

def make_needle_map_workload() -> CrashWorkload:
    """A crash around the disk needle map's flushes: a threshold of 8
    merges the delta into a new .sdx every few puts, each round is acked
    at its journal fsync, and the crash lands anywhere, a torn or
    revoked sidecar rename included."""
    from ..storage.needle_map import DiskNeedleMap

    def _open(root):
        nm = DiskNeedleMap(os.path.join(root, "1.idx"))
        nm.FLUSH_THRESHOLD = 8
        return nm

    def setup(root):
        nm = _open(root)
        for key in range(1, 5):
            nm.put(key, key * 16, 100 + key)
        nm.sync()
        nm.close()   # close() flushes the delta into a durable .sdx

    def run(root, ack, rng):
        nm = _open(root)
        for key in range(1, 5):
            ack(f"k{key}", (key * 16, 100 + key))
        key = 100
        for _round in range(5):
            batch = {}
            for _ in range(4):
                key += 1
                off, size = key * 8, rng.randrange(50, 4000)
                batch[key] = (off, size)
                ack.candidate(f"k{key}", (off, size))
                nm.put(key, off, size)
            nm.sync()
            for k, v in batch.items():
                ack(f"k{k}", v)
        ack.candidate("k1", None)
        nm.delete(1, tombstone_offset=999)
        nm.sync()
        ack("k1", None)
        for _ in range(3):      # an un-synced tail
            key += 1
            ack.candidate(f"k{key}", (key * 8, 64))
            nm.put(key, key * 8, 64)
        nm._index_file.close()  # the crash: no sync, no flush

    def recover(crash_dir):
        nm = _open(crash_dir)
        observed = {f"k{nv.key}": ((nv.offset, nv.size) if nv.size > 0
                                   else None)
                    for nv in nm.values()}
        nm.close()
        return observed

    return CrashWorkload("needle_map_flush", setup, run, recover)


# ------------------------------------------------------------ EC encode

def _reference_dat(size: int) -> bytes:
    """The reference workload's .dat: seeded bytes, one draw each."""
    r = random_mod.Random(0xEC)
    return bytes(r.getrandbits(8) for _ in range(size))


def _shard_digest(data: bytes) -> int:
    return int(np.frombuffer(data, np.uint8).sum(dtype=np.uint64)) \
        & 0xFFFFFFFF


def _read_shards(base: str, total: int, observed: dict) -> None:
    from ..ec.geometry import to_ext
    for sid in range(total):
        try:
            with open(base + to_ext(sid), "rb") as f:
                observed[f"shard{sid}"] = f.read()
        except FileNotFoundError:
            pass


def _check_committed(base: str, total: int, observed: dict, ctx: dict,
                     need_digests: bool) -> list:
    """The commit-marker invariant, acked or not: a .ecm at `base` must be
    complete (an atomic replace forbids a torn marker) and vouch for a
    complete, byte-exact shard set whose bytes match the digests it
    carries."""
    out = []
    if not os.path.exists(base + ".ecm"):
        return out
    try:
        with open(base + ".ecm") as f:
            meta = json.load(f)
    except ValueError:
        return [".ecm exists but is torn/unparseable "
                "(non-atomic marker commit)"]
    if "layout_version" not in meta or (
            need_digests and "shard_digests" not in meta):
        return [".ecm parsed but incomplete (torn marker)"]
    digests = meta.get("shard_digests", {})
    for sid in range(total):
        got = observed.get(f"shard{sid}")
        if got is None:
            out.append(f".ecm committed but shard {sid} is missing")
            continue
        if ctx and got != ctx.get(sid):
            out.append(f".ecm committed but shard {sid} bytes "
                       f"diverge (un-synced shard pages dropped)")
        want = digests.get(str(sid))
        if want is not None and _shard_digest(got) != want:
            out.append(f".ecm digest for shard {sid} is {want} "
                       f"but the bytes sum to {_shard_digest(got)}")
    return out


def make_ec_workload(coder=None, geometry=None, dat_size: int = 41_000,
                     dat_source: Optional[Callable[[int], bytes]] = None,
                     encode: Optional[Callable] = None) -> CrashWorkload:
    """Encode a .dat of `dat_size` bytes (`dat_source(size)`, default the
    reference's seeded bytes) with `encode(base, coder, geometry)`
    (default ``striping.write_ec_files``) and ack every shard and the
    .ecm."""
    from ..ec import striping
    from ..ec.coder import NumpyCoder
    from ..ec.geometry import Geometry, to_ext

    g = geometry or Geometry(data_shards=3, parity_shards=2,
                             large_block_size=8192, small_block_size=1024)
    coder = coder or NumpyCoder(g.data_shards, g.parity_shards)
    encode = encode or striping.write_ec_files
    dat_source = dat_source or _reference_dat
    base_name = "7"
    ctx: dict = {}

    def setup(root):
        with open(os.path.join(root, base_name + ".dat"), "wb") as f:
            f.write(dat_source(dat_size))

    def run(root, ack, rng):
        base = os.path.join(root, base_name)
        encode(base, coder, g)
        ctx.clear()
        for sid in range(g.total_shards):
            with open(base + to_ext(sid), "rb") as f:
                ctx[sid] = f.read()
            ack(f"shard{sid}", ctx[sid])
        with open(base + ".ecm") as f:
            ctx["ecm"] = json.load(f)
        ack("ecm", ctx["ecm"])

    def recover(crash_dir):
        base = os.path.join(crash_dir, base_name)
        observed: dict = {}
        try:
            with open(base + ".ecm") as f:
                observed["ecm"] = json.load(f)
        except FileNotFoundError:
            pass
        _read_shards(base, g.total_shards, observed)
        return observed

    def check(crash_dir, observed, expected):
        return _check_committed(os.path.join(crash_dir, base_name),
                                g.total_shards, observed, ctx, False)

    return CrashWorkload("ec_encode", setup, run, recover, check)


# -------------------------------------------------------- fused warm-down

def _fused_payload(nid: int) -> bytes:
    if nid % 3 == 0:    # compressible: exercises the gzip splice
        return (b"fused crashsim compressible text block. " * 64
                )[: 900 + nid * 13]
    r = random_mod.Random(nid)           # incompressible: declined
    return bytes(r.getrandbits(8) for _ in range(300 + (nid * 37) % 1200))


def make_fused_warmdown_workload(
        coder=None, geometry=None, needles: int = 24,
        deleted: Iterable[int] = (4, 9, 14),
        make_needle: Optional[Callable] = None) -> CrashWorkload:
    """The one-pass warm-down end to end: the fused compact + gzip + RS +
    digest pass into a staging base, then the store's promote (shards ->
    .ecx -> .ecm marker last). The source volume (needles 1..`needles`,
    `make_needle(nid)` each, default the reference's payloads, with
    `deleted` tombstoned) is durable before the pass and never written by
    it, so its needles must read back CRC-clean after every crash; a
    committed .ecm at the volume base must vouch for the full shard set,
    byte-exact and matching its digests. A crash anywhere leaves the
    source or a committed shard set, never neither."""
    from ..ec import fused as ec_fused
    from ..ec.coder import NumpyCoder
    from ..ec.geometry import Geometry, to_ext
    from ..storage.needle import Needle
    from ..storage.store import Store
    from ..storage.volume import Volume

    g = geometry or Geometry(data_shards=3, parity_shards=2,
                             large_block_size=8192, small_block_size=1024)
    coder = coder or NumpyCoder(g.data_shards, g.parity_shards)
    make_needle = make_needle or (
        lambda nid: Needle(cookie=_COOKIE, id=nid, data=_fused_payload(nid)))
    deleted = frozenset(deleted)
    ctx: dict = {}
    datas: dict = {}

    def setup(root):
        v = Volume(root, "", 7, create=True)
        datas.clear()
        for nid in range(1, needles + 1):
            n = make_needle(nid)
            datas[nid] = n.data
            v.write_needle(n)
        for nid in sorted(deleted):
            v.delete_needle(Needle(cookie=_COOKIE, id=nid))
        v.close()

    def run(root, ack, rng):
        v = Volume(root, "", 7)
        # the source side of the contract: durable before the pass starts,
        # never written by it; it must survive every crash prefix
        for nid in range(1, needles + 1):
            ack(f"src_n{nid}", None if nid in deleted else datas[nid])
        base = os.path.join(root, "7")
        staging = base + ".fusing"
        ec_fused.fused_vacuum_gzip_encode(v, staging, coder, g)
        # the production promote, not a model of it (the method uses no
        # state of its store: renames in commit order)
        Store._ec_fused_promote(None, base, staging, g)
        ctx.clear()
        for sid in range(g.total_shards):
            with open(base + to_ext(sid), "rb") as f:
                ctx[sid] = f.read()
            ack(f"shard{sid}", ctx[sid])
        with open(base + ".ecm") as f:
            ctx["ecm"] = json.load(f)
        ack("ecm", ctx["ecm"])
        v.close()

    def read_src(vdir):
        v = Volume(vdir, "", 7)
        observed = {}
        for nv in v.nm.values():
            observed[f"src_n{nv.key}"] = (v.read_needle(nv.key).data
                                          if nv.size > 0 else None)
        v.close()
        return observed

    def recover(crash_dir):
        observed = read_src(crash_dir)
        base = os.path.join(crash_dir, "7")
        try:
            with open(base + ".ecm") as f:
                observed["ecm"] = json.load(f)
        except (FileNotFoundError, ValueError):
            pass   # an absent or torn marker is check()'s business
        _read_shards(base, g.total_shards, observed)
        return observed

    def check(crash_dir, observed, expected):
        # uncommitted: the (always checked) source volume is the truth
        return _check_committed(os.path.join(crash_dir, "7"),
                                g.total_shards, observed, ctx, True)

    return CrashWorkload("fused_warmdown", setup, run, recover, check)


# --------------------------------------------------------- raft snapshot

def make_raft_workload() -> CrashWorkload:
    from ..cluster.raft import RaftNode

    def state(node) -> dict:
        return {"term": node.term, "voted_for": node.voted_for,
                "log": json.loads(json.dumps(node.log)),
                "snap_index": node.snap_index,
                "snap_term": node.snap_term,
                "snap_state": json.loads(json.dumps(node.snap_state))}

    def node(root):
        d = os.path.join(root, "raft")
        os.makedirs(d, exist_ok=True)
        return RaftNode("n1:1", [], apply_fn=lambda cmd: None, state_dir=d)

    def setup(root):
        n = node(root)
        n.term = 1
        n._save_state()
        n._save_exec.shutdown(wait=False)

    def run(root, ack, rng):
        n = node(root)
        ack("state", state(n))
        for rnd in range(6):
            n.term += 1
            n.voted_for = f"peer{rnd}"
            n.log.append({"term": n.term,
                          "cmd": {"assign_batch": {"count": rnd * 10 + 1}}})
            if rnd % 2:
                # a compaction: the metadata log's state into the
                # snapshot, the log emptied
                n.snap_index += len(n.log)
                n.snap_term = n.term
                n.snap_state = {"max_volume_id": rnd,
                                "metalog": {
                                    "next_key": rnd * 1000,
                                    "assign_batches": rnd,
                                    "volumes": {str(v): {"collection": ""}
                                                for v in range(rnd)},
                                    "geometry": {"": "10+4"}}}
                n.log = []
            ack.candidate("state", state(n))
            n._save_state()
            ack("state", state(n))
        n._save_exec.shutdown(wait=False)

    def recover(crash_dir):
        n = node(crash_dir)
        out = {"state": state(n)}
        n._save_exec.shutdown(wait=False)
        return out

    return CrashWorkload("raft_snapshot", setup, run, recover)


# ------------------------------------------------------------- filer KV

def make_filer_kv_workload() -> CrashWorkload:
    """The filer's LevelDbStore: KV puts into its WAL, the segment
    compaction as the durability barrier (the WAL is flushed, not
    fsynced: a bounded loss by design), an un-compacted tail of
    candidates only."""
    from ..filer.leveldb_store import LevelDbStore

    def _store(root):
        return LevelDbStore(os.path.join(root, "filer.ldb"),
                            wal_flush_entries=1_000_000)

    def setup(root):
        st = _store(root)
        st.kv_put("ring_handoff/v0", b"0")
        st._compact()
        st._wal.close()

    def run(root, ack, rng):
        st = _store(root)
        ack("ring_handoff/v0", b"0")
        for rnd in range(1, 5):
            for j in range(3):
                key = f"watermark/{rnd}/{j}"
                val = f"offset-{rnd * 100 + j}".encode()
                ack.candidate(key, val)
                st.kv_put(key, val)
            st._compact()
            for j in range(3):
                key = f"watermark/{rnd}/{j}"
                ack(key, f"offset-{rnd * 100 + j}".encode())
        for j in range(4):
            key = f"watermark/tail/{j}"
            ack.candidate(key, b"x")
            st.kv_put(key, b"x")
        st._wal.close()

    def recover(crash_dir):
        st = _store(crash_dir)
        out: dict = {}
        keys = (["ring_handoff/v0"]
                + [f"watermark/{r}/{j}"
                   for r in range(1, 5) for j in range(3)]
                + [f"watermark/tail/{j}" for j in range(4)])
        for key in keys:
            v = st.kv_get(key)
            if v is not None:
                out[key] = v
        st._wal.close()
        return out

    return CrashWorkload("filer_kv", setup, run, recover)


def make_offset_workload() -> CrashWorkload:
    """Replication's consume positions: a FileQueueInput's ack and a
    Replicator's save_offset, alternating, each a barrier."""
    from ..replication.replicator import Replicator
    from ..replication.sub import FileQueueInput

    def setup(root):
        os.makedirs(os.path.join(root, "spool"), exist_ok=True)

    def run(root, ack, rng):
        inp = FileQueueInput(os.path.join(root, "spool"))
        rep = Replicator("src:0", None,
                         offset_path=os.path.join(root, "geo.offset"))
        for i in range(1, 8):
            inp._file = f"events-{i:04d}.ndjson"
            inp._offset = i * 1000 + rng.randrange(100)
            pos = {"file": inp._file, "offset": inp._offset}
            ack.candidate("file_pos", pos)
            inp.ack()
            ack("file_pos", pos)

            tsns = i * 10_000 + rng.randrange(1000)
            ack.candidate("geo_since", tsns)
            rep.save_offset(tsns)
            ack("geo_since", tsns)

    def recover(crash_dir):
        out: dict = {}
        inp = FileQueueInput(os.path.join(crash_dir, "spool"))
        # a position at the epoch is legal only while none was durably
        # acked: the harness compares with the acked values
        if inp._file or inp._offset:
            out["file_pos"] = {"file": inp._file, "offset": inp._offset}
        rep = Replicator("src:0", None,
                         offset_path=os.path.join(crash_dir, "geo.offset"))
        since = rep.load_offset()
        if since:
            out["geo_since"] = since
        return out

    return CrashWorkload("offset_commit", setup, run, recover)


def registry() -> list:
    """Fresh workload instances at their defaults (closures hold
    per-recording state)."""
    return [
        make_volume_workload(),
        make_group_commit_workload(),
        make_needle_map_workload(),
        make_ec_workload(),
        make_fused_warmdown_workload(),
        make_raft_workload(),
        make_filer_kv_workload(),
        make_offset_workload(),
    ]
