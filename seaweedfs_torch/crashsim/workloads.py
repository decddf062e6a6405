"""Per-subsystem crash workloads over the port's persistence paths.

The port's copy of seaweedfs_tpu/crashsim/workloads.py, with the
workloads whose modules the port has. Each drives the production code
(not a model of it), acks state at its durability barriers, and reopens
the subsystem on the reconstructed crash tree:

- volume_append  -- .dat append + .idx journal + .swm watermark; torn-tail
                    truncation and index re-derivation on open;
- ec_encode      -- shard files + the .ecm commit marker, written by
                    ``striping.write_ec_files`` (or any encoder with its
                    signature, such as ``pipeline.stream_encode``, whose
                    ``_FanOut`` writer threads append with ``os.writev``);
- fused_warmdown -- the one-pass warm-down (ec/fused.py) through staging
                    and the store's promote: a crash anywhere leaves the
                    source volume readable or a fully committed shard set.

The EC workloads take the coder, the geometry and the source size; their
defaults are the reference's own (RS(3,2) with 8192 / 1024 blocks, a
41,000-byte .dat, 24 needles, ``NumpyCoder``), so at the defaults they
ack the reference's bytes. Not ported yet (their modules are not):
volume_group_commit, needle_map_flush, raft_snapshot, offset_commit and
filer_kv.
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


def registry() -> list:
    """Fresh workload instances at their defaults (closures hold
    per-recording state)."""
    return [
        make_volume_workload(),
        make_ec_workload(),
        make_fused_warmdown_workload(),
    ]
