"""Rebuild the disk state a power loss at op index `crash` could leave.

The port's copy of seaweedfs_tpu/crashsim/replay.py.

The model is the ALICE-style abstract persistence model:

- an op covered by a later (pre-crash) barrier is GUARANTEED: ``fsync``
  of a file stabilizes that inode's data ops so far; ``dirsync`` of a
  directory stabilizes the namespace ops (create/unlink/rename) inside
  it so far;
- every other pre-crash op is independently kept or dropped by the
  seeded RNG — the kernel may have written any subset, in any order;
- an un-stabilized *write* can additionally be TORN: a sector-aligned
  prefix survives and (coin flip) the remainder of the torn sector is
  garbage — the shape a CRC check must catch;
- inodes are first-class: data written to a temp file travels with the
  rename; if the birth of an inode's directory entry is dropped, its
  data is unreachable no matter what was kept (data pages of an
  unlinked inode).

This is deliberately *stricter* than common ext4 data=ordered behavior
(fsync of a new file does not stabilize its directory entry here) —
the durability contract must hold on the weakest POSIX-compliant
disk, which is what `utils/durable.py`'s three-barrier recipe
guarantees.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass, field
from typing import Optional, Sequence

from .shim import Op

SECTOR = 512


@dataclass
class _Inode:
    content0: bytes = b""          # baseline content (pre-recording)
    data_ops: list = field(default_factory=list)   # [(seq, Op)]
    stable_upto: int = 0           # data_ops[:stable_upto] are guaranteed
    paths: set = field(default_factory=set)        # every name it had


@dataclass
class _NsOp:
    seq: int
    kind: str          # create | unlink | rename
    path: str
    dst: str
    inode: _Inode
    stable: bool = False


def _parent(path: str) -> str:
    return path.rsplit("/", 1)[0] if "/" in path else ""


def build_crash_state(baseline: dict[str, bytes], ops: Sequence[Op],
                      crash: int, rng: random.Random,
                      dest_dir: str) -> None:
    """Materialize one possible post-crash tree into `dest_dir`.

    baseline: path -> bytes of the tree when recording started (that
    state predates the log, so it is durable by assumption).
    ops: the recorded log; only ops[:crash] happened.
    """
    inodes: dict[str, _Inode] = {}
    cur: dict[str, _Inode] = {}
    ns_log: list[_NsOp] = []
    for path, content in baseline.items():
        ino = _Inode(content0=content, paths={path})
        inodes[path] = ino
        cur[path] = ino

    def find_inode(path: str) -> Optional[_Inode]:
        ino = cur.get(path)
        if ino is not None:
            return ino
        # fd-based ops can reference a path the inode was renamed away
        # from; newest match wins
        for cand in reversed(ns_log):
            if path in cand.inode.paths:
                return cand.inode
        return None

    # ---- pass 1: build inode/namespace views + stabilization marks ----
    for op in ops[:crash]:
        if op.kind == "create":
            existing = cur.get(op.path)
            if existing is not None:
                # open('w') on an existing file truncates in place: a
                # data op on the same inode, not a namespace change
                existing.data_ops.append((op.seq, Op(
                    seq=op.seq, kind="trunc", path=op.path, size=0)))
            else:
                ino = _Inode(paths={op.path})
                cur[op.path] = ino
                ns_log.append(_NsOp(op.seq, "create", op.path, "", ino))
        elif op.kind in ("write", "trunc"):
            ino = find_inode(op.path)
            if ino is None:       # write through a stale path: orphan
                ino = _Inode(paths={op.path})
                cur[op.path] = ino
                ns_log.append(_NsOp(op.seq, "create", op.path, "", ino))
            ino.data_ops.append((op.seq, op))
        elif op.kind == "fsync":
            ino = find_inode(op.path)
            if ino is not None:
                ino.stable_upto = len(ino.data_ops)
        elif op.kind == "dirsync":
            d = op.path if op.path != "." else ""
            for entry in ns_log:
                target_dir = _parent(entry.dst or entry.path)
                if target_dir == d:
                    entry.stable = True
        elif op.kind == "unlink":
            ino = cur.pop(op.path, None)
            if ino is not None:
                ns_log.append(_NsOp(op.seq, "unlink", op.path, "", ino))
        elif op.kind == "rename":
            ino = cur.pop(op.path, None)
            if ino is None:
                continue
            ino.paths.add(op.dst)
            cur[op.dst] = ino
            ns_log.append(_NsOp(op.seq, "rename", op.path, op.dst, ino))

    # ---- pass 2: decide survival + materialize ----
    def materialize(ino: _Inode) -> bytes:
        buf = bytearray(ino.content0)
        for i, (_seq, op) in enumerate(ino.data_ops):
            stable = i < ino.stable_upto
            if op.kind == "trunc":
                if stable or rng.random() < 0.5:
                    size = op.size
                    if size <= len(buf):
                        del buf[size:]
                    else:
                        buf.extend(b"\0" * (size - len(buf)))
                continue
            data = op.data
            if not stable:
                roll = rng.random()
                if roll < 1 / 3:
                    continue                      # dropped entirely
                if roll < 2 / 3 and len(data) > 0:
                    # torn: sector-aligned prefix survives; coin flip
                    # garbages the remainder of the torn sector
                    sectors = len(data) // SECTOR
                    keep = rng.randrange(0, sectors + 1) * SECTOR
                    if keep >= len(data):
                        keep = max(0, len(data) - 1)
                    torn = data[:keep]
                    if rng.random() < 0.5:
                        pad = min(SECTOR, len(data) - keep)
                        torn += bytes(rng.randrange(256)
                                      for _ in range(pad))
                    data = torn
                    if not data:
                        continue
            end = op.offset + len(data)
            if end > len(buf):
                buf.extend(b"\0" * (end - len(buf)))
            buf[op.offset:op.offset + len(data)] = data
        return bytes(buf)

    names: dict[str, _Inode] = dict(
        (p, ino) for p, ino in inodes.items())
    for entry in ns_log:
        keep = entry.stable or rng.random() < 0.5
        if not keep:
            continue
        if entry.kind == "create":
            names[entry.path] = entry.inode
        elif entry.kind == "unlink":
            names.pop(entry.path, None)
        elif entry.kind == "rename":
            names.pop(entry.path, None)
            names[entry.dst] = entry.inode

    os.makedirs(dest_dir, exist_ok=True)
    content_cache: dict[int, bytes] = {}
    for path, ino in names.items():
        dest = os.path.join(dest_dir, path.replace("/", os.sep))
        os.makedirs(os.path.dirname(dest) or dest_dir, exist_ok=True)
        if id(ino) not in content_cache:
            content_cache[id(ino)] = materialize(ino)
        with open(dest, "wb") as f:
            f.write(content_cache[id(ino)])
