"""DirectoryRing: virtual-node consistent hashing over filer peers.

The port's copy of seaweedfs_tpu/metaring/ring.py. The partition key is
a path's PARENT directory, so one directory's children share an owner:
a listing is a one-peer operation and one path's create, overwrite and
delete serialize on one store. Hashing is md5 over (peer, vnode index):
every process that knows the membership computes the same ring, and the
master's ``/dir/ring`` (version-numbered) orders membership changes.

``owners(dir, n)`` is the owner and n-1 distinct successors, the replica
set: writes land on the owner and mirror to the successors, so losing a
peer loses no acknowledged entry.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Optional


def _hash(key: str) -> int:
    return int.from_bytes(
        hashlib.md5(key.encode("utf-8")).digest()[:8], "big")


class DirectoryRing:
    def __init__(self, peers: Optional[list[str]] = None,
                 vnodes: int = 64, replicas: int = 2, version: int = 0):
        self.vnodes = max(1, int(vnodes))
        self.replicas = max(1, int(replicas))
        self.version = version
        self.peers: list[str] = []
        self._points: list[int] = []       # sorted vnode hashes
        self._owners: list[str] = []       # parallel peer urls
        for p in peers or []:
            self.add_peer(p, _bump=False)

    # --- membership ---
    def add_peer(self, peer: str, _bump: bool = True) -> bool:
        if peer in self.peers:
            return False
        self.peers.append(peer)
        self.peers.sort()
        for i in range(self.vnodes):
            h = _hash(f"{peer}#{i}")
            at = bisect.bisect_left(self._points, h)
            self._points.insert(at, h)
            self._owners.insert(at, peer)
        if _bump:
            self.version += 1
        return True

    def remove_peer(self, peer: str) -> bool:
        if peer not in self.peers:
            return False
        self.peers.remove(peer)
        keep = [(h, o) for h, o in zip(self._points, self._owners)
                if o != peer]
        self._points = [h for h, _ in keep]
        self._owners = [o for _, o in keep]
        self.version += 1
        return True

    # --- placement ---
    def owner(self, directory: str) -> Optional[str]:
        owners = self.owners(directory, 1)
        return owners[0] if owners else None

    def owners(self, directory: str, n: int = 0) -> list[str]:
        """The owner and distinct successors of a directory (its replica
        set); n=0 is the configured replica count, capped at the
        membership."""
        if not self._points:
            return []
        n = min(n or self.replicas, len(self.peers))
        start = bisect.bisect(self._points, _hash(directory)) \
            % len(self._points)
        out: list[str] = []
        for i in range(len(self._points)):
            peer = self._owners[(start + i) % len(self._points)]
            if peer not in out:
                out.append(peer)
                if len(out) >= n:
                    break
        return out

    def is_replica(self, directory: str, peer: str) -> bool:
        return peer in self.owners(directory)

    # --- wire form (served at /dir/ring, pushed over /cluster/watch) ---
    def to_dict(self) -> dict:
        return {"version": self.version, "peers": list(self.peers),
                "vnodes": self.vnodes, "replicas": self.replicas}

    @classmethod
    def from_dict(cls, d: dict) -> "DirectoryRing":
        return cls(peers=list(d.get("peers", [])),
                   vnodes=int(d.get("vnodes", 64)),
                   replicas=int(d.get("replicas", 2)),
                   version=int(d.get("version", 0)))

    def partition_counts(self, sample_dirs: list[str]) -> dict[str, int]:
        """Owned-directory counts over a directory sample (the
        ``filer.ring.status`` balance view)."""
        out = {p: 0 for p in self.peers}
        for d in sample_dirs:
            o = self.owner(d)
            if o is not None:
                out[o] += 1
        return out
