"""DirectoryRing: virtual-node consistent hashing over filer peers.

The port's reduced copy of seaweedfs_tpu/metaring/ring.py: membership
(``add_peer``, ``remove_peer``) and ``owner``, what clustersim's
``churn`` scenario measures. The partition key is a path's parent
directory, so one directory's children share an owner. Hashing is md5
over (peer, vnode index): every process that knows the membership
computes the same ring. Left out: the replica sets (``owners`` beyond
the first, ``is_replica``), the wire form and ``partition_counts``.
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
                 vnodes: int = 64, version: int = 0):
        self.vnodes = max(1, int(vnodes))
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
        """The peer of the first vnode at or after the directory's hash
        (wrapping), None on an empty ring."""
        if not self._points:
            return None
        at = bisect.bisect(self._points, _hash(directory)) \
            % len(self._points)
        return self._owners[at]
