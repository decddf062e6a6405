"""Per-volume access-heat tracking — the signal the lifecycle plane runs on.

The port's copy of seaweedfs_tpu/lifecycle/heat.py, whole. Volume
servers sample their read/write paths into a HeatTracker:
one dict update per request, no locks on the hot path beyond a cheap
mutex, no I/O.  Every heartbeat drains only the volumes touched since the
last beat ("send only changed entries"), so an idle 1000-volume node adds
ZERO bytes to its heartbeat and a busy one adds O(changed volumes).

The master folds those deltas into per-node VolumeHeat records
(topology/topology.py) keyed by volume id: cumulative read/write counts,
the last access timestamp, and a decayed-EWMA read rate (reads/second,
half-life HALFLIFE seconds) that the policy engine compares against
WEED_LIFECYCLE_HOT_READ_RATE to decide when a warm (EC) volume has turned
hot again.  first_seen exists so a freshly restarted master — which has
no access history at all — never mistakes "I just booted" for "idle for
weeks": idleness is measured from max(last_access, first_seen).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Iterable, Optional

# decayed-EWMA half-life for the read-rate signal (seconds): after one
# half-life with no reads the remembered rate halves
HALFLIFE = 600.0


def decayed_rate(rate: float, since: float, now: float,
                 halflife: float = HALFLIFE) -> float:
    """The EWMA read rate `rate` recorded at `since`, decayed to `now`."""
    if rate <= 0.0:
        return 0.0
    dt = max(now - since, 0.0)
    return rate * 0.5 ** (dt / halflife)


class HeatTracker:
    """Volume-server side: O(1) sampling + delta drain for heartbeats."""

    def __init__(self, halflife: float = HALFLIFE):
        self.halflife = halflife
        self._lock = threading.Lock()
        # vid -> [reads_delta, writes_delta, last_access, rate, last_drain]
        self._stats: dict[int, list] = {}
        self._dirty: set[int] = set()

    def _entry(self, vid: int) -> list:
        st = self._stats.get(vid)
        if st is None:
            st = self._stats[vid] = [0, 0, 0.0, 0.0, time.time()]
        return st

    def record_read(self, vid: int) -> None:
        now = time.time()
        with self._lock:
            st = self._entry(vid)
            st[0] += 1
            st[2] = now
            self._dirty.add(vid)

    def record_write(self, vid: int) -> None:
        now = time.time()
        with self._lock:
            st = self._entry(vid)
            st[1] += 1
            st[2] = now
            self._dirty.add(vid)

    def drop(self, vid: int) -> None:
        with self._lock:
            self._stats.pop(vid, None)
            self._dirty.discard(vid)

    def requeue(self, entries: Iterable[dict]) -> None:
        """Put drained deltas back after a failed delivery (heartbeat
        POST timed out / leader changed) so the window's access records
        ride the next beat instead of vanishing. Counts and last_access
        merge exactly; the EWMA rate may count the window twice (it was
        already folded at drain time) — a slightly-hot bias is the safe
        direction for a signal that gates destructive idle transitions."""
        with self._lock:
            for e in entries:
                st = self._entry(int(e["id"]))
                st[0] += int(e.get("reads", 0))
                st[1] += int(e.get("writes", 0))
                st[2] = max(st[2], float(e.get("last_access", 0.0)))
                self._dirty.add(int(e["id"]))

    def deltas(self, known_vids: Optional[Iterable[int]] = None
               ) -> list[dict]:
        """Drain the dirty set into heartbeat entries (changed volumes
        only — the heartbeat stays O(changed), not O(volumes)).  Passing
        known_vids also prunes tracker state for volumes this server no
        longer holds, so deleted/moved volumes don't pin memory."""
        now = time.time()
        out: list[dict] = []
        with self._lock:
            if known_vids is not None:
                known = set(known_vids)
                for vid in [v for v in self._stats if v not in known]:
                    self._stats.pop(vid, None)
                    self._dirty.discard(vid)
            for vid in sorted(self._dirty):
                st = self._stats.get(vid)
                if st is None:
                    continue
                reads, writes, last_access, rate, last_drain = st
                dt = max(now - last_drain, 1e-3)
                # EWMA over drain intervals: decay the old rate to now,
                # blend in this interval's instantaneous reads/second
                decay = 0.5 ** (dt / self.halflife)
                rate = decay * rate + (1.0 - decay) * (reads / dt)
                st[0] = st[1] = 0
                st[3] = rate
                st[4] = now
                out.append({"id": vid, "reads": reads, "writes": writes,
                            "last_access": last_access,
                            "read_rate": round(rate, 6)})
            self._dirty.clear()
        return out


@dataclass
class VolumeHeat:
    """Master-side per-node heat record, merged from heartbeat deltas."""
    reads: int = 0
    writes: int = 0
    last_access: float = 0.0
    read_rate: float = 0.0
    first_seen: float = field(default_factory=time.time)
    updated: float = field(default_factory=time.time)

    def merge(self, entry: dict, now: Optional[float] = None) -> None:
        now = now if now is not None else time.time()
        self.reads += int(entry.get("reads", 0))
        self.writes += int(entry.get("writes", 0))
        self.last_access = max(self.last_access,
                               float(entry.get("last_access", 0.0)))
        # the reporter's EWMA is authoritative — it saw every access
        self.read_rate = float(entry.get("read_rate", 0.0))
        self.updated = now

    def rate_now(self, now: Optional[float] = None) -> float:
        return decayed_rate(self.read_rate, self.updated,
                            now if now is not None else time.time())

    def to_dict(self, now: Optional[float] = None) -> dict:
        now = now if now is not None else time.time()
        return {"reads": self.reads, "writes": self.writes,
                "last_access": self.last_access,
                "read_rate": round(self.rate_now(now), 6),
                "first_seen": self.first_seen}
