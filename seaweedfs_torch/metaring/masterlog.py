"""MasterMetaLog: the masters' replicated metadata state machine.

The port's copy of seaweedfs_tpu/metaring/masterlog.py. The raft log
(cluster/raft.py) carries the assignment plane itself, so a newly elected
leader replays to the exact state instead of jumping a ceiling:

  {"assign_batch": {"count": N}}   mint N consecutive needle keys; the
                                   apply computes the first key from the
                                   replicated next_key, and the leader
                                   reads its own result back
                                   (``RaftNode.propose_apply``)
  {"seq_floor": K}                 a key seen outside the log (a
                                   heartbeat's max_file_key) as a floor:
                                   only a cold start over existing volumes
  {"volume_create": {...}}         a registry row (vid, collection,
                                   replication, ttl)
  {"volume_retire": {"vid": N}}    drop registry rows (or "vids": [...])
  {"geometry_stamp": {...}}        the RS(k,m) a collection's volumes
                                   seal into, as first used

A leader killed in the middle of ``/dir/assign?count=N`` never re-issues
or skips a key: a batch that committed is in the log the next leader
replays, and one that did not consumed nothing. ``capture`` and
``restore`` are the snapshot's form, the reference's, so a snapshot of
either package restores into the other.
"""

from __future__ import annotations

from typing import Optional


class MasterMetaLog:
    """The applied state, changed only by raft's apply (leader and
    followers alike)."""

    def __init__(self):
        self.next_key = 1                    # the next needle key
        self.assign_batches = 0              # batches applied
        self.volumes: dict[int, dict] = {}   # vid -> registry row
        self.geometry: dict[str, str] = {}   # collection -> "k+m"

    def apply(self, cmd: dict) -> Optional[int]:
        """Apply one command in log order; returns an assign batch's
        first key, else None. Deterministic: every replica folds the same
        commands into the same state."""
        result = None
        if "assign_batch" in cmd:
            count = max(1, int(cmd["assign_batch"]["count"]))
            result = self.next_key
            self.next_key += count
            self.assign_batches += 1
        if "seq_floor" in cmd:
            floor = int(cmd["seq_floor"])
            if floor >= self.next_key:
                self.next_key = floor + 1
        if "volume_create" in cmd:
            rec = dict(cmd["volume_create"])
            vid = int(rec.pop("vid"))
            self.volumes[vid] = rec
        if "volume_retire" in cmd:
            vr = cmd["volume_retire"]
            vids = vr.get("vids", [vr["vid"]] if "vid" in vr else [])
            for v in vids:
                self.volumes.pop(int(v), None)
        if "geometry_stamp" in cmd:
            st = cmd["geometry_stamp"]
            self.geometry[st.get("collection", "")] = st["geometry"]
        return result

    def capture(self) -> dict:
        return {"next_key": self.next_key,
                "assign_batches": self.assign_batches,
                "volumes": {str(v): dict(r)
                            for v, r in self.volumes.items()},
                "geometry": dict(self.geometry)}

    def restore(self, state: dict) -> None:
        self.next_key = max(self.next_key, int(state.get("next_key", 1)))
        self.assign_batches = max(self.assign_batches,
                                  int(state.get("assign_batches", 0)))
        # the snapshot's registry replaces this one: a follower that fell
        # behind must also forget the rows the leader retired before it
        # compacted, or the replicas stop converging
        self.volumes = {int(v): dict(rec)
                        for v, rec in (state.get("volumes") or {}).items()}
        self.geometry = dict(state.get("geometry") or {})

    def status(self) -> dict:
        return {"next_key": self.next_key,
                "assign_batches": self.assign_batches,
                "volumes": len(self.volumes),
                "geometry_stamps": dict(self.geometry)}
