"""Raft consensus for the masters' control plane.

The port's copy of seaweedfs_tpu/cluster/raft.py. Upstream elects a
leader among at most 5 masters (``weed master -peers``,
weed/server/raft_server.go:34-151) and replicates the volume-id counter
through the log (weed/topology/cluster_commands.go:8-31); the rest of
the topology is rebuilt from the volume servers' heartbeats. This node
runs on the master's aiohttp loop:

- election with a persisted term and vote and randomized timeouts, log
  replication with the standard commit rule (a leader commits an entry of
  its own term once a majority holds it);
- the log carries small JSON commands (the metadata log's, see
  metaring/masterlog.py), applied in order through ``apply_fn``;
  ``propose_apply`` hands the proposer its own command's apply result;
- ``ensure_ready``: a fresh leader commits a no-op of its term before it
  serves anything that depends on the applied state;
- past ``max_log_entries`` the applied prefix folds into ``snap_state``
  (``capture_fn``), and a follower behind the snapshot receives it inside
  AppendEntries (``restore_fn``);
- term, vote, log and snapshot go to ``<state_dir>/raft_state.json``
  through ``utils/durable.write_atomic``, on one save thread, so the loop
  never waits on an fsync and the writes keep their order.

The RPCs and the state file are the reference's, byte for byte, so either
package loads the other's state directory:

  POST /cluster/raft/vote    RequestVote
  POST /cluster/raft/append  AppendEntries (also the leader's heartbeat)

A node whose peer list names only itself leads from its construction
(the reference: from ``start``), so a single master needs no
configuration.

Differences from the reference:

- a loaded snapshot is applied state: after ``_load_state``,
  ``commit_index`` and ``last_applied`` start at ``snap_index``. The
  reference resets both to 0, so its first commit walks indices
  1..snap_index through ``_entry``, whose negative list index re-applies
  entries from the log's tail (ROADMAP Queue 3, F6: a restarted master's
  metadata log runs ahead of its replicas and the cluster mints fid keys
  twice);
- ``lease_valid``: a leader knows when a majority last answered it at its
  term. The masters' leader-only passes (vacuum, maintenance, lifecycle,
  balance) also require a live lease, so a leader cut off from the others
  stops acting on its stale topology within an election timeout, before
  the majority can have elected another (ROADMAP Queue 3, D13);
- ``leader_since``, when this node last won (a new leader's grace
  periods, server/master.py); ``stop`` waits for the queued state
  writes; a proposal stopped or deposed during its fsync returns at
  once instead of waiting out its timeout;
- a replication round sends nothing once its leader was deposed: each
  AppendEntries goes out only while the node still leads at the round's
  term. The reference builds each request from the node's current term,
  so a leader deposed by a RequestVote while its round is in flight sends
  a heartbeat at the candidate's term under its own name, and the
  candidate steps down (ROADMAP Queue 3, F7);
- a follower that refuses AppendEntries because ``prev_log_index`` lies
  past its log's end says where its log ends (``last_index`` in the
  reply), and the leader moves ``next_index`` there at once. The
  reference steps back one entry a heartbeat, so a node restarted behind
  a leader elected while it was down catches up one entry each 0.1 s
  (ROADMAP Queue 3, D19). A reply without the key, as the reference's
  are, still steps back by one;
- a leader or candidate that steps down restarts its election timer.
  The reference's timer runs on through a term of leading, so a leader
  deposed by a reply's higher term may campaign a few milliseconds
  later, before the new leader's first heartbeat reaches it, and unseat
  that leader (ROADMAP Queue 3, F8).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import logging
import os
import random
import socket
import time
from typing import Callable, Optional

import aiohttp

from ..utils import durable

log = logging.getLogger("raft")

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"


def _endpoint_ips(addr: str) -> tuple[set, str]:
    """(the host's addresses with the literal host, port) of host:port."""
    host, _, port = addr.rpartition(":")
    ips = {host}
    try:
        for info in socket.getaddrinfo(host, None):
            ips.add(info[4][0])
    except OSError:
        pass
    return ips, port


def same_endpoint(a: str, b: str) -> bool:
    """Whether two host:port strings name one endpoint, hostnames
    resolved: "localhost:9333" is "127.0.0.1:9333". A node that does not
    find itself in its peer list heartbeats its own endpoint, and the
    AppendEntries it sends itself demote it, so elections never end."""
    if a == b:
        return True
    a_ips, a_port = _endpoint_ips(a)
    b_ips, b_port = _endpoint_ips(b)
    return a_port == b_port and bool(a_ips & b_ips)


class RaftNode:
    def __init__(self, node_id: str, peers: list[str],
                 apply_fn: Callable[[dict], object],
                 election_timeout: tuple[float, float] = (0.3, 0.6),
                 heartbeat_interval: float = 0.1,
                 state_dir: Optional[str] = None,
                 capture_fn: Optional[Callable[[], dict]] = None,
                 restore_fn: Optional[Callable[[dict], None]] = None,
                 max_log_entries: int = 256):
        self.id = node_id
        self.peers = [p for p in peers if not same_endpoint(p, node_id)]
        self.apply_fn = apply_fn
        self.capture_fn = capture_fn
        self.restore_fn = restore_fn
        self.max_log_entries = max_log_entries
        self.election_timeout = election_timeout
        self.heartbeat_interval = heartbeat_interval
        self.state_path = (os.path.join(state_dir, "raft_state.json")
                           if state_dir else None)

        # persistent
        self.term = 0
        self.voted_for: Optional[str] = None
        self.log: list[dict] = []   # {"term": int, "cmd": dict}
        self.snap_index = 0         # last index folded into the snapshot
        self.snap_term = 0
        self.snap_state: dict = {}

        # volatile
        self.role = FOLLOWER
        self.leader_id: Optional[str] = None
        self.leader_since = 0.0     # monotonic time this node last won
        self.commit_index = 0       # 1-based; 0: nothing committed
        self.last_applied = 0
        self.next_index: dict[str, int] = {}
        self.match_index: dict[str, int] = {}
        # peer -> monotonic time of the last request it answered at this
        # node's term while it led (the lease)
        self._ack_at: dict[str, float] = {}

        # the snapshot is applied state (F6): loading sets commit_index
        # and last_applied to snap_index, after the volatile defaults
        self._load_state()

        self._session: Optional[aiohttp.ClientSession] = None
        # propose_apply's results: index -> apply_fn's return value, kept
        # only for the indices a local proposer waits on
        self._result_wanted: set[int] = set()
        self._apply_results: dict[int, object] = {}
        self._save_exec = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="raft-save")
        self._tasks: list[asyncio.Task] = []
        self._flushes: set[asyncio.Task] = set()   # _schedule_flush's
        self._timer_reset = asyncio.Event()
        self._commit_waiters: list[tuple[int, int, asyncio.Future]] = []
        self._stopped = False
        self._ready_term = -1
        if not self.peers:
            # alone: the leader from the start, every entry committed
            self._become_leader()

    # --- lifecycle ---
    async def start(self) -> None:
        self._session = aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=2.0))
        if self.peers:
            self._tasks.append(asyncio.create_task(self._election_timer()))

    async def stop(self) -> None:
        """Stop timers and replication; a stopped node is a follower to
        whatever still holds it. Waits for the queued state writes, so a
        node restarted on the same directory loads the last of them."""
        self._stopped = True
        self.role = FOLLOWER
        self._fail_waiters()
        tasks, self._tasks = self._tasks, []
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        if self._session is not None:
            await self._session.close()
            self._session = None
        await asyncio.get_running_loop().run_in_executor(
            None, lambda: self._save_exec.shutdown(wait=True))

    def _load_state(self) -> None:
        if not (self.state_path and os.path.exists(self.state_path)):
            return
        with open(self.state_path) as f:
            st = json.load(f)
        self.term = st["term"]
        self.voted_for = st.get("voted_for")
        self.log = st.get("log", [])
        self.snap_index = st.get("snap_index", 0)
        self.snap_term = st.get("snap_term", 0)
        self.snap_state = st.get("snap_state", {})
        if self.snap_state and self.restore_fn:
            self.restore_fn(self.snap_state)
        self.commit_index = self.last_applied = self.snap_index

    def _save_state(self) -> None:
        if self.state_path:
            self._write_state(self._serialize_state())

    def _serialize_state(self) -> str:
        """Serialized on the loop, so the file is one point in time even
        though the save thread writes it."""
        return json.dumps({"term": self.term, "voted_for": self.voted_for,
                           "log": self.log, "snap_index": self.snap_index,
                           "snap_term": self.snap_term,
                           "snap_state": self.snap_state})

    def _write_state(self, data: str) -> None:
        # a vote that vanishes in a crash lets this node vote twice in one
        # term: fsync the file, rename, fsync the directory
        durable.write_atomic(self.state_path, data)

    async def _flush_state(self) -> None:
        """A durable save; the loop awaits the save thread."""
        if not self.state_path:
            return
        data = self._serialize_state()
        await asyncio.get_running_loop().run_in_executor(
            self._save_exec, self._write_state, data)

    def _schedule_flush(self) -> None:
        """A save started from synchronous code (a step-down seen in a
        reply, a compaction); written in place when no loop runs."""
        if not self.state_path:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            self._save_state()
            return
        task = loop.create_task(self._flush_state())
        self._flushes.add(task)
        task.add_done_callback(self._flush_done)

    def _flush_done(self, task: asyncio.Task) -> None:
        self._flushes.discard(task)
        if not task.cancelled() and task.exception() is not None:
            log.error("%s: state flush failed: %s", self.id,
                      task.exception())

    # --- the log (1-based global indices; the list holds entries
    #     snap_index + 1 .. snap_index + len(log)) ---
    def _last_index(self) -> int:
        return self.snap_index + len(self.log)

    def _entry(self, index: int) -> dict:
        if not self.snap_index < index <= self._last_index():
            # a negative list index would read the log's tail (F6)
            raise IndexError(f"index {index} outside the log "
                             f"({self.snap_index}, {self._last_index()}]")
        return self.log[index - self.snap_index - 1]

    def _term_at(self, index: int) -> int:
        if index == self.snap_index:
            return self.snap_term
        if self.snap_index < index <= self._last_index():
            return self._entry(index)["term"]
        return 0

    def _maybe_compact(self) -> None:
        """Fold the applied entries into the snapshot once the log holds
        more than max_log_entries."""
        if len(self.log) <= self.max_log_entries:
            return
        cut = self.last_applied - self.snap_index
        if cut <= 0:
            return
        self.snap_term = self._term_at(self.last_applied)
        del self.log[:cut]
        self.snap_index = self.last_applied
        self.snap_state = self.capture_fn() if self.capture_fn else {}
        self._schedule_flush()

    @property
    def is_leader(self) -> bool:
        return self.role == LEADER

    @property
    def quorum(self) -> int:
        return (len(self.peers) + 1) // 2 + 1

    def lease_valid(self) -> bool:
        """Whether this node leads and a majority answered it at its term
        within the shortest election timeout: no other leader can have
        been elected since (a follower waits at least that long)."""
        if self.role != LEADER:
            return False
        since = time.monotonic() - self.election_timeout[0]
        fresh = sum(1 for p in self.peers
                    if self._ack_at.get(p, float("-inf")) >= since)
        return 1 + fresh >= self.quorum

    # --- election ---
    async def _election_timer(self) -> None:
        while not self._stopped:
            timeout = random.uniform(*self.election_timeout)
            try:
                await asyncio.wait_for(self._timer_reset.wait(), timeout)
                self._timer_reset.clear()
                continue
            except asyncio.TimeoutError:
                pass
            if self.role != LEADER:
                await self._run_election()

    async def _run_election(self) -> None:
        self.role = CANDIDATE
        self.term += 1
        self.voted_for = self.id
        term = self.term
        await self._flush_state()
        if self.term != term or self.role != CANDIDATE:
            return  # a higher term arrived during the fsync
        log.info("%s: starting election for term %d", self.id, term)
        votes = 1
        req = {"term": term, "candidate_id": self.id,
               "last_log_index": self._last_index(),
               "last_log_term": self._term_at(self._last_index())}
        replies = await asyncio.gather(
            *[self._post(p, "/cluster/raft/vote", req) for p in self.peers],
            return_exceptions=True)
        if self.term != term or self.role != CANDIDATE:
            return
        for r in replies:
            if isinstance(r, dict):
                if r.get("term", 0) > self.term:
                    self._step_down(r["term"])
                    return
                if r.get("granted"):
                    votes += 1
        if votes >= self.quorum:
            self._become_leader()

    def _become_leader(self) -> None:
        log.info("%s: leader for term %d", self.id, self.term)
        self.role = LEADER
        self.leader_id = self.id
        self.leader_since = time.monotonic()
        nxt = self._last_index() + 1
        self.next_index = {p: nxt for p in self.peers}
        self.match_index = {p: 0 for p in self.peers}
        self._ack_at = {}
        if not self.peers:
            self.commit_index = self._last_index()
            self._apply_committed()
            return
        self._tasks = [t for t in self._tasks if not t.done()]
        self._tasks.append(asyncio.create_task(self._leader_loop()))

    def _step_down(self, term: int, flush: bool = True) -> None:
        if term > self.term:
            self.term = term
            self.voted_for = None
            # the RPC handlers pass flush=False: the save they await
            # before replying carries the new term
            if flush:
                self._schedule_flush()
        if self.role != FOLLOWER:
            log.info("%s: stepping down at term %d", self.id, term)
            # a deposed leader or candidate waits a whole election
            # timeout for the new leader (F8): its timer ran on while it
            # led and may be about to fire
            self._timer_reset.set()
        self.role = FOLLOWER
        self._fail_waiters()

    async def _leader_loop(self) -> None:
        term = self.term
        while not self._stopped and self.role == LEADER and self.term == term:
            await self._replicate_round()
            await asyncio.sleep(self.heartbeat_interval)

    async def _replicate_round(self) -> None:
        term = self.term
        await asyncio.gather(
            *[self._replicate_to(p, term) for p in self.peers],
            return_exceptions=True)
        self._advance_commit()

    async def _replicate_to(self, peer: str, term: int) -> None:
        if self.role != LEADER or self.term != term:
            # deposed since the round began: a request built now would
            # carry a term this node never won
            return
        nxt = self.next_index.get(peer, self._last_index() + 1)
        if nxt <= self.snap_index:
            # the follower is behind the compacted log: the snapshot
            # rides this AppendEntries
            nxt = self.snap_index + 1
        prev = nxt - 1
        entries = self.log[nxt - self.snap_index - 1:]
        req = {"term": term, "leader_id": self.id,
               "prev_log_index": prev, "prev_log_term": self._term_at(prev),
               "entries": entries, "leader_commit": self.commit_index}
        if prev == self.snap_index and self.snap_index > 0:
            req["snapshot"] = {"state": self.snap_state,
                               "index": self.snap_index,
                               "term": self.snap_term}
        sent = time.monotonic()
        r = await self._post(peer, "/cluster/raft/append", req)
        if not isinstance(r, dict) or self.role != LEADER:
            return
        if r.get("term", 0) > self.term:
            self._step_down(r["term"])
            return
        if r.get("term") == term == self.term:
            self._ack_at[peer] = max(self._ack_at.get(peer, sent), sent)
        if r.get("success"):
            self.match_index[peer] = prev + len(entries)
            self.next_index[peer] = self.match_index[peer] + 1
        else:
            nxt -= 1
            hint = r.get("last_index")
            if isinstance(hint, int):
                # the follower's log ends before prev: probe its end next
                nxt = min(nxt, hint + 1)
            self.next_index[peer] = max(1, nxt)

    def _advance_commit(self) -> None:
        if self.role != LEADER:
            return
        for n in range(self._last_index(), self.commit_index, -1):
            if self._term_at(n) != self.term:
                break
            count = 1 + sum(1 for p in self.peers
                            if self.match_index.get(p, 0) >= n)
            if count >= self.quorum:
                self.commit_index = n
                break
        self._apply_committed()

    def _apply_committed(self) -> None:
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            try:
                ret = self.apply_fn(self._entry(self.last_applied)["cmd"])
                if self.last_applied in self._result_wanted:
                    self._apply_results[self.last_applied] = ret
            except Exception as e:
                log.error("apply failed at %d: %s", self.last_applied, e)
        self._maybe_compact()
        done, self._commit_waiters = self._commit_waiters, []
        for index, term, fut in done:
            if fut.done():
                continue
            if index <= self.commit_index:
                fut.set_result(self._term_at(index) == term)
            else:
                self._commit_waiters.append((index, term, fut))

    def _fail_waiters(self) -> None:
        done, self._commit_waiters = self._commit_waiters, []
        for _, _, fut in done:
            if not fut.done():
                fut.set_result(False)

    # --- the proposers' API ---
    async def ensure_ready(self, timeout: float = 5.0) -> bool:
        """The leader's readiness barrier: a no-op of the current term,
        committed once per term, so every earlier entry is committed and
        applied here before anything reads the applied state."""
        if self.role != LEADER:
            return False
        if self._ready_term == self.term:
            return True
        ok = await self.propose({"noop": True}, timeout)
        if ok:
            self._ready_term = self.term
        return ok

    async def propose(self, cmd: dict, timeout: float = 5.0) -> bool:
        """Append `cmd`; True once it commits at this node's term, False
        if leadership is lost or the timeout passes."""
        ok, _ = await self.propose_apply(cmd, timeout, want_result=False)
        return ok

    async def propose_apply(self, cmd: dict, timeout: float = 5.0,
                            want_result: bool = True
                            ) -> tuple[bool, object]:
        """propose() that also returns what apply_fn returned for this
        command: an assign batch's first key comes from the replicated
        counter at its place in the log, and a concurrent proposal may
        have advanced the counter since."""
        if self.role != LEADER:
            return False, None
        self.log.append({"term": self.term, "cmd": cmd})
        # the index before any await: a concurrent proposal may append
        # during the fsync
        index = self._last_index()
        if want_result:
            self._result_wanted.add(index)
        try:
            await self._flush_state()
            if self._stopped or self.role != LEADER:
                # stopped or deposed during the fsync: no waiter would
                # ever be resolved
                return False, None
            if not self.peers:
                self.commit_index = index
                self._apply_committed()
                return True, self._apply_results.pop(index, None)
            fut = asyncio.get_running_loop().create_future()
            self._commit_waiters.append((index, self.term, fut))
            await self._replicate_round()
            try:
                ok = await asyncio.wait_for(fut, timeout)
            except asyncio.TimeoutError:
                ok = False
            return ok, (self._apply_results.pop(index, None)
                        if ok else None)
        finally:
            self._result_wanted.discard(index)
            self._apply_results.pop(index, None)

    # --- RPC handlers (the master's raft routes) ---
    async def handle_vote(self, req: dict) -> dict:
        term_changed = req["term"] > self.term
        if term_changed:
            self._step_down(req["term"], flush=False)
        granted = False
        if req["term"] == self.term and \
                self.voted_for in (None, req["candidate_id"]):
            up_to_date = (
                req["last_log_term"], req["last_log_index"]
            ) >= (self._term_at(self._last_index()), self._last_index())
            if up_to_date:
                granted = True
                self.voted_for = req["candidate_id"]
                self._timer_reset.set()
        if term_changed or granted:
            # term and vote are durable before the reply
            await self._flush_state()
        return {"term": self.term, "granted": granted}

    async def handle_append(self, req: dict) -> dict:
        if req["term"] < self.term:
            return {"term": self.term, "success": False}
        term_changed = req["term"] > self.term
        if term_changed or self.role != FOLLOWER:
            self._step_down(req["term"], flush=False)
        if term_changed:
            # the new term is durable before anything is acknowledged at it
            await self._flush_state()
        self.leader_id = req["leader_id"]
        self._timer_reset.set()

        snap = req.get("snapshot")
        if snap and snap["index"] > self.snap_index:
            # install the leader's snapshot: its state, an empty log
            if self.restore_fn:
                self.restore_fn(snap["state"])
            self.log = []
            self.snap_index = snap["index"]
            self.snap_term = snap["term"]
            self.snap_state = snap["state"]
            self.commit_index = max(self.commit_index, snap["index"])
            self.last_applied = max(self.last_applied, snap["index"])
            await self._flush_state()

        prev = req["prev_log_index"]
        if prev < self.snap_index:
            # below this node's snapshot floor: all of that is committed
            return {"term": self.term, "success": False}
        if prev > self._last_index():
            # where this log ends, so the leader skips the gap (D19)
            return {"term": self.term, "success": False,
                    "last_index": self._last_index()}
        if prev > 0 and self._term_at(prev) != req["prev_log_term"]:
            return {"term": self.term, "success": False}
        # append, truncating at the first conflict
        idx = prev
        for entry in req["entries"]:
            idx += 1
            if idx <= self._last_index():
                if self._term_at(idx) != entry["term"]:
                    del self.log[idx - self.snap_index - 1:]
                    self.log.append(entry)
            else:
                self.log.append(entry)
        if req["entries"]:
            # the entries are durable before the leader counts them
            await self._flush_state()
        if req["leader_commit"] > self.commit_index:
            self.commit_index = min(req["leader_commit"], self._last_index())
            self._apply_committed()
        return {"term": self.term, "success": True}

    async def _post(self, peer: str, path: str, body: dict):
        try:
            async with self._session.post(f"http://{peer}{path}",
                                          json=body) as r:
                return await r.json()
        except Exception:
            return None
