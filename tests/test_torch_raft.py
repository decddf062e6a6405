"""The port's raft plane (seaweedfs_torch/cluster/raft.py) and metadata
log (seaweedfs_torch/metaring/masterlog.py) against the reference's.

(a) ``MasterMetaLog``: seeded sequences of 500 commands of all five
kinds go through both packages; after every command the returned key
and ``capture()`` are equal, and each package's capture restores into the
other's log. (b) ``RaftNode``'s handlers: seeded sequences of
RequestVote and AppendEntries requests (stale terms, conflicting entries
that truncate, ``prev_log_index`` below the snapshot floor, snapshot
installs, ``leader_commit`` past the last entry) go to a port node and a
reference node, both with peers and not started: equal responses (the
port's refusal of a ``prev_log_index`` past its log's end also carries
``last_index``, D19), equal state after each request and equal
``raft_state.json`` bytes; the state
directory each writes loads in the other, and the masters' snapshots
restore across the packages. (c) F6: a restarted node of the reference
re-applies log entries from its tail (its metadata log runs ahead of its
replicas' and the cluster mints keys twice); the port's replicas stay
equal and mint no key twice. The scenario waits, at each step, until
every running node holds the leader's log and commit index. (d) F7: a
leader deposed by a RequestVote while its replication round is queued
sends, in the reference, AppendEntries at the candidate's term under its
own name (the candidate then steps down); the port's sends nothing. (e)
D19: a follower whose log ends far before the leader's ``next_index``
(a node restarted behind a leader elected while it was down) matches in
the reference after one round per missing entry, in the port after two.
"""

import asyncio
import functools
import json
import signal
import time

import numpy as np
import pytest

from seaweedfs_torch.cluster import raft as praft
from seaweedfs_torch.metaring import MasterMetaLog as PMetaLog
from seaweedfs_torch.server.master import MasterServer as PMaster
from seaweedfs_tpu.cluster import raft as rraft
from seaweedfs_tpu.metaring import MasterMetaLog as RMetaLog
from seaweedfs_tpu.server.master import MasterServer as RMaster

# numeric addresses: a node resolves its peers' hosts to recognize itself
PEERS = ["127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"]
N1, N2, N3 = PEERS


def within(seconds: int):
    """Fail the test with TimeoutError after `seconds` (SIGALRM)."""
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


def _metalog_cmd(rng, next_key: int, vids: list) -> dict:
    """One command of a random kind; floors below and above next_key,
    retirements by "vid" and by "vids"."""
    kind = int(rng.integers(0, 7))
    if kind <= 1:
        return {"assign_batch": {"count": int(rng.integers(-2, 40))}}
    if kind == 2:
        return {"seq_floor": int(next_key + rng.integers(-30, 30))}
    if kind == 3:
        vid = int(rng.integers(1, 60))
        return {"volume_create": {
            "vid": vid, "collection": ["", "a", "b"][vid % 3],
            "replication": ["000", "001", "010"][vid % 3],
            "ttl": ["", "3m"][vid % 2]}}
    if kind == 4:
        return {"volume_retire": {"vid": int(rng.integers(1, 60))}}
    if kind == 5:
        pick = [int(v) for v in rng.choice(vids or [1], size=3)]
        return {"volume_retire": {"vids": pick + [999]}}
    return {"geometry_stamp": {
        "collection": ["", "a", "archive"][int(rng.integers(0, 3))],
        "geometry": ["10+4", "20+4", "6+3"][int(rng.integers(0, 3))]}}


def _metalog_cmds(seed: int, n: int = 500) -> list:
    rng = np.random.default_rng(seed)
    shadow = PMetaLog()
    cmds = []
    for _ in range(n):
        cmd = _metalog_cmd(rng, shadow.next_key, list(shadow.volumes))
        if rng.random() < 0.1:
            # a combined entry, as /dir/assign's first-use stamp is
            cmd.update(_metalog_cmd(rng, shadow.next_key,
                                    list(shadow.volumes)))
        shadow.apply(json.loads(json.dumps(cmd)))
        cmds.append(cmd)
    return cmds


# --- (a) the metadata log ---------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metalog_matches_reference(seed):
    r, p = RMetaLog(), PMetaLog()
    kinds = set()
    for cmd in _metalog_cmds(seed):
        kinds.update(cmd)
        assert p.apply(json.loads(json.dumps(cmd))) == r.apply(
            json.loads(json.dumps(cmd))), cmd
        assert p.capture() == r.capture(), cmd
    assert p.status() == r.status()
    assert kinds == {"assign_batch", "seq_floor", "volume_create",
                     "volume_retire", "geometry_stamp"}


@pytest.mark.parametrize("seed", [3, 4])
def test_metalog_captures_restore_across_packages(seed):
    """A capture of either package restores into the other's log (into
    a fresh one and over a diverged one) to the same state."""
    cmds = _metalog_cmds(seed, 300)
    for src_cls, dst_cls in ((PMetaLog, RMetaLog), (RMetaLog, PMetaLog)):
        src = src_cls()
        for cmd in cmds:
            src.apply(json.loads(json.dumps(cmd)))
        snap = json.loads(json.dumps(src.capture()))
        for dst in (dst_cls(), dst_cls()):
            for cmd in cmds[:50]:
                dst.apply(json.loads(json.dumps(cmd)))
            dst.restore(snap)
            assert dst.capture() == src.capture()


# --- (b) the handlers -------------------------------------------------

def _node(mod, metalog_cls, state_dir, max_log_entries=4):
    ml = metalog_cls()
    node = mod.RaftNode(N1, PEERS, ml.apply,
                        election_timeout=(30.0, 60.0), state_dir=state_dir,
                        capture_fn=ml.capture, restore_fn=ml.restore,
                        max_log_entries=max_log_entries)
    node.ml = ml
    return node


def _state(node) -> tuple:
    return (node.term, node.voted_for, json.loads(json.dumps(node.log)),
            node.snap_index, node.snap_term,
            json.loads(json.dumps(node.snap_state)), node.commit_index,
            node.last_applied, node.ml.capture())


def _requests(seed: int, n: int = 160) -> list:
    """A leader history with elections, conflicts and compactions, and
    the requests a follower would see of it, perturbed."""
    rng = np.random.default_rng(seed)
    shadow = PMetaLog()
    log: list = []          # the model leader's log
    term = 1
    reqs = []

    def entries_from(i: int) -> list:
        return json.loads(json.dumps(log[i:]))

    for _ in range(n):
        kind = ["vote", "append", "append", "append", "conflict", "stale",
                "snapshot", "below_floor", "commit_past"][
                    int(rng.integers(0, 9))]
        if kind == "vote":
            reqs.append(("vote", {
                "term": int(term + rng.integers(-1, 2)),
                "candidate_id": PEERS[int(rng.integers(1, 3))],
                "last_log_index": int(rng.integers(0, len(log) + 3)),
                "last_log_term": int(rng.integers(0, term + 2))}))
            continue
        cut = None
        if kind == "conflict":
            # a new leader whose log diverged near its end: its entries
            # at the new term replace the follower's from the cut on
            term += 1
            cut = max(0, len(log) - int(rng.integers(1, 4)))
            log = log[:cut]
        if kind in ("append", "conflict", "commit_past"):
            for _ in range(int(rng.integers(1 if cut is not None else 0,
                                            4))):
                cmd = _metalog_cmd(rng, shadow.next_key, [])
                shadow.apply(json.loads(json.dumps(cmd)))
                log.append({"term": term, "cmd": cmd})
        prev = max(0, len(log) - int(rng.integers(0, 5)))
        if cut is not None:
            prev = cut
        if kind == "below_floor":
            prev = int(rng.integers(0, 3))
        req_term = term - 1 if kind == "stale" else term
        commit = int(rng.integers(0, len(log) + 1))
        if kind == "commit_past":
            commit = len(log) + int(rng.integers(1, 5))
        req = {"term": req_term, "leader_id": N2,
               "prev_log_index": prev,
               "prev_log_term": log[prev - 1]["term"] if prev else 0,
               "entries": entries_from(prev), "leader_commit": commit}
        if kind == "snapshot" and log:
            # near the end: above the follower's own compactions
            idx = max(1, len(log) - int(rng.integers(0, 2)))
            folded = PMetaLog()
            for e in log[:idx]:
                folded.apply(json.loads(json.dumps(e["cmd"])))
            req.update({"prev_log_index": idx,
                        "prev_log_term": log[idx - 1]["term"],
                        "entries": entries_from(idx),
                        "leader_commit": max(commit, idx),
                        "snapshot": {"state": folded.capture(),
                                     "index": idx,
                                     "term": log[idx - 1]["term"]}})
        reqs.append(("append", req))
    return reqs


async def _settle(node) -> None:
    """Let a compaction's scheduled save run, then save once more."""
    for _ in range(3):
        await asyncio.sleep(0)
    await node._flush_state()


@pytest.mark.parametrize("seed", [10, 11, 13, 14])
@within(60)
def test_handlers_match_reference(seed, tmp_path):
    reqs = _requests(seed)
    kinds = {("snapshot" in r) if k == "append" else k for k, r in reqs}
    assert {"vote", True, False} <= kinds

    async def drive():
        (tmp_path / "p").mkdir()
        (tmp_path / "r").mkdir()
        p = _node(praft, PMetaLog, str(tmp_path / "p"))
        r = _node(rraft, RMetaLog, str(tmp_path / "r"))
        seen = {"truncated": False, "below_floor": False,
                "installed": False, "compacted": False, "hinted": False}
        for i, (kind, req) in enumerate(reqs):
            terms = {j: p._term_at(j) for j in range(
                p.snap_index + 1, p.snap_index + len(p.log) + 1)}
            handler = "handle_vote" if kind == "vote" else "handle_append"
            last_p = p._last_index()
            got_p = await getattr(p, handler)(json.loads(json.dumps(req)))
            got_r = await getattr(r, handler)(json.loads(json.dumps(req)))
            # the port's refusal of a prev past its log's end also says
            # where the log ends (D19); every other key is the reference's
            hint = got_p.pop("last_index", None)
            if hint is not None:
                seen["hinted"] = True
                assert not got_p["success"] and hint == last_p < \
                    req["prev_log_index"], (i, req, hint)
            assert got_p == got_r, (i, kind, req)
            await _settle(p)
            await _settle(r)
            assert _state(p) == _state(r), (i, kind, req)
            assert (tmp_path / "p" / "raft_state.json").read_bytes() == \
                (tmp_path / "r" / "raft_state.json").read_bytes(), i
            if kind == "append" and req["term"] >= p.term:
                if req.get("snapshot") and p.snap_index == \
                        req["snapshot"]["index"]:
                    seen["installed"] = True
                if req["prev_log_index"] < p.snap_index:
                    seen["below_floor"] = True
                if any(j > p.snap_index and p._term_at(j) != t
                       for j, t in terms.items()):
                    seen["truncated"] = True
                if p.snap_index and not req.get("snapshot"):
                    seen["compacted"] = True
        for node in (p, r):
            node._save_exec.shutdown(wait=True)
        return seen, p, r

    seen, p, r = asyncio.run(drive())
    assert all(seen.values()), seen

    # each package's state directory loads in the other: the persistent
    # fields are equal, and the state machine holds the snapshot
    def persistent(node):
        return (node.term, node.voted_for, node.log, node.snap_index,
                node.snap_term, node.snap_state)

    for src, mod, cls in (("p", rraft, RMetaLog), ("r", praft, PMetaLog)):
        loaded = _node(mod, cls, str(tmp_path / src))
        want = p if src == "p" else r
        assert persistent(loaded) == persistent(want)
        restored = cls()
        restored.restore(want.snap_state)
        assert loaded.ml.capture() == restored.capture()
        loaded._save_exec.shutdown(wait=False)


def test_master_snapshots_restore_across_packages():
    """A master's raft snapshot (volume-id counter, metadata log; the
    reference's also carries its filer ring and key ceiling) restores
    into the other package's master to the same assignment state."""
    cmds = _metalog_cmds(7, 200)
    for src_cls, dst_cls in ((RMaster, PMaster), (PMaster, RMaster)):
        src = src_cls()
        for i, cmd in enumerate(cmds):
            cmd = dict(cmd)
            if "volume_create" in cmd:
                cmd["max_volume_id"] = cmd["volume_create"]["vid"]
            src._raft_apply(json.loads(json.dumps(cmd)))
        snap = json.loads(json.dumps(src._raft_capture()))
        dst = dst_cls()
        dst._raft_restore(snap)
        assert dst.metalog.capture() == src.metalog.capture()
        assert dst.topology.max_volume_id == src.topology.max_volume_id
    # a ceiling-era entry of the reference folds in as a floor in both
    r, p = RMaster(), PMaster()
    for m in (r, p):
        m._raft_apply({"max_file_key": 5000})
        m._raft_restore({"max_file_key": 7000, "metalog": {}})
    assert p.metalog.capture() == r.metalog.capture()
    assert p.metalog.next_key == 7001


# --- (c) F6: a restarted node re-applies log entries ------------------

class _Net:
    """In-process transport: every node's _post calls the peer's
    handler directly; a node marked down answers nothing."""

    def __init__(self):
        self.nodes = {}
        self.down = set()

    def wire(self, node) -> None:
        self.nodes[node.id] = node

        async def post(peer, path, body, _me=node.id):
            target = self.nodes.get(peer)
            if target is None or peer in self.down or _me in self.down:
                return None
            handler = (target.handle_vote if path.endswith("/vote")
                       else target.handle_append)
            return await handler(json.loads(json.dumps(body)))

        node._post = post


async def _f6_scenario(mod, metalog_cls, tmp_path) -> dict:
    """Three nodes at max_log_entries=4: 7 batches of one key from N1;
    N2 (a follower) restarts on its state dir; N2 wins an election and
    assigns 3 batches; N3 (never restarted) wins one and assigns 3."""
    net = _Net()

    def make(nid):
        d = tmp_path / nid.replace(":", "_").replace(".", "_")
        d.mkdir(exist_ok=True)
        ml = metalog_cls()
        node = mod.RaftNode(nid, PEERS, ml.apply,
                            election_timeout=(30.0, 60.0),
                            heartbeat_interval=0.01, state_dir=str(d),
                            capture_fn=ml.capture, restore_fn=ml.restore,
                            max_log_entries=4)
        node.ml = ml
        net.wire(node)
        return node

    async def converge(bound: float = 10.0):
        """Until every node that is up holds the leader's last log index
        and commit index and has applied them (a restarted node catches
        up through the leader's appends); at most `bound` seconds."""
        deadline = time.monotonic() + bound
        while True:
            up = [n for nid, n in nodes.items() if nid not in net.down]
            leaders = [n for n in up if n.is_leader]
            if leaders:
                lead = max(leaders, key=lambda n: n.term)
                if all(n._last_index() == lead._last_index()
                       and n.commit_index == lead.commit_index
                       and n.last_applied == n.commit_index for n in up):
                    return
            assert time.monotonic() < deadline, "the nodes did not converge"
            await asyncio.sleep(0.01)

    nodes = {nid: make(nid) for nid in PEERS}
    keys = []
    tries = []

    async def elect(node):
        """Run node's election until it leads, as its election timer
        would (at most 3 rounds); the rounds it took go to `tries`. A
        deposed leader's round in flight can unseat a candidate of the
        reference (F7)."""
        for n in range(1, 4):
            await node._run_election()
            if node.is_leader:
                break
        tries.append(n)

    async def assign(leader, n):
        for _ in range(n):
            ok, key = await leader.propose_apply(
                {"assign_batch": {"count": 1}})
            assert ok
            keys.append(key)

    await elect(nodes[N1])
    assert nodes[N1].is_leader
    await assign(nodes[N1], 7)
    await converge()
    out = {"before_restart": {nid: n.ml.next_key
                              for nid, n in nodes.items()},
           "snap_index": nodes[N2].snap_index,
           "log_len": len(nodes[N2].log)}
    # restart N2 from its state dir
    net.down.add(N2)
    nodes[N2]._stopped = True
    await asyncio.sleep(0.05)
    nodes[N2]._save_exec.shutdown(wait=True)
    nodes[N2] = make(N2)
    net.down.discard(N2)
    await converge()
    out["after_restart"] = {nid: n.ml.next_key for nid, n in nodes.items()}
    # N2 leads and assigns
    await elect(nodes[N2])
    assert nodes[N2].is_leader
    await assign(nodes[N2], 3)
    await converge()
    # fail over to N3, which was never restarted
    await elect(nodes[N3])
    assert nodes[N3].is_leader
    await assign(nodes[N3], 3)
    await converge()
    out["keys"] = keys
    out["election_tries"] = tries
    out["captures"] = {nid: n.ml.capture() for nid, n in nodes.items()}
    for n in nodes.values():
        n._stopped = True
        n.role = "follower"
    await asyncio.sleep(0.05)
    for n in nodes.values():
        n._save_exec.shutdown(wait=True)
    return out


@within(60)
def test_f6_restarted_node_does_not_reapply(tmp_path):
    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    ref = asyncio.run(_f6_scenario(rraft, RMetaLog, tmp_path / "r"))
    port = asyncio.run(_f6_scenario(praft, PMetaLog, tmp_path / "p"))
    # the scenario: a compacted log with a tail behind the snapshot
    for out in (ref, port):
        assert out["snap_index"] >= 4 and out["log_len"] >= 1
        assert set(out["before_restart"].values()) == {8}
    # the reference: the restarted node re-applied tail entries, its
    # counter is ahead of its replicas'
    after = ref["after_restart"]
    assert after[N2] > after[N1] == after[N3] == 8, after
    # the port: every replica equal after the restart and at the end,
    # and no key minted twice across both failovers
    assert set(port["after_restart"].values()) == {8}
    # the port's deposed leader sends nothing at a term it did not win:
    # each election is won at its first round
    assert port["election_tries"] == [1, 1, 1]
    caps = list(port["captures"].values())
    assert caps[0] == caps[1] == caps[2]
    assert sorted(port["keys"]) == list(range(1, 14))
    assert caps[0]["next_key"] == 14


@within(30)
def test_f6_standalone_restart_keeps_the_counter(tmp_path):
    """One node, 11 batches at max_log_entries=4, a restart: the
    reference's counter moves from 12 to 13, the port's stays 12."""
    async def drive(mod, cls, d):
        def make():
            ml = cls()
            node = mod.RaftNode(N1, [], ml.apply, state_dir=str(d),
                                capture_fn=ml.capture,
                                restore_fn=ml.restore, max_log_entries=4)
            node.ml = ml
            return node
        node = make()
        await node.start()
        for _ in range(11):
            ok, _ = await node.propose_apply({"assign_batch": {"count": 1}})
            assert ok
        before = node.ml.next_key
        await node.stop()
        node._save_exec.shutdown(wait=True)
        again = make()
        await again.start()
        after = again.ml.next_key
        await again.stop()
        return before, after

    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    assert asyncio.run(drive(rraft, RMetaLog, tmp_path / "r")) == (12, 13)
    assert asyncio.run(drive(praft, PMetaLog, tmp_path / "p")) == (12, 12)


def test_same_endpoint_matches_reference():
    for a, b in [("localhost:9333", "127.0.0.1:9333"),
                 ("127.0.0.1:9333", "127.0.0.1:9334"),
                 ("127.0.0.1:1", "127.0.0.1:1")]:
        assert praft.same_endpoint(a, b) == rraft.same_endpoint(a, b)


# --- (d) F7: a deposed leader's queued round -------------------------------

async def _f7_scenario(mod, tmp_path) -> list:
    """N1 leads term 1; a replication round is started and, before its
    per-peer sends run, N2's RequestVote for term 2 reaches N1. Returns
    the (term, leader) of every AppendEntries N1 sent after the vote."""
    net = _Net()
    nodes = {}
    for nid in PEERS:
        d = tmp_path / nid.replace(":", "_").replace(".", "_")
        d.mkdir(exist_ok=True)
        nodes[nid] = mod.RaftNode(nid, PEERS, lambda cmd: None,
                                  election_timeout=(30.0, 60.0),
                                  heartbeat_interval=30.0,
                                  state_dir=str(d))
        net.wire(nodes[nid])
    n1 = nodes[N1]
    await n1._run_election()
    assert n1.is_leader and n1.term == 1
    sent = []
    real = n1._post

    async def post(peer, path, body):
        if path.endswith("/append") and voted:
            sent.append((body["term"], body["leader_id"]))
        return await real(peer, path, body)

    n1._post = post
    voted = False
    round_ = asyncio.ensure_future(n1._replicate_round())
    vote = asyncio.ensure_future(n1.handle_vote(
        {"term": 2, "candidate_id": N2,
         "last_log_index": n1._last_index(),
         "last_log_term": n1._term_at(n1._last_index())}))
    await asyncio.sleep(0)
    voted = True
    await asyncio.gather(round_, vote)
    for n in nodes.values():
        n._stopped = True
        n.role = "follower"
    await asyncio.sleep(0.05)
    for n in nodes.values():
        n._save_exec.shutdown(wait=True)
    return sent


@within(30)
def test_f7_deposed_leader_sends_nothing_at_the_new_term(tmp_path):
    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    ref = asyncio.run(_f7_scenario(rraft, tmp_path / "r"))
    port = asyncio.run(_f7_scenario(praft, tmp_path / "p"))
    # the reference: its queued sends carry term 2, a term N1 never won
    assert ref and all(t == 2 and who == N1 for t, who in ref), ref
    # the port: the round sees it was deposed and sends nothing
    assert port == []


# --- (e) D19: a follower far behind the leader's next_index ---------------

async def _d19_rounds(mod, tmp_path, leader_len: int = 300,
                      follower_len: int = 20) -> tuple[int, list, list]:
    """N1 leads term 2 with `leader_len` entries and next_index past its
    log's end for every peer (as set at its election); N2's log holds the
    first `follower_len` of them; N3 is down. Returns the replication
    rounds until N2 matches, and both logs."""
    net = _Net()
    nodes = {}
    for nid in PEERS:
        d = tmp_path / nid.replace(":", "_").replace(".", "_")
        d.mkdir(exist_ok=True)
        nodes[nid] = mod.RaftNode(nid, PEERS, lambda cmd: None,
                                  election_timeout=(30.0, 60.0),
                                  heartbeat_interval=30.0,
                                  state_dir=str(d), max_log_entries=10000)
        net.wire(nodes[nid])
    net.down.add(N3)
    n1, n2 = nodes[N1], nodes[N2]
    entries = [{"term": 1, "cmd": {"assign_batch": {"count": 1}}}
               for _ in range(leader_len)]
    n1.log, n1.term = list(entries), 2
    n2.log, n2.term = entries[:follower_len], 1
    n1.role, n1.leader_id = mod.LEADER, N1
    n1.next_index = {p: leader_len + 1 for p in PEERS if p != N1}
    n1.match_index = {p: 0 for p in PEERS if p != N1}
    rounds = 0
    while n1.match_index[N2] < leader_len and rounds < 2 * leader_len:
        await n1._replicate_round()
        rounds += 1
    for n in nodes.values():
        n._stopped = True
        n.role = mod.FOLLOWER
    for n in nodes.values():
        n._save_exec.shutdown(wait=True)
    return rounds, n1.log, n2.log


@within(60)
def test_d19_follower_far_behind_matches_in_two_rounds(tmp_path):
    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    ref_rounds, ref_lead, ref_follow = asyncio.run(
        _d19_rounds(rraft, tmp_path / "r"))
    port_rounds, port_lead, port_follow = asyncio.run(
        _d19_rounds(praft, tmp_path / "p"))
    # the reference steps back one entry a round: 280 refusals, then the
    # match
    assert ref_rounds == 300 - 20 + 1
    # the port jumps to the follower's end: one refusal, then the match
    assert port_rounds == 2
    assert ref_follow == ref_lead and port_follow == port_lead


# --- (f) F8: a deposed leader's election timer -------------------------------

async def _f8_delay(mod, tmp_path, timeout: float = 0.4,
                    led_for: float = 0.3) -> float:
    """N1 leads term 1 with its election timer running (a fixed timeout);
    after `led_for` s a replication round meets followers at term 5 and
    N1 steps down. Returns the seconds from the step-down to N1's next
    campaign."""
    net = _Net()
    nodes = {}
    for nid in PEERS:
        d = tmp_path / nid.replace(":", "_").replace(".", "_")
        d.mkdir(exist_ok=True)
        nodes[nid] = mod.RaftNode(nid, PEERS, lambda cmd: None,
                                  election_timeout=(timeout, timeout),
                                  heartbeat_interval=30.0,
                                  state_dir=str(d))
        net.wire(nodes[nid])
    n1 = nodes[N1]
    await n1._run_election()
    assert n1.is_leader and n1.term == 1
    campaigns = []

    async def campaign():
        campaigns.append(time.monotonic())

    n1._run_election = campaign
    timer = asyncio.ensure_future(n1._election_timer())
    await asyncio.sleep(led_for)
    for nid in (N2, N3):
        nodes[nid].term = 5
    await n1._replicate_round()
    assert n1.role == mod.FOLLOWER and n1.term == 5
    down = time.monotonic()
    while not campaigns and time.monotonic() - down < 3 * timeout:
        await asyncio.sleep(0.01)
    for t in [timer, *n1._tasks]:
        t.cancel()
    for n in nodes.values():
        n._stopped = True
        n.role = mod.FOLLOWER
    await asyncio.gather(timer, *n1._tasks, return_exceptions=True)
    for n in nodes.values():
        n._save_exec.shutdown(wait=True)
    assert campaigns
    return campaigns[0] - down


@within(30)
def test_f8_deposed_leader_waits_an_election_timeout(tmp_path):
    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    ref = asyncio.run(_f8_delay(rraft, tmp_path / "r"))
    port = asyncio.run(_f8_delay(praft, tmp_path / "p"))
    # the reference: the timer drawn while it led fires 0.1 s after the
    # step-down, before a new leader's heartbeat could come
    assert ref < 0.3, ref
    # the port: a whole election timeout after the step-down
    assert port >= 0.4, port
