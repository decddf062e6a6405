"""Declarative fault-injection plane: named points, env and code control.

The port's reduced copy of seaweedfs_tpu/faults/__init__.py. Hot paths
carry *named fault points*; a point does nothing until a fault is armed
against it (the disarmed check is one emptiness test on an almost always
empty list). Faults are armed by the ``WEED_FAULTS`` env at first use,
e.g.::

    WEED_FAULTS="ec.feed.read:error:p=0.5:count=3,ec.feed.stall:delay:ms=200"

or in code with :func:`set_fault`. Actions: ``delay`` (sleep ``ms``),
``error`` (raise :class:`FaultError`), ``drop`` (the call site discards
the operation; the feed turns that into a failed read), ``corrupt``
(flip one deterministic byte of a payload). Every fault has a
probability ``p`` rolled on its own ``random.Random(seed)`` and an
optional ``count`` budget after which it disarms itself.

The points this package fires are ``KNOWN_POINTS``; ``fire_async`` is
``fire`` for the servers' coroutines. Not ported: the ``/admin/faults``
handler.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Optional


class FaultError(RuntimeError):
    """An injected failure (action=error)."""


_ACTIONS = ("delay", "error", "drop", "corrupt")

# fire() consumes these; corrupt() consumes only "corrupt", so a corrupt
# fault at a point whose path calls both is not burned by the flow check
_FLOW_ACTIONS = ("delay", "error", "drop")


@dataclass
class Fault:
    point: str              # exact name, or prefix ending in '*'
    action: str
    p: float = 1.0          # firing probability per arrival
    count: Optional[int] = None   # remaining budget; None = unlimited
    ms: float = 0.0         # delay duration (action=delay)
    seed: int = 0
    fired: int = 0
    _rng: random.Random = field(default=None, repr=False)  # type: ignore

    def __post_init__(self):
        if self.action not in _ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}")
        self._rng = random.Random(self.seed)

    def matches(self, point: str) -> bool:
        if self.point.endswith("*"):
            return point.startswith(self.point[:-1])
        return self.point == point

    def to_dict(self) -> dict:
        d = {"point": self.point, "action": self.action, "p": self.p,
             "ms": self.ms, "seed": self.seed, "fired": self.fired}
        if self.count is not None:
            d["count"] = self.count
        return d


# the fault points this package fires (the reference's names)
KNOWN_POINTS = frozenset({
    "ec.feed.read",         # EC feed stripe/survivor reads (ec/feed.py)
    "ec.feed.stall",        # EC feed staging-buffer waits (ec/feed.py)
    "ec.fused.read",        # fused warm-down compaction-chunk reads
                            # (ec/fused.py); a drop fails the chunk
    "ec.fused.gzip",        # fused warm-down payload transform; a drop
                            # fails the gzip/splice stage
    "ec.fused.commit",      # fused warm-down commit barrier, after the
                            # shards, .dat, .idx and .ecx are durable and
                            # before the .ecm marker
    "disk.write",           # a volume's positioned .dat writes
                            # (storage/backend.py); a drop loses the bytes
    "disk.sync",            # a volume's .dat fsync barrier
    "volume.replicate",     # a volume server's write fan-out to replicas;
                            # a drop skips it, an error fails the write
    "lifecycle.warm",       # the start of a warm transition
    "lifecycle.encode",     # a warm transition's last step: the shard set
                            # verified mounted, the original not retired
    "lifecycle.unec",       # the start of an un-EC (decode) transition
    "lifecycle.expire",     # the start of a TTL expiry
    "master.balance.plan",  # a balancer planning pass; a drop skips it
    "master.balance.move",  # a balance move, before its copy step
    "sim.heartbeat",        # one clustersim node's heartbeat; a drop
                            # loses the beat (flap drills)
    "ring.proxy",           # a filer ring hop (proxy, mirror, handoff
                            # push); a drop is a peer gone mid-request
    "ring.handoff",         # a handoff's move of one directory; an error
                            # or drop is a runner that died mid-pass
    "http_pool.request",    # a pooled sync request (cache/http_pool.py);
                            # an error or drop counts as a host failure
    "http_pool.response",   # a pooled response's body (corrupt only)
})

_lock = threading.Lock()
_faults: list[Fault] = []
_env_loaded = False


def _parse_spec(spec: str) -> Fault:
    """'point:action[:k=v]*' -> Fault."""
    parts = [p for p in spec.strip().split(":") if p]
    if len(parts) < 2:
        raise ValueError(f"bad fault spec {spec!r} "
                         "(want point:action[:k=v]...)")
    kwargs: dict = {}
    for kv in parts[2:]:
        k, _, v = kv.partition("=")
        if k == "count":
            kwargs["count"] = int(v)
        elif k == "p":
            kwargs["p"] = float(v)
        elif k == "ms":
            kwargs["ms"] = float(v)
        elif k == "seed":
            kwargs["seed"] = int(v)
        else:
            raise ValueError(f"unknown fault param {k!r} in {spec!r}")
    return Fault(point=parts[0], action=parts[1], **kwargs)


def _ensure_env() -> None:
    global _env_loaded
    if _env_loaded:
        return
    with _lock:
        if _env_loaded:
            return
        _env_loaded = True
        env = os.environ.get("WEED_FAULTS", "")
        for spec in env.split(","):
            if spec.strip():
                _faults.append(_parse_spec(spec))


def set_fault(point: str, action: str, p: float = 1.0,
              count: Optional[int] = None, ms: float = 0.0,
              seed: int = 0) -> dict:
    """Arm a fault; returns its dict form."""
    _ensure_env()
    f = Fault(point=point, action=action, p=p, count=count, ms=ms,
              seed=seed)
    with _lock:
        _faults.append(f)
    return f.to_dict()


def clear(point: Optional[str] = None) -> int:
    """Disarm faults at `point` (exact registration string), or all."""
    global _faults
    _ensure_env()
    with _lock:
        before = len(_faults)
        if point is None or point == "*":
            _faults = []
        else:
            _faults = [f for f in _faults if f.point != point]
        return before - len(_faults)


def active() -> list[dict]:
    _ensure_env()
    with _lock:
        return [f.to_dict() for f in _faults]


def _arm(point: str, kinds: tuple) -> Optional[Fault]:
    """Roll the dice for `point`; returns the fault to apply (budget
    already consumed) or None. The disarmed fast path is one unlocked
    emptiness check (a stale read costs one extra lock round at worst)."""
    if _env_loaded and not _faults:
        return None
    _ensure_env()
    with _lock:
        if not _faults:
            return None
        for f in _faults:
            if f.action not in kinds or not f.matches(point):
                continue
            if f.count is not None and f.count <= 0:
                continue
            if f.p < 1.0 and f._rng.random() >= f.p:
                continue
            f.fired += 1
            if f.count is not None:
                f.count -= 1
            return f
    return None


def fire(point: str) -> bool:
    """Hook for sync call sites. Applies any armed delay/error fault;
    returns True when the operation should be silently DROPPED."""
    f = _arm(point, _FLOW_ACTIONS)
    if f is None:
        return False
    if f.action == "delay":
        # the injected delay is a fault.<point> span, so a drill's latency
        # is attributed to the faulted point
        from .. import observe
        with observe.span(f"fault.{point}"):
            time.sleep(f.ms / 1000.0)
        return False
    if f.action == "error":
        raise FaultError(f"injected fault at {point}")
    return True  # drop


async def fire_async(point: str) -> bool:
    """fire() for coroutine call sites: a delay parks on the loop instead
    of blocking it."""
    f = _arm(point, _FLOW_ACTIONS)
    if f is None:
        return False
    if f.action == "delay":
        import asyncio

        from .. import observe
        with observe.span(f"fault.{point}"):
            await asyncio.sleep(f.ms / 1000.0)
        return False
    if f.action == "error":
        raise FaultError(f"injected fault at {point}")
    return True


def corrupt(point: str, data: bytes) -> bytes:
    """Apply an armed corrupt fault to a payload: one byte, chosen by the
    fault's deterministic rng, is bit-flipped. No fault -> data verbatim."""
    if not data:
        return data
    f = _arm(point, ("corrupt",))
    if f is None:
        return data
    pos = f._rng.randrange(len(data))
    out = bytearray(data)
    out[pos] ^= 0xFF
    return bytes(out)
