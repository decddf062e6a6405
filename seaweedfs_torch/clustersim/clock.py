"""The virtual clock every simulated component shares.

The port's copy of seaweedfs_tpu/clustersim/clock.py. ``Topology``
takes ``now`` as its injected clock, and the balance planner and
``PlannerState`` take ``now`` arguments, so the whole control plane runs
on simulated time: time moves only when the simulator says so, which is
what lets a 1000-node run of minutes of virtual time finish in seconds
and replay bit for bit from its seed. The epoch is far from zero, so no
default timestamp of the production code sits inside a decay half-life
of t = 0.
"""

from __future__ import annotations

EPOCH = 1_700_000_000.0


class VirtualClock:
    __slots__ = ("_now",)

    def __init__(self, start: float = EPOCH):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError("virtual time never rewinds")
        self._now += dt
        return self._now
