"""Event-loop lag sampler.

The port's copy of seaweedfs_tpu/overload/sampler.py, whole.

Queue depth measures pressure on *admitted* work; loop lag measures
whether the event loop itself is keeping up — the one signal that
catches overload caused by anything (a blocking call that slipped
through, GC pauses, CPU starvation from a co-located encode job), not
just by request volume.  A task sleeps ``interval`` seconds and measures
how late the loop woke it: that lateness is exactly the extra latency
every other callback on this loop is currently paying.

The sampler's latest reading drives shed decisions (so recovery is
visible within one sampler window of the cause clearing), while a short
ring of recent samples backs ``recent_max()`` for tests and the
``/healthz`` state.
"""

from __future__ import annotations

import asyncio
from collections import deque
from typing import Optional


class LoopLagSampler:
    def __init__(self, interval: float = 0.1, window: int = 30,
                 metrics=None):
        self.interval = max(0.001, float(interval))
        self.metrics = metrics
        self.lag = 0.0                      # latest sample, seconds
        # optional per-tick hook: periodic gauge publication rides the
        # sampler so the admit hot path never pays for it
        self.on_sample = None
        self._samples: deque = deque(maxlen=max(1, window))
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.get_event_loop().create_task(self._run())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    @property
    def running(self) -> bool:
        return self._task is not None and not self._task.done()

    async def _run(self) -> None:
        loop = asyncio.get_event_loop()
        while True:
            t0 = loop.time()
            await asyncio.sleep(self.interval)
            # lateness of this wakeup == lateness of every callback that
            # was runnable during the stall
            lag = max(0.0, loop.time() - t0 - self.interval)
            self.lag = lag
            self._samples.append(lag)
            if self.metrics is not None:
                self.metrics.observe("admission_loop_lag", lag)
                self.metrics.gauge("admission_loop_lag_ms",
                                   round(lag * 1e3, 3))
            if self.on_sample is not None:
                try:
                    self.on_sample()
                except Exception:
                    pass  # a broken gauge hook must not kill the sampler

    def recent_max(self) -> float:
        """Largest lag over the retained window (seconds)."""
        return max(self._samples, default=0.0)
