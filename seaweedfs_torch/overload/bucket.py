"""Token buckets for admission metering.

The port's copy of seaweedfs_tpu/overload/bucket.py, whole.

One :class:`TokenBucket` is the classic leaky-refill shape: capacity
``burst`` tokens, refilled continuously at ``rate`` tokens/second on a
monotonic clock.  Refill happens inside the same lock that spends, and
always from the stored timestamp — concurrent acquirers can never
double-count an elapsed interval (no refill drift), which is what the
isolation tests pin down.

:class:`TenantBuckets` is the per-tenant tier of the hierarchy: a
bounded map of lazily-created buckets keyed by tenant (S3 access key or
collection).  Bounded because tenant keys are client-chosen strings — an
attacker must not be able to grow server memory one curl at a time.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Optional


class TokenBucket:
    """Thread-safe token bucket on a monotonic clock.

    ``rate`` tokens/second refill, ``burst`` capacity.  ``try_acquire``
    never blocks — admission control wants an immediate verdict so a
    shed can be answered in microseconds.
    """

    __slots__ = ("rate", "burst", "_tokens", "_last", "_clock", "_lock")

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        if rate <= 0:
            raise ValueError("rate must be > 0")
        self.rate = float(rate)
        self.burst = float(burst) if burst > 0 else float(rate)
        self._tokens = self.burst
        self._clock = clock
        self._last = clock()
        self._lock = threading.Lock()

    def _refill_locked(self, now: float) -> None:
        elapsed = now - self._last
        if elapsed <= 0:
            return  # clock went nowhere (or backwards): no free tokens
        self._tokens = min(self.burst, self._tokens + elapsed * self.rate)
        self._last = now

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill_locked(self._clock())
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def set_rate(self, rate: float, burst: Optional[float] = None) -> None:
        """Retune the bucket in place (striped admission rebalance).

        Refills at the OLD rate up to now before switching, so a rate
        change mid-interval never grants or steals tokens retroactively;
        shrinking the burst clamps the balance so a shard whose stripe
        just shrank can't spend a stale surplus.
        """
        if rate <= 0:
            raise ValueError("rate must be > 0")
        with self._lock:
            self._refill_locked(self._clock())
            self.rate = float(rate)
            if burst is not None:
                self.burst = float(burst) if burst > 0 else float(rate)
                self._tokens = min(self._tokens, self.burst)

    def tokens(self) -> float:
        """Current token count (refreshes refill) — for gauges/tests."""
        with self._lock:
            self._refill_locked(self._clock())
            return self._tokens


class TenantBuckets:
    """Bounded per-tenant bucket map (the per-tenant tier).

    Eviction is oldest-touched-first: a tenant idle long enough to be
    evicted restarts with a full burst, which errs on the side of
    admitting — correct for a limiter that exists to stop *sustained*
    hogging, not to meter precisely across evictions.
    """

    def __init__(self, rate: float, burst: float, max_tenants: int = 4096,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst) if burst > 0 else float(rate)
        self.max_tenants = max_tenants
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: "OrderedDict[str, TokenBucket]" = OrderedDict()

    def _get(self, tenant: str) -> TokenBucket:
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                b = TokenBucket(self.rate, self.burst, clock=self._clock)
                self._buckets[tenant] = b
                while len(self._buckets) > self.max_tenants:
                    self._buckets.popitem(last=False)
            else:
                self._buckets.move_to_end(tenant)
            return b

    def set_rate(self, rate: float, burst: float) -> None:
        """Retune the tier: future buckets are born at the new rate and
        every live tenant bucket is retuned in place (striped admission
        rebalance must reach tenants already being hammered)."""
        with self._lock:
            self.rate = float(rate)
            self.burst = float(burst) if burst > 0 else float(rate)
            live = list(self._buckets.values())
        for b in live:
            b.set_rate(self.rate, self.burst)

    def try_acquire(self, tenant: str, n: float = 1.0) -> bool:
        if not tenant:
            return True  # untenanted traffic is metered by the global tier
        return self._get(tenant).try_acquire(n)

    def tokens(self, tenant: str) -> Optional[float]:
        with self._lock:
            b = self._buckets.get(tenant)
        return None if b is None else b.tokens()

    def __len__(self) -> int:
        with self._lock:
            return len(self._buckets)
