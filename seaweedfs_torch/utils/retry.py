"""The failure discipline of the port's clients: ``RetryPolicy``, a
per-host circuit breaker, and the request deadline budget.

The port's copy of seaweedfs_tpu/utils/retry.py:

* :class:`RetryPolicy`: jittered exponential backoff (``base *
  mult^attempt``, +/- ``jitter`` of it), capped at ``max_delay`` and by
  the ambient deadline budget.
* :class:`CircuitBreaker`: a per-host three-state breaker. After
  ``failure_threshold`` consecutive failures a host opens: calls fail
  fast, with no dial, until ``open_seconds`` pass; then one half-open
  probe is let through, whose success closes the breaker and whose
  failure opens it again. :func:`shared_breaker` is the process-wide
  instance, so the evidence of a dead peer gathered on one path
  protects the others (the volume server's read repair uses it).
* The deadline budget: a caller's time budget rides the
  ``X-Seaweed-Deadline`` header as the remaining seconds (relative, so
  clock skew between nodes never corrupts it). A server rebases it onto
  its own clock into a contextvar (:func:`bind_deadline`); outbound
  calls re-inject what is left (:func:`inject_deadline`) and cap their
  socket timeouts to it (:func:`cap_timeout`).

Left out: the retry count on the ambient request's wide event, which
the port's wide events do not carry.
"""

from __future__ import annotations

import contextvars
import random
import threading
import time
from typing import Optional

DEADLINE_HEADER = "X-Seaweed-Deadline"

# statuses worth retrying after a pause: transient overload (429/503 —
# the admission plane's shed answers), bad gateway / gateway timeout
# from a proxy mid-failover
RETRYABLE_STATUSES = frozenset({429, 502, 503, 504})

# cap on how long a client will honor a server-sent Retry-After: a
# buggy or hostile header must not park a retry loop for an hour
MAX_RETRY_AFTER_S = 30.0


def parse_retry_after(value) -> Optional[float]:
    """Retry-After header -> seconds (delta-seconds or HTTP-date form),
    clamped to [0, MAX_RETRY_AFTER_S]; None when absent/unparseable."""
    if not value:
        return None
    try:
        return min(max(0.0, float(value)), MAX_RETRY_AFTER_S)
    except (TypeError, ValueError):
        pass
    try:
        from email.utils import parsedate_to_datetime
        dt = parsedate_to_datetime(value)
        return min(max(0.0, dt.timestamp() - time.time()),
                   MAX_RETRY_AFTER_S)
    except (TypeError, ValueError):
        return None


def is_shed(status: int, headers) -> bool:
    """True when a response is the overload plane's shed answer
    (``X-Seaweed-Shed: 1`` on a 429/503): the host is ALIVE and asked us
    to back off — it must not be charged as a circuit-breaker failure,
    or a load spike trips every breaker and becomes a capacity
    collapse."""
    if status not in (429, 503) or headers is None:
        return False
    v = headers.get("x-seaweed-shed", "") or headers.get(
        "X-Seaweed-Shed", "")
    return str(v).strip() == "1"

_deadline: contextvars.ContextVar[float] = contextvars.ContextVar(
    "sw_deadline", default=0.0)


class BreakerOpen(ConnectionError):
    """Fast-failure for a host whose circuit breaker is open. Subclasses
    ConnectionError so existing replica-rotation handlers treat it like
    any other connection failure (move on to the next host)."""


class DeadlineExceeded(TimeoutError):
    """The request's propagated deadline budget is exhausted."""


# --- deadline budget ---

def bind_deadline(headers) -> Optional[contextvars.Token]:
    """Bind an incoming X-Seaweed-Deadline (remaining seconds, relative)
    into the ambient context, rebased onto THIS node's clock; returns
    the reset token (None if absent/bad). Relative-per-hop means clock
    skew never corrupts the budget — only network latency leaks in,
    exactly grpc's deadline tradeoff."""
    raw = headers.get(DEADLINE_HEADER, "") if headers else ""
    if not raw:
        return None
    try:
        left = float(raw)
    except ValueError:
        return None
    return _deadline.set(time.time() + max(left, 0.0))


def reset_deadline(token) -> None:
    if token is not None:
        _deadline.reset(token)


def set_deadline(seconds_from_now: float) -> contextvars.Token:
    """Start a fresh budget (entry-point clients)."""
    return _deadline.set(time.time() + seconds_from_now)


def current_deadline() -> float:
    """Ambient absolute deadline, 0.0 when none is set."""
    return _deadline.get()


def remaining_budget() -> Optional[float]:
    """Seconds left in the ambient budget (None = unbounded). Clamped at
    0.0 — callers decide whether that is an error."""
    dl = _deadline.get()
    if not dl:
        return None
    return max(0.0, dl - time.time())


def inject_deadline(headers: dict) -> dict:
    """Add the ambient budget's REMAINING seconds to an outbound header
    dict (no-op when no budget is active)."""
    dl = _deadline.get()
    if dl:
        headers.setdefault(DEADLINE_HEADER,
                           repr(max(dl - time.time(), 0.0)))
    return headers


def cap_timeout(timeout: Optional[float],
                floor: float = 0.001) -> Optional[float]:
    """The smaller of a socket timeout and the remaining budget. Raises
    DeadlineExceeded when the budget is already gone — better to fail
    before the dial than to hand a 0-second timeout to the socket
    layer."""
    left = remaining_budget()
    if left is None:
        return timeout
    if left <= 0.0:
        raise DeadlineExceeded("deadline budget exhausted")
    left = max(left, floor)
    return left if timeout is None else min(timeout, left)


# --- circuit breaker ---

class _HostState:
    __slots__ = ("failures", "opened_at", "probing", "probe_started")

    def __init__(self):
        self.failures = 0
        self.opened_at = 0.0     # 0 = closed
        self.probing = False     # a half-open probe is in flight
        self.probe_started = 0.0


class CircuitBreaker:
    """Per-host breaker. Thread-safe; keys are opaque strings (host:port
    urls in practice)."""

    def __init__(self, failure_threshold: int = 5,
                 open_seconds: float = 15.0, metrics=None):
        self.failure_threshold = failure_threshold
        self.open_seconds = open_seconds
        self.metrics = metrics
        self._lock = threading.Lock()
        self._hosts: dict[str, _HostState] = {}

    def _count(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.count(f"breaker_{name}")

    def check(self, host: str) -> None:
        """Raise BreakerOpen when `host` is open (and no probe slot is
        available). An expired open window admits exactly one half-open
        probe; concurrent callers keep failing fast until it resolves.
        A probe that never reports back (its caller raised past both
        record_* calls) forfeits the slot after another open window, so
        a lost probe can't wedge the host fast-failing forever."""
        with self._lock:
            st = self._hosts.get(host)
            if st is None or not st.opened_at:
                return
            now = time.monotonic()
            if now - st.opened_at >= self.open_seconds and (
                    not st.probing
                    or now - st.probe_started >= self.open_seconds):
                st.probing = True  # this caller is the probe
                st.probe_started = now
                self._count("half_open")
                return
        self._count("fast_fail")
        raise BreakerOpen(f"circuit breaker open for {host}")

    def record_success(self, host: str) -> None:
        with self._lock:
            st = self._hosts.get(host)
            if st is None:
                return
            if st.opened_at:
                self._count("closed")
            st.failures = 0
            st.opened_at = 0.0
            st.probing = False

    def record_failure(self, host: str) -> None:
        with self._lock:
            st = self._hosts.setdefault(host, _HostState())
            if st.probing:
                # failed half-open probe: restart the open window
                st.probing = False
                st.opened_at = time.monotonic()
                self._count("reopened")
                return
            st.failures += 1
            if not st.opened_at and st.failures >= self.failure_threshold:
                st.opened_at = time.monotonic()
                self._count("opened")

    def is_open(self, host: str) -> bool:
        with self._lock:
            st = self._hosts.get(host)
            return bool(st and st.opened_at)

    def reset(self, host: Optional[str] = None) -> None:
        with self._lock:
            if host is None:
                self._hosts.clear()
            else:
                self._hosts.pop(host, None)


_shared_breaker: Optional[CircuitBreaker] = None
_shared_lock = threading.Lock()


def shared_breaker() -> CircuitBreaker:
    """The process-wide breaker of the intra-cluster clients (the
    volume server's read repair)."""
    global _shared_breaker
    with _shared_lock:
        if _shared_breaker is None:
            from . import metrics as metrics_mod
            _shared_breaker = CircuitBreaker(
                metrics=metrics_mod.shared("cluster"))
        return _shared_breaker


# --- retry policy ---

class RetryPolicy:
    """Jittered exponential backoff schedule, deadline-aware.

    ``delays()`` yields the sleep before each RETRY (so ``max_attempts=3``
    yields twice).  Sleeps are capped to the remaining ambient budget and
    the iterator stops early once the budget cannot cover another sleep —
    a retry that would start already-expired is pointless work.
    """

    def __init__(self, max_attempts: int = 3, base_delay: float = 0.05,
                 max_delay: float = 2.0, multiplier: float = 2.0,
                 jitter: float = 0.5,
                 rng: Optional[random.Random] = None):
        self.max_attempts = max(1, max_attempts)
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.multiplier = multiplier
        self.jitter = jitter
        self._rng = rng or random

    def backoff(self, attempt: int) -> float:
        """Sleep before retry number `attempt` (0-based)."""
        d = min(self.base_delay * (self.multiplier ** attempt),
                self.max_delay)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, d)

    def delays(self):
        for attempt in range(self.max_attempts - 1):
            d = self.backoff(attempt)
            left = remaining_budget()
            if left is not None:
                if left <= d:
                    return  # budget can't cover the sleep, let alone a try
                d = min(d, left)
            yield d

    def call(self, fn, *args, retry_on=(ConnectionError, OSError),
             host: str = "", breaker: Optional[CircuitBreaker] = None,
             on_retry=None, **kwargs):
        """Run fn with retries (sync). With `host` + `breaker`, each
        attempt is breaker-gated and recorded; BreakerOpen itself is
        never retried against the same host — it IS the fast path."""
        last: Optional[Exception] = None
        attempt = 0
        while True:
            if breaker is not None and host:
                breaker.check(host)  # BreakerOpen propagates immediately
            try:
                out = fn(*args, **kwargs)
            except retry_on as e:
                if breaker is not None and host:
                    breaker.record_failure(host)
                last = e
            else:
                if breaker is not None and host:
                    breaker.record_success(host)
                return out
            attempt += 1
            if attempt >= self.max_attempts:
                raise last
            d = self.backoff(attempt - 1)
            left = remaining_budget()  # the budget gates each RETRY live
            if left is not None:
                if left <= d:
                    raise last
                d = min(d, left)
            if on_retry is not None:
                on_retry(attempt, last)
            time.sleep(d)


DEFAULT_POLICY = RetryPolicy()
