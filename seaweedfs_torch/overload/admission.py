"""AdmissionController: the per-process admission decision.

The port's reduced copy of seaweedfs_tpu/overload/admission.py. One
controller guards one serving process (each server object owns one,
publishing into that server's metrics registry). ``admit()`` is called
by the aiohttp middleware and returns a ticket that MUST be released
when the request finishes; everything runs on the event loop, so the
hot path is plain attribute arithmetic with no locks. Not ported, with
the surfaces that need them (ROADMAP A.9): striped admission over a
SO_REUSEPORT shard fleet (``apply_stripe``, ``healthz_handler``'s
``shard_ctx``), the fastpath listener's pre-admitted requests and its
raw shed headers, and the filer ring's hop class.

Decision order (cheapest verdict first, background always before
foreground):

1. ``system`` class: control plane, always admitted.
2. strict priority: a ``bg`` request is shed while any ``fg`` request
   is queued, or was shed within the last sampler window — repair
   traffic must never consume capacity a user request is waiting for.
3. loop-lag thresholds (``WEED_ADMISSION_LAG_BG_MS`` /
   ``_LAG_FG_MS``): when the event loop itself is late, admitting more
   work only adds queueing — bg sheds at the low bar, fg at the high.
4. token buckets: global rate (exhaustion = overload = 503), then the
   per-tenant bucket (exhaustion = that tenant's problem = 429).
5. per-class concurrency cap: above it, wait in a bounded FIFO queue
   (an ``admission.wait`` span records the queueing so traces show
   where the latency came from); queue full or wait timed out = shed.

Shed responses carry ``Retry-After`` (jittered, so a synchronized
client fleet doesn't come back in lockstep) and ``X-Seaweed-Shed: 1``
so cooperating clients back off without charging their circuit
breakers.
"""

from __future__ import annotations

import asyncio
import os
import random
import time
from collections import deque
from typing import Optional

from . import (CLASS_BG, CLASS_FG, CLASS_SYSTEM, PRIORITY_HEADER,
               SHED_HEADER, SYSTEM_PATHS, SYSTEM_PREFIXES, classify,
               tenant_from_request, _priority)
from .bucket import TenantBuckets, TokenBucket
from .sampler import LoopLagSampler


def _env_num(env, key: str, default: float) -> float:
    try:
        return float(env.get(key, "") or default)
    except (TypeError, ValueError):
        return default


class ShedError(Exception):
    """Raised by admit() when the request must be refused.  Carries
    everything a surface needs to answer: HTTP status (503 overload /
    429 tenant), jittered Retry-After seconds, and the reason tag."""

    def __init__(self, status: int, retry_after: int, reason: str,
                 cls: str):
        super().__init__(reason)
        self.status = status
        self.retry_after = retry_after
        self.reason = reason
        self.cls = cls

    def headers(self) -> dict:
        return {"Retry-After": str(self.retry_after), SHED_HEADER: "1"}


class _ClassState:
    __slots__ = ("limit", "queue_depth", "inflight", "waiting",
                 "waiters", "last_shed")

    def __init__(self, limit: int, queue_depth: int):
        self.limit = max(0, int(limit))          # 0 = unlimited
        self.queue_depth = max(0, int(queue_depth))
        self.inflight = 0
        self.waiting = 0
        self.waiters: deque = deque()
        self.last_shed = 0.0                     # monotonic; 0 = never


class _Ticket:
    """Admission grant; release exactly once when the request ends."""

    __slots__ = ("_controller", "_cls", "_released")

    def __init__(self, controller: Optional["AdmissionController"],
                 cls: str):
        self._controller = controller
        self._cls = cls
        self._released = False

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        if self._controller is not None:
            self._controller._release(self._cls)


_SYSTEM_TICKET = _Ticket(None, CLASS_SYSTEM)


class AdmissionController:
    """Per-process admission state for one server. All WEED_ADMISSION_*
    knobs resolve at construction (explicit kwargs win over env)."""

    def __init__(self, name: str, metrics=None, *,
                 fg_concurrency: Optional[int] = None,
                 bg_concurrency: Optional[int] = None,
                 fg_queue: Optional[int] = None,
                 bg_queue: Optional[int] = None,
                 queue_timeout: Optional[float] = None,
                 global_rps: Optional[float] = None,
                 global_burst: Optional[float] = None,
                 tenant_rps: Optional[float] = None,
                 tenant_burst: Optional[float] = None,
                 lag_sample: Optional[float] = None,
                 lag_bg: Optional[float] = None,
                 lag_fg: Optional[float] = None,
                 retry_after_max: Optional[int] = None,
                 system_paths: frozenset = SYSTEM_PATHS,
                 system_prefixes: tuple = SYSTEM_PREFIXES,
                 tenant_validator=None,
                 env=os.environ,
                 time_fn=time.monotonic,
                 rng: Optional[random.Random] = None):
        self.name = name
        self.metrics = metrics
        # the system-class exemption set for THIS surface: only paths
        # its router reserves ahead of user catch-alls (overload/
        # __init__.py) — classify() with a shared set would let user
        # paths that collide with another server's control plane bypass
        # admission
        self.system_paths = system_paths
        self.system_prefixes = system_prefixes
        # admission runs BEFORE request authentication (shed cheaply,
        # before signature work), so the tenant key arrives UNVERIFIED.
        # A surface with an identity store supplies a cheap existence
        # check here; unknown keys fall back to the global bucket —
        # otherwise an unauthenticated attacker spoofing a victim's
        # access key drains the victim's bucket (targeted 429s) and
        # random keys churn the bounded TenantBuckets LRU.
        self.tenant_validator = tenant_validator
        self._now = time_fn
        self._rng = rng or random

        def knob(value, key, default):
            return value if value is not None \
                else _env_num(env, key, default)

        self.queue_timeout = knob(queue_timeout,
                                  "WEED_ADMISSION_QUEUE_TIMEOUT_MS",
                                  2000.0) / (1.0 if queue_timeout is not None
                                             else 1000.0)
        self.retry_after_max = max(1, int(knob(
            retry_after_max, "WEED_ADMISSION_RETRY_AFTER_S", 2)))
        lag_sample_s = knob(lag_sample, "WEED_ADMISSION_LAG_SAMPLE_MS",
                            100.0) / (1.0 if lag_sample is not None
                                      else 1000.0)
        self.lag_bg = knob(lag_bg, "WEED_ADMISSION_LAG_BG_MS", 0.0) \
            / (1.0 if lag_bg is not None else 1000.0)
        self.lag_fg = knob(lag_fg, "WEED_ADMISSION_LAG_FG_MS", 0.0) \
            / (1.0 if lag_fg is not None else 1000.0)
        self.classes: dict[str, _ClassState] = {
            CLASS_FG: _ClassState(
                int(knob(fg_concurrency,
                         "WEED_ADMISSION_FG_CONCURRENCY", 0)),
                int(knob(fg_queue, "WEED_ADMISSION_FG_QUEUE", 256))),
            CLASS_BG: _ClassState(
                int(knob(bg_concurrency,
                         "WEED_ADMISSION_BG_CONCURRENCY", 64)),
                int(knob(bg_queue, "WEED_ADMISSION_BG_QUEUE", 32))),
        }
        g_rps = knob(global_rps, "WEED_ADMISSION_GLOBAL_RPS", 0.0)
        g_burst = knob(global_burst, "WEED_ADMISSION_GLOBAL_BURST",
                       2.0 * g_rps)
        self.global_bucket = (TokenBucket(g_rps, g_burst, clock=time_fn)
                              if g_rps > 0 else None)
        t_rps = knob(tenant_rps, "WEED_ADMISSION_TENANT_RPS", 0.0)
        t_burst = knob(tenant_burst, "WEED_ADMISSION_TENANT_BURST",
                       2.0 * t_rps)
        self.tenant_buckets = (TenantBuckets(t_rps, t_burst,
                                             clock=time_fn)
                               if t_rps > 0 else None)
        # demand, shed and inversion tallies: plain ints bumped on the
        # event loop (no lock)
        self.demand = 0
        self.sheds = 0
        self.inversions = 0
        self.sampler = LoopLagSampler(interval=lag_sample_s,
                                      metrics=metrics)
        if metrics is not None and self.global_bucket is not None:
            # token gauge rides the sampler tick: admit() stays at one
            # counter write even with the global bucket configured
            self.sampler.on_sample = self._publish_bucket_gauge
        # one sampler window is THE hysteresis clock: bg stays locked
        # out this long after the last fg shed, and /healthz reports
        # "shedding" for this long after the last shed of any class
        self.window = self.sampler.interval
        # the /healthz reporting window is separately tunable: a load
        # balancer polling every few seconds would never catch a
        # 100ms-wide flag during intermittent overload — raise this to
        # ~2x the LB poll interval for a sticky drain signal (shed
        # BEHAVIOR still recovers within one sampler window)
        self.health_window = max(self.window, _env_num(
            env, "WEED_ADMISSION_HEALTH_WINDOW_S", self.window))
        self._fg_pressure_until = 0.0

    # --- lifecycle (server _on_startup/_on_cleanup) ---

    async def start(self) -> None:
        await self.sampler.start()

    def stop(self) -> None:
        self.sampler.stop()

    # --- metrics helpers ---

    def _count(self, name: str, cls: str) -> None:
        if self.metrics is not None:
            self.metrics.count(name, labels={"cls": cls})

    def _gauge_class(self, cls: str) -> None:
        # inflight/waiting gauges only mean something for a bounded
        # class — and skipping them keeps the default (unlimited-fg)
        # hot path at one counter per admit instead of three locked
        # metric writes
        st = self.classes[cls]
        if self.metrics is not None and st.limit:
            self.metrics.gauge("admission_inflight", st.inflight,
                               labels={"cls": cls})
            self.metrics.gauge("admission_waiting", st.waiting,
                               labels={"cls": cls})

    def _publish_bucket_gauge(self) -> None:
        self.metrics.gauge("admission_bucket_tokens",
                           round(self.global_bucket.tokens(), 1),
                           labels={"bucket": "global"})

    def retry_after(self) -> int:
        """Jittered Retry-After: uniform over [1, max] whole seconds so
        a synchronized client fleet desynchronizes on the way back."""
        return self._rng.randint(1, self.retry_after_max)

    def _shed(self, cls: str, status: int, reason: str, *,
              node_pressure: bool = True) -> ShedError:
        now = self._now()
        if node_pressure:
            st = self.classes.get(cls)
            if st is not None:
                st.last_shed = now
            if cls == CLASS_FG:
                # one sampler window of bg lockout per fg shed: while
                # user traffic is being refused, repair traffic gets
                # NOTHING
                self._fg_pressure_until = now + self.window
        self.sheds += 1
        self._count("admission_shed", cls)
        return ShedError(status, self.retry_after(), reason, cls)

    def _fg_pressure(self, now: float) -> bool:
        fg = self.classes[CLASS_FG]
        return fg.waiting > 0 or now < self._fg_pressure_until

    # --- the admission decision ---

    async def admit(self, cls: str, tenant: str = "") -> _Ticket:
        """Admit or raise ShedError. The returned ticket must be
        released when the request completes (middleware/fastpath do)."""
        if cls not in self.classes:
            self._count("admission_admitted", CLASS_SYSTEM)
            return _SYSTEM_TICKET
        now = self._now()
        self.demand += 1
        if cls == CLASS_BG and self._fg_pressure(now):
            raise self._shed(cls, 503, "foreground pressure")
        lag = self.sampler.lag
        if cls == CLASS_BG and self.lag_bg and lag >= self.lag_bg:
            raise self._shed(cls, 503, "event loop lagging")
        if cls == CLASS_FG and self.lag_fg and lag >= self.lag_fg:
            raise self._shed(cls, 503, "event loop lagging")
        st = self.classes[cls]
        # queue-full is plain arithmetic: refuse it BEFORE spending a
        # global/tenant token — a saturated class would otherwise burn
        # rate-limit budget on requests that get shed anyway, under-
        # admitting relative to the configured RPS exactly when the
        # node is under pressure. No await sits between this verdict
        # and the slot wait below, so it cannot go stale.
        if (st.limit and st.inflight >= st.limit
                and st.waiting >= st.queue_depth):
            raise self._shed(cls, 503, "queue full")
        if self.global_bucket is not None:
            if not self.global_bucket.try_acquire():
                raise self._shed(cls, 503, "global rate exceeded")
        if self.tenant_buckets is not None and tenant:
            if (self.tenant_validator is not None
                    and not self.tenant_validator(tenant)):
                tenant = ""   # unknown key: global bucket only
        if self.tenant_buckets is not None and tenant:
            if not self.tenant_buckets.try_acquire(tenant):
                self._count("admission_tenant_limited", cls)
                # that tenant's problem, not node overload: a hog tenant
                # steadily exceeding its own bucket on an idle server
                # must not lock out background repair traffic nor flip
                # /healthz "shedding" (an LB would drain a healthy node)
                raise self._shed(cls, 429,
                                 f"tenant {tenant!r} rate exceeded",
                                 node_pressure=False)
        if st.limit and st.inflight >= st.limit:
            got = await self._wait_for_slot(st, cls)
            if not got:
                raise self._shed(cls, 503, "queue timeout")
            if cls == CLASS_BG and self._fg_pressure(self._now()):
                # fg pressure arrived while this bg request was queued:
                # give the slot straight back and shed anyway — the
                # invariant is zero bg admitted under fg pressure
                self._release(cls)
                raise self._shed(cls, 503, "foreground pressure")
        else:
            st.inflight += 1
        if cls == CLASS_BG and self._fg_pressure(self._now()):
            # belt-and-suspenders invariant counter: by construction
            # this is unreachable; the bench asserts it stays 0
            self.inversions += 1
            self._count("admission_inversion", cls)
        self._count("admission_admitted", cls)
        self._gauge_class(cls)
        return _Ticket(self, cls)

    async def _wait_for_slot(self, st: _ClassState, cls: str) -> bool:
        """Park in the class's FIFO queue until a release hands over a
        slot (True) or the bounded patience runs out (False).  A granted
        future means the slot is ALREADY ours (the releaser incremented
        inflight on our behalf)."""
        from .. import observe
        fut = asyncio.get_event_loop().create_future()
        st.waiters.append(fut)
        st.waiting += 1
        self._gauge_class(cls)
        try:
            with observe.span("admission.wait", tags={"cls": cls}):
                await asyncio.wait_for(fut, self.queue_timeout)
            return True
        except asyncio.TimeoutError:
            # the handoff may have landed between the timer firing and
            # this task resuming — a granted slot must not leak
            return fut.done() and not fut.cancelled()
        except asyncio.CancelledError:
            # the waiting request itself was cancelled (client gone); if
            # the handoff landed first, give the granted slot back or
            # the class leaks capacity forever
            if fut.done() and not fut.cancelled():
                self._release(cls)
            raise
        finally:
            st.waiting -= 1
            if not fut.done():
                try:
                    st.waiters.remove(fut)
                except ValueError:
                    pass
            self._gauge_class(cls)

    def _release(self, cls: str) -> None:
        st = self.classes.get(cls)
        if st is None:
            return
        st.inflight -= 1
        while st.waiters:
            fut = st.waiters.popleft()
            if not fut.done():
                st.inflight += 1   # hand the slot directly to the waiter
                fut.set_result(None)
                break
        self._gauge_class(cls)

    # --- state for /healthz (load balancers key on this to drain) ---

    def health(self) -> dict:
        now = self._now()
        classes = {}
        for cls, st in self.classes.items():
            recent = bool(st.last_shed) and (now - st.last_shed
                                             <= self.health_window)
            classes[cls] = {"inflight": st.inflight,
                            "waiting": st.waiting,
                            "limit": st.limit,
                            "queue_depth": st.queue_depth,
                            "shed_recent": recent}
        # the drain signal keys on FOREGROUND pressure only: a repair
        # fan-in overflowing the bg caps on an otherwise idle node is
        # not a reason for an LB to drain it (bg state stays visible
        # in classes).  A non-empty fg queue is live pressure even
        # between sheds.
        fg = self.classes[CLASS_FG]
        shedding = (classes[CLASS_FG]["shed_recent"] or fg.waiting > 0)
        return {"shedding": shedding,
                "loop_lag_ms": round(self.sampler.lag * 1e3, 3),
                "classes": classes}


# --- serving-surface glue ---

def _shed_web_response(err: ShedError):
    from aiohttp import web
    return web.json_response({"error": f"overloaded: {err.reason}"},
                             status=err.status, headers=err.headers())


def admission_middleware(controller: AdmissionController):
    """aiohttp middleware classifying, metering and bounding every
    request. The reference's hooks for requests admitted elsewhere (its
    fastpath listener's loopback token, the filer ring's hop predicate)
    come with those surfaces (ROADMAP A.9)."""
    from aiohttp import web

    @web.middleware
    async def admission_mw(request: web.Request, handler):
        cls = classify(request.headers.get(PRIORITY_HEADER, ""),
                       request.path, controller.system_paths,
                       controller.system_prefixes)
        # tenant extraction parses the Authorization header — skip it
        # entirely when no per-tenant buckets are configured
        tenant = (tenant_from_request(request)
                  if controller.tenant_buckets is not None else "")
        try:
            ticket = await controller.admit(cls, tenant)
        except ShedError as e:
            return _shed_web_response(e)
        # bg propagates downstream (the filer fetching chunks for a bg
        # request must present as bg at the volume server too)
        ptok = _priority.set(CLASS_BG) if cls == CLASS_BG else None
        try:
            return await handler(request)
        finally:
            if ptok is not None:
                _priority.reset(ptok)
            ticket.release()

    return admission_mw


def healthz_handler(controller: AdmissionController):
    """aiohttp /healthz handler reporting liveness AND shedding state.
    Status stays 200 while shedding — a load balancer that drains on
    /healthz failure would amplify an overload into an outage; it
    should key on the ``admission.shedding`` field instead."""
    from aiohttp import web

    async def handler(request: web.Request) -> web.Response:
        return web.json_response({"ok": True,
                                  "admission": controller.health()})

    return handler
