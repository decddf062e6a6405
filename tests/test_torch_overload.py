"""The port's overload plane (seaweedfs_torch/overload/) against the
reference's (seaweedfs_tpu/overload/).

The reference's unit cases of tests/test_overload.py (token buckets, the
loop-lag sampler, the admission controller's shed rules with an injected
clock, classification, tenant keys, the aiohttp middleware, the
``admission.wait`` span) run against both packages, parametrised by
``ov``. Two differences are by design: the port registers no
``/admin/faults`` route, so its ``faults_admin_paths()`` stays empty
under ``WEED_FAULTS_ADMIN=1``, and its middleware has no fastpath
listener's token, so the pre-admitted requests run on the reference
only. Then parity cases: the constants and
system-path sets equal, a queue-full verdict spends no token, and one
seeded random sequence of admits, releases and clock steps gives both
controllers the same verdicts, counters and health.
"""

import asyncio
import random
import threading
import time

import pytest

from seaweedfs_torch import observe as pobserve
from seaweedfs_torch import overload as pov
from seaweedfs_tpu import observe as robserve
from seaweedfs_tpu import overload as rov

OBSERVE = {pov: pobserve, rov: robserve}


@pytest.fixture(params=["reference", "port"])
def ov(request):
    return {"reference": rov, "port": pov}[request.param]


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# --- token buckets ---

def test_bucket_burst_capacity(ov):
    clk = FakeClock()
    b = ov.TokenBucket(rate=10.0, burst=5.0, clock=clk)
    assert [b.try_acquire() for _ in range(5)] == [True] * 5
    assert not b.try_acquire()  # burst exhausted, no time has passed


def test_bucket_monotonic_refill(ov):
    clk = FakeClock()
    b = ov.TokenBucket(rate=10.0, burst=5.0, clock=clk)
    for _ in range(5):
        assert b.try_acquire()
    clk.advance(0.25)  # 2.5 tokens back
    assert b.try_acquire() and b.try_acquire()
    assert not b.try_acquire()
    # refill never exceeds burst
    clk.advance(1000.0)
    assert abs(b.tokens() - 5.0) < 1e-9
    # a clock that goes nowhere (or backwards) mints no free tokens
    for _ in range(5):
        b.try_acquire()
    clk.t -= 50.0
    assert not b.try_acquire()


def test_bucket_no_refill_drift_under_concurrent_acquires(ov):
    """N threads hammering try_acquire must never beat the arithmetic
    bound burst + rate*elapsed: if two threads both credited the same
    elapsed interval (refill drift), the total would exceed it."""
    rate, burst = 200.0, 20.0
    b = ov.TokenBucket(rate=rate, burst=burst)
    admitted = []
    stop = time.monotonic() + 0.5
    start = time.monotonic()

    def worker():
        n = 0
        while time.monotonic() < stop:
            if b.try_acquire():
                n += 1
        admitted.append(n)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.monotonic() - start
    total = sum(admitted)
    assert total <= burst + rate * elapsed + 1.0, \
        f"refill drift: {total} > {burst} + {rate}*{elapsed:.3f}"
    # and the bucket wasn't starved either (loose floor: CI is noisy)
    assert total >= burst + rate * 0.5 * 0.5


def test_tenant_buckets_isolated_and_bounded(ov):
    clk = FakeClock()
    tb = ov.TenantBuckets(rate=1.0, burst=2.0, max_tenants=3, clock=clk)
    assert tb.try_acquire("a") and tb.try_acquire("a")
    assert not tb.try_acquire("a")   # tenant a exhausted
    assert tb.try_acquire("b")       # tenant b unaffected
    assert tb.try_acquire("")        # untenanted is not metered here
    for t in ("c", "d", "e"):
        tb.try_acquire(t)
    assert len(tb) <= 3              # bounded: client-chosen keys can't
    #                                  grow server memory unboundedly


# --- loop lag sampler ---

def test_lag_sampler_detects_injected_stall(ov):
    async def main():
        # a 100ms stall shows up as lag in [stall - interval, stall]:
        # the pending wakeup was scheduled at most one interval before
        # the stall ended — small interval => tight bound
        s = ov.LoopLagSampler(interval=0.02, window=20)
        await s.start()
        await asyncio.sleep(0.08)            # a few clean samples
        clean = s.recent_max()
        time.sleep(0.1)                       # stall the loop itself
        await asyncio.sleep(0.05)             # let the late sample land
        stalled = s.recent_max()
        s.stop()
        assert stalled >= 0.07, f"stall not detected: {stalled}"
        assert stalled > clean
    asyncio.run(main())


# --- admission controller ---

def _controller(ov, **kw):
    kw.setdefault("env", {})  # isolate from WEED_ADMISSION_* in the env
    return ov.AdmissionController("test", **kw)


def test_bg_sheds_while_fg_waiting_and_recovers(ov):
    clk = FakeClock()

    async def main():
        c = _controller(ov, fg_concurrency=1, fg_queue=8, bg_concurrency=8,
                        queue_timeout=5.0, time_fn=clk)
        first = await c.admit(ov.CLASS_FG)
        waiter = asyncio.ensure_future(c.admit(ov.CLASS_FG))
        await asyncio.sleep(0.01)  # park the second fg in the queue
        assert c.classes[ov.CLASS_FG].waiting == 1
        with pytest.raises(ov.ShedError) as ei:
            await c.admit(ov.CLASS_BG)
        assert ei.value.status == 503
        assert ei.value.headers()["X-Seaweed-Shed"] == "1"
        assert int(ei.value.headers()["Retry-After"]) >= 1
        # fg itself keeps flowing: release hands the slot to the waiter
        first.release()
        second = await waiter
        assert c.classes[ov.CLASS_FG].inflight == 1
        second.release()
        # queue drained + one sampler window later: bg flows again
        clk.advance(c.window + 0.001)
        (await c.admit(ov.CLASS_BG)).release()
    asyncio.run(main())


def test_fg_shed_locks_bg_out_for_one_window(ov):
    clk = FakeClock()

    async def main():
        c = _controller(ov, fg_concurrency=1, fg_queue=0,
                        queue_timeout=0.05, time_fn=clk)
        t = await c.admit(ov.CLASS_FG)
        with pytest.raises(ov.ShedError) as ei:
            await c.admit(ov.CLASS_FG)   # queue_depth=0: shed now
        assert ei.value.reason == "queue full"
        t.release()
        # no fg waiting anymore, but the shed was within the window
        with pytest.raises(ov.ShedError) as ei:
            await c.admit(ov.CLASS_BG)
        assert ei.value.reason == "foreground pressure"
        clk.advance(c.window + 0.001)
        (await c.admit(ov.CLASS_BG)).release()
    asyncio.run(main())


def test_queue_timeout_sheds(ov):
    async def main():
        c = _controller(ov, fg_concurrency=1, fg_queue=4, queue_timeout=0.05)
        t = await c.admit(ov.CLASS_FG)
        t0 = time.monotonic()
        with pytest.raises(ov.ShedError) as ei:
            await c.admit(ov.CLASS_FG)
        assert ei.value.reason == "queue timeout"
        assert time.monotonic() - t0 < 2.0
        assert c.classes[ov.CLASS_FG].waiting == 0  # no leak
        t.release()
        (await c.admit(ov.CLASS_FG)).release()
    asyncio.run(main())


def test_tenant_bucket_answers_429(ov):
    clk = FakeClock()

    async def main():
        c = _controller(ov, tenant_rps=1.0, tenant_burst=2.0, time_fn=clk)
        for _ in range(2):
            (await c.admit(ov.CLASS_FG, tenant="hog")).release()
        with pytest.raises(ov.ShedError) as ei:
            await c.admit(ov.CLASS_FG, tenant="hog")
        assert ei.value.status == 429
        # other tenants and untenanted traffic unaffected
        (await c.admit(ov.CLASS_FG, tenant="quiet")).release()
        (await c.admit(ov.CLASS_FG)).release()
    asyncio.run(main())


def test_tenant_shed_is_not_node_pressure(ov):
    """A hog tenant exhausting its OWN bucket on an idle node must not
    lock out background traffic nor flip the /healthz shedding flag —
    that would drain a healthy node and starve cluster self-healing."""
    clk = FakeClock()

    async def main():
        c = _controller(ov, tenant_rps=1.0, tenant_burst=1.0, time_fn=clk)
        (await c.admit(ov.CLASS_FG, tenant="hog")).release()
        with pytest.raises(ov.ShedError) as ei:
            await c.admit(ov.CLASS_FG, tenant="hog")
        assert ei.value.status == 429
        # no fg pressure: bg still admitted, healthz stays calm
        (await c.admit(ov.CLASS_BG)).release()
        assert c.health()["shedding"] is False
    asyncio.run(main())


def test_global_bucket_answers_503(ov):
    clk = FakeClock()

    async def main():
        c = _controller(ov, global_rps=1.0, global_burst=1.0, time_fn=clk)
        (await c.admit(ov.CLASS_FG)).release()
        with pytest.raises(ov.ShedError) as ei:
            await c.admit(ov.CLASS_FG)
        assert ei.value.status == 503
    asyncio.run(main())


def test_system_class_never_shed(ov):
    clk = FakeClock()

    async def main():
        c = _controller(ov, fg_concurrency=1, fg_queue=0, queue_timeout=0.01,
                        global_rps=1.0, global_burst=1.0, time_fn=clk)
        t = await c.admit(ov.CLASS_FG)   # spends the global token
        with pytest.raises(ov.ShedError):
            await c.admit(ov.CLASS_FG)
        # control plane sails through caps, buckets and fg pressure
        (await c.admit(ov.CLASS_SYSTEM)).release()
        t.release()
    asyncio.run(main())


def test_health_reports_shedding_state(ov):
    clk = FakeClock()

    async def main():
        c = _controller(ov, fg_concurrency=1, fg_queue=0,
                        queue_timeout=0.01, time_fn=clk)
        assert c.health()["shedding"] is False
        t = await c.admit(ov.CLASS_FG)
        with pytest.raises(ov.ShedError):
            await c.admit(ov.CLASS_FG)
        h = c.health()
        assert h["shedding"] is True
        assert h["classes"][ov.CLASS_FG]["shed_recent"] is True
        clk.advance(c.window + 0.001)
        assert c.health()["shedding"] is False  # one window later
        t.release()
    asyncio.run(main())


def test_tenant_validator_sends_unknown_keys_to_global_bucket(ov):
    """Admission runs before request auth, so tenant keys arrive
    unverified: a spoofed Credential=VICTIMKEY from an unauthenticated
    client must not drain the victim's bucket (nor churn the bounded
    TenantBuckets LRU with random keys)."""
    clk = FakeClock()

    async def main():
        c = _controller(ov, tenant_rps=1.0, tenant_burst=1.0, time_fn=clk,
                        tenant_validator=lambda k: k == "real")
        # spoofed keys never touch a tenant bucket: admit freely, and
        # no bucket is ever minted for them (no LRU churn)
        for _ in range(5):
            (await c.admit(ov.CLASS_FG, tenant="spoofed")).release()
        assert "spoofed" not in c.tenant_buckets._buckets
        # the real tenant's bucket still meters the real tenant
        (await c.admit(ov.CLASS_FG, tenant="real")).release()
        with pytest.raises(ov.ShedError) as ei:
            await c.admit(ov.CLASS_FG, tenant="real")
        assert ei.value.status == 429
    asyncio.run(main())


def test_health_shedding_ignores_bg_only_pressure(ov):
    """A repair fan-in overflowing the bg caps on an otherwise idle
    node must not flip the drain signal: the LB keys on it, and
    draining a node whose foreground path is perfectly healthy turns
    a background backlog into lost serving capacity."""
    clk = FakeClock()

    async def main():
        c = _controller(ov, bg_concurrency=1, bg_queue=0,
                        queue_timeout=0.01, time_fn=clk)
        t = await c.admit(ov.CLASS_BG)
        with pytest.raises(ov.ShedError):
            await c.admit(ov.CLASS_BG)   # bg queue full -> shed
        h = c.health()
        assert h["classes"][ov.CLASS_BG]["shed_recent"] is True
        assert h["shedding"] is False          # fg path is healthy
        t.release()
    asyncio.run(main())


# --- classification / propagation helpers ---

def test_classify_and_priority_context(ov):
    assert ov.classify("", "/some/file") == ov.CLASS_FG
    assert ov.classify("bg", "/some/file") == ov.CLASS_BG
    assert ov.classify("background", "/x") == ov.CLASS_BG
    assert ov.classify("weird", "/x") == ov.CLASS_FG
    # path wins: control plane stays system even when tagged bg
    assert ov.classify("bg", "/heartbeat") == ov.CLASS_SYSTEM
    assert ov.classify("", "/debug/trace") == ov.CLASS_SYSTEM
    # EXACT ops routes only: an arbitrary /debug/<x> path resolves to
    # user data on the catch-all surfaces and must be metered, and
    # /admin/faults is only a registered route on master/volume (the
    # gateways add it via faults_admin_paths when WEED_FAULTS_ADMIN=1)
    assert ov.classify("", "/debug/anything") == ov.CLASS_FG
    assert ov.classify(
        "", "/admin/faults",
        ov.GATEWAY_SYSTEM_PATHS) == ov.CLASS_FG
    assert ov.classify(
        "", "/admin/faults",
        ov.VOLUME_SYSTEM_PATHS) == ov.CLASS_SYSTEM
    import os as _os
    _prev = _os.environ.pop("WEED_FAULTS_ADMIN", None)
    try:
        assert ov.faults_admin_paths() == frozenset()
        _os.environ["WEED_FAULTS_ADMIN"] = "1"
        # the port's gateway registers no /admin/faults route (its faults
        # plane has no admin face), so the path stays metered there
        assert ov.faults_admin_paths() == (
            frozenset({"/admin/faults"}) if ov is rov else frozenset())
    finally:
        if _prev is None:
            _os.environ.pop("WEED_FAULTS_ADMIN", None)
        else:
            _os.environ["WEED_FAULTS_ADMIN"] = _prev
    headers = {}
    ov.inject(headers)
    assert headers == {}  # untagged = foreground: no header noise
    with ov.priority(ov.CLASS_BG):
        ov.inject(headers)
    assert headers[ov.PRIORITY_HEADER] == ov.CLASS_BG
    assert ov.current_priority() == ""  # reset on exit


def test_tenant_from_request_variants(ov):
    class Req:
        def __init__(self, query=None, headers=None):
            self.query = query or {}
            self.headers = headers or {}

    assert ov.tenant_from_request(Req({"collection": "c1"})) == "c1"
    sig4 = ("AWS4-HMAC-SHA256 Credential=AKIDEXAMPLE/20260803/us-east-1/"
            "s3/aws4_request, SignedHeaders=host, Signature=abc")
    assert ov.tenant_from_request(
        Req(headers={"Authorization": sig4})) == "AKIDEXAMPLE"
    assert ov.tenant_from_request(
        Req(headers={"Authorization": "AWS AKV2KEY:sig"})) == "AKV2KEY"
    assert ov.tenant_from_request(Req()) == ""


# --- aiohttp middleware ---

def test_middleware_sheds_marks_and_skips_internal(ov):
    from aiohttp import web
    from aiohttp.test_utils import TestClient, TestServer

    clk = FakeClock()

    async def main():
        c = _controller(ov, fg_concurrency=1, fg_queue=0, queue_timeout=0.01,
                        time_fn=clk)
        seen_priority = []

        async def handler(request):
            seen_priority.append(ov.current_priority())
            if request.query.get("hold"):
                await asyncio.sleep(0.6)
            return web.json_response({"ok": True})

        # the port's middleware takes no fastpath token (its listener is
        # not ported): the pre-admitted cases run on the reference only
        mw = (ov.admission_middleware(c, internal_token=lambda: "sekrit")
              if ov is rov else ov.admission_middleware(c))
        app = web.Application(middlewares=[mw])
        app.router.add_get("/healthz", ov.healthz_handler(c))
        app.router.add_route("*", "/{p:.*}", handler)
        async with TestClient(TestServer(app)) as client:
            r = await client.get("/file1")
            assert r.status == 200
            hold = asyncio.ensure_future(client.get("/file2?hold=1"))
            await asyncio.sleep(0.1)  # the held request owns the slot
            r = await client.get("/file3")
            assert r.status == 503
            assert r.headers["X-Seaweed-Shed"] == "1"
            assert "Retry-After" in r.headers
            # fg shed within the window -> bg locked out
            r = await client.get(
                "/file4", headers={ov.PRIORITY_HEADER: "bg"})
            assert r.status == 503
            if ov is rov:
                # internal-token requests were admitted at the fastpath
                # listener: the middleware must not double-meter them
                r = await client.get("/file5",
                                     headers={"X-Swfs-Internal": "sekrit"})
                assert r.status == 200
                # ... but a bg-tagged proxied request must still rebind the
                # ambient priority (the fastpath task's contextvar doesn't
                # cross the loopback hop) so nested fetches present as bg
                r = await client.get(
                    "/file5b", headers={"X-Swfs-Internal": "sekrit",
                                        ov.PRIORITY_HEADER: "bg"})
                assert r.status == 200
                assert seen_priority[-1] == ov.CLASS_BG
                # tunneled requests (chunked/Expect framing) carry the token
                # only to skip the whitelist re-check — they were NOT
                # admitted at the listener and must be metered here, or any
                # client dodges the caps via Transfer-Encoding: chunked
                r = await client.get(
                    "/file5c", headers={"X-Swfs-Internal": "sekrit",
                                        "X-Swfs-Tunnel": "1"})
                assert r.status == 503
                assert r.headers["X-Seaweed-Shed"] == "1"
            # healthz reports the shedding, and is itself never shed
            r = await client.get("/healthz")
            assert r.status == 200
            payload = await r.json()
            assert payload["admission"]["shedding"] is True
            assert (await hold).status == 200
            # bg handlers observe the bg ambient priority (propagation)
            clk.advance(c.window + 1.0)
            r = await client.get(
                "/file6", headers={ov.PRIORITY_HEADER: "bg"})
            assert r.status == 200
            assert seen_priority[-1] == ov.CLASS_BG
    asyncio.run(main())


def test_admission_wait_records_span(ov):
    observe = OBSERVE[ov]

    async def main():
        observe.reset()
        c = _controller(ov, fg_concurrency=1, fg_queue=4, queue_timeout=5.0)
        t = await c.admit(ov.CLASS_FG)
        waiter = asyncio.ensure_future(c.admit(ov.CLASS_FG))
        await asyncio.sleep(0.02)
        t.release()
        (await waiter).release()
        names = [s["name"] for s in observe.spans()]
        assert "admission.wait" in names
    asyncio.run(main())


# --- parity: the port against the reference on the same inputs ---

def test_constants_and_system_sets_equal():
    for name in ("PRIORITY_HEADER", "SHED_HEADER", "RING_HOP_HEADER",
                 "CLASS_FG", "CLASS_BG", "CLASS_SYSTEM", "OPS_PATHS",
                 "OPS_PREFIXES", "MASTER_SYSTEM_PATHS",
                 "VOLUME_SYSTEM_PATHS", "FILER_SYSTEM_PATHS",
                 "GATEWAY_SYSTEM_PATHS", "SYSTEM_PATHS",
                 "SYSTEM_PREFIXES"):
        assert getattr(pov, name) == getattr(rov, name), name
    from seaweedfs_torch import metaring
    # the ring's hop header is overload's, with the reference's value
    assert metaring.RING_HOP_HEADER is pov.RING_HOP_HEADER


def test_queue_full_spends_no_token(ov):
    """A saturated class refuses before the global bucket is charged: a
    shed request leaves the token for the next admitted one."""
    clk = FakeClock()

    async def main():
        c = _controller(ov, fg_concurrency=1, fg_queue=0, global_rps=1.0,
                        global_burst=2.0, time_fn=clk)
        t = await c.admit(ov.CLASS_FG)
        left = c.global_bucket.tokens()
        with pytest.raises(ov.ShedError) as ei:
            await c.admit(ov.CLASS_FG)
        assert ei.value.reason == "queue full"
        assert c.global_bucket.tokens() == left == 1.0
        t.release()
        (await c.admit(ov.CLASS_FG)).release()
        return c.global_bucket.tokens()
    assert asyncio.run(main()) == 0.0


def _drive(ov, seed: int) -> list:
    """A seeded sequence of admits (fg, bg, system, with or without a
    tenant), releases and clock steps; every verdict, then the
    controller's counters and health."""
    rng = random.Random(seed)
    clk = FakeClock()

    async def main():
        c = _controller(
            ov, fg_concurrency=3, fg_queue=0, bg_concurrency=2, bg_queue=1,
            queue_timeout=0.002, global_rps=40.0, global_burst=12.0,
            tenant_rps=5.0, tenant_burst=3.0, time_fn=clk,
            rng=random.Random(seed), tenant_validator=lambda k: k != "spoof")
        held: list = []
        out = []
        for _ in range(400):
            op = rng.random()
            if op < 0.55:
                cls = rng.choice([ov.CLASS_FG, ov.CLASS_FG, ov.CLASS_BG,
                                  ov.CLASS_SYSTEM])
                tenant = rng.choice(["", "a", "b", "spoof"])
                try:
                    held.append(await c.admit(cls, tenant))
                    out.append(("ok", cls))
                except ov.ShedError as e:
                    out.append((e.status, e.reason, e.cls,
                                e.retry_after))
            elif op < 0.9 and held:
                held.pop(rng.randrange(len(held))).release()
                out.append("release")
            else:
                clk.advance(rng.choice([0.01, 0.05, 0.2, 1.0]))
                out.append("tick")
        out.append((c.demand, c.sheds, c.inversions, c.health()))
        for t in held:
            t.release()
        return out

    return asyncio.run(main())


SEEDS = (0, 1, 2)


@pytest.mark.parametrize("seed", SEEDS)
def test_random_admission_sequences_agree(seed):
    assert _drive(pov, seed) == _drive(rov, seed)


def test_random_sequences_reach_every_verdict():
    got = [v for seed in SEEDS for v in _drive(pov, seed)[:-1]
           if isinstance(v, tuple) and len(v) == 4]
    assert {"queue full", "queue timeout", "foreground pressure",
            "global rate exceeded"} <= {v[1] for v in got}
    assert {429, 503} == {v[0] for v in got}
