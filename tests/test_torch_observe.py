"""The port's tracing, wide events, fault plane and metrics registry
against the reference's.

The same spans, stage totals, Chrome-trace documents, wide events,
fault arming and rolls, and metric operations must give the reference's
results (ids and wall-clock stamps aside, which are random or
time-dependent in both). The pipeline must wrap its dispatch and its
materialize wait in the reference's two trace annotations (NVTX ranges
on a card, inert here), and ``stamp_shard_digests`` must count its host
recomputes as the reference's does. Exact equality everywhere.
"""

import json
import logging
import os
import shutil

import numpy as np
import pytest

from seaweedfs_torch import faults as pfaults
from seaweedfs_torch import observe as pobs
from seaweedfs_torch.ec import coder as pcoder
from seaweedfs_torch.ec import geometry as pgeo
from seaweedfs_torch.ec import pipeline as ppipe
from seaweedfs_torch.observe import profiler as pprof
from seaweedfs_torch.observe import wideevents as pwide
from seaweedfs_torch.utils import metrics as pmetrics
from seaweedfs_tpu import faults as rfaults
from seaweedfs_tpu import observe as robs
from seaweedfs_tpu.ec import pipeline as rpipe
from seaweedfs_tpu.observe import wideevents as rwide
from seaweedfs_tpu.utils import metrics as rmetrics

SIDES = {"port": (pobs, pwide, pfaults, pmetrics),
         "ref": (robs, rwide, rfaults, rmetrics)}


@pytest.fixture(autouse=True)
def fresh():
    for obs, wide, faults, _ in SIDES.values():
        obs.reset()
        wide.reset()
        faults.clear()
    yield
    for obs, wide, faults, _ in SIDES.values():
        obs.reset()
        wide.reset()
        faults.clear()


def _strip(span: dict) -> dict:
    """A span without its random ids, wall clock and thread id."""
    return {k: v for k, v in span.items()
            if k not in ("trace", "id", "parent", "start_us", "tid")}


def _spans_of(side: str) -> list:
    obs = SIDES[side][0]
    ctx = obs.TraceCtx("t1", "p0", "ec", "node")
    obs.record_span("ec.read", ctx, 100, 7, tags={"batch": 0})
    obs.record_span("ec.read", ctx, 200, 5)
    with obs.stage("ec.kernel", ctx, tags={"batch": 1}):
        pass
    with obs.bind(ctx):
        assert obs.capture() == ctx
        assert obs.ensure_ctx("x") == ctx
        with obs.span("fault.ec.feed.read") as sp:
            assert obs.capture().trace_id == "t1"
            assert obs.capture().span_id == sp.span_id
    assert obs.capture() == obs.TraceCtx("", "", "", "")
    fresh_ctx = obs.ensure_ctx("ec")
    assert fresh_ctx.trace_id and fresh_ctx.service == "ec"
    assert obs.run_with(ctx, lambda: obs.capture()) == ctx
    with pytest.raises(KeyError):
        with obs.span("boom", ctx=ctx):
            raise KeyError("x")
    return obs.spans()


def test_spans_and_totals_match_reference():
    got, want = _spans_of("port"), _spans_of("ref")
    strip = [_strip(s) for s in got]
    for s in strip:
        if s["name"] in ("ec.kernel", "fault.ec.feed.read", "boom"):
            s["dur_us"] = 0
    ref = [_strip(s) for s in want]
    for s in ref:
        if s["name"] in ("ec.kernel", "fault.ec.feed.read", "boom"):
            s["dur_us"] = 0
    assert strip == ref
    assert got[-1]["tags"] == {"error": "KeyError"}
    assert got[2]["parent"] == "p0" and got[3]["parent"] == "p0"
    for side in ("port", "ref"):
        obs = SIDES[side][0]
        totals = obs.stage_totals("t1", prefix="ec.")
        assert totals["ec.read"] == (2, 12)
        assert set(totals) == {"ec.read", "ec.kernel"}
    assert len(pobs.spans(limit=2)) == 2 and pobs.spans("nope") == []


def test_chrome_trace_matches_reference():
    spans = [{"trace": "t", "id": "a", "parent": "", "name": "ec.read",
              "svc": "ec", "inst": "", "start_us": 10, "dur_us": 0,
              "tid": 3, "tags": {"batch": 1}},
             {"trace": "t", "id": "b", "parent": "a", "name": "ec.kernel",
              "svc": "volume", "inst": "n1", "start_us": 20, "dur_us": 9,
              "tid": 4, "tags": {}}]
    assert pobs.to_chrome_trace(spans) == robs.to_chrome_trace(spans)


def test_ring_size_env(monkeypatch):
    for raw in ("", "17", "-3", "junk"):
        monkeypatch.setenv("WEED_TRACE_RING", raw)
        monkeypatch.setenv("WEED_WIDE_RING", raw)
        assert pobs._ring_size() == robs._ring_size()
        assert pwide._ring_size() == rwide._ring_size()
    assert pobs.RING_SIZE == pobs._ring.maxlen == 4096


def test_maybe_log_slow(caplog, monkeypatch):
    monkeypatch.setenv("WEED_TRACE_SLOW_MS", "0")
    with caplog.at_level(logging.WARNING):
        with pobs.span("ec.encode", service="ec") as sp:
            pass
        pobs.maybe_log_slow(sp)
    assert "slow request" in caplog.text and "ec.encode" in caplog.text


def test_wide_events_match_reference():
    totals = {"ec.read": (3, 1500), "ec.write": (3, 700)}
    evs = []
    for side in ("port", "ref"):
        wide = SIDES[side][1]
        ev = wide.emit_stages("ec", "ec.encode 1", "t9", 4000, totals)
        wide.emit_stages("volume", "GET /1,1", "t8", 900, {})
        ev.pop("ts")
        evs.append(ev)
        assert [e["trace"] for e in wide.events(stage="ec.")] == ["t9"]
        assert [e["trace"] for e in wide.events(min_ms=2)] == ["t9"]
        assert [e["svc"] for e in wide.events(limit=1)] == ["volume"]
        assert wide.events(trace="t8", cls="bg", shed=False)[0]["dur_us"] \
            == 900
    assert evs[0] == evs[1]


def test_fault_specs_rolls_and_budgets_match_reference(monkeypatch):
    monkeypatch.setenv("WEED_FAULTS",
                       "ec.feed.read:error:p=0.5:count=3:seed=4,"
                       "ec.feed.*:drop:p=0.25:seed=9")
    seqs = {}
    for side, mod in (("port", pfaults), ("ref", rfaults)):
        monkeypatch.setattr(mod, "_env_loaded", False)
        monkeypatch.setattr(mod, "_faults", [])
        outcomes = []
        for _ in range(40):
            for point in ("ec.feed.read", "ec.feed.stall"):
                try:
                    outcomes.append(mod.fire(point))
                except mod.FaultError:
                    outcomes.append("error")
        seqs[side] = (outcomes, mod.active())
        assert mod.clear() == 2 and mod.active() == []
    assert seqs["port"] == seqs["ref"]
    assert "error" in seqs["port"][0] and True in seqs["port"][0]
    with pytest.raises(ValueError):
        pfaults.set_fault("ec.feed.read", "explode")
    with pytest.raises(ValueError):
        pfaults._parse_spec("ec.feed.read")
    with pytest.raises(ValueError):
        pfaults._parse_spec("ec.feed.read:drop:bogus=1")


def test_fault_delay_and_corrupt_match_reference():
    payload = bytes(range(200))
    for mod in (pfaults, rfaults):
        mod.set_fault("ec.feed.stall", "delay", ms=1, count=1)
        mod.set_fault("ec.feed.read", "corrupt", seed=5)
    assert not pfaults.fire("ec.feed.stall")
    assert [s["name"] for s in pobs.spans()] == ["fault.ec.feed.stall"]
    assert pfaults.corrupt("ec.feed.read", payload) == rfaults.corrupt(
        "ec.feed.read", payload) != payload
    assert pfaults.corrupt("other", payload) == payload
    assert pfaults.KNOWN_POINTS <= rfaults.KNOWN_POINTS


def test_metrics_registry_renders_like_reference():
    regs = {"port": pmetrics.Registry("ec"), "ref": rmetrics.Registry("ec")}
    for reg in regs.values():
        reg.count("ec_digest_host_recompute", 3)
        reg.count("ec_digest_host_recompute")
        reg.count("reads", labels={"collection": 'a"b\\c\nd'})
        reg.gauge("feed_batch_bytes", 8388608)
        reg.gauge("feed_queue_depth", 4, labels={"queue": "write"})
        reg.gauge("feed_queue_depth", 2, labels={"queue": "read"})
    assert regs["port"].render() == regs["ref"].render()
    for reg in regs.values():
        assert reg.value("ec_digest_host_recompute") == 4
        assert reg.value("feed_queue_depth", {"queue": "write"}) == 4
        assert reg.value("missing", default=-1) == -1
        assert not reg.is_empty()
    assert pmetrics.Registry("x").is_empty()


def test_shared_registries_render_in_order():
    pmetrics.shared("zz_test").gauge("g", 1)
    pmetrics.shared("aa_test").gauge("g", 2)
    text = pmetrics.render_shared()
    assert text.index("seaweedfs_tpu_aa_test_g 2") < text.index(
        "seaweedfs_tpu_zz_test_g 1")
    assert pmetrics.shared("aa_test") is pmetrics.shared("aa_test")


def test_pipeline_annotates_dispatch_and_kernel_wait(tmp_path, monkeypatch):
    names = []
    real = pprof.trace_annotation

    def recording(name):
        names.append(name)
        return real(name)

    monkeypatch.setattr(ppipe, "trace_annotation", recording)
    base = str(tmp_path / "1")
    with open(base + ".dat", "wb") as f:
        f.write(np.random.default_rng(2).bytes(30_001))
    g = pgeo.Geometry(large_block_size=10000, small_block_size=100)
    ppipe.stream_encode(base, pcoder.TorchCoder(10, 4, device="cpu"), g,
                        batch_size=1000)
    assert names.count("ec_pipeline_dispatch") == names.count(
        "ec_pipeline_kernel_wait") > 1
    with real("inert"):  # no card here: the annotation does nothing
        pass


def test_stamp_counts_host_recomputes_like_reference(tmp_path):
    base = str(tmp_path / "src" / "1")
    os.makedirs(os.path.dirname(base))
    with open(base + ".dat", "wb") as f:
        f.write(np.random.default_rng(8).bytes(40_001))
    g = pgeo.Geometry(large_block_size=10000, small_block_size=100)
    ppipe.stream_encode(base, pcoder.NumpyCoder(10, 4), g, batch_size=1000)
    deltas = {}
    for side, pipe, metrics in (("port", ppipe, pmetrics),
                                ("ref", rpipe, rmetrics)):
        d = str(tmp_path / side)
        shutil.copytree(os.path.dirname(base), d)
        b = os.path.join(d, "1")
        with open(b + ".ecm") as f:
            meta = json.load(f)
        meta["shard_digests"] = {"0": meta["shard_digests"]["0"]}
        with open(b + ".ecm", "w") as f:
            json.dump(meta, f)
        reg = metrics.shared("ec")
        before = reg.value("ec_digest_host_recompute")
        pipe.stamp_shard_digests(b, g)
        pipe.stamp_shard_digests(b, g)  # nothing left to recompute
        deltas[side] = reg.value("ec_digest_host_recompute") - before
    assert deltas == {"port": 13, "ref": 13}
