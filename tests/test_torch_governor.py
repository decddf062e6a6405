"""The port's feed governor and governed pipeline against the reference's.

Both packages' ``FeedGovernor`` get the same synthetic span totals (the
scenarios of tests/test_feed_governor.py: memory budget, overhead-bound
reads, kernel-bound, write-bound, hard bounds, reader widening, a
disabled governor, several devices, the formulation axis with a coder
double that has the retune hook) and must give the same plans, field by
field, and the same exported gauges, rendered byte for byte. A governed
``stream_encode`` / ``stream_encode_many`` / ``stream_rebuild`` with
``TorchCoder(device="cpu")`` must write the reference's bytes (shards,
.ecx, .ecm) and record the same span names with the same per-stage
counts. Exact equality everywhere.
"""

import hashlib
import os
import shutil

import numpy as np
import pytest
import torch

from seaweedfs_torch import observe as pobs
from seaweedfs_torch.ec import coder as pcoder
from seaweedfs_torch.ec import geometry as pgeo
from seaweedfs_torch.ec import governor as pgov
from seaweedfs_torch.ec import pipeline as ppipe
from seaweedfs_torch.ec import striping as pstrip
from seaweedfs_torch.observe import wideevents as pwide
from seaweedfs_torch.storage.needle import Needle as PNeedle
from seaweedfs_torch.storage.volume import Volume as PVolume
from seaweedfs_torch.utils import metrics as pmetrics
from seaweedfs_tpu import ec as rec
from seaweedfs_tpu import observe as robs
from seaweedfs_tpu.ec import governor as rgov
from seaweedfs_tpu.ec import pipeline as rpipe
from seaweedfs_tpu.observe import wideevents as rwide
from seaweedfs_tpu.utils import metrics as rmetrics

torch.set_num_threads(1)

MB = 1024 * 1024
SIDES = {"port": (pgov, pobs, pmetrics, ppipe),
         "ref": (rgov, robs, rmetrics, rpipe)}

# the feed knobs the governor reads at construction, pinned so that no
# test depends on the host's core count
HOST_ENV = {"WEED_EC_READERS": "2", "WEED_EC_READERS_MAX": "4",
            "WEED_EC_GZIP_WORKERS": "1", "WEED_EC_GZIP_MAX": "2"}


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    for k, v in HOST_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("WEED_EC_FORMULATION", raising=False)
    for gov, obs, _, _ in SIDES.values():
        gov.reset()
        obs.reset()
    pwide.reset()
    rwide.reset()
    yield
    for gov, obs, _, _ in SIDES.values():
        gov.reset()
        obs.reset()


class _Double:
    """A coder double with the formulation hook both packages'
    _steer_formulation look for: it runs whatever the plan says."""

    def retune_formulation(self, formulation: str) -> str:
        return formulation


def _play(side: str, steps: list) -> tuple[list, str]:
    """Run a scenario on one package's governor: ("plan", nbytes, k,
    chips) records the plan; ("run", read_s, dispatch_s, kernel_s,
    write_s, n, nbytes, k, chips) injects one run's per-batch ec.* spans,
    plans (steered through the hooked double) and folds the run. Returns
    the plans and the governor's gauges, rendered."""
    gov_mod, obs, metrics, pipe = SIDES[side]
    gov = gov_mod.FeedGovernor()
    gov.metrics = metrics.Registry("ec")
    out = []
    for step in steps:
        if step[0] == "plan":
            _, nbytes, k, chips = step
            out.append(tuple(gov.plan(nbytes, k, chips=chips)))
            continue
        _, read_s, dispatch_s, kernel_s, write_s, n, nbytes, k, chips = step
        ctx = obs.TraceCtx(obs.new_id(), "", "ec", "")
        for name, secs in (("ec.read", read_s), ("ec.dispatch", dispatch_s),
                           ("ec.kernel", kernel_s), ("ec.write", write_s)):
            for _ in range(n):
                obs.record_span(name, ctx, 0, int(secs / n * 1e6))
        op = pipe._steer_formulation(_Double(),
                                     gov.plan(nbytes, k, chips=chips))
        gov.finish_run(ctx.trace_id, op, nbytes, k)
        out.append(tuple(op))
    return out, gov.metrics.render()


def _run(read_s, dispatch_s, kernel_s, write_s, n=8, nbytes=100 * MB,
         k=10, chips=1):
    return ("run", read_s, dispatch_s, kernel_s, write_s, n, nbytes, k,
            chips)


def _plan(nbytes=1 << 30, k=10, chips=1):
    return ("plan", nbytes, k, chips)


SCENARIOS = {
    "memory_budget": ({"WEED_EC_HOST_BUDGET_MB": "128",
                       "WEED_EC_BATCH_BYTES": str(64 * MB)},
                      [_plan(), _plan(k=20)]),
    "overhead_dominated_read": ({"WEED_EC_HOST_BUDGET_MB": "4096"},
                                [_plan(), _run(0.05, 0.01, 0.01, 0.01,
                                               n=100), _plan()]),
    "kernel_bound": ({}, [_plan(), _run(0.1, 0.1, 5.0, 0.1), _plan(),
                          _run(0.1, 0.1, 5.0, 0.1), _plan()]),
    "write_bound": ({}, [_plan(), _run(0.1, 0.1, 0.1, 5.0), _plan(),
                         _run(0.1, 0.1, 0.1, 5.0), _plan()]),
    "hard_bounds": ({"WEED_EC_BATCH_MAX": str(8 * MB),
                     "WEED_EC_DEPTH_MAX": "4"},
                    [_run(0.05, 0.01, 5.0, 0.01, n=200)] * 10 + [_plan()]),
    "reader_widening": ({"WEED_EC_READERS": "1",
                         "WEED_EC_READERS_MAX": "8"},
                        [_plan()] + [_run(5.0, 0.1, 0.1, 0.1), _plan()] * 5),
    "disabled": ({"WEED_EC_GOVERNOR": "0"},
                 [_plan(), _run(0.01, 0.01, 9.0, 0.01, n=100), _plan()]),
    "chips": ({"WEED_EC_BATCH_BYTES": str(1 * MB),
               "WEED_EC_BATCH_MIN": str(1 * MB),
               "WEED_EC_HOST_BUDGET_MB": "4096"},
              [_plan(chips=1), _plan(chips=8),
               _run(0.1, 0.1, 5.0, 0.1, chips=4), _plan(chips=4)]),
    "formulation_explore_exploit": (
        {}, [_run(0.1, 0.1, 1.0, 0.1), _run(0.1, 0.1, 0.5, 0.1),
             _run(0.1, 0.1, 0.5, 0.1), _plan(), _plan(k=20)]),
    "formulation_pinned": ({"WEED_EC_FORMULATION": "xorsched"},
                           [_run(0.1, 0.1, 1.0, 0.1), _plan()]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_governor_matches_reference(name, monkeypatch):
    env, steps = SCENARIOS[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port, port_gauges = _play("port", steps)
    ref, ref_gauges = _play("ref", steps)
    assert port == ref
    assert port_gauges == ref_gauges
    assert pgov.OperatingPoint._fields == rgov.OperatingPoint._fields


def test_scenarios_move_the_plan():
    """The scenarios are not vacuous: each retune moved the plan as the
    reference's own tests say it must."""
    plans = {}
    for name, (env, steps) in SCENARIOS.items():
        with pytest.MonkeyPatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            plans[name] = _play("port", steps)[0]
    batch, depth, write_depth, readers = 0, 1, 2, 3
    assert plans["memory_budget"][0][batch] * 10 * 6 <= 128 * MB
    p = plans["overhead_dominated_read"]
    assert p[2][batch] == 2 * p[0][batch]
    p = plans["kernel_bound"]
    assert p[2][depth] == p[0][depth] + 1
    p = plans["write_bound"]
    assert p[2][write_depth] > p[0][write_depth]
    assert plans["hard_bounds"][-1][batch] <= 8 * MB
    assert plans["hard_bounds"][-1][depth] <= 4
    p = plans["reader_widening"]
    assert [x[readers] for x in p[::2]] == [1, 2, 4, 8, 8, 8]
    # depth stays while the pool widens, then deepens
    assert [x[depth] - p[0][depth] for x in p[::2]] == [0, 0, 0, 0, 1, 2]
    p = plans["disabled"]
    assert p[0] == p[2]
    p = plans["chips"]
    assert p[1][batch] >= 8 * MB and p[1][4] == 8
    assert p[3][batch] == 2 * p[2][batch]
    p = plans["formulation_explore_exploit"]
    assert [x[6] for x in p[:3]] == ["bitplane", "xorsched", "xorsched"]
    assert p[3][6] == "xorsched" and p[4][6] == "bitplane"
    assert plans["formulation_pinned"][-1][6] == "xorsched"


def test_torch_coder_has_no_formulation_hook():
    op = pgov.OperatingPoint(MB, 4, 4)
    assert ppipe._steer_formulation(
        pcoder.TorchCoder(10, 4, device="cpu"), op).formulation == ""
    assert rpipe._steer_formulation(
        rec.get_coder("numpy", 10, 4), op).formulation == ""


def test_shared_registry_exports_the_plan(monkeypatch):
    monkeypatch.setenv("WEED_EC_READERS", "3")
    pgov.FeedGovernor().plan(1 << 30, 10)
    text = pmetrics.render_shared()
    assert "seaweedfs_tpu_ec_feed_reader_threads 3" in text
    assert "seaweedfs_tpu_ec_feed_batch_bytes" in text


# --- governed runs against the reference ---------------------------------

GEO = {"large_block_size": 262144, "small_block_size": 16384}
GOVERNED_ENV = {"WEED_EC_BATCH_BYTES": "65536", "WEED_EC_BATCH_MIN": "16384",
                "WEED_EC_READERS": "2"}
VICTIMS = (0, 3, 7, 12)


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def volume(tmp_path_factory):
    """A mixed-tier needle volume (large and small rows), about 3 MB."""
    d = str(tmp_path_factory.mktemp("gov_src"))
    rng = np.random.default_rng(11)
    vol = PVolume(d, "", 1, create=True)
    nid = written = 0
    while written < 3 << 20:
        nid += 1
        size = int(rng.integers(1024, 128 * 1024))
        vol.write_needle(PNeedle(cookie=nid, id=nid,
                                 data=rng.bytes(size)))
        written += size
    vol.close()
    return d


def _copies(volume, tmp_path, names):
    bases = {}
    for name in names:
        d = str(tmp_path / name)
        shutil.copytree(volume, d)
        bases[name] = os.path.join(d, "1")
    return bases


def _coder(side: str):
    return (pcoder.TorchCoder(10, 4, device="cpu") if side == "port"
            else rec.get_coder("numpy", 10, 4))


def _geo(side: str):
    return pgeo.Geometry(**GEO) if side == "port" else rec.Geometry(**GEO)


def _span_counts(side: str, wide) -> dict:
    obs = SIDES[side][1]
    trace = wide.events(svc="ec")[-1]["trace"]
    return {k: c for k, (c, _) in obs.stage_totals(
        trace, prefix="ec.").items()}


def _assert_same_files(a: str, b: str, exts) -> None:
    for ext in exts:
        assert _sha(a + ext) == _sha(b + ext), ext


SHARDS = [pgeo.to_ext(i) for i in range(14)]


def test_governed_stream_encode_matches_reference(volume, tmp_path,
                                                  monkeypatch):
    for k, v in GOVERNED_ENV.items():
        monkeypatch.setenv(k, v)
    bases = _copies(volume, tmp_path, ["port", "ref"])
    counts = {}
    for side, wide in (("port", pwide), ("ref", rwide)):
        gov = SIDES[side][0]
        SIDES[side][3].stream_encode(bases[side], _coder(side), _geo(side))
        assert gov.get().runs == 1
        counts[side] = _span_counts(side, wide)
    pstrip.write_sorted_ecx_from_idx(bases["port"])
    rec.write_sorted_ecx_from_idx(bases["ref"])
    _assert_same_files(bases["port"], bases["ref"],
                       SHARDS + [".ecx", ".ecm"])
    assert counts["port"] == counts["ref"]
    assert set(counts["port"]) == {"ec.read", "ec.dispatch", "ec.kernel",
                                   "ec.digest", "ec.write"}
    assert len(set(counts["port"].values())) == 1
    assert counts["port"]["ec.read"] > 1
    assert pgov.get().metrics.value("feed_runs") == 1


def test_governed_encode_many_matches_reference(volume, tmp_path,
                                                monkeypatch):
    for k, v in GOVERNED_ENV.items():
        monkeypatch.setenv(k, v)
    bases = _copies(volume, tmp_path, ["p1", "p2", "r1", "r2"])
    counts = {}
    for side, wide, names in (("port", pwide, ["p1", "p2"]),
                              ("ref", rwide, ["r1", "r2"])):
        n = SIDES[side][3].stream_encode_many(
            [bases[x] for x in names], _coder(side), _geo(side))
        assert n == 2 and SIDES[side][0].get().runs == 1
        counts[side] = _span_counts(side, wide)
    for p, r in (("p1", "r1"), ("p2", "r2")):
        _assert_same_files(bases[p], bases[r], SHARDS + [".ecm"])
    assert counts["port"] == counts["ref"]
    assert counts["port"]["ec.volume"] == 2
    assert ppipe.stream_encode_many([], _coder("port"), _geo("port")) == 0


def test_governed_stream_rebuild_matches_reference(volume, tmp_path,
                                                   monkeypatch):
    for k, v in GOVERNED_ENV.items():
        monkeypatch.setenv(k, v)
    bases = _copies(volume, tmp_path, ["port", "ref"])
    want = {}
    counts = {}
    for side, wide in (("port", pwide), ("ref", rwide)):
        pipe = SIDES[side][3]
        pipe.stream_encode(bases[side], _coder(side), _geo(side),
                           batch_size=65536, depth=2)
        want[side] = {v: _sha(bases[side] + pgeo.to_ext(v))
                      for v in VICTIMS}
        for v in VICTIMS:
            os.remove(bases[side] + pgeo.to_ext(v))
        assert pipe.stream_rebuild(bases[side], _coder(side),
                                   _geo(side)) == list(VICTIMS)
        assert SIDES[side][0].get().runs == 1
        counts[side] = _span_counts(side, wide)
    assert want["port"] == want["ref"]
    for v in VICTIMS:
        assert _sha(bases["port"] + pgeo.to_ext(v)) == want["port"][v]
    assert counts["port"] == counts["ref"]
    assert set(counts["port"]) == {"ec.read", "ec.dispatch", "ec.kernel",
                                   "ec.write"}


def test_explicit_args_pin_the_plan(volume, tmp_path):
    gov = pgov.get()
    before = (gov._batch, gov._depth, gov._write_depth, gov.runs)
    base = _copies(volume, tmp_path, ["p"])["p"]
    ppipe.stream_encode(base, _coder("port"), _geo("port"),
                        batch_size=65536)
    assert (gov._batch, gov._depth, gov._write_depth, gov.runs) == before
    ev = pwide.events(svc="ec")[-1]
    assert ev["name"] == "ec.encode 1" and ev["stages"]["ec.read"] >= 0
