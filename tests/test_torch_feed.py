"""The port's host feeds against the reference's (ec/feed.py).

Mmap, preadv, O_DIRECT and the reader pool must give the reference
feeds' batches byte for byte on the same odd-sized .dat and survivor
files, following tests/test_feed_equivalence.py: zero-copy strided views
of the map, a bounded pool whose buffers recycle, close() waking a
starved reader and ending the pool threads, O_DIRECT degrading to
buffered reads with page-aligned staging, and the ``ec.feed.read`` /
``ec.feed.stall`` fault points firing. The whole pipeline on each feed
must write the reference's shards. Exact equality everywhere.
"""

import hashlib
import os
import threading

import numpy as np
import pytest
import torch

from seaweedfs_torch import faults as pfaults
from seaweedfs_torch import observe as pobs
from seaweedfs_torch.ec import coder as pcoder
from seaweedfs_torch.ec import feed as pfeed
from seaweedfs_torch.ec import geometry as pgeo
from seaweedfs_torch.ec import pipeline as ppipe
from seaweedfs_torch.ec import striping as pstrip
from seaweedfs_torch.utils import metrics as pmetrics
from seaweedfs_tpu import ec as rec
from seaweedfs_tpu.ec import feed as rfeed
from seaweedfs_tpu.ec import pipeline as rpipe

torch.set_num_threads(1)

GEO = {"large_block_size": 10000, "small_block_size": 100}
PG, RG = pgeo.Geometry(**GEO), rec.Geometry(**GEO)
SIZE = 123_457


@pytest.fixture(autouse=True)
def no_faults():
    pfaults.clear()
    yield
    pfaults.clear()


def _write_dat(directory, name: str, size: int, seed: int) -> str:
    base = os.path.join(str(directory), name)
    with open(base + ".dat", "wb") as f:
        f.write(np.random.default_rng(seed).integers(
            0, 256, size, dtype=np.uint8).tobytes())
    return base


@pytest.fixture(scope="module")
def dat(tmp_path_factory):
    return _write_dat(tmp_path_factory.mktemp("feed"), "1", SIZE, 5)


def _drain(feed, it) -> list:
    out = []
    try:
        for b in it:
            out.append(np.array(b, copy=True))
            feed.recycle(b)
    finally:
        feed.close()
    return out


def _stripe(mod, cls, base, batch, **kw):
    f = getattr(mod, cls)(base + ".dat", 10, batch, pool_buffers=3, **kw)
    g = PG if mod is pfeed else RG
    seg = (pstrip if mod is pfeed else rec.striping).stripe_segments
    return _drain(f, f.batches(seg(SIZE, g, batch)))


FEEDS = [("MmapFeed", {}), ("PreadvFeed", {"odirect": False}),
         ("PreadvFeed", {"odirect": True})]


@pytest.mark.parametrize("readers", [1, 3])
@pytest.mark.parametrize("cls,kw", FEEDS, ids=["mmap", "preadv", "odirect"])
def test_stripe_feeds_match_reference(dat, cls, kw, readers):
    for batch in (64, 1000, 1 << 16):
        got = _stripe(pfeed, cls, dat, batch, readers=readers, **kw)
        want = _stripe(rfeed, cls, dat, batch, readers=readers, **kw)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a.shape == b.shape and np.array_equal(a, b), batch


@pytest.mark.parametrize("readers", [1, 3])
@pytest.mark.parametrize("use_mmap", [True, False])
def test_shard_feed_matches_reference(tmp_path, use_mmap, readers):
    base = _write_dat(tmp_path, "1", 77_803, 23)
    ppipe.stream_encode(base, pcoder.NumpyCoder(10, 4), PG, batch_size=1000)
    paths = [base + pgeo.to_ext(i) for i in range(1, 11)]
    got, want = [], []
    for mod, out in ((pfeed, got), (rfeed, want)):
        f = mod.ShardFeed(paths, 512, pool_buffers=3, use_mmap=use_mmap,
                          readers=readers, odirect=False)
        out.extend(_drain(f, f.batches(512, pad_final=True)))
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_open_feed_follows_the_reference_rules(dat, monkeypatch):
    for env, cls in [({}, "MmapFeed"), ({"WEED_EC_MMAP": "0"}, "PreadvFeed"),
                     ({"WEED_EC_ODIRECT": "1"}, "PreadvFeed")]:
        with monkeypatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            for mod in (pfeed, rfeed):
                f = mod.open_feed(dat + ".dat", 10, 1000, readers=1)
                assert type(f).__name__ == cls, env
                f.close()
    for env in [{}, {"WEED_EC_READERS": "3"}, {"WEED_EC_READERS": "999"},
                {"WEED_EC_READERS": "x"}, {"WEED_EC_MMAP": "false"},
                {"WEED_EC_ODIRECT": "yes"}]:
        with monkeypatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            for fn in ("use_mmap_default", "use_odirect_default",
                       "reader_count_default"):
                assert getattr(pfeed, fn)() == getattr(rfeed, fn)(), env
            assert (pfeed.env_thread_count("WEED_EC_READERS", 2)
                    == rfeed.env_thread_count("WEED_EC_READERS", 2))


def test_mmap_zero_copy_views(tmp_path):
    """A batch that is one uniformly strided in-bounds segment is a VIEW
    of the map, as the reference's."""
    g = pgeo.Geometry(10, 4, large_block_size=4096, small_block_size=256)
    size = g.large_row_size * 2
    base = _write_dat(tmp_path, "1", size, 9)
    f = pfeed.MmapFeed(base + ".dat", 10, 4096, pool_buffers=2)
    batches = list(f.batches(pstrip.stripe_segments(size, g, 4096)))
    assert len(batches) == 2
    for b in batches:
        assert not b.flags.owndata and b.base is not None
        assert b.strides == (g.large_block_size, 1)
    dat = np.fromfile(base + ".dat", dtype=np.uint8)
    assert np.array_equal(batches[0],
                          dat[:g.large_row_size].reshape(10, 4096))
    f.close()


def test_pool_bounded_recycled_and_close_unblocks(dat):
    """Withholding recycle() stalls acquire (bounded memory), recycling
    hands back the SAME buffer, and close() wakes a starved reader."""
    f = pfeed.PreadvFeed(dat + ".dat", 10, 1024, pool_buffers=2,
                         readers=1)
    it = f.batches(pstrip.stripe_segments(SIZE, PG, 1024))
    held = [next(it), next(it)]
    ids = {id(b.base) for b in held}
    got, result = threading.Event(), {}

    def puller():
        try:
            result["b"] = next(it)
        except RuntimeError:
            pass
        got.set()

    th = threading.Thread(target=puller, daemon=True)
    th.start()
    assert not got.wait(0.3), "feed allocated beyond its pool"
    f.recycle(held.pop(0))
    assert got.wait(2.0) and id(result["b"].base) in ids
    # starve it again and close: the waiting reader raises
    it2 = f.batches(pstrip.stripe_segments(SIZE, PG, 1024))
    got.clear()

    def starved():
        try:
            next(it2)
        except RuntimeError:
            got.set()

    th2 = threading.Thread(target=starved, daemon=True)
    th2.start()
    th2.join(0.2)
    f.close()
    assert got.wait(2.0), "close() left the reader wedged"
    th.join(2.0)
    th2.join(2.0)
    assert not th.is_alive() and not th2.is_alive()


def test_mid_read_close_ends_pool_threads_without_leaks(dat):
    f = pfeed.PreadvFeed(dat + ".dat", 10, 1024, pool_buffers=2, readers=3)
    it = f.batches(pstrip.stripe_segments(SIZE, PG, 1024))
    held = [next(it), next(it)]
    threads = list(f._rpool._threads)
    assert threads and all(th.is_alive() for th in threads)
    raised = threading.Event()

    def puller():
        try:
            next(it)
        except RuntimeError:
            raised.set()

    th = threading.Thread(target=puller, daemon=True)
    th.start()
    th.join(0.3)
    assert th.is_alive(), "puller should be waiting for a buffer"
    f.close()
    assert raised.wait(2.0)
    th.join(2.0)
    for worker in threads:
        worker.join(2.0)
        assert not worker.is_alive()
    assert len(f._lent) <= len(held)


def test_odirect_staging_is_page_aligned_and_degrades(dat):
    reg = pmetrics.shared("ec")
    before = reg.value("feed_pool_alloc_bytes")
    pool = pfeed.BufferPool(10, 8192, count=2, aligned=True)
    for _ in range(2):
        assert pool.acquire().ctypes.data % pfeed._ALIGN == 0
    assert reg.value("feed_pool_alloc_bytes") - before == 2 * 10 * 8192
    f = pfeed.PreadvFeed(dat + ".dat", 10, 4096, odirect=True, readers=2)
    assert f.pool.aligned
    got = _drain(f, f.batches(pstrip.stripe_segments(SIZE, PG, 4096)))
    want = _stripe(rfeed, "MmapFeed", dat, 4096, readers=1)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_ordered_pool_map_keeps_order_and_raises_in_place():
    pool = pfeed._ReaderPool(3)
    try:
        assert list(pfeed.ordered_pool_map(
            pool, (lambda i=i: i * i for i in range(20)), 4)) == [
            i * i for i in range(20)]

        def boom():
            raise ValueError("job 2")

        fns = [lambda: 0, lambda: 1, boom, lambda: 3]
        it = pfeed.ordered_pool_map(pool, iter(fns), 2)
        assert [next(it), next(it)] == [0, 1]
        with pytest.raises(ValueError, match="job 2"):
            next(it)
    finally:
        pool.close()


@pytest.mark.parametrize("readers", [1, 2])
@pytest.mark.parametrize("action,exc", [("error", pfaults.FaultError),
                                        ("drop", IOError)])
def test_feed_read_fault_fails_the_read(dat, readers, action, exc):
    pfaults.set_fault("ec.feed.read", action, count=1)
    f = pfeed.PreadvFeed(dat + ".dat", 10, 1000, readers=readers)
    with pytest.raises(exc):
        _drain(f, f.batches(pstrip.stripe_segments(SIZE, PG, 1000)))
    assert pfaults.active()[0]["fired"] == 1


def test_feed_stall_fault_fires_on_a_starved_pool(dat):
    pobs.reset()
    pfaults.set_fault("ec.feed.stall", "delay", ms=1, count=1)
    f = pfeed.PreadvFeed(dat + ".dat", 10, 1024, pool_buffers=2, readers=1)
    it = f.batches(pstrip.stripe_segments(SIZE, PG, 1024))
    held = [next(it), next(it)]
    timer = threading.Timer(0.3, lambda: f.recycle(held[0]))
    timer.start()
    next(it)  # waits for the recycle: the stall point fires once
    timer.join()
    f.close()
    assert [s["name"] for s in pobs.spans()] == ["fault.ec.feed.stall"]
    pfaults.set_fault("ec.feed.stall", "drop")
    f = pfeed.PreadvFeed(dat + ".dat", 10, 1024, pool_buffers=2, readers=1)
    it = f.batches(pstrip.stripe_segments(SIZE, PG, 1024))
    _ = [next(it), next(it)]
    with pytest.raises(RuntimeError, match="ec.feed.stall"):
        next(it)
    f.close()


def _sha(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


@pytest.mark.parametrize("env", [{"WEED_EC_MMAP": "1"}, {"WEED_EC_MMAP": "0"},
                                 {"WEED_EC_ODIRECT": "1"},
                                 {"WEED_EC_READERS": "3"}],
                         ids=["mmap", "preadv", "odirect", "readers"])
def test_pipeline_on_each_feed_matches_reference(tmp_path, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    size = 99_001
    pbase = _write_dat(tmp_path, "p", size, 3)
    rbase = _write_dat(tmp_path, "r", size, 3)
    ppipe.stream_encode(pbase, pcoder.TorchCoder(10, 4, device="cpu"), PG,
                        batch_size=1000)
    rpipe.stream_encode(rbase, rec.get_coder("numpy", 10, 4), RG,
                        batch_size=1000)
    for i in range(14):
        assert _sha(pbase + pgeo.to_ext(i)) == _sha(rbase + pgeo.to_ext(i))
    for v in (1, 4, 10, 13):
        os.remove(pbase + pgeo.to_ext(v))
    assert ppipe.stream_rebuild(pbase, pcoder.NumpyCoder(10, 4), PG,
                                batch_size=512) == [1, 4, 10, 13]
    for i in range(14):
        assert _sha(pbase + pgeo.to_ext(i)) == _sha(rbase + pgeo.to_ext(i))


def test_failed_read_leaves_no_marker(tmp_path, monkeypatch):
    """The fault drill: an armed ec.feed.read error fails the encode with
    FaultError and leaves no .ecm; after clear() the run succeeds."""
    monkeypatch.setenv("WEED_EC_MMAP", "0")
    base = _write_dat(tmp_path, "1", 50_001, 4)
    coder = pcoder.TorchCoder(10, 4, device="cpu")
    pfaults.set_fault("ec.feed.read", "error")
    with pytest.raises(pfaults.FaultError):
        ppipe.stream_encode(base, coder, PG, batch_size=1000)
    assert not os.path.exists(base + ".ecm")
    pfaults.clear()
    ppipe.stream_encode(base, coder, PG, batch_size=1000)
    assert os.path.exists(base + ".ecm")
