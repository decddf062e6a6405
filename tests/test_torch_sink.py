"""The port's device sinks and digest helpers against the JAX reference.

``stream_encode_device_sink`` / ``stream_rebuild_device_sink`` on
``TorchCoder(device="cpu")``, under both formulations, must give the
reference sinks' digests on ``JaxCoder`` and the digests of the real
shard files and of the .ecm; several windows and ``materialize=False``
must not change them. The unpooled, padded feeds must give the reference
feeds' batches, and ``stamp_shard_digests`` must merge exactly as the
reference's does. Bit equality everywhere.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from seaweedfs_torch.ec import coder as pcoder
from seaweedfs_torch.ec import feed as pfeed
from seaweedfs_torch.ec import geometry as pgeo
from seaweedfs_torch.ec import pipeline as ppipe
from seaweedfs_torch.ec import striping as pstrip
from seaweedfs_tpu import ec as rec
from seaweedfs_tpu.ec import feed as rfeed
from seaweedfs_tpu.ec import pipeline as rpipe

# the plain version runs at test sizes: one thread keeps this worker
# from crowding the others under pytest-xdist
torch.set_num_threads(1)

GEO = {"large_block_size": 262144, "small_block_size": 16384}
BATCH = 65536
VICTIMS = (12, 0, 7, 3)  # digest rows follow the caller's order
FORMULATIONS = ["bitplane", "xorsched"]


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """A mixed-tier volume (large and small rows) encoded by the port's
    stream_encode, with its .ecm digests."""
    d = tmp_path_factory.mktemp("sink")
    base = os.path.join(str(d), "1")
    rng = np.random.default_rng(17)
    with open(base + ".dat", "wb") as f:
        f.write(rng.integers(0, 256, 4_000_003, dtype=np.uint8).tobytes())
    pg = pgeo.Geometry(**GEO)
    ppipe.stream_encode(base, pcoder.NumpyCoder(10, 4), pg,
                        batch_size=BATCH, depth=2)
    return {"base": base, "pg": pg, "rg": rec.Geometry(**GEO)}


def _coder(formulation: str):
    return pcoder.TorchCoder(10, 4, device="cpu", formulation=formulation)


@pytest.mark.parametrize("formulation", FORMULATIONS)
def test_encode_sink_matches_reference_and_files(encoded, formulation):
    base = encoded["base"]
    stats: dict = {}
    got = ppipe.stream_encode_device_sink(
        base, _coder(formulation), encoded["pg"], batch_size=BATCH,
        stats=stats)
    assert got.dtype == np.uint32 and got.shape == (4,)
    want = rpipe.stream_encode_device_sink(
        base, rec.JaxCoder(10, 4), encoded["rg"], batch_size=BATCH)
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got, ppipe.parity_file_digest(base, encoded["pg"]))
    stamped = ppipe.read_stamped_digests(base)
    assert [stamped[i] for i in range(10, 14)] == got.tolist()
    assert stats["n_windows"] == 1
    assert stats["n_batches"] == stats["staged_bytes"] // (10 * BATCH)
    assert stats["volume_bytes"] == 4_000_003
    for key in ("read_wait_s", "stage_s", "dispatch_s", "wait_s",
                "total_s"):
        assert stats[key] >= 0


@pytest.mark.parametrize("formulation", FORMULATIONS)
def test_rebuild_sink_matches_reference_and_files(encoded, formulation):
    base = encoded["base"]
    stats: dict = {}
    got = ppipe.stream_rebuild_device_sink(
        base, _coder(formulation), VICTIMS, encoded["pg"],
        batch_size=BATCH, stats=stats)
    assert got.shape == (len(VICTIMS),)
    want = rpipe.stream_rebuild_device_sink(
        base, rec.JaxCoder(10, 4), VICTIMS, encoded["rg"],
        batch_size=BATCH)
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got, ppipe.shard_file_digest(base, VICTIMS))
    stamped = ppipe.read_stamped_digests(base)
    assert [stamped[v] for v in VICTIMS] == got.tolist()
    assert stats["shard_bytes"] == os.path.getsize(base + ".ec00")


@pytest.mark.parametrize("formulation", FORMULATIONS)
def test_sinks_over_several_windows_and_deferred(encoded, formulation):
    base, pg = encoded["base"], encoded["pg"]
    coder = _coder(formulation)
    stats: dict = {}
    acc = ppipe.stream_encode_device_sink(
        base, coder, pg, batch_size=BATCH, window_bytes=3 * 10 * BATCH,
        stats=stats, materialize=False)
    assert stats["n_windows"] > 1
    assert not isinstance(acc, np.ndarray)
    assert np.array_equal(coder.materialize(acc),
                          ppipe.parity_file_digest(base, pg))
    acc = ppipe.stream_rebuild_device_sink(
        base, coder, VICTIMS, pg, batch_size=BATCH,
        window_bytes=2 * 10 * BATCH, materialize=False)
    assert np.array_equal(coder.materialize(acc),
                          ppipe.shard_file_digest(base, VICTIMS))


def test_digest_wraps_mod_2_32():
    """The int64 accumulator reduces to the reference's wrapping uint32
    sum: 20 batches of one all-0xFF row sum past 2^32."""
    coder = pcoder.TorchCoder(1, 1, device="cpu")
    x = np.full((1, 1 << 20), 0xFF, dtype=np.uint8)
    acc = None
    for _ in range(20):
        acc = coder.encode_digest_async(x, acc)
    parity = coder.encode(x)
    want = (int(parity.astype(np.uint64).sum()) * 20) & 0xFFFFFFFF
    assert int(parity.astype(np.uint64).sum()) * 20 > 1 << 32
    assert coder.materialize(acc).tolist() == [want]
    ref = rec.NumpyCoder(1, 1)
    racc = None
    for _ in range(20):
        racc = ref.encode_digest_async(x, racc)
    assert np.asarray(racc).tolist() == [want]


def test_numpy_coder_window_hooks_match_reference():
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, 256, (10, 999), dtype=np.uint8)
               for _ in range(3)]
    port, ref = pcoder.NumpyCoder(10, 4), rec.NumpyCoder(10, 4)
    staged = [port.stage_async(b) for b in batches]
    assert np.array_equal(port.encode_digest_window_async(staged),
                          ref.encode_digest_window_async(batches))
    present = tuple(range(2, 12))
    assert np.array_equal(
        port.rec_digest_window_async(present, (1, 0), staged),
        ref.rec_digest_window_async(present, (1, 0), batches))


def _batches(it) -> list:
    return [np.array(b, copy=True) for b in it]


@pytest.mark.parametrize("pad_final", [False, True])
def test_unpooled_padded_stripe_feed_matches_reference(encoded, pad_final):
    base, pg, rg = encoded["base"], encoded["pg"], encoded["rg"]
    size = os.path.getsize(base + ".dat")
    port = pfeed.PreadvFeed(base + ".dat", 10, BATCH, pooled=False)
    ref = rfeed.PreadvFeed(base + ".dat", 10, BATCH, pooled=False,
                           readers=1, odirect=False)
    try:
        got = _batches(port.batches(
            pstrip.stripe_segments(size, pg, BATCH), pad_final=pad_final))
        want = _batches(ref.batches(
            rec.striping.stripe_segments(size, rg, BATCH),
            pad_final=pad_final))
    finally:
        port.close()
        ref.close()
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert (got[-1].shape[1] == BATCH) == (pad_final or
                                           want[-1].shape[1] == BATCH)
    assert not port.pool.pooled and not port._lent


@pytest.mark.parametrize("pad_final", [False, True])
def test_unpooled_padded_shard_feed_matches_reference(encoded, pad_final):
    base = encoded["base"]
    paths = [base + pgeo.to_ext(i) for i in range(1, 11)]
    width = 100_000  # the shard files are not a multiple of it
    port = pfeed.ShardFeed(paths, width, pooled=False)
    ref = rfeed.ShardFeed(paths, width, pooled=False, use_mmap=False,
                          readers=1, odirect=False)
    try:
        got = _batches(port.batches(width, pad_final=pad_final))
        want = _batches(ref.batches(width, pad_final=pad_final))
    finally:
        port.close()
        ref.close()
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert (got[-1].shape[1] == width) == pad_final


def test_pooled_feed_still_recycles(encoded):
    base, pg = encoded["base"], encoded["pg"]
    size = os.path.getsize(base + ".dat")
    feed = pfeed.PreadvFeed(base + ".dat", 10, BATCH, pool_buffers=2)
    try:
        n = 0
        for b in feed.batches(pstrip.stripe_segments(size, pg, BATCH)):
            feed.recycle(b)
            n += 1
        assert n > 2 and feed.pool.pooled and not feed._lent
    finally:
        feed.close()


def test_stamp_shard_digests_merges_like_reference(encoded, tmp_path):
    """Merge-only: stamped ids keep their value even after the shard
    changed; missing ids are computed from the files; the .ecm bytes
    equal the reference's."""
    dirs = {}
    for side in ("port", "ref"):
        d = str(tmp_path / side)
        os.mkdir(d)
        for i in range(14):
            shutil.copy(encoded["base"] + pgeo.to_ext(i),
                        os.path.join(d, "1" + pgeo.to_ext(i)))
        base = os.path.join(d, "1")
        with open(encoded["base"] + ".ecm") as f:
            meta = json.load(f)
        # stamped: 0..4 (0 with a stale value); 5..13 left to compute
        meta["shard_digests"] = {"0": 12345, "1": meta["shard_digests"]["1"],
                                 "2": 7, "3": 8, "4": 9}
        with open(base + ".ecm", "w") as f:
            json.dump(meta, f)
        dirs[side] = base
    os.remove(dirs["port"] + pgeo.to_ext(13))
    os.remove(dirs["ref"] + pgeo.to_ext(13))
    got = ppipe.stamp_shard_digests(dirs["port"], encoded["pg"])
    want = rpipe.stamp_shard_digests(dirs["ref"], encoded["rg"])
    assert got == want
    assert got[0] == 12345 and 13 not in got
    assert got[5] == int(ppipe.shard_file_digest(dirs["port"], [5])[0])
    with open(dirs["port"] + ".ecm") as f, open(dirs["ref"] + ".ecm") as g:
        assert f.read() == g.read()
    assert ppipe.read_stamped_digests(dirs["port"]) == got
    # a second stamp changes nothing; no marker, no stamp
    assert ppipe.stamp_shard_digests(dirs["port"], encoded["pg"]) == got
    os.remove(dirs["port"] + ".ecm")
    assert ppipe.stamp_shard_digests(dirs["port"], encoded["pg"]) == {}
    assert ppipe.read_stamped_digests(dirs["port"]) == {}
