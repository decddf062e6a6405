"""The port's shard writers when ``fsync`` fails at close.

``_FanOut._writer`` takes close()'s sentinel and then syncs the file. A
failed sync must record its error and end the writer: the writer must not
go on to drain its queue for the sentinel it has already taken. Otherwise
``close()`` joins forever and ``stream_encode``, ``stream_encode_many``
and ``stream_rebuild`` neither return nor raise. The reference has the
same writer (``seaweedfs_tpu/ec/pipeline.py``, ``_FanOut._writer``) and
hangs on this input, so it is not run here; every call under test runs
in a daemon thread joined with a timeout, so a hang fails the test
instead of stalling the run.
"""

import errno
import os
import threading

import numpy as np
import pytest
import torch

from seaweedfs_torch.ec import coder as pcoder
from seaweedfs_torch.ec import geometry as pgeo
from seaweedfs_torch.ec import pipeline as ppipe
from seaweedfs_torch.ec.geometry import to_ext

torch.set_num_threads(1)

JOIN_S = 10.0
GEO = pgeo.Geometry(large_block_size=262144, small_block_size=16384)


def _failing_fsync(fd):
    raise OSError(errno.EIO, "injected fsync failure")


def _bounded(fn, *args, **kwargs):
    """Run fn in a daemon thread; (finished, exception or None)."""
    box = {}

    def run():
        try:
            fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 - handed to the test
            box["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(JOIN_S)
    return not th.is_alive(), box.get("error")


def test_fanout_close_returns_when_fsync_fails(tmp_path, monkeypatch):
    """One path, one 16-byte row: close() comes after the row is written,
    so the writer takes the sentinel from its blocking get and then
    fails to sync."""
    monkeypatch.setattr(ppipe.os, "fsync", _failing_fsync)
    path = str(tmp_path / "shard")
    fan = ppipe._FanOut([path], depth=2)
    written = threading.Event()
    fan.put_rows(iter([np.arange(16, dtype=np.uint8)]), on_done=written.set)
    assert written.wait(JOIN_S)
    finished, err = _bounded(fan.close)
    assert finished, "close() did not return after a failed fsync"
    assert err is None
    assert len(fan.errors) == 1
    assert isinstance(fan.errors[0], OSError)
    assert fan.errors[0].errno == errno.EIO
    with open(path, "rb") as f:
        assert f.read() == bytes(range(16))


def _volume(directory, seed: int = 5, size: int = 200_000) -> str:
    base = os.path.join(str(directory), "1")
    with open(base + ".dat", "wb") as f:
        f.write(np.random.default_rng(seed).bytes(size))
    return base


def _encode(base):
    ppipe.stream_encode(base, pcoder.TorchCoder(10, 4, device="cpu"), GEO,
                        batch_size=32768, depth=2)


def _encode_many(base):
    ppipe.stream_encode_many([base], pcoder.TorchCoder(10, 4, device="cpu"),
                             GEO, batch_size=32768, depth=2)


def _rebuild(base):
    ppipe.stream_rebuild(base, pcoder.TorchCoder(10, 4, device="cpu"), GEO,
                         batch_size=32768, depth=2)


@pytest.mark.parametrize("entry", ["stream_encode", "stream_encode_many",
                                   "stream_rebuild"])
def test_stream_entry_raises_when_fsync_fails(entry, tmp_path, monkeypatch):
    base = _volume(tmp_path)
    if entry == "stream_rebuild":
        _encode(base)
        for i in (2, 11):
            os.remove(base + to_ext(i))
    monkeypatch.setattr(ppipe.os, "fsync", _failing_fsync)
    run = {"stream_encode": _encode, "stream_encode_many": _encode_many,
           "stream_rebuild": _rebuild}[entry]
    finished, err = _bounded(run, base)
    assert finished, f"{entry} hung after a failed fsync"
    assert isinstance(err, OSError) and err.errno == errno.EIO
    if entry != "stream_rebuild":
        assert not os.path.exists(base + ".ecm"), "a failed set committed"
