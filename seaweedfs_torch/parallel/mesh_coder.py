"""MeshCoder: the ErasureCoder over several devices, on PyTorch.

The port's counterpart of seaweedfs_tpu/parallel/mesh_coder.py. It
computes what the reference's mesh computes; it does not shard the way
``shard_map`` does. A mesh is a list of ``torch.device`` ("members"; a
device may repeat), and one process drives all of them, as one reference
process drives its mesh. Each member is a single-device ``TorchCoder``
with its own CUDA stream and its own operands, so a repeated device still
runs its members on separate streams.

- encode (collective-free): a [k, B] batch's columns are padded to a
  multiple of the member count (zero columns have zero parity, and
  ``materialize`` slices the pad off), each member's column slice is
  copied into page-locked host memory and H2D, ``non_blocking``, on the
  member's stream, and the member launches the formulation's
  hand-written kernel (``rs_cuda.gf_apply`` for ``bitplane``,
  ``gf_apply_xorsched`` for ``xorsched``) with its digest epilogue; the
  host gathers the parity slices, and ``row_digests`` adds the members'
  wrapping uint32 sums (pad columns add 0), which equals the single-card
  digest.
- rebuild: the survivor rows are row-sharded (rows and columns padded to
  the member count), an all-gather gives every member the k rows (device
  copies between the members' streams, ordered by events; no
  ``torch.distributed``), and each member reconstructs its own column
  slice.
- digest windows: ``stage_async`` stages column slices as encode does;
  each member runs the digest-only launches on its slices, and
  ``materialize`` adds the members' [R] partial sums.

Staging is per member: every slice is an ``ec.stage.chip`` span and adds
to the ``feed_chip_staged_bytes`` / ``feed_chip_stage_seconds`` counters
(labelled by chip) of the shared "ec" registry, beside the
``feed_mesh_devices`` gauge.

``WEED_EC_MESH_DEVICES`` selects the mesh as in the reference: unset,
"0" or "1" is no mesh, "all" every card, N clamps to the cards present.
A request that resolves to one card gives the single-card
``TorchCoder``: ``coder()`` never returns a MeshCoder over one card. The
reference's "pallas" method is the port's ``bitplane`` (both run
``_gf_kernel``'s counterpart); ``lut`` has no kernel here and raises.
Synchronous reconstruction (degraded reads) runs on the first member,
as the reference's runs on one device.

Not ported: the HLO inspection (``encode_hlo_text``,
``encode_is_collective_free``; the encode makes no device-to-device
copy by construction) and the ``warm_*`` hooks (nothing compiles per
shape here).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import observe
from ..ec.coder import ErasureCoder, TorchCoder, _Staged
from ..ops import rs_torch
from ..utils import metrics as metrics_mod

# the reference's method names that mean one of the port's formulations
_ALIASES = {"pallas": "bitplane"}


def card_devices(n: int) -> list[torch.device]:
    """The first n cards, the mesh a card count asks for."""
    return [torch.device("cuda", i) for i in range(n)]


def mesh_device_count() -> int:
    """The cards WEED_EC_MESH_DEVICES asks for: 0 is no mesh (the
    default), "all" every card, N clamps to the cards present; a count
    of one or less reads as no mesh (one card is the TorchCoder path)."""
    raw = os.environ.get("WEED_EC_MESH_DEVICES", "").strip().lower()
    if not raw or raw in ("0", "1", "no", "false"):
        return 0
    have = torch.cuda.device_count()
    if raw == "all":
        return have if have > 1 else 0
    try:
        n = int(raw)
    except ValueError:
        return 0
    n = min(n, have)
    return n if n > 1 else 0


def _formulation(formulation: Optional[str]) -> str:
    """A formulation by TorchCoder's rule (unset: the WEED_EC_FORMULATION
    pin, xorsched or bitplane), the reference's aliases resolved."""
    env = rs_torch.formulation_env()
    f = formulation or ("xorsched" if env == "xorsched" else "bitplane")
    return _ALIASES.get(f, f)


def coder(data_shards: int, parity_shards: int,
          n_devices: Optional[int] = None,
          formulation: Optional[str] = None) -> ErasureCoder:
    """The mesh-or-single factory: a MeshCoder over n_devices cards
    (default: WEED_EC_MESH_DEVICES, then every card) when that resolves
    to more than one, else the single-card TorchCoder, which raises where
    there is no card."""
    if n_devices is None:
        if os.environ.get("WEED_EC_MESH_DEVICES", "").strip():
            n_devices = mesh_device_count() or 1
        else:
            n_devices = torch.cuda.device_count()
    if n_devices <= 1:
        return TorchCoder(data_shards, parity_shards,
                          formulation=_formulation(formulation))
    return MeshCoder(data_shards, parity_shards, n_devices=n_devices,
                     formulation=formulation)


class _MeshHandle:
    """The members' in-flight results (column slices, in member order)
    and the valid (pre-padding) width."""

    __slots__ = ("parts", "width")

    def __init__(self, parts: list, width: int):
        self.parts = parts
        self.width = width


class _MeshStaged:
    """One batch staged as the members' column slices."""

    __slots__ = ("parts",)

    def __init__(self, parts: list):
        self.parts = parts

    def block_until_ready(self) -> "_MeshStaged":
        for p in self.parts:
            p.block_until_ready()
        return self


class _MeshDigest:
    """The members' running digest buffers."""

    __slots__ = ("parts",)

    def __init__(self, parts: list):
        self.parts = parts


def _host_buffer(device: torch.device, shape: tuple) -> torch.Tensor:
    """A host buffer for one member's slice: page-locked for a card, so
    its H2D copy runs asynchronously on the member's stream."""
    return torch.empty(shape, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")


def all_gather_rows(members: Sequence[TorchCoder],
                    blocks: Sequence[_Staged]) -> list[torch.Tensor]:
    """Every member's copy of all the members' row blocks, stacked in
    member order on its own device. blocks[i] was staged on member i's
    stream; each member's copies are enqueued on its own stream after
    every block's event, so the result is ready for that member's next
    launch (on the CPU, plain concatenations)."""
    out = []
    for mb in members:
        stream = mb._stream
        if stream is None:
            out.append(torch.cat([b.dev.to(mb.device) for b in blocks]))
            continue
        with torch.cuda.stream(stream):
            for b in blocks:
                if b.event is not None:
                    stream.wait_event(b.event)
            full = torch.empty((sum(b.dev.shape[0] for b in blocks),
                                blocks[0].dev.shape[1]),
                               dtype=torch.uint8, device=mb.device)
            row = 0
            for b in blocks:
                full[row:row + b.dev.shape[0]].copy_(b.dev,
                                                     non_blocking=True)
                row += b.dev.shape[0]
        out.append(full)
    return out


def gather_apply(members: Sequence[TorchCoder], operands: Sequence,
                 blocks: Sequence[_Staged], k: int, cols: int,
                 rows: int) -> list:
    """The rebuild's sharded step: all-gather the members' row blocks of
    the survivors, then each member j applies its operand to the k rows
    of its column slice [j * cols, (j + 1) * cols); returns the members'
    handles, each with `rows` real output rows."""
    handles = []
    for j, (mb, w, full) in enumerate(zip(members, operands,
                                          all_gather_rows(members, blocks))):
        with (torch.cuda.stream(mb._stream) if mb._stream is not None
              else contextlib.nullcontext()):
            local = full[:k, j * cols:(j + 1) * cols].contiguous()
        # the blocks and the gathered rows stay referenced until the
        # member's last event
        handles.append(mb._launch(w, local, rows, keep=(full, *blocks)))
    return handles


class MeshCoder(ErasureCoder):
    """ErasureCoder over several devices: column-split encode, all-gather
    rebuild, summed digest windows (module docstring). `devices` names the
    members explicitly and may repeat one; otherwise the first
    `n_devices` cards (default: every card)."""

    def __init__(self, data_shards: int, parity_shards: int,
                 n_devices: Optional[int] = None,
                 formulation: Optional[str] = None,
                 devices: Optional[Sequence] = None):
        super().__init__(data_shards, parity_shards)
        f = _formulation(formulation)
        if f not in ("bitplane", "xorsched"):
            raise ValueError(f"MeshCoder: unknown formulation {f!r}")
        if devices is None:
            have = torch.cuda.device_count()
            n = n_devices or have
            if n < 2:
                raise ValueError("MeshCoder needs >= 2 devices; use "
                                 "TorchCoder (or parallel.mesh_coder."
                                 "coder) for one card")
            if have < n:
                raise ValueError(f"need {n} cards, have {have}")
            devices = card_devices(n)
        devices = [torch.device(d) for d in devices]
        if len(devices) < 2:
            raise ValueError("MeshCoder needs >= 2 devices")
        self.formulation = f
        self.mesh_devices = len(devices)
        self.members = [TorchCoder(data_shards, parity_shards, device=d,
                                   formulation=f) for d in devices]
        self.pinned_host = any(d.type == "cuda" for d in devices)
        metrics_mod.shared("ec").gauge("feed_mesh_devices",
                                       self.mesh_devices)

    # --- staging: one column slice per member ---

    def _slice_cols(self, arr: np.ndarray, i: int, cols: int,
                    device: torch.device) -> torch.Tensor:
        """Member i's [C, cols] column slice in a host buffer, the pad
        columns past the batch's width zero."""
        piece = _host_buffer(device, (arr.shape[0], cols))
        view = piece.numpy()
        lo = min(i * cols, arr.shape[1])
        hi = min(lo + cols, arr.shape[1])
        view[:, :hi - lo] = arr[:, lo:hi]
        view[:, hi - lo:] = 0
        return piece

    def _stage_cols(self, data) -> list[_Staged]:
        """Stage each member's column slice of a [C, B] batch (B padded to
        a multiple of the member count) on the member's stream; each slice
        is an ec.stage.chip span and adds to its chip's counters."""
        arr = np.asarray(data, dtype=np.uint8)
        cols = -(-arr.shape[1] // self.mesh_devices)
        ctx = observe.ensure_ctx("ec")
        reg = metrics_mod.shared("ec")
        staged = []
        for i, mb in enumerate(self.members):
            start_us = int(time.time() * 1e6)
            t0 = time.perf_counter()
            piece = self._slice_cols(arr, i, cols, mb.device)
            staged.append(mb.stage_async(piece))
            dur = time.perf_counter() - t0
            observe.record_span("ec.stage.chip", ctx, start_us,
                                int(dur * 1e6),
                                tags={"chip": i, "bytes": piece.nbytes})
            reg.count("feed_chip_staged_bytes", value=piece.nbytes,
                      labels={"chip": str(i)})
            reg.count("feed_chip_stage_seconds", value=round(dur, 6),
                      labels={"chip": str(i)})
        return staged

    def stage_async(self, data) -> _MeshStaged:
        return _MeshStaged(self._stage_cols(data))

    # --- encode: collective-free ---

    def encode_async(self, data) -> _MeshHandle:
        width = int(np.shape(data)[1])
        parts = [mb._launch(mb._w_enc, s.dev, self.m, digest=True,
                            keep=(s.host,))
                 for mb, s in zip(self.members, self._stage_cols(data))]
        return _MeshHandle(parts, width)

    def encode(self, data) -> np.ndarray:
        return self.materialize(self.encode_async(data))

    def materialize(self, handle):
        if isinstance(handle, _MeshHandle):
            out = np.concatenate(
                [mb.materialize(h) for mb, h in zip(self.members,
                                                     handle.parts)], axis=1)
            return out[:, :handle.width]
        if isinstance(handle, _MeshDigest):
            total = sum(mb.materialize(d).astype(np.uint64)
                        for mb, d in zip(self.members, handle.parts))
            return (total & 0xFFFFFFFF).astype(np.uint32)
        return np.asarray(handle)

    def row_digests(self, handle) -> Optional[np.ndarray]:
        """The members' [C + R] wrapping sums added mod 2^32: the whole
        batch's row digests (pad columns add 0)."""
        if not isinstance(handle, _MeshHandle):
            return None
        parts = [mb.row_digests(h) for mb, h in zip(self.members,
                                                     handle.parts)]
        if any(p is None for p in parts):
            return None
        total = sum(p.astype(np.uint64) for p in parts)
        return (total & 0xFFFFFFFF).astype(np.uint32)

    # --- rebuild: row-sharded survivors, all-gathered ---

    def _stage_rows(self, arr: np.ndarray, cols: int) -> list[_Staged]:
        """Row-shard [k, B] survivors over the members, rows padded to a
        multiple of the member count and columns to `cols` per member."""
        n = self.mesh_devices
        rows = -(-arr.shape[0] // n)
        staged = []
        for i, mb in enumerate(self.members):
            block = _host_buffer(mb.device, (rows, n * cols))
            view = block.numpy()
            lo = min(i * rows, arr.shape[0])
            hi = min(lo + rows, arr.shape[0])
            view[:hi - lo, :arr.shape[1]] = arr[lo:hi]
            view[hi - lo:] = 0
            view[:, arr.shape[1]:] = 0
            staged.append(mb.stage_async(block))
        return staged

    def rec_apply_async(self, present, missing):
        """Each member reconstructs its column slice of the missing rows
        with the reconstruction matrix zero-padded to [m, k], as
        TorchCoder's; the pad rows are sliced off at materialize()."""
        present, missing = tuple(present), tuple(missing)
        ws = [mb._rec_w(present, missing, rows=self.m)
              for mb in self.members]

        def run(survivors) -> _MeshHandle:
            arr = np.asarray(survivors, dtype=np.uint8)
            cols = -(-arr.shape[1] // self.mesh_devices)
            parts = gather_apply(self.members, ws,
                                 self._stage_rows(arr, cols), self.k, cols,
                                 len(missing))
            return _MeshHandle(parts, int(arr.shape[1]))

        return run

    def _rec_apply(self, present, missing):
        return self.members[0]._rec_apply(present, missing)

    # --- digest windows: each member digests its slices ---

    def _digest_window(self, dispatch, staged, acc) -> _MeshDigest:
        accs = acc.parts if acc is not None else [None] * self.mesh_devices
        return _MeshDigest([
            dispatch(mb, [s.parts[i] for s in staged], accs[i])
            for i, mb in enumerate(self.members)])

    def encode_digest_async(self, data, acc=None) -> _MeshDigest:
        return self.encode_digest_window_async([self.stage_async(data)],
                                               acc)

    def encode_digest_window_async(self, staged, acc=None) -> _MeshDigest:
        return self._digest_window(
            lambda mb, parts, a: mb.encode_digest_window_async(parts, a),
            staged, acc)

    def rec_digest_window_async(self, present, missing, staged,
                                acc=None) -> _MeshDigest:
        return self._digest_window(
            lambda mb, parts, a: mb.rec_digest_window_async(
                present, missing, parts, a), staged, acc)


def mesh_status() -> dict:
    """This process's mesh and EC-feed state for /admin/ec/mesh_status and
    the ec.mesh.status shell command: the requested mesh, the cards
    torch.cuda sees (listed only when a mesh is asked for or live: a probe
    on a server without one touches no device), and the per-chip staging
    counters and governor gauges of the shared "ec" registry."""
    reg = metrics_mod.shared("ec")
    feed = reg.snapshot(prefix="feed_")
    chips: dict[str, dict] = {}
    for key, value in sorted(feed.items()):
        if key.startswith("feed_chip_") and '{chip="' in key:
            name, _, rest = key.partition("{")
            chip = rest.split('"')[1]
            chips.setdefault(chip, {})[name[len("feed_chip_"):]] = value
    out = {
        "requested": os.environ.get("WEED_EC_MESH_DEVICES", ""),
        "mesh_devices": int(feed.get("feed_mesh_devices", 0) or 0),
        "chips": chips,
        "feed": {k: v for k, v in feed.items()
                 if not k.startswith("feed_chip_")},
    }
    if out["mesh_devices"] > 0 or out["requested"].strip():
        out["devices"] = [{"index": i,
                           "name": torch.cuda.get_device_name(i)}
                          for i in range(torch.cuda.device_count())]
        out["backend"] = "cuda" if torch.cuda.is_available() else "cpu"
    else:
        out["devices"] = None  # no mesh configured: no device probe
    return out
