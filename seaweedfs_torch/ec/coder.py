"""The ErasureCoder interface and its backends, on PyTorch.

The port's counterpart of seaweedfs_tpu/ec/coder.py:

- ``NumpyCoder`` -- the numpy reference (table lookups, slow);
- ``TorchCoder`` -- the hand-written CUDA kernels (``ops/rs_cuda``) on a
  card, the counterpart of the reference's ``PallasCoder``; constructed
  with ``device="cpu"`` the same class runs the kernels' plain versions,
  which is the only place a plain version serves a coder.

``TorchCoder``'s formulation picks the kernel, as ``PallasCoder``'s does:
``"bitplane"`` (``rs_cuda.gf_apply``, the bit-plane matrix as operand) or
``"xorsched"`` (``rs_cuda.gf_apply_xorsched``, the matrix's lowered XOR
schedule as operand). Unset, it follows the ``WEED_EC_FORMULATION`` pin:
xorsched when the pin says so, bitplane otherwise; an unknown pin raises.

``get_coder("auto", k, m)`` returns the CUDA ``TorchCoder`` and raises
where there is no card: it never falls back to the CPU. ``"mesh"`` is the
multi-card coder's factory (``parallel.mesh_coder.coder``): a
``MeshCoder`` over several cards, the single-card ``TorchCoder`` on one;
it raises without a card too. All backends and formulations produce
bit-identical shards.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..ops import gf256, rs_cuda, rs_torch, xor_schedule

# fn(survivors [k, n] uint8) -> rebuilt rows [len(missing), n] uint8
ApplyFn = Callable[[np.ndarray], np.ndarray]


class ErasureCoder:
    """Encode/reconstruct fixed-width stripes of k data + m parity shards."""

    # whether the pipeline should stage batches in page-locked memory
    pinned_host = False

    def __init__(self, data_shards: int, parity_shards: int):
        self.k = data_shards
        self.m = parity_shards

    def encode(self, data: np.ndarray) -> np.ndarray:
        """data [k, n] uint8 -> parity [m, n] uint8."""
        raise NotImplementedError

    def _rec_apply(self, present: tuple, missing: tuple) -> ApplyFn:
        """Backend hook: build the survivors -> missing transform."""
        raise NotImplementedError

    # --- async pipeline hooks (ec/pipeline.py) ---
    # CPU backends compute synchronously; the pipeline still overlaps
    # their compute with disk reads and writes on its worker threads.

    def encode_async(self, data: np.ndarray):
        """Dispatch an encode; returns a handle for materialize()."""
        return self.encode(data)

    def rec_apply_async(self, present: tuple, missing: tuple) -> ApplyFn:
        """Like _rec_apply, but the returned fn may defer computation."""
        return self._rec_apply(present, missing)

    def materialize(self, handle) -> np.ndarray:
        """Block until a handle from encode_async/rec_apply_async is real."""
        return np.asarray(handle)

    def row_digests(self, handle) -> Optional[np.ndarray]:
        """The wrapping uint32 byte sums of a materialized encode handle's
        k data rows and m parity rows, where the backend computed them
        with the parity; None where it did not (the caller sums the rows
        itself)."""
        return None

    def reconstruct(self, shards: Sequence[Optional[np.ndarray]],
                    data_only: bool = False,
                    targets: Optional[Sequence[int]] = None
                    ) -> list[Optional[np.ndarray]]:
        """Fill missing (None) entries from any k survivors.

        targets: rebuild only these shard ids (all must be absent); by
        default every absent shard is rebuilt (data shards only with
        data_only=True), as upstream's Reconstruct/ReconstructData split.
        """
        total = self.k + self.m
        if len(shards) != total:
            raise ValueError(f"want {total} shards, got {len(shards)}")
        present = tuple(i for i, s in enumerate(shards) if s is not None)
        if targets is not None:
            missing = tuple(targets)
            if any(shards[i] is not None for i in missing):
                raise ValueError(f"targets {missing} are not all absent")
        else:
            missing = tuple(i for i, s in enumerate(shards) if s is None
                            and (not data_only or i < self.k))
        if not missing:
            return list(shards)
        if len(present) < self.k:
            raise ValueError("too few shards to reconstruct")
        survivors = np.stack([np.asarray(shards[i], dtype=np.uint8)
                              for i in present[:self.k]])
        rebuilt = np.asarray(
            self._rec_apply(present[:self.k], missing)(survivors))
        out = list(shards)
        for row, tgt in enumerate(missing):
            out[tgt] = rebuilt[row]
        return out

    def verify(self, shards: Sequence[np.ndarray]) -> bool:
        data = np.stack(shards[:self.k])
        parity = np.stack(shards[self.k:])
        return bool(np.array_equal(self.encode(data), parity))

    # --- staged-window hooks (pipeline.stream_*_device_sink) ---
    # The sinks separate moving bytes (stage_async) from running kernels
    # (one *_window_async call per staged window) and keep only a per-row
    # digest of the result: the wrapping uint32 byte sum of each output
    # row, summed over the batches.

    def stage_async(self, data: np.ndarray):
        """Move one batch toward the device without running any kernel.
        CPU backends return the array unchanged."""
        return np.asarray(data, dtype=np.uint8)

    def encode_digest_async(self, data: np.ndarray, acc=None):
        """Encode one batch and fold its parity digest ([m] uint32 per-row
        wrapping byte sums) into `acc`; materialize() makes it real."""
        d = np.sum(self.encode(data), axis=1, dtype=np.uint32)
        return d if acc is None else np.asarray(acc, np.uint32) + d

    def encode_digest_window_async(self, staged: Sequence, acc=None):
        """Digest a whole staged window (batches of one shape)."""
        for b in staged:
            acc = self.encode_digest_async(b, acc)
        return acc

    def rec_digest_window_async(self, present: tuple, missing: tuple,
                                staged: Sequence, acc=None):
        """Like encode_digest_window_async, but digesting reconstructed
        shards: staged batches are [k, n] survivor stripes and the digest
        has len(missing) rows, in the caller's order of `missing`."""
        apply_fn = self._rec_apply(present, missing)
        for b in staged:
            rebuilt = np.asarray(apply_fn(np.asarray(b, dtype=np.uint8)))
            d = np.sum(rebuilt, axis=1, dtype=np.uint32)
            acc = d if acc is None else np.asarray(acc, np.uint32) + d
        return acc


class NumpyCoder(ErasureCoder):
    def encode(self, data: np.ndarray) -> np.ndarray:
        return gf256.encode_parity(np.asarray(data, dtype=np.uint8), self.m)

    def _rec_apply(self, present, missing):
        rec = gf256.reconstruction_matrix(self.k, self.m, present, missing)
        return lambda survivors: gf256.gf_matrix_apply(rec, survivors)


class _Pending:
    """An enqueued kernel run: the D2H copy lands in `host` (page-locked)
    once `event` completes; `rows` of it are real (the rest is padding).
    `digest`, when the run carried the digest epilogue, is the digest
    buffer's copy beside it, cut to the C input and `rows` output sums.
    Device tensors stay referenced until then. On the CPU `event` is None
    and everything is already real."""

    __slots__ = ("event", "host", "rows", "keep", "digest")

    def __init__(self, event, host: torch.Tensor, rows: int, keep: tuple,
                 digest: Optional[torch.Tensor] = None):
        self.event = event
        self.host = host
        self.rows = rows
        self.keep = keep
        self.digest = digest


class _Staged:
    """A batch whose H2D copy is enqueued on the coder's stream; `host`
    pins the source until block_until_ready() has seen the copy done."""

    __slots__ = ("dev", "host", "event")

    def __init__(self, dev: torch.Tensor, host, event):
        self.dev = dev
        self.host = host
        self.event = event

    def block_until_ready(self) -> "_Staged":
        if self.event is not None:
            self.event.synchronize()
        self.host = None
        return self


class _Digest:
    """A running digest buffer (``rs_cuda.new_digest``: [C + R] int32
    holding the kernels' wrapping uint32 sums, on the coder's device):
    real once `event` (recorded after the last kernel that feeds it) is
    done. Its first `skip` entries are the input rows' sums;
    materialize() returns the R output rows' as uint32."""

    __slots__ = ("acc", "event", "skip")

    def __init__(self, acc: torch.Tensor, event, skip: int):
        self.acc = acc
        self.event = event
        self.skip = skip


class TorchCoder(ErasureCoder):
    """GF(2^8) through the hand-written kernels on one device.

    On a card every kernel run is enqueued on the coder's own CUDA
    stream: the host batch is copied H2D (asynchronously when it is
    page-locked, as the pipeline's staging buffers are), the kernel runs
    with its matrix operand, and the result is copied D2H into a fresh
    page-locked tensor, after which an event is recorded. materialize()
    waits for that event and hands out a numpy view of the host tensor;
    the view keeps the tensor alive while writer threads hold its rows,
    and PyTorch's page-locked allocator reuses its memory only after the
    recorded copy is done. Every matrix is runtime data (the bit-plane
    matrix W, or the lowered XOR program), made once per matrix, kept on
    the device and cached under a lock (degraded reads come from many
    threads), so no failure pattern compiles anything.

    Encode runs carry the kernels' digest epilogue: the handle also
    brings back the data and parity rows' byte sums, which
    ``row_digests`` hands the pipeline for the .ecm, so no pass over the
    rows runs on the host. Reconstruction runs skip the epilogue.

    The staged-window hooks keep the batches and the digests on the
    device: stage_async enqueues the H2D copy only, the window calls
    enqueue one digest-only launch per batch (no output stores), all
    adding into one uint32 digest buffer, and only that buffer crosses
    back.

    Not ported from ``PallasCoder``: ``_shrink_tile`` and its retry
    loops (they retry after any exception, which would hide a kernel that
    fails) and the AOT ``warm_*`` hooks (nothing compiles per shape here).
    """

    def __init__(self, data_shards: int, parity_shards: int,
                 device: str | torch.device = "cuda",
                 formulation: str | None = None):
        super().__init__(data_shards, parity_shards)
        # as PallasCoder: lut has no kernel of its own, so any pin other
        # than xorsched keeps the bitplane kernel; a bad pin raises
        env = rs_torch.formulation_env()
        self.formulation = formulation or (
            "xorsched" if env == "xorsched" else "bitplane")
        if self.formulation not in ("bitplane", "xorsched"):
            raise ValueError(f"TorchCoder: unknown formulation "
                             f"{self.formulation!r}")
        self._kernel = (rs_cuda.gf_apply_xorsched
                        if self.formulation == "xorsched"
                        else rs_cuda.gf_apply)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("TorchCoder: no CUDA device")
            self._stream = torch.cuda.Stream(self.device)
        elif self.device.type == "cpu":
            self._stream = None
        else:
            raise ValueError(f"TorchCoder: unsupported device {device}")
        self.pinned_host = self.device.type == "cuda"
        self._w_enc = self._operand(
            gf256.parity_matrix(data_shards, parity_shards))
        self._w_rec: dict = {}
        self._w_lock = threading.Lock()

    def _operand(self, matrix: np.ndarray, rows: Optional[int] = None):
        """The kernel's operand for a coefficient matrix, on the device;
        rows > R zero-pads (zero rows rebuild zeros)."""
        if self.formulation == "bitplane":
            return rs_torch.load_matrix(matrix, self.device, rows=rows)
        return xor_schedule.lower_schedule_grouped(
            xor_schedule.schedule_for_matrix(rs_torch.pad_rows(matrix, rows))
        ).to(self.device)

    def _rec_w(self, present: tuple, missing: tuple,
               rows: Optional[int] = None):
        key = (present, missing, rows)
        with self._w_lock:
            w = self._w_rec.get(key)
            if w is None:
                rec = gf256.reconstruction_matrix(self.k, self.m, present,
                                                  missing)
                w = self._w_rec[key] = self._operand(rec, rows)
        return w

    @staticmethod
    def _digest_size(w) -> int:
        """C + R of an operand (padding rows included): the length of its
        digest buffer."""
        if isinstance(w, xor_schedule.XorProgram):
            return (w.sched.n_in + w.sched.n_rows) // 8
        return (w.shape[0] + w.shape[1]) // 8

    def _run(self, w, data, rows: int, digest: bool = False):
        """Enqueue the operand applied to host bytes [C, n] (an array, or
        a CPU tensor), with the digest epilogue when asked; returns a
        handle."""
        staged = self.stage_async(data)
        return self._launch(w, staged.dev, rows, digest, keep=(staged.host,))

    def _launch(self, w, xd: torch.Tensor, rows: int, digest: bool = False,
                keep: tuple = ()) -> _Pending:
        """Enqueue the operand applied to xd [C, n] on the coder's device
        (written on the coder's stream), then the copy back; `keep` holds
        whatever must outlive the enqueued work."""
        size = self._digest_size(w)
        if self._stream is None:
            d = rs_cuda.new_digest(size, "cpu") if digest else None
            out = self._kernel(w, xd, digest=d)
            return _Pending(None, out, rows, (),
                            None if d is None else d[:xd.shape[0] + rows])
        with torch.cuda.stream(self._stream):
            dd = rs_cuda.new_digest(size, self.device) if digest else None
            out = self._kernel(w, xd, digest=dd)
            host = torch.empty(out.shape, dtype=torch.uint8,
                               pin_memory=True)
            host.copy_(out, non_blocking=True)
            dh = None
            if digest:
                dh = torch.empty(size, dtype=torch.int32, pin_memory=True)
                dh.copy_(dd, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        # the host batch must outlive the async H2D copy; the digest's
        # view drops the padding rows' sums
        return _Pending(event, host, rows, keep + (xd, out, dd),
                        None if dh is None else dh[:xd.shape[0] + rows])

    def materialize(self, handle) -> np.ndarray:
        if isinstance(handle, _Pending):
            if handle.event is not None:
                handle.event.synchronize()
            return handle.host[:handle.rows].numpy()
        if isinstance(handle, _Digest):
            if handle.event is not None:
                handle.event.synchronize()
            return rs_cuda.digest_values(
                handle.acc[handle.skip:].cpu()).numpy().astype(np.uint32)
        return handle.numpy()

    def row_digests(self, handle) -> Optional[np.ndarray]:
        """The input rows' and the first `rows` output rows' byte sums
        ([C + rows] uint32) of a materialized handle that carried the
        digest epilogue (every encode_async handle does); None for one
        that did not."""
        if not isinstance(handle, _Pending) or handle.digest is None:
            return None
        if handle.event is not None:
            handle.event.synchronize()
        return rs_cuda.digest_values(handle.digest).numpy().astype(np.uint32)

    def encode_async(self, data: np.ndarray):
        return self._run(self._w_enc, data, self.m, digest=True)

    def encode(self, data: np.ndarray) -> np.ndarray:
        return self.materialize(self.encode_async(data))

    def rec_apply_async(self, present, missing):
        """The reconstruction matrix zero-padded to the parity matrix's
        [m, k] shape; the pad rows are sliced off at materialize()."""
        w = self._rec_w(tuple(present), tuple(missing), rows=self.m)
        return lambda survivors: self._run(w, survivors, len(missing))

    def _rec_apply(self, present, missing):
        # synchronous reconstruction (degraded reads): the exact matrix,
        # so a one-shard interval runs the kernel with R = 1
        w = self._rec_w(tuple(present), tuple(missing))
        return lambda survivors: self.materialize(
            self._run(w, survivors, len(missing)))

    # --- staged-window hooks ---

    def stage_async(self, data) -> _Staged:
        """Enqueue the batch's H2D copy on the coder's stream (an array,
        or a CPU tensor: a page-locked one copies asynchronously); no
        kernel runs. On the CPU the batch is wrapped as it is."""
        x = (data.contiguous() if isinstance(data, torch.Tensor) else
             torch.from_numpy(np.ascontiguousarray(data, dtype=np.uint8)))
        if self._stream is None:
            return _Staged(x, None, None)
        with torch.cuda.stream(self._stream):
            xd = x.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return _Staged(xd, x, event)

    def _digest_window(self, w, staged: Sequence,
                       acc: Optional[_Digest]) -> _Digest:
        """acc + the per-row byte sums of the operand applied to every
        staged batch: one digest-only launch per batch, all adding into
        one digest buffer, enqueued on the coder's stream."""
        on_card = self._stream is not None
        with (torch.cuda.stream(self._stream) if on_card
              else contextlib.nullcontext()):
            if acc is None:
                acc = _Digest(rs_cuda.new_digest(self._digest_size(w),
                                                 self.device), None, self.k)
            for b in staged:
                self._kernel(w, b.dev, digest=acc.acc, out=False)
            event = torch.cuda.Event() if on_card else None
            if on_card:
                event.record(self._stream)
        return _Digest(acc.acc, event, acc.skip)

    def encode_digest_async(self, data: np.ndarray, acc=None) -> _Digest:
        return self.encode_digest_window_async([self.stage_async(data)],
                                               acc)

    def encode_digest_window_async(self, staged, acc=None) -> _Digest:
        return self._digest_window(self._w_enc, staged, acc)

    def rec_digest_window_async(self, present, missing, staged,
                                acc=None) -> _Digest:
        # the exact matrix: one digest row per victim, in the caller's
        # order of `missing`
        w = self._rec_w(tuple(present), tuple(missing))
        return self._digest_window(w, staged, acc)


_REGISTRY: dict = {}


def register_coder(name: str, factory) -> None:
    _REGISTRY[name] = factory


def _mesh_factory(data_shards: int, parity_shards: int,
                  device: "str | torch.device | None" = None
                  ) -> ErasureCoder:
    """The mesh-or-single factory (parallel/mesh_coder.py): a MeshCoder
    over the cards WEED_EC_MESH_DEVICES asks for (default: every card),
    the single-card TorchCoder on a one-card host; it raises without a
    card. Imported lazily, as the reference does."""
    if device is not None and torch.device(device).type != "cuda":
        raise ValueError(f"get_coder('mesh'): {device} is not a card")
    from ..parallel import mesh_coder
    return mesh_coder.coder(data_shards, parity_shards)


register_coder("numpy", NumpyCoder)
register_coder("torch", TorchCoder)
register_coder("mesh", _mesh_factory)


def get_coder(name: str, data_shards: int, parity_shards: int,
              device: "str | torch.device | None" = None) -> ErasureCoder:
    """A coder by name. "auto" is the CUDA kernel coder, its formulation
    from WEED_EC_FORMULATION; it raises where there is no card. `device`
    goes to the "torch" coder (a card, or "cpu" for the kernels' plain
    versions); "auto" takes only a card."""
    if name == "auto":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "get_coder('auto'): no CUDA device (the port does not fall "
                "back to the CPU; ask for 'numpy' or "
                "TorchCoder(device='cpu') explicitly)")
        if device is not None and torch.device(device).type != "cuda":
            raise ValueError(f"get_coder('auto'): {device} is not a card")
        name = "torch"
    if name not in _REGISTRY:
        raise KeyError(f"unknown coder {name!r}; have {sorted(_REGISTRY)}")
    if device is None:
        return _REGISTRY[name](data_shards, parity_shards)
    return _REGISTRY[name](data_shards, parity_shards, device=device)
