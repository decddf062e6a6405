"""The batched multi-device EC kernel surface, on PyTorch.

The port's counterpart of seaweedfs_tpu/parallel/sharded.py: [B, k, n]
stripe batches spread over a mesh of devices, each member running the
hand-written kernel on its share.

- ``sharded_encode``: the batch axis B splits over the members; each
  folds its local batches into one [k, b * n] stripe and launches the
  formulation's kernel once (no collective).
- ``sharded_rebuild``: the k survivor rows are row-sharded over the
  members (padded to the member count), all-gathered so every member
  holds the k rows, and each member reconstructs its slice of the column
  space.

A mesh (``make_mesh``) is a list of ``torch.device``; a device may
repeat. Each device runs its kernel on a CUDA card and the kernel's plain
version on the CPU. The production plane drives the same work through
``MeshCoder`` (mesh_coder.py).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..ec.coder import TorchCoder
from .mesh_coder import card_devices, gather_apply


@dataclass(frozen=True)
class Mesh:
    """The members of a mesh, in order."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over `devices` (explicit, may repeat one), else the first
    `n_devices` cards (default: every card)."""
    if devices is None:
        have = torch.cuda.device_count()
        n = n_devices or have
        if have < n or n < 1:
            raise ValueError(f"need {n} cards, have {have}")
        devices = card_devices(n)
    return Mesh(tuple(torch.device(d) for d in devices))


@functools.lru_cache(maxsize=32)
def _members(k: int, m: int, mesh: Mesh,
             formulation: str) -> tuple[TorchCoder, ...]:
    """One coder per member (own stream, operands on its device), made
    once per (geometry, mesh, formulation); the cache is the registry,
    bounded and evicted least recently used."""
    return tuple(TorchCoder(k, m, device=d, formulation=formulation)
                 for d in mesh.devices)


def sharded_encode(mesh: Mesh, data, parity_shards: int = 4,
                   formulation: str = "bitplane") -> np.ndarray:
    """data [B, k, n] uint8 (B divisible by the mesh size) -> parity
    [B, m, n]; each member encodes its B / size batches as one [k, b * n]
    stripe."""
    data = np.asarray(data, dtype=np.uint8)
    b, k, n = data.shape
    if b % mesh.size:
        raise ValueError(f"batch {b} does not divide over {mesh.size} "
                         "members")
    members = _members(k, parity_shards, mesh, formulation)
    local = b // mesh.size
    handles = []
    for i, mb in enumerate(members):
        part = data[i * local:(i + 1) * local]
        flat = np.ascontiguousarray(part.transpose(1, 0, 2)).reshape(
            k, local * n)
        handles.append(mb._run(mb._w_enc, flat, parity_shards))
    out = [mb.materialize(h).reshape(parity_shards, local, n)
           .transpose(1, 0, 2) for mb, h in zip(members, handles)]
    return np.concatenate(out, axis=0)


def sharded_rebuild(mesh: Mesh, shards: list, k: int, m: int,
                    formulation: str = "bitplane") -> list:
    """Rebuild the missing (None) shards with the survivors spread over
    the mesh: rows padded to the mesh size and row-sharded, all-gathered,
    and each member computes the missing rows of its column slice."""
    present = tuple(i for i, s in enumerate(shards) if s is not None)
    missing = tuple(i for i, s in enumerate(shards) if s is None)
    if len(present) < k:
        raise ValueError("too few shards")
    basis = present[:k]
    survivors = np.stack([np.asarray(shards[i], dtype=np.uint8)
                          for i in basis])
    n = survivors.shape[1]
    size = mesh.size
    rows = -(-k // size)
    cols = -(-n // size)  # each member rebuilds an equal column slice
    padded = np.zeros((rows * size, cols * size), dtype=np.uint8)
    padded[:k, :n] = survivors
    members = _members(k, m, mesh, formulation)
    blocks = [mb.stage_async(padded[i * rows:(i + 1) * rows])
              for i, mb in enumerate(members)]
    handles = gather_apply(members, [mb._rec_w(basis, missing)
                                     for mb in members], blocks, k, cols,
                           len(missing))
    rebuilt = np.concatenate([mb.materialize(h)
                              for mb, h in zip(members, handles)],
                             axis=1)[:, :n]
    result = list(shards)
    for row, tgt in enumerate(missing):
        result[tgt] = rebuilt[row]
    return result
