"""Packed-word XOR schedules for binary (bit-plane) GF matrices.

The port's reduced copy of seaweedfs_tpu/ops/xor_schedule.py. Applying a
binary matrix over GF(2) is XOR of the selected input bit-planes, and for
a fixed matrix the XOR expression tree can be computed once, shared and
run over machine words:

1. ``build_schedule`` turns the binary matrix [R, C] into a straight-line
   program of 2-operand XORs by greedy common-subexpression elimination
   (repeatedly hoist the operand pair that co-occurs in the most rows
   into a fresh intermediate). It is the reference's algorithm, step for
   step, so both packages give the same ``ops`` and ``out_ids`` for the
   same matrix: the schedule is the kernel's program.
2. ``pack_planes`` transposes [C, n] uint8 shards into bit-plane words
   [C*8, ceil(n/32)] (32 stripe columns per word); ``run_schedule``
   executes the schedule over them and ``unpack_planes`` turns the result
   back into bytes. These three are plain PyTorch, on the tensors' device,
   and make up the plain version of the kernel (``rs_torch``).
3. Lowering is the port's own step: it turns a schedule into a program of
   (dst, a, b) slot triples in which a slot is reused once the value it
   held is dead, and a table of the output planes' slots.
   ``lower_schedule_grouped`` gives the kernel's operand
   (``csrc/gf_xorsched.cu``): the ops in groups of four independent ops,
   so that the kernel issues a group's loads before its stores, ordered to
   keep fewer values live. ``lower_schedule`` keeps the schedule's order,
   one op at a time: the baseline whose slot count the grouped lowering
   must not exceed.

Words are int32 tensors holding the reference's uint32 bit patterns:
PyTorch's uint32 arithmetic is incomplete, and the bits are the same.
"""

from __future__ import annotations

import heapq
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch


class XorSchedule(NamedTuple):
    """A straight-line XOR program over bit-plane rows.

    Value ids: ``0..n_in-1`` are the input rows; each ``ops[t]`` =
    ``(a, b)`` defines value ``n_in + t = vals[a] ^ vals[b]``. Output row
    ``r`` is value ``out_ids[r]`` (``None`` = all-zero matrix row -> zero
    output). ``dense_xors`` is the popcount bound the greedy CSE is
    measured against; ``sched_xors == len(ops)``.
    """

    n_in: int
    n_rows: int
    ops: tuple
    out_ids: tuple
    dense_xors: int
    sched_xors: int


def build_schedule(w: np.ndarray) -> XorSchedule:
    """Greedy shared-pair CSE schedule for a binary matrix [R, C].

    Each iteration counts, for every pair of live value ids, how many
    rows contain both (one float32 product on the 0/1 membership matrix),
    hoists the most-shared pair into a new intermediate and substitutes
    it. When no pair is shared by >= 2 rows, the remaining per-row operand
    sets fold into left-to-right XOR chains.
    """
    w = np.asarray(w)
    if w.ndim != 2:
        raise ValueError(f"want a 2-D binary matrix, got shape {w.shape}")
    n_rows, n_in = w.shape
    m = (w != 0)  # [rows, value ids], grows a column per intermediate
    dense = int(sum(max(int(row.sum()) - 1, 0) for row in m))
    ops: list[tuple[int, int]] = []
    while True:
        mf = m.astype(np.float32)
        co = mf.T @ mf  # co[a, b] = rows containing both a and b
        np.fill_diagonal(co, 0.0)
        if co.size == 0 or co.max() < 2.0:
            break
        a, b = np.unravel_index(int(np.argmax(co)), co.shape)
        a, b = int(min(a, b)), int(max(a, b))
        both = m[:, a] & m[:, b]
        new_col = np.zeros((n_rows, 1), dtype=bool)
        new_col[both, 0] = True
        m[both, a] = False
        m[both, b] = False
        m = np.hstack([m, new_col])
        ops.append((a, b))
    next_id = m.shape[1]
    out_ids: list[Optional[int]] = []
    for r in range(n_rows):
        idx = np.nonzero(m[r])[0].tolist()
        if not idx:
            out_ids.append(None)
        elif len(idx) == 1:
            out_ids.append(int(idx[0]))
        else:
            cur = int(idx[0])
            for x in idx[1:]:
                ops.append((cur, int(x)))
                cur = next_id
                next_id += 1
            out_ids.append(cur)
    return XorSchedule(n_in=n_in, n_rows=n_rows, ops=tuple(ops),
                       out_ids=tuple(out_ids), dense_xors=dense,
                       sched_xors=len(ops))


_cache: dict = {}
_cache_lock = threading.Lock()
_CACHE_MAX = 128


def schedule_for_matrix(matrix: np.ndarray) -> XorSchedule:
    """The (cached) schedule for a GF(2^8) coefficient matrix [R, C],
    built from its expanded binary form (``rs_torch.bitplane_matrix``):
    n_in = C*8 input bit-plane rows, n_rows = R*8 output bit-plane rows.
    Threads asking for the same matrix at once build it once."""
    from .rs_torch import bitplane_matrix  # rs_torch imports us back
    m = np.asarray(matrix, dtype=np.uint8)
    key = (m.tobytes(), m.shape)
    with _cache_lock:
        sched = _cache.get(key)
        if sched is None:
            sched = build_schedule(bitplane_matrix(m))
            if len(_cache) >= _CACHE_MAX:
                _cache.pop(next(iter(_cache)))
            _cache[key] = sched
    return sched


def apply_schedule_numpy(sched: XorSchedule, bits: np.ndarray) -> np.ndarray:
    """Dense-domain executor: bits [n_in, n] 0/1 -> [n_rows, n]."""
    bits = np.asarray(bits, dtype=np.uint8)
    vals = [bits[i] for i in range(sched.n_in)]
    for a, b in sched.ops:
        vals.append(vals[a] ^ vals[b])
    zero = np.zeros(bits.shape[1], dtype=np.uint8)
    return np.stack([vals[i] if i is not None else zero
                     for i in sched.out_ids])


def packed_width(n: int) -> int:
    """32-bit words per bit-plane row for an n-column stripe batch."""
    return (n + 31) // 32


def pack_planes(x: torch.Tensor) -> torch.Tensor:
    """[C, n] uint8 shards -> [C*8, ceil(n/32)] int32 bit-plane words.

    Row c*8+j holds bit j of shard row c; bit b of word q is stripe
    column q*32+b. The tail word is zero-padded. Built one bit position at
    a time, so no temporary is larger than the input's words."""
    c, n = x.shape
    nw = packed_width(n)
    xp = torch.zeros((c, nw * 32), dtype=torch.uint8, device=x.device)
    xp[:, :n] = x
    cols = xp.view(c, nw, 32)
    shifts = torch.arange(8, dtype=torch.int32, device=x.device)
    planes = torch.zeros((c * 8, nw), dtype=torch.int32, device=x.device)
    for b in range(32):
        col = cols[:, :, b].to(torch.int32)                  # [C, nw]
        bits = (col[:, None, :] >> shifts[None, :, None]) & 1  # [C, 8, nw]
        planes |= bits.reshape(c * 8, nw) << b
    return planes


def unpack_planes(p: torch.Tensor, n: int) -> torch.Tensor:
    """[R*8, nw] int32 bit-plane words -> [R, n] uint8 (pack_planes'
    inverse)."""
    r8, nw = p.shape
    rows = r8 // 8
    shifts = torch.arange(8, dtype=torch.int32, device=p.device)
    out = torch.empty((rows, nw, 32), dtype=torch.uint8, device=p.device)
    for b in range(32):
        bits = ((p >> b) & 1).reshape(rows, 8, nw)
        out[:, :, b] = (bits << shifts[None, :, None]).sum(
            dim=1).to(torch.uint8)
    return out.reshape(rows, nw * 32)[:, :n]


def run_schedule(sched: XorSchedule, planes: torch.Tensor) -> torch.Tensor:
    """Execute the schedule over packed rows: [n_in, nw] -> [n_rows, nw].
    Every value stays alive, as in the reference."""
    vals = [planes[i] for i in range(sched.n_in)]
    for a, b in sched.ops:
        vals.append(vals[a] ^ vals[b])
    zero = torch.zeros_like(planes[0])
    return torch.stack([vals[i] if i is not None else zero
                        for i in sched.out_ids])


class XorProgram(NamedTuple):
    """A schedule lowered to slot triples (the kernel's operand when
    ``group`` is 4).

    ``code`` int16 [n_ops, 3]: op t sets slot ``code[t, 0]`` to the XOR of
    slots ``code[t, 1]`` and ``code[t, 2]``. Before the first op, slot
    ``i < n_in`` holds input plane i; ``out_slots`` int16 [n_rows] names
    the slot that holds output plane r at the end, -1 for a zero row.
    ``n_slots`` is how many slots the program touches. The ops run in
    consecutive groups of ``group``: a group reads all its operands, then
    writes all its results (``group == 1`` is one op at a time).
    """

    sched: XorSchedule
    code: torch.Tensor
    out_slots: torch.Tensor
    n_slots: int
    group: int = 1

    def to(self, device: torch.device | str) -> "XorProgram":
        return self._replace(code=self.code.to(device),
                             out_slots=self.out_slots.to(device))


def lower_schedule(sched: XorSchedule) -> XorProgram:
    """Assign each value of the schedule a slot, reusing the slots of dead
    values (the reference keeps every value alive; on the card each live
    value is one 32-bit shared-memory word per thread, so the slot count
    sets how many threads a block can hold).

    A value dies after its last use as an operand unless an output names
    it; an op's operands are freed before its result is placed, so the
    result may overwrite one of them (the kernel reads both first). The
    free slot with the lowest index is taken first."""
    n_vals = sched.n_in + len(sched.ops)
    last_use = [-1] * n_vals
    for t, (a, b) in enumerate(sched.ops):
        last_use[a] = t
        last_use[b] = t
    keep = {v for v in sched.out_ids if v is not None}
    slot_of = list(range(sched.n_in)) + [-1] * len(sched.ops)
    free: list[int] = []
    for v in range(sched.n_in):
        if last_use[v] < 0 and v not in keep:
            heapq.heappush(free, v)  # input that nothing reads
    n_slots = sched.n_in
    code = np.empty((len(sched.ops), 3), dtype=np.int16)
    for t, (a, b) in enumerate(sched.ops):
        for v in {a, b}:
            if last_use[v] == t and v not in keep:
                heapq.heappush(free, slot_of[v])
        if free:
            dst = heapq.heappop(free)
        else:
            dst = n_slots
            n_slots += 1
        slot_of[sched.n_in + t] = dst
        code[t] = (dst, slot_of[a], slot_of[b])
    if n_slots > np.iinfo(np.int16).max:
        raise ValueError(f"schedule needs {n_slots} slots, more than int16")
    out_slots = np.array([slot_of[v] if v is not None else -1
                          for v in sched.out_ids], dtype=np.int16)
    return XorProgram(sched=sched, code=torch.from_numpy(code),
                      out_slots=torch.from_numpy(out_slots),
                      n_slots=n_slots)


def lower_schedule_grouped(sched: XorSchedule, group: int = 4) -> XorProgram:
    """Lower a schedule into groups of `group` independent ops, ordered to
    keep few values live.

    Each group is chosen greedily from the ops whose operands are ready:
    first those after which the most operands are dead, then the
    schedule's own order. Within a group no op reads a slot that another
    op of the group writes and no two ops write one slot, so the kernel may
    issue all of a group's loads before its stores. An op's result takes
    the slot of an operand that dies with it and that no other op of the
    group reads; other slots of values dead in a group are free from the
    next group on. A short group is padded with no-ops, each XORing a free
    slot into itself (a new slot only when too few are free)."""
    n_in, ops = sched.n_in, sched.ops
    keep = {v for v in sched.out_ids if v is not None}
    uses = [0] * (n_in + len(ops))  # reads by ops not yet placed
    readers: list[list[int]] = [[] for _ in range(n_in + len(ops))]
    for t, (a, b) in enumerate(ops):
        for v in (a, b):
            uses[v] += 1
            readers[v].append(t)
    waiting = [sum(1 for v in (a, b) if v >= n_in) for a, b in ops]
    ready = {t for t in range(len(ops)) if waiting[t] == 0}
    slot_of = list(range(n_in)) + [-1] * len(ops)
    free = [v for v in range(n_in) if uses[v] == 0 and v not in keep]
    heapq.heapify(free)
    n_slots = n_in
    code: list[tuple[int, int, int]] = []

    def dies_with(t: int) -> int:
        a, b = ops[t]
        return sum(1 for v in {a, b}
                   if v not in keep and uses[v] == (a == v) + (b == v))

    while ready:
        chosen = sorted(ready, key=lambda t: (-dies_with(t), t))[:group]
        reads: dict[int, int] = {}
        for t in chosen:
            for v in ops[t]:
                reads[v] = reads.get(v, 0) + 1
        dying = {v for v, c in reads.items()
                 if v not in keep and uses[v] == c}
        claimed: set[int] = set()
        for t in chosen:
            a, b = ops[t]
            dst = -1
            for v in (a, b):
                if (v in dying and v not in claimed
                        and reads[v] == (a == v) + (b == v)):
                    dst = slot_of[v]
                    claimed.add(v)
                    break
            if dst < 0:
                if free:
                    dst = heapq.heappop(free)
                else:
                    dst = n_slots
                    n_slots += 1
            slot_of[n_in + t] = dst
            code.append((dst, slot_of[a], slot_of[b]))
        # a short group's no-ops each XOR a dead slot into itself: slots
        # free before this group, which none of its ops touches
        spare = heapq.nsmallest(group - len(chosen), free)
        while len(spare) < group - len(chosen):
            spare.append(n_slots)
            n_slots += 1
        code.extend((d, d, d) for d in spare)
        for d in spare:
            if d not in free:
                heapq.heappush(free, d)
        for v in dying - claimed:
            heapq.heappush(free, slot_of[v])
        for t in chosen:
            ready.discard(t)
            for v in ops[t]:
                uses[v] -= 1
            for r in readers[n_in + t]:
                waiting[r] -= 1
                if waiting[r] == 0:
                    ready.add(r)
    arr = np.array(code, dtype=np.int64).reshape(-1, 3)
    if n_slots > np.iinfo(np.int16).max:
        raise ValueError(f"schedule needs {n_slots} slots, more than int16")
    out_slots = np.array([slot_of[v] if v is not None else -1
                          for v in sched.out_ids], dtype=np.int16)
    return XorProgram(sched=sched,
                      code=torch.from_numpy(arr.astype(np.int16)),
                      out_slots=torch.from_numpy(out_slots),
                      n_slots=n_slots, group=group)

