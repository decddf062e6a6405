"""Wide events: one structured record per operation, in a bounded ring.

The port's reduced copy of seaweedfs_tpu/observe/wideevents.py, cut to
what the EC pipeline uses: every ``stream_encode``/``stream_rebuild``
emits one record with its per-stage times (``emit_stages``) into a
per-process ring (``WEED_WIDE_RING``, default 4096) that ``events()``
reads with filters. Not ported: the per-request accumulator, the ndjson
sink, the tail-attribution helpers and the /debug/events handler (they
come with the servers).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Optional


def _ring_size() -> int:
    try:
        size = int(os.environ.get("WEED_WIDE_RING", "4096"))
    except ValueError:
        return 4096
    return size if size > 0 else 4096


_ring: deque = deque(maxlen=_ring_size())
_ring_lock = threading.Lock()


def emit_stages(svc: str, name: str, trace: str, dur_us: int,
                totals: dict, cls: str = "bg", inst: str = "") -> dict:
    """Emit a record from pre-aggregated stage totals (observe.
    stage_totals form: name -> (count, total_us))."""
    stages = {k: int(v[1]) for k, v in totals.items()}
    ev = {
        "ts": round(time.time(), 3),
        "name": name,
        "trace": trace,
        "svc": svc,
        "inst": inst,
        "cls": cls,
        "status": 0,
        "dur_us": dur_us,
        "bytes_in": 0,
        "bytes_out": 0,
        "shed": False,
        "queue_us": stages.get("admission.wait", 0),
        "stages": stages,
    }
    with _ring_lock:
        _ring.append(ev)
    return ev


def events(trace: str = "", cls: str = "", status: int = 0,
           min_ms: float = 0.0, stage: str = "", svc: str = "",
           shed: Optional[bool] = None, limit: int = 0) -> list[dict]:
    """Filtered events, oldest first. All filters AND together; ``stage``
    matches events whose breakdown has a stage with that prefix."""
    with _ring_lock:
        out = list(_ring)
    if trace:
        out = [e for e in out if e.get("trace") == trace]
    if cls:
        out = [e for e in out if e.get("cls") == cls]
    if svc:
        out = [e for e in out if e.get("svc") == svc]
    if status:
        out = [e for e in out if e.get("status") == status]
    if min_ms > 0:
        min_us = min_ms * 1000.0
        out = [e for e in out if e.get("dur_us", 0) >= min_us]
    if stage:
        out = [e for e in out
               if any(s.startswith(stage) for s in e.get("stages", {}))]
    if shed is not None:
        out = [e for e in out if bool(e.get("shed")) == shed]
    if limit and len(out) > limit:
        out = out[-limit:]
    return out


def reset() -> None:
    """Drop all recorded events (tests)."""
    with _ring_lock:
        _ring.clear()
