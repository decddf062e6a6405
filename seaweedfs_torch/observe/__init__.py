"""Tracing: spans in a bounded ring, captured contexts, Chrome-trace export.

The port's reduced copy of seaweedfs_tpu/observe/__init__.py. Every
process keeps a bounded ring of completed spans (``WEED_TRACE_RING``,
default 4096). The EC pipeline records one span per stage and batch
(``ec.read``, ``ec.dispatch``, ``ec.kernel``, ``ec.digest``,
``ec.write``, ``ec.dispatch_window``) against an explicit captured
context, and the feed governor folds ``stage_totals`` of a run's trace
back into its model (ec/governor.py). ``to_chrome_trace`` turns spans
into a Chrome trace-event document (Perfetto, chrome://tracing).

Spans are contextvars-based; worker threads do not inherit context, so
code captures it (``capture``/``ensure_ctx``) and re-enters it in the
thread with ``bind``/``run_with``. Not ported: the HTTP/gRPC header
propagation, the aiohttp middleware and the /debug/trace handler (they
come with the servers).
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import os
import random
import threading
import time
from collections import deque
from typing import Iterable, NamedTuple, Optional

_log = logging.getLogger(__name__)


def _ring_size() -> int:
    """A malformed or negative WEED_TRACE_RING falls back to 4096."""
    try:
        size = int(os.environ.get("WEED_TRACE_RING", "4096"))
    except ValueError:
        return 4096
    return size if size > 0 else 4096


RING_SIZE = _ring_size()

_trace_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "sw_trace_id", default="")
_span_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "sw_span_id", default="")
_service: contextvars.ContextVar[str] = contextvars.ContextVar(
    "sw_service", default="")
_instance: contextvars.ContextVar[str] = contextvars.ContextVar(
    "sw_instance", default="")

_ring: deque = deque(maxlen=RING_SIZE)
_ring_lock = threading.Lock()


def slow_threshold_ms() -> float:
    """Root spans slower than this log a warning (WEED_TRACE_SLOW_MS)."""
    try:
        return float(os.environ.get("WEED_TRACE_SLOW_MS", "1000"))
    except ValueError:
        return 1000.0


# ids only need uniqueness: a SystemRandom-seeded PRNG is much cheaper
# per id than os.urandom
_id_rng = random.Random(random.SystemRandom().getrandbits(64))
_id_lock = threading.Lock()


def new_id() -> str:
    with _id_lock:
        return f"{_id_rng.getrandbits(64):016x}"


class TraceCtx(NamedTuple):
    """A captured trace position, safe to hand across threads."""
    trace_id: str
    span_id: str
    service: str
    instance: str


def capture() -> TraceCtx:
    """Snapshot the ambient trace context (for worker threads)."""
    return TraceCtx(_trace_id.get(), _span_id.get(),
                    _service.get(), _instance.get())


@contextlib.contextmanager
def bind(ctx: TraceCtx):
    """Re-enter a captured context (typically inside a worker thread)."""
    tokens = (_trace_id.set(ctx.trace_id), _span_id.set(ctx.span_id),
              _service.set(ctx.service), _instance.set(ctx.instance))
    try:
        yield
    finally:
        for var, tok in zip((_trace_id, _span_id, _service, _instance),
                            tokens):
            var.reset(tok)


def run_with(ctx: TraceCtx, fn, *args, **kwargs):
    """Run fn under a captured context."""
    with bind(ctx):
        return fn(*args, **kwargs)


class Span:
    """Context manager measuring one operation; records into the ring on
    exit. With an explicit ctx= it works in plain threads."""

    __slots__ = ("name", "tags", "_ctx", "_root", "trace_id", "span_id",
                 "parent_id", "_service", "_instance", "_t0", "_start_us",
                 "_tokens", "dur_us")

    def __init__(self, name: str, tags: Optional[dict] = None,
                 ctx: Optional[TraceCtx] = None,
                 service: str = "", root: bool = False):
        self.name = name
        self.tags = dict(tags) if tags else {}
        self._ctx = ctx
        self._root = root
        self._service = service
        self._tokens = None

    def __enter__(self) -> "Span":
        ctx = self._ctx if self._ctx is not None else capture()
        self.trace_id = ctx.trace_id or new_id()
        self.parent_id = "" if self._root else ctx.span_id
        self.span_id = new_id()
        svc = self._service or ctx.service
        self._service = svc
        self._instance = ctx.instance
        self._tokens = (_trace_id.set(self.trace_id),
                        _span_id.set(self.span_id),
                        _service.set(svc),
                        _instance.set(ctx.instance))
        self._start_us = int(time.time() * 1e6)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dur_us = int((time.perf_counter() - self._t0) * 1e6)
        self.dur_us = dur_us
        for var, tok in zip((_trace_id, _span_id, _service, _instance),
                            self._tokens):
            var.reset(tok)
        if exc_type is not None:
            self.tags.setdefault("error", exc_type.__name__)
        record({
            "trace": self.trace_id,
            "id": self.span_id,
            "parent": self.parent_id,
            "name": self.name,
            "svc": self._service,
            "inst": self._instance,
            "start_us": self._start_us,
            "dur_us": dur_us,
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "tags": self.tags,
        })

    @property
    def dur_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3


def span(name: str, tags: Optional[dict] = None,
         ctx: Optional[TraceCtx] = None, service: str = "") -> Span:
    return Span(name, tags=tags, ctx=ctx, service=service)


def record(span_dict: dict) -> None:
    with _ring_lock:
        _ring.append(span_dict)


def record_span(name: str, ctx: TraceCtx, start_us: int, dur_us: int,
                tags: Optional[dict] = None) -> str:
    """Record a completed span against an explicit context, with no
    contextvar traffic (hot worker threads: the EC pipeline stages).
    Returns the span id."""
    sid = new_id()
    record({
        "trace": ctx.trace_id,
        "id": sid,
        "parent": ctx.span_id,
        "name": name,
        "svc": ctx.service,
        "inst": ctx.instance,
        "start_us": start_us,
        "dur_us": dur_us,
        "tid": threading.get_ident() & 0x7FFFFFFF,
        "tags": dict(tags) if tags else {},
    })
    return sid


@contextlib.contextmanager
def stage(name: str, ctx: TraceCtx, tags: Optional[dict] = None):
    """Time a block and record_span it against an explicit context."""
    start_us = int(time.time() * 1e6)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record_span(name, ctx, start_us,
                    int((time.perf_counter() - t0) * 1e6), tags)


def ensure_ctx(service: str = "") -> TraceCtx:
    """The ambient context, or a fresh root one (trace id minted) when no
    trace is active, so a background operation still forms one trace."""
    ctx = capture()
    if ctx.trace_id:
        return ctx
    return TraceCtx(new_id(), "", ctx.service or service, ctx.instance)


def spans(trace_id: str = "", limit: int = 0) -> list[dict]:
    """Completed spans, oldest first, optionally filtered by trace id."""
    with _ring_lock:
        out = list(_ring)
    if trace_id:
        out = [s for s in out if s["trace"] == trace_id]
    if limit and len(out) > limit:
        out = out[-limit:]
    return out


def reset() -> None:
    """Drop all recorded spans (tests)."""
    with _ring_lock:
        _ring.clear()


def stage_totals(trace_id: str = "",
                 prefix: str = "") -> dict[str, tuple[int, int]]:
    """Aggregate completed spans by name -> (count, total_us), optionally
    filtered by trace id and name prefix: the EC feed governor's
    per-stage time model."""
    out: dict[str, tuple[int, int]] = {}
    for s in spans(trace_id=trace_id):
        name = s.get("name", "")
        if prefix and not name.startswith(prefix):
            continue
        c, t = out.get(name, (0, 0))
        out[name] = (c + 1, t + int(s.get("dur_us", 0)))
    return out


def maybe_log_slow(span_obj: Span) -> None:
    """Slow-operation warning for a root span; threshold
    WEED_TRACE_SLOW_MS."""
    dur = span_obj.dur_ms
    if dur >= slow_threshold_ms():
        _log.warning("slow request trace=%s svc=%s %s took %.1fms",
                     span_obj.trace_id, span_obj._service or "?",
                     span_obj.name, dur)


def to_chrome_trace(span_dicts: Iterable[dict]) -> dict:
    """Span dicts -> one Chrome trace-event JSON document; each distinct
    (service, instance) pair is a process lane."""
    span_dicts = list(span_dicts)
    procs: dict[tuple[str, str], int] = {}
    for s in span_dicts:
        key = (s.get("svc") or "unknown", s.get("inst") or "")
        procs.setdefault(key, len(procs) + 1)
    events = []
    for (svc, inst), pid in procs.items():
        events.append({
            "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": f"{svc}@{inst}" if inst else svc}})
    for s in span_dicts:
        pid = procs[(s.get("svc") or "unknown", s.get("inst") or "")]
        args = {"trace_id": s.get("trace", ""),
                "span_id": s.get("id", "")}
        if s.get("parent"):
            args["parent_id"] = s["parent"]
        for k, v in (s.get("tags") or {}).items():
            args[str(k)] = v
        events.append({
            "name": s.get("name", "?"),
            "cat": s.get("svc") or "unknown",
            "ph": "X",
            "ts": s.get("start_us", 0),
            "dur": max(int(s.get("dur_us", 0)), 1),
            "pid": pid,
            "tid": s.get("tid", 0),
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def client_trace_config():
    """aiohttp TraceConfig that adds the ambient deadline budget and
    priority class to every outbound request of a session created with it
    (params.headers is the live request header dict). The reference's also
    carries the trace id, which waits for trace propagation (ROADMAP Queue
    1 A.9)."""
    import aiohttp

    tc = aiohttp.TraceConfig()

    async def on_request_start(session, trace_ctx, params) -> None:
        from .. import overload
        from ..utils import retry
        retry.inject_deadline(params.headers)
        overload.inject(params.headers)

    tc.on_request_start.append(on_request_start)
    return tc
