"""S3-Select-lite: filter/project JSON documents stored in needles.

The port's copy of seaweedfs_tpu/query/json_query.py, whole. Capability
parity with the reference's query engine
(weed/server/volume_grpc_query.go:13-69, weed/query/json/query_json.go:17):
stream needle payloads, apply a comparison filter on one dotted field, and
project a subset of fields, emitting NDJSON. The reference uses gjson path
syntax; here paths are dotted keys with list indices (a.b.0.c).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Iterable, Iterator, Optional

_OPS = {
    "=": lambda a, b: a == b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "contains": lambda a, b: isinstance(a, str) and str(b) in a,
}


def get_path(doc: Any, path: str) -> Optional[Any]:
    """Resolve a dotted path ('a.b.0.c') against parsed JSON."""
    cur = doc
    if not path:
        return cur
    for part in path.split("."):
        if isinstance(cur, dict):
            if part not in cur:
                return None
            cur = cur[part]
        elif isinstance(cur, list):
            try:
                cur = cur[int(part)]
            except (ValueError, IndexError):
                return None
        else:
            return None
    return cur


@dataclass
class QueryFilter:
    field: str
    op: str
    value: Any

    def matches(self, doc: Any) -> bool:
        got = get_path(doc, self.field)
        if got is None:
            return False
        want = self.value
        # numeric comparisons coerce like gjson does
        if isinstance(got, (int, float)) and isinstance(want, str):
            try:
                want = float(want)
            except ValueError:
                pass
        fn = _OPS.get(self.op)
        if fn is None:
            raise ValueError(f"unsupported op {self.op!r}")
        try:
            return bool(fn(got, want))
        except TypeError:
            return False


def project_doc(doc: Any, projections: Optional[list[str]]) -> Any:
    if not projections:
        return doc
    out = {}
    for p in projections:
        v = get_path(doc, p)
        if v is not None:
            out[p.split(".")[-1]] = v
    return out


def query_json_lines(payloads: Iterable[bytes],
                     flt: Optional[QueryFilter] = None,
                     projections: Optional[list[str]] = None,
                     ) -> Iterator[str]:
    """Filter+project a stream of JSON payloads; yields NDJSON lines.
    Payloads that aren't valid JSON are skipped (as the reference skips
    needles that fail to parse)."""
    for raw in payloads:
        try:
            doc = json.loads(raw)
        except (ValueError, UnicodeDecodeError):
            continue
        docs = doc if isinstance(doc, list) else [doc]
        for d in docs:
            if flt is not None and not flt.matches(d):
                continue
            yield json.dumps(project_doc(d, projections),
                             separators=(",", ":"))
