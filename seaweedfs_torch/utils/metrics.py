"""Minimal Prometheus-text metrics registry.

The port's reduced copy of seaweedfs_tpu/utils/metrics.py: counters,
gauges and duration histograms (the reference's buckets) with optional
label sets, rendered in Prometheus exposition format, and the
process-wide shared registries that subsystems which are not servers
(the EC feed governor and feed) publish through. The family names keep
the reference's ``seaweedfs_tpu_<subsystem>_`` namespace, so dashboards
and alerts read either package. Not ported: histogram exemplars, the
aiohttp ``exposition`` handler and the push-gateway loop (they come
with the trace plane, ROADMAP A.9).
"""

from __future__ import annotations

import threading
from collections import defaultdict

# the reference's metric namespace
NAMESPACE = "seaweedfs_tpu"
# the reference's histogram buckets, seconds
_BUCKETS = [0.0001, 0.001, 0.01, 0.1, 1.0, 10.0]


def _escape(value) -> str:
    """Prometheus exposition label-value escaping: backslash, quote,
    newline."""
    return (str(value).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _key(name: str, labels: dict | None) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{_escape(v)}"'
                     for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


class Registry:
    def __init__(self, subsystem: str):
        self.subsystem = subsystem
        self._lock = threading.Lock()
        self._counters: dict[str, float] = defaultdict(float)
        self._gauges: dict[str, float] = {}
        self._hist: dict[str, list[int]] = {}
        self._hist_sum: dict[str, float] = defaultdict(float)
        self._hist_count: dict[str, int] = defaultdict(int)

    def count(self, name: str, value: float = 1.0,
              labels: dict | None = None) -> None:
        with self._lock:
            self._counters[_key(name, labels)] += value

    def gauge(self, name: str, value: float,
              labels: dict | None = None) -> None:
        with self._lock:
            self._gauges[_key(name, labels)] = value

    def observe(self, name: str, seconds: float,
                labels: dict | None = None) -> None:
        key = _key(name, labels)
        with self._lock:
            buckets = self._hist.setdefault(key, [0] * (len(_BUCKETS) + 1))
            for i, b in enumerate(_BUCKETS):
                if seconds <= b:
                    buckets[i] += 1
                    break
            else:
                buckets[-1] += 1
            self._hist_sum[key] += seconds
            self._hist_count[key] += 1

    def value(self, name: str, labels: dict | None = None,
              default: float = 0.0) -> float:
        """Current value of a counter or gauge."""
        key = _key(name, labels)
        with self._lock:
            if key in self._counters:
                return self._counters[key]
            return self._gauges.get(key, default)

    @staticmethod
    def _split(key: str) -> tuple[str, str]:
        """'read{a="b"}' -> ('read', '{a="b"}')."""
        if "{" in key:
            name, _, rest = key.partition("{")
            return name, "{" + rest
        return key, ""

    @classmethod
    def _families(cls, keys) -> dict[str, list[str]]:
        """Group metric keys by family name, families and label sets both
        sorted: all samples of one family sit under one # TYPE line."""
        fams: dict[str, list[str]] = {}
        for key in sorted(keys):
            fams.setdefault(cls._split(key)[0], []).append(key)
        return dict(sorted(fams.items()))

    def render(self) -> str:
        """Prometheus exposition text."""
        with self._lock:
            lines = []
            p = f"{NAMESPACE}_{self.subsystem}"
            for name, keys in self._families(self._counters).items():
                lines.append(f"# TYPE {p}_{name}_total counter")
                for key in keys:
                    _, lbl = self._split(key)
                    lines.append(f"{p}_{name}_total{lbl} "
                                 f"{self._counters[key]}")
            for name, keys in self._families(self._gauges).items():
                lines.append(f"# TYPE {p}_{name} gauge")
                for key in keys:
                    _, lbl = self._split(key)
                    lines.append(f"{p}_{name}{lbl} {self._gauges[key]}")
            for name, keys in self._families(self._hist).items():
                lines.append(f"# TYPE {p}_{name}_seconds histogram")
                for key in keys:
                    _, lbl = self._split(key)
                    # the key's labels with the per-bucket le label
                    inner = lbl[1:-1] + "," if lbl else ""
                    acc = 0
                    for b, n in zip(_BUCKETS + ["+Inf"], self._hist[key]):
                        acc += n
                        lines.append(f"{p}_{name}_seconds_bucket"
                                     f'{{{inner}le="{b}"}} {acc}')
                    lines.append(f"{p}_{name}_seconds_sum{lbl} "
                                 f"{self._hist_sum[key]}")
                    lines.append(f"{p}_{name}_seconds_count{lbl} "
                                 f"{self._hist_count[key]}")
            return "\n".join(lines) + "\n"

    def snapshot(self, prefix: str = "") -> dict[str, float]:
        """Counters and gauges as a flat {rendered key: value} dict,
        filtered by family-name prefix: the JSON face of the registry
        for admin status endpoints (ec.mesh.status)."""
        with self._lock:
            out = {k: v for k, v in self._counters.items()
                   if k.startswith(prefix)}
            out.update((k, v) for k, v in self._gauges.items()
                       if k.startswith(prefix))
            return out

    def is_empty(self) -> bool:
        with self._lock:
            return not (self._counters or self._gauges or self._hist)


# --- process-wide shared registries ---
# Subsystems that are not servers (the EC feed governor) register here;
# a server's /metrics appends render_shared() to its own registry's text.

_shared: dict[str, "Registry"] = {}
_shared_lock = threading.Lock()


def shared(subsystem: str) -> "Registry":
    """The process-wide registry for `subsystem` (created on first use)."""
    with _shared_lock:
        reg = _shared.get(subsystem)
        if reg is None:
            reg = _shared[subsystem] = Registry(subsystem)
        return reg


def render_shared() -> str:
    """Exposition text of every non-empty shared registry, stable order."""
    with _shared_lock:
        regs = [_shared[name] for name in sorted(_shared)]
    return "".join(r.render() for r in regs if not r.is_empty())
