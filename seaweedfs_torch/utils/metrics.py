"""Minimal Prometheus-text metrics registry.

The port's reduced copy of seaweedfs_tpu/utils/metrics.py: counters and
gauges with optional label sets, rendered in Prometheus exposition
format, and the process-wide shared registries that subsystems which are
not servers (the EC feed governor and feed) publish through. The family
names keep the reference's ``seaweedfs_tpu_<subsystem>_`` namespace, so
dashboards and alerts read either package. Not ported: duration
histograms and their exemplars, the aiohttp ``exposition`` handler and
the push-gateway loop (they come with the servers, which use them).
"""

from __future__ import annotations

import threading
from collections import defaultdict

# the reference's metric namespace
NAMESPACE = "seaweedfs_tpu"


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

    def count(self, name: str, value: float = 1.0,
              labels: dict | None = None) -> None:
        with self._lock:
            self._counters[_key(name, labels)] += value

    def gauge(self, name: str, value: float,
              labels: dict | None = None) -> None:
        with self._lock:
            self._gauges[_key(name, labels)] = value

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
            return "\n".join(lines) + "\n"

    def is_empty(self) -> bool:
        with self._lock:
            return not (self._counters or self._gauges)


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
