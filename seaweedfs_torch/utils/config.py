"""Two-tier configuration: per-command flags + TOML files with env override.

The port's copy of seaweedfs_tpu/utils/config.py, whole (upstream's
Viper-based loader, weed/util/config.go:19-43): TOML files are searched
in ./, ~/.seaweedfs/, /etc/seaweedfs/ and any key can be overridden by an
environment variable named ``WEED_<SECTION>_<KEY>`` (dots become
underscores, upper-cased), matching weed/command/scaffold.go:18-22.
"""

from __future__ import annotations

import os
import tomllib
from typing import Any, Optional

SEARCH_PATHS = [".", os.path.expanduser("~/.seaweedfs"), "/etc/seaweedfs"]

ENV_PREFIX = "WEED_"


class Configuration:
    """A loaded TOML document with env-var override and dotted-key access."""

    def __init__(self, data: dict, name: str = ""):
        self._data = data
        self._name = name

    def get(self, key: str, default: Any = None) -> Any:
        env_key = ENV_PREFIX + key.replace(".", "_").replace("-", "_").upper()
        if env_key in os.environ:
            raw = os.environ[env_key]
            if isinstance(default, bool):
                return raw.lower() in ("1", "true", "yes", "on")
            if isinstance(default, int):
                try:
                    return int(raw)
                except ValueError:
                    return default
            if isinstance(default, float):
                try:
                    return float(raw)
                except ValueError:
                    return default
            return raw
        node: Any = self._data
        for part in key.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def get_string(self, key: str, default: str = "") -> str:
        return str(self.get(key, default))

    def get_bool(self, key: str, default: bool = False) -> bool:
        return bool(self.get(key, default))

    def get_int(self, key: str, default: int = 0) -> int:
        return int(self.get(key, default))

    def section(self, key: str) -> "Configuration":
        val = self.get(key, {})
        return Configuration(val if isinstance(val, dict) else {}, self._name)

    def keys(self) -> list[str]:
        return list(self._data.keys())


def load_configuration(name: str, required: bool = False,
                       search_paths: Optional[list[str]] = None
                       ) -> Configuration:
    """Load ``<name>.toml`` from the standard search paths.

    Returns an empty Configuration (env overrides still apply) when the file
    is absent and not required, like LoadConfiguration
    (weed/util/config.go:19).
    """
    for d in (search_paths or SEARCH_PATHS):
        path = os.path.join(d, name + ".toml")
        if os.path.isfile(path):
            with open(path, "rb") as f:
                return Configuration(tomllib.load(f), name)
    if required:
        raise FileNotFoundError(
            f"missing required config {name}.toml in {search_paths or SEARCH_PATHS}")
    return Configuration({}, name)
