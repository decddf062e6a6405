"""FilerStore plugins: the pluggable metadata backend.

The port's reduced copy of seaweedfs_tpu/filer/stores.py. One interface,
several implementations, as the reference's FilerStore contract
(weed/filer/filerstore.go:20-43) and its plugin model (a store selected
by name, weed/filer/configuration.go:14-37):

- ``memory``   : dict-backed (tests, ephemeral filers)
- ``sqlite``   : stdlib sqlite3 over the abstract-SQL layer
                 (abstract_sql.py), the CLI filer's default
- ``leveldb``  : the embedded LSM (leveldb_store.py)
- ``leveldb2`` : eight LSMs sharded by the parent directory's hash
                 (leveldb2_store.py)
- ``mysql``, ``postgres``: the abstract-SQL layer on their DB-API
                 drivers
- the network stores, each with a fake server in the repo: ``redis``
  (redis_store.py), ``redis2`` (redis2_store.py), ``etcd``
  (etcd_store.py), ``mongodb`` (mongodb_store.py), ``elastic``
  (elastic_store.py), ``cassandra`` (cassandra_store.py)

Each supports the same contract: entry CRUD by full path, ordered
directory listing with prefix and pagination, a subtree purge, a KV
face for system metadata, and ``iter_directories``, the walk of the
filer ring's handoff (the reference's leveldb stores cannot enumerate;
the port's can, ROADMAP Queue 3, D17). The network stores cannot, in
either package, so a ring member on one hands no partition off. Asking
``create_store`` for an unknown name raises the reference's KeyError.
"""

from __future__ import annotations

import importlib
import threading
from typing import Callable, Iterator, Optional

from .entry import Entry

_STORES: dict[str, Callable[..., "FilerStore"]] = {}


def register_store(name: str, factory) -> None:
    _STORES[name] = factory


def create_store(name: str, **kwargs) -> "FilerStore":
    if name not in _STORES:
        raise KeyError(f"unknown filer store {name!r}; have {sorted(_STORES)}")
    return _STORES[name](**kwargs)


class FilerStore:
    name = "base"

    def insert_entry(self, entry: Entry) -> None:
        raise NotImplementedError

    def update_entry(self, entry: Entry) -> None:
        raise NotImplementedError

    def find_entry(self, path: str) -> Optional[Entry]:
        raise NotImplementedError

    def delete_entry(self, path: str) -> None:
        raise NotImplementedError

    def delete_folder_children(self, path: str) -> None:
        raise NotImplementedError

    def list_directory_entries(self, dir_path: str, start_file_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        raise NotImplementedError

    def kv_put(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def kv_get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def iter_directories(self) -> Iterator[str]:
        """Every directory with at least one stored child, sorted: the
        walk of the ring's partition handoff (a walk from the root cannot
        see subtrees whose parents live on other peers)."""
        raise NotImplementedError(
            f"store {self.name!r} cannot enumerate directories")

    def begin(self) -> None:  # transaction hooks (AtomicRenameEntry)
        pass

    def commit(self) -> None:
        pass

    def rollback(self) -> None:
        pass

    def close(self) -> None:
        pass


def _split(path: str) -> tuple[str, str]:
    path = path.rstrip("/") or "/"
    if path == "/":
        return "", "/"
    d, _, name = path.rpartition("/")
    return d or "/", name


class MemoryStore(FilerStore):
    name = "memory"

    def __init__(self, **_):
        # dir -> {name -> Entry}
        self._dirs: dict[str, dict[str, Entry]] = {}
        self._kv: dict[str, bytes] = {}
        self._lock = threading.RLock()
        self._snapshot: Optional[dict] = None

    def begin(self) -> None:
        with self._lock:
            self._snapshot = {d: dict(names)
                              for d, names in self._dirs.items()}

    def commit(self) -> None:
        self._snapshot = None

    def rollback(self) -> None:
        with self._lock:
            if self._snapshot is not None:
                self._dirs = self._snapshot
                self._snapshot = None

    def insert_entry(self, entry: Entry) -> None:
        d, name = _split(entry.full_path)
        with self._lock:
            self._dirs.setdefault(d, {})[name] = entry

    update_entry = insert_entry

    def find_entry(self, path: str) -> Optional[Entry]:
        d, name = _split(path)
        if name == "/":
            return None
        with self._lock:
            return self._dirs.get(d, {}).get(name)

    def delete_entry(self, path: str) -> None:
        d, name = _split(path)
        with self._lock:
            self._dirs.get(d, {}).pop(name, None)

    def delete_folder_children(self, path: str) -> None:
        path = path.rstrip("/") or "/"
        with self._lock:
            doomed = [d for d in self._dirs
                      if d == path or d.startswith(path + "/")
                      or (path == "/" and d)]
            for d in doomed:
                self._dirs.pop(d, None)

    def list_directory_entries(self, dir_path: str, start_file_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        dir_path = dir_path.rstrip("/") or "/"
        with self._lock:
            names = sorted(self._dirs.get(dir_path, {}))
            out = []
            for n in names:
                if prefix and not n.startswith(prefix):
                    continue
                if start_file_name:
                    if n < start_file_name:
                        continue
                    if n == start_file_name and not include_start:
                        continue
                out.append(self._dirs[dir_path][n])
                if len(out) >= limit:
                    break
            return out

    def kv_put(self, key: str, value: bytes) -> None:
        self._kv[key] = value

    def kv_get(self, key: str) -> Optional[bytes]:
        return self._kv.get(key)

    def iter_directories(self) -> Iterator[str]:
        with self._lock:
            dirs = sorted(d for d, names in self._dirs.items()
                          if names and d)
        return iter(dirs)


def _lazy(module: str, cls: str):
    """A factory that imports `module` at the first store made: the
    stores' modules import this one."""
    def make(**kw):
        return getattr(importlib.import_module(f"{__package__}.{module}"),
                       cls)(**kw)
    return make


register_store("memory", MemoryStore)
for _name, _module, _cls in (
        ("sqlite", "abstract_sql", "SqliteStore"),
        ("mysql", "abstract_sql", "MysqlStore"),
        ("postgres", "abstract_sql", "PostgresStore"),
        ("leveldb", "leveldb_store", "LevelDbStore"),
        ("leveldb2", "leveldb2_store", "Leveldb2Store"),
        ("redis", "redis_store", "RedisStore"),
        ("redis2", "redis2_store", "Redis2Store"),
        ("etcd", "etcd_store", "EtcdStore"),
        ("mongodb", "mongodb_store", "MongodbStore"),
        ("elastic", "elastic_store", "ElasticStore"),
        ("cassandra", "cassandra_store", "CassandraStore")):
    register_store(_name, _lazy(_module, _cls))

# the network stores: kind -> (its fake server's module and class in this
# package's filer/, whether its address goes to the store as ``servers``
# (etcd and elastic: an address or URL) or as ``host`` and ``port``)
NETWORK_STORES = {
    "redis": ("fake_redis", "FakeRedisServer", False),
    "redis2": ("fake_redis", "FakeRedisServer", False),
    "etcd": ("fake_etcd", "FakeEtcdServer", True),
    "mongodb": ("fake_mongo", "FakeMongoServer", False),
    "elastic": ("fake_elastic", "FakeElasticServer", True),
    "cassandra": ("fake_cassandra", "FakeCassandraServer", False),
}


def network_store_kwargs(kind: str, address: str) -> dict:
    """The kwargs of the network store `kind` on the server at `address`
    (``host:port``; etcd and elastic also take a URL or a comma list).
    ValueError for a store that takes no address, or a malformed one."""
    if kind not in NETWORK_STORES:
        raise ValueError(f"the {kind!r} store takes no server address; "
                         f"the network stores are {sorted(NETWORK_STORES)}")
    if NETWORK_STORES[kind][2]:
        if not address.strip(", "):
            raise ValueError(f"the {kind!r} store needs an address")
        return {"servers": address}
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"the {kind!r} store's address must be "
                         f"host:port, got {address!r}")
    return {"host": host, "port": int(port)}
