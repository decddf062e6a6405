"""leveldb2: the dir-hash SHARDED embedded store.

The port's copy of seaweedfs_tpu/filer/leveldb2_store.py, whole: either
package opens the other's directory of shards.

Counterpart of weed/filer/leveldb2/leveldb2_store.go:1-207 — not a
config alias of leveldb but a scalability design: the parent directory
is md5-hashed and its last byte picks one of 8 independent LSM
instances (subdirs 00..07), so write amplification and compaction load
spread across 8 smaller trees while every directory's children stay in
exactly ONE shard (listing remains a single-range scan there;
hashToBytes, leveldb2_store.go:239-248). DeleteFolderChildren removes
direct children only — grandchildren live in their own parents' shards
— matching the reference's prefix-range delete.

Each shard is a full LevelDbStore (WAL + sorted segment, the in-repo
LSM); the sharding layer routes by the same hash rule the reference
uses. The KV face hashes the key itself.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

from .entry import Entry
from .leveldb_store import LevelDbStore
from .stores import FilerStore, _split

DB_COUNT = 8


def _shard_of(dir_path: str, count: int = DB_COUNT) -> int:
    """md5(dir), last byte mod count (leveldb2_store.go hashToBytes)."""
    digest = hashlib.md5(dir_path.encode("utf-8")).digest()
    return digest[-1] % count


class Leveldb2Store(FilerStore):
    name = "leveldb2"

    def __init__(self, path: str = "filer2.ldb",
                 db_count: int = DB_COUNT, **kw):
        self.dir = path
        self.db_count = db_count
        self._shards = []
        for d in range(db_count):
            sub = os.path.join(path, f"{d:02d}")
            self._shards.append(LevelDbStore(path=sub, **kw))

    def _for_dir(self, dir_path: str) -> LevelDbStore:
        return self._shards[_shard_of(dir_path, self.db_count)]

    def _for_path(self, path: str) -> LevelDbStore:
        d, _name = _split(path)
        return self._shards[_shard_of(d, self.db_count)]

    # --- entry CRUD: route by the PARENT directory's hash ---
    def insert_entry(self, entry: Entry) -> None:
        self._for_path(entry.full_path).insert_entry(entry)

    def update_entry(self, entry: Entry) -> None:
        self._for_path(entry.full_path).update_entry(entry)

    def find_entry(self, path: str) -> Optional[Entry]:
        return self._for_path(path).find_entry(path)

    def delete_entry(self, path: str) -> None:
        self._for_path(path).delete_entry(path)

    def delete_folder_children(self, path: str) -> None:
        # this repo's store contract deletes the whole SUBTREE in one
        # call (the filer does not recurse); descendants hash to
        # different shards by their own parent dirs, so every shard
        # prunes its slice of the subtree
        for shard in self._shards:
            shard.delete_folder_children(path)

    def list_directory_entries(self, dir_path: str, start_file_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        return self._for_dir(dir_path).list_directory_entries(
            dir_path, start_file_name, include_start, limit, prefix)

    def iter_directories(self):
        """Every shard's directories, merged in order (a directory's
        children live in one shard)."""
        dirs = set()
        for shard in self._shards:
            dirs.update(shard.iter_directories())
        return iter(sorted(dirs))

    # --- KV face: hash the key itself ---
    def kv_put(self, key: str, value: bytes) -> None:
        self._shards[_shard_of(key, self.db_count)].kv_put(key, value)

    def kv_get(self, key: str) -> Optional[bytes]:
        return self._shards[_shard_of(key, self.db_count)].kv_get(key)

    def close(self) -> None:
        for shard in self._shards:
            shard.close()
