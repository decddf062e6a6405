"""redis2: the redis store whose directories are sorted sets.

The port's copy of seaweedfs_tpu/filer/redis2_store.py (upstream
weed/filer/redis2/universal_redis_store.go): a directory's children live
in a ZSET at ``dir + "\\x00"`` (score 0, so redis orders them by name)
instead of a SET. Insert is ``ZADD NX`` (:51), delete ``ZREM`` (:100),
and a listing pages with index-ranged ``ZRANGE`` (:142) from the start
name's ``ZRANK``, so a page of a large directory does not fetch its whole
membership. Same RESP client and entry keys as redis_store.py.
"""

from __future__ import annotations

from typing import Optional

from .entry import Entry
from .redis_store import _KV_PREFIX, _dir_list_key, _RespClient
from .stores import FilerStore, _split

_PAGE = 1024


class Redis2Store(FilerStore):
    name = "redis2"

    def __init__(self, host: str = "127.0.0.1", port: int = 6379, **_):
        self._client = _RespClient(host, port)
        self._client.command("PING")

    def insert_entry(self, entry: Entry) -> None:
        c = self._client
        c.command("SET", entry.full_path, entry.to_json())
        d, name = _split(entry.full_path)
        if name:
            c.command("ZADD", _dir_list_key(d), "NX", 0, name)

    def update_entry(self, entry: Entry) -> None:
        self.insert_entry(entry)

    def find_entry(self, path: str) -> Optional[Entry]:
        data = self._client.command("GET", path)
        if data is None:
            return None
        return Entry.from_json(data.decode())

    def delete_entry(self, path: str) -> None:
        c = self._client
        c.command("DEL", path, _dir_list_key(path))
        d, name = _split(path)
        if name:
            c.command("ZREM", _dir_list_key(d), name)

    def delete_folder_children(self, path: str) -> None:
        c = self._client
        start = 0
        while True:
            names = c.command("ZRANGE", _dir_list_key(path), start,
                              start + _PAGE - 1)
            if not names:
                break
            for raw in names:
                child = f"{path.rstrip('/')}/{raw.decode()}"
                self.delete_folder_children(child)
                c.command("DEL", child, _dir_list_key(child))
            start += len(names)
        c.command("DEL", _dir_list_key(path))

    def list_directory_entries(self, dir_path: str, start_file_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        c = self._client
        out: list[Entry] = []
        # start at the marker's rank on the server; a marker that is not
        # a member falls back to a scan that skips on the client
        index = 0
        if start_file_name:
            rank = c.command("ZRANK", _dir_list_key(dir_path),
                             start_file_name)
            if rank is not None:
                index = int(rank) + (0 if include_start else 1)
                start_file_name = ""
        while len(out) < limit:
            names = c.command("ZRANGE", _dir_list_key(dir_path), index,
                              index + _PAGE - 1)
            if not names:
                break
            index += len(names)
            for raw in names:
                name = raw.decode()
                if start_file_name:
                    if name < start_file_name:
                        continue
                    if name == start_file_name and not include_start:
                        continue
                if prefix and not name.startswith(prefix):
                    continue
                e = self.find_entry(f"{dir_path.rstrip('/')}/{name}")
                if e is not None:
                    out.append(e)
                    if len(out) >= limit:
                        break
        return out

    def kv_put(self, key: str, value: bytes) -> None:
        self._client.command("SET", _KV_PREFIX + key, value)

    def kv_get(self, key: str) -> Optional[bytes]:
        v = self._client.command("GET", _KV_PREFIX + key)
        return bytes(v) if v is not None else None

    def close(self) -> None:
        self._client.close()
