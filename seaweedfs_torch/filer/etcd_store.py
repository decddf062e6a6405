"""The etcd filer store: an ordered keyspace read by ranges.

The port's copy of seaweedfs_tpu/filer/etcd_store.py (upstream
weed/filer/etcd/etcd_store.go:26-190): an entry's JSON lives at key
``dir + "\\x00" + name`` (genKey, :183-188), a directory listing is one
range read over the directory's prefix (:146-180), and a folder purge is
two prefix range deletes. The transport is etcd v3's HTTP/JSON gateway
(``/v3/kv/range``, ``/v3/kv/put``, ``/v3/kv/deleterange``, keys and
values in base64), which every etcd serves on its client port. Every
call is one blocking ``urllib`` request bounded by the caller's deadline
budget (utils/retry.py), so the filer server makes its store calls in
an executor, never on its loop. The tests and the smoke run it against
fake_etcd.py.
"""

from __future__ import annotations

import base64
import json
import urllib.request
from typing import Optional

from ..utils import retry
from .entry import Entry
from .stores import FilerStore, _split

DIR_FILE_SEPARATOR = "\x00"  # etcd_store.go:18
_KV_PREFIX = "kv\x01"


def _b64(s: bytes) -> str:
    return base64.b64encode(s).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


def prefix_range_end(prefix: bytes) -> bytes:
    """clientv3.GetPrefixRangeEnd: the least key above every key that
    starts with `prefix`."""
    b = bytearray(prefix)
    for i in range(len(b) - 1, -1, -1):
        if b[i] < 0xFF:
            b[i] += 1
            return bytes(b[:i + 1])
    return b"\x00"  # an all-0xff prefix: to the end of the keyspace


class EtcdStore(FilerStore):
    name = "etcd"

    def __init__(self, servers: str = "127.0.0.1:2379", timeout: float = 3.0,
                 **_):
        host = servers.split(",")[0]
        if not host.startswith("http"):
            host = "http://" + host
        self._base = host.rstrip("/")
        self._timeout = timeout
        self._call("range", {"key": _b64(b"\x00")})  # reachable?

    def _call(self, api: str, payload: dict) -> dict:
        req = urllib.request.Request(
            f"{self._base}/v3/kv/{api}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(
                req, timeout=retry.cap_timeout(self._timeout)) as r:
            return json.loads(r.read() or b"{}")

    def _put(self, key: bytes, value: bytes) -> None:
        self._call("put", {"key": _b64(key), "value": _b64(value)})

    def _get(self, key: bytes) -> Optional[bytes]:
        kvs = self._call("range", {"key": _b64(key)}).get("kvs") or []
        return _unb64(kvs[0]["value"]) if kvs else None

    def _delete(self, key: bytes, range_end: Optional[bytes] = None) -> None:
        payload = {"key": _b64(key)}
        if range_end is not None:
            payload["range_end"] = _b64(range_end)
        self._call("deleterange", payload)

    @staticmethod
    def _entry_key(path: str) -> bytes:
        d, name = _split(path)
        return (d + DIR_FILE_SEPARATOR + name).encode()

    @staticmethod
    def _dir_prefix(dir_path: str) -> bytes:
        return (dir_path + DIR_FILE_SEPARATOR).encode()

    def insert_entry(self, entry: Entry) -> None:
        self._put(self._entry_key(entry.full_path),
                  entry.to_json().encode())

    def update_entry(self, entry: Entry) -> None:  # etcd_store.go:97
        self.insert_entry(entry)

    def find_entry(self, path: str) -> Optional[Entry]:
        data = self._get(self._entry_key(path))
        if data is None:
            return None
        return Entry.from_json(data.decode())

    def delete_entry(self, path: str) -> None:
        self._delete(self._entry_key(path))

    def delete_folder_children(self, path: str) -> None:
        # the children's keys share "dir\x00"; the deeper tree lies
        # under "dir/"
        p = self._dir_prefix(path)
        self._delete(p, prefix_range_end(p))
        deep = (path.rstrip("/") + "/").encode()
        self._delete(deep, prefix_range_end(deep))

    def list_directory_entries(self, dir_path: str, start_file_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        base = self._dir_prefix(dir_path)
        scope = base + prefix.encode() if prefix else base
        start = base + start_file_name.encode() if start_file_name else scope
        if start < scope:
            start = scope
        resp = self._call("range", {
            "key": _b64(start),
            "range_end": _b64(prefix_range_end(scope)),
            "sort_order": "ASCEND", "sort_target": "KEY",
            # one more, for an excluded start key
            "limit": limit + 1,
        })
        out: list[Entry] = []
        for kv in resp.get("kvs") or []:
            name = _unb64(kv["key"])[len(base):].decode()
            if not name:
                continue
            if name == start_file_name and not include_start:
                continue
            out.append(Entry.from_json(_unb64(kv["value"]).decode()))
            if len(out) >= limit:
                break
        return out

    def kv_put(self, key: str, value: bytes) -> None:
        self._put((_KV_PREFIX + key).encode(), value)

    def kv_get(self, key: str) -> Optional[bytes]:
        return self._get((_KV_PREFIX + key).encode())
