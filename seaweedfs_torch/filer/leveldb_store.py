"""Embedded log-structured filer store (the port's copy of
seaweedfs_tpu/filer/leveldb_store.py, whole: either package opens the
other's files) — the role of the reference's
default leveldb store (weed/filer/leveldb/leveldb_store.go).

Same design family as LevelDB (LSM): writes append to a write-ahead log
and land in an in-memory sorted memtable; when the WAL grows past a
threshold the memtable merges into a single sorted segment file and the
WAL resets. Reads consult the memtable first, then the segment. Crash
recovery = load segment + replay WAL.

Key layout matches the reference's: `dir \\x00 name`, so all children of a
directory are a contiguous sorted key range and directory listing is a
range scan (leveldb_store.go ListDirectoryEntries). The KV face uses a
separate `\\x01` prefix.
"""

from __future__ import annotations

import bisect
import json
import os
import threading
from typing import Optional

from ..utils import durable
from .entry import Entry
from .stores import FilerStore, _split

_SEP = "\x00"
_KV = "\x01"
_TOMBSTONE = None  # memtable value for deletions


class LevelDbStore(FilerStore):
    name = "leveldb"

    def __init__(self, path: str = "filer.ldb",
                 wal_flush_entries: int = 4096, **_):
        self.dir = path
        os.makedirs(path, exist_ok=True)
        self.wal_flush_entries = wal_flush_entries
        self._lock = threading.RLock()
        self._mem: dict[str, Optional[str]] = {}
        self._seg_keys: list[str] = []
        self._seg_vals: list[str] = []
        self._load()
        self._wal = open(self._wal_path(), "a", encoding="utf-8")

    def _wal_path(self) -> str:
        return os.path.join(self.dir, "wal.log")

    def _seg_path(self) -> str:
        return os.path.join(self.dir, "segment.jsonl")

    def _load(self) -> None:
        # errors="replace": a torn-sector WAL tail after power loss can
        # hold arbitrary garbage bytes, which must read as a corrupt
        # line to skip (loudly) — not a UnicodeDecodeError that keeps
        # the whole store from opening
        seg = self._seg_path()
        if os.path.exists(seg):
            corrupt = 0
            with open(seg, encoding="utf-8", errors="replace") as f:
                for line in f:
                    try:
                        k, v = json.loads(line)
                    except ValueError:
                        corrupt += 1
                        continue
                    self._seg_keys.append(k)
                    self._seg_vals.append(v)
            if corrupt:
                # the segment holds ACKED (compaction-barrier) data —
                # only a pre-durable-writer segment can be torn, and
                # losing its keys must be loud
                self._warn_corrupt(seg, corrupt,
                                   "segment (acked data at risk)")
        wal = self._wal_path()
        if os.path.exists(wal):
            corrupt = 0
            with open(wal, encoding="utf-8", errors="replace") as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                        key = rec["k"]
                    except (ValueError, TypeError, KeyError):
                        corrupt += 1  # torn tail write: skip, keep rest
                        continue
                    self._mem[key] = rec.get("v")
            if corrupt:
                self._warn_corrupt(wal, corrupt, "WAL torn tail")

    @staticmethod
    def _warn_corrupt(path: str, corrupt: int, what: str) -> None:
        import logging
        logging.getLogger("filer.leveldb").warning(
            "%s: skipped %d corrupt line(s) after crash (%s)",
            path, corrupt, what)

    def _append_wal(self, key: str, value: Optional[str]) -> None:
        rec = {"k": key}
        if value is not None:
            rec["v"] = value
        self._wal.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._wal.flush()
        self._mem[key] = value
        if len(self._mem) >= self.wal_flush_entries:
            self._compact()

    def _compact(self) -> None:
        """Merge memtable into the sorted segment, reset the WAL."""
        merged: dict[str, str] = dict(zip(self._seg_keys, self._seg_vals))
        for k, v in self._mem.items():
            if v is None:
                merged.pop(k, None)
            else:
                merged[k] = v
        keys = sorted(merged)
        tmp = self._seg_path() + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for k in keys:
                f.write(json.dumps([k, merged[k]],
                                   separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())
        # the segment absorbs the WAL it is about to reset: an un-synced
        # segment rename + truncated WAL would drop every folded entry
        durable.replace_atomic(tmp, self._seg_path(), sync_file=False)
        self._seg_keys = keys
        self._seg_vals = [merged[k] for k in keys]
        self._mem.clear()
        self._wal.close()
        self._wal = open(self._wal_path(), "w", encoding="utf-8")

    # --- point ops ---
    def _get(self, key: str) -> Optional[str]:
        if key in self._mem:
            return self._mem[key]
        i = bisect.bisect_left(self._seg_keys, key)
        if i < len(self._seg_keys) and self._seg_keys[i] == key:
            return self._seg_vals[i]
        return None

    def insert_entry(self, entry: Entry) -> None:
        d, name = _split(entry.full_path)
        with self._lock:
            self._append_wal(f"{d}{_SEP}{name}", entry.to_json())

    update_entry = insert_entry

    def find_entry(self, path: str) -> Optional[Entry]:
        d, name = _split(path)
        if name == "/":
            return None
        with self._lock:
            v = self._get(f"{d}{_SEP}{name}")
        return Entry.from_json(v) if v is not None else None

    def delete_entry(self, path: str) -> None:
        d, name = _split(path)
        with self._lock:
            self._append_wal(f"{d}{_SEP}{name}", _TOMBSTONE)

    def delete_folder_children(self, path: str) -> None:
        path = path.rstrip("/") or "/"
        with self._lock:
            doomed = set()
            for k in list(self._mem):
                if self._key_under(k, path):
                    doomed.add(k)
            for k in self._seg_keys:
                if self._key_under(k, path):
                    doomed.add(k)
            for k in doomed:
                self._append_wal(k, _TOMBSTONE)

    @staticmethod
    def _key_under(key: str, path: str) -> bool:
        if key.startswith(_KV):
            return False
        d = key.split(_SEP, 1)[0]
        return d == path or (path != "/" and d.startswith(path + "/")) or \
            (path == "/" and d != "")

    # --- range scan ---
    def list_directory_entries(self, dir_path: str, start_file_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        dir_path = dir_path.rstrip("/") or "/"
        base = f"{dir_path}{_SEP}"
        with self._lock:
            # merge the two sorted views of the key range
            names: dict[str, Optional[str]] = {}
            # every child key is dir + "\x00" + name, so the range ends
            # before dir + "\x01" regardless of the name's code points
            lo = bisect.bisect_left(self._seg_keys, base)
            hi = bisect.bisect_left(self._seg_keys, dir_path + "\x01")
            for i in range(lo, hi):
                names[self._seg_keys[i][len(base):]] = self._seg_vals[i]
            for k, v in self._mem.items():
                if k.startswith(base):
                    names[k[len(base):]] = v
        out: list[Entry] = []
        for name in sorted(names):
            v = names[name]
            if v is None:
                continue
            if prefix and not name.startswith(prefix):
                continue
            if start_file_name:
                if include_start and name < start_file_name:
                    continue
                if not include_start and name <= start_file_name:
                    continue
            out.append(Entry.from_json(v))
            if len(out) >= limit:
                break
        return out

    def iter_directories(self):
        """The directories with a live child in the memtable or the
        segment, sorted (the ring handoff's walk; the reference's store
        cannot enumerate, ROADMAP Queue 3, D17)."""
        with self._lock:
            live: dict[str, bool] = {}
            for k, v in zip(self._seg_keys, self._seg_vals):
                live[k] = v is not None
            for k, v in self._mem.items():
                live[k] = v is not None
        dirs = {k.split(_SEP, 1)[0] for k, alive in live.items()
                if alive and not k.startswith(_KV) and _SEP in k}
        return iter(sorted(d for d in dirs if d))

    # --- kv face ---
    def kv_put(self, key: str, value: bytes) -> None:
        import base64
        with self._lock:
            self._append_wal(_KV + key, base64.b64encode(value).decode())

    def kv_get(self, key: str) -> Optional[bytes]:
        import base64
        with self._lock:
            v = self._get(_KV + key)
        return base64.b64decode(v) if v is not None else None

    def close(self) -> None:
        with self._lock:
            if not self._wal.closed:
                self._compact()
                self._wal.close()
