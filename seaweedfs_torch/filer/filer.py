"""Filer core: the directory/file namespace over the blob store.

The port's reduced copy of seaweedfs_tpu/filer/filer.py (upstream
weed/filer/filer.go, filer_delete_entry.go, filer_deletion.go,
filer_notify.go): CRUD with auto-created parent directories, a
read-through entry cache on the lookup path, recursive delete that hands
freed chunks to ``on_delete_chunks``, hard-link reference counts in the
store's KV face (shared chunks are freed with the last link), rename as
a store transaction (rolled back whole on failure), and a metadata event
log every mutation feeds: a bounded in-memory ring, optionally persisted
as JSON lines that either package replays, with subscribers (the
server's ``/__meta__/subscribe`` streams, the ring's parent-existence
cache) and one shared ndjson wire form per event. ``apply_event``
replays an event another filer applied (a stream's line), its
``signatures`` keeping loops out; ``create_entry(ensure_parents=False)``
leaves the ancestors to the filer ring, which creates each on its own
partition's owner.

Left out: the reference's ``WEED_FILER_ENTRY_CACHE_TTL`` knob (its 5 s
default is the argument's), with ``utils/config`` in slice 9.
"""

from __future__ import annotations

import json
import logging
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..cache import TTLCache
from .chunks import FileChunk
from .entry import Entry, new_directory
from .stores import FilerStore

log = logging.getLogger("filer")


@dataclass
class MetaEvent:
    """EventNotification (weed/pb/filer.proto): one namespace mutation.
    ``signatures`` carries the ids of every filer that already applied
    it (loop prevention of multi-filer sync)."""
    tsns: int
    directory: str
    old_entry: Optional[Entry]
    new_entry: Optional[Entry]
    delete_chunks: bool = False
    signatures: tuple[int, ...] = ()

    def to_dict(self) -> dict:
        return {
            "tsns": self.tsns,
            "directory": self.directory,
            "old": (json.loads(self.old_entry.to_json())
                    if self.old_entry else None),
            "new": (json.loads(self.new_entry.to_json())
                    if self.new_entry else None),
            "deleteChunks": self.delete_chunks,
            "signatures": list(self.signatures),
        }

    def wire(self) -> bytes:
        """The compact ndjson line, serialized once however many
        subscriber streams carry the event."""
        cached = getattr(self, "_wire", None)
        if cached is None:
            cached = json.dumps(self.to_dict(),
                                separators=(",", ":")).encode() + b"\n"
            self._wire = cached
        return cached

    @classmethod
    def from_dict(cls, d: dict) -> "MetaEvent":
        old = d.get("old")
        new = d.get("new")
        return cls(
            tsns=int(d["tsns"]),
            directory=d["directory"],
            old_entry=Entry.from_json(json.dumps(old)) if old else None,
            new_entry=Entry.from_json(json.dumps(new)) if new else None,
            delete_chunks=bool(d.get("deleteChunks", False)),
            signatures=tuple(d.get("signatures", ())))


class MetaLog:
    """Bounded in-memory event log with subscriber fan-out and optional
    on-disk persistence (the role of weed/util/log_buffer and
    filer_notify.go: a memory tail of ``CAPACITY`` events and a
    replayable persisted log)."""

    CAPACITY = 8192

    def __init__(self, persist_path: str = ""):
        self.persist_path = persist_path
        self._events: list[MetaEvent] = []
        self._lock = threading.Lock()
        self._subscribers: list[Callable[[MetaEvent], None]] = []
        self._persist_f = None
        if persist_path:
            os.makedirs(os.path.dirname(persist_path) or ".", exist_ok=True)
            self._persist_f = open(persist_path, "a", encoding="utf-8")

    def append(self, event: MetaEvent) -> None:
        with self._lock:
            self._events.append(event)
            if len(self._events) > self.CAPACITY:
                self._events = self._events[-self.CAPACITY:]
            if self._persist_f is not None:
                self._persist_f.write(
                    json.dumps(event.to_dict(), separators=(",", ":"))
                    + "\n")
                self._persist_f.flush()
            subs = list(self._subscribers)
        for fn in subs:
            try:
                fn(event)
            except Exception:
                log.exception("meta subscriber failed")

    def subscribe(self, fn: Callable[[MetaEvent], None]) -> None:
        """Call `fn(event)` after every append (on the appending
        thread)."""
        with self._lock:
            self._subscribers.append(fn)

    def unsubscribe(self, fn: Callable[[MetaEvent], None]) -> None:
        with self._lock:
            if fn in self._subscribers:
                self._subscribers.remove(fn)

    def read_persisted_since(self, tsns: int, prefix: str = "/"):
        """Replay the on-disk log lazily (ReadPersistedLogBuffer,
        weed/filer/filer_notify.go:103); a torn or foreign line is
        skipped."""
        if not self.persist_path or not os.path.exists(self.persist_path):
            return
        with open(self.persist_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    e = MetaEvent.from_dict(json.loads(line))
                except (ValueError, KeyError, TypeError):
                    continue
                if e.tsns > tsns and e.directory.startswith(prefix):
                    yield e

    def close(self) -> None:
        with self._lock:
            if self._persist_f is not None:
                self._persist_f.close()
                self._persist_f = None

    def events_since(self, tsns: int, prefix: str = "/") -> list[MetaEvent]:
        with self._lock:
            return [e for e in self._events
                    if e.tsns > tsns and e.directory.startswith(prefix)]


class Filer:
    def __init__(self, store: FilerStore,
                 on_delete_chunks: Optional[Callable[[list[FileChunk]],
                                                     None]] = None,
                 meta_log_path: str = "",
                 entry_cache_ttl: float = 5.0,
                 metrics=None):
        self.store = store
        self.meta_log = MetaLog(persist_path=meta_log_path)
        self.on_delete_chunks = on_delete_chunks or (lambda chunks: None)
        # a per-filer id stamped on every event (store "signature",
        # weed/filer/meta_aggregator.go)
        self.signature = random.getrandbits(31)
        self._lock = threading.RLock()
        # read-through entry cache on the lookup path: every mutation
        # through this Filer invalidates; the TTL bounds staleness from
        # anything that is not (<= 0 disables); negative lookups cache
        # too
        self._entry_cache = None
        if entry_cache_ttl > 0:
            self._entry_cache = TTLCache(ttl=entry_cache_ttl,
                                         max_entries=8192,
                                         metrics=metrics, name="entry")

    # --- CRUD ---
    def create_entry(self, entry: Entry, o_excl: bool = False,
                     signatures: tuple[int, ...] = (),
                     ensure_parents: bool = True) -> Entry:
        """Insert with parent auto-creation (Filer.CreateEntry,
        weed/filer/filer.go:119-186). ``ensure_parents=False`` skips it:
        in a ring each ancestor's entry belongs to its own partition's
        owner, which the ring creates it on."""
        with self._lock:
            if ensure_parents:
                self._ensure_parents(entry.parent)
            old = self.store.find_entry(entry.full_path)
            if old is not None:
                if o_excl:
                    raise FileExistsError(entry.full_path)
                if old.is_directory and not entry.is_directory:
                    raise IsADirectoryError(entry.full_path)
            self.store.insert_entry(entry)
            # hard links (filerstore_hardlink.go): a KV counter per link
            # id decides when shared chunks may be freed; an overwrite
            # that changes or clears the link id drops the old group's
            # reference
            if old is not None and old.hard_link_id and \
                    old.hard_link_id != entry.hard_link_id:
                self._bump_hardlink(old.hard_link_id, -1)
            if entry.hard_link_id and \
                    (old is None or old.hard_link_id != entry.hard_link_id):
                self._bump_hardlink(entry.hard_link_id, +1)
        self._notify(entry.parent, old, entry, signatures=signatures)
        return entry

    def freeable_replaced_chunks(self, old: Optional[Entry]
                                 ) -> list[FileChunk]:
        """Chunks of an overwritten entry that are safe to free: none
        while other hard links still reference them."""
        if old is None or not old.chunks:
            return []
        if old.hard_link_id:
            raw = self.store.kv_get(f"hardlink/{old.hard_link_id}")
            if raw and int(raw) > 0:
                return []
        return list(old.chunks)

    def _bump_hardlink(self, hlid: str, delta: int) -> int:
        key = f"hardlink/{hlid}"
        raw = self.store.kv_get(key)
        n = (int(raw) if raw else 0) + delta
        if n <= 0:
            # the KV face has no delete; zero means gone
            self.store.kv_put(key, b"0")
            return 0
        self.store.kv_put(key, str(n).encode())
        return n

    def _ensure_parents(self, dir_path: str) -> None:
        if dir_path in ("", "/"):
            return
        existing = self.store.find_entry(dir_path)
        if existing is not None:
            if not existing.is_directory:
                raise NotADirectoryError(dir_path)
            return
        parent = dir_path.rsplit("/", 1)[0] or "/"
        self._ensure_parents(parent)
        d = new_directory(dir_path)
        self.store.insert_entry(d)
        self._notify(parent, None, d)

    def update_entry(self, entry: Entry,
                     signatures: tuple[int, ...] = ()) -> Entry:
        with self._lock:
            old = self.store.find_entry(entry.full_path)
            if old is None:
                raise FileNotFoundError(entry.full_path)
            self.store.update_entry(entry)
            if old.hard_link_id and old.hard_link_id != entry.hard_link_id:
                self._bump_hardlink(old.hard_link_id, -1)
            if entry.hard_link_id and \
                    old.hard_link_id != entry.hard_link_id:
                self._bump_hardlink(entry.hard_link_id, +1)
        self._notify(entry.parent, old, entry, signatures=signatures)
        return entry

    _CACHE_MISS = object()

    def find_entry(self, path: str) -> Optional[Entry]:
        path = _norm(path)
        if path == "/":
            return new_directory("/")
        if self._entry_cache is None:
            return self.store.find_entry(path)
        hit = self._entry_cache.get(path, self._CACHE_MISS)
        if hit is not self._CACHE_MISS:
            return hit
        # snapshot the invalidation generation before the store read: a
        # value read while a mutation committed is not cached
        gen = self._entry_cache.generation
        entry = self.store.find_entry(path)
        self._entry_cache.put_if_fresh(path, entry, gen)
        return entry

    def list_directory(self, dir_path: str, start_file: str = "",
                       include_start: bool = False, limit: int = 1024,
                       prefix: str = "") -> list[Entry]:
        return self.store.list_directory_entries(
            _norm(dir_path), start_file, include_start, limit, prefix)

    # --- delete (recursive, chunk-freeing) ---
    def delete_entry(self, path: str, recursive: bool = False,
                     free_chunks: bool = True,
                     signatures: tuple[int, ...] = ()) -> None:
        """DeleteEntryMetaAndData (weed/filer/filer_delete_entry.go);
        free_chunks=False removes the metadata only."""
        path = _norm(path)
        entry = self.store.find_entry(path)
        if entry is None:
            raise FileNotFoundError(path)
        freed: list[FileChunk] = []
        with self._lock:
            if entry.is_directory:
                children = self.store.list_directory_entries(path, limit=2)
                if children and not recursive:
                    raise OSError(f"directory {path} not empty")
                # the walk always runs, so hard-link counters stay right
                # on metadata-only deletes too
                self._collect_chunks_recursive(path, freed)
                self.store.delete_folder_children(path)
                if self._entry_cache is not None:
                    # children vanish without events of their own
                    self._entry_cache.drop_prefix(path.rstrip("/") + "/")
            else:
                if entry.hard_link_id:
                    # shared chunks go with the last link
                    if self._bump_hardlink(entry.hard_link_id, -1) == 0:
                        freed.extend(entry.chunks)
                elif free_chunks:
                    freed.extend(entry.chunks)
            self.store.delete_entry(path)
        if freed and free_chunks:
            self.on_delete_chunks(freed)
        self._notify(entry.parent, entry, None, delete_chunks=bool(freed),
                     signatures=signatures)

    def _collect_chunks_recursive(self, dir_path: str,
                                  out: list[FileChunk]) -> None:
        start = ""
        while True:
            batch = self.store.list_directory_entries(dir_path, start,
                                                      limit=1024)
            if not batch:
                return
            for e in batch:
                if e.is_directory:
                    self._collect_chunks_recursive(e.full_path, out)
                elif e.hard_link_id:
                    if self._bump_hardlink(e.hard_link_id, -1) == 0:
                        out.extend(e.chunks)
                else:
                    out.extend(e.chunks)
            if len(batch) < 1024:
                return
            start = batch[-1].name

    # --- rename (AtomicRenameEntry,
    #     weed/server/filer_grpc_server_rename.go) ---
    def rename(self, old_path: str, new_path: str) -> None:
        old_path, new_path = _norm(old_path), _norm(new_path)
        with self._lock:
            entry = self.store.find_entry(old_path)
            if entry is None:
                raise FileNotFoundError(old_path)
            self.store.begin()
            try:
                self._move_recursive(entry, new_path)
                self.store.commit()
            except Exception:
                self.store.rollback()
                raise

    def _move_recursive(self, entry: Entry, new_path: str) -> None:
        old_path = entry.full_path
        if entry.is_directory:
            start = ""
            while True:
                batch = self.store.list_directory_entries(old_path, start,
                                                          limit=1024)
                if not batch:
                    break
                for child in batch:
                    self._move_recursive(
                        child, f"{new_path}/{child.name}")
                if len(batch) < 1024:
                    break
                start = batch[-1].name
        self.store.delete_entry(old_path)
        moved = Entry(full_path=new_path, attr=entry.attr,
                      chunks=entry.chunks, extended=entry.extended,
                      hard_link_id=entry.hard_link_id)
        self._ensure_parents(moved.parent)
        self.store.insert_entry(moved)
        self._notify(moved.parent, entry, moved)

    # --- events ---
    def _notify(self, directory: str, old: Optional[Entry],
                new: Optional[Entry], delete_chunks: bool = False,
                signatures: tuple[int, ...] = ()) -> None:
        moved_across = (old is not None and new is not None
                        and old.full_path != new.full_path)
        if self._entry_cache is not None:
            # every mutation passes here: drop both sides, negative
            # entries included
            if old is not None:
                self._entry_cache.pop(old.full_path)
                if moved_across and old.is_directory:
                    # cached descendants under the old path are stale
                    self._entry_cache.drop_prefix(
                        old.full_path.rstrip("/") + "/")
            if new is not None:
                self._entry_cache.pop(new.full_path)
        sigs = tuple(signatures) + (self.signature,)
        self.meta_log.append(MetaEvent(
            tsns=time.time_ns(), directory=directory,
            old_entry=old, new_entry=new, delete_chunks=delete_chunks,
            signatures=sigs))
        if moved_across and old.parent != new.parent:
            # a cross-directory move's event names the new parent only:
            # a metadata-only tombstone at the old parent tells
            # subscribers watching that prefix that the old path died
            self.meta_log.append(MetaEvent(
                tsns=time.time_ns(), directory=old.parent,
                old_entry=old, new_entry=None, delete_chunks=False,
                signatures=sigs))

    def apply_event(self, event: MetaEvent) -> bool:
        """Replay a mutation another filer applied
        (MetaAggregator.MaybeReplicateMetadataChange,
        weed/filer/meta_aggregator.go:31-207); False when skipped because
        this filer's signature is on it already."""
        if self.signature in event.signatures:
            return False
        sigs = event.signatures
        old, new = event.old_entry, event.new_entry
        if new is not None and old is not None \
                and old.full_path != new.full_path:
            # a rename: the old path goes metadata-only, the new upserts
            try:
                self.delete_entry(old.full_path, recursive=True,
                                  free_chunks=False, signatures=sigs)
            except FileNotFoundError:
                pass
            self.create_entry(new, signatures=sigs)
        elif new is not None:
            if self.store.find_entry(new.full_path) is None:
                self.create_entry(new, signatures=sigs)
            else:
                self.update_entry(new, signatures=sigs)
        elif old is not None:
            try:
                # the chunks belong to the origin: a replay never frees
                self.delete_entry(old.full_path, recursive=True,
                                  free_chunks=False, signatures=sigs)
            except FileNotFoundError:
                pass
        return True

    def close(self) -> None:
        self.meta_log.close()
        self.store.close()


def _norm(path: str) -> str:
    if not path.startswith("/"):
        path = "/" + path
    while "//" in path:
        path = path.replace("//", "/")
    return path.rstrip("/") or "/"
