"""WFS: the mount's virtual filesystem over a filer.

The port's copy of seaweedfs_tpu/mount/wfs.py. Mirrors
weed/filesys/wfs.go + file.go + dir.go + filehandle.go: a path-based
VFS with open-handle registry and write-back dirty pages. Kernel FUSE
glue (fuse_mount.py) calls these methods 1:1; every operation here is
also directly testable without a kernel, which is exactly how the
reference tests its mount internals (pure-logic tests only,
dirty_page_interval_test.go / fscache_test.go).

Write path (wfs_write.go + dirty_page.go): writes land in per-handle
ContinuousIntervals; when buffered bytes exceed the chunk size the largest
run flushes early; flush()/release() uploads the rest — each run becomes
one chunk via filer-proxied assign + volume server POST — then the entry
is saved with the merged chunk list.

Two open-handle cases differ from the reference (ROADMAP Queue 3):
``truncate`` of a path with open handles also trims each handle's dirty
pages and chunk list, so the handle's next flush cannot bring the cut
bytes back (D22); ``rename`` of a path with open handles moves them with
it, so their next flush saves the entry at the new path, not a new file
at the old one (D23).
"""

from __future__ import annotations

import http.client
import json
import os
import threading
import time
import urllib.error
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from ..cache import Singleflight, TieredChunkCache, TTLCache, shared_pool
from ..filer.assign_lease import AssignLeasePool
from .dirty_pages import ContinuousIntervals
from .meta_cache import MetaCache


class FuseError(OSError):
    def __init__(self, errno_: int, msg: str = ""):
        super().__init__(errno_, msg)


def _norm(path: str) -> str:
    path = "/" + path.strip("/")
    while "//" in path:
        path = path.replace("//", "/")
    return path


class FilerClient:
    """Thin sync HTTP client for the filer's meta + data endpoints.
    Intra-cluster requests ride pooled keep-alive connections; direct
    chunk reads go through a local chunk cache with singleflight so N
    threads re-reading one hot chunk cost one volume-server fetch."""

    def __init__(self, filer_url: str,
                 chunk_cache: Optional[TieredChunkCache] = None):
        self.filer = filer_url.rstrip("/")
        self._pool = shared_pool()
        self._vid_cache = TTLCache(ttl=60.0)
        self.chunk_cache = chunk_cache if chunk_cache is not None \
            else TieredChunkCache(max_bytes=32 * 1024 * 1024)
        self._read_flight = Singleflight("mount.read_chunk")
        # set after the first 401: subsequent chunk reads fetch the read
        # token up front instead of paying a guaranteed-401 round trip
        self._read_auth_needed = False
        self._fid_auth: dict[str, tuple[str, float]] = {}
        # bulk fid lease over the filer's assign proxy: flush fan-outs
        # draw N write targets from one /__meta__/assign?count=N trip
        self._lease = AssignLeasePool(self._assign_fetch)

    def _get_json(self, path_qs: str) -> Optional[dict]:
        r = self._pool.request("GET", f"http://{self.filer}{path_qs}",
                               timeout=60)
        if r.status == 404:
            return None
        if r.status >= 400:
            raise urllib.error.HTTPError(
                f"http://{self.filer}{path_qs}", r.status, "filer error",
                None, None)
        return r.json()

    def lookup(self, path: str) -> Optional[dict]:
        return self._get_json("/__meta__/lookup?"
                              + urllib.parse.urlencode({"path": path}))

    def list_dir(self, path: str, limit: int = 100000) -> list[dict]:
        out = self._get_json("/__meta__/list?" + urllib.parse.urlencode(
            {"dir": path, "limit": str(limit)}))
        return out.get("entries", []) if out else []

    def _post(self, path_qs: str, body: Optional[bytes] = None) -> None:
        headers = {"Content-Type": "application/json"} if body else {}
        r = self._pool.request("POST", f"http://{self.filer}{path_qs}",
                               body=body, headers=headers, timeout=60)
        if r.status >= 400:
            raise IOError(f"POST {path_qs}: HTTP {r.status} "
                          f"{r.data[:200]!r}")

    def create_entry(self, entry: dict, free_old_chunks: bool = True) -> None:
        self._post("/__meta__/create_entry",
                   json.dumps({"entry": entry,
                               "free_old_chunks": free_old_chunks}).encode())

    def update_entry(self, entry: dict) -> None:
        self._post("/__meta__/update_entry",
                   json.dumps({"entry": entry}).encode())

    def delete(self, path: str, recursive: bool = False) -> None:
        self._post("/__meta__/delete",
                   json.dumps({"path": path,
                               "recursive": recursive}).encode())

    def rename(self, old: str, new: str) -> None:
        self._post(urllib.parse.quote(old) + "?"
                   + urllib.parse.urlencode({"mv.to": new}))

    def _assign_fetch(self, params: dict, count: int) -> dict:
        """Lease refill: one real assignment through the filer proxy
        (?count=N reaches the master's bulk path)."""
        p = dict(params)
        if count > 1:
            p["count"] = str(count)
        qs = urllib.parse.urlencode(p)
        out = self._get_json("/__meta__/assign" + (f"?{qs}" if qs else ""))
        if out is None or "error" in out:
            raise IOError(f"assign failed: {out}")
        return out

    def assign(self, collection: str = "", replication: str = "",
               ttl: str = "") -> dict:
        """One write target from the bulk lease (zero round trips while
        the lease is live)."""
        return self._lease.get(collection, replication, ttl)

    def assign_direct(self, collection: str = "", replication: str = "",
                      ttl: str = "") -> dict:
        """A genuinely fresh master assignment: direct=true makes the
        filer proxy bypass ITS lease pool too (which may still hold fids
        on the volume whose failure triggered this retry)."""
        params = {k: v for k, v in (("collection", collection),
                                    ("replication", replication),
                                    ("ttl", ttl),
                                    ("direct", "true")) if v}
        return self._assign_fetch(params, 1)

    def upload_chunk(self, assign: dict, data: bytes) -> None:
        headers = {"Content-Type": "application/octet-stream"}
        if assign.get("auth"):
            headers["Authorization"] = f"BEARER {assign['auth']}"
        try:
            r = self._pool.request(
                "POST", f"http://{assign['url']}/{assign['fid']}",
                body=data, headers=headers, timeout=300)
        except (OSError, http.client.HTTPException):
            # conn refused / breaker open: this volume is a bad target
            self._lease.invalidate(assign["fid"])
            raise
        if r.status in (404, 409):
            # volume gone or sealed read-only: the lease is stale
            self._lease.invalidate(assign["fid"])
        if r.status >= 300:
            raise IOError(f"upload {assign['fid']}: HTTP {r.status}")

    def delete_blob(self, assign: dict) -> None:
        """Best-effort delete of one assigned blob (the retry path's
        reap: a failed POST may still have landed on the server)."""
        headers = ({"Authorization": f"BEARER {assign['auth']}"}
                   if assign.get("auth") else {})
        try:
            self._pool.request(
                "DELETE", f"http://{assign['url']}/{assign['fid']}",
                headers=headers, timeout=30)
        except (OSError, http.client.HTTPException):
            pass

    def read_range(self, path: str, offset: int, size: int) -> bytes:
        r = self._pool.request(
            "GET", f"http://{self.filer}" + urllib.parse.quote(path),
            headers={"Range": f"bytes={offset}-{offset + size - 1}"},
            timeout=300)
        if r.status in (404, 416):
            return b""
        if r.status >= 400:
            raise IOError(f"read {path}: HTTP {r.status}")
        data = r.data
        if r.status == 200:
            data = data[offset:offset + size]
        return data

    def lookup_volume(self, vid: int) -> list[str]:
        cached = self._vid_cache.get(vid)
        if cached:
            return cached
        out = self._get_json(f"/__meta__/lookup_volume?volumeId={vid}")
        urls = [loc["url"] for loc in (out or {}).get("locations", [])]
        if urls:
            self._vid_cache.put(vid, urls)
        return urls

    def _cache_fid_auth(self, fid: str, auth: str) -> None:
        """Bounded short-TTL token cache: fids are unbounded on a
        long-lived mount, so stale entries are swept when the cache
        grows instead of leaking forever."""
        now = time.time()
        if len(self._fid_auth) >= 4096:
            self._fid_auth = {f: (a, ts) for f, (a, ts)
                              in self._fid_auth.items() if now - ts < 30.0}
            if len(self._fid_auth) >= 4096:
                self._fid_auth.clear()
        self._fid_auth[fid] = (auth, now)

    def lookup_fid_with_auth(self, fid: str) -> tuple[list[str], str]:
        """Per-fid lookup via the filer — returns (urls, read_jwt); the
        filer passes through the master's read token when a read key is
        configured."""
        out = self._get_json("/__meta__/lookup_volume?"
                             + urllib.parse.urlencode({"fileId": fid}))
        urls = [loc["url"] for loc in (out or {}).get("locations", [])]
        return urls, (out or {}).get("auth", "")

    def read_chunk(self, fid: str, offset_in_chunk: int, size: int) -> bytes:
        """Fetch a sub-range of one chunk straight from a volume server —
        used for handle-local chunks the filer doesn't know about yet.
        Cached per view, and N concurrent readers of one cold view
        coalesce into one backend fetch."""
        key = f"{fid}@{offset_in_chunk}:{size}"
        cached = self.chunk_cache.get(key)
        if cached is not None:
            return cached

        def fetch() -> bytes:
            data = self._read_chunk_backend(fid, offset_in_chunk, size)
            self.chunk_cache.put(key, data)
            return data

        return self._read_flight.do(key, fetch)

    def _read_chunk_backend(self, fid: str, offset_in_chunk: int,
                            size: int) -> bytes:
        """One volume-server round trip (pooled); falls back to a per-fid
        read-jwt lookup on 401."""
        vid = int(fid.split(",")[0])
        last: Optional[Exception] = None
        urls, auth = self.lookup_volume(vid), ""
        if self._read_auth_needed:
            cached = self._fid_auth.get(fid)
            if cached and time.time() - cached[1] < 30.0:
                auth = cached[0]
            else:
                fid_urls, auth = self.lookup_fid_with_auth(fid)
                urls = fid_urls or urls
                if auth:
                    self._cache_fid_auth(fid, auth)
        for attempt in range(2):
            denied = False
            for url in urls:
                headers = {"Range": f"bytes={offset_in_chunk}-"
                                    f"{offset_in_chunk + size - 1}"}
                if auth:
                    headers["Authorization"] = f"BEARER {auth}"
                try:
                    r = self._pool.request("GET", f"http://{url}/{fid}",
                                           headers=headers, timeout=300)
                except Exception as e:
                    last = e
                    self._vid_cache.pop(vid)
                    continue
                if r.status in (200, 206):
                    data = r.data
                    if r.status == 200:
                        data = data[offset_in_chunk:
                                    offset_in_chunk + size]
                    return data
                last = IOError(f"{url}/{fid}: HTTP {r.status}")
                if r.status == 401 and attempt == 0:
                    denied = True
                    break  # acquire a read token and retry
            if denied:
                self._read_auth_needed = True
                fid_urls, auth = self.lookup_fid_with_auth(fid)
                urls = fid_urls or urls
                if auth:
                    self._cache_fid_auth(fid, auth)
                continue
            break
        raise IOError(f"read chunk {fid}: {last}")


class FileHandle:
    """One open file: read-through + write-back dirty pages
    (weed/filesys/filehandle.go + dirty_page.go)."""

    def __init__(self, wfs: "WFS", path: str, entry: dict,
                 flags_write: bool = True):
        self.wfs = wfs
        self.path = path
        self.entry = entry
        self.dirty = ContinuousIntervals()
        self.flags_write = flags_write
        self._lock = threading.Lock()
        self.ref_count = 1
        # True while the handle holds early-flushed chunks the filer
        # doesn't know about yet; reads then use the handle's chunk view
        self._has_local_chunks = False

    # --- size helpers ---
    def _entry_size(self) -> int:
        chunks = self.entry.get("chunks", [])
        return max((c["offset"] + c["size"] for c in chunks), default=0)

    def size(self) -> int:
        return max(self._entry_size(), self.dirty.total_size())

    # --- io ---
    def write(self, data: bytes, offset: int) -> int:
        if not self.flags_write:
            raise FuseError(9, "handle not open for write")  # EBADF
        with self._lock:
            self.dirty.add_interval(data, offset)
            if self.dirty.buffered_bytes() >= self.wfs.chunk_size:
                self._flush_largest_locked()
        return len(data)

    def read(self, size: int, offset: int) -> bytes:
        with self._lock:
            dirty_data, mask = self.dirty.read_data_at(size, offset)
        file_size = self.size()
        if offset >= file_size:
            return b""
        size = min(size, file_size - offset)
        if all(mask[:size]):
            return dirty_data[:size]
        # Mid-write (handle holds early-flushed chunks the filer doesn't
        # know about yet): serve non-dirty ranges from the handle's own
        # chunk list so read-your-writes holds between an auto-flush and
        # flush() without persisting intermediate entries cluster-wide
        # (the reference likewise reads via the handle's chunk view,
        # weed/filesys/filehandle.go). Otherwise read through the filer
        # path, which stays fresh w.r.t. writes by other clients.
        buf = bytearray(size)
        if self._entry_size() > offset:
            if self._has_local_chunks:
                from ..filer.chunks import FileChunk as FC, read_plan
                chunks = [FC.from_dict(c)
                          for c in self.entry.get("chunks", [])]
                for view in read_plan(chunks, offset, size):
                    data = self.wfs.client.read_chunk(
                        view.fid, view.offset_in_chunk, view.size)
                    pos = view.logic_offset - offset
                    buf[pos:pos + len(data)] = data
            else:
                remote = self.wfs.client.read_range(self.path, offset, size)
                buf[:len(remote)] = remote
        for i in range(size):
            if mask[i]:
                buf[i] = dirty_data[i]
        return bytes(buf)

    # --- flush ---
    def _upload_interval(self, iv) -> dict:
        client = self.wfs.client
        a = client.assign(self.wfs.collection, self.wfs.replication)
        try:
            client.upload_chunk(a, iv.data)
        except (OSError, http.client.HTTPException):
            # the leased target failed (upload_chunk already invalidated
            # the lease): best-effort reap of the fid (the POST may have
            # landed before the error) and retry once against a fresh
            # direct assignment — a new fid, so the re-POST can't
            # double-write
            client.delete_blob(a)
            a = client.assign_direct(self.wfs.collection,
                                     self.wfs.replication)
            client.upload_chunk(a, iv.data)
        return {"fid": a["fid"], "offset": iv.start, "size": len(iv.data),
                "mtime": time.time_ns(), "etag": ""}

    def _upload_intervals(self, ivs: list) -> tuple[list[dict],
                                                    Optional[Exception]]:
        """Fan dirty-run uploads through the mount's bounded upload
        window (same WEED_FILER_UPLOAD_CONCURRENCY knob as the filer's
        pipelined PUT). Returns (successful chunks in interval order,
        first error): the caller must KEEP the successes even on partial
        failure — the intervals are already popped from the dirty set,
        so dropping a landed chunk would silently lose its bytes."""
        if len(ivs) <= 1:
            try:
                return [self._upload_interval(iv) for iv in ivs], None
            except Exception as e:
                return [], e
        futures = [self.wfs.flush_pool.submit(self._upload_interval, iv)
                   for iv in ivs]
        results, first_err = [], None
        for f in futures:
            try:
                results.append(f.result())
            except Exception as e:
                first_err = first_err or e
        return results, first_err

    def _flush_largest_locked(self) -> None:
        # early-flushed chunks stay handle-local until flush(); read()
        # serves them from the handle's chunk list, so mid-write state
        # is never visible cluster-wide
        iv = self.dirty.pop_largest_contiguous()
        if iv is not None:
            self.entry.setdefault("chunks", []).append(
                self._upload_interval(iv))
            self._has_local_chunks = True

    def flush(self) -> None:
        """Upload remaining dirty runs and save the entry
        (FileHandle.Flush, filehandle.go)."""
        with self._lock:
            results, err = self._upload_intervals(self.dirty.pop_all())
            # landed chunks join the entry even when a sibling failed:
            # a later flush()/release() then saves them (the old serial
            # loop appended each success before the failure, same
            # guarantee)
            self.entry.setdefault("chunks", []).extend(results)
            if err is not None:
                self._has_local_chunks = self._has_local_chunks \
                    or bool(results)
                raise err
            self.entry.setdefault("attr", {})["mtime"] = time.time()
            self.wfs.client.create_entry(self.entry, free_old_chunks=False)
            self._has_local_chunks = False
            self.wfs.meta_cache.invalidate(self.path)

    def release(self) -> None:
        self.flush()

    def truncate(self, length: int) -> None:
        """Drop buffered and flushed bytes past `length`."""
        with self._lock:
            self.dirty.truncate(length)
            self.entry["chunks"] = _trim_chunks(
                self.entry.get("chunks", []), length)

    def move_to(self, path: str) -> None:
        with self._lock:
            self.path = path
            self.entry = dict(self.entry, path=path)


def _trim_chunks(chunks: list, length: int) -> list:
    """The chunks of an entry cut at `length`: those past it dropped,
    the one across it shortened."""
    kept = []
    for c in chunks:
        if c["offset"] >= length:
            continue
        c = dict(c)
        c["size"] = min(c["size"], length - c["offset"])
        kept.append(c)
    return kept


class WFS:
    """The filesystem: path ops + open-handle registry (wfs.go:77)."""

    def __init__(self, filer_url: str, collection: str = "",
                 replication: str = "", chunk_size: int = 8 * 1024 * 1024,
                 cache_ttl: float = 60.0, subscribe: bool = False):
        self.client = FilerClient(filer_url)
        self.collection = collection
        self.replication = replication
        self.chunk_size = chunk_size
        self.meta_cache = MetaCache(ttl=cache_ttl)
        self.handles: dict[int, FileHandle] = {}
        self._next_fh = 1
        self._lock = threading.Lock()
        # bounded window for flush fan-out: dirty-run chunk uploads from
        # one handle overlap instead of paying their latencies end to end
        workers = max(1, int(os.environ.get(
            "WEED_FILER_UPLOAD_CONCURRENCY", "") or 4))
        self.flush_pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="wfs-flush")
        if subscribe:
            self.meta_cache.start_subscriber(filer_url)

    # --- lookup / attr ---
    def lookup(self, path: str) -> Optional[dict]:
        path = _norm(path)
        hit = self.meta_cache.get(path)
        if hit is not None:
            return hit[0]
        entry = self.client.lookup(path)
        self.meta_cache.put(path, entry)
        return entry

    def getattr(self, path: str) -> dict:
        entry = self.lookup(path)
        if entry is None:
            raise FuseError(2, path)  # ENOENT
        attr = entry.get("attr", {})
        size = max(
            (c["offset"] + c["size"] for c in entry.get("chunks", [])),
            default=0)
        # open write handles know a newer size
        for fh in self.handles.values():
            if fh.path == _norm(path):
                size = max(size, fh.size())
        return {"mode": attr.get("mode", 0o660), "size": size,
                "mtime": attr.get("mtime", 0), "uid": attr.get("uid", 0),
                "gid": attr.get("gid", 0)}

    def readdir(self, path: str) -> list[str]:
        path = _norm(path)
        entry = self.lookup(path)
        if entry is None:
            raise FuseError(2, path)
        listing = self.meta_cache.get_listing(path)
        if listing is None:
            listing = self.client.list_dir(path)
            self.meta_cache.put_listing(path, listing)
        return [e["path"].rsplit("/", 1)[-1] for e in listing]

    # --- file lifecycle ---
    def create(self, path: str, mode: int = 0o660) -> int:
        path = _norm(path)
        entry = {"path": path,
                 "attr": {"mode": mode, "mtime": time.time(),
                          "crtime": time.time(), "uid": 0, "gid": 0,
                          "mime": "application/octet-stream"},
                 "chunks": []}
        self.client.create_entry(entry)
        self.meta_cache.invalidate(path)
        return self._open_handle(path, entry)

    def open(self, path: str, for_write: bool = False) -> int:
        path = _norm(path)
        entry = self.lookup(path)
        if entry is None:
            raise FuseError(2, path)
        return self._open_handle(path, dict(entry), for_write)

    def _open_handle(self, path: str, entry: dict,
                     for_write: bool = True) -> int:
        with self._lock:
            fh = self._next_fh
            self._next_fh += 1
            self.handles[fh] = FileHandle(self, path, entry, for_write)
            return fh

    def write(self, fh: int, data: bytes, offset: int) -> int:
        return self._handle(fh).write(data, offset)

    def read(self, fh: int, size: int, offset: int) -> bytes:
        return self._handle(fh).read(size, offset)

    def flush(self, fh: int) -> None:
        self._handle(fh).flush()

    def release(self, fh: int) -> None:
        with self._lock:
            handle = self.handles.pop(fh, None)
        if handle is not None:
            handle.release()

    def _handle(self, fh: int) -> FileHandle:
        h = self.handles.get(fh)
        if h is None:
            raise FuseError(9, f"bad handle {fh}")  # EBADF
        return h

    # --- namespace ops ---
    def mkdir(self, path: str, mode: int = 0o770) -> None:
        path = _norm(path)
        entry = {"path": path,
                 "attr": {"mode": 0o040000 | (mode & 0o777),
                          "mtime": time.time(), "crtime": time.time()},
                 "chunks": []}
        self.client.create_entry(entry)
        self.meta_cache.invalidate(path)

    def unlink(self, path: str) -> None:
        path = _norm(path)
        if self.lookup(path) is None:
            raise FuseError(2, path)
        self.client.delete(path)
        self.meta_cache.invalidate(path)

    def rmdir(self, path: str) -> None:
        path = _norm(path)
        if self.client.list_dir(path, limit=1):
            raise FuseError(39, path)  # ENOTEMPTY
        self.client.delete(path, recursive=True)
        self.meta_cache.invalidate(path)

    def rename(self, old: str, new: str) -> None:
        old, new = _norm(old), _norm(new)
        self.client.rename(old, new)
        # open handles follow their file (D23)
        for fh in self._handles_of(old):
            fh.move_to(new)
        self.meta_cache.invalidate(old)
        self.meta_cache.invalidate(new)

    def _handles_of(self, path: str) -> list[FileHandle]:
        with self._lock:
            return [h for h in self.handles.values() if h.path == path]

    def truncate(self, path: str, length: int) -> None:
        """ftruncate semantics: drop/trim chunks past length
        (file.go Setattr size change), in the filer's entry and in every
        open handle of the path (D22)."""
        path = _norm(path)
        entry = self.lookup(path)
        if entry is None:
            raise FuseError(2, path)
        entry = dict(entry)
        entry["chunks"] = _trim_chunks(entry.get("chunks", []), length)
        for fh in self._handles_of(path):
            fh.truncate(length)
        self.client.create_entry(entry)
        self.meta_cache.invalidate(path)

    # --- extended attributes (weed/filesys/xattr.go; stored in the
    #     entry's extended map) ---
    def setxattr(self, path: str, name: str, value: bytes) -> None:
        import base64
        path = _norm(path)
        entry = self.lookup(path)
        if entry is None:
            raise FuseError(2, path)
        entry = dict(entry)
        extended = dict(entry.get("extended") or {})
        extended["xattr-" + name] = base64.b64encode(value).decode()
        entry["extended"] = extended
        self.client.update_entry(entry)
        self.meta_cache.invalidate(path)

    def getxattr(self, path: str, name: str) -> bytes:
        import base64
        entry = self.lookup(_norm(path))
        if entry is None:
            raise FuseError(2, path)
        raw = (entry.get("extended") or {}).get("xattr-" + name)
        if raw is None:
            raise FuseError(61, name)  # ENODATA
        return base64.b64decode(raw)

    def listxattr(self, path: str) -> list[str]:
        entry = self.lookup(_norm(path))
        if entry is None:
            raise FuseError(2, path)
        return [k[len("xattr-"):] for k in (entry.get("extended") or {})
                if k.startswith("xattr-")]

    def removexattr(self, path: str, name: str) -> None:
        path = _norm(path)
        entry = self.lookup(path)
        if entry is None:
            raise FuseError(2, path)
        extended = dict(entry.get("extended") or {})
        if extended.pop("xattr-" + name, None) is None:
            raise FuseError(61, name)
        entry = dict(entry)
        entry["extended"] = extended
        self.client.update_entry(entry)
        self.meta_cache.invalidate(path)

    # --- hard links (weed/filer/filerstore_hardlink.go: linked entries
    #     share a hard_link_id and the chunk list rides it) ---
    def link(self, target: str, link_path: str) -> None:
        target, link_path = _norm(target), _norm(link_path)
        entry = self.lookup(target)
        if entry is None:
            raise FuseError(2, target)
        if entry.get("attr", {}).get("mode", 0) & 0o040000:
            raise FuseError(1, "cannot hardlink directories")  # EPERM
        entry = dict(entry)
        hlid = entry.get("hard_link_id")
        if not hlid:
            import uuid as uuid_mod
            hlid = uuid_mod.uuid4().hex
            entry["hard_link_id"] = hlid
            self.client.update_entry(entry)
        link_entry = dict(entry)
        link_entry["path"] = link_path
        self.client.create_entry(link_entry, free_old_chunks=False)
        self.meta_cache.invalidate(link_path)
        self.meta_cache.invalidate(target)

    def statfs(self) -> dict:
        return {"bsize": 1024 * 1024, "blocks": 1 << 30, "bfree": 1 << 30}

    def destroy(self) -> None:
        for fh in list(self.handles):
            self.release(fh)
        self.meta_cache.stop()
        self.flush_pool.shutdown(wait=False)
