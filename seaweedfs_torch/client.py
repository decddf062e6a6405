"""Synchronous client: assign, lookup, upload, download, delete, vacuum,
admin.

The port's reduced copy of seaweedfs_tpu/client.py (upstream
weed/operation/: Assign, Lookup, Upload, DeleteFiles; the wdclient vid
cache), on ``http.client`` through server/http.py's keep-alive
connections. Used by the shell commands, the CLI and the tests. An
upload to a replicated volume goes to the assigned holder, which fans
it out; a download tries every holder the master lists, or reads from
one named holder (``download(fid, url=...)``).

Every call carries the ambient deadline budget (``X-Seaweed-Deadline``,
utils/retry.py) and caps its socket timeout to it. ``Client`` takes the
master, or an HA group's comma list, and follows the reference's failure
discipline (seaweedfs_tpu/client.py:67-161). With one master a
connection error is retried once after a ``RetryPolicy`` backoff, and a
shed answer (429/503 with ``X-Seaweed-Shed: 1``) once after its
``Retry-After`` (capped at 5 s); any other 429/502/503/504 is an error.
With a list, a connection error or any 429/502/503/504 (a follower with
no leader answers 503 "no leader elected", a leader that lost its term
503) moves to the next master, with a backoff after each full round, for
four rounds. The admin lease (``AdminLock``) and its renewals go through
the same rotation; a renewal that lands on a new leader hands it the
lease's token, which it adopts. With ``replica_masters`` (else
``WEED_GEO_REPLICA_MASTERS``), a second cluster's master list, a
download whose primary cluster is unreachable (every master or every
holder failed to connect) is served by that cluster and
``last_read_stale`` is set (the geo plane's read failover,
seaweedfs_tpu/client.py:356-420); an answer from a healthy primary, a
404 among them, never fails over, and failover is one hop: the
replica's client has no replica of its own (ROADMAP Queue 3, D26). Left
out: the bulk-assignment lease pool, the shared connection pool with its
circuit breaker, the watch stream and the leader hints it pushes, JWTs
and batch delete. ``query`` posts each holder's share of the fids to its
``/admin/query`` and gathers the NDJSON answers. The volume tail
(``tail_volume``) streams on a connection of its own.
"""

from __future__ import annotations

import http.client as http_client
import json
import os
import threading
import time
import urllib.parse
import uuid
from typing import Optional

from .server import http
from .utils.retry import (RETRYABLE_STATUSES, RetryPolicy, cap_timeout,
                          inject_deadline, is_shed, parse_retry_after)


class ClientError(RuntimeError):
    pass


class ClientUnreachable(ClientError):
    """The whole primary cluster is unreachable (every master failed, or
    every holder refused the connection): the condition geo read failover
    answers. An authoritative negative answer (HTTP 404, 'volume not
    found') from a healthy cluster is a plain ClientError and never fails
    over: serving deleted data from the replica would resurrect it."""


# connection errors worth a holder or master rotation
_CONN_ERRORS = (OSError, http_client.HTTPException)


def _request(method: str, url: str, body: Optional[bytes] = None,
             headers: Optional[dict] = None,
             timeout: float = 30.0) -> http.ClientResponse:
    """One call with the ambient deadline budget: its remaining seconds
    ride the deadline header, and the socket timeout is capped to it."""
    return http.request(method, url, body, inject_deadline(dict(
        headers or {})), cap_timeout(timeout))


def _get_json(url: str, timeout: float = 30.0) -> dict:
    r = _request("GET", url, timeout=timeout)
    try:
        return r.json()
    except ValueError:
        raise ClientError(f"GET {url}: HTTP {r.status}")


def _post_json(url: str, body: dict, timeout: float = 300.0) -> dict:
    status, detail = http.post_json(url, body, cap_timeout(timeout),
                                    headers=inject_deadline({}))
    if status >= 400:
        raise ClientError(f"POST {url}: {detail.get('error')}")
    return detail


class _VidCache:
    """vid -> holder urls, each entry kept for `ttl` seconds."""

    def __init__(self, ttl: float = 60.0):
        self.ttl = ttl
        self._d: dict[int, tuple[list[str], float]] = {}
        self._lock = threading.Lock()

    def get(self, vid: int) -> Optional[list[str]]:
        with self._lock:
            hit = self._d.get(vid)
            if hit is None or time.monotonic() - hit[1] > self.ttl:
                return None
            return hit[0]

    def put(self, vid: int, urls: list[str]) -> None:
        with self._lock:
            self._d[vid] = (urls, time.monotonic())

    def pop(self, vid: int) -> None:
        with self._lock:
            self._d.pop(vid, None)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()


class AdminLock:
    """The master's cluster-exclusive admin lease, held for a block and
    renewed in the background (upstream
    wdclient/exclusive_locks/exclusive_locker.go): the shell's commands
    that move volumes run under it, and the master's daemons launch
    nothing while it is held. Re-entrant: a command that calls another
    takes it once. A lock another client holds is waited for up to
    ``WAIT_SECONDS``, then the command fails. Its calls go through the
    client's master rotation, so the lease follows the leader."""

    NAME = "admin"
    RENEW_SECONDS = 3.0     # the master's lease is 10 s
    WAIT_SECONDS = 60.0

    def __init__(self, client: "Client"):
        self.client = client
        self.owner = f"shell-{uuid.uuid4().hex[:8]}"
        self._mu = threading.Lock()
        self._depth = 0
        self._token = 0
        self._stop = threading.Event()
        self._renewer: Optional[threading.Thread] = None

    def _lease(self, previous: int) -> dict:
        # a fresh lease may wait up to 30 s on the master for the
        # daemons' jobs in flight
        return self.client._master_post(
            "/cluster/lock", {"name": self.NAME, "client": self.owner,
                              "previous_token": previous}, timeout=60.0)

    def __enter__(self) -> "AdminLock":
        with self._mu:
            self._depth += 1
            if self._depth > 1:
                return self
            deadline = time.monotonic() + self.WAIT_SECONDS
            while True:
                try:
                    self._token = self._lease(0)["token"]
                    break
                except ClientError:
                    if time.monotonic() >= deadline:
                        self._depth -= 1
                        raise
                    time.sleep(0.5)
            self._stop = threading.Event()
            self._renewer = threading.Thread(
                target=self._renew, args=(self._stop,), daemon=True,
                name="admin-lock-renew")
            self._renewer.start()
        return self

    def _renew(self, stop: threading.Event) -> None:
        while not stop.wait(self.RENEW_SECONDS):
            try:
                self._token = self._lease(self._token)["token"]
            except (ClientError, OSError):
                # a missed renewal: the next one may land in time
                pass

    def __exit__(self, *exc) -> None:
        with self._mu:
            self._depth -= 1
            if self._depth:
                return
            self._stop.set()
            if self._renewer is not None:
                self._renewer.join()
                self._renewer = None
            token, self._token = self._token, 0
        try:
            self.client._master_post("/cluster/unlock",
                                     {"name": self.NAME, "token": token},
                                     timeout=30.0)
        except (ClientError, OSError):
            # the lease ends by itself
            pass


class Client:
    # full rounds of an HA list before a call fails
    ROUNDS = 4

    def __init__(self, master_url: str,
                 replica_masters: Optional[str] = ""):
        # one master, or an HA group's comma list
        self.masters = [m.strip().rstrip("/") for m in master_url.split(",")
                        if m.strip()]
        # geo read failover: a second CLUSTER's master list (not more HA
        # peers of this one); "" reads WEED_GEO_REPLICA_MASTERS, None
        # means no replica at all
        self._replica_masters = "" if replica_masters is None else (
            replica_masters or os.environ.get("WEED_GEO_REPLICA_MASTERS",
                                              ""))
        self._replica_client: Optional["Client"] = None
        # True when the last download() was answered by the replica
        # cluster: correct up to the replication lag, not read-your-writes
        self.last_read_stale = False
        self._master_i = 0
        self._vid_cache = _VidCache(ttl=60.0)
        self.admin_lock = AdminLock(self)
        self._retry = RetryPolicy(base_delay=0.1, max_delay=1.0)

    @property
    def master(self) -> str:
        """The master calls go to now."""
        return self.masters[self._master_i]

    def _after_failure(self, attempt: int) -> None:
        """One master: back off. A list: the next master, and a backoff
        after each full round."""
        n = len(self.masters)
        if n == 1:
            time.sleep(self._retry.backoff(attempt))
            return
        self._master_i = (self._master_i + 1) % n
        if (attempt + 1) % n == 0:
            time.sleep(self._retry.backoff(attempt // n))

    def _master_call(self, method: str, path_qs: str,
                     body: Optional[dict] = None,
                     timeout: float = 30.0) -> http.ClientResponse:
        """One call to the master under the failure discipline above;
        the answer of the first master that gives one that is neither a
        connection error nor a retryable status."""
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"} if data else None
        ha = len(self.masters) > 1
        attempts = self.ROUNDS * len(self.masters) if ha else 2
        last: Optional[Exception] = None
        for attempt in range(attempts):
            final = attempt == attempts - 1
            try:
                r = _request(method, f"http://{self.master}{path_qs}",
                             data, headers, timeout=timeout)
            except OSError as e:
                if final:
                    if ha:
                        raise ClientUnreachable(f"all masters failed: {e}")
                    raise
                last = e
                self._after_failure(attempt)
                continue
            if r.status not in RETRYABLE_STATUSES:
                return r
            last = ClientError(f"master {self.master}: HTTP {r.status} "
                               f"{r.data[:200]!r}")
            if final:
                raise (ClientUnreachable(f"all masters failed: {last}")
                       if ha else last)
            if ha:
                # a shed master is alive but busy: another is idle
                if is_shed(r.status, r.headers):
                    self._master_i = (self._master_i + 1) % len(self.masters)
                else:
                    self._after_failure(attempt)
                continue
            if not is_shed(r.status, r.headers):
                raise last
            # the one master is alive and asked for a pause
            delay = parse_retry_after(r.headers.get("Retry-After"))
            time.sleep(min(delay if delay is not None
                           else self._retry.backoff(attempt), 5.0))
        raise ClientError(f"master call failed: {last}")

    def _master_get(self, path_qs: str, timeout: float = 30.0) -> dict:
        r = self._master_call("GET", path_qs, timeout=timeout)
        try:
            return r.json()
        except ValueError:
            raise ClientError(f"GET {self.master}{path_qs}: HTTP {r.status}")

    def _master_post(self, path: str, body: dict,
                     timeout: float = 300.0) -> dict:
        r = self._master_call("POST", path, body, timeout=timeout)
        try:
            detail = r.json()
        except ValueError:
            detail = {"error": f"HTTP {r.status}"}
        if r.status >= 400:
            raise ClientError(f"POST {self.master}{path}: "
                              f"{detail.get('error')}")
        return detail

    # --- master ops ---
    def assign(self, count: int = 1, collection: str = "",
               replication: str = "", ttl: str = "") -> dict:
        params = {"count": str(count)}
        if collection:
            params["collection"] = collection
        if replication:
            params["replication"] = replication
        if ttl:
            params["ttl"] = ttl
        out = self._master_get("/dir/assign?"
                               + urllib.parse.urlencode(params))
        if "error" in out:
            raise ClientError(out["error"])
        return out

    def lookup(self, vid: int) -> list[str]:
        cached = self._vid_cache.get(vid)
        if cached:
            return cached
        out = self._master_get(f"/dir/lookup?volumeId={vid}")
        urls = [loc["url"] for loc in out.get("locations", [])]
        if not urls:
            raise ClientError(out.get("error", f"volume {vid} not found"))
        self._vid_cache.put(vid, urls)
        return urls

    def grow(self, count: int = 1, collection: str = "",
             replication: str = "", ttl: str = "") -> dict:
        params = {"count": str(count), "collection": collection,
                  "replication": replication, "ttl": ttl}
        return self._master_get("/vol/grow?"
                                + urllib.parse.urlencode(params))

    def cluster_status(self) -> dict:
        return self._master_get("/cluster/status")

    def vacuum(self, threshold: float = 0.3) -> dict:
        """Compact every volume whose garbage is at least `threshold` on
        all its holders (the master's /vol/vacuum); returns
        {"ok", "compacted": [vid, ...]}."""
        return self._master_get(
            f"/vol/vacuum?garbageThreshold={threshold}", timeout=600)

    # --- blob ops ---
    def upload_blob(self, url: str, fid: str, data: bytes,
                    filename: str = "", mime: str = "",
                    ttl: str = "") -> dict:
        boundary = uuid.uuid4().hex
        name = filename or "file"
        ctype = mime or "application/octet-stream"
        body = (
            f"--{boundary}\r\n"
            f'Content-Disposition: form-data; name="file"; '
            f'filename="{name}"\r\n'
            f"Content-Type: {ctype}\r\n\r\n").encode() + data + \
            f"\r\n--{boundary}--\r\n".encode()
        target = f"http://{url}/{fid}"
        if ttl:
            target += "?" + urllib.parse.urlencode({"ttl": ttl})
        r = _request("POST", target, body,
                         {"Content-Type":
                          f"multipart/form-data; boundary={boundary}"},
                         timeout=300)
        if r.status >= 300:
            raise ClientError(f"upload {fid}: HTTP {r.status} "
                              f"{r.data[:200]!r}")
        return r.json()

    def upload(self, data: bytes, filename: str = "", mime: str = "",
               collection: str = "", replication: str = "",
               ttl: str = "") -> str:
        """Assign + upload; returns the fid."""
        a = self.assign(collection=collection, replication=replication,
                        ttl=ttl)
        self.upload_blob(a["url"], a["fid"], data, filename, mime, ttl)
        return a["fid"]

    def _replica(self) -> Optional["Client"]:
        if not self._replica_masters:
            return None
        if self._replica_client is None:
            # the replica client gets no replica of its own, not even
            # from the environment: failover is one hop, never a ring
            # (ROADMAP Queue 3, D26)
            self._replica_client = Client(self._replica_masters,
                                          replica_masters=None)
        return self._replica_client

    def download(self, fid: str, url: str = "") -> bytes:
        """The blob, from the first holder that serves it, or from the
        holder `url` alone. When the primary cluster is unreachable and a
        replica cluster is configured, the replica serves it and
        ``last_read_stale`` is set."""
        self.last_read_stale = False
        try:
            return self._download_local(fid, url)
        except (ClientUnreachable, *_CONN_ERRORS):
            # unreachability only: a 404 from a healthy primary is
            # authoritative and must not resurrect deleted data
            replica = self._replica()
            if replica is None:
                raise
            data = replica.download(fid)
            self.last_read_stale = True
            return data

    def _download_local(self, fid: str, url: str) -> bytes:
        vid = int(fid.split(",")[0])
        last_err: Optional[Exception] = None
        for holder in [url] if url else self.lookup(vid):
            try:
                r = _request("GET", f"http://{holder}/{fid}",
                             timeout=300)
            except _CONN_ERRORS as e:  # refused etc: try the next holder
                last_err = e
                self._vid_cache.pop(vid)
                continue
            if r.status in (200, 206):
                return r.data
            last_err = ClientError(f"{holder}/{fid}: HTTP {r.status}")
        if isinstance(last_err, _CONN_ERRORS):
            # every holder refused the dial: unreachable, not a negative
            # answer
            raise ClientUnreachable(f"download {fid} failed: {last_err}")
        raise ClientError(f"download {fid} failed: {last_err}")

    def delete(self, fid: str) -> None:
        vid = int(fid.split(",")[0])
        for url in self.lookup(vid):
            r = _request("DELETE", f"http://{url}/{fid}", timeout=60)
            if r.status < 300:
                return
            if r.status == 404:
                continue
            raise ClientError(f"delete {fid}: HTTP {r.status}")
        raise ClientError(f"delete {fid}: no replica accepted")

    # --- volume-server admin (the shell commands' transport) ---
    def volume_admin(self, server: str, op: str, body: dict) -> dict:
        return _post_json(f"http://{server}/admin/{op}", body)

    def tail_volume(self, vid: int, since_ns: int = 0,
                    timeout: float = 300.0):
        """Yield the needle records appended to volume `vid` after
        since_ns, from its first holder's /admin/tail, as they stream
        (operation.TailVolume, weed/operation/tail_volume.go)."""
        from .storage import types as t
        from .storage.needle import Needle
        urls = self.lookup(vid)
        conn = http_client.HTTPConnection(urls[0],
                                          timeout=cap_timeout(timeout))
        try:
            conn.request("GET", f"/admin/tail?volume_id={vid}"
                                f"&since_ns={since_ns}")
            r = conn.getresponse()
            if r.status != 200:
                raise ClientError(f"tail of volume {vid} on {urls[0]}: "
                                  f"HTTP {r.status}")
            while True:
                head = r.read(4)
                if len(head) < 4:
                    return
                rec = r.read(int.from_bytes(head, "big"))
                yield Needle.from_bytes(rec, t.CURRENT_VERSION)
        finally:
            conn.close()

    def query(self, fids: list[str], filter: Optional[dict] = None,
              projections: Optional[list[str]] = None) -> list[dict]:
        """S3-Select-lite over JSON blobs (weed/query): the documents of
        `fids` that pass `filter` ({"field", "op", "value"}), projected
        to `projections`, grouped by each volume's first holder."""
        out: list[dict] = []
        by_server: dict[str, list[str]] = {}
        for fid in fids:
            urls = self.lookup(int(fid.split(",")[0]))
            if urls:
                by_server.setdefault(urls[0], []).append(fid)
        for server, group in by_server.items():
            body = json.dumps({"fids": group, "filter": filter,
                               "projections": projections}).encode()
            r = _request("POST", f"http://{server}/admin/query", body,
                         {"Content-Type": "application/json"}, timeout=300)
            if r.status != 200:
                raise ClientError(f"query on {server}: HTTP {r.status}")
            for line in r.data.splitlines():
                if line.strip():
                    out.append(json.loads(line))
        return out

    def ec_lookup(self, vid: int) -> dict:
        return self._master_get(f"/col/lookup/ec?volumeId={vid}")

    def dir_status(self) -> dict:
        return self._master_get("/dir/status")

    # --- the lifecycle plane (the shell's volume.heat, lifecycle.*) ---
    def volume_heat(self, vid: int = 0) -> dict:
        """Per-volume access heat and lifecycle state (/vol/heat)."""
        return self._master_get("/vol/heat"
                                + (f"?volumeId={vid}" if vid else ""))

    def lifecycle_status(self) -> dict:
        return self._master_get("/lifecycle/status")

    def lifecycle_run(self) -> dict:
        """One lifecycle evaluation pass now."""
        return self._master_post("/lifecycle/run", {})

    # --- the balance plane (the shell's cluster.balance.*) ---
    def balance_status(self) -> dict:
        return self._master_get("/balance/status")

    def balance_run(self) -> dict:
        """One balance planning pass now."""
        return self._master_post("/balance/run", {}, timeout=120.0)
