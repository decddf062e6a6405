"""S3-compatible gateway over the filer.

The port's reduced copy of seaweedfs_tpu/s3/s3_server.py. Capability parity with the reference S3 API (weed/s3api/s3api_server.go and
handlers): buckets as directories under /buckets (filer_buckets.go), object
CRUD, ListObjects V1/V2 with prefix/delimiter/markers, bulk delete,
multipart uploads (parts as filer files under /buckets/.uploads/<id>,
completed by concatenating chunk lists — filer_multipart.go:59-200), copy,
and AWS Signature V4 header auth (auth_signature_v4.go; anonymous mode when
no credentials are configured).

Path-style addressing: /{bucket}/{key}. Rides the filer's HTTP data path for
object bytes and its /__meta__ API (the filer-gRPC analog) for entry-level
operations. Signature V2 (header and presigned), presigned V4, streaming
chunked SigV4 bodies, post-policy uploads, tagging, versioning and the
bucket lifecycle and replication configurations are the reference's; the
admission middleware (overload/) meters every request, and ``/healthz``
and ``/metrics`` are reserved through ``overload.reserve_ops``.

Left out, each with its later home:

- the trace middleware and ``/debug/trace``, ``/debug/profile``,
  ``/debug/pprof`` and ``/debug/events`` (ROADMAP A.9, the rest of
  ``observe/``): their names stay reserved (every method answers 405),
  so no request to them reaches a bucket;
- ``shard_ctx`` and the stripe loop of a SO_REUSEPORT shard fleet (A.9,
  ``server/sharded.py``);
- ``/admin/faults`` (the port's ``faults`` has no admin face).

Replica-cluster read failover (the geo plane): with ``replica_filer_url``
(else ``WEED_GEO_REPLICA_FILER``), a GET or HEAD whose primary filer is
breaker-open (``utils/retry.shared_breaker()``) or fails live is served
by the replica cluster's filer, marked ``X-Seaweed-Stale-Ok: 1`` and
counted in ``geo_failover_reads``. Writes never fail over.
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import logging
import os
import time
import urllib.parse
import uuid
import xml.etree.ElementTree as ET
from typing import Optional

import aiohttp
from aiohttp import web

from . import auth as auth_mod
from .. import overload
from ..geo import rules as geo_rules
from ..geo import versioning as geo_versioning
from ..server import http
from ..utils import metrics as metrics_mod
from ..utils import retry as retry_mod

log = logging.getLogger("s3")

BUCKETS_DIR = "/buckets"
UPLOADS_DIR = "/buckets/.uploads"
XMLNS = "http://s3.amazonaws.com/doc/2006-03-01/"


def _xml(root: ET.Element) -> web.Response:
    body = b'<?xml version="1.0" encoding="UTF-8"?>\n' + ET.tostring(root)
    return web.Response(body=body, content_type="application/xml")


def _error(code: str, message: str, status: int) -> web.Response:
    root = ET.Element("Error")
    ET.SubElement(root, "Code").text = code
    ET.SubElement(root, "Message").text = message
    return web.Response(
        body=b'<?xml version="1.0" encoding="UTF-8"?>\n' + ET.tostring(root),
        status=status, content_type="application/xml")


class S3Server:
    def __init__(self, filer_url: str,
                 access_key: str = "", secret_key: str = "",
                 iam: Optional["auth_mod.Iam"] = None,
                 url: str = "",
                 replica_filer_url: str = ""):
        self.filer_url = filer_url
        # replica-cluster read failover: GETs go to the replica
        # cluster's filer when the primary's breaker is open or a fetch
        # fails live, marked stale. Writes never fail over (the replica
        # is a follower; split-brain writes lose data).
        self.replica_filer_url = (replica_filer_url or os.environ.get(
            "WEED_GEO_REPLICA_FILER", ""))
        # the process-wide per-host breaker: evidence of a dead filer
        # collected here protects every other caller, and vice versa
        self._filer_breaker = retry_mod.shared_breaker()
        # own advertised host:port
        self.url = url
        # identity registry with per-action ACLs
        # (auth_credentials.go:25-150); the legacy access/secret pair
        # becomes a single Admin identity
        if iam is not None:
            self.iam = iam
        elif access_key:
            self.iam = auth_mod.Iam([{
                "name": "admin",
                "credentials": [{"accessKey": access_key,
                                 "secretKey": secret_key}],
                "actions": [auth_mod.ACTION_ADMIN]}])
        else:
            self.iam = auth_mod.Iam([])
        self.metrics = metrics_mod.Registry("s3")
        self._session: Optional[aiohttp.ClientSession] = None
        # overload plane: per-tenant buckets key off the SigV4 access
        # key id here (overload.tenant_from_request), so one hot tenant
        # answers 429 while the others keep their capacity. Gateway
        # system set = only the reserved ops routes — a BUCKET named
        # "status" or "heartbeat" is user traffic and is metered.
        # tenant keys arrive UNVERIFIED (admission runs before SigV4),
        # so only charge buckets for access keys the identity registry
        # actually knows: unknown keys can't churn the bounded
        # TenantBuckets LRU and meter under the global bucket instead.
        # That is the whole guarantee — a spoofed KNOWN access key id
        # (AKIDs are not secrets; they ride in presigned URLs and logs)
        # still drains that tenant's bucket pre-auth, so per-tenant
        # limits are a fairness ceiling, not an auth-grade quota (see
        # README "Sizing per-tenant buckets")
        self.admission = overload.AdmissionController(
            "s3", metrics=self.metrics,
            system_paths=(overload.GATEWAY_SYSTEM_PATHS
                          | overload.faults_admin_paths()),
            tenant_validator=lambda k: (self.iam.enabled
                                        and self.iam.lookup(k) is not None))
        self.app = self._build_app()

    def _build_app(self) -> web.Application:
        app = web.Application(
            client_max_size=5 * 1024 * 1024 * 1024,
            middlewares=[overload.admission_middleware(self.admission)])
        # ops surface registered before the catch-alls (exact routes win
        # over the {bucket} patterns; these names are reserved like the
        # reference's /status endpoints), every other method 405: a
        # GET-only route would let PUT /metrics fall through to the
        # {bucket} catch-all and mint a bucket the gateway can never
        # read back; S3 keeps its XML error shape via `reserved`. The
        # debug routes are not ported: their names stay reserved with no
        # handler, so each method answers 405 there
        for path, handler in (
                ("/healthz", overload.healthz_handler(self.admission)),
                ("/metrics", self.metrics_handler),
                ("/debug/trace", None),
                ("/debug/profile", None),
                ("/debug/pprof", None),
                ("/debug/events", None)):
            overload.reserve_ops(app, path, handler,
                                 reserved=self._reserved)
        app.router.add_route("*", "/", self.dispatch_root)
        app.router.add_route("*", "/{bucket}", self.dispatch_bucket)
        app.router.add_route("*", "/{bucket}/{key:.*}", self.dispatch_object)
        app.on_startup.append(self._on_startup)
        app.on_cleanup.append(self._on_cleanup)
        return app

    async def _reserved(self, request: web.Request) -> web.Response:
        return _error("MethodNotAllowed",
                      "reserved operational endpoint", 405)

    async def metrics_handler(self, request: web.Request) -> web.Response:
        # with credentials configured, the ops surface needs an Admin
        # signature — metrics leak object keys and topology, and unlike
        # master/volume/filer there is no IP-whitelist in front
        err = self._check_auth(request, action=auth_mod.ACTION_ADMIN)
        if err is not None:
            return err
        return web.Response(
            text=self.metrics.render() + metrics_mod.render_shared(),
            content_type="text/plain")

    async def _on_startup(self, app) -> None:
        await self.admission.start()
        self._session = aiohttp.ClientSession(
            # inactivity-bounded, no total cap (large object streams)
            timeout=aiohttp.ClientTimeout(total=None, sock_connect=10,
                                          sock_read=60))

    async def _on_cleanup(self, app) -> None:
        self.admission.stop()
        if self._session:
            await self._session.close()

    @staticmethod
    def _sigv4_string_to_sign(request: web.Request, signed_headers: list,
                              payload_hash: str, amz_date: str,
                              scope: str,
                              skip_query: tuple = ()) -> str:
        """Canonical request -> string-to-sign, shared by the header and
        presigned auth paths so the canonical form cannot drift."""
        # MultiDict.keys() repeats duplicated keys (which would double
        # every repeated parameter); AWS sorts the PERCENT-ENCODED
        # (key, value) TUPLES (botocore does the same) — joined "k=v"
        # strings diverge when one key prefixes another and the longer
        # key's next character sorts above '=' (any letter)
        cq = [f"{k}={v}" for k, v in sorted(
            (urllib.parse.quote(k, safe="-_.~"),
             urllib.parse.quote(v, safe="-_.~"))
            for k, v in request.query.items() if k not in skip_query)]
        canonical_headers = "".join(
            f"{h}:{' '.join(request.headers.get(h, '').split())}\n"
            for h in signed_headers)
        canonical = "\n".join([
            request.method,
            urllib.parse.quote(request.path, safe="/-_.~"),
            "&".join(cq),
            canonical_headers,
            ";".join(signed_headers),
            payload_hash,
        ])
        return "\n".join([
            "AWS4-HMAC-SHA256", amz_date, scope,
            hashlib.sha256(canonical.encode()).hexdigest()])

    # --- auth (SigV4 header scheme + per-action ACLs) ---
    def _check_auth(self, request: web.Request,
                    action: str = "", bucket: str = ""
                    ) -> Optional[web.Response]:
        """Verify the SigV4 signature, resolve the identity, and check the
        requested action against its ACL. Stashes the verified signature
        context on the request for streaming-chunked payloads."""
        if not self.iam.enabled:
            return None  # anonymous mode
        if request.query.get("X-Amz-Algorithm") == "AWS4-HMAC-SHA256":
            return self._check_presigned(request, action, bucket)
        auth = request.headers.get("Authorization", "")
        if auth.startswith("AWS ") and not auth.startswith("AWS4"):
            return self._check_v2(request, auth, action, bucket)
        if (not auth and "Signature" in request.query
                and "AWSAccessKeyId" in request.query):
            return self._check_presigned_v2(request, action, bucket)
        if not auth.startswith("AWS4-HMAC-SHA256 "):
            return _error("AccessDenied", "missing signature", 403)
        try:
            parts = dict(p.strip().split("=", 1)
                         for p in auth[len("AWS4-HMAC-SHA256 "):].split(","))
            cred = parts["Credential"].split("/")
            akid, date, region, service = cred[0], cred[1], cred[2], cred[3]
            found = self.iam.lookup(akid)
            if found is None:
                return _error("InvalidAccessKeyId", "unknown key", 403)
            identity, secret_key = found
            signed_headers = parts["SignedHeaders"].split(";")
            amz_date = request.headers.get("x-amz-date", "")
            scope = f"{date}/{region}/{service}/aws4_request"
            string_to_sign = self._sigv4_string_to_sign(
                request, signed_headers,
                request.headers.get("x-amz-content-sha256",
                                    "UNSIGNED-PAYLOAD"),
                amz_date, scope)

            k = auth_mod.signing_key(secret_key, date, region, service)
            want = hmac.new(k, string_to_sign.encode(),
                            hashlib.sha256).hexdigest()
            if not hmac.compare_digest(want, parts["Signature"]):
                return _error("SignatureDoesNotMatch", "bad signature", 403)
            # ACL only AFTER the signature is proven: identity names and
            # per-action permissions must not leak to unauthenticated
            # callers (AWS orders its checks the same way)
            if action and not identity.allows(action, bucket):
                return _error(
                    "AccessDenied",
                    f"{identity.name} may not {action} on {bucket}", 403)
            # context for STREAMING-AWS4-HMAC-SHA256-PAYLOAD bodies
            request["sigv4"] = {"seed": parts["Signature"], "key": k,
                                "amz_date": amz_date, "scope": scope}
        except (KeyError, IndexError, ValueError) as e:
            return _error("AuthorizationHeaderMalformed", str(e), 400)
        return None

    def _check_v2(self, request: web.Request, auth: str, action: str,
                  bucket: str) -> Optional[web.Response]:
        """Signature V2 header scheme (isReqAuthenticatedV2,
        weed/s3api/auth_signature_v2.go:1-412): HMAC-SHA1 over the
        Method/MD5/Type/Date/amz-headers/resource string."""
        from . import sigv2
        fields = auth[len("AWS "):].split(":")
        if len(fields) != 2 or not fields[0]:
            return _error("AuthorizationHeaderMalformed",
                          "malformed V2 Authorization", 400)
        akid, given = fields
        found = self.iam.lookup(akid)
        if found is None:
            return _error("InvalidAccessKeyId", "unknown key", 403)
        identity, secret_key = found
        # V2 signs the percent-ENCODED path as sent (request.path is
        # decoded; a key with a space/%/+ would mismatch)
        sts = sigv2.string_to_sign(
            request.method, request.rel_url.raw_path, request.query,
            request.headers)
        want = sigv2.signature(secret_key, sts)
        if not hmac.compare_digest(want, given):
            return _error("SignatureDoesNotMatch", "bad signature", 403)
        if action and not identity.allows(action, bucket):
            return _error("AccessDenied",
                          f"{identity.name} may not {action} on {bucket}",
                          403)
        return None

    def _check_presigned_v2(self, request: web.Request, action: str,
                            bucket: str) -> Optional[web.Response]:
        """Presigned V2 (doesPresignV2SignatureMatch): AWSAccessKeyId /
        Expires / Signature in the query, epoch Expires in the Date
        slot."""
        from . import sigv2
        q = request.query
        akid = q.get("AWSAccessKeyId", "")
        expires = q.get("Expires", "")
        given = q.get("Signature", "")
        if not akid or not expires or not given:
            return _error("AuthorizationQueryParametersError",
                          "missing V2 query parameters", 400)
        found = self.iam.lookup(akid)
        if found is None:
            return _error("InvalidAccessKeyId", "unknown key", 403)
        identity, secret_key = found
        sts = sigv2.presigned_string_to_sign(
            request.method, request.rel_url.raw_path, q, request.headers,
            expires)
        want = sigv2.signature(secret_key, sts)
        # signature first — expiry answers before the signature is proven
        # would give unauthenticated callers an oracle (same order as the
        # V4 presigned path above)
        if not hmac.compare_digest(want, given):
            return _error("SignatureDoesNotMatch", "bad signature", 403)
        try:
            deadline = int(expires)
        except ValueError:
            return _error("AuthorizationQueryParametersError",
                          "malformed Expires", 400)
        if time.time() > deadline:
            return _error("AccessDenied", "Request has expired", 403)
        if action and not identity.allows(action, bucket):
            return _error("AccessDenied",
                          f"{identity.name} may not {action} on {bucket}",
                          403)
        return None

    def _check_presigned(self, request: web.Request, action: str,
                         bucket: str) -> Optional[web.Response]:
        """Presigned-URL query auth (doesPresignedSignatureMatch,
        weed/s3api/auth_signature_v4.go): the SigV4 parameters ride the
        query string, the payload is UNSIGNED-PAYLOAD, and the signature
        expires X-Amz-Expires seconds after X-Amz-Date."""
        import time as time_mod

        q = request.query
        try:
            cred = q["X-Amz-Credential"].split("/")
            akid, date, region, service = (cred[0], cred[1], cred[2],
                                           cred[3])
            amz_date = q["X-Amz-Date"]
            expires = int(q.get("X-Amz-Expires", "900"))
            signed_headers = q["X-Amz-SignedHeaders"].split(";")
            given = q["X-Amz-Signature"]
        except (KeyError, IndexError, ValueError) as e:
            return _error("AuthorizationQueryParametersError", str(e), 400)
        if not 1 <= expires <= 604800:
            # AWS bounds X-Amz-Expires to [1s, 7 days]; a negative value
            # must be rejected as malformed, not treated as pre-expired
            return _error("AuthorizationQueryParametersError",
                          "X-Amz-Expires must be between 1 and 604800",
                          400)
        found = self.iam.lookup(akid)
        if found is None:
            return _error("InvalidAccessKeyId", "unknown key", 403)
        identity, secret_key = found
        # signature FIRST: expiry/ACL answers before the signature is
        # proven would hand an unauthenticated caller an oracle for
        # identity names and per-action permissions
        scope = f"{date}/{region}/{service}/aws4_request"
        # canonical request: every query param except the signature itself
        string_to_sign = self._sigv4_string_to_sign(
            request, signed_headers, "UNSIGNED-PAYLOAD", amz_date, scope,
            skip_query=("X-Amz-Signature",))
        k = auth_mod.signing_key(secret_key, date, region, service)
        want = hmac.new(k, string_to_sign.encode(),
                        hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, given):
            return _error("SignatureDoesNotMatch", "bad signature", 403)
        try:
            import calendar
            t0 = calendar.timegm(time_mod.strptime(amz_date,
                                                   "%Y%m%dT%H%M%SZ"))
        except ValueError:
            return _error("AuthorizationQueryParametersError",
                          "bad X-Amz-Date", 400)
        now = time_mod.time()
        if now > t0 + expires or now < t0 - 900:
            return _error("AccessDenied", "Request has expired", 403)
        if action and not identity.allows(action, bucket):
            return _error("AccessDenied",
                          f"{identity.name} may not {action} on {bucket}",
                          403)
        return None

    # --- filer plumbing ---
    async def _meta(self, op: str, body: dict) -> tuple[int, dict]:
        async with self._session.post(
                f"http://{self.filer_url}/__meta__/{op}", json=body) as r:
            return r.status, await r.json()

    async def _meta_get(self, op: str, params: dict,
                        filer: str = "") -> tuple[int, dict]:
        async with self._session.get(
                f"http://{filer or self.filer_url}/__meta__/{op}",
                params=params) as r:
            return r.status, await r.json()

    def _obj_path(self, bucket: str, key: str) -> str:
        return f"{BUCKETS_DIR}/{bucket}/{key}".rstrip("/")

    # --- dispatch ---
    async def dispatch_root(self, request: web.Request) -> web.Response:
        denied = self._check_auth(request)
        if denied is not None:
            return denied
        if request.method == "GET":
            return await self.list_buckets(request)
        return _error("MethodNotAllowed", request.method, 405)

    async def dispatch_bucket(self, request: web.Request) -> web.Response:
        bucket = request.match_info["bucket"]
        if request.method == "POST" and "delete" not in request.query:
            # browser post-policy upload: authenticated by the signed
            # policy document, not the Authorization header
            return await self.post_policy_upload(request, bucket)
        action = {"PUT": auth_mod.ACTION_ADMIN,
                  "DELETE": auth_mod.ACTION_ADMIN,
                  "HEAD": auth_mod.ACTION_LIST,
                  "GET": auth_mod.ACTION_LIST,
                  "POST": auth_mod.ACTION_WRITE}.get(request.method, "")
        denied = self._check_auth(request, action, bucket)
        if denied is not None:
            return denied
        if "lifecycle" in request.query:
            # Put/Get/DeleteBucketLifecycleConfiguration: the rules
            # live on the bucket entry; the master's lifecycle daemon
            # enforces them (Expiration + Transition StorageClass=WARM)
            if request.method == "PUT":
                return await self.put_bucket_lifecycle(request, bucket)
            if request.method == "GET":
                return await self.get_bucket_lifecycle(bucket)
            if request.method == "DELETE":
                return await self.delete_bucket_lifecycle(bucket)
            return _error("MethodNotAllowed", request.method, 405)
        if "versioning" in request.query:
            # Put/GetBucketVersioning: state rides the bucket entry's
            # extended attributes (geo/versioning.py layout)
            if request.method == "PUT":
                return await self.put_bucket_versioning(request, bucket)
            if request.method == "GET":
                return await self.get_bucket_versioning(bucket)
            return _error("MethodNotAllowed", request.method, 405)
        if "replication" in request.query:
            # Put/Get/DeleteBucketReplication: the rules live on the
            # bucket entry; the master's geo daemon enforces them
            # (one BucketReplicator job per enabled rule)
            if request.method == "PUT":
                return await self.put_bucket_replication(request, bucket)
            if request.method == "GET":
                return await self.get_bucket_replication(bucket)
            if request.method == "DELETE":
                return await self.delete_bucket_replication(bucket)
            return _error("MethodNotAllowed", request.method, 405)
        if "versions" in request.query and request.method == "GET":
            return await self.list_object_versions(request, bucket)
        if request.method == "PUT":
            return await self.put_bucket(bucket)
        if request.method == "DELETE":
            return await self.delete_bucket(bucket)
        if request.method == "HEAD":
            return await self.head_bucket(bucket)
        if request.method == "GET":
            return await self.list_objects(request, bucket)
        if request.method == "POST" and "delete" in request.query:
            return await self.bulk_delete(request, bucket)
        return _error("MethodNotAllowed", request.method, 405)

    async def dispatch_object(self, request: web.Request) -> web.Response:
        bucket = request.match_info["bucket"]
        key = request.match_info["key"]
        q = request.query
        tagging = "tagging" in q
        if tagging:
            action = (auth_mod.ACTION_READ if request.method == "GET"
                      else auth_mod.ACTION_TAGGING)
        elif request.method in ("GET", "HEAD"):
            action = auth_mod.ACTION_READ
        else:
            action = auth_mod.ACTION_WRITE
        denied = self._check_auth(request, action, bucket)
        if denied is not None:
            return denied
        if tagging:
            if request.method == "GET":
                return await self.get_tagging(bucket, key)
            if request.method == "PUT":
                return await self.put_tagging(request, bucket, key)
            if request.method == "DELETE":
                return await self.delete_tagging(bucket, key)
        if request.method == "POST" and "uploads" in q:
            return await self.initiate_multipart(bucket, key)
        if request.method == "PUT" and "partNumber" in q:
            return await self.upload_part(request, bucket, key)
        if request.method == "POST" and "uploadId" in q:
            return await self.complete_multipart(request, bucket, key)
        if request.method == "DELETE" and "uploadId" in q:
            return await self.abort_multipart(request, bucket, key)
        if request.method == "GET" and "uploadId" in q:
            return await self.list_parts(request, bucket, key)
        if request.method == "PUT":
            if "x-amz-copy-source" in request.headers:
                return await self.copy_object(request, bucket, key)
            return await self.put_object(request, bucket, key)
        if request.method in ("GET", "HEAD"):
            return await self.get_object(request, bucket, key)
        if request.method == "DELETE":
            return await self.delete_object(
                bucket, key, version_id=q.get("versionId", ""))
        return _error("MethodNotAllowed", request.method, 405)

    # --- request payloads (streaming chunked SigV4) ---
    async def _request_payload(self, request: web.Request):
        """The request body, transparently de-framing (and verifying)
        STREAMING-AWS4-HMAC-SHA256-PAYLOAD bodies
        (chunked_reader_v4.go)."""
        if request.headers.get("x-amz-content-sha256", "") == \
                "STREAMING-AWS4-HMAC-SHA256-PAYLOAD":
            ctx = request.get("sigv4")
            if ctx:
                return await auth_mod.read_chunked_sigv4(
                    request.content, ctx["seed"], ctx["key"],
                    ctx["amz_date"], ctx["scope"])
            return await auth_mod.read_chunked_sigv4(request.content)
        return request.content

    # --- buckets ---
    async def list_buckets(self, request: web.Request) -> web.Response:
        status, body = await self._meta_get(
            "list", {"dir": BUCKETS_DIR, "limit": "1000"})
        root = ET.Element("ListAllMyBucketsResult", xmlns=XMLNS)
        owner = ET.SubElement(root, "Owner")
        ET.SubElement(owner, "ID").text = "seaweedfs-tpu"
        buckets = ET.SubElement(root, "Buckets")
        for e in body.get("entries", []):
            name = e["path"].rsplit("/", 1)[-1]
            if name.startswith("."):
                continue
            b = ET.SubElement(buckets, "Bucket")
            ET.SubElement(b, "Name").text = name
            ET.SubElement(b, "CreationDate").text = _iso(
                e["attr"].get("crtime", 0))
        return _xml(root)

    async def put_bucket(self, bucket: str) -> web.Response:
        self.metrics.count("put_bucket")
        status, body = await self._meta("create_entry", {"entry": {
            "path": f"{BUCKETS_DIR}/{bucket}",
            "attr": {"mode": 0o40770, "crtime": time.time(),
                     "mtime": time.time()},
            "chunks": [],
        }, "o_excl": True})
        if status == 409:
            return _error("BucketAlreadyExists", bucket, 409)
        if status != 200:
            return _error("InternalError", str(body.get("error")), 500)
        return web.Response(status=200)

    async def delete_bucket(self, bucket: str) -> web.Response:
        status, listing = await self._meta_get(
            "list", {"dir": f"{BUCKETS_DIR}/{bucket}", "limit": "1"})
        if status == 200 and listing.get("entries"):
            return _error("BucketNotEmpty", bucket, 409)
        status, _ = await self._meta(
            "delete", {"path": f"{BUCKETS_DIR}/{bucket}",
                       "recursive": True})
        if status == 404:
            return _error("NoSuchBucket", bucket, 404)
        return web.Response(status=204)

    async def head_bucket(self, bucket: str) -> web.Response:
        status, _ = await self._meta_get(
            "lookup", {"path": f"{BUCKETS_DIR}/{bucket}"})
        return web.Response(status=200 if status == 200 else 404)

    # --- bucket lifecycle configuration (s3api_bucket_handlers.go's
    #     lifecycle trio; rules parsed/serialized in
    #     seaweedfs_tpu/lifecycle/s3_rules.py, enforced by the master's
    #     lifecycle daemon through the filer) ---

    async def put_bucket_lifecycle(self, request: web.Request,
                                   bucket: str) -> web.Response:
        from ..lifecycle import s3_rules
        self.metrics.count("put_bucket_lifecycle")
        body = await request.read()
        try:
            rules = s3_rules.parse_lifecycle_xml(body)
        except s3_rules.LifecycleXmlError as e:
            return _error("MalformedXML", str(e), 400)
        err = await self._set_bucket_attr(
            bucket, s3_rules.BUCKET_ATTR, s3_rules.rules_to_json(rules))
        return err or web.Response(status=200)

    async def get_bucket_lifecycle(self, bucket: str) -> web.Response:
        from ..lifecycle import s3_rules
        raw = await self._bucket_attr(bucket, s3_rules.BUCKET_ATTR)
        if raw is None:
            return _error("NoSuchBucket", bucket, 404)
        rules = s3_rules.rules_from_json(raw)
        if not rules:
            return _error("NoSuchLifecycleConfiguration",
                          "no lifecycle configuration", 404)
        return web.Response(body=s3_rules.rules_to_xml(rules),
                            content_type="application/xml")

    async def delete_bucket_lifecycle(self, bucket: str) -> web.Response:
        from ..lifecycle import s3_rules
        err = await self._set_bucket_attr(bucket, s3_rules.BUCKET_ATTR,
                                          None)
        return err or web.Response(status=204)

    # --- bucket attribute plumbing (versioning + replication state both
    #     ride the bucket directory entry's extended attributes, exactly
    #     like lifecycle rules and object tags) ---

    async def _set_bucket_attr(self, bucket: str, attr: str,
                               value: Optional[str]) -> Optional[web.Response]:
        """Set (or with None, clear) one extended attribute on the
        bucket entry; returns an error response or None."""
        status, entry = await self._meta_get(
            "lookup", {"path": f"{BUCKETS_DIR}/{bucket}"})
        if status != 200:
            return _error("NoSuchBucket", bucket, 404)
        extended = entry.get("extended") or {}
        if value is None:
            if attr not in extended:
                return None
            extended.pop(attr, None)
        else:
            extended[attr] = value
        entry["extended"] = extended
        status, out = await self._meta("update_entry", {"entry": entry})
        if status != 200:
            return _error("InternalError", str(out.get("error")), 500)
        return None

    async def _bucket_attr(self, bucket: str,
                           attr: str) -> Optional[str]:
        """One extended attribute off the bucket entry: None = no such
        bucket, "" = bucket exists but the attribute is unset."""
        status, entry = await self._meta_get(
            "lookup", {"path": f"{BUCKETS_DIR}/{bucket}"})
        if status != 200:
            return None
        return (entry.get("extended") or {}).get(attr, "")

    # --- bucket versioning (s3api_bucket_handlers.go's versioning
    #     pair; semantics in geo/versioning.py) ---

    async def put_bucket_versioning(self, request: web.Request,
                                    bucket: str) -> web.Response:
        self.metrics.count("put_bucket_versioning")
        body = await request.read()
        try:
            root = ET.fromstring(body)
        except ET.ParseError as e:
            return _error("MalformedXML", str(e), 400)
        ns = root.tag.split("}")[0] + "}" if root.tag.startswith("{") else ""
        st = root.find(f"{ns}Status")
        if st is None or st.text not in ("Enabled", "Suspended"):
            return _error("MalformedXML",
                          "Status must be Enabled or Suspended", 400)
        err = await self._set_bucket_attr(
            bucket, geo_versioning.VERSIONING_ATTR, st.text)
        return err or web.Response(status=200)

    async def get_bucket_versioning(self, bucket: str) -> web.Response:
        state = await self._bucket_attr(bucket,
                                        geo_versioning.VERSIONING_ATTR)
        if state is None:
            return _error("NoSuchBucket", bucket, 404)
        root = ET.Element("VersioningConfiguration", xmlns=XMLNS)
        if state:
            ET.SubElement(root, "Status").text = state
        return _xml(root)

    async def _versioning_enabled(self, bucket: str) -> bool:
        state = await self._bucket_attr(bucket,
                                        geo_versioning.VERSIONING_ATTR)
        return state == "Enabled"

    # --- bucket replication (PutBucketReplication subset; rules in
    #     geo/rules.py, enforced by the master's geo daemon) ---

    async def put_bucket_replication(self, request: web.Request,
                                     bucket: str) -> web.Response:
        self.metrics.count("put_bucket_replication")
        body = await request.read()
        try:
            rules = geo_rules.parse_replication_xml(body)
        except geo_rules.ReplicationXmlError as e:
            return _error("MalformedXML", str(e), 400)
        err = await self._set_bucket_attr(
            bucket, geo_rules.BUCKET_ATTR,
            geo_rules.rules_to_json(rules))
        return err or web.Response(status=200)

    async def get_bucket_replication(self, bucket: str) -> web.Response:
        raw = await self._bucket_attr(bucket, geo_rules.BUCKET_ATTR)
        if raw is None:
            return _error("NoSuchBucket", bucket, 404)
        rules = geo_rules.rules_from_json(raw)
        if not rules:
            return _error("ReplicationConfigurationNotFoundError",
                          "no replication configuration", 404)
        return web.Response(body=geo_rules.rules_to_xml(rules),
                            content_type="application/xml")

    async def delete_bucket_replication(self, bucket: str) -> web.Response:
        # a failed filer update must NOT read as "rule removed": the
        # geo daemon would keep replicating what the operator stopped
        err = await self._set_bucket_attr(bucket, geo_rules.BUCKET_ATTR,
                                          None)
        return err or web.Response(status=204)

    # --- objects ---
    async def put_object(self, request: web.Request, bucket: str,
                         key: str) -> web.Response:
        self.metrics.count("put_object")
        # one bucket-entry lookup answers both existence and
        # versioning state — no second round trip on the write path
        status, bentry = await self._meta_get(
            "lookup", {"path": f"{BUCKETS_DIR}/{bucket}"})
        if status != 200:
            return _error("NoSuchBucket", bucket, 404)
        path = self._obj_path(bucket, key)
        versioned = (bentry.get("extended") or {}).get(
            geo_versioning.VERSIONING_ATTR) == "Enabled"
        version_id = ""
        extra_q = ""
        old = None
        if versioned:
            # capture the current version now; it is ARCHIVED only
            # after the overwrite lands (archiving first would leave a
            # phantom duplicate version when the body PUT fails).
            # free_old_chunks=false keeps the replaced chunk list
            # alive across the overwrite so the archive can adopt it.
            version_id = geo_versioning.new_version_id()
            status, cur = await self._meta_get("lookup", {"path": path})
            if status == 200 and \
                    not cur.get("attr", {}).get("mode", 0) & 0o40000:
                old = cur
            extra_q = "?free_old_chunks=false"
        headers = {"Content-Type": request.content_type
                   or "application/octet-stream"}
        try:
            payload = await self._request_payload(request)
        except auth_mod.ChunkedSigV4Error as e:
            return _error("SignatureDoesNotMatch", str(e), 403)
        async with self._session.put(
                f"http://{self.filer_url}{urllib.parse.quote(path)}"
                + extra_q,
                data=payload, headers=headers) as r:
            if r.status >= 300:
                return _error("InternalError", f"filer: {r.status}", 500)
        if request.headers.get("x-amz-tagging"):
            tags = dict(urllib.parse.parse_qsl(
                request.headers["x-amz-tagging"]))
            await self._save_tags(path, tags)
        entry = None
        if versioned:
            if old is not None:
                await self._archive_version(path, old)
            entry = await self._stamp_version(path, version_id)
        if entry is None:
            status, entry = await self._meta_get("lookup",
                                                 {"path": path})
            if status != 200:
                entry = {}
        resp_headers = {"ETag": f'"{_entry_etag(entry)}"'}
        if version_id:
            resp_headers["x-amz-version-id"] = version_id
        return web.Response(status=200, headers=resp_headers)

    # --- versioning internals (layout in geo/versioning.py:
    #     current version at the object path, noncurrent versions as
    #     sibling entries under <path>.versions/<version id>) ---

    async def _archive_version(self, path: str, old: dict) -> None:
        """Preserve the current entry as a noncurrent version: a new
        entry under <path>.versions/ SHARING the old chunk list — a
        metadata copy, no data movement."""
        old_vid = geo_versioning.entry_version_id(old)
        archived = dict(old)
        archived["path"] = \
            f"{geo_versioning.versions_dir(path)}/{old_vid}"
        ext = dict(old.get("extended") or {})
        ext[geo_versioning.VERSION_ID_ATTR] = old_vid
        archived["extended"] = ext
        # free_old_chunks=False: re-archiving the same "null" version
        # after repeated unversioned-era overwrites must never free the
        # chunks the fresh archive copy just adopted
        await self._meta("create_entry", {"entry": archived,
                                          "free_old_chunks": False})

    async def _stamp_version(self, path: str,
                             version_id: str) -> Optional[dict]:
        """Stamp the version id onto the entry at `path`; returns the
        stamped entry so callers don't pay another lookup."""
        status, entry = await self._meta_get("lookup", {"path": path})
        if status != 200:
            return None
        ext = entry.get("extended") or {}
        ext[geo_versioning.VERSION_ID_ATTR] = version_id
        entry["extended"] = ext
        await self._meta("update_entry", {"entry": entry})
        return entry

    async def _versioned_overwrite_state(
            self, bucket: str, path: str
    ) -> tuple[bool, Optional[dict], str]:
        """(versioning enabled, current entry to archive or None, new
        version id) — the shared preamble of every write that can
        replace a versioned object (PutObject, CopyObject,
        CompleteMultipartUpload, DeleteObject's marker path)."""
        if not await self._versioning_enabled(bucket):
            return False, None, ""
        status, cur = await self._meta_get("lookup", {"path": path})
        old = (cur if status == 200
               and not cur.get("attr", {}).get("mode", 0) & 0o40000
               else None)
        return True, old, geo_versioning.new_version_id()

    async def _versions_of(self, bucket: str, key: str) -> list[dict]:
        """Noncurrent version entries for a key, newest first (version
        ids are fixed-width time-ordered hex, so name order IS age
        order; "null" sorts before every timestamped id = oldest).
        Paginated: truncating at one store page would silently drop
        the NEWEST versions of a hot key and promote a stale one on
        delete."""
        vdir = geo_versioning.versions_dir(self._obj_path(bucket, key))
        entries: list[dict] = []
        start = ""
        while True:
            status, listing = await self._meta_get(
                "list", {"dir": vdir, "start": start, "limit": "1000"})
            if status != 200:
                break
            page = listing.get("entries", [])
            entries.extend(
                e for e in page
                if not e.get("attr", {}).get("mode", 0) & 0o40000)
            if len(page) < 1000:
                break
            start = page[-1]["path"].rsplit("/", 1)[-1]

        def age_key(e: dict) -> str:
            name = e["path"].rsplit("/", 1)[-1]
            # "null" (pre-versioning) is the OLDEST version, but 'n'
            # sorts after every hex digit — map it below them
            return "" if name == geo_versioning.NULL_VERSION else name

        entries.sort(key=age_key, reverse=True)
        return entries

    async def get_object(self, request: web.Request, bucket: str,
                         key: str) -> web.StreamResponse:
        self.metrics.count("get_object")
        want_vid = request.query.get("versionId", "")
        # primary first; the replica cluster's filer only when the
        # primary is breaker-open or fails live
        filers = [self.filer_url]
        if self.replica_filer_url:
            filers.append(self.replica_filer_url)
        last_err = ""
        for i, filer in enumerate(filers):
            stale_ok = i > 0
            try:
                self._filer_breaker.check(filer)
            except retry_mod.BreakerOpen:
                last_err = f"breaker open for {filer}"
                continue
            try:
                resp = await self._get_object_from(
                    filer, request, bucket, key, want_vid, stale_ok)
                self._filer_breaker.record_success(filer)
                if stale_ok:
                    self.metrics.count("geo_failover_reads")
                return resp
            except (aiohttp.ClientError, asyncio.TimeoutError,
                    OSError) as e:
                self._filer_breaker.record_failure(filer)
                last_err = str(e)
                if request.get("s3_prepared"):
                    # the response already started streaming to the
                    # client: a second prepare() is impossible — let the
                    # truncation surface as a disconnect instead of a
                    # corrupt double response
                    raise
        return _error("ServiceUnavailable",
                      f"no filer reachable: {last_err}", 503)

    async def _get_object_from(self, filer: str, request: web.Request,
                               bucket: str, key: str, want_vid: str,
                               stale_ok: bool) -> web.StreamResponse:
        path = self._obj_path(bucket, key)
        # keys never address directories: GETting a prefix entry must be
        # NoSuchKey, not the filer's JSON listing
        status, entry = await self._meta_get("lookup", {"path": path},
                                             filer=filer)
        if want_vid:
            current = geo_versioning.entry_version_id(entry) \
                if status == 200 else ""
            if current != want_vid:
                # a noncurrent version: its sibling entry
                path = (f"{geo_versioning.versions_dir(path)}"
                        f"/{want_vid}")
                status, entry = await self._meta_get(
                    "lookup", {"path": path}, filer=filer)
                if status != 200:
                    return _error("NoSuchVersion", want_vid, 404)
                if geo_versioning.is_delete_marker(entry):
                    # AWS answers 405 for a GET aimed at a delete marker
                    return web.Response(
                        status=405,
                        headers={"x-amz-delete-marker": "true",
                                 "x-amz-version-id": want_vid})
        if status != 200 or entry.get("attr", {}).get("mode", 0) & 0o40000:
            return _error("NoSuchKey", key, 404)
        headers = {}
        if "Range" in request.headers:
            headers["Range"] = request.headers["Range"]
        async with self._session.request(
                request.method,
                f"http://{filer}{urllib.parse.quote(path)}",
                headers=headers) as r:
            if r.status == 404:
                return _error("NoSuchKey", key, 404)
            resp = web.StreamResponse(status=r.status)
            for h in ("Content-Type", "Content-Length", "ETag",
                      "Content-Range", "Accept-Ranges"):
                if h in r.headers:
                    resp.headers[h] = r.headers[h]
            vid = geo_versioning.entry_version_id(entry)
            if vid != geo_versioning.NULL_VERSION:
                resp.headers["x-amz-version-id"] = vid
            if stale_ok:
                # served from the replica cluster: correct up to the
                # replication lag, flagged so the caller knows
                resp.headers["X-Seaweed-Stale-Ok"] = "1"
            request["s3_prepared"] = True
            await resp.prepare(request)
            if request.method != "HEAD":
                async for chunk in r.content.iter_chunked(1 << 20):
                    await resp.write(chunk)
            await resp.write_eof()
            return resp

    async def delete_object(self, bucket: str, key: str,
                            version_id: str = "") -> web.Response:
        self.metrics.count("delete_object")
        path = self._obj_path(bucket, key)
        if version_id:
            return await self._delete_version(bucket, key, version_id)
        if await self._versioning_enabled(bucket):
            # versioned delete: archive the current version, then lay
            # down a delete marker — nothing is freed
            status, old = await self._meta_get("lookup", {"path": path})
            if status == 200 and \
                    not old.get("attr", {}).get("mode", 0) & 0o40000:
                await self._archive_version(path, old)
                await self._meta("delete", {"path": path,
                                            "free_chunks": False})
            marker_vid = geo_versioning.new_version_id()
            marker = {
                "path": (f"{geo_versioning.versions_dir(path)}"
                         f"/{marker_vid}"),
                "attr": {"mode": 0o600, "mtime": time.time(),
                         "crtime": time.time()},
                "chunks": [],
                "extended": {
                    geo_versioning.VERSION_ID_ATTR: marker_vid,
                    geo_versioning.DELETE_MARKER_ATTR: "true"},
            }
            await self._meta("create_entry", {"entry": marker})
            return web.Response(status=204, headers={
                "x-amz-delete-marker": "true",
                "x-amz-version-id": marker_vid})
        await self._meta("delete", {"path": path, "recursive": True})
        return web.Response(status=204)

    async def _delete_version(self, bucket: str, key: str,
                              version_id: str) -> web.Response:
        """DELETE ?versionId= — permanently removes that one version;
        deleting the CURRENT version promotes the newest remaining
        noncurrent version back to the object path (AWS semantics)."""
        path = self._obj_path(bucket, key)
        status, main = await self._meta_get("lookup", {"path": path})
        headers = {"x-amz-version-id": version_id}
        if status == 200 and \
                geo_versioning.entry_version_id(main) == version_id:
            # an archived sibling under the SAME version id can share
            # the chunk list (a versioned PUT that archived the old
            # entry but whose overwrite never landed): freeing here
            # would corrupt the copy about to be promoted
            twin, _ = await self._meta_get(
                "lookup",
                {"path": f"{geo_versioning.versions_dir(path)}"
                         f"/{version_id}"})
            await self._meta("delete", {"path": path,
                                        "free_chunks": twin != 200})
            promoted = await self._versions_of(bucket, key)
            if promoted and not geo_versioning.is_delete_marker(
                    promoted[0]):
                newest = promoted[0]
                restored = dict(newest)
                restored["path"] = path
                await self._meta("create_entry",
                                 {"entry": restored,
                                  "free_old_chunks": False})
                await self._meta("delete", {"path": newest["path"],
                                            "free_chunks": False})
            return web.Response(status=204, headers=headers)
        vpath = f"{geo_versioning.versions_dir(path)}/{version_id}"
        status, entry = await self._meta_get("lookup", {"path": vpath})
        if status == 200:
            if geo_versioning.is_delete_marker(entry):
                headers["x-amz-delete-marker"] = "true"
                # removing the newest delete marker un-deletes the key:
                # promote the newest remaining real version back
                await self._meta("delete", {"path": vpath})
                remaining = await self._versions_of(bucket, key)
                main_missing = (await self._meta_get(
                    "lookup", {"path": path}))[0] != 200
                if main_missing and remaining and \
                        not geo_versioning.is_delete_marker(remaining[0]):
                    newest = remaining[0]
                    restored = dict(newest)
                    restored["path"] = path
                    await self._meta("create_entry",
                                     {"entry": restored,
                                      "free_old_chunks": False})
                    await self._meta("delete", {"path": newest["path"],
                                                "free_chunks": False})
            else:
                await self._meta("delete", {"path": vpath})
        return web.Response(status=204, headers=headers)

    async def copy_object(self, request: web.Request, bucket: str,
                          key: str) -> web.Response:
        src = urllib.parse.unquote(
            request.headers["x-amz-copy-source"]).lstrip("/")
        src_path = f"{BUCKETS_DIR}/{src}"
        status, entry = await self._meta_get("lookup", {"path": src_path})
        if status != 200:
            return _error("NoSuchKey", src, 404)
        # full data copy through the filer: source and destination must not
        # share chunks or deleting one would free the other's blobs
        dst_path = self._obj_path(bucket, key)
        # a copy ONTO a versioned key is an overwrite like any PUT:
        # archive the current version, keep its chunks, stamp the new id
        versioned, old, version_id = \
            await self._versioned_overwrite_state(bucket, dst_path)
        extra_q = "?free_old_chunks=false" if versioned else ""
        mime = entry.get("attr", {}).get("mime") or "application/octet-stream"
        async with self._session.get(
                f"http://{self.filer_url}{urllib.parse.quote(src_path)}"
                ) as src_resp:
            if src_resp.status != 200:
                return _error("NoSuchKey", src, 404)
            async with self._session.put(
                    f"http://{self.filer_url}"
                    f"{urllib.parse.quote(dst_path)}{extra_q}",
                    data=src_resp.content,
                    headers={"Content-Type": mime}) as r:
                if r.status >= 300:
                    return _error("InternalError", "copy failed", 500)
        new_entry = None
        if versioned:
            if old is not None:
                await self._archive_version(dst_path, old)
            new_entry = await self._stamp_version(dst_path, version_id)
        if new_entry is None:
            status, new_entry = await self._meta_get("lookup",
                                                     {"path": dst_path})
        root = ET.Element("CopyObjectResult", xmlns=XMLNS)
        ET.SubElement(root, "ETag").text = f'"{_entry_etag(new_entry)}"'
        ET.SubElement(root, "LastModified").text = _iso(time.time())
        resp = _xml(root)
        if version_id:
            resp.headers["x-amz-version-id"] = version_id
        return resp

    async def bulk_delete(self, request: web.Request,
                          bucket: str) -> web.Response:
        body = await request.read()
        root = ET.fromstring(body)
        deleted = ET.Element("DeleteResult", xmlns=XMLNS)
        ns = ""
        if root.tag.startswith("{"):
            ns = root.tag.split("}")[0] + "}"
        for obj in root.findall(f"{ns}Object"):
            key = obj.find(f"{ns}Key").text
            vid_el = obj.find(f"{ns}VersionId")
            # route through delete_object so versioned buckets get the
            # archive + delete-marker semantics on the batch path too —
            # a raw meta delete here would free the current version's
            # chunks with no marker laid
            resp = await self.delete_object(
                bucket, key,
                version_id=(vid_el.text or "")
                if vid_el is not None else "")
            d = ET.SubElement(deleted, "Deleted")
            ET.SubElement(d, "Key").text = key
            marker = resp.headers.get("x-amz-delete-marker", "")
            if marker:
                ET.SubElement(d, "DeleteMarker").text = marker
                ET.SubElement(d, "DeleteMarkerVersionId").text = \
                    resp.headers.get("x-amz-version-id", "")
        return _xml(deleted)

    # --- listing ---
    async def list_objects(self, request: web.Request,
                           bucket: str) -> web.Response:
        if (await self.head_bucket(bucket)).status != 200:
            return _error("NoSuchBucket", bucket, 404)
        q = request.query
        v2 = q.get("list-type") == "2"
        prefix = q.get("prefix", "")
        delimiter = q.get("delimiter", "")
        max_keys = int(q.get("max-keys", 1000))
        marker = q.get("continuation-token" if v2 else "marker", "")
        if v2 and not marker:
            # V2 start-after applies only on the first page
            marker = q.get("start-after", "")
        url_encode = q.get("encoding-type") == "url"

        contents, common_prefixes, truncated, next_marker = \
            await self._walk_listing(bucket, prefix, delimiter, marker,
                                     max_keys)

        def enc(v: str) -> str:
            # encoding-type=url applies to every key-derived field
            return urllib.parse.quote(v) if url_encode else v

        root = ET.Element("ListBucketResult", xmlns=XMLNS)
        ET.SubElement(root, "Name").text = bucket
        ET.SubElement(root, "Prefix").text = enc(prefix)
        ET.SubElement(root, "MaxKeys").text = str(max_keys)
        ET.SubElement(root, "IsTruncated").text = \
            "true" if truncated else "false"
        if v2:
            # KeyCount includes CommonPrefixes (AWS ListObjectsV2 docs)
            ET.SubElement(root, "KeyCount").text = \
                str(len(contents) + len(common_prefixes))
            if truncated:
                ET.SubElement(root, "NextContinuationToken").text = \
                    next_marker
        elif truncated:
            ET.SubElement(root, "NextMarker").text = enc(next_marker)
        if delimiter:
            ET.SubElement(root, "Delimiter").text = enc(delimiter)
        if url_encode:
            ET.SubElement(root, "EncodingType").text = "url"
        for key, entry in contents:
            c = ET.SubElement(root, "Contents")
            ET.SubElement(c, "Key").text = enc(key)
            ET.SubElement(c, "LastModified").text = _iso(
                entry["attr"].get("mtime", 0))
            ET.SubElement(c, "ETag").text = f'"{_entry_etag(entry)}"'
            ET.SubElement(c, "Size").text = str(_entry_size(entry))
            # transitioned objects surface their warm placement (the
            # lifecycle daemon stamps x-amz-storage-class on Transition)
            ET.SubElement(c, "StorageClass").text = (
                (entry.get("extended") or {}).get(
                    "x-amz-storage-class") or "STANDARD")
        for p in sorted(common_prefixes):
            cp = ET.SubElement(root, "CommonPrefixes")
            ET.SubElement(cp, "Prefix").text = enc(p)
        return _xml(root)

    async def _walk_listing(self, bucket: str, prefix: str, delimiter: str,
                            marker: str, max_keys: int):
        """Stream the filer tree in global S3 key order.

        Inside one directory, sorting children by their EFFECTIVE key
        (name for files, name + "/" for directories) yields exact
        lexicographic order of all keys — a directory's subtree occupies
        the contiguous key range starting at name + "/" — so a sequential
        recursion IS the merge walk the reference streams with
        (s3api_objects_list_handlers.go). Subtrees entirely at or below
        the marker are pruned without listing them, common-prefix folds
        skip whole subtrees, and the walk stops at max_keys + 1: a page
        over a 100k-key bucket touches ~max_keys entries, not 100k.
        """
        base = f"{BUCKETS_DIR}/{bucket}"
        contents: list[tuple[str, dict]] = []
        common: set[str] = set()
        state = {"truncated": False, "last": ""}

        def add_common(p: str) -> bool:
            """Fold into a CommonPrefix; counts toward max-keys like S3."""
            if p in common:
                return True
            if marker and p <= marker \
                    and not (marker.startswith(p) and marker != p):
                # already returned as the last item of a previous page —
                # but a marker strictly INSIDE p's subtree (client-supplied
                # marker / start-after) means keys past it still roll up
                # into p, so p must be emitted (AWS semantics)
                return True
            if len(contents) + len(common) >= max_keys:
                state["truncated"] = True
                return False
            common.add(p)
            state["last"] = p
            return True

        async def emit(eff: str, is_dir: bool, e: dict) -> bool:
            """One child in effective-key order; False = stop the walk."""
            if is_dir:
                if eff.endswith(geo_versioning.VERSIONS_SUFFIX + "/"):
                    # noncurrent-version sibling directories are
                    # versioning plumbing, not keys (ListObjectVersions
                    # walks them; plain listings must not)
                    return True
                # prune: incompatible with the prefix, or the whole
                # subtree sorts at/below the marker
                if prefix and not (eff.startswith(prefix)
                                   or prefix.startswith(eff)):
                    return True
                if marker and marker >= eff \
                        and not marker.startswith(eff):
                    return True
                if (delimiter and eff.startswith(prefix)
                        and delimiter in eff[len(prefix):-1]):
                    # every key below folds into one CommonPrefix
                    cut = eff[len(prefix):].index(delimiter)
                    return add_common(eff[:len(prefix) + cut + 1])
                if delimiter and delimiter == "/" \
                        and eff.startswith(prefix) \
                        and len(eff) > len(prefix):
                    # the subtree itself is the common prefix — but only
                    # when strictly deeper than the prefix; a directory
                    # whose key EQUALS the prefix (prefix="photos/") must
                    # be walked so its children are listed
                    return add_common(eff)
                return await walk(e["path"], eff)
            key = eff
            if prefix and not key.startswith(prefix):
                return True
            if marker and key <= marker:
                return True
            if delimiter and delimiter in key[len(prefix):]:
                cut = key[len(prefix):].index(delimiter)
                return add_common(key[:len(prefix) + cut + 1])
            if len(contents) + len(common) >= max_keys:
                state["truncated"] = True
                return False
            contents.append((key, e))
            state["last"] = key
            return True

        async def walk(dir_path: str, key_prefix: str) -> bool:
            """Emit this subtree in key order; False = stop the walk.

            Store pages are NAME-ordered, but a directory's effective key
            (name + "/") can sort after later names ("foo.txt" < "foo/"),
            so children are held back until the page stream has passed
            their effective key — only items with eff <= the page's last
            raw name are safe to emit before fetching the next page.
            """
            start = ""
            include_start = "false"
            pending: list[tuple[str, bool, dict]] = []
            if marker and marker.startswith(key_prefix):
                # resume inside this directory: children sorting before
                # the marker's first path segment cannot contain keys past
                # it — EXCEPT directories whose name is a proper prefix of
                # that segment ("a" sorts before "a.txt" by name but its
                # keys "a/..." sort after). Probe those few names
                # explicitly into the merge, then start the store listing
                # at the segment itself.
                first_seg = marker[len(key_prefix):].split("/", 1)[0]
                if first_seg:
                    for i in range(1, len(first_seg)):
                        p = first_seg[:i]
                        st, e = await self._meta_get(
                            "lookup", {"path": f"{dir_path}/{p}"})
                        if st != 200:
                            continue
                        if bool(e["attr"].get("mode", 0) & 0o40000):
                            pending.append((key_prefix + p + "/", True, e))
                    start = first_seg
                    include_start = "true"
            while True:
                status, body = await self._meta_get("list", {
                    "dir": dir_path, "start": start,
                    "include_start": include_start, "limit": "1024"})
                entries = body.get("entries", [])
                for e in entries:
                    name = e["path"].rsplit("/", 1)[-1]
                    is_dir = bool(e["attr"].get("mode", 0) & 0o40000)
                    eff = key_prefix + name + ("/" if is_dir else "")
                    pending.append((eff, is_dir, e))
                pending.sort(key=lambda c: c[0])
                last_page = len(entries) < 1024
                if last_page:
                    safe, pending = pending, []
                else:
                    bound = key_prefix + \
                        entries[-1]["path"].rsplit("/", 1)[-1]
                    cut = 0
                    while cut < len(pending) and pending[cut][0] <= bound:
                        cut += 1
                    safe, pending = pending[:cut], pending[cut:]
                for eff, is_dir, e in safe:
                    if not await emit(eff, is_dir, e):
                        return False
                if last_page:
                    return True
                start = entries[-1]["path"].rsplit("/", 1)[-1]
                include_start = "false"

        await walk(base, "")
        # NextMarker must be the LAST emitted item — content key OR common
        # prefix — or common prefixes sorting after the last key would be
        # re-emitted on the next page
        next_marker = state["last"] if state["truncated"] else ""
        return contents, common, state["truncated"], next_marker

    # --- ListObjectVersions (GET /{bucket}?versions) ---

    async def list_object_versions(self, request: web.Request,
                                   bucket: str) -> web.Response:
        """Every version of every key: the current version (the object
        entry itself) plus the sibling ``<key>.versions/`` entries,
        newest first per key — delete markers as <DeleteMarker>.
        Supports prefix and max-keys; one page (no key-marker
        pagination in this subset)."""
        if (await self.head_bucket(bucket)).status != 200:
            return _error("NoSuchBucket", bucket, 404)
        q = request.query
        prefix = q.get("prefix", "")
        max_keys = int(q.get("max-keys", 1000))
        base = f"{BUCKETS_DIR}/{bucket}"
        # key -> [(entry, is_current)]
        found: dict[str, list[tuple[dict, bool]]] = {}
        truncated = {"v": False}

        def total() -> int:
            return sum(len(v) for v in found.values())

        async def walk(dir_path: str, key_prefix: str) -> None:
            start = ""
            while True:
                status, body = await self._meta_get(
                    "list", {"dir": dir_path, "start": start,
                             "limit": "1024"})
                entries = body.get("entries", []) if status == 200 else []
                for e in entries:
                    if truncated["v"]:
                        return
                    name = e["path"].rsplit("/", 1)[-1]
                    is_dir = bool(e["attr"].get("mode", 0) & 0o40000)
                    if is_dir and name.endswith(
                            geo_versioning.VERSIONS_SUFFIX):
                        key = key_prefix + name[:-len(
                            geo_versioning.VERSIONS_SUFFIX)]
                        if prefix and not key.startswith(prefix):
                            continue
                        for v in await self._versions_of(bucket, key):
                            if total() >= max_keys:
                                truncated["v"] = True
                                break
                            found.setdefault(key, []).append((v, False))
                        continue
                    if is_dir:
                        await walk(e["path"], key_prefix + name + "/")
                        continue
                    key = key_prefix + name
                    if prefix and not key.startswith(prefix):
                        continue
                    if total() >= max_keys:
                        truncated["v"] = True
                        return
                    found.setdefault(key, []).append((e, True))
                if len(entries) < 1024:
                    return
                start = entries[-1]["path"].rsplit("/", 1)[-1]

        await walk(base, "")
        root = ET.Element("ListVersionsResult", xmlns=XMLNS)
        ET.SubElement(root, "Name").text = bucket
        ET.SubElement(root, "Prefix").text = prefix
        ET.SubElement(root, "MaxKeys").text = str(max_keys)
        ET.SubElement(root, "IsTruncated").text = \
            "true" if truncated["v"] else "false"
        for key in sorted(found):
            versions = found[key]
            # current first (it is by construction the newest), then
            # the noncurrent ones — _versions_of already yields those
            # newest-first
            versions.sort(key=lambda ve: ve[1], reverse=True)
            for idx, (entry, is_current) in enumerate(versions):
                vid = geo_versioning.entry_version_id(entry)
                tag = ("DeleteMarker"
                       if geo_versioning.is_delete_marker(entry)
                       else "Version")
                el = ET.SubElement(root, tag)
                ET.SubElement(el, "Key").text = key
                ET.SubElement(el, "VersionId").text = vid
                ET.SubElement(el, "IsLatest").text = \
                    "true" if idx == 0 else "false"
                ET.SubElement(el, "LastModified").text = _iso(
                    entry["attr"].get("mtime", 0))
                if tag == "Version":
                    ET.SubElement(el, "ETag").text = \
                        f'"{_entry_etag(entry)}"'
                    ET.SubElement(el, "Size").text = \
                        str(_entry_size(entry))
        return _xml(root)

    # --- tagging (s3api_object_tagging_handlers.go; tags live in the
    #     entry's extended attributes) ---
    async def _save_tags(self, path: str, tags: dict) -> web.Response | None:
        status, entry = await self._meta_get("lookup", {"path": path})
        if status != 200:
            return _error("NoSuchKey", path, 404)
        extended = entry.get("extended") or {}
        if tags:
            extended["x-amz-tagging"] = urllib.parse.urlencode(tags)
        else:
            extended.pop("x-amz-tagging", None)
        entry["extended"] = extended
        await self._meta("update_entry", {"entry": entry})
        return None

    async def get_tagging(self, bucket: str, key: str) -> web.Response:
        path = self._obj_path(bucket, key)
        status, entry = await self._meta_get("lookup", {"path": path})
        if status != 200:
            return _error("NoSuchKey", key, 404)
        raw = (entry.get("extended") or {}).get("x-amz-tagging", "")
        root = ET.Element("Tagging", xmlns=XMLNS)
        tagset = ET.SubElement(root, "TagSet")
        for k, v in urllib.parse.parse_qsl(raw):
            tag = ET.SubElement(tagset, "Tag")
            ET.SubElement(tag, "Key").text = k
            ET.SubElement(tag, "Value").text = v
        return _xml(root)

    async def put_tagging(self, request: web.Request, bucket: str,
                          key: str) -> web.Response:
        body = await request.read()
        try:
            root = ET.fromstring(body)
        except ET.ParseError as e:
            return _error("MalformedXML", str(e), 400)
        ns = root.tag.split("}")[0] + "}" if root.tag.startswith("{") else ""
        tags = {}
        for tag in root.iter(f"{ns}Tag"):
            k = tag.find(f"{ns}Key")
            v = tag.find(f"{ns}Value")
            if k is not None and k.text:
                tags[k.text] = v.text or "" if v is not None else ""
        if len(tags) > 10:
            return _error("BadRequest", "too many tags", 400)
        err = await self._save_tags(self._obj_path(bucket, key), tags)
        return err or web.Response(status=200)

    async def delete_tagging(self, bucket: str, key: str) -> web.Response:
        err = await self._save_tags(self._obj_path(bucket, key), {})
        return err or web.Response(status=204)

    # --- browser post-policy upload (weed/s3api/policy) ---
    async def post_policy_upload(self, request: web.Request,
                                 bucket: str) -> web.Response:
        if not request.content_type.startswith("multipart/"):
            return _error("BadRequest", "expected multipart form", 400)
        fields: dict[str, str] = {"bucket": bucket}
        file_data: Optional[bytes] = None
        file_name = ""
        reader = await request.multipart()
        while True:
            part = await reader.next()
            if part is None:
                break
            name = (part.name or "").lower()
            if name == "file":
                file_data = bytes(await part.read(decode=False))
                file_name = part.filename or ""
                break  # per the S3 spec, fields after `file` are ignored
            fields[name] = (await part.read(decode=False)).decode(
                "utf-8", "replace")
        if file_data is None:
            return _error("BadRequest", "missing file field", 400)
        if self.iam.enabled:
            ok, why, length_range = auth_mod.verify_post_policy(
                fields, self.iam)
            if not ok:
                # sentinel match — a *condition* merely named
                # content-length-range failing is still AccessDenied
                if why == auth_mod.ERR_BAD_LENGTH_RANGE:
                    return _error("InvalidPolicyDocument", why, 400)
                return _error("AccessDenied", why, 403)
            # content-length-range is the one policy condition only the
            # caller can check (it needs the actual payload size)
            if length_range is not None:
                lo, hi = length_range
                if len(file_data) < lo:
                    return _error("EntityTooSmall",
                                  f"{len(file_data)} < {lo}", 400)
                if len(file_data) > hi:
                    return _error("EntityTooLarge",
                                  f"{len(file_data)} > {hi}", 400)
            # the signing identity still needs Write on this bucket — a
            # policy signature must not bypass the per-action ACL
            # (V2 policies carry the bare key in AWSAccessKeyId)
            akid = (fields.get("x-amz-credential", "").split("/")[0]
                    or fields.get("awsaccesskeyid", ""))
            found = self.iam.lookup(akid)
            if found is None or not found[0].allows(auth_mod.ACTION_WRITE,
                                                    bucket):
                return _error("AccessDenied",
                              f"identity may not Write on {bucket}", 403)
        key = fields.get("key", "")
        if not key:
            return _error("BadRequest", "missing key", 400)
        key = key.replace("${filename}", file_name)
        if (await self.head_bucket(bucket)).status != 200:
            return _error("NoSuchBucket", bucket, 404)
        path = self._obj_path(bucket, key)
        headers = {"Content-Type": fields.get("content-type",
                                              "application/octet-stream")}
        async with self._session.put(
                f"http://{self.filer_url}{urllib.parse.quote(path)}",
                data=file_data, headers=headers) as r:
            if r.status >= 300:
                return _error("InternalError", f"filer: {r.status}", 500)
        status = int(fields.get("success_action_status", "204"))
        return web.Response(status=status if status in (200, 201, 204)
                            else 204)

    # --- multipart ---
    async def initiate_multipart(self, bucket: str,
                                 key: str) -> web.Response:
        upload_id = uuid.uuid4().hex
        await self._meta("create_entry", {"entry": {
            "path": f"{UPLOADS_DIR}/{upload_id}",
            "attr": {"mode": 0o40770, "mtime": time.time(),
                     "crtime": time.time()},
            "chunks": [],
            "extended": {"bucket": bucket, "key": key},
        }})
        root = ET.Element("InitiateMultipartUploadResult", xmlns=XMLNS)
        ET.SubElement(root, "Bucket").text = bucket
        ET.SubElement(root, "Key").text = key
        ET.SubElement(root, "UploadId").text = upload_id
        return _xml(root)

    async def upload_part(self, request: web.Request, bucket: str,
                          key: str) -> web.Response:
        upload_id = request.query["uploadId"]
        status, _ = await self._meta_get(
            "lookup", {"path": f"{UPLOADS_DIR}/{upload_id}"})
        if status != 200:
            return _error("NoSuchUpload", upload_id, 404)
        part = int(request.query["partNumber"])
        if not 1 <= part <= 10000:
            return _error("InvalidPartNumber", str(part), 400)
        path = f"{UPLOADS_DIR}/{upload_id}/{part:05d}.part"
        try:
            payload = await self._request_payload(request)
        except auth_mod.ChunkedSigV4Error as e:
            return _error("SignatureDoesNotMatch", str(e), 403)
        async with self._session.put(
                f"http://{self.filer_url}{path}",
                data=payload) as r:
            if r.status >= 300:
                return _error("InternalError", f"filer: {r.status}", 500)
        status, entry = await self._meta_get("lookup", {"path": path})
        return web.Response(status=200,
                            headers={"ETag": f'"{_entry_etag(entry)}"'})

    async def complete_multipart(self, request: web.Request, bucket: str,
                                 key: str) -> web.Response:
        """Concatenate part chunk lists (filer_multipart.go:59-200)."""
        upload_id = request.query["uploadId"]
        status, _ = await self._meta_get(
            "lookup", {"path": f"{UPLOADS_DIR}/{upload_id}"})
        if status != 200:
            return _error("NoSuchUpload", upload_id, 404)
        status, listing = await self._meta_get(
            "list", {"dir": f"{UPLOADS_DIR}/{upload_id}", "limit": "10001"})
        parts = sorted(
            (e for e in listing.get("entries", [])
             if e["path"].endswith(".part")),
            key=lambda e: int(e["path"].rsplit("/", 1)[-1].split(".")[0]))
        all_chunks = []
        offset = 0
        for p in parts:
            chunks = p.get("chunks", [])
            if any(c.get("is_chunk_manifest") for c in chunks):
                # super-chunked part: flatten through the filer so nested
                # offsets shift correctly and the manifest blobs are freed
                status, body = await self._meta_get(
                    "resolve_chunks", {"path": p["path"],
                                       "shift": str(offset),
                                       "free_manifests": "true"})
                if status != 200:
                    return _error("InternalError",
                                  "part manifest resolution failed", 500)
                all_chunks.extend(body["chunks"])
            else:
                for c in chunks:
                    all_chunks.append({**c, "offset": offset + c["offset"]})
            offset += _entry_size(p)
        final_path = self._obj_path(bucket, key)
        # a multipart complete ONTO a versioned key is an overwrite:
        # the replaced entry's chunks must survive (the archive adopts
        # them) and the new entry carries its version id from birth
        versioned, old, version_id = \
            await self._versioned_overwrite_state(bucket, final_path)
        entry = {
            "path": final_path,
            "attr": {"mode": 0o100660, "mtime": time.time(),
                     "crtime": time.time(),
                     "mime": "application/octet-stream"},
            "chunks": all_chunks,
        }
        if version_id:
            entry["extended"] = {
                geo_versioning.VERSION_ID_ATTR: version_id}
        status, _ = await self._meta(
            "create_entry",
            {"entry": entry, "free_old_chunks": not versioned})
        if status != 200:
            return _error("InternalError", "complete failed", 500)
        if versioned and old is not None:
            await self._archive_version(final_path, old)
        # drop the upload dir but keep the chunks (they now belong to the key)
        await self._meta("delete", {"path": f"{UPLOADS_DIR}/{upload_id}",
                                    "recursive": True,
                                    "free_chunks": False})
        root = ET.Element("CompleteMultipartUploadResult", xmlns=XMLNS)
        ET.SubElement(root, "Bucket").text = bucket
        ET.SubElement(root, "Key").text = key
        ET.SubElement(root, "ETag").text = f'"{hashlib.md5(upload_id.encode()).hexdigest()}-{len(parts)}"'
        resp = _xml(root)
        if version_id:
            resp.headers["x-amz-version-id"] = version_id
        return resp

    async def abort_multipart(self, request: web.Request, bucket: str,
                              key: str) -> web.Response:
        upload_id = request.query["uploadId"]
        await self._meta("delete", {"path": f"{UPLOADS_DIR}/{upload_id}",
                                    "recursive": True})
        return web.Response(status=204)

    async def list_parts(self, request: web.Request, bucket: str,
                         key: str) -> web.Response:
        upload_id = request.query["uploadId"]
        status, listing = await self._meta_get(
            "list", {"dir": f"{UPLOADS_DIR}/{upload_id}", "limit": "10000"})
        if status != 200:
            return _error("NoSuchUpload", upload_id, 404)
        root = ET.Element("ListPartsResult", xmlns=XMLNS)
        ET.SubElement(root, "Bucket").text = bucket
        ET.SubElement(root, "Key").text = key
        ET.SubElement(root, "UploadId").text = upload_id
        for e in listing.get("entries", []):
            if not e["path"].endswith(".part"):
                continue
            p = ET.SubElement(root, "Part")
            num = int(e["path"].rsplit("/", 1)[-1].split(".")[0])
            ET.SubElement(p, "PartNumber").text = str(num)
            ET.SubElement(p, "Size").text = str(_entry_size(e))
            ET.SubElement(p, "ETag").text = f'"{_entry_etag(e)}"'
        return _xml(root)


def _entry_size(entry: dict) -> int:
    return max((c["offset"] + c["size"] for c in entry.get("chunks", [])),
               default=0)


def _entry_etag(entry: dict) -> str:
    chunks = entry.get("chunks", [])
    if len(chunks) == 1:
        return chunks[0].get("etag", "")
    h = hashlib.md5()
    for c in chunks:
        h.update(c.get("etag", "").encode())
    return f"{h.hexdigest()}-{len(chunks)}" if chunks else ""


def _iso(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(ts))


async def run_s3(host: str, port: int, filer_url: str,
                 **kwargs) -> tuple["S3Server", web.AppRunner]:
    """Serve a gateway in front of `filer_url` on host:port (0 picks a
    free port) on the running loop; returns the gateway (``server.url``
    is host:port) and its runner, as run_filer does.
    ``await runner.cleanup()`` stops it."""
    sock = http.listen_socket(host, port)
    kwargs.setdefault("url", f"{host}:{sock.getsockname()[1]}")
    server = S3Server(filer_url, **kwargs)
    runner = await http.start_app(server.app, sock)
    log.info("s3 gateway on %s -> filer %s", server.url, filer_url)
    return server, runner
