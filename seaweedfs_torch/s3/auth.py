"""S3 auth: identities with per-action ACLs, streaming chunked SigV4

The port's copy of seaweedfs_tpu/s3/auth.py, whole.
payloads, and browser post-policy verification.

Counterparts of the reference's auth stack:
- IdentityAccessManagement with per-identity actions
  (weed/s3api/auth_credentials.go:25-150): identities are loaded from a
  JSON config; each carries credentials and allowed actions
  ("Read"/"Write"/"List"/"Tagging"/"Admin", optionally ":bucket"-scoped).
- STREAMING-AWS4-HMAC-SHA256-PAYLOAD chunked bodies
  (weed/s3api/chunked_reader_v4.go): the framing is stripped and each
  chunk signature is verified against the rolling SigV4 chain.
- POST policy uploads (weed/s3api/policy/post-policy): base64 policy
  document signature + expiry + condition checks.
"""

from __future__ import annotations

import base64
import binascii
import hashlib
import hmac
import json
import time
from dataclasses import dataclass, field
from typing import Optional

ACTION_READ = "Read"
ACTION_WRITE = "Write"
ACTION_LIST = "List"
ACTION_TAGGING = "Tagging"
ACTION_ADMIN = "Admin"


@dataclass
class Identity:
    name: str
    credentials: list[dict] = field(default_factory=list)  # accessKey/secretKey
    actions: list[str] = field(default_factory=list)

    def allows(self, action: str, bucket: str = "") -> bool:
        for a in self.actions:
            base, _, scope = a.partition(":")
            if scope and scope != bucket:
                continue
            # Admin (global or bucket-scoped) implies every action there
            if base == ACTION_ADMIN or base == action:
                return True
        return False

    def secret_for(self, access_key: str) -> Optional[str]:
        for c in self.credentials:
            if c.get("accessKey") == access_key:
                return c.get("secretKey")
        return None


class Iam:
    """Identity registry (auth_credentials.go)."""

    def __init__(self, identities: Optional[list[dict]] = None):
        self.identities = [Identity(name=d.get("name", ""),
                                    credentials=d.get("credentials", []),
                                    actions=d.get("actions", []))
                           for d in (identities or [])]

    @classmethod
    def from_file(cls, path: str) -> "Iam":
        with open(path) as f:
            return cls(json.load(f).get("identities", []))

    @property
    def enabled(self) -> bool:
        return bool(self.identities)

    def lookup(self, access_key: str) -> Optional[tuple[Identity, str]]:
        for ident in self.identities:
            secret = ident.secret_for(access_key)
            if secret is not None:
                return ident, secret
        return None


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def signing_key(secret: str, date: str, region: str,
                service: str = "s3") -> bytes:
    k = _hmac(f"AWS4{secret}".encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


class ChunkedSigV4Error(ValueError):
    pass


async def read_chunked_sigv4(content, seed_signature: str = "",
                             sign_key: Optional[bytes] = None,
                             amz_date: str = "", scope: str = "") -> bytes:
    """Decode a STREAMING-AWS4-HMAC-SHA256-PAYLOAD body
    (chunked_reader_v4.go): frames of
      <hex size>;chunk-signature=<sig>\\r\\n <data> \\r\\n
    ending with a zero-length chunk. When sign_key is given, every chunk
    signature is verified against the rolling chain seeded by the request
    signature."""
    out = bytearray()
    prev_sig = seed_signature
    while True:
        header = bytearray()
        while not header.endswith(b"\r\n"):
            b = await content.read(1)
            if not b:
                raise ChunkedSigV4Error("truncated chunk header")
            header += b
            if len(header) > 1024:
                raise ChunkedSigV4Error("oversized chunk header")
        text = header[:-2].decode("ascii", "replace")
        size_hex, _, ext = text.partition(";")
        try:
            size = int(size_hex, 16)
        except ValueError:
            raise ChunkedSigV4Error(f"bad chunk size {size_hex!r}")
        sig = ""
        if ext.startswith("chunk-signature="):
            sig = ext[len("chunk-signature="):]
        data = b""
        if size:
            data = await content.readexactly(size)
        trailer = await content.readexactly(2)
        if trailer != b"\r\n":
            raise ChunkedSigV4Error("missing chunk terminator")

        if sign_key is not None:
            string_to_sign = "\n".join([
                "AWS4-HMAC-SHA256-PAYLOAD", amz_date, scope, prev_sig,
                hashlib.sha256(b"").hexdigest(),
                hashlib.sha256(data).hexdigest()])
            want = hmac.new(sign_key, string_to_sign.encode(),
                            hashlib.sha256).hexdigest()
            if not hmac.compare_digest(want, sig):
                raise ChunkedSigV4Error("chunk signature mismatch")
            prev_sig = sig
        if size == 0:
            return bytes(out)
        out += data


# sentinel for a malformed content-length-range in a signed policy — the
# upload handler maps exactly this to 400 InvalidPolicyDocument
ERR_BAD_LENGTH_RANGE = "invalid content-length-range"


def verify_post_policy(
        fields: dict, iam: Iam) -> tuple[bool, str, Optional[tuple[int, int]]]:
    """Verify a browser POST upload (policy/post-policy): the policy is a
    base64 JSON document signed with the SigV4 chain; expiry and eq /
    starts-with conditions must hold for the submitted fields. Returns
    (ok, why, content_length_range) — the range comes from THIS parse so
    the upload handler, the only place that sees the payload size, never
    re-parses (and can't drift from) the verified document."""
    policy_b64 = fields.get("policy", "")
    if not policy_b64:
        return False, "missing policy", None
    if "x-amz-credential" not in fields and "awsaccesskeyid" in fields:
        # V2 policy signature (doesPolicySignatureV2Match,
        # auth_signature_v2.go): Base64(HMAC-SHA1(secret, policy))
        found = iam.lookup(fields.get("awsaccesskeyid", ""))
        if found is None:
            return False, "unknown access key", None
        _, secret = found
        want = base64.b64encode(hmac.new(
            secret.encode(), policy_b64.encode(), hashlib.sha1).digest()
        ).decode()
        if not hmac.compare_digest(want, fields.get("signature", "")):
            return False, "signature mismatch", None
    else:
        credential = fields.get("x-amz-credential", "")
        signature = fields.get("x-amz-signature", "")
        try:
            akid, date, region, service, _ = credential.split("/")
        except ValueError:
            return False, "malformed credential", None
        found = iam.lookup(akid)
        if found is None:
            return False, "unknown access key", None
        _, secret = found
        key = signing_key(secret, date, region, service)
        want = hmac.new(key, policy_b64.encode(),
                        hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, signature):
            return False, "signature mismatch", None
    try:
        policy = json.loads(base64.b64decode(policy_b64))
    except (ValueError, binascii.Error):
        return False, "unreadable policy", None
    exp = policy.get("expiration", "")
    try:
        import calendar
        deadline = calendar.timegm(time.strptime(
            exp.split(".")[0].rstrip("Z"), "%Y-%m-%dT%H:%M:%S"))
    except ValueError:
        return False, "bad expiration", None
    if time.time() > deadline:
        return False, "policy expired", None
    length_range: Optional[tuple[int, int]] = None
    for cond in policy.get("conditions", []):
        if isinstance(cond, dict):
            for k, v in cond.items():
                k = k.lstrip("$").lower()
                if k == "bucket":
                    if fields.get("bucket", "") != v:
                        return False, f"condition failed: bucket != {v}", None
                elif fields.get(k, "") != v:
                    return False, f"condition failed: {k}", None
        elif isinstance(cond, list) and len(cond) == 3:
            op, name, val = cond
            name = str(name).lstrip("$").lower()
            have = fields.get(name, "")
            if op == "eq" and have != val:
                return False, f"condition failed: {name}", None
            if op == "starts-with" and not have.startswith(val):
                return False, f"condition failed: {name} prefix", None
            if str(op).lower() == "content-length-range":
                # enforced by the caller (only it sees the payload size);
                # malformed bounds in a *signed* policy are the signer's
                # bug — reject as a bad document, not a 500
                try:
                    length_range = (int(name), int(val))
                except (TypeError, ValueError):
                    return False, ERR_BAD_LENGTH_RANGE, None
    return True, "", length_range