"""AWS Signature V4 client-side signing.

The port's copy of seaweedfs_tpu/s3/sigv4.py, reduced to
``sign_request`` (upstream weed/s3api/auth_signature_v4.go, the signing
half): the headers it returns are the reference's for the same request
and time, so the object-store tier (storage/backend.py
``S3ObjectStore``) can talk to the reference's S3 gateway or any
S3-compatible endpoint. The verifier and the gateway are not ported.
"""

from __future__ import annotations

import hashlib
import hmac
import time
import urllib.parse


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sign_request(method: str, url: str, headers: dict, payload: bytes,
                 access_key: str, secret_key: str,
                 region: str = "us-east-1", service: str = "s3",
                 now: float | None = None) -> dict:
    """Return headers with Host, x-amz-date, x-amz-content-sha256 and a
    SigV4 Authorization added."""
    parsed = urllib.parse.urlparse(url)
    t = time.gmtime(now if now is not None else time.time())
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", t)
    date = time.strftime("%Y%m%d", t)
    payload_hash = hashlib.sha256(payload).hexdigest()

    out = dict(headers)
    out["host"] = parsed.netloc
    out["x-amz-date"] = amz_date
    out["x-amz-content-sha256"] = payload_hash

    signed_headers = sorted(h.lower() for h in out)
    canonical_headers = "".join(
        f"{h}:{' '.join(str(out[_orig(out, h)]).split())}\n"
        for h in signed_headers)
    # sort (encoded key, encoded value) tuples, not joined "k=v" strings:
    # the two orders diverge when one key prefixes another (e.g. "key"
    # vs "key1") because '=' is compared against the longer key's next
    # character
    query = sorted(
        (urllib.parse.quote(k, safe="-_.~"),
         urllib.parse.quote(v, safe="-_.~"))
        for k, v in urllib.parse.parse_qsl(parsed.query,
                                           keep_blank_values=True))
    canonical = "\n".join([
        method,
        urllib.parse.quote(parsed.path or "/", safe="/-_.~"),
        "&".join(f"{k}={v}" for k, v in query),
        canonical_headers,
        ";".join(signed_headers),
        payload_hash,
    ])
    scope = f"{date}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical.encode()).hexdigest()])
    k = _hmac(f"AWS4{secret_key}".encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    signature = hmac.new(k, string_to_sign.encode(),
                         hashlib.sha256).hexdigest()
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={';'.join(signed_headers)}, Signature={signature}")
    return out


def _orig(headers: dict, lower: str) -> str:
    for k in headers:
        if k.lower() == lower:
            return k
    return lower
