"""AWS Signature Version 2 — header and presigned query schemes.

The port's copy of seaweedfs_tpu/s3/sigv2.py, whole.

Counterpart of the reference's V2 acceptance path
(weed/s3api/auth_signature_v2.go:1-412): the gateway accepts V2 alongside
V4 so legacy SDKs keep working. Both halves live here — `sign_header` /
`presign` produce requests, `string_to_sign` / `presigned_string_to_sign`
are what the server verifies against — so client and server cannot drift.

    Authorization = "AWS" + " " + AccessKeyId + ":" + Signature
    Signature     = Base64(HMAC-SHA1(SecretKey, StringToSign))
    StringToSign  = Method \n Content-MD5 \n Content-Type \n Date \n
                    CanonicalizedAmzHeaders + CanonicalizedResource

Presigned V2 rides the query string (AWSAccessKeyId, Expires, Signature)
with the epoch Expires in the Date slot.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import time
import urllib.parse

# Sub-resources included in CanonicalizedResource, alphabetical — the
# same whitelist AWS documents (and auth_signature_v2.go pins; 'tagging'
# is deliberately NOT in the reference's V2 list)
RESOURCE_LIST = (
    "acl", "delete", "lifecycle", "location", "logging", "notification",
    "partNumber", "policy", "requestPayment", "response-cache-control",
    "response-content-disposition", "response-content-encoding",
    "response-content-language", "response-content-type",
    "response-expires", "torrent", "uploadId", "uploads", "versionId",
    "versioning", "versions", "website",
)


def canonicalized_amz_headers(headers) -> str:
    """Lowercased x-amz-* headers, sorted, values whitespace-collapsed,
    one "k:v\n" line each. `headers` is any .items()-able mapping."""
    amz = {}
    for k, v in headers.items():
        lk = k.lower()
        if lk.startswith("x-amz-"):
            v = " ".join(str(v).split())
            amz[lk] = f"{amz[lk]},{v}" if lk in amz else v
    return "".join(f"{k}:{amz[k]}\n" for k in sorted(amz))


def canonicalized_resource(path: str, query) -> str:
    """URL path plus whitelisted sub-resources (sorted, with values)."""
    subs = []
    for k in sorted(set(query.keys())):
        if k in RESOURCE_LIST:
            v = query[k]
            subs.append(f"{k}={v}" if v else k)
    out = path or "/"
    if subs:
        out += "?" + "&".join(subs)
    return out


def string_to_sign(method: str, path: str, query, headers) -> str:
    """Header-scheme StringToSign. If x-amz-date is signed, the Date slot
    is empty (the amz header wins, per the V2 spec)."""
    h = {k.lower(): v for k, v in headers.items()}
    date = "" if "x-amz-date" in h else h.get("date", "")
    return (f"{method}\n{h.get('content-md5', '')}\n"
            f"{h.get('content-type', '')}\n{date}\n"
            f"{canonicalized_amz_headers(headers)}"
            f"{canonicalized_resource(path, query)}")


def presigned_string_to_sign(method: str, path: str, query,
                             headers, expires: str) -> str:
    """Presigned scheme: the epoch Expires rides the Date slot."""
    h = {k.lower(): v for k, v in headers.items()}
    return (f"{method}\n{h.get('content-md5', '')}\n"
            f"{h.get('content-type', '')}\n{expires}\n"
            f"{canonicalized_amz_headers(headers)}"
            f"{canonicalized_resource(path, query)}")


def signature(secret_key: str, sts: str) -> str:
    return base64.b64encode(
        hmac.new(secret_key.encode(), sts.encode(),
                 hashlib.sha1).digest()).decode()


def sign_header(method: str, url: str, headers: dict,
                access_key: str, secret_key: str,
                now: float | None = None) -> dict:
    """Client side: return headers with Date + a V2 Authorization."""
    parsed = urllib.parse.urlparse(url)
    out = dict(headers)
    if not any(k.lower() in ("date", "x-amz-date") for k in out):
        out["Date"] = time.strftime(
            "%a, %d %b %Y %H:%M:%S GMT",
            time.gmtime(now if now is not None else time.time()))
    query = dict(urllib.parse.parse_qsl(parsed.query,
                                        keep_blank_values=True))
    sts = string_to_sign(method, parsed.path or "/", query, out)
    out["Authorization"] = (
        f"AWS {access_key}:{signature(secret_key, sts)}")
    return out


def presign(method: str, url: str, access_key: str, secret_key: str,
            expires_in: int = 900, now: float | None = None) -> str:
    """Client side: append AWSAccessKeyId/Expires/Signature to the URL."""
    parsed = urllib.parse.urlparse(url)
    expires = str(int((now if now is not None else time.time())
                      + expires_in))
    query = dict(urllib.parse.parse_qsl(parsed.query,
                                        keep_blank_values=True))
    sts = presigned_string_to_sign(method, parsed.path or "/", query, {},
                                   expires)
    sig = signature(secret_key, sts)
    extra = urllib.parse.urlencode({
        "AWSAccessKeyId": access_key, "Expires": expires,
        "Signature": sig})
    sep = "&" if parsed.query else "?"
    return url + sep + extra
