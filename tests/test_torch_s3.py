"""The port's S3 gateway (seaweedfs_torch/s3/) against the reference's.

Three kinds of case, each on the same inputs in both packages:

- unit parity: ``signing_key`` and the V4 canonical form (with AWS's
  published vectors), the V4 string to sign for the same requests,
  ``read_chunked_sigv4`` on a good body and on tampered chunks, V2
  header and presigned signatures, post-policy verification,
  ``Iam.from_file`` / ``lookup`` / the actions on one ``s3.json``, the
  ``geo.rules`` XML cases (accepted ones round-trip, refused ones fail
  with the same message), version ids, and the gateways' ops routes;
- the reference's behaviour cases of tests/test_s3_e2e.py,
  tests/test_s3_completeness.py and tests/test_s3_sigv2.py, each run
  against a gateway of each package (parametrised by ``pkg``: the
  reference's on ``cluster_util.Cluster``, the port's on
  ``LocalCluster.add_s3``);
- an end-to-end parity script: one seeded sequence of signed S3
  requests (buckets, objects, ranges, copies, bulk deletes, V1 and V2
  listings paged, multipart, tagging, a POST policy, versioning with
  overwrites, delete markers and ``?versionId``, the replication and
  lifecycle configurations, a reader refused) against each package's
  gateway. Status codes, the compared headers, XML bodies and object
  bytes must be equal after normalising only version ids, upload ids
  (and the multipart ETag derived from one) and dates.

The port's volume servers run the kernel's plain version
(``coder_name="torch", device="cpu"``). D11 (ROADMAP Queue 3) gets its
gateway-level case here; its signer-level twin is
tests/test_torch_tier.py::test_escaped_key_is_refused_by_both_signers_alike.
"""

import asyncio
import base64
import hashlib
import hmac
import json
import random
import re
import subprocess
import sys
import time
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path

import pytest
from aiohttp.test_utils import make_mocked_request

import test_s3_completeness as ref_comp
import test_s3_e2e as ref_e2e
import test_s3_sigv2 as ref_v2
from cluster_util import Cluster, free_port
from seaweedfs_torch.client import Client
from seaweedfs_torch.geo import rules as prules
from seaweedfs_torch.geo import versioning as pver
from seaweedfs_torch.s3 import auth as pauth
from seaweedfs_torch.s3 import s3_server as pserver
from seaweedfs_torch.s3 import sigv2 as psigv2
from seaweedfs_torch.server.local_cluster import LocalCluster
from seaweedfs_torch.shell import commands as shell_commands
from seaweedfs_tpu.geo import rules as rrules
from seaweedfs_tpu.geo import versioning as rver
from seaweedfs_tpu.s3 import auth as rauth
from seaweedfs_tpu.s3 import s3_server as rserver
from seaweedfs_tpu.s3 import sigv2 as rsigv2
from seaweedfs_tpu.s3.sigv4 import sign_request

REPO = Path(__file__).resolve().parent.parent
PKGS = ("reference", "port")
# the identities of both reference test modules, one s3.json
IDENTITIES = ref_comp.IDENTITIES + ref_v2.IDENTITIES


# --- the gateways ---

class Stack:
    """One package's cluster (one volume server), its filers and its two
    gateways: anonymous (``s3``) and with IDENTITIES (``s3_iam``)."""

    def __init__(self, pkg: str):
        self.pkg = pkg
        if pkg == "reference":
            self.cluster = Cluster(n_volume_servers=1, pulse=0.15)
        else:
            self.cluster = LocalCluster(1, coder_name="torch", device="cpu",
                                        pulse=0.15)
        self.s3 = self.gateway()
        self.s3_iam = self.gateway(iam_of(pkg)(IDENTITIES))
        self.s3_parity = self.gateway(iam_of(pkg)(IDENTITIES))

    def gateway(self, iam=None):
        kw = {} if iam is None else {"iam": iam}
        if self.pkg == "reference":
            filer = self.cluster.add_filer(chunk_size=16 * 1024)
            port = free_port()
            gw = rserver.S3Server(filer.url, **kw)
            self.cluster.runners.append(self.cluster.serve(gw.app, port))
            gw.url = f"127.0.0.1:{port}"
        else:
            filer = self.cluster.add_filer("memory", 16 * 1024)
            gw = self.cluster.add_s3(filer, **kw)
        gw._test_filer = filer
        return gw

    def shutdown(self) -> None:
        self.cluster.shutdown()


def iam_of(pkg: str):
    return (rauth if pkg == "reference" else pauth).Iam


@pytest.fixture(scope="module", params=PKGS)
def stack(request):
    s = Stack(request.param)
    yield s
    s.shutdown()


# --- the reference's behaviour cases, against each package's gateway ---

E2E_CASES = [
    "test_bucket_lifecycle", "test_object_crud", "test_listing_v1_v2",
    "test_listing_prefix_plus_delimiter",
    "test_listing_paginated_common_prefixes",
    "test_listing_marker_inside_common_prefix", "test_multipart_upload",
    "test_copy_object", "test_bulk_delete", "test_listing_global_key_order",
    "test_get_directory_key_is_404", "test_double_bucket_create_conflicts",
    "test_bogus_upload_id_404"]
COMPLETENESS_CASES = [
    "test_object_tagging_crud", "test_put_object_with_tagging_header",
    "test_chunked_sigv4_end_to_end", "test_list_v2_start_after_and_encoding"]
IAM_CASES = [
    (ref_comp, "test_acl_reader_cannot_write"),
    (ref_comp, "test_acl_bucket_scoped_write"),
    (ref_comp, "test_presigned_url_get_and_put"),
    (ref_comp, "test_post_policy_upload"),
    (ref_comp, "test_post_policy_content_length_range"),
    (ref_v2, "test_v2_header_auth_crud"),
    (ref_v2, "test_v2_rejections"),
    (ref_v2, "test_v2_presigned_url"),
    (ref_v2, "test_v2_post_policy_upload"),
    (ref_v2, "test_v4_prefix_query_keys_end_to_end"),
    (ref_v2, "test_presigned_expires_bounds")]


@pytest.mark.parametrize("case", E2E_CASES)
def test_e2e_case(stack, case):
    getattr(ref_e2e, case)(stack.s3)


@pytest.mark.parametrize("case", COMPLETENESS_CASES)
def test_completeness_case(stack, case):
    getattr(ref_comp, case)(stack.s3)


def test_multipart_with_manifested_part(stack):
    """A part manifested by its filer (a batch of 3 chunks) completes
    with its offsets rebased."""
    ref_comp.test_multipart_with_manifested_part(stack.cluster, stack.s3)


@pytest.mark.parametrize("case", [name for _, name in IAM_CASES])
def test_identity_case(stack, case):
    mod = dict((name, m) for m, name in IAM_CASES)[case]
    getattr(mod, case)(stack.s3_iam)


@pytest.mark.parametrize("pkg", PKGS)
def test_sigv4_auth_required(pkg):
    """An auth-enabled gateway refuses an anonymous request and a
    tampered signature and accepts a signed one (the reference's case,
    on each package's S3Server)."""
    server_cls = (rserver if pkg == "reference" else pserver).S3Server
    server = server_cls("127.0.0.1:1", access_key="AKID",
                        secret_key="SECRET")
    url = "http://example/"
    signed = sign_request("GET", url, {}, b"", "AKID", "SECRET",
                          now=1_785_283_200.0)
    good = make_mocked_request("GET", "/", headers=signed)
    assert server._check_auth(good) is None
    assert server._check_auth(make_mocked_request(
        "GET", "/", headers={"Authorization": "nope"})) is not None
    sig = signed["Authorization"].rsplit("=", 1)[1]
    tampered = dict(signed, Authorization=signed["Authorization"].replace(
        sig, "0" * 64))
    assert server._check_auth(make_mocked_request(
        "GET", "/", headers=tampered)).status == 403


# --- unit parity on the same inputs ---

def test_signing_key_equal_and_aws_vector():
    # docs.aws.amazon.com "Deriving the signing key" worked example
    k = pauth.signing_key(ref_v2.AWS_SECRET, "20150830", "us-east-1", "iam")
    assert k.hex() == ("c4afb1cc5771d871763a393e44b703571b55cc28424d1a5e"
                       "86da6ed3c154a4b9")
    rng = random.Random(7)
    for _ in range(20):
        secret = "".join(rng.choice("abcdefXYZ/+0123") for _ in range(40))
        date = f"2026{rng.randrange(1, 13):02d}{rng.randrange(1, 29):02d}"
        region = rng.choice(["us-east-1", "eu-west-1", "ap-south-2"])
        service = rng.choice(["s3", "iam"])
        assert pauth.signing_key(secret, date, region, service) == \
            rauth.signing_key(secret, date, region, service)


@pytest.mark.parametrize("pkg", PKGS)
def test_sigv4_aws_vectors(pkg):
    """The gateway's canonical form and signing key against AWS's
    published SigV4 vectors (get-vanilla, the IAM ListUsers example) and
    the tuple order of 'key' before 'key1' (tests/test_s3_sigv2.py's
    cases, on each package)."""
    server, auth = ((rserver, rauth) if pkg == "reference"
                    else (pserver, pauth))

    def signature(req, signed, amz_date, scope):
        sts = server.S3Server._sigv4_string_to_sign(
            req, signed, hashlib.sha256(b"").hexdigest(), amz_date, scope)
        date, region, service, _ = scope.split("/")
        key = auth.signing_key(ref_v2.AWS_SECRET, date, region, service)
        return hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()

    req = ref_v2._FakeRequest("GET", "/", {}, {
        "host": "example.amazonaws.com", "x-amz-date": "20150830T123600Z"})
    assert signature(req, ["host", "x-amz-date"], "20150830T123600Z",
                     "20150830/us-east-1/service/aws4_request") == (
        "5fa00fa31553b73ebf1942676e86291e8372ff2a2260956d9b8aae1d763fbf31")
    req = ref_v2._FakeRequest(
        "GET", "/", {"Action": "ListUsers", "Version": "2010-05-08"},
        {"content-type": "application/x-www-form-urlencoded; charset=utf-8",
         "host": "iam.amazonaws.com", "x-amz-date": "20150830T123600Z"})
    assert signature(req, ["content-type", "host", "x-amz-date"],
                     "20150830T123600Z",
                     "20150830/us-east-1/iam/aws4_request") == (
        "5d672d79c15b13162d9279b0855cfba6789a8edb4c82c400e06b5924a6f2b5d7")
    req = ref_v2._FakeRequest("GET", "/", {"key": "x", "key1": "y"},
                              {"host": "h"})
    sts = server.S3Server._sigv4_string_to_sign(
        req, ["host"], "UNSIGNED-PAYLOAD", "20250101T000000Z",
        "20250101/us-east-1/s3/aws4_request")
    assert sts.split("\n")[3] == hashlib.sha256("\n".join([
        "GET", "/", "key=x&key1=y", "host:h\n", "host",
        "UNSIGNED-PAYLOAD"]).encode()).hexdigest()


V4_REQUESTS = [
    ("GET", "/b/k.txt", {}, ""),
    ("PUT", "/b/dir/a b+c.txt", {"Content-Type": "text/plain"}, ""),
    ("GET", "/b?list-type=2&prefix=x/&key=1&key1=2&max-keys=7", {}, ""),
    ("DELETE", "/b/k?versionId=00ab&uploadId=", {"x-amz-meta-a": "  1  2"},
     ""),
]


@pytest.mark.parametrize("case", range(len(V4_REQUESTS)))
def test_v4_string_to_sign_equal(case):
    method, path, headers, _ = V4_REQUESTS[case]
    hdrs = {"host": "h:8333", "x-amz-date": "20260801T101010Z",
            "x-amz-content-sha256": "UNSIGNED-PAYLOAD", **headers}
    req = make_mocked_request(method, urllib.parse.quote(path, safe="/?&="),
                              headers=hdrs)
    signed = sorted(h.lower() for h in hdrs)
    for skip in ((), ("key1",)):
        args = (req, signed, "UNSIGNED-PAYLOAD", "20260801T101010Z",
                "20260801/us-east-1/s3/aws4_request", skip)
        assert pserver.S3Server._sigv4_string_to_sign(*args) == \
            rserver.S3Server._sigv4_string_to_sign(*args)


def _frame(payload: bytes, key: bytes, seed: str, amz_date: str,
           scope: str) -> bytes:
    return ref_comp._frame_chunks(payload, 1000, key, seed, amz_date, scope)


def _decode(mod, framed, *args):
    try:
        return asyncio.run(mod.read_chunked_sigv4(
            ref_comp._FakeStream(framed), *args))
    except mod.ChunkedSigV4Error as e:
        return ("refused", str(e))
    except (asyncio.IncompleteReadError, TypeError) as e:
        # a truncated body; a non-ASCII byte in a chunk's signature
        # (hmac.compare_digest refuses it, in both packages)
        return (type(e).__name__,)


def test_read_chunked_sigv4_equal():
    rng = random.Random(11)
    date, scope = "20260730T000000Z", "20260730/us-east-1/s3/aws4_request"
    key = pauth.signing_key("secret", "20260730", "us-east-1")
    payload = rng.randbytes(5321)
    framed = _frame(payload, key, "seedsig", date, scope)
    args = ("seedsig", key, date, scope)
    assert _decode(pauth, framed, *args) == _decode(rauth, framed, *args) \
        == payload
    # unverified: only de-framed
    assert _decode(pauth, framed) == _decode(rauth, framed) == payload
    cases = []
    for at in (len(framed) // 2, 10, len(framed) - 5):
        bad = bytearray(framed)
        bad[at] ^= 0xFF
        cases.append(bytes(bad))
    cases += [framed[:-7], b"zz;chunk-signature=x\r\n"]
    for bad in cases:
        got = _decode(pauth, bad, *args)
        assert got == _decode(rauth, bad, *args)
        assert got != payload
    # a tampered chunk is refused, never a partial object; so is a chain
    # seeded by another request's signature
    assert _decode(pauth, cases[0], *args)[0] == "refused"
    other = ("otherseed",) + args[1:]
    assert _decode(pauth, framed, *other) == _decode(rauth, framed, *other)
    assert _decode(pauth, framed, *other)[0] == "refused"


SIGV2_CASES = [
    ("GET", "/b/k.txt", {}, {"Date": "Tue, 27 Mar 2007 19:36:42 +0000"}),
    ("PUT", "/b/a%20b%2Bc.txt", {}, {"Content-Type": "text/plain",
                                     "Content-MD5": "abc==",
                                     "x-amz-meta-b": " 2  3 ",
                                     "X-Amz-Meta-A": "1"}),
    ("GET", "/b", {"acl": "", "versionId": "7", "tagging": "",
                   "prefix": "p"}, {"x-amz-date": "now", "Date": "then"}),
    ("DELETE", "/b/k", {"uploadId": "u1", "partNumber": "2"}, {}),
]


@pytest.mark.parametrize("case", range(len(SIGV2_CASES)))
def test_sigv2_equal(case):
    method, path, query, headers = SIGV2_CASES[case]
    for mod_a, mod_b in ((psigv2, rsigv2),):
        a = mod_a.string_to_sign(method, path, query, headers)
        assert a == mod_b.string_to_sign(method, path, query, headers)
        assert mod_a.signature("s3cr3t", a) == mod_b.signature("s3cr3t", a)
        assert mod_a.presigned_string_to_sign(
            method, path, query, headers, "1800000000") == \
            mod_b.presigned_string_to_sign(method, path, query, headers,
                                           "1800000000")
    url = f"http://h:8333{path}?" + urllib.parse.urlencode(query)
    assert psigv2.sign_header(method, url, headers, "AK", "SK",
                              now=1_800_000_000.0) == \
        rsigv2.sign_header(method, url, headers, "AK", "SK",
                           now=1_800_000_000.0)
    assert psigv2.presign(method, url, "AK", "SK", 300,
                          now=1_800_000_000.0) == \
        rsigv2.presign(method, url, "AK", "SK", 300, now=1_800_000_000.0)
    assert psigv2.RESOURCE_LIST == rsigv2.RESOURCE_LIST


def test_iam_from_file_equal(tmp_path):
    path = tmp_path / "s3.json"
    path.write_text(json.dumps({"identities": IDENTITIES + [
        {"name": "multi",
         "credentials": [{"accessKey": "M1", "secretKey": "m1"},
                         {"accessKey": "M2", "secretKey": "m2"}],
         "actions": ["Read:b1", "Tagging", "Admin:b2"]}]}))
    p, r = pauth.Iam.from_file(str(path)), rauth.Iam.from_file(str(path))
    assert p.enabled and r.enabled
    assert not pauth.Iam([]).enabled and not rauth.Iam([]).enabled
    keys = [c["accessKey"] for d in json.loads(path.read_text())[
        "identities"] for c in d["credentials"]] + ["NOPE", ""]
    for key in keys:
        a, b = p.lookup(key), r.lookup(key)
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert (a[0].name, a[1]) == (b[0].name, b[1])
        for action in (pauth.ACTION_READ, pauth.ACTION_WRITE,
                       pauth.ACTION_LIST, pauth.ACTION_TAGGING,
                       pauth.ACTION_ADMIN):
            for bucket in ("", "b1", "b2", "onlythis", "other"):
                assert a[0].allows(action, bucket) == \
                    b[0].allows(action, bucket), (key, action, bucket)
    assert (pauth.ACTION_READ, pauth.ACTION_WRITE, pauth.ACTION_LIST,
            pauth.ACTION_TAGGING, pauth.ACTION_ADMIN) == (
        rauth.ACTION_READ, rauth.ACTION_WRITE, rauth.ACTION_LIST,
        rauth.ACTION_TAGGING, rauth.ACTION_ADMIN)


def _post_fields(policy: dict, secret: str, v2: bool = False) -> dict:
    doc = base64.b64encode(json.dumps(policy).encode()).decode()
    if v2:
        sig = base64.b64encode(hmac.new(secret.encode(), doc.encode(),
                                        hashlib.sha1).digest()).decode()
        return {"policy": doc, "awsaccesskeyid": "V2ADMIN",
                "signature": sig}
    date = time.strftime("%Y%m%d", time.gmtime())
    key = pauth.signing_key(secret, date, "us-east-1")
    return {"policy": doc, "x-amz-credential":
            f"ADMINKEY/{date}/us-east-1/s3/aws4_request",
            "x-amz-signature": hmac.new(key, doc.encode(),
                                        hashlib.sha256).hexdigest()}


def test_verify_post_policy_equal():
    exp = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(time.time() + 600))
    good = {"expiration": exp, "conditions": [
        {"bucket": "pb"}, ["starts-with", "$key", "up/"],
        ["content-length-range", 1, 10]]}
    cases = [
        (_post_fields(good, "adminsecret"), {"bucket": "pb",
                                             "key": "up/x"}),
        (_post_fields(good, "adminsecret"), {"bucket": "pb",
                                             "key": "no/x"}),
        (_post_fields(good, "adminsecret"), {"bucket": "qb",
                                             "key": "up/x"}),
        (_post_fields(good, "WRONG"), {"bucket": "pb", "key": "up/x"}),
        (_post_fields(good, "v2adminsecret", v2=True), {"bucket": "pb",
                                                        "key": "up/y"}),
        (_post_fields({"expiration": "2001-01-01T00:00:00Z",
                       "conditions": []}, "adminsecret"), {}),
        (_post_fields({"expiration": exp, "conditions": [
            ["content-length-range", "a", 3]]}, "adminsecret"), {}),
        ({"policy": "!!"}, {}),
        ({}, {}),
    ]
    piam, riam = pauth.Iam(IDENTITIES), rauth.Iam(IDENTITIES)
    for fields, extra in cases:
        f = {**fields, **extra}
        assert pauth.verify_post_policy(dict(f), piam) == \
            rauth.verify_post_policy(dict(f), riam)
    assert pauth.ERR_BAD_LENGTH_RANGE == rauth.ERR_BAD_LENGTH_RANGE


REPLICATION_XML = [
    (b"<ReplicationConfiguration><Role>arn:r</Role><Rule><ID>r1</ID>"
     b"<Status>Enabled</Status><Prefix>logs/</Prefix><Destination>"
     b"<Bucket>arn:aws:s3:::dst</Bucket><Endpoint>h:8888</Endpoint>"
     b"</Destination></Rule></ReplicationConfiguration>"),
    (b'<ReplicationConfiguration xmlns="http://s3.amazonaws.com/doc/'
     b'2006-03-01/"><Rule><Status>Disabled</Status><Priority>1</Priority>'
     b"<Filter><Prefix>a/</Prefix></Filter><Destination><Bucket>plain"
     b"</Bucket></Destination></Rule><Rule><Status>Enabled</Status>"
     b"<Filter/><Destination><Bucket>arn:aws:s3:::b2</Bucket>"
     b"</Destination></Rule></ReplicationConfiguration>"),
    # refused: each outside the supported subset
    b"<ReplicationConfiguration></ReplicationConfiguration>",
    b"<Other/>",
    b"<ReplicationConfiguration><Rule>",
    (b"<ReplicationConfiguration><Rule><Status>Maybe</Status>"
     b"<Destination><Bucket>d</Bucket></Destination></Rule>"
     b"</ReplicationConfiguration>"),
    (b"<ReplicationConfiguration><Rule><Status>Enabled</Status></Rule>"
     b"</ReplicationConfiguration>"),
    (b"<ReplicationConfiguration><Rule><Destination><Bucket/>"
     b"</Destination></Rule></ReplicationConfiguration>"),
    (b"<ReplicationConfiguration><Rule><Status>Enabled</Status>"
     b"<DeleteMarkerReplication/><Destination><Bucket>d</Bucket>"
     b"</Destination></Rule></ReplicationConfiguration>"),
    b"<ReplicationConfiguration><Bogus/></ReplicationConfiguration>",
    (b"<ReplicationConfiguration>" + b"<Rule><Destination><Bucket>d"
     b"</Bucket></Destination></Rule>" * 17
     + b"</ReplicationConfiguration>"),
]


def _parse_replication(mod, body):
    try:
        rules = mod.parse_replication_xml(body)
    except mod.ReplicationXmlError as e:
        return ("refused", str(e))
    return ("ok", rules, mod.rules_to_xml(rules), mod.rules_to_json(rules),
            mod.rules_from_json(mod.rules_to_json(rules)),
            mod.active_rule(rules))


@pytest.mark.parametrize("case", range(len(REPLICATION_XML)))
def test_geo_rules_equal(case):
    body = REPLICATION_XML[case]
    got = _parse_replication(prules, body)
    assert got == _parse_replication(rrules, body)
    if got[0] == "ok":
        # a serialised configuration parses back to the same rules
        assert prules.parse_replication_xml(got[2]) == got[1]
    for raw in ("not json", "{}", "[1]", None):
        assert prules.rules_from_json(raw) == rrules.rules_from_json(raw)
    assert (prules.BUCKET_ATTR, prules.MAX_RULES) == (rrules.BUCKET_ATTR,
                                                      rrules.MAX_RULES)


def test_version_ids_and_layout_equal():
    ids = [pver.new_version_id() for _ in range(200)]
    for vid in ids + [rver.new_version_id()]:
        assert re.fullmatch(r"[0-9a-f]{20}", vid)
    # fixed width and time-ordered: name order is creation order
    assert ids == sorted(ids) and len(set(ids)) == len(ids)
    assert pver.NULL_VERSION == rver.NULL_VERSION == "null"
    for name in ("VERSIONING_ATTR", "VERSION_ID_ATTR", "DELETE_MARKER_ATTR",
                 "VERSIONS_SUFFIX"):
        assert getattr(pver, name) == getattr(rver, name)
    for entry in ({}, {"extended": None}, {"extended": {
            "x-amz-version-id": "00ff"}}, {"extended": {
            "x-amz-delete-marker": "true"}}, {"extended": {
            "x-amz-delete-marker": "false"}}):
        assert pver.entry_version_id(entry) == rver.entry_version_id(entry)
        assert pver.is_delete_marker(entry) == rver.is_delete_marker(entry)
    assert pver.versions_dir("/buckets/b/k") == \
        rver.versions_dir("/buckets/b/k") == "/buckets/b/k.versions"


def test_gateway_helpers_equal():
    rng = random.Random(3)
    for _ in range(30):
        chunks = [{"offset": o, "size": rng.randrange(1, 100),
                   "etag": rng.choice(["", "abc", f"{rng.random()}"])}
                  for o in sorted(rng.sample(range(1000), rng.randrange(4)))]
        entry = {"chunks": chunks}
        assert pserver._entry_size(entry) == rserver._entry_size(entry)
        assert pserver._entry_etag(entry) == rserver._entry_etag(entry)
        ts = rng.uniform(0, 2e9)
        assert pserver._iso(ts) == rserver._iso(ts)


@pytest.mark.parametrize("pkg", PKGS)
def test_tenant_validator_meters_only_known_keys(pkg):
    """Admission runs before SigV4, so a tenant key is unverified: the
    gateway meters per tenant only the keys its identities know."""
    server_cls = (rserver if pkg == "reference" else pserver).S3Server
    gw = server_cls("127.0.0.1:1", iam=iam_of(pkg)(IDENTITIES))
    assert gw.admission.tenant_validator("ADMINKEY")
    assert not gw.admission.tenant_validator("VICTIMKEY")
    anon = server_cls("127.0.0.1:1")
    assert not anon.admission.tenant_validator("ADMINKEY")
    assert gw.admission.system_paths == rserver.overload.OPS_PATHS


def _raw(gw, method, path, data=None, headers=None):
    r = urllib.request.Request(f"http://{gw.url}{path}", data=data,
                               method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_ops_routes_are_reserved(stack):
    """PUT /healthz or /metrics never reaches the {bucket} catch-all
    (S3's XML 405); /metrics needs an Admin signature; the port's
    unported debug routes answer 405 to every method."""
    gw = stack.s3_iam
    for path in ("/healthz", "/metrics"):
        status, body = _raw(gw, "PUT", path)
        assert status == 405 and b"MethodNotAllowed" in body
    status, body = _raw(gw, "GET", "/healthz")
    assert status == 200 and json.loads(body)["admission"]["shedding"] \
        is False
    assert _raw(gw, "GET", "/metrics")[0] == 403
    url = f"http://{gw.url}/metrics"
    with urllib.request.urlopen(urllib.request.Request(
            url, headers=sign_request("GET", url, {}, b"", "ADMINKEY",
                                      "adminsecret")), timeout=60) as r:
        assert r.status == 200 and b"seaweedfs_tpu_s3_" in r.read()
    if stack.pkg == "port":
        for method in ("GET", "PUT", "POST"):
            assert _raw(gw, method, "/debug/trace")[0] == 405
    # no bucket was minted by any of them
    listed = _raw(stack.s3, "GET", "/")[1]
    for name in (b"healthz", b"metrics", b"debug"):
        assert b"<Name>" + name not in listed


# --- D11: a key whose URL path is already percent-escaped ---

def test_d11_escaped_key_same_answer_from_both_gateways():
    """The SigV4 signer quotes an already escaped path again while the
    gateways verify the decoded one, so both gateways refuse such a
    request alike (ROADMAP Queue 3, D11); a V2 signature covers the
    escaped path as sent and both accept it. The signer-level twin is
    tests/test_torch_tier.py::
    test_escaped_key_is_refused_by_both_signers_alike."""
    answers = {}
    for pkg in PKGS:
        s = Stack.__new__(Stack)
        s.pkg = pkg
        s.cluster = (Cluster(n_volume_servers=1, pulse=0.15)
                     if pkg == "reference" else
                     LocalCluster(1, coder_name="torch", device="cpu",
                                  pulse=0.15))
        try:
            gw = s.gateway(iam_of(pkg)(IDENTITIES))
            out = []
            for method, path, data in (
                    ("PUT", "/d11", b""),
                    ("PUT", "/d11/a%20b.txt", b"escaped"),
                    ("GET", "/d11/a%20b.txt", b""),
                    ("PUT", "/d11/plain.txt", b"plain")):
                url = f"http://{gw.url}{path}"
                hdrs = sign_request(method, url, {}, data, "ADMINKEY",
                                    "adminsecret")
                status, body = _raw(gw, method, path, data or None, hdrs)
                out.append((status, re.sub(rb"<Message>.*</Message>", b"",
                                           body)))
            url = f"http://{gw.url}/d11/a%20b.txt"
            hdrs = rsigv2.sign_header("PUT", url, {
                "Content-Type": "application/octet-stream"}, "V2ADMIN",
                "v2adminsecret")
            out.append(_raw(gw, "PUT", "/d11/a%20b.txt", b"v2", hdrs))
            hdrs = rsigv2.sign_header("GET", url, {}, "V2READ",
                                      "v2readsecret")
            out.append(_raw(gw, "GET", "/d11/a%20b.txt", None, hdrs))
            answers[pkg] = out
        finally:
            s.cluster.shutdown()
    assert answers["port"] == answers["reference"]
    got = answers["port"]
    assert [a[0] for a in got] == [200, 403, 403, 200, 200, 200]
    assert b"SignatureDoesNotMatch" in got[1][1]
    assert got[-1] == (200, b"v2")


# --- the end-to-end parity script ---

ADMIN = ("ADMINKEY", "adminsecret")
READER = ("READKEY", "readsecret")
RULES_XML = (b"<LifecycleConfiguration><Rule><ID>old</ID><Filter><Prefix>"
             b"old/</Prefix></Filter><Status>Enabled</Status><Expiration>"
             b"<Days>30</Days></Expiration></Rule></LifecycleConfiguration>")


def _script(seed: int) -> list:
    """(who, method, path, body, headers, capture) steps; a path may be a
    function of the values captured so far."""
    rng = random.Random(seed)
    keys = ["a.txt", "b.bin", "dir/x1", "dir/x2", "dir/sub/y", "dir/sub/z",
            "e/f/g", "zz"]
    bodies = {k: rng.randbytes(rng.choice([1, 700, 16 * 1024, 40_000]))
              for k in keys}
    s = []

    def step(method, path, body=b"", headers=None, who=ADMIN,
             capture=None):
        s.append((who, method, path, body, headers or {}, capture))

    step("PUT", "/pb")
    step("PUT", "/pb")                       # BucketAlreadyExists
    step("GET", "/")
    step("HEAD", "/pb")
    step("HEAD", "/nob")
    for k in keys:
        step("PUT", f"/pb/{k}", bodies[k],
             {"Content-Type": "application/octet-stream"})
    for k in keys:
        step("GET", f"/pb/{k}")
    step("HEAD", "/pb/b.bin")
    step("GET", "/pb/dir/x2", headers={"Range": "bytes=16000-16999"})
    step("GET", "/pb/nokey")
    step("GET", "/pb/dir")                   # a directory is no key
    step("PUT", "/pb/copy.bin", headers={"x-amz-copy-source": "/pb/dir/x1"})
    step("GET", "/pb/copy.bin")
    step("GET", "/pb")
    step("GET", "/pb?prefix=dir/")
    step("GET", "/pb?delimiter=/")
    step("GET", "/pb?prefix=dir/&delimiter=/")
    step("GET", "/pb?max-keys=3", capture="m1")
    step("GET", lambda c: f"/pb?max-keys=3&marker={c['m1']}", capture="m2")
    step("GET", lambda c: f"/pb?max-keys=3&marker={c['m2']}")
    step("GET", "/pb?list-type=2&max-keys=3", capture="t1")
    step("GET", lambda c: "/pb?list-type=2&max-keys=3&continuation-token="
         + c["t1"])
    step("GET", "/pb?list-type=2&delimiter=/&prefix=dir/&max-keys=1",
         capture="t2")
    step("GET", lambda c: "/pb?list-type=2&delimiter=/&prefix=dir/"
         "&max-keys=1&continuation-token=" + c["t2"])
    step("GET", "/pb?list-type=2&start-after=dir/x2")
    step("POST", "/pb?delete", b"<Delete><Object><Key>zz</Key></Object>"
         b"<Object><Key>e/f/g</Key></Object><Object><Key>none</Key>"
         b"</Object></Delete>")
    step("GET", "/pb?list-type=2")
    # multipart: parts checked with ListParts before Complete
    step("POST", "/pb/mp.bin?uploads", capture="up")
    parts = [rng.randbytes(20_000), rng.randbytes(33_000), rng.randbytes(5)]
    for i, part in enumerate(parts, 1):
        step("PUT", lambda c, i=i: f"/pb/mp.bin?partNumber={i}"
             f"&uploadId={c['up']}", part)
    step("GET", lambda c: f"/pb/mp.bin?uploadId={c['up']}")
    step("POST", lambda c: f"/pb/mp.bin?uploadId={c['up']}",
         b"<CompleteMultipartUpload/>")
    step("GET", "/pb/mp.bin")
    step("POST", "/pb/ab.bin?uploads", capture="up2")
    step("DELETE", lambda c: f"/pb/ab.bin?uploadId={c['up2']}")
    step("PUT", "/pb/ab.bin?partNumber=1&uploadId=deadbeef", b"x")
    # tagging
    step("PUT", "/pb/a.txt?tagging", b"<Tagging><TagSet><Tag><Key>env</Key>"
         b"<Value>prod</Value></Tag><Tag><Key>t</Key><Value>2</Value></Tag>"
         b"</TagSet></Tagging>")
    step("GET", "/pb/a.txt?tagging")
    step("PUT", "/pb/t.bin", b"tagged", {"x-amz-tagging": "k=v&w=x y"})
    step("GET", "/pb/t.bin?tagging")
    step("DELETE", "/pb/a.txt?tagging")
    step("GET", "/pb/a.txt?tagging")
    # a POST policy upload
    step("POST", "/pb", "POLICY", who=None)
    step("GET", "/pb/up/f.bin")
    # the reader: reads and lists, never writes
    step("GET", "/pb/b.bin", who=READER)
    step("GET", "/pb?prefix=dir/sub/", who=READER)
    step("PUT", "/pb/r.txt", b"no", who=READER)
    step("PUT", "/readerb", who=READER)
    step("DELETE", "/pb/b.bin", who=READER)
    step("GET", "/pb/b.bin", who=None)       # anonymous: refused
    # versioning: overwrites, delete markers, ?versionId
    step("PUT", "/vb")
    step("GET", "/vb?versioning")
    step("PUT", "/vb/k0", b"before versioning")
    step("PUT", "/vb?versioning", b"<VersioningConfiguration><Status>"
         b"Enabled</Status></VersioningConfiguration>")
    step("PUT", "/vb?versioning", b"<VersioningConfiguration><Status>"
         b"Maybe</Status></VersioningConfiguration>")
    step("GET", "/vb?versioning")
    for n, name in enumerate(("v1", "v2", "v3")):
        step("PUT", "/vb/k1", rng.randbytes(1000 + n), capture=name)
    step("PUT", "/vb/k0", b"after", capture="k0v")
    step("PUT", "/vb/k2", b"two", capture="k2v")
    step("GET", "/vb/k1")
    step("GET", lambda c: f"/vb/k1?versionId={c['v1']}")
    step("GET", lambda c: f"/vb/k1?versionId={c['v2']}")
    step("GET", "/vb/k0?versionId=null")
    step("DELETE", "/vb/k1", capture="dm")
    step("GET", "/vb/k1")
    step("GET", lambda c: f"/vb/k1?versionId={c['dm']}")
    step("GET", "/vb?versions")
    step("GET", "/vb?versions&prefix=k1&max-keys=3")
    step("GET", "/vb?list-type=2")
    step("DELETE", lambda c: f"/vb/k1?versionId={c['dm']}")
    step("GET", "/vb/k1")
    step("DELETE", lambda c: f"/vb/k1?versionId={c['v3']}")
    step("GET", "/vb/k1")
    step("DELETE", lambda c: f"/vb/k2?versionId={c['k2v']}")
    step("GET", "/vb/k2")
    step("PUT", "/vb/k0", headers={"x-amz-copy-source": "/pb/a.txt"})
    step("POST", "/vb?delete", b"<Delete><Object><Key>k0</Key></Object>"
         b"</Delete>")
    step("GET", "/vb?versions")
    # the replication and lifecycle configurations
    step("GET", "/pb?replication")
    step("PUT", "/pb?replication", REPLICATION_XML[0])
    step("GET", "/pb?replication")
    step("PUT", "/pb?replication", REPLICATION_XML[2])
    step("DELETE", "/pb?replication")
    step("GET", "/pb?replication")
    step("PUT", "/nob?replication", REPLICATION_XML[0])
    step("GET", "/pb?lifecycle")
    step("PUT", "/pb?lifecycle", RULES_XML)
    step("GET", "/pb?lifecycle")
    step("DELETE", "/pb?lifecycle")
    step("GET", "/pb?lifecycle")
    # the bucket's delete: not while it holds objects
    step("DELETE", "/pb")
    step("POST", "/pb?delete", b"<Delete>" + b"".join(
        b"<Object><Key>%s</Key></Object>" % k.encode() for k in
        keys + ["copy.bin", "mp.bin", "t.bin", "up/f.bin"]) + b"</Delete>")
    step("GET", "/pb")
    step("DELETE", "/pb")
    step("HEAD", "/pb")
    step("GET", "/")
    return s


def _policy_body(gw_url: str) -> tuple:
    exp = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(time.time() + 600))
    fields = {"key": "up/${filename}", **_post_fields(
        {"expiration": exp, "conditions": [
            {"bucket": "pb"}, ["starts-with", "$key", "up/"]]},
        "adminsecret")}
    return (ref_comp._post_policy_body(fields, b"posted bytes", "bnd9"),
            {"Content-Type": "multipart/form-data; boundary=bnd9"})


HEADERS = ("ETag", "x-amz-version-id", "x-amz-delete-marker",
           "Content-Range", "Content-Length")


def _run_script(gw, seed: int) -> list:
    captured: dict = {}
    ids: dict = {}
    out = []

    def token(kind: str, raw: str) -> str:
        return ids.setdefault(raw, f"<{kind}-{len(ids)}>")

    def norm(text: str) -> str:
        for raw, tok in sorted(ids.items(), key=lambda kv: -len(kv[0])):
            text = text.replace(raw, tok)
        text = re.sub(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d\.\d{3}Z", "<date>",
                      text)
        return text

    for who, method, path, body, headers, capture in _script(seed):
        if callable(path):
            path = path(captured)
        headers = dict(headers)
        if body == "POLICY":
            body, headers = _policy_body(gw.url)
        url = f"http://{gw.url}{path}"
        if who is not None:
            headers = sign_request(method, url, headers, body, *who)
        status, hdrs, data = _http(method, url, body, headers)
        text = data.decode("latin-1")
        vid = hdrs.get("x-amz-version-id", "")
        if vid and vid != "null":
            token("version", vid)
        for m in re.findall(r"<(?:VersionId|DeleteMarkerVersionId)>"
                            r"([0-9a-f]{20})<", text):
            token("version", m)
        m = re.search(r"<UploadId>([0-9a-f]{32})</UploadId>", text)
        if m:
            tok = token("upload", m.group(1))
            # the multipart ETag is md5(upload id)-N
            ids.setdefault(hashlib.md5(m.group(1).encode()).hexdigest(),
                           tok + "-md5")
        if capture:
            if capture in ("up", "up2"):
                captured[capture] = m.group(1)
            elif capture.startswith(("m", "t")) and len(capture) == 2:
                tag = ("NextMarker" if capture[0] == "m"
                       else "NextContinuationToken")
                captured[capture] = urllib.parse.quote(re.search(
                    f"<{tag}>(.*?)</{tag}>", text).group(1))
            else:
                captured[capture] = vid
        out.append((method, norm(path), status,
                    {h: norm(hdrs[h]) for h in HEADERS if h in hdrs},
                    hashlib.sha256(data).hexdigest()
                    if not text.startswith("<?xml") else norm(text)))
    return out


def _http(method, url, body, headers):
    r = urllib.request.Request(url, data=body or None, method=method,
                               headers=headers)
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def test_s3_script_parity():
    got = {}
    for pkg in PKGS:
        s = Stack.__new__(Stack)
        s.pkg = pkg
        s.cluster = (Cluster(n_volume_servers=1, pulse=0.15)
                     if pkg == "reference" else
                     LocalCluster(1, coder_name="torch", device="cpu",
                                  pulse=0.15))
        try:
            got[pkg] = _run_script(s.gateway(iam_of(pkg)(IDENTITIES)), 18)
        finally:
            s.cluster.shutdown()
    for i, (p, r) in enumerate(zip(got["port"], got["reference"])):
        assert p == r, f"step {i}"
    assert len(got["port"]) == len(got["reference"]) == len(_script(18))
    statuses = {step[2] for step in got["port"]}
    assert {200, 204, 206, 403, 404, 405, 409} <= statuses


# --- CLI s3 and the shell's bucket.* commands ---

def _cli(*argv, **kw):
    return subprocess.Popen(
        [sys.executable, "-I", "-c", "import sys; sys.path.insert(0, %r); "
         "from seaweedfs_torch.cli import main; main()" % str(REPO), *argv],
        cwd=str(REPO), **kw)


def test_cli_s3_and_bucket_commands(tmp_path):
    """`cli s3 -config s3.json` in front of a port filer: an admin's
    signed PUT lands, the reader is refused a PUT with 403; a lone
    -access_key is refused before the gateway starts; the shell's
    bucket.* and collection.* commands see and change the buckets."""
    lone = _cli("s3", "-access_key", "K", stdout=subprocess.PIPE,
                stderr=subprocess.PIPE)
    _, err = lone.communicate(timeout=120)
    assert lone.returncode != 0 and b"provided together" in err
    cl = LocalCluster(1, coder_name="torch", device="cpu", pulse=0.15)
    proc = None
    try:
        fs = cl.add_filer("memory", 16 * 1024)
        cfg = tmp_path / "s3.json"
        cfg.write_text(json.dumps({"identities": IDENTITIES}))
        port = free_port()
        proc = _cli("s3", "-port", str(port), "-filer", fs.url, "-config",
                    str(cfg), stdout=subprocess.DEVNULL,
                    stderr=subprocess.PIPE)
        base = f"http://127.0.0.1:{port}"
        deadline = time.time() + 120
        while True:
            try:
                with urllib.request.urlopen(f"{base}/healthz", timeout=5):
                    break
            except OSError:
                assert proc.poll() is None, proc.stderr.read()
                assert time.time() < deadline
                time.sleep(0.2)

        def signed(method, path, body, who):
            return _http(method, base + path, body, sign_request(
                method, base + path, {}, body, *who))

        assert signed("PUT", "/clib", b"", ADMIN)[0] == 200
        assert signed("PUT", "/clib/o.bin", b"cli bytes", ADMIN)[0] == 200
        assert signed("PUT", "/clib/r.bin", b"no", READER)[0] == 403
        assert signed("GET", "/clib/o.bin", b"", READER)[2] == b"cli bytes"

        out = subprocess.run(
            [sys.executable, "-m", "seaweedfs_torch.cli", "shell",
             "-master", cl.master_url, "-filer", fs.url, "bucket.list"],
            cwd=str(REPO), capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr[-500:]
        assert json.loads(out.stdout.strip().splitlines()[-1]) == {
            "buckets": ["clib"]}
        shell_commands._register_all()
        env = shell_commands.CommandEnv(Client(cl.master_url), filer=fs.url)

        def shell(*argv):
            return shell_commands.run_command(env, list(argv))

        assert shell("bucket.create", "-name", "made")["ok"]
        assert signed("HEAD", "/made", b"", ADMIN)[0] == 200
        assert shell("bucket.list") == {"buckets": ["clib", "made"]}
        assert shell("bucket.delete", "-name", "clib")["deleted"] == "clib"
        assert signed("GET", "/clib/o.bin", b"", ADMIN)[0] == 404
        assert shell("bucket.list") == {"buckets": ["made"]}
        cols = shell("collection.list")["collections"]
        assert {c["name"] for c in cols} <= {"(default)", "clib"}
        plan = shell("collection.delete", "-collection", "nonesuch")
        assert plan == {"plan": [], "applied": False}
    finally:
        if proc is not None:
            proc.terminate()
            proc.wait(timeout=30)
        cl.shutdown()
