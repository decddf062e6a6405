"""The lifecycle daemon's S3 pass in the port against the reference's.

``s3_rules`` parses and serialises the reference's XML cases equally
(and refuses the same ones with the same message). Then the end-to-end
flow of tests/test_lifecycle.py's S3 case in both packages, twice: with
the rules put on the bucket's entry through the filer's
``/__meta__/update_entry``, and with the same rules put through each
package's S3 gateway (PutBucketLifecycleConfiguration, objects PUT and
read through the gateway): a master whose lifecycle daemon scans the
filer (a "day" of 1 s), four volume servers, a filer. An ``old/`` object expires and
its chunks are freed, an ``arc/`` object is listed ``WARM``, its
volume's warm transition is ``ok``, and the object reads back equal
through the filer, also with shards {0, 3, 7, 12} dropped from their
holders; ``keep.bin`` stays. The port's volume servers run the kernel's
plain version (``coder_name="torch", device="cpu"``).
"""

import json
import random
import re
import time

import pytest

from cluster_util import Cluster, free_port
from seaweedfs_torch.ec.geometry import Geometry
from seaweedfs_torch.lifecycle import LifecycleConfig as PConfig
from seaweedfs_torch.lifecycle import s3_rules as prules
from seaweedfs_torch.server import http as phttp
from seaweedfs_torch.server.local_cluster import LocalCluster
from seaweedfs_tpu.lifecycle import LifecycleConfig as RConfig
from seaweedfs_tpu.lifecycle import s3_rules as rrules
from seaweedfs_tpu.s3.s3_server import S3Server as RS3Server

RULES = (b"<LifecycleConfiguration>"
         b"<Rule><ID>old</ID><Filter><Prefix>old/</Prefix></Filter>"
         b"<Status>Enabled</Status>"
         b"<Expiration><Days>1</Days></Expiration></Rule>"
         b"<Rule><ID>arc</ID><Filter><Prefix>arc/</Prefix></Filter>"
         b"<Status>Enabled</Status>"
         b"<Transition><Days>0</Days><StorageClass>WARM"
         b"</StorageClass></Transition></Rule>"
         b"</LifecycleConfiguration>")

XML_CASES = [
    RULES,
    (b'<LifecycleConfiguration xmlns="http://s3.amazonaws.com/doc/'
     b'2006-03-01/"><Rule><Prefix>logs/</Prefix><Status>Disabled</Status>'
     b"<Expiration><Days>2.5</Days></Expiration>"
     b"<Transition><Days>0.5</Days><StorageClass>warm</StorageClass>"
     b"</Transition></Rule></LifecycleConfiguration>"),
    (b"<LifecycleConfiguration><Rule><Filter/><Status>Enabled</Status>"
     b"<Expiration><Days>0</Days></Expiration></Rule>"
     b"</LifecycleConfiguration>"),
    # refused: each outside the supported subset
    (b"<LifecycleConfiguration><Rule><Status>Enabled</Status>"
     b"<Transition><Days>1</Days><StorageClass>GLACIER</StorageClass>"
     b"</Transition></Rule></LifecycleConfiguration>"),
    b"<LifecycleConfiguration></LifecycleConfiguration>",
    (b"<LifecycleConfiguration><Rule><Status>Enabled</Status>"
     b"<Expiration><Date>2030-01-01</Date></Expiration></Rule>"
     b"</LifecycleConfiguration>"),
    (b"<LifecycleConfiguration><Rule><Status>Enabled</Status>"
     b"<Expiration><Days>-1</Days></Expiration></Rule>"
     b"</LifecycleConfiguration>"),
    (b"<LifecycleConfiguration><Rule><Status>Maybe</Status>"
     b"<Expiration><Days>1</Days></Expiration></Rule>"
     b"</LifecycleConfiguration>"),
    (b"<LifecycleConfiguration><Rule><Status>Enabled</Status>"
     b"<NoncurrentVersionExpiration/></Rule></LifecycleConfiguration>"),
    (b"<LifecycleConfiguration><Rule><Status>Enabled</Status></Rule>"
     b"</LifecycleConfiguration>"),
    b"<Other/>",
    b"<LifecycleConfiguration><Rule>",
    (b"<LifecycleConfiguration>" + b"<Rule><Status>Enabled</Status>"
     b"<Expiration><Days>1</Days></Expiration></Rule>" * 101
     + b"</LifecycleConfiguration>"),
]


def _parse(mod, body):
    try:
        rules = mod.parse_lifecycle_xml(body)
    except mod.LifecycleXmlError as e:
        return ("refused", str(e))
    return ("ok", rules, mod.rules_to_xml(rules), mod.rules_to_json(rules),
            mod.rules_from_json(mod.rules_to_json(rules)))


@pytest.mark.parametrize("case", range(len(XML_CASES)))
def test_s3_rules_parse_and_serialise_equal(case):
    body = XML_CASES[case]
    got = _parse(prules, body)
    assert got == _parse(rrules, body)
    if got[0] == "ok":
        # a serialised configuration parses back to the same rules
        assert prules.parse_lifecycle_xml(got[2]) == got[1]
    assert prules.rules_from_json("not json") == \
        rrules.rules_from_json("not json") == []
    assert (prules.BUCKET_ATTR, prules.STORAGE_CLASS_ATTR,
            prules.WARM_CLASS) == (rrules.BUCKET_ATTR,
                                   rrules.STORAGE_CLASS_ATTR,
                                   rrules.WARM_CLASS)


def _wait(predicate, what, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return
        time.sleep(0.1)
    raise AssertionError(f"timeout waiting for {what}")


def _cluster(pkg):
    geometry = Geometry(10, 4, large_block_size=64 * 1024,
                        small_block_size=4 * 1024)
    if pkg == "reference":
        cfg = RConfig(interval=0.3, day_seconds=1.0, force_enabled=True)
        c = Cluster(n_volume_servers=4,
                    master_kwargs={"lifecycle_config": cfg})
        return c, c.masters[0], c.add_filer()
    cfg = PConfig(interval=0.3, day_seconds=1.0, force_enabled=True)
    c = LocalCluster(4, coder_name="torch", device="cpu",
                     geometry=geometry, volume_size_limit_mb=1, pulse=0.15,
                     master_kwargs={"lifecycle_config": cfg})
    return c, c.master, c.add_filer()


def _flow(pkg, payload):
    c, master, fs = _cluster(pkg)
    base = f"http://{fs.url}"
    mu = c.master_url
    try:
        # the daemon learns the filer after boot, as the reference's
        # test wires it
        master.lifecycle.cfg.filer = fs.url
        for path, col in (("old/a.bin", "oldc"), ("arc/b.bin", "b1"),
                          ("keep.bin", "b1")):
            r = phttp.request("PUT", f"{base}/buckets/b1/{path}"
                              f"?collection={col}", payload)
            assert r.status == 201, r.data
        _, old = phttp.get_json(
            f"{base}/__meta__/lookup?path=/buckets/b1/old/a.bin")
        _, bucket = phttp.get_json(
            f"{base}/__meta__/lookup?path=/buckets/b1")
        bucket["extended"] = {prules.BUCKET_ATTR: prules.rules_to_json(
            prules.parse_lifecycle_xml(RULES))}
        assert phttp.post_json(f"{base}/__meta__/update_entry",
                               {"entry": bucket})[0] == 200

        def get(path):
            return phttp.request("GET", f"{base}/buckets/b1/{path}")

        _wait(lambda: get("old/a.bin").status == 404, "old/ expired")

        def fid_status(fid):
            _, loc = phttp.get_json(f"http://{mu}/dir/lookup?fileId={fid}")
            return phttp.request(
                "GET", f"http://{loc['locations'][0]['url']}/{fid}").status

        _wait(lambda: all(fid_status(ch["fid"]) == 404
                          for ch in old["chunks"]), "old/ chunks freed")
        assert get("keep.bin").data == payload

        def arc_entry():
            return phttp.get_json(
                f"{base}/__meta__/lookup?path=/buckets/b1/arc/b.bin")[1]

        _wait(lambda: arc_entry().get("extended", {}).get(
            prules.STORAGE_CLASS_ATTR) == "WARM", "arc/ listed WARM")

        def status():
            return phttp.get_json(f"http://{mu}/lifecycle/status")[1]

        _wait(lambda: any(e["kind"] == "warm" and e["outcome"] == "ok"
                          for e in status()["recent"]),
              "the chunk volume's warm transition")
        master.repair_enabled = False
        healthy = get("arc/b.bin").data
        vid = int(arc_entry()["chunks"][0]["fid"].split(",")[0])
        _, ec = phttp.get_json(f"http://{mu}/col/lookup/ec?volumeId={vid}")
        for sid in (0, 3, 7, 12):
            url = ec["shards"][str(sid)][0]
            st, out = phttp.post_json(
                f"http://{url}/admin/ec/delete_shards",
                {"volume_id": vid, "collection": "b1", "shard_ids": [sid]})
            assert st == 200, out
        _wait(lambda: len(phttp.get_json(
            f"http://{mu}/col/lookup/ec?volumeId={vid}")[1]["shards"])
            == 10, "the lookup drops the four shards")
        degraded = get("arc/b.bin").data
        kinds = sorted({e["kind"] for e in status()["recent"]})
        return {"healthy": healthy == payload,
                "degraded": degraded == payload,
                "keep": get("keep.bin").data == payload,
                "kinds": [k for k in kinds if k.startswith("s3_")],
                "warm_chunks": len(arc_entry()["chunks"])}
    finally:
        c.shutdown()


def test_s3_rules_end_to_end_through_the_filer():
    payload = random.Random(51).randbytes(20_000)
    got = {pkg: _flow(pkg, payload) for pkg in ("reference", "port")}
    assert got["port"] == got["reference"] == {
        "healthy": True, "degraded": True, "keep": True,
        "kinds": ["s3_expire", "s3_transition"], "warm_chunks": 2}


def _gateway(pkg, c, fs):
    """An anonymous S3 gateway of `pkg` in front of `fs`; its url."""
    if pkg == "reference":
        port = free_port()
        c.runners.append(c.serve(RS3Server(fs.url).app, port))
        return f"127.0.0.1:{port}"
    return c.add_s3(fs).url


def _gateway_flow(pkg, payload):
    """The S3 case with the rules put through the gateway: ``arc/b.bin``
    and ``keep.bin`` PUT through it, ``old/a.bin`` through the filer in
    a collection of its own (a gateway PUT lands in the filer's default
    collection, and the old/ chunks must not share the volume that warms
    down), every read through the gateway."""
    c, master, fs = _cluster(pkg)
    gw = f"http://{_gateway(pkg, c, fs)}"
    mu = c.master_url
    try:
        master.lifecycle.cfg.filer = fs.url
        assert phttp.request("PUT", f"{gw}/b1").status == 200
        for path in ("arc/b.bin", "keep.bin"):
            r = phttp.request("PUT", f"{gw}/b1/{path}", payload)
            assert r.status == 200, r.data
        r = phttp.request("PUT", f"http://{fs.url}/buckets/b1/old/a.bin"
                          "?collection=oldc", payload)
        assert r.status == 201, r.data
        _, old = phttp.get_json(
            f"http://{fs.url}/__meta__/lookup?path=/buckets/b1/old/a.bin")
        r = phttp.request("PUT", f"{gw}/b1?lifecycle", RULES)
        assert r.status == 200, r.data
        stored = phttp.request("GET", f"{gw}/b1?lifecycle").data

        def get(path):
            return phttp.request("GET", f"{gw}/b1/{path}")

        _wait(lambda: get("old/a.bin").status == 404, "old/ expired")

        def fid_status(fid):
            _, loc = phttp.get_json(f"http://{mu}/dir/lookup?fileId={fid}")
            return phttp.request(
                "GET", f"http://{loc['locations'][0]['url']}/{fid}").status

        _wait(lambda: all(fid_status(ch["fid"]) == 404
                          for ch in old["chunks"]), "old/ chunks freed")

        def classes():
            body = phttp.request("GET", f"{gw}/b1?list-type=2").data
            return dict(zip(re.findall(rb"<Key>(.*?)</Key>", body),
                            re.findall(rb"<StorageClass>(.*?)<", body)))

        _wait(lambda: classes().get(b"arc/b.bin") == b"WARM",
              "arc/ listed WARM")

        def status():
            return phttp.get_json(f"http://{mu}/lifecycle/status")[1]

        _wait(lambda: any(e["kind"] == "warm" and e["outcome"] == "ok"
                          for e in status()["recent"]),
              "the chunk volume's warm transition")
        master.repair_enabled = False
        healthy = get("arc/b.bin").data
        _, arc = phttp.get_json(
            f"http://{fs.url}/__meta__/lookup?path=/buckets/b1/arc/b.bin")
        vid = int(arc["chunks"][0]["fid"].split(",")[0])
        _, ec = phttp.get_json(f"http://{mu}/col/lookup/ec?volumeId={vid}")
        for sid in (0, 3, 7, 12):
            url = ec["shards"][str(sid)][0]
            st, out = phttp.post_json(
                f"http://{url}/admin/ec/delete_shards",
                {"volume_id": vid, "collection": "", "shard_ids": [sid]})
            assert st == 200, out
        _wait(lambda: len(phttp.get_json(
            f"http://{mu}/col/lookup/ec?volumeId={vid}")[1]["shards"])
            == 10, "the lookup drops the four shards")
        kinds = sorted({e["kind"] for e in status()["recent"]})
        return {"stored": stored == prules.rules_to_xml(
                    prules.parse_lifecycle_xml(RULES)),
                "healthy": healthy == payload,
                "degraded": get("arc/b.bin").data == payload,
                "keep": get("keep.bin").data == payload,
                "classes": classes(),
                "kinds": [k for k in kinds if k.startswith("s3_")],
                "warm_chunks": len(arc["chunks"])}
    finally:
        c.shutdown()


def test_s3_rules_end_to_end_through_the_gateway():
    payload = random.Random(53).randbytes(20_000)
    got = {pkg: _gateway_flow(pkg, payload) for pkg in ("reference", "port")}
    assert got["port"] == got["reference"] == {
        "stored": True, "healthy": True, "degraded": True, "keep": True,
        "classes": {b"arc/b.bin": b"WARM", b"keep.bin": b"STANDARD"},
        "kinds": ["s3_expire", "s3_transition"], "warm_chunks": 2}


@pytest.mark.parametrize("raw", [
    json.dumps([1]),
    json.dumps([{"status": "Enabled", "expire_days": "x"}]),
], ids=["not-a-rule", "days-not-a-number"])
def test_malformed_bucket_rules_do_not_stall_the_pass(raw):
    """A bucket entry's rules attribute written malformed through
    /__meta__/update_entry makes the S3 pass raise (an AttributeError,
    a TypeError); the same pass still plans and launches the warm-down
    of a volume in ``warm_requested``, in both packages."""
    payload = random.Random(52).randbytes(20_000)

    def run(pkg):
        c, master, fs = _cluster(pkg)
        base = f"http://{fs.url}"
        try:
            master.lifecycle.cfg.filer = fs.url
            r = phttp.request("PUT", f"{base}/buckets/b1/arc/b.bin"
                              "?collection=b1", payload)
            assert r.status == 201, r.data
            _, bucket = phttp.get_json(
                f"{base}/__meta__/lookup?path=/buckets/b1")
            bucket["extended"] = {prules.BUCKET_ATTR: raw}
            assert phttp.post_json(f"{base}/__meta__/update_entry",
                                   {"entry": bucket})[0] == 200
            _, entry = phttp.get_json(
                f"{base}/__meta__/lookup?path=/buckets/b1/arc/b.bin")
            vid = int(entry["chunks"][0]["fid"].split(",")[0])
            master.lifecycle.warm_requested[vid] = "test"

            def warm_ok():
                recent = phttp.get_json(
                    f"http://{c.master_url}/lifecycle/status")[1]["recent"]
                return any(e["kind"] == "warm" and e["volume"] == vid
                           and e["outcome"] == "ok" for e in recent)

            _wait(warm_ok, f"{pkg}: volume {vid}'s warm-down")
            return phttp.request("GET", f"{base}/buckets/b1/arc/b.bin"
                                 ).data == payload
        finally:
            c.shutdown()

    assert run("reference") and run("port")
