"""The port's object-store tier against the reference's.

One volume is written once and copied (with its mtime), and each
package's Store moves its copy's .dat to the same directory-backed object
store: the ``.vif`` each writes must be the same bytes, reads go through
``RemoteFile``, the volume comes back tiered after a restart, a second
upload is refused, and the download brings back the same .dat. Also here:
``RemoteFile``'s block cache against the reference's (the same store
calls for the same reads), ``sign_request`` against the reference's for a
pinned time and through the reference's S3 gateway verifier, and
``volume.tier.upload`` / ``volume.tier.download`` through the port's
shell on a cluster, with every needle read over HTTP in between, and a
tier to an S3 endpoint that checks every signature with the reference
gateway's verifier, through a restart.
"""

import hashlib
import os
import random
import shutil
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
from aiohttp.test_utils import make_mocked_request

from seaweedfs_torch.client import Client as PClient
from seaweedfs_torch.client import ClientError as PClientError
from seaweedfs_torch.ec import geometry as pgeo
from seaweedfs_torch.s3 import sigv4 as psig
from seaweedfs_torch.server.local_cluster import LocalCluster
from seaweedfs_torch.shell import commands as pcommands
from seaweedfs_torch.storage import backend as pbackend
from seaweedfs_torch.storage import store as pstore
from seaweedfs_torch.storage.needle import Needle as PNeedle
from seaweedfs_torch.storage.volume import VolumeReadOnly as PReadOnly
from seaweedfs_tpu.s3 import sigv4 as rsig
from seaweedfs_tpu.s3.s3_server import S3Server
from seaweedfs_tpu.storage import backend as rbackend
from seaweedfs_tpu.storage import store as rstore
from seaweedfs_tpu.storage.needle import Needle as RNeedle
from seaweedfs_tpu.storage.volume import VolumeReadOnly as RReadOnly

PACKAGES = {"ref": (rstore, rbackend, RNeedle, RReadOnly),
            "port": (pstore, pbackend, PNeedle, PReadOnly)}


def _payloads(n: int = 60, seed: int = 4) -> dict:
    rng = random.Random(seed)
    return {i: rng.randbytes(rng.randint(10, 9000)) for i in range(1, n + 1)}


def _sha(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture()
def source(tmp_path):
    """A volume of 60 needles (every 7th deleted), written by the
    reference's Store."""
    d = tmp_path / "src"
    st = rstore.Store([str(d)], coder_name="numpy")
    st.add_volume(1)
    payloads = _payloads()
    for i, data in payloads.items():
        st.write_needle(1, RNeedle(cookie=0x100 + i, id=i, data=data))
    deleted = set(range(1, 61, 7))
    for i in deleted:
        st.delete_needle(1, RNeedle(cookie=0x100 + i, id=i))
    st.close()
    return {"dir": d, "payloads": payloads, "deleted": deleted}


def _reads(st, source) -> list:
    out = []
    for i, data in source["payloads"].items():
        try:
            out.append(st.read_needle(1, i, cookie=0x100 + i).data == data)
        except KeyError as e:
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("kind", ["memory", "leveldb"])
def test_tier_cycle_matches_reference(source, tmp_path, kind):
    bucket = str(tmp_path / "bucket")
    spec = {"type": "local_store", "directory": bucket}
    original = _sha(source["dir"] / "1.dat")
    seen = {}
    for name, (smod, bmod, needle, read_only) in PACKAGES.items():
        d = tmp_path / name
        shutil.copytree(source["dir"], d)      # copy2: the mtime too
        st = smod.Store([str(d)], coder_name="numpy", needle_map_kind=kind)
        got = [_reads(st, source)]
        info = st.tier_upload(1, spec)
        v = st.find_volume(1)
        got += [info, v.is_remote, v.read_only,
                os.path.exists(d / "1.dat"), _reads(st, source)]
        with pytest.raises(read_only):
            v.write_needle(needle(cookie=1, id=999, data=b"no"))
        with pytest.raises(ValueError):
            st.tier_upload(1, spec)
        got.append([(h["id"], h["file_count"], h["read_only"])
                    for h in st.heartbeat()["volumes"]])
        got.append(_sha(os.path.join(bucket, "1.dat")) == original)
        with open(d / "1.vif", "rb") as f:
            vif = f.read()
        st.close()
        # the restart: the .vif brings the volume back tiered
        st = smod.Store([str(d)], coder_name="numpy", needle_map_kind=kind)
        v = st.find_volume(1)
        got += [v is not None and v.is_remote, _reads(st, source)]
        got.append(st.tier_download(1))
        v = st.find_volume(1)
        got += [v.is_remote, v.read_only, os.path.exists(d / "1.vif"),
                _sha(d / "1.dat") == original, _reads(st, source)]
        with pytest.raises(ValueError):
            st.tier_download(1)
        st.close()
        seen[name] = (got, vif)
    assert seen["port"][1] == seen["ref"][1]
    assert seen["port"][0] == seen["ref"][0]
    assert seen["port"][0][2] is True


def test_tier_upload_rolls_back_its_seal(source, tmp_path):
    """An upload whose store fails leaves the volume writable, as the
    reference's does."""
    for name, (smod, _, needle, _) in PACKAGES.items():
        d = tmp_path / name
        shutil.copytree(source["dir"], d)
        st = smod.Store([str(d)], coder_name="numpy")
        with pytest.raises(KeyError):
            st.tier_upload(1, {"type": "nowhere"})
        v = st.find_volume(1)
        assert not v.read_only and not v.is_remote
        v.write_needle(needle(cookie=5, id=500, data=b"still writable"))
        st.close()


def test_remote_file_block_cache_matches_reference(tmp_path):
    """The same reads through both RemoteFiles: the same bytes, and the
    same calls into the store (the block LRU hits and evicts alike)."""
    blob = tmp_path / "blob"
    rng = random.Random(7)
    blob.write_bytes(rng.randbytes(5 * 1024 * 1024 + 777))
    size = blob.stat().st_size
    reads = [(rng.randint(1, 300_000), rng.randint(0, size + 10))
             for _ in range(400)]
    reads += [(2 * 1024 * 1024, 1024 * 1024 - 5), (16, size - 8),
              (10, size + 100)]
    seen = {}
    for name, (_, bmod, _, _) in PACKAGES.items():
        store = bmod.LocalObjectStore(str(tmp_path / f"bucket_{name}"))
        store.put("k", str(blob))
        calls = []
        get_range = store.get_range

        def counting(key, off, n, get_range=get_range, calls=calls):
            calls.append((off, n))
            return get_range(key, off, n)

        store.get_range = counting
        rf = bmod.RemoteFile(store, "k", size)
        rf.CACHE_BLOCKS = 3
        out = [hashlib.sha256(rf.read_at(n, off)).hexdigest()
               for n, off in reads]
        with pytest.raises(IOError):
            rf.write_at(b"x", 0)
        with pytest.raises(IOError):
            rf.truncate(0)
        seen[name] = (out, calls, rf.size())
    assert seen["port"] == seen["ref"]
    data = blob.read_bytes()
    assert seen["port"][0][-2] == hashlib.sha256(data[size - 8:]).hexdigest()


def test_open_store_and_specs_match_reference(tmp_path):
    for spec in ({"type": "local_store", "directory": str(tmp_path / "b")},
                 {"type": "s3", "endpoint": "http://127.0.0.1:1/",
                  "bucket": "bk", "access_key": "ak", "secret_key": "sk"}):
        p = pbackend.open_store(spec)
        r = rbackend.open_store(spec)
        assert p.spec() == r.spec() and p.kind == r.kind
        assert "secret_key" not in p.spec()
    for mod in (pbackend, rbackend):
        with pytest.raises(KeyError):
            mod.open_store({"type": "tape"})


SIGNED = [("PUT", "http://127.0.0.1:8333/b/k.dat", {}, b"payload"),
          ("GET", "http://127.0.0.1:8333/b/1.dat",
           {"Range": "bytes=0-1048575"}, b""),
          ("HEAD", "http://h:9000/bucket/dir/a%20b.dat?key=1&key1=2", {},
           b""),
          ("DELETE", "http://h:9000/bucket/x.dat?uploadId=", {}, b"")]


@pytest.mark.parametrize("case", range(len(SIGNED)))
def test_sign_request_matches_reference(case):
    method, url, headers, body = SIGNED[case]
    for now in (1_700_000_000.0, 1_800_000_123.5):
        p = psig.sign_request(method, url, dict(headers), body, "AKID",
                              "SECRET", region="eu-west-1", now=now)
        r = rsig.sign_request(method, url, dict(headers), body, "AKID",
                              "SECRET", region="eu-west-1", now=now)
        assert p == r


class _Identity:
    name = "tier"

    def allows(self, action, bucket):
        return True


class _Iam:
    enabled = True

    def lookup(self, akid):
        return (_Identity(), "SECRET") if akid == "AKID" else None


def _gateway_check(method: str, url: str, headers: dict):
    gateway = object.__new__(S3Server)
    gateway.iam = _Iam()
    path = url.split("://", 1)[1]
    path = path[path.index("/"):]
    return S3Server._check_auth(
        gateway, make_mocked_request(method, path, headers=headers),
        "Write", "b")


# the requests whose paths carry no percent-escape (the tier's keys are
# "<collection>_<vid>.dat")
PLAIN = [i for i, c in enumerate(SIGNED) if "%" not in c[1]]


@pytest.mark.parametrize("case", PLAIN)
def test_signed_request_passes_reference_gateway(case):
    """The port's headers through the reference's S3 gateway check
    (S3Server._check_auth): accepted; with the body's hash changed,
    refused."""
    method, url, headers, body = SIGNED[case]
    signed = psig.sign_request(method, url, dict(headers), body, "AKID",
                               "SECRET")
    assert _gateway_check(method, url, signed) is None
    tampered = {**signed, "x-amz-content-sha256":
                hashlib.sha256(body + b"!").hexdigest()}
    bad = _gateway_check(method, url, tampered)
    assert bad is not None and bad.status == 403


def test_escaped_key_is_refused_by_both_signers_alike():
    """A key whose URL carries a percent-escape: the reference's signer
    quotes the escaped path again while its gateway verifies the decoded
    one, so the gateway refuses the signature; the port's signer is the
    reference's and is refused the same way (ROADMAP Queue 3, D11). The
    tier never names such a key."""
    method, url, headers, body = SIGNED[2]
    for mod in (psig, rsig):
        signed = mod.sign_request(method, url, dict(headers), body, "AKID",
                                  "SECRET")
        bad = _gateway_check(method, url, signed)
        assert bad is not None and bad.status == 403


class _S3Endpoint:
    """An S3 endpoint on localhost that keeps objects in memory and
    answers 403 to a request that fails the reference gateway's SigV4
    check (``S3Server._check_auth``), or to a PUT whose body is not the
    one its signature covers."""

    def __init__(self):
        self.objects: dict = {}
        self.refused = 0
        endpoint = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _reply(self, status: int, body: bytes = b"",
                       length: int | None = None) -> None:
                self.send_response(status)
                self.send_header("Content-Length", str(
                    len(body) if length is None else length))
                self.end_headers()
                if body:
                    self.wfile.write(body)

            def _allowed(self, body: bytes = b"") -> bool:
                headers = dict(self.headers.items())
                bad = _gateway_check(self.command, "http://s3" + self.path,
                                     headers)
                if bad is None and self.command == "PUT":
                    bad = (hashlib.sha256(body).hexdigest()
                           != self.headers.get("x-amz-content-sha256"))
                if bad:
                    endpoint.refused += 1
                    self._reply(403)
                return not bad

            def do_PUT(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                if self._allowed(body):
                    endpoint.objects[self.path] = body
                    self._reply(200)

            def do_HEAD(self):
                if self._allowed():
                    obj = endpoint.objects.get(self.path)
                    if obj is None:
                        self._reply(404)
                    else:
                        self._reply(200, length=len(obj))

            def do_GET(self):
                if not self._allowed():
                    return
                obj = endpoint.objects.get(self.path)
                if obj is None:
                    self._reply(404)
                    return
                first, _, last = self.headers.get(
                    "Range", "bytes=0-").removeprefix("bytes=").partition("-")
                end = int(last) + 1 if last else len(obj)
                self._reply(206 if "Range" in self.headers else 200,
                            obj[int(first):end])

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self._server.server_port}"
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join()


def test_s3_tier_signs_after_a_restart(source, tmp_path, monkeypatch):
    """A volume tiered to an S3 endpoint that verifies every signature.
    The ``.vif`` holds no keys, so a reopened volume signs with the
    server's ``WEED_S3_ACCESS_KEY`` / ``WEED_S3_SECRET_KEY``: without them
    it is refused and does not load; with them the port's reads and
    download go through. The reference signs nothing after the restart
    and its volume does not load either way (ROADMAP Queue 3, D12)."""
    original = _sha(source["dir"] / "1.dat")
    endpoint = _S3Endpoint()
    seen = {}
    try:
        for name, (smod, _, _, _) in PACKAGES.items():
            d = tmp_path / name
            shutil.copytree(source["dir"], d)
            spec = {"type": "s3", "endpoint": endpoint.url, "bucket": name,
                    "access_key": "AKID", "secret_key": "SECRET"}
            monkeypatch.delenv("WEED_S3_ACCESS_KEY", raising=False)
            monkeypatch.delenv("WEED_S3_SECRET_KEY", raising=False)
            st = smod.Store([str(d)], coder_name="numpy")
            live = _reads(st, source)
            info = st.tier_upload(1, spec)
            got = [info["files"][0]["backend"], _reads(st, source) == live,
                   endpoint.refused]
            st.close()
            st = smod.Store([str(d)], coder_name="numpy")
            got += [st.find_volume(1) is not None, endpoint.refused > 0]
            st.close()
            endpoint.refused = 0
            monkeypatch.setenv("WEED_S3_ACCESS_KEY", "AKID")
            monkeypatch.setenv("WEED_S3_SECRET_KEY", "SECRET")
            st = smod.Store([str(d)], coder_name="numpy")
            v = st.find_volume(1)
            got.append(v is not None and v.is_remote)
            if v is not None:
                got.append(_reads(st, source) == live)
                st.tier_download(1)
                got += [_sha(d / "1.dat") == original,
                        _reads(st, source) == live]
            got.append(endpoint.refused)
            st.close()
            endpoint.refused = 0
            seen[name] = got
    finally:
        endpoint.close()
    for name in PACKAGES:
        assert seen[name][0] == {"type": "s3", "endpoint": endpoint.url,
                                 "bucket": name, "region": "us-east-1"}
        assert seen[name][1:5] == [True, 0, False, True]
    assert seen["port"][5:] == [True, True, True, True, 0]
    assert seen["ref"][5] is False and seen["ref"][6] > 0


PG = pgeo.Geometry(10, 4, large_block_size=64 * 1024,
                   small_block_size=4 * 1024)


def test_tier_commands_through_the_shell(tmp_path):
    """volume.tier.upload to a local store and volume.tier.download
    through the port's shell (they take the admin lease): every needle
    reads over HTTP while tiered, after the holder restarts, and after
    the download."""
    cl = LocalCluster(2, coder_name="numpy", geometry=PG,
                      volume_size_limit_mb=1, pulse=0.15,
                      directory=str(tmp_path / "cl"),
                      store_kwargs={"needle_map_kind": "leveldb"})
    try:
        client = PClient(cl.master_url)
        pcommands._register_all()
        env = pcommands.CommandEnv(client, PG)
        rng = random.Random(3)
        fids = {}
        for i in range(30):
            data = rng.randbytes(rng.randint(100, 20_000))
            fids[client.upload(data, collection="tier")] = data
        vid = int(next(iter(fids)).split(",")[0])
        assert {int(f.split(",")[0]) for f in fids} == {vid}

        def read_all():
            client._vid_cache.clear()
            for fid, data in fids.items():
                assert client.download(fid) == data, fid

        bucket = str(tmp_path / "bucket")
        out = pcommands.run_command(
            env, ["volume.tier.upload", "-volumeId", str(vid), "-dest",
                  f"local_store:{bucket}"])
        assert out["ok"] and len(out["results"]) == 1
        holder = cl.index_of(client.lookup(vid)[0])
        v = cl.store(holder).find_volume(vid)
        assert v.is_remote and not os.path.exists(
            v.base_file_name() + ".dat")
        read_all()
        with pytest.raises(PClientError):
            pcommands.run_command(
                env, ["volume.tier.upload", "-volumeId", str(vid),
                      "-dest", f"local_store:{bucket}"])
        cl.restart_volume_server(holder)
        cl.wait_for_nodes(2)
        assert cl.store(holder).find_volume(vid).is_remote
        read_all()
        out = pcommands.run_command(
            env, ["volume.tier.download", "-volumeId", str(vid)])
        assert out["ok"]
        v = cl.store(holder).find_volume(vid)
        assert not v.is_remote and v.read_only
        read_all()
        with pytest.raises(PClientError):
            pcommands.run_command(env, ["volume.tier.upload", "-volumeId",
                                        str(vid), "-dest", "tape:x"])
    finally:
        cl.shutdown()


def test_tiered_volume_without_a_descriptor_answers_as_reference(source,
                                                                  tmp_path):
    """A tiered .dat has no file descriptor: the nowait read and write
    decline (the executor path serves them), a plain ec_generate fails on
    the absent .dat, and the fused pass reads through the object store;
    all as the reference answers, the fused shards the same bytes."""
    from seaweedfs_tpu.ec import geometry as rgeo
    seen = {}
    for name, (smod, _, needle, _) in PACKAGES.items():
        geo = rgeo if name == "ref" else pgeo
        g = geo.Geometry(4, 2, large_block_size=64 * 1024,
                         small_block_size=4 * 1024)
        d = tmp_path / name
        shutil.copytree(source["dir"], d)
        st = smod.Store([str(d)], coder_name="numpy",
                        geometry_policy=geo.GeometryPolicy({}, g))
        try:
            st.tier_upload(1, {"type": "local_store",
                               "directory": str(tmp_path / f"b_{name}")})
            v = st.find_volume(1)
            got = [v.read_needle_nowait(2), v.write_needles_batch_nowait(
                [needle(cookie=1, id=900, data=b"x")])]
            with pytest.raises(FileNotFoundError):
                st.ec_generate(1)
            got.append(st.ec_fused_generate(1))
            got.append([_sha(d / f"1.ec{i:02d}") for i in range(6)])
            got.append(_sha(d / "1.ecx"))
        finally:
            st.close()
        seen[name] = got
    assert seen["port"] == seen["ref"]
    assert seen["port"][:2] == [None, None]
