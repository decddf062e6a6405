"""The port's network filer stores, their fake servers, the MySQL and
Postgres dialects and the ``KvSequencer`` against the reference's.

- The store contract (tests/test_torch_filer_core.py's ``_drive_store``)
  over redis, redis2, etcd, mongodb, elastic and cassandra: the port's
  store on the port's fake answers as the reference's store on the
  reference's fake, and the two fakes hold the same keys and values
  afterwards (the layout is the reference's).
- Cross-wire: the port's store on the reference's fake, and the
  reference's store on the port's fake, answer the same.
- ``bson_lite``: seeded documents encode to the same bytes in both
  packages and decode back in either.
- redis2 lists from a sorted set, in pages ranked on the server.
- The MySQL and Postgres dialects' statements equal the reference's;
  both stores run the contract through a bridge that executes their SQL
  on sqlite, issuing the same statements as the reference's and
  answering as the sqlite store; without pymysql or psycopg2 both packages
  raise a ``RuntimeError`` naming the missing module.
- A filer on etcd (whose store blocks in ``urllib``) opens it and calls
  it in its executor, never on its loop.
- ``KvSequencer``: a port and a reference sequencer on one fake mint
  disjoint keys; ``set_max`` after the counter is reset; a port master
  on one assigns over HTTP with every sequencer call off its loop, and
  its keys after a restart exceed those before.
- CLI: ``master -sequencer_kv`` assigns from the KV's counter, and
  ``filer -store redis2 -store_servers`` serves a PUT and a GET; a
  malformed address, or one given to a store that takes none, is refused.
"""

import copy
import functools
import json
import signal
import sqlite3
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from cluster_util import TEST_GEOMETRY
from seaweedfs_torch.filer import abstract_sql as psql
from seaweedfs_torch.filer import bson_lite as pbson
from seaweedfs_torch.filer.entry import new_file
from seaweedfs_torch.filer.fake_redis import FakeRedisServer
from seaweedfs_torch.filer.redis_store import _RespClient as FakeRedisClient
from seaweedfs_torch.server.local_cluster import LocalCluster
from seaweedfs_torch.storage.file_id import FileId
from seaweedfs_torch.topology.sequence import KvSequencer as PKv
from seaweedfs_tpu.filer import abstract_sql as rsql
from seaweedfs_tpu.filer import bson_lite as rbson
from seaweedfs_tpu.topology.sequence import KvSequencer as RKv
from test_torch_filer_core import (NET_KINDS, PKGS, _drive_store,
                                   start_fake)

REPO = Path(__file__).resolve().parent.parent
OTHER = {"port": "reference", "reference": "port"}
SEQ_KEY = "master/sequence"


def within(seconds: int):
    """Fail the test with TimeoutError after `seconds` (SIGALRM)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            def fire(signum, frame):
                raise TimeoutError(f"{fn.__name__}: over {seconds} s")

            old = signal.signal(signal.SIGALRM, fire)
            signal.alarm(seconds)
            try:
                return fn(*args, **kwargs)
            finally:
                signal.alarm(0)
                signal.signal(signal.SIGALRM, old)
        return wrapper
    return deco


def _wait(cond, what: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.05)


def _fake_state(fake):
    """What a fake server holds, comparable across the packages."""
    if hasattr(fake, "_strings"):
        return (fake._strings, {k: sorted(v) for k, v in fake._sets.items()},
                fake._zsets)
    if hasattr(fake, "indices"):
        return fake.indices
    for attr in ("data", "docs", "parts"):
        if hasattr(fake.state, attr):
            return getattr(fake.state, attr)
    raise TypeError(type(fake))


def _contract(store_pkg: str, fake_pkg: str, kind: str, tmp_path):
    """The contract's answers from `store_pkg`'s store on `fake_pkg`'s
    fake, and what the fake holds after it."""
    fake, kw = start_fake(fake_pkg, kind)
    try:
        store = PKGS[store_pkg][4].create_store(kind, **kw)
        seen = _drive_store(store_pkg, kind, tmp_path, store)
        return seen, copy.deepcopy(_fake_state(fake))
    finally:
        fake.close()


# --- the store contract -----------------------------------------------------

@pytest.mark.parametrize("kind", NET_KINDS)
def test_store_contract_equal(tmp_path, kind):
    port = _contract("port", "port", kind, tmp_path)
    ref = _contract("reference", "reference", kind, tmp_path)
    assert port[0] == ref[0]
    assert port[1] == ref[1]


@pytest.mark.parametrize("store_pkg", ["port", "reference"])
@pytest.mark.parametrize("kind", NET_KINDS)
def test_cross_wire(tmp_path, kind, store_pkg):
    crossed = _contract(store_pkg, OTHER[store_pkg], kind, tmp_path)
    ref = _contract("reference", "reference", kind, tmp_path)
    assert crossed == ref


# --- bson_lite --------------------------------------------------------------

def _random_value(rng, depth: int):
    kind = int(rng.integers(0, 9 if depth < 2 else 7))
    if kind == 0:
        return "".join(chr(int(c)) for c in
                       rng.integers(32, 0x3000, size=int(rng.integers(0, 12))))
    if kind == 1:
        return rng.bytes(int(rng.integers(0, 20)))
    if kind == 2:
        return bool(rng.integers(0, 2))
    if kind == 3:
        return None
    if kind == 4:
        return int(rng.integers(-2 ** 31, 2 ** 31))
    if kind == 5:
        return int(rng.integers(-2 ** 62, 2 ** 62))
    if kind == 6:
        return float(rng.standard_normal() * 10 ** int(rng.integers(-5, 6)))
    if kind == 7:
        return _random_doc(rng, depth + 1)
    return [_random_value(rng, depth + 1)
            for _ in range(int(rng.integers(0, 5)))]


def _random_doc(rng, depth: int = 0) -> dict:
    return {f"k{i}.{int(rng.integers(0, 100))}": _random_value(rng, depth)
            for i in range(int(rng.integers(1, 8)))}


@pytest.mark.parametrize("seed", range(4))
def test_bson_lite_bytes_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        doc = _random_doc(rng)
        raw = pbson.encode_doc(doc)
        assert raw == rbson.encode_doc(doc)
        assert pbson.decode_doc(raw) == rbson.decode_doc(raw) == \
            (doc, len(raw))
        # a document at an offset, as an OP_MSG body carries it
        framed = b"\x00" * 5 + raw
        assert pbson.decode_doc(framed, 5) == (doc, len(raw))


# --- redis2: the sorted-set listing -----------------------------------------

def test_redis2_uses_sorted_set_listing():
    """Children live in a ZSET (ZADD NX), not a SET; a listing pages from
    the start name's rank, sorted by the server; the reference's store
    lists the port's writes the same."""
    from seaweedfs_tpu.filer.stores import create_store as rcreate

    from seaweedfs_torch.filer.stores import create_store as pcreate
    fake = FakeRedisServer()
    try:
        s = pcreate("redis2", host=fake.host, port=fake.port)
        r = rcreate("redis2", host=fake.host, port=fake.port)
        for i in np.random.default_rng(5).permutation(2100):
            s.insert_entry(new_file(f"/zd/f{int(i):04d}", []))
        assert b"/zd\x00" in fake._zsets and b"/zd\x00" not in fake._sets
        names = [f"/zd/f{i:04d}" for i in range(2100)]
        for store in (s, r):
            # past one ZRANGE page of 1024
            assert [e.full_path for e in store.list_directory_entries(
                "/zd", limit=3000)] == names
            assert [e.full_path for e in store.list_directory_entries(
                "/zd", start_file_name="f1500", limit=2)] == names[1501:1503]
            assert [e.full_path for e in store.list_directory_entries(
                "/zd", start_file_name="f1500", include_start=True,
                limit=2)] == names[1500:1502]
            # a start name that is not a member: a scan from the start
            assert [e.full_path for e in store.list_directory_entries(
                "/zd", start_file_name="f0999x", limit=2)] == \
                names[1000:1002]
        s.delete_entry("/zd/f0002")
        assert [e.name for e in r.list_directory_entries("/zd", limit=3)] \
            == ["f0000", "f0001", "f0003"]
        s.close()
        r.close()
    finally:
        fake.close()


# --- the SQL dialects -------------------------------------------------------

ENGINES = {"mysql": ("MysqlDialect", "MysqlStore"),
           "postgres": ("PostgresDialect", "PostgresStore")}
# the spellings sqlite reads differently; everything else runs verbatim
TRANSLATIONS = {
    "mysql": [("ON DUPLICATE KEY UPDATE meta=VALUES(meta)",
               "ON CONFLICT(dir, name) DO UPDATE SET meta=excluded.meta"),
              ("ON DUPLICATE KEY UPDATE v=VALUES(v)",
               "ON CONFLICT(k) DO UPDATE SET v=excluded.v"),
              (r"ESCAPE '\\'", r"ESCAPE '\'")],
    "postgres": [],
}


@pytest.mark.parametrize("engine", ENGINES)
def test_sql_dialect_statements_equal(engine):
    p = getattr(psql, ENGINES[engine][0])()
    r = getattr(rsql, ENGINES[engine][0])()

    def spell(d):
        return (d.placeholder, d.like_escape, d.upsert_entry(),
                d.upsert_kv(), d.create_tables())

    assert spell(p) == spell(r)
    assert p.placeholder == "%s"


class _Bridge:
    """A DB-API connection that runs a dialect's SQL on sqlite, changing
    only the engine's spellings, and records every statement."""

    def __init__(self, db: str, translations, log: list):
        self._c = sqlite3.connect(db, timeout=30)
        self._tr = translations
        self._log = log

    def cursor(self):
        bridge = self

        class Cur:
            def __init__(self):
                self._cur = bridge._c.cursor()

            def execute(self, sql, params=()):
                bridge._log.append((sql, list(params)))
                for a, b in bridge._tr:
                    sql = sql.replace(a, b)
                return self._cur.execute(sql.replace("%s", "?"), params)

            def fetchone(self):
                return self._cur.fetchone()

            def fetchall(self):
                return self._cur.fetchall()

        return Cur()

    def commit(self):
        self._c.commit()

    def rollback(self):
        self._c.rollback()

    def close(self):
        self._c.close()


def _bridged_contract(pkg: str, engine: str, tmp_path):
    mod = psql if pkg == "port" else rsql
    cls = getattr(mod, ENGINES[engine][1])
    log: list = []
    db = str(tmp_path / f"{pkg}.{engine}.db")

    class Bridged(cls):
        def __init__(self):
            # the engine's connection parameters are skipped: the
            # schema goes through the bridge
            mod.AbstractSqlStore.__init__(self)

        def _connect(self):
            return _Bridge(db, TRANSLATIONS[engine], log)

    seen = _drive_store(pkg, engine, tmp_path, Bridged())
    return seen, log


@pytest.mark.parametrize("engine", ENGINES)
def test_sql_dialect_runs_the_contract(tmp_path, engine):
    port, port_sql = _bridged_contract("port", engine, tmp_path)
    ref, ref_sql = _bridged_contract("reference", engine, tmp_path)
    assert port_sql == ref_sql and port == ref
    # the dialect's SQL answers as the sqlite store does
    assert port == _drive_store("port", "sqlite", tmp_path)
    assert any("%s" in sql for sql, _ in port_sql)


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("engine", ENGINES)
def test_missing_driver_raises(pkg, engine):
    with pytest.raises(RuntimeError, match="driver"):
        PKGS[pkg][4].create_store(engine)


# --- KvSequencer ------------------------------------------------------------

def _counter(host: str, port: int) -> int:
    c = FakeRedisClient(host, port)
    try:
        return int(c.command("GET", SEQ_KEY) or b"0")
    finally:
        c.close()


@pytest.mark.parametrize("fake_pkg", ["port", "reference"])
def test_kv_sequencers_mint_disjoint_keys(fake_pkg):
    """A port and a reference sequencer leasing from one counter never
    mint one key twice, batches larger than a lease included."""
    fake, kw = start_fake(fake_pkg, "redis")
    try:
        seqs = [PKv(kw["host"], kw["port"], batch=10),
                RKv(kw["host"], kw["port"], batch=10)]
        rng = np.random.default_rng(11)
        seen = []
        for _ in range(200):
            n = int(rng.integers(1, 25))
            first = seqs[int(rng.integers(0, 2))].next_file_id(n)
            seen.extend(range(first, first + n))
        assert len(seen) == len(set(seen))
        assert max(seen) <= _counter(kw["host"], kw["port"])
        seqs[0].close()
    finally:
        fake.close()


@within(60)
def test_kv_sequencer_threads_mint_unique_keys():
    """16 threads (more than the cores) on one port sequencer and one
    reference sequencer, the interpreter switching threads often: no key
    twice, batches past a lease included."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with FakeRedisServer() as (host, port):
            seqs = [PKv(host, port, batch=7), RKv(host, port, batch=7)]
            got: list = []

            def mint(k: int) -> None:
                rng = np.random.default_rng(k)
                mine = []
                for _ in range(150):
                    n = int(rng.integers(1, 10))
                    first = seqs[k % 2].next_file_id(n)
                    mine.extend(range(first, first + n))
                got.append(mine)

            workers = [threading.Thread(target=mint, args=(k,))
                       for k in range(16)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(30)
            assert not any(w.is_alive() for w in workers)
            keys = [k for mine in got for k in mine]
            assert len(got) == 16 and len(keys) == len(set(keys))
            assert max(keys) <= _counter(host, port)
            seqs[0].close()
    finally:
        sys.setswitchinterval(old)


def _after_reset(cls) -> list:
    """Keys a sequencer mints across a reset of the KV's counter: `a`
    leased before it, `b` starts after it and is raised (``set_max``) to
    the highest key seen, as a master is to its volumes' keys."""
    with FakeRedisServer() as (host, port):
        a = cls(host, port, batch=10)
        keys = [a.next_file_id(3) for _ in range(5)]
        c = FakeRedisClient(host, port)
        c.command("FLUSHALL")
        c.close()
        seen = keys[-1] + 2
        b = cls(host, port, batch=10)
        b.set_max(seen)
        keys += [b.next_file_id() for _ in range(12)]
        a.set_max(seen)
        keys += [a.next_file_id(4) for _ in range(6)]
        keys.append(_counter(host, port))
        return keys


def test_set_max_against_a_reset_counter():
    port = _after_reset(PKv)
    assert port == _after_reset(RKv)
    seen = port[4] + 2
    # every lease taken after the reset lies above the highest key seen
    assert min(port[5:17]) > seen
    assert all(k > seen for k in port[17:23])
    # a's lease from before the reset stays, in both packages: its next
    # keys (17-20) were also leased to b, and both mint 17 (ROADMAP
    # Queue 3, D20)
    assert port[17] == seen + 1 and seen + 1 in port[5:17]
    assert port[-1] >= max(port[5:23])


class _Recording(PKv):
    """A KvSequencer that records the thread of each call."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.threads = []

    def next_file_id(self, count: int = 1) -> int:
        self.threads.append(threading.current_thread())
        return super().next_file_id(count)

    def set_max(self, seen: int) -> None:
        self.threads.append(threading.current_thread())
        super().set_max(seen)


def _assign_keys(cl, n: int) -> list:
    keys = []
    while len(keys) < n:
        try:
            with urllib.request.urlopen(
                    f"http://{cl.master_url}/dir/assign?count=3",
                    timeout=10) as r:
                body = json.load(r)
        except urllib.error.HTTPError as e:
            # a restarted master waits for the servers' beats
            assert e.code == 503, e.read()
            time.sleep(0.1)
            continue
        keys.append(FileId.parse(body["fid"]).key)
    return keys


@within(120)
def test_master_assigns_through_a_kv_sequencer(tmp_path):
    fake = FakeRedisServer()
    made = []

    def sequencer():
        made.append(_Recording(fake.host, fake.port, batch=50))
        return made[-1]

    cl = LocalCluster(1, coder_name="numpy", geometry=TEST_GEOMETRY,
                      volume_size_limit_mb=1, pulse=0.15, racks=1,
                      directory=str(tmp_path), sequencer=sequencer)
    try:
        before = _assign_keys(cl, 40)
        cl.restart_master(0)
        cl.wait_for_nodes(1)
        after = _assign_keys(cl, 40)
        assert len(made) == 2
        # every call of both sequencers ran off the cluster's loop
        for seq in made:
            assert seq.threads
            assert all(t is not cl._thread for t in seq.threads)
        assert min(after) > max(before)
        spans = [range(k, k + 3) for k in before + after]
        keys = [k for s in spans for k in s]
        assert len(keys) == len(set(keys))
        assert _counter(fake.host, fake.port) >= max(keys)
        # the master logged its key ceiling through raft
        assert cl.master._key_bound > max(after)
    finally:
        cl.shutdown()
        fake.close()


@within(120)
def test_filer_calls_its_network_store_off_the_loop(tmp_path, monkeypatch):
    """etcd's store blocks in urllib: a filer opens it and makes every
    call of it in its executor, never on the cluster's loop."""
    from seaweedfs_torch.filer import etcd_store
    threads = []
    real = etcd_store.EtcdStore._call

    def call(self, api, payload):
        threads.append(threading.current_thread())
        return real(self, api, payload)

    monkeypatch.setattr(etcd_store.EtcdStore, "_call", call)
    fake, kw = start_fake("port", "etcd")
    cl = LocalCluster(1, coder_name="numpy", geometry=TEST_GEOMETRY,
                      volume_size_limit_mb=1, pulse=0.15, racks=1,
                      directory=str(tmp_path))
    try:
        fs = cl.add_filer("etcd", 64 * 1024, kw)
        base = f"http://{fs.url}"
        data = np.random.default_rng(9).bytes(200_000)

        def put() -> bool:
            req = urllib.request.Request(f"{base}/d/a.bin", data=data,
                                         method="PUT")
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    return r.status == 201
            except urllib.error.HTTPError:
                return False

        _wait(put, "a PUT through the etcd filer")
        with urllib.request.urlopen(f"{base}/d/a.bin", timeout=30) as r:
            assert r.read() == data
        body = json.dumps({"entry": json.loads(
            new_file("/m/e1").to_json())}).encode()
        req = urllib.request.Request(
            f"{base}/__meta__/create_entry", data=body, method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200
        req = urllib.request.Request(f"{base}/d?mv.to=/moved", method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200
        with urllib.request.urlopen(f"{base}/__meta__/list?dir=/moved",
                                    timeout=30) as r:
            assert [e["path"] for e in json.load(r)["entries"]] == \
                ["/moved/a.bin"]
        cl.restart_filer(fs)
        assert threads
        assert all(t is not cl._thread for t in threads)
    finally:
        cl.shutdown()
        fake.close()


# --- CLI --------------------------------------------------------------------

_CLI = ("import sys; sys.path.insert(0, %r); "
        "from seaweedfs_torch.cli import main; main()" % str(REPO))


def _free_port() -> int:
    """A free port whose gRPC twin (+10000) is free too: a CLI server
    binds both."""
    from seaweedfs_torch.server.http import free_port_with_grpc_twin
    return free_port_with_grpc_twin()


def _up(url: str) -> bool:
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status == 200
    except OSError:
        return False


@pytest.fixture(scope="module")
def cli_stack(tmp_path_factory):
    """A master leasing keys from one fake redis, a volume server, and a
    filer on redis2 on another, each a CLI process."""
    work = tmp_path_factory.mktemp("netcli")
    seq_kv, meta_kv = FakeRedisServer(), FakeRedisServer()
    mport, vport, fport = _free_port(), _free_port(), _free_port()
    master = f"127.0.0.1:{mport}"
    cli = [sys.executable, "-I", "-c", _CLI]
    args = [
        ["master", "-port", str(mport), "-volumeSizeLimitMB", "1",
         "-pulse", "0.2", "-sequencer_kv", f"127.0.0.1:{seq_kv.port}"],
        ["volume", "-port", str(vport), "-dir", str(work), "-mserver",
         master, "-pulse", "0.2", "-coder", "numpy"],
        ["filer", "-port", str(fport), "-mserver", master, "-store",
         "redis2", "-store_servers", f"127.0.0.1:{meta_kv.port}",
         "-chunk_size_mb", "1"],
    ]
    procs = []
    try:
        for a in args:
            procs.append(subprocess.Popen(cli + a, stdout=subprocess.DEVNULL,
                                          stderr=subprocess.DEVNULL))

        def up() -> bool:
            assert all(p.poll() is None for p in procs)
            return _up(f"http://{master}/dir/status") and \
                _up(f"http://127.0.0.1:{fport}/healthz")

        _wait(up, "the CLI servers", timeout=60)
        yield {"master": master, "filer": f"127.0.0.1:{fport}",
               "seq_kv": seq_kv, "meta_kv": meta_kv}
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
        seq_kv.close()
        meta_kv.close()


@within(120)
def test_cli_master_sequencer_kv_assigns(cli_stack):
    kv = cli_stack["seq_kv"]

    def assign():
        try:
            with urllib.request.urlopen(
                    f"http://{cli_stack['master']}/dir/assign",
                    timeout=10) as r:
                return FileId.parse(json.load(r)["fid"]).key
        except (urllib.error.HTTPError, KeyError):
            return None

    keys = []

    def first() -> bool:
        key = assign()   # None until the volume server has registered
        if key is not None:
            keys.append(key)
        return bool(keys)

    _wait(first, "an assign", timeout=60)
    keys += [assign() for _ in range(5)]
    assert None not in keys and len(set(keys)) == len(keys)
    assert max(keys) <= _counter(kv.host, kv.port)


@within(120)
def test_cli_filer_on_redis2_serves_put_get(cli_stack):
    data = np.random.default_rng(3).bytes(300_000)
    url = f"http://{cli_stack['filer']}/cli/dir/a.bin"

    def put() -> bool:
        req = urllib.request.Request(url, data=data, method="PUT")
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status in (200, 201)
        except urllib.error.HTTPError:
            return False   # no volume to write to yet

    _wait(put, "a PUT through the filer", timeout=60)
    with urllib.request.urlopen(url, timeout=30) as r:
        assert r.read() == data
    # the entry and its directory's sorted set live on the KV
    meta = cli_stack["meta_kv"]
    assert b"/cli/dir\x00" in meta._zsets
    assert b"/cli/dir/a.bin" in meta._strings


@pytest.mark.parametrize("argv, says", [
    (["filer", "-store", "redis", "-store_servers", "127.0.0.1"],
     "host:port"),
    (["filer", "-store", "cassandra", "-store_servers", "h:cql"],
     "host:port"),
    (["filer", "-store", "etcd", "-store_servers", ","], "needs an address"),
    (["filer", "-store", "mysql", "-store_servers", "h:3306"],
     "takes no server address"),
    (["filer", "-store", "sqlite", "-store_servers", "h:1"],
     "takes no server address"),
    (["master", "-sequencer_kv", "6379"], "host:port"),
])
def test_cli_refuses_a_bad_store_address(argv, says):
    """A malformed address, or one given to a store that takes none,
    stops the command with a message before it serves."""
    from seaweedfs_torch.cli import main
    with pytest.raises(SystemExit, match=says):
        main(argv)
