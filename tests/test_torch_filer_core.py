"""The port's filer core (seaweedfs_torch/filer) against the reference's
(seaweedfs_tpu/filer) on the same inputs.

Chunk math (visible intervals, read plans, compaction, etags) on 200
seeded random overwrite sequences and the reference's named cases;
entries' JSON; manifest blobs; the store contract, one test over the
four embedded stores, each package's store given the same operations
(tests/test_torch_network_stores.py runs it over the network stores);
the namespace core (create, rename, delete, events, the rename's
rollback); and state carried across: sqlite, leveldb and leveldb2 stores
and the six network stores (on the reader's package's fake server), and
a persisted event log, written by one package are opened and listed
equally by the other.
"""

import asyncio
import importlib
import json
import random
import sqlite3

import pytest

from seaweedfs_torch.filer import chunks as pch
from seaweedfs_torch.filer import entry as pent
from seaweedfs_torch.filer import filer as pfil
from seaweedfs_torch.filer import manifest as pman
from seaweedfs_torch.filer import stores as pstores
from seaweedfs_tpu.filer import chunks as rch
from seaweedfs_tpu.filer import entry as rent
from seaweedfs_tpu.filer import filer as rfil
from seaweedfs_tpu.filer import manifest as rman
from seaweedfs_tpu.filer import stores as rstores

PKGS = {"port": (pch, pent, pfil, pman, pstores),
        "reference": (rch, rent, rfil, rman, rstores)}
STORES = ("memory", "sqlite", "leveldb", "leveldb2")
# the network stores (the port's table: each package's fake has the
# same module and class)
NET_KINDS = tuple(pstores.NETWORK_STORES)
PKG_NAMES = {"port": "seaweedfs_torch", "reference": "seaweedfs_tpu"}


def start_fake(pkg: str, kind: str):
    """`pkg`'s fake server for the network store `kind`, running; returns
    it and the store's kwargs."""
    module, cls, _ = pstores.NETWORK_STORES[kind]
    mod = importlib.import_module(f"{PKG_NAMES[pkg]}.filer.{module}")
    fake = getattr(mod, cls)()
    return fake, pstores.network_store_kwargs(kind,
                                              f"{fake.host}:{fake.port}")


def _chunks(mod, specs):
    return [mod.FileChunk(fid, off, size, mtime=mt, etag=et)
            for fid, off, size, mt, et in specs]


def _views(views):
    return [(v.fid, v.offset_in_chunk, v.size, v.logic_offset)
            for v in views]


def _intervals(vis):
    return [(v.start, v.stop, v.fid, v.mtime, v.chunk_offset) for v in vis]


def _random_specs(rng, n, size):
    specs = []
    for i in range(n):
        off = rng.randrange(0, size - 1)
        ln = rng.randrange(1, size - off + 1)
        # mtimes collide now and then: ties break by offset
        specs.append((f"{rng.randrange(1, 9)},{i:04x}{rng.getrandbits(32):08x}",
                      off, ln, rng.randrange(0, n // 2 + 1),
                      f"{rng.getrandbits(64):016x}"))
    return specs


def test_chunk_math_random_sequences_equal():
    rng = random.Random(20261018)
    for case in range(200):
        size = rng.choice((64, 1000, 1 << 20))
        specs = _random_specs(rng, rng.randrange(1, 40), size)
        p, r = _chunks(pch, specs), _chunks(rch, specs)
        assert _intervals(pch.non_overlapping_visible_intervals(p)) == \
            _intervals(rch.non_overlapping_visible_intervals(r)), case
        for _ in range(5):
            off = rng.randrange(0, size)
            ln = rng.randrange(0, size - off + 1)
            assert _views(pch.read_plan(p, off, ln)) == \
                _views(rch.read_plan(r, off, ln)), (case, off, ln)
        live_p, garbage_p = pch.compact_chunks(p)
        live_r, garbage_r = rch.compact_chunks(r)
        assert [c.to_dict() for c in live_p] == \
            [c.to_dict() for c in live_r]
        assert [c.to_dict() for c in garbage_p] == \
            [c.to_dict() for c in garbage_r]
        assert pch.etag(p) == rch.etag(r)
        assert pch.total_size(p) == rch.total_size(r)


NAMED = {
    "single": ([("1,ab", 0, 100, 1, "e1")], [(10, 50)]),
    "full_overwrite": ([("1,a", 0, 100, 1, "a"), ("2,b", 0, 100, 2, "b")],
                       [(0, 100)]),
    "partial_overwrite_middle": ([("1,a", 0, 100, 1, "a"),
                                  ("2,b", 30, 40, 2, "b")], [(20, 60)]),
    "append": ([("1,a", 0, 100, 1, "a"), ("2,b", 100, 50, 2, "b")],
               [(0, 150), (90, 20)]),
    "sparse_hole": ([("1,a", 0, 10, 1, "a"), ("2,b", 100, 10, 2, "b")],
                    [(0, 110), (5, 100)]),
    "etag_one": ([("1,a", 0, 10, 0, "abcd")], [(0, 10)]),
    "etag_two": ([("1,a", 0, 10, 0, "abcd"), ("2,b", 10, 10, 0, "ef01")],
                 [(0, 20)]),
}


@pytest.mark.parametrize("name", sorted(NAMED))
def test_chunk_math_named_cases_equal(name):
    specs, reads = NAMED[name]
    p, r = _chunks(pch, specs), _chunks(rch, specs)
    assert _intervals(pch.non_overlapping_visible_intervals(p)) == \
        _intervals(rch.non_overlapping_visible_intervals(r))
    for off, ln in reads:
        assert _views(pch.read_plan(p, off, ln)) == \
            _views(rch.read_plan(r, off, ln))
    assert pch.etag(p) == rch.etag(r)
    assert [c.fid for c in pch.compact_chunks(p)[1]] == \
        [c.fid for c in rch.compact_chunks(r)[1]]


def _entry_pair(kind, path, rng):
    out = []
    for ch, ent in ((pch, pent), (rch, rent)):
        if kind == "dir":
            e = ent.new_directory(path, mode=0o755)
        else:
            e = ent.new_file(path, [ch.FileChunk("3,01ab", 0, 5, mtime=7,
                                                 etag="x"),
                                    ch.FileChunk("4,02cd", 5, 9, mtime=8,
                                                 is_chunk_manifest=True)],
                             mime="text/plain", collection="b1",
                             replication="001", ttl_sec=60)
            e.extended = {"x-amz-storage-class": "WARM"}
            e.hard_link_id = "hl1"
        e.attr.mtime = e.attr.crtime = 1700000000.5
        e.attr.uid, e.attr.group_names = 3, ["g"]
        out.append(e)
    return out


@pytest.mark.parametrize("kind", ["file", "dir"])
def test_entry_json_equal(kind):
    p, r = _entry_pair(kind, "/a/b/c", random.Random(1))
    assert p.to_json() == r.to_json()
    assert pent.Entry.from_json(r.to_json()).to_json() == r.to_json()
    assert rent.Entry.from_json(p.to_json()).to_json() == p.to_json()
    assert (p.name, p.parent, p.size(), p.is_directory) == \
        (r.name, r.parent, r.size(), r.is_directory)


def test_manifest_bytes_equal():
    rng = random.Random(7)
    specs = [(f"5,{i:06x}{rng.getrandbits(32):08x}", i * 100, 100, i, "")
             for i in range(2500)]
    p, r = _chunks(pch, specs), _chunks(rch, specs)
    assert pman.pack_manifest(p[:1000]) == rman.pack_manifest(r[:1000])
    assert [c.to_dict() for c in pman.unpack_manifest(
        rman.pack_manifest(r[:10]))] == [c.to_dict() for c in r[:10]]

    def fold(man, ch):
        blobs = []

        async def save(blob, at):
            blobs.append(blob)
            return ch.FileChunk(f"9,{len(blobs):08x}00000000", at,
                                len(blob), etag=f"m{len(blobs)}")

        out = asyncio.run(man.maybe_manifestize(
            _chunks(ch, specs), save, batch=100))

        async def fetch(c):
            return blobs[int(c.fid.split(",")[1][:8], 16) - 1]

        resolved = asyncio.run(man.resolve_manifests(out, fetch))
        return [c.to_dict() for c in out], blobs, \
            [c.to_dict() for c in resolved]

    out_p, blobs_p, res_p = fold(pman, pch)
    out_r, blobs_r, res_r = fold(rman, rch)
    assert blobs_p == blobs_r and out_p == out_r and res_p == res_r
    assert len(res_p) == 2500 and len(out_p) <= 100
    assert pman.MANIFEST_BATCH == rman.MANIFEST_BATCH == 1000


def _make_store(pkg, kind, tmp_path):
    stores = PKGS[pkg][4]
    kw = {} if kind == "memory" else {"path": str(tmp_path / f"{pkg}.{kind}")}
    return stores.create_store(kind, **kw)


def _listing(entries):
    return [json.loads(e.to_json()) for e in entries]


def _drive_store(pkg, kind, tmp_path, store=None):
    """The store contract: CRUD, ordered listing with prefixes (LIKE
    escapes), pagination, subtree purge, KV, on `store` (else a new one
    of `kind`); returns what it read."""
    _, ent, _, _, _ = PKGS[pkg]
    s = store if store is not None else _make_store(pkg, kind, tmp_path)
    seen = []
    names = ["b.txt", "a.txt", "my_file.txt", "myXfile.txt", "100%.txt",
             "z", "Zed", "été", "a b", "a_b"]
    for i, n in enumerate(names):
        e = ent.new_file(f"/d/{n}")
        e.attr.mtime = e.attr.crtime = float(i)
        s.insert_entry(e)
    sub = ent.new_directory("/d/sub")
    sub.attr.mtime = sub.attr.crtime = 99.0
    s.insert_entry(sub)
    deep = ent.new_file("/d/sub/deep/f")
    deep.attr.mtime = deep.attr.crtime = 5.0
    s.insert_entry(deep)
    seen.append(_listing(s.list_directory_entries("/d")))
    for prefix in ("my_", "100%", "a", "a_", "Z", "é"):
        seen.append([e.name for e in
                     s.list_directory_entries("/d", prefix=prefix)])
    page, start = [], ""
    while True:
        batch = s.list_directory_entries("/d", start, limit=3)
        if not batch:
            break
        page.append([e.name for e in batch])
        start = batch[-1].name
    seen.append(page)
    seen.append([e.name for e in s.list_directory_entries(
        "/d", "a.txt", include_start=True, limit=2)])
    seen.append(json.loads(s.find_entry("/d/a.txt").to_json()))
    assert s.find_entry("/d/nope") is None and s.find_entry("/") is None
    e = s.find_entry("/d/b.txt")
    e.attr.mime = "x/y"
    s.update_entry(e)
    seen.append(s.find_entry("/d/b.txt").attr.mime)
    s.delete_entry("/d/b.txt")
    seen.append(s.find_entry("/d/b.txt") is None)
    s.delete_folder_children("/d/sub")
    seen.append(s.find_entry("/d/sub/deep/f") is None)
    seen.append(s.find_entry("/d/sub") is not None)
    s.kv_put("k/1", b"\x00\xffv")
    seen.append((s.kv_get("k/1"), s.kv_get("k/none")))
    s.close()
    return seen


@pytest.mark.parametrize("kind", STORES)
def test_store_contract_equal(tmp_path, kind):
    assert _drive_store("port", kind, tmp_path) == \
        _drive_store("reference", kind, tmp_path)


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_unknown_store_raises_keyerror(pkg):
    stores = PKGS[pkg][4]
    for name in ("redis3", "mysql8", "sqlite "):
        with pytest.raises(KeyError):
            stores.create_store(name)


def _drive_filer(pkg, tmp_path):
    """The namespace core's answers to one script of operations; the
    event log's shape (kinds and directories, no times)."""
    ch, ent, fil, _, stores = PKGS[pkg]
    freed = []
    f = fil.Filer(stores.create_store("memory"),
                  on_delete_chunks=lambda cs: freed.extend(c.fid for c in cs),
                  entry_cache_ttl=0)
    seen = []

    def check(fn):
        try:
            fn()
            return "ok"
        except (OSError, ValueError) as e:
            return type(e).__name__

    f.create_entry(ent.new_file("/src/d/f1", [ch.FileChunk("1,a", 0, 5)]))
    f.create_entry(ent.new_file("/src/f2", [ch.FileChunk("2,b", 0, 3)]))
    seen.append(check(lambda: f.create_entry(ent.new_file("/src/f2"),
                                             o_excl=True)))
    seen.append(check(lambda: f.create_entry(ent.new_file("/src/d"))))
    seen.append(check(lambda: f.create_entry(ent.new_file("/src/f2/x"))))
    seen.append(check(lambda: f.delete_entry("/src")))
    f.rename("/src", "/dst")
    seen.append([e.full_path for e in f.list_directory("/dst")])
    seen.append(f.find_entry("/dst/d/f1").chunks[0].fid)
    # hard links: chunks go with the last link
    for p in ("/h/one", "/h/two"):
        e = ent.new_file(p, [ch.FileChunk("7,h", 0, 4)])
        e.hard_link_id = "L"
        f.create_entry(e)
    f.delete_entry("/h/one")
    seen.append(list(freed))
    f.delete_entry("/h/two")
    seen.append(list(freed))
    f.delete_entry("/dst", recursive=True)
    seen.append(sorted(freed))
    seen.append(check(lambda: f.delete_entry("/dst")))
    seen.append(f.freeable_replaced_chunks(None))
    seen.append([(e.directory, e.old_entry.full_path if e.old_entry else None,
                  e.new_entry.full_path if e.new_entry else None,
                  e.delete_chunks)
                 for e in f.meta_log.events_since(0)])
    seen.append(len(f.meta_log.events_since(0, "/h")))
    f.close()
    return seen


def test_filer_operations_equal(tmp_path):
    assert _drive_filer("port", tmp_path) == \
        _drive_filer("reference", tmp_path)


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_rename_rolls_back_on_failure(tmp_path, pkg):
    """A store failure mid-rename leaves the namespace unchanged, in
    both packages (the reference's test on each)."""
    _, ent, fil, _, stores = PKGS[pkg]
    s = stores.create_store("sqlite", path=str(tmp_path / "txn.db"))
    f = fil.Filer(s, entry_cache_ttl=0)
    f.create_entry(ent.new_file("/t/a/f1"))
    f.create_entry(ent.new_file("/t/a/f2"))
    real_insert = s.insert_entry
    calls = {"n": 0}

    def failing_insert(entry):
        calls["n"] += 1
        if calls["n"] >= 2 and entry.full_path.startswith("/t/b"):
            raise sqlite3.OperationalError("disk I/O error (injected)")
        real_insert(entry)

    s.insert_entry = failing_insert
    with pytest.raises(sqlite3.OperationalError):
        f.rename("/t/a", "/t/b")
    s.insert_entry = real_insert
    assert f.find_entry("/t/a/f1") is not None
    assert f.find_entry("/t/a/f2") is not None
    assert f.find_entry("/t/b") is None
    s.close()


def _write_tree(pkg, kind, path, store_kwargs=None):
    _, ent, fil, _, stores = PKGS[pkg]
    f = fil.Filer(stores.create_store(kind, **(store_kwargs
                                               or {"path": str(path)})),
                  meta_log_path=str(path) + ".events", entry_cache_ttl=0)
    rng = random.Random(3)
    ch = PKGS[pkg][0]
    for i in range(40):
        d = f"/b{i % 3}/k{i % 5}"
        e = ent.new_file(f"{d}/o{i:03d}",
                         [ch.FileChunk(f"{i},{rng.getrandbits(40):010x}",
                                       0, i + 1)])
        e.attr.mtime = e.attr.crtime = float(i)
        f.create_entry(e)
    f.rename("/b0/k0", "/b0/moved")
    f.delete_entry("/b1/k1", recursive=True)
    f.store.kv_put("offset/x", b"42")
    f.close()


def _read_tree(pkg, kind, path, store_kwargs=None):
    _, _, fil, _, stores = PKGS[pkg]
    f = fil.Filer(stores.create_store(kind, **(store_kwargs
                                               or {"path": str(path)})),
                  meta_log_path=str(path) + ".events", entry_cache_ttl=0)
    out = {}

    def walk(d):
        for e in f.list_directory(d, limit=1 << 20):
            out[e.full_path] = json.loads(e.to_json())
            if e.is_directory:
                out[e.full_path]["attr"]["mtime"] = 0
                out[e.full_path]["attr"]["crtime"] = 0
                walk(e.full_path)

    walk("/")
    events = [(e.directory,
               e.old_entry.full_path if e.old_entry else None,
               e.new_entry.full_path if e.new_entry else None)
              for e in f.meta_log.read_persisted_since(0)]
    kv = f.store.kv_get("offset/x")
    f.close()
    return out, events, kv


@pytest.mark.parametrize("kind", ["sqlite", "leveldb", "leveldb2",
                                  *NET_KINDS])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_state_carried_across(tmp_path, kind, writer):
    """A store and a persisted event log written by one package are
    opened and listed equally by the other (and by the writer); a
    network store's tree lives on the reader's package's fake."""
    path = tmp_path / f"state.{kind}"
    reader = "port" if writer == "reference" else "reference"
    fake, kw = start_fake(reader, kind) if kind in NET_KINDS \
        else (None, None)
    try:
        _write_tree(writer, kind, path, kw)
        theirs = _read_tree(reader, kind, path, kw)
        mine = _read_tree(writer, kind, path, kw)
    finally:
        if fake is not None:
            fake.close()
    assert theirs == mine
    tree, events, kv = theirs
    assert len([p for p, e in tree.items() if e["chunks"]]) == 37
    assert "/b0/moved/o000" in tree and "/b1/k1" not in tree
    assert kv == b"42" and len(events) > 40
