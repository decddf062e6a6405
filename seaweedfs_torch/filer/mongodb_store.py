"""The mongodb filer store: one collection of documents.

The port's copy of seaweedfs_tpu/filer/mongodb_store.py (upstream
weed/filer/mongodb/mongodb_store.go:27-200): a ``filemeta`` collection
of {directory, name, meta} documents, unique by (directory, name); a
lookup is a point query, a listing is {directory: d, name: {$gt|$gte:
start}} sorted by name with a limit, and inserts are upserts. It speaks
mongo's wire protocol, OP_MSG (opcode 2013) frames of the BSON subset in
bson_lite.py, over one socket, so it works against a mongod; the tests
and the smoke run it against fake_mongo.py.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Optional

from . import bson_lite as bson
from .entry import Entry
from .netutil import read_exact
from .stores import FilerStore, _split

OP_MSG = 2013
_KV_DIR = "\x01kv"  # the KV face's rows, under a reserved directory


class _MongoClient:
    """An OP_MSG client: one socket, one command at a time, section 0
    only."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._req_id = 0
        self._lock = threading.Lock()

    def command(self, doc: dict) -> dict:
        # flagBits (0), then one kind-0 section: the command's BSON
        body = struct.pack("<I", 0) + b"\x00" + bson.encode_doc(doc)
        with self._lock:
            self._req_id += 1
            header = struct.pack("<iiii", 16 + len(body), self._req_id,
                                 0, OP_MSG)
            self.sock.sendall(header + body)
            reply = self._read_msg()
        if reply.get("ok") != 1:
            raise RuntimeError(f"mongodb error: {reply}")
        # a mongod reports a document's failed write with ok: 1
        if reply.get("writeErrors"):
            raise RuntimeError(f"mongodb write error: "
                               f"{reply['writeErrors']}")
        return reply

    def _read_msg(self) -> dict:
        header = read_exact(self.sock.recv, 16)
        length, _req, _resp, opcode = struct.unpack("<iiii", header)
        payload = read_exact(self.sock.recv, length - 16)
        if opcode != OP_MSG:
            raise ConnectionError(f"unexpected opcode {opcode}")
        if payload[4] != 0:
            raise ConnectionError("only kind-0 sections supported")
        doc, _ = bson.decode_doc(payload, 5)
        return doc

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class MongodbStore(FilerStore):
    name = "mongodb"

    def __init__(self, host: str = "127.0.0.1", port: int = 27017,
                 database: str = "seaweedfs", **_):
        self._c = _MongoClient(host, port)
        self._db = database
        self._c.command({"ping": 1, "$db": database})

    def _cmd(self, doc: dict) -> dict:
        doc["$db"] = self._db
        return self._c.command(doc)

    def _upsert(self, d: str, name: str, meta: bytes) -> None:
        self._cmd({"update": "filemeta", "updates": [{
            "q": {"directory": d, "name": name},
            "u": {"directory": d, "name": name, "meta": meta},
            "upsert": True}]})

    def _find_meta(self, d: str, name: str) -> Optional[bytes]:
        reply = self._cmd({"find": "filemeta",
                           "filter": {"directory": d, "name": name},
                           "limit": 1, "singleBatch": True})
        batch = reply["cursor"]["firstBatch"]
        return batch[0].get("meta") if batch else None

    def insert_entry(self, entry: Entry) -> None:
        self.update_entry(entry)  # upstream's InsertEntry delegates too

    def update_entry(self, entry: Entry) -> None:
        d, name = _split(entry.full_path)
        self._upsert(d, name, entry.to_json().encode())

    def find_entry(self, path: str) -> Optional[Entry]:
        meta = self._find_meta(*_split(path))
        return Entry.from_json(meta.decode()) if meta else None

    def delete_entry(self, path: str) -> None:
        d, name = _split(path)
        self._cmd({"delete": "filemeta", "deletes": [
            {"q": {"directory": d, "name": name}, "limit": 1}]})

    def delete_folder_children(self, path: str) -> None:
        # the children, then the deeper tree by a range of directories
        self._cmd({"delete": "filemeta", "deletes": [
            {"q": {"directory": path}, "limit": 0}]})
        deep = path.rstrip("/") + "/"
        self._cmd({"delete": "filemeta", "deletes": [
            {"q": {"directory": {"$gte": deep, "$lt": deep[:-1] + "0"}},
             "limit": 0}]})

    def list_directory_entries(self, dir_path: str, start_file_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        flt: dict = {"directory": dir_path}
        name_cond: dict = {}
        if start_file_name:
            name_cond["$gte" if include_start else "$gt"] = start_file_name
        if prefix:
            name_cond.setdefault("$gte", prefix)
            if name_cond["$gte"] < prefix:
                name_cond["$gte"] = prefix
        if name_cond:
            flt["name"] = name_cond
        want = limit + (64 if prefix else 0)
        # singleBatch and batchSize: a mongod caps a first batch at 101
        # documents otherwise, and leaves a cursor to getMore
        reply = self._cmd({"find": "filemeta", "filter": flt,
                           "sort": {"name": 1}, "limit": want,
                           "batchSize": want, "singleBatch": True})
        out: list[Entry] = []
        for doc in reply["cursor"]["firstBatch"]:
            name = doc["name"]
            if prefix and not name.startswith(prefix):
                if name > prefix:
                    break  # sorted: past the prefix
                continue
            if not doc.get("meta"):
                continue
            out.append(Entry.from_json(doc["meta"].decode()))
            if len(out) >= limit:
                break
        return out

    def kv_put(self, key: str, value: bytes) -> None:
        self._upsert(_KV_DIR, key, value)

    def kv_get(self, key: str) -> Optional[bytes]:
        return self._find_meta(_KV_DIR, key)

    def close(self) -> None:
        self._c.close()
