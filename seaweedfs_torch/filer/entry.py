"""Filer entries: files and directories in the namespace.

The port's copy of seaweedfs_tpu/filer/entry.py, whole, with its JSON
form. Model parity with the reference Entry (weed/filer/entry.go,
weed/pb/filer.proto Entry/FuseAttributes): a full path, POSIX-ish
attributes, and the chunk list for files. Serialized as JSON for store
values (the reference uses protobuf; the store interface hides this).
"""

from __future__ import annotations

import json
import stat as stat_mod
import time
from dataclasses import dataclass, field
from typing import Optional

from .chunks import FileChunk, total_size


@dataclass
class Attr:
    mtime: float = 0.0
    crtime: float = 0.0
    mode: int = 0o660
    uid: int = 0
    gid: int = 0
    mime: str = ""
    ttl_sec: int = 0
    user_name: str = ""
    group_names: list[str] = field(default_factory=list)
    symlink_target: str = ""
    md5: str = ""
    replication: str = ""
    collection: str = ""

    @property
    def is_directory(self) -> bool:
        return stat_mod.S_ISDIR(self.mode)


@dataclass
class Entry:
    full_path: str
    attr: Attr = field(default_factory=Attr)
    chunks: list[FileChunk] = field(default_factory=list)
    extended: dict[str, str] = field(default_factory=dict)
    hard_link_id: str = ""

    @property
    def is_directory(self) -> bool:
        return self.attr.is_directory

    @property
    def name(self) -> str:
        return self.full_path.rstrip("/").rsplit("/", 1)[-1]

    @property
    def parent(self) -> str:
        p = self.full_path.rstrip("/").rsplit("/", 1)[0]
        return p or "/"

    def size(self) -> int:
        return total_size(self.chunks)

    def to_json(self) -> str:
        return json.dumps({
            "path": self.full_path,
            "attr": {
                "mtime": self.attr.mtime, "crtime": self.attr.crtime,
                "mode": self.attr.mode, "uid": self.attr.uid,
                "gid": self.attr.gid, "mime": self.attr.mime,
                "ttl_sec": self.attr.ttl_sec,
                "user_name": self.attr.user_name,
                "group_names": self.attr.group_names,
                "symlink_target": self.attr.symlink_target,
                "md5": self.attr.md5,
                "replication": self.attr.replication,
                "collection": self.attr.collection,
            },
            "chunks": [c.to_dict() for c in self.chunks],
            "extended": self.extended,
            "hard_link_id": self.hard_link_id,
        })

    @classmethod
    def from_json(cls, s: str) -> "Entry":
        d = json.loads(s)
        a = d.get("attr", {})
        return cls(
            full_path=d["path"],
            attr=Attr(
                mtime=a.get("mtime", 0.0), crtime=a.get("crtime", 0.0),
                mode=a.get("mode", 0o660), uid=a.get("uid", 0),
                gid=a.get("gid", 0), mime=a.get("mime", ""),
                ttl_sec=a.get("ttl_sec", 0),
                user_name=a.get("user_name", ""),
                group_names=a.get("group_names", []),
                symlink_target=a.get("symlink_target", ""),
                md5=a.get("md5", ""),
                replication=a.get("replication", ""),
                collection=a.get("collection", ""),
            ),
            chunks=[FileChunk.from_dict(c) for c in d.get("chunks", [])],
            extended=d.get("extended", {}),
            hard_link_id=d.get("hard_link_id", ""),
        )


def new_directory(path: str, mode: int = 0o770) -> Entry:
    now = time.time()
    return Entry(full_path=path,
                 attr=Attr(mtime=now, crtime=now,
                           mode=stat_mod.S_IFDIR | mode))


def new_file(path: str, chunks: Optional[list[FileChunk]] = None,
             mime: str = "", mode: int = 0o660,
             collection: str = "", replication: str = "",
             ttl_sec: int = 0) -> Entry:
    now = time.time()
    return Entry(full_path=path,
                 attr=Attr(mtime=now, crtime=now,
                           mode=stat_mod.S_IFREG | mode, mime=mime,
                           collection=collection, replication=replication,
                           ttl_sec=ttl_sec),
                 chunks=chunks or [])
