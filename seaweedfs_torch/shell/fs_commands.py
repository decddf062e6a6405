"""fs.* commands: browse and change the filer namespace.

The port's copy of seaweedfs_tpu/shell/fs_commands.py (upstream
weed/shell/command_fs_ls.go, _du, _cat, _mv, _rm, _tree, _cd, _pwd,
_mkdir, command_fs_meta_save/load.go), over the filer's meta HTTP API at
``env.filer``; relative paths resolve against ``env.cwd``. The export of
``fs.meta.save`` is JSON lines of entry objects (upstream writes
protobuf; the information is the same), and ``fs.meta.load`` creates
them, keeping any existing entry's chunks. None of them moves a volume,
so none takes the master's admin lock (the reference marks ``fs.mv``,
``fs.rm`` and ``fs.meta.load`` as needing its shell lock when the shell
asks for one).
"""

from __future__ import annotations

import json
import stat as stat_mod

from ..client import ClientError, _request
from .commands import CommandEnv, command, parser


def _list_dir(env: CommandEnv, directory: str, limit: int = 1 << 30):
    start = ""
    yielded = 0
    while yielded < limit:
        out = env.filer_get("/__meta__/list",
                            {"dir": directory, "start": start,
                             "limit": 256})
        entries = out.get("entries", [])
        if not entries:
            return
        for e in entries:
            yield e
            yielded += 1
            if yielded >= limit:
                return
        start = entries[-1]["path"].rsplit("/", 1)[-1]
        if len(entries) < 256:
            return


def _is_dir(entry: dict) -> bool:
    return stat_mod.S_ISDIR(entry.get("attr", {}).get("mode", 0))


def _entry_size(entry: dict) -> int:
    return sum(c.get("size", 0) for c in entry.get("chunks", []))


def _require_filer(env: CommandEnv) -> None:
    if not env.filer:
        raise ClientError("fs.* commands need -filer <host:port>")


@command("fs.pwd", "print the shell working directory")
def fs_pwd(env: CommandEnv, argv: list[str]):
    return {"cwd": env.cwd}


@command("fs.cd", "change the shell working directory (fs.cd /dir)")
def fs_cd(env: CommandEnv, argv: list[str]):
    _require_filer(env)
    target = env.resolve(argv[0] if argv else "/")
    if target != "/":
        try:
            out = env.filer_get("/__meta__/lookup", {"path": target})
        except ClientError:
            raise ClientError(f"{target}: not found")
        if not _is_dir(out):
            raise ClientError(f"{target}: not a directory")
    env.cwd = target
    return {"cwd": env.cwd}


@command("fs.ls", "list a filer directory (fs.ls [-l] [path])")
def fs_ls(env: CommandEnv, argv: list[str]):
    _require_filer(env)
    p = parser("fs.ls")
    p.add_argument("-l", action="store_true", dest="long")
    p.add_argument("path", nargs="?", default=".")
    args = p.parse_args(argv)
    directory = env.resolve(args.path)
    rows = []
    for e in _list_dir(env, directory):
        name = e["path"].rsplit("/", 1)[-1]
        if args.long:
            rows.append({"name": name, "dir": _is_dir(e),
                         "size": _entry_size(e),
                         "mtime": e.get("attr", {}).get("mtime", 0),
                         "mode": oct(e.get("attr", {}).get("mode", 0))})
        else:
            rows.append(name + ("/" if _is_dir(e) else ""))
    return {"dir": directory, "entries": rows}


@command("fs.du", "disk usage of a filer tree (fs.du [path])")
def fs_du(env: CommandEnv, argv: list[str]):
    _require_filer(env)
    directory = env.resolve(argv[0] if argv else ".")

    def walk(d: str) -> tuple[int, int, int]:
        size = files = dirs = 0
        for e in _list_dir(env, d):
            if _is_dir(e):
                s, f, dd = walk(e["path"])
                size += s
                files += f
                dirs += dd + 1
            else:
                size += _entry_size(e)
                files += 1
        return size, files, dirs

    size, files, dirs = walk(directory)
    return {"dir": directory, "bytes": size, "files": files, "dirs": dirs}


@command("fs.cat", "print a filer file (fs.cat /path)")
def fs_cat(env: CommandEnv, argv: list[str]):
    _require_filer(env)
    if not argv:
        raise ClientError("fs.cat needs a path")
    path = env.resolve(argv[0])
    r = _request("GET", f"http://{env.filer}{path}", timeout=300)
    if r.status != 200:
        raise ClientError(f"{path}: HTTP {r.status}")
    return r.data


@command("fs.mv", "rename/move within the filer (fs.mv src dst)")
def fs_mv(env: CommandEnv, argv: list[str]):
    _require_filer(env)
    if len(argv) != 2:
        raise ClientError("fs.mv needs src and dst")
    src, dst = env.resolve(argv[0]), env.resolve(argv[1])
    env.filer_post("/__meta__/rename", {"from": src, "to": dst})
    return {"ok": True, "from": src, "to": dst}


@command("fs.rm", "delete a filer entry (fs.rm [-r] path)")
def fs_rm(env: CommandEnv, argv: list[str]):
    _require_filer(env)
    p = parser("fs.rm")
    p.add_argument("-r", action="store_true", dest="recursive")
    p.add_argument("path")
    args = p.parse_args(argv)
    path = env.resolve(args.path)
    env.filer_post("/__meta__/delete",
                   {"path": path, "recursive": args.recursive})
    return {"ok": True, "deleted": path}


@command("fs.mkdir", "create a filer directory (fs.mkdir /path)")
def fs_mkdir(env: CommandEnv, argv: list[str]):
    _require_filer(env)
    if not argv:
        raise ClientError("fs.mkdir needs a path")
    path = env.resolve(argv[0])
    env.filer_post("/__meta__/create_entry",
                   {"entry": {"path": path,
                              "attr": {"mode": stat_mod.S_IFDIR | 0o770}}})
    return {"ok": True, "dir": path}


@command("fs.tree", "print a filer subtree (fs.tree [path])")
def fs_tree(env: CommandEnv, argv: list[str]):
    _require_filer(env)
    root = env.resolve(argv[0] if argv else ".")

    def walk(d: str, depth: int, out: list) -> None:
        if depth > 32:
            return
        for e in _list_dir(env, d):
            name = e["path"].rsplit("/", 1)[-1]
            out.append("  " * depth + name + ("/" if _is_dir(e) else ""))
            if _is_dir(e):
                walk(e["path"], depth + 1, out)

    lines: list = [root]
    walk(root, 1, lines)
    return {"tree": lines}


@command("fs.meta.cat",
         "print one entry's full metadata (fs.meta.cat /path)")
def fs_meta_cat(env: CommandEnv, argv: list[str]):
    _require_filer(env)
    if not argv:
        raise ClientError("fs.meta.cat needs a path")
    return env.filer_get("/__meta__/lookup",
                         {"path": env.resolve(argv[0])})


@command("fs.meta.save",
         "export filer metadata to a local JSONL file "
         "(fs.meta.save [-o file] [path])")
def fs_meta_save(env: CommandEnv, argv: list[str]):
    _require_filer(env)
    p = parser("fs.meta.save")
    p.add_argument("-o", dest="output", default="filer_meta.jsonl")
    p.add_argument("path", nargs="?", default="/")
    args = p.parse_args(argv)
    root = env.resolve(args.path)
    count = 0
    with open(args.output, "w") as f:
        def walk(d: str) -> None:
            nonlocal count
            for e in _list_dir(env, d):
                f.write(json.dumps(e) + "\n")
                count += 1
                if _is_dir(e):
                    walk(e["path"])
        walk(root)
    return {"ok": True, "file": args.output, "entries": count}


@command("fs.meta.load",
         "import filer metadata from a JSONL export "
         "(fs.meta.load file)")
def fs_meta_load(env: CommandEnv, argv: list[str]):
    _require_filer(env)
    if not argv:
        raise ClientError("fs.meta.load needs a file")
    count = 0
    with open(argv[0]) as f:
        for line in f:
            env.filer_post("/__meta__/create_entry",
                           {"entry": json.loads(line),
                            "free_old_chunks": False})
            count += 1
    return {"ok": True, "entries": count}
