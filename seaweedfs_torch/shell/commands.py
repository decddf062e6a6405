"""Admin shell framework: the command registry and CommandEnv.

The port's reduced copy of seaweedfs_tpu/shell/commands.py (upstream
weed/shell/commands.go:28-72): every command is a named callable over a
shared CommandEnv holding the master client and the EC geometry pin.
``weed shell <name> [args...]`` and the REPL both dispatch through
COMMANDS. The port registers the EC lifecycle (``ec.encode``,
``ec.warmdown``, ``ec.rebuild``, ``ec.balance``, ``ec.decode``,
shell/ec_shell.py), ``volume.list``, the hot tier's
``volume.fix.replication``, ``volume.copy``, ``volume.delete``,
``volume.configure.replication`` and ``volume.mark``, and the lifecycle
plane's ``volume.heat``, ``lifecycle.status`` and ``lifecycle.run``
(shell/volume_commands.py), the balancer's ``cluster.balance.status``
and ``cluster.balance.run`` (shell/balance_commands.py), and the filer
namespace's ``fs.*`` commands (shell/fs_commands.py), which talk to the
filer that ``CommandEnv(filer=)`` names (shell ``-filer``) and resolve
relative paths against ``env.cwd``, the filer ring's
``filer.ring.status``, ``filer.ring.join`` and ``filer.ring.leave``
(shell/ring_commands.py), and ``bucket.list``, ``bucket.create``,
``bucket.delete``, ``collection.list`` and ``collection.delete``
(shell/bucket_commands.py), and the geo plane's ``geo.status`` and
``geo.sync`` (shell/geo_commands.py); the other command modules of the
reference (locks, telemetry, traces and the rest of the volume commands)
are not ported. A command that moves
volumes (``destructive``) runs under the master's cluster-exclusive admin
lock (client.AdminLock), taken and released around it; the reference's
``lock``/``unlock`` commands, which hold it across commands, are not
ported.
"""

from __future__ import annotations

import argparse
import shlex
import urllib.parse
from typing import Callable

from ..client import Client, ClientError, _get_json, _post_json

COMMANDS: dict[str, "ShellCommand"] = {}


class ShellCommand:
    def __init__(self, name: str, help_text: str, fn: Callable,
                 destructive: bool = False):
        self.name = name
        self.help = help_text
        self.fn = fn
        self.destructive = destructive

    def __call__(self, env: "CommandEnv", argv: list[str]):
        if not self.destructive:
            return self.fn(env, argv)
        with env.client.admin_lock:
            return self.fn(env, argv)


def command(name: str, help_text: str, destructive: bool = False):
    def deco(fn):
        COMMANDS[name] = ShellCommand(name, help_text, fn, destructive)
        return fn
    return deco


class CommandEnv:
    """Shared state across shell commands (weed/shell/commands.go:28-33)."""

    def __init__(self, client: Client, geometry=None, filer: str = ""):
        from ..ec.geometry import DEFAULT
        self.client = client
        self.geometry = geometry or DEFAULT
        self.filer = filer.rstrip("/")
        self.cwd = "/"

    # --- the filer's meta API, for the fs.* commands ---
    def filer_get(self, path: str, params: dict) -> dict:
        """GET a filer meta route; an error status raises ClientError."""
        qs = urllib.parse.urlencode(params)
        out = _get_json(f"http://{self.filer}{path}?{qs}", timeout=60)
        if "error" in out:
            raise ClientError(f"GET {path}: {out['error']}")
        return out

    def filer_post(self, path: str, body: dict) -> dict:
        return _post_json(f"http://{self.filer}{path}", body)

    def resolve(self, path: str) -> str:
        """A possibly relative filer path against the shell's cwd, with
        "." and ".." folded."""
        if not path or path == ".":
            return self.cwd
        if not path.startswith("/"):
            path = f"{self.cwd.rstrip('/')}/{path}"
        parts: list[str] = []
        for seg in path.split("/"):
            if seg in ("", "."):
                continue
            if seg == "..":
                if parts:
                    parts.pop()
                continue
            parts.append(seg)
        return "/" + "/".join(parts)


def parser(prog: str) -> argparse.ArgumentParser:
    return argparse.ArgumentParser(prog=prog, add_help=False)


def run_command(env: CommandEnv, line_or_argv) -> object:
    """Dispatch one command line (string or argv list)."""
    argv = (shlex.split(line_or_argv) if isinstance(line_or_argv, str)
            else list(line_or_argv))
    if not argv:
        return None
    name, rest = argv[0], argv[1:]
    if name in ("help", "?"):
        return {n: c.help for n, c in sorted(COMMANDS.items())}
    cmd = COMMANDS.get(name)
    if cmd is None:
        raise ClientError(f"unknown command {name!r}; try 'help'")
    return cmd(env, rest)


@command("volume.list", "print the cluster topology (volume.list)")
def volume_list(env: CommandEnv, argv: list[str]):
    return env.client.dir_status()


def _register_all() -> None:
    """Import every command module for its registration side effects
    (upstream does the same through init() imports, commands.go:42)."""
    from . import (balance_commands, bucket_commands,  # noqa: F401
                   ec_shell, fs_commands, geo_commands, ring_commands,
                   volume_commands)
