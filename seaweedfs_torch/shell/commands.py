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
(shell/volume_commands.py), and the balancer's
``cluster.balance.status`` and ``cluster.balance.run``
(shell/balance_commands.py); the other command modules of
the reference (fs, buckets, locks, geo, the ring, telemetry, traces and
the rest of the volume commands) are not ported. A command that moves
volumes (``destructive``) runs under the master's cluster-exclusive admin
lock (client.AdminLock), taken and released around it; the reference's
``lock``/``unlock`` commands, which hold it across commands, are not
ported.
"""

from __future__ import annotations

import argparse
import shlex
from typing import Callable

from ..client import Client, ClientError

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

    def __init__(self, client: Client, geometry=None):
        from ..ec.geometry import DEFAULT
        self.client = client
        self.geometry = geometry or DEFAULT


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
    from . import balance_commands, ec_shell, volume_commands  # noqa: F401
