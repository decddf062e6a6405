"""Registry adapters exposing the EC lifecycle workflows as shell commands
(ec.encode / ec.warmdown / ec.rebuild / ec.balance / ec.decode,
weed/shell/command_ec_*).

The port's copy of seaweedfs_tpu/shell/ec_shell.py without
``ec.mesh.status``."""

from __future__ import annotations

from .commands import CommandEnv, command, parser
from .ec_commands import EcCommands


def _ec(env: CommandEnv) -> EcCommands:
    return EcCommands(env.client, env.geometry)


@command("ec.encode",
         "erasure-code volumes (ec.encode -volumeId N[,N2,...] "
         "[-collection c] [-parallel N] [-dryRun]) — a comma list "
         "encodes the whole window back-to-back through one governed "
         "executable; -parallel drives up to N source servers at once",
         destructive=True)
def ec_encode(env: CommandEnv, argv: list[str]):
    p = parser("ec.encode")
    p.add_argument("-volumeId", required=True)
    p.add_argument("-collection", default="")
    p.add_argument("-parallel", type=int, default=1)
    p.add_argument("-dryRun", action="store_true")
    args = p.parse_args(argv)
    vids = [int(v) for v in str(args.volumeId).split(",") if v]
    ec = _ec(env)
    if len(vids) == 1:
        return ec.encode(vids[0], args.collection, apply=not args.dryRun)
    return ec.encode_many(vids, args.collection, apply=not args.dryRun,
                          parallel=args.parallel)


@command("ec.warmdown",
         "one-pass warm-down (ec.warmdown -volumeId N[,N2,...] "
         "[-collection c] [-parallel N] [-dryRun]) — compaction + gzip "
         "+ RS encode + shard digests fused into a single governed "
         "pass on each source (ec/fused); otherwise the same "
         "spread/mount/retire flow as ec.encode",
         destructive=True)
def ec_warmdown(env: CommandEnv, argv: list[str]):
    p = parser("ec.warmdown")
    p.add_argument("-volumeId", required=True)
    p.add_argument("-collection", default="")
    p.add_argument("-parallel", type=int, default=1)
    p.add_argument("-dryRun", action="store_true")
    args = p.parse_args(argv)
    vids = [int(v) for v in str(args.volumeId).split(",") if v]
    ec = _ec(env)
    if len(vids) == 1:
        return ec.encode(vids[0], args.collection, apply=not args.dryRun,
                         fused=True)
    return ec.encode_many(vids, args.collection, apply=not args.dryRun,
                          parallel=args.parallel, fused=True)


@command("ec.rebuild",
         "rebuild missing EC shards (ec.rebuild -volumeId N "
         "[-collection c] [-dryRun])",
         destructive=True)
def ec_rebuild(env: CommandEnv, argv: list[str]):
    p = parser("ec.rebuild")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    p.add_argument("-dryRun", action="store_true")
    args = p.parse_args(argv)
    return _ec(env).rebuild(args.volumeId, args.collection,
                            apply=not args.dryRun)


@command("ec.balance",
         "spread EC shards evenly (ec.balance [-collection c] [-dryRun])",
         destructive=True)
def ec_balance(env: CommandEnv, argv: list[str]):
    p = parser("ec.balance")
    p.add_argument("-collection", default="")
    p.add_argument("-dryRun", action="store_true")
    args = p.parse_args(argv)
    return _ec(env).balance(args.collection, apply=not args.dryRun)


@command("ec.decode",
         "decode an EC volume back to a normal volume "
         "(ec.decode -volumeId N [-collection c] [-dryRun])",
         destructive=True)
def ec_decode(env: CommandEnv, argv: list[str]):
    p = parser("ec.decode")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    p.add_argument("-dryRun", action="store_true")
    args = p.parse_args(argv)
    return _ec(env).decode(args.volumeId, args.collection,
                           apply=not args.dryRun)
