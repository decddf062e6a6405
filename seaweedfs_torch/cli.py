"""Command-line interface: the `weed`-equivalent entry point of the port.

The port's reduced copy of seaweedfs_tpu/cli.py (upstream
weed/command/command.go:10-33), with the reference's flags where they
apply:

  python3 -m seaweedfs_torch.cli master -port 9333 -volumeSizeLimitMB 1024 \\
      [-defaultReplication 001] [-garbageThreshold 0.3] \\
      [-maintenance_interval S] [-repair_concurrency N] \\
      [-peers h1:9333,h2:9333,h3:9333 -mdir /state] [-sequencer_kv h:6379]
  python3 -m seaweedfs_torch.cli volume -port 8080 -dir /data \\
      -mserver h1:9333[,h2:9333,...] [-rack r1] [-coder auto|torch|numpy] \\
      [-device cuda:0] [-index memory|compact|leveldb|leveldbMedium|\\
      leveldbLarge] [-minFreeSpacePercent 1] [-preallocate MB]
  python3 -m seaweedfs_torch.cli shell -master h1:9333[,h2:9333,...] \\
      ec.encode -volumeId 3 [-collection c]
  python3 -m seaweedfs_torch.cli shell -server localhost:9333 \\
      volume.fix.replication -force
  python3 -m seaweedfs_torch.cli filer -port 8888 -mserver h1:9333 \\
      [-store sqlite|memory|leveldb|leveldb2|mysql|postgres|redis|redis2|\\
      etcd|mongodb|elastic|cassandra] [-store_path ./filer.db] \\
      [-store_servers host:port] \\
      [-chunk_size_mb 8] [-default_replication 000] [-collection c] \\
      [-meta_log events.jsonl] [-ring_peers h:8888,h:8889,h:8890] \\
      [-peers h:8889]     (reads ./notification.toml when present)
  python3 -m seaweedfs_torch.cli watch -filer h:8888 [-pathPrefix /p]
  python3 -m seaweedfs_torch.cli filer.replicate -filer h:8888 \\
      [-pathPrefix /p] [-offsetFile F] [-from_queue]
                          (reads ./replication.toml)
  python3 -m seaweedfs_torch.cli filer.sync -a h:8888 -b h:8889
  python3 -m seaweedfs_torch.cli shell -master h1:9333 -filer h:8888 \\
      fs.ls -l /buckets
  python3 -m seaweedfs_torch.cli s3 -port 8333 -filer h:8888 \\
      [-config s3.json | -access_key K -secret_key S]
  python3 -m seaweedfs_torch.cli webdav -port 7333 -filer h:8888
  python3 -m seaweedfs_torch.cli msg.broker -port 17777 -filer h:8888
  python3 -m seaweedfs_torch.cli mount -filer h:8888 -dir /mnt/weed \\
      [-collection c] [-replication 000] [-chunk_size_mb 8]
  python3 -m seaweedfs_torch.cli compact -dir /data -volumeId 3
  python3 -m seaweedfs_torch.cli backup -server localhost:9333 \\
      -dir /backup -volumeId 3 [-collection c]
  python3 -m seaweedfs_torch.cli fix -dir /backup -volumeId 3
  python3 -m seaweedfs_torch.cli version

``-coder`` defaults to ``auto``, the CUDA kernel coder, which raises on a
host without a card at the volume server's first EC step (there is no
CPU fallback); ``-coder numpy``, or ``-coder torch -device cpu`` (the
kernels' plain versions), run EC on the host. Servers run on an asyncio
loop until SIGTERM or SIGINT, then stop their background tasks and
close their stores. A filer (``filer``) keeps its namespace in ``-store`` (``sqlite`` at
``-store_path`` by default; ``leveldb`` and ``leveldb2`` keep a
directory there; ``memory`` keeps nothing; ``redis``, ``redis2``,
``mongodb`` and ``cassandra`` take a ``host:port`` in
``-store_servers``, ``etcd`` and ``elastic`` an address or URL there;
the other stores refuse it) and cuts uploads into ``-chunk_size_mb`` chunks. The shell's ``fs.*`` commands
need ``-filer``. ``-ring_peers`` makes the filer a member of the filer
ring of those filers (every member's ``ip:port``, its own included; the
vnodes and replicas come from ``WEED_FILER_RING_VNODES`` /
``_REPLICAS``, 64 and 2); the shell's ``filer.ring.join -peer`` and
``filer.ring.leave -peer`` change the master's membership, which the
members follow. ``s3`` runs the S3 gateway in front of ``-filer``:
buckets are the filer's ``/buckets/<name>`` directories; requests are
SigV4 (header, presigned or streaming chunked) or V2 signed against the
identities of ``-config`` (upstream's ``s3.json``: ``{"identities":
[{"name", "credentials": [{"accessKey", "secretKey"}], "actions":
["Admin" | "Read" | "Write" | "List" | "Tagging", optionally
":bucket"]}]}``), or against the one Admin pair of ``-access_key`` and
``-secret_key`` (given together or not at all); with neither the
gateway is anonymous. The shell's ``bucket.*`` commands need ``-filer``
too. ``webdav`` runs the WebDAV gateway in front of ``-filer`` (no
auth: trusted networks only). ``mount`` mounts the filer's namespace at
``-dir`` through the kernel (fusepy if it imports, else the libfuse2
ctypes binding; it needs /dev/fuse, libfuse.so.2 and fusermount) and
serves it until unmounted (``fusermount -u -z DIR``); new files go to
``-collection`` with ``-replication``, cut into ``-chunk_size_mb``
chunks. ``compact`` vacuums one volume offline (the volume
server must not have it mounted). ``backup`` pulls what a volume gained
since the local copy's last record from its holder's ``/admin/tail``
into a replica in ``-dir`` (creating it on the first run); ``fix``
rebuilds a volume's .idx from its .dat.

A master, a volume server and a filer also serve their gRPC service
(pb/, server/*_grpc.py) on ``-grpc_port``, by default their HTTP port +
10000 (upstream's convention: peers reach each other's gRPC at the HTTP
port + 10000), 0 for none; ``volume -grpc_heartbeat`` beats over the
master's gRPC Heartbeat stream. ``msg.broker`` runs a pub/sub message
broker (messaging/), its gRPC service on its port + 10000; with
``-filer`` its topic segments persist under the filer's ``/topics/``
and it registers over the filer's gRPC KeepConnected, so brokers of one
filer share the partitions by rendezvous hash.

Masters of an HA group (upstream's ``weed master -peers``, at most 5)
each take every master's ``ip:port`` in ``-peers`` (their own included)
and a directory of their own in ``-mdir`` for the raft state (created if
missing); a master without ``-peers`` is alone and needs no ``-mdir``.
``-sequencer_kv host:port`` makes a master lease its file keys from a
redis-protocol KV's counter (``KvSequencer``, upstream's etcd
sequencer) instead of minting them through its metadata log.
Volume servers (``-mserver``) and the shell (``-master``, or ``-server``)
take the group's comma list and follow its leader.

A volume server's ``-index`` is the needle map kind of its volumes
(``memory``; ``compact``, 16 bytes an entry; the ``leveldb`` kinds, a
disk-resident map with a bounded delta of 100k / 400k / 1M entries).
Below ``-minFreeSpacePercent`` free on a data disk (default 1) its
volumes seal read-only until space is back; ``-preallocate`` reserves
that many MB for each new volume.

The master runs the repair daemon (every ``-maintenance_interval``
seconds, default the pulse, 0 off; at most ``-repair_concurrency``
repairs at once, default ``WEED_EC_ENCODE_WORKERS`` or 2) and, when a
``WEED_LIFECYCLE_*`` rule is set (``WARM_AFTER``, ``HOT_READ_RATE``,
``COLLECTION_TTL``; ``INTERVAL``, ``FULL_FRACTION``, ``TTL_GRACE``), the
lifecycle daemon. A volume server scrubs its EC shards every
``WEED_EC_SCRUB_INTERVAL`` seconds (3600; 0 off) and samples access heat
with half-life ``WEED_LIFECYCLE_HEAT_HALFLIFE``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import signal
import sys


def _serve_until_signalled(start) -> None:
    """Run `start()` (a coroutine returning the server and its runner)
    on a fresh loop, then serve until SIGTERM/SIGINT and clean up."""

    async def main() -> None:
        _, runner = await start()
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        try:
            await stop.wait()
        finally:
            await runner.cleanup()

    asyncio.run(main())


def _grpc_port(args) -> int:
    """-grpc_port: -1 (the default) is the HTTP port + 10000
    (weed/pb/grpc_client_server.go), 0 serves no gRPC."""
    return args.port + 10000 if args.grpc_port < 0 else args.grpc_port


def cmd_master(args) -> None:
    import os

    from .server.master import run_master
    peers = [p.strip() for p in args.peers.split(",") if p.strip()]
    if args.mdir:
        os.makedirs(args.mdir, exist_ok=True)
    sequencer = None
    if args.sequencer_kv:
        from .topology.sequence import KvSequencer
        host, _, port = args.sequencer_kv.rpartition(":")
        if not host or not port.isdigit():
            raise SystemExit(f"-sequencer_kv must be host:port, got "
                             f"{args.sequencer_kv!r}")
        sequencer = KvSequencer(host, int(port))
    _serve_until_signalled(lambda: run_master(
        args.ip, args.port,
        peers=peers or None,
        raft_state_dir=args.mdir or None,
        sequencer=sequencer,
        volume_size_limit_mb=args.volume_size_limit_mb,
        default_replication=args.default_replication,
        garbage_threshold=args.garbage_threshold,
        pulse_seconds=args.pulse,
        maintenance_interval_seconds=(
            None if args.maintenance_interval < 0
            else args.maintenance_interval),
        repair_concurrency=args.repair_concurrency,
        grpc_port=_grpc_port(args)))


def cmd_volume(args) -> None:
    from .ec.geometry import Geometry
    from .server.volume_server import run_volume_server
    from .storage.store import Store
    dirs = args.dir.split(",")
    store = Store(dirs, max_volume_counts=[args.max] * len(dirs),
                  coder_name=args.coder,
                  geometry=Geometry(large_block_size=args.ec_large_block,
                                    small_block_size=args.ec_small_block),
                  needle_map_kind=args.index,
                  min_free_space_percent=args.min_free_space_percent,
                  preallocate=args.preallocate * 1024 * 1024,
                  device=args.device or None)
    try:
        _serve_until_signalled(lambda: run_volume_server(
            args.ip, args.port, store, args.mserver,
            data_center=args.data_center, rack=args.rack,
            pulse_seconds=args.pulse, grpc_port=_grpc_port(args),
            use_grpc_heartbeat=args.grpc_heartbeat))
    finally:
        # the runner's cleanup closes it; this covers a failed start
        store.close()


def cmd_filer(args) -> None:
    from .notification.queues import load_notifier
    from .server.filer_server import run_filer
    from .utils.config import load_configuration
    store_kwargs = {}
    if args.store in ("sqlite", "leveldb", "leveldb2"):
        store_kwargs["path"] = args.store_path
    if args.store_servers:
        from .filer.stores import network_store_kwargs
        try:
            store_kwargs.update(network_store_kwargs(args.store,
                                                     args.store_servers))
        except ValueError as e:
            raise SystemExit(f"-store_servers: {e}")
    notifier = load_notifier(load_configuration("notification"))
    ring_config = None
    if args.ring_peers:
        from .metaring import RingConfig
        base = RingConfig.from_env()
        ring_config = RingConfig(
            peers=[p for p in args.ring_peers.split(",") if p],
            vnodes=base.vnodes, replicas=base.replicas)
    _serve_until_signalled(lambda: run_filer(
        args.ip, args.port, args.mserver, store_name=args.store,
        store_kwargs=store_kwargs,
        chunk_size=args.chunk_size_mb * 1024 * 1024,
        default_replication=args.default_replication,
        default_collection=args.collection,
        meta_log_path=args.meta_log, ring_config=ring_config,
        peers=[p for p in args.peers.split(",") if p], notifier=notifier,
        grpc_port=_grpc_port(args)))


def cmd_watch(args) -> None:
    """Live-tail filer metadata events (weed watch,
    weed/command/watch.go:36)."""
    from .replication.replicator import Replicator
    r = Replicator(args.filer, None, args.path_prefix)
    for e in r.subscribe_events(since=args.since):
        if e.directory.startswith(args.path_prefix):
            print(json.dumps(e.to_dict()), flush=True)


def _offset_path(stem: str, *parts: str) -> str:
    """Default resume-offset file: a stable per-user directory (not the
    working directory, so restarts from elsewhere still resume), a
    readable first part and a hash of the full job identity (source,
    sink, prefix), so distinct jobs never share an offset
    (filer_sync.go setOffset/getOffset key by signature)."""
    import hashlib
    base = os.path.join(os.path.expanduser("~"), ".seaweedfs_torch",
                        "offsets")
    os.makedirs(base, exist_ok=True)
    job_key = hashlib.sha256("|".join(parts).encode()).hexdigest()[:12]
    human = parts[0].replace(":", "_").replace("/", "_") if parts else ""
    return os.path.join(base, f"{stem}.{human}.{job_key}")


def cmd_filer_replicate(args) -> None:
    """Continuously replicate one filer into a sink configured by
    replication.toml (weed filer.replicate). With -from_queue the events
    come from the configured [source.*] queue (the file spool) instead of
    a live subscribe stream: upstream's Kafka/SQS-fed mode
    (weed/replication/sub)."""
    import time as _time

    from .replication.replicator import Replicator, run_from_queue
    from .replication.sink import load_sink
    from .utils.config import load_configuration
    cfg = load_configuration("replication")
    sink = load_sink(cfg)
    if sink is None:
        raise SystemExit("no enabled [sink.*] in replication.toml")
    offset = args.offset_file or _offset_path(
        "replicate_offset", args.filer, sink.identity(), args.path_prefix)
    r = Replicator(args.filer, sink, args.path_prefix, offset_path=offset)
    if args.from_queue:
        from .replication.sub import load_notification_input
        inp = load_notification_input(cfg)
        if inp is None:
            raise SystemExit("-from_queue needs an enabled [source.*] in "
                             "replication.toml")
        while True:
            run_from_queue(r, inp, idle_timeout=2.0)
            _time.sleep(1.0)
    else:
        r.run()


def cmd_filer_sync(args) -> None:
    """Active-active sync of two filers with signature loop prevention
    (weed filer.sync, weed/command/filer_sync.go:81-330)."""
    import threading

    from .client import _get_json
    from .replication.replicator import Replicator
    from .replication.sink import FilerSink

    def signature_of(filer: str) -> int:
        return int(_get_json(f"http://{filer}/__meta__/info",
                             timeout=10)["signature"])

    sig_a, sig_b = signature_of(args.a), signature_of(args.b)

    def one_direction(src: str, dst: str, dst_sig: int) -> None:
        # exclude the events the destination already processed (the loop
        # break); per-direction offsets, keyed by src, dst and prefix, so
        # restarts resume instead of replaying everything
        if args.offset_file:
            suffix = f"{src}_{dst}".replace(":", "_").replace("/", "_")
            offset = f"{args.offset_file}.{suffix}"
        else:
            offset = _offset_path("sync_offset", src, dst, args.path_prefix)
        Replicator(src, FilerSink(dst), args.path_prefix,
                   offset_path=offset).run(exclude_sig=dst_sig)

    ta = threading.Thread(target=one_direction,
                          args=(args.a, args.b, sig_b), daemon=True)
    ta.start()
    one_direction(args.b, args.a, sig_a)


def cmd_msg_broker(args) -> None:
    from .messaging.broker import run_broker
    _serve_until_signalled(lambda: run_broker(args.ip, args.port,
                                              filer_url=args.filer))


def cmd_s3(args) -> None:
    from .s3.s3_server import run_s3
    if bool(args.access_key) != bool(args.secret_key):
        raise SystemExit(
            "-access_key and -secret_key must be provided together "
            "(omit both for anonymous mode)")
    iam = None
    if args.config:
        from .s3.auth import Iam
        iam = Iam.from_file(args.config)
    _serve_until_signalled(lambda: run_s3(
        args.ip, args.port, args.filer,
        access_key=args.access_key, secret_key=args.secret_key, iam=iam))


def cmd_webdav(args) -> None:
    from .server.webdav_server import run_webdav
    _serve_until_signalled(lambda: run_webdav(args.ip, args.port,
                                              args.filer))


def cmd_mount(args) -> None:
    from .mount.fuse_mount import mount
    mount(args.filer, args.dir, collection=args.collection,
          replication=args.replication,
          chunk_size=args.chunk_size_mb * 1024 * 1024)


def cmd_shell(args) -> None:
    """Admin shell: one-shot `shell <cmd> [args]` or an interactive REPL
    (weed/shell/shell_liner.go)."""
    from .client import Client
    from .ec.geometry import Geometry
    from .shell import commands as shell_commands
    from .shell.commands import COMMANDS, CommandEnv, run_command
    shell_commands._register_all()
    argv = list(args.cmd or [])
    if argv and args.volume:
        argv += ["-volumeId", str(args.volume)]
    if argv and args.collection:
        argv += ["-collection", args.collection]
    if argv and args.dry_run:
        argv.append("-dryRun")
    env = CommandEnv(Client(args.server),
                     Geometry(large_block_size=args.ec_large_block,
                              small_block_size=args.ec_small_block),
                     filer=args.filer)
    if argv:
        out = run_command(env, argv)
        if isinstance(out, bytes):
            # fs.cat: the file's bytes, as they are
            sys.stdout.buffer.write(out)
            sys.stdout.flush()
            return
        print(json.dumps(out, default=str))
        return
    print(f"seaweedfs-torch shell: {len(COMMANDS)} commands; 'help' lists "
          "them, ctrl-d exits", file=sys.stderr)
    while True:
        try:
            line = input("> ").strip()
        except EOFError:
            break
        if line in ("exit", "quit"):
            break
        if not line:
            continue
        try:
            print(json.dumps(run_command(env, line), default=str))
        except Exception as e:
            print(json.dumps({"error": str(e)}))


def cmd_compact(args) -> None:
    """Offline vacuum of one volume (weed compact,
    weed/command/compact.go)."""
    from .storage.volume import Volume
    v = Volume(args.dir, args.collection, args.volumeId)
    try:
        before = v.data_file_size()
        v.compact()
        after = v.data_file_size()
    finally:
        v.close()
    print(json.dumps({"volume": args.volumeId, "bytes_before": before,
                      "bytes_after": after, "reclaimed": before - after}))


def cmd_backup(args) -> None:
    """Incrementally pull a volume into a local replica directory
    (weed backup, weed/command/backup.go:64)."""
    import os

    from .client import Client
    from .storage import volume_backup
    from .storage.volume import Volume
    client = Client(args.server)
    os.makedirs(args.dir, exist_ok=True)
    prefix = f"{args.collection}_" if args.collection else ""
    create = not os.path.exists(
        os.path.join(args.dir, f"{prefix}{args.volumeId}.dat"))
    v = Volume(args.dir, args.collection, args.volumeId, create=create)
    try:
        applied = volume_backup.incremental_backup(
            v, 0, lambda since: client.tail_volume(args.volumeId, since))
        count = v.file_count()
    finally:
        v.close()
    print(json.dumps({"volume": args.volumeId, "applied": applied,
                      "file_count": count}))


def cmd_fix(args) -> None:
    """Rebuild a volume's .idx by scanning its .dat (weed fix,
    weed/command/fix.go:61)."""
    from .storage import volume_backup
    count = volume_backup.rebuild_idx(args.dir, args.collection,
                                      args.volumeId)
    print(json.dumps({"volume": args.volumeId, "live_needles": count}))


def cmd_version(args) -> None:
    from . import __version__
    print(f"seaweedfs-torch {__version__}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="seaweedfs-torch")
    p.add_argument("-v", type=int, default=0, dest="verbosity",
                   help="log INFO and above when > 0")
    sub = p.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("master", help="run a master server")
    m.add_argument("-ip", default="127.0.0.1")
    m.add_argument("-port", type=int, default=9333)
    m.add_argument("-volumeSizeLimitMB", "-volume_size_limit_mb",
                   dest="volume_size_limit_mb", type=int,
                   default=30 * 1024)
    m.add_argument("-defaultReplication", "-default_replication",
                   dest="default_replication", default="000")
    m.add_argument("-garbageThreshold", "-garbage_threshold",
                   dest="garbage_threshold", type=float, default=0.3,
                   help="the periodic vacuum compacts volumes with at "
                        "least this share of deleted bytes")
    m.add_argument("-pulse", type=float, default=5.0,
                   help="expected heartbeat interval (dead nodes are "
                        "pruned after 5 pulses)")
    m.add_argument("-maintenance_interval", type=float, default=-1.0,
                   help="seconds between maintenance-daemon passes "
                        "(prune + repair planner; default: pulse, "
                        "0 disables the daemon)")
    m.add_argument("-peers", default="",
                   help="comma-separated ip:port of every master of the "
                        "HA group, this one included (weed master "
                        "-peers)")
    m.add_argument("-mdir", default="",
                   help="directory of this master's raft state")
    m.add_argument("-sequencer_kv", default="",
                   help="host:port of a redis-protocol KV whose counter "
                        "leases the file keys (KvSequencer)")
    m.add_argument("-repair_concurrency", type=int, default=None,
                   help="max concurrent repairs (re-replication / "
                        "auto ec.rebuild / lifecycle encodes) the "
                        "daemon drives; default WEED_EC_ENCODE_WORKERS "
                        "or 2")
    m.add_argument("-grpc_port", type=int, default=-1,
                   help="the gRPC port (default: the HTTP port + 10000; "
                        "0 serves no gRPC)")
    m.set_defaults(fn=cmd_master)

    v = sub.add_parser("volume", help="run a volume server")
    v.add_argument("-ip", default="127.0.0.1")
    v.add_argument("-port", type=int, default=8080)
    v.add_argument("-dir", default="./data")
    v.add_argument("-max", type=int, default=8)
    v.add_argument("-mserver", default="127.0.0.1:9333",
                   help="the master, or an HA group's comma list")
    v.add_argument("-dataCenter", dest="data_center", default="")
    v.add_argument("-rack", default="")
    v.add_argument("-pulse", type=float, default=5.0)
    v.add_argument("-coder", default="auto",
                   help="auto (the CUDA kernels), torch or numpy")
    v.add_argument("-device", default="",
                   help="the coder's device, e.g. cuda:0 or cpu")
    v.add_argument("-ec_large_block", type=int, default=1024 * 1024 * 1024)
    v.add_argument("-ec_small_block", type=int, default=1024 * 1024)
    v.add_argument("-index", default="memory",
                   choices=["memory", "compact", "leveldb", "leveldbMedium",
                            "leveldbLarge"],
                   help="needle map kind (weed volume -index)")
    v.add_argument("-minFreeSpacePercent", dest="min_free_space_percent",
                   type=float, default=1.0,
                   help="seal the volumes of a disk with less free space")
    v.add_argument("-preallocate", type=int, default=0,
                   help="MB to reserve for each new volume "
                        "(volume_create_linux.go)")
    v.add_argument("-grpc_port", type=int, default=-1,
                   help="the gRPC port (default: the HTTP port + 10000; "
                        "0 serves no gRPC)")
    v.add_argument("-grpc_heartbeat", action="store_true",
                   help="beat over the master's gRPC Heartbeat stream "
                        "(at its HTTP port + 10000) instead of HTTP")
    v.set_defaults(fn=cmd_volume)

    sh = sub.add_parser("shell", help="admin shell (REPL or one-shot)")
    sh.add_argument("-master", "-server", dest="server",
                    default="127.0.0.1:9333",
                    help="the master, or an HA group's comma list")
    sh.add_argument("-filer", default="",
                    help="the filer host:port of the fs.* commands")
    sh.add_argument("-volume", type=int, default=0)
    sh.add_argument("-collection", default="")
    sh.add_argument("-dry_run", action="store_true")
    sh.add_argument("-ec_large_block", type=int, default=1024 * 1024 * 1024)
    sh.add_argument("-ec_small_block", type=int, default=1024 * 1024)
    sh.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="command + args (empty for the REPL)")
    sh.set_defaults(fn=cmd_shell)

    f = sub.add_parser("filer", help="run a filer server")
    f.add_argument("-ip", default="127.0.0.1")
    f.add_argument("-port", type=int, default=8888)
    f.add_argument("-mserver", default="127.0.0.1:9333",
                   help="the master, or an HA group's comma list")
    f.add_argument("-store", default="sqlite",
                   help="metadata store: sqlite | memory | leveldb | "
                        "leveldb2 | mysql | postgres | redis | redis2 | "
                        "etcd | mongodb | elastic | cassandra")
    f.add_argument("-store_path", default="./filer.db")
    f.add_argument("-store_servers", default="",
                   help="host:port (or URL) of a network store (redis, "
                        "redis2, etcd, mongodb, elastic, cassandra)")
    f.add_argument("-chunk_size_mb", type=int, default=8)
    f.add_argument("-default_replication", default="")
    f.add_argument("-collection", default="")
    f.add_argument("-meta_log", default="",
                   help="path for the persisted metadata event log")
    f.add_argument("-peers", default="",
                   help="peer filers, host:port each, whose metadata "
                        "streams replay into this filer's store")
    f.add_argument("-ring_peers", default="",
                   help="the filer ring's members, host:port each "
                        "(this filer's own included)")
    f.add_argument("-grpc_port", type=int, default=-1,
                   help="the gRPC port (default: the HTTP port + 10000; "
                        "0 serves no gRPC)")
    f.set_defaults(fn=cmd_filer)

    mb = sub.add_parser("msg.broker", help="run a pub/sub message broker")
    mb.add_argument("-ip", default="127.0.0.1")
    mb.add_argument("-port", type=int, default=17777,
                    help="the HTTP port (gRPC on it + 10000)")
    mb.add_argument("-filer", default="",
                    help="filer host:port: segments persist there and the "
                         "broker registers over its gRPC KeepConnected "
                         "(empty: memory only, alone)")
    mb.set_defaults(fn=cmd_msg_broker)

    w = sub.add_parser("watch", help="live-tail filer metadata events")
    w.add_argument("-filer", default="127.0.0.1:8888")
    w.add_argument("-pathPrefix", dest="path_prefix", default="/")
    w.add_argument("-since", type=int, default=0)
    w.set_defaults(fn=cmd_watch)

    fr = sub.add_parser("filer.replicate",
                        help="replicate filer changes into a sink "
                             "(replication.toml)")
    fr.add_argument("-filer", default="127.0.0.1:8888")
    fr.add_argument("-pathPrefix", dest="path_prefix", default="/")
    fr.add_argument("-offsetFile", dest="offset_file", default="",
                    help="resume-offset file (default derived from -filer)")
    fr.add_argument("-from_queue", action="store_true",
                    help="consume events from the [source.*] queue in "
                         "replication.toml instead of a live subscribe")
    fr.set_defaults(fn=cmd_filer_replicate)

    fsync = sub.add_parser("filer.sync",
                           help="active-active sync between two filers")
    fsync.add_argument("-a", required=True, help="filer A host:port")
    fsync.add_argument("-b", required=True, help="filer B host:port")
    fsync.add_argument("-pathPrefix", dest="path_prefix", default="/")
    fsync.add_argument("-offsetFile", dest="offset_file", default="",
                       help="resume-offset file stem (default: "
                            "~/.seaweedfs_torch/offsets/, keyed by job)")
    fsync.set_defaults(fn=cmd_filer_sync)

    s3p = sub.add_parser("s3", help="run the S3 gateway")
    s3p.add_argument("-ip", default="127.0.0.1")
    s3p.add_argument("-port", type=int, default=8333)
    s3p.add_argument("-filer", default="127.0.0.1:8888")
    s3p.add_argument("-access_key", default="")
    s3p.add_argument("-secret_key", default="")
    s3p.add_argument("-config", default="",
                     help="JSON identities file with per-action ACLs "
                          "(weed s3 -config)")
    s3p.set_defaults(fn=cmd_s3)

    mt = sub.add_parser("mount", help="FUSE-mount a filer path")
    mt.add_argument("-filer", default="127.0.0.1:8888")
    mt.add_argument("-dir", required=True, help="local mountpoint")
    mt.add_argument("-collection", default="")
    mt.add_argument("-replication", default="")
    mt.add_argument("-chunk_size_mb", type=int, default=8)
    mt.set_defaults(fn=cmd_mount)

    wd = sub.add_parser("webdav", help="run the WebDAV gateway")
    wd.add_argument("-ip", default="127.0.0.1")
    wd.add_argument("-port", type=int, default=7333)
    wd.add_argument("-filer", default="127.0.0.1:8888")
    wd.set_defaults(fn=cmd_webdav)

    cp = sub.add_parser("compact", help="offline vacuum of one volume")
    cp.add_argument("-dir", default="./data")
    cp.add_argument("-collection", default="")
    cp.add_argument("-volumeId", type=int, required=True)
    cp.set_defaults(fn=cmd_compact)

    bk = sub.add_parser("backup", help="incrementally pull a volume "
                                       "into a local replica")
    bk.add_argument("-server", default="127.0.0.1:9333")
    bk.add_argument("-dir", default="./backup")
    bk.add_argument("-collection", default="")
    bk.add_argument("-volumeId", type=int, required=True)
    bk.set_defaults(fn=cmd_backup)

    fx = sub.add_parser("fix", help="rebuild a volume's .idx from its .dat")
    fx.add_argument("-dir", default="./data")
    fx.add_argument("-collection", default="")
    fx.add_argument("-volumeId", type=int, required=True)
    fx.set_defaults(fn=cmd_fix)

    ver = sub.add_parser("version", help="print the version")
    ver.set_defaults(fn=cmd_version)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbosity > 0 else logging.WARNING,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args.fn(args)


if __name__ == "__main__":
    main()
