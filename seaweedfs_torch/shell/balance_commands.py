"""cluster.balance.status and cluster.balance.run: the operator's face
of the auto-balancer (balance/daemon.py on the master).

The port's copy of seaweedfs_tpu/shell/balance_commands.py.
``cluster.balance.status`` prints the daemon's state: per-node read
rates (hottest first), moves in flight and recent ones, and the two-pass
and cooldown bookkeeping that says why a proposed move has not fired.
``cluster.balance.run`` runs one planning pass now, the timer's, and
reports what it planned, confirmed and launched.
"""

from __future__ import annotations

from .commands import CommandEnv, command, parser


@command("cluster.balance.status",
         "show the auto-balancer's state: per-node heat rates, pending/"
         "recent moves, two-pass + cooldown bookkeeping "
         "(cluster.balance.status [-hot N])")
def cluster_balance_status(env: CommandEnv, argv: list[str]):
    p = parser("cluster.balance.status")
    p.add_argument("-hot", type=int, default=10,
                   help="show only the N hottest nodes (0 = all)")
    args = p.parse_args(argv)
    out = env.client.balance_status()
    rates = out.get("node_rates", {})
    ranked = sorted(rates.items(), key=lambda kv: (-kv[1], kv[0]))
    if args.hot > 0:
        ranked = ranked[:args.hot]
    out["node_rates"] = dict(ranked)
    out["nodes_tracked"] = len(rates)
    return out


@command("cluster.balance.run",
         "trigger one balance planning pass now (the same pass the "
         "timer loop runs); confirmed moves launch through the shared "
         "repair worker slots (cluster.balance.run)")
def cluster_balance_run(env: CommandEnv, argv: list[str]):
    parser("cluster.balance.run").parse_args(argv)
    return env.client.balance_run()
