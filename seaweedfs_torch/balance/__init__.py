"""Balance plane: the heat-driven auto-balancer.

The port's reduced copy of seaweedfs_tpu/balance/, in the planner/daemon
split of the master's other daemons:

* **planner.py**: pure, clock-injected and seeded. ``plan_moves`` reads
  the topology's per-node heat and capacity and proposes volume moves
  from hot nodes to cold ones, never shrinking a volume's rack or data
  center spread, never past the destination's capacity watermark, only
  for sealed volumes (read-only, or past 0.9 of the size limit), never
  for EC volumes. ``PlannerState`` is the oscillation guard (two-pass
  confirmation, per-volume cooldown, the A->B->A veto) that both the
  daemon and clustersim run. ``pick_replica_target`` is the repair
  daemon's placement rule.
* **daemon.py**: ``BalancerDaemon`` on the master executes confirmed
  moves with the replicate -> verify -> retire primitives, sharing the
  repair daemon's semaphore and backoff.

``/dir/assign`` places new volumes on the coldest nodes first while the
balancer is on (``Topology.find_empty_slots(heat_rank=...)``). Every
knob is a ``WEED_BALANCE_*`` variable (``BalanceConfig.from_env``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional


def _env_float(env: dict, key: str, default: float) -> float:
    try:
        return float(env.get(key, "") or default)
    except ValueError:
        return default


@dataclass
class BalanceConfig:
    """The WEED_BALANCE_* knobs."""
    interval: float = 30.0      # WEED_BALANCE_INTERVAL seconds per pass
    hot_ratio: float = 1.5      # WEED_BALANCE_HOT_RATIO x mean = hot
    cold_ratio: float = 0.8     # WEED_BALANCE_COLD_RATIO x mean = cold
    min_rate: float = 0.05      # WEED_BALANCE_MIN_RATE reads/s floor
    max_moves: int = 4          # WEED_BALANCE_MAX_MOVES per pass
    cooldown: float = 600.0     # WEED_BALANCE_COOLDOWN s between moves
                                # of one volume
    watermark: float = 0.85     # WEED_BALANCE_WATERMARK destination
                                # volume-slot utilization cap
    assign_heat_aware: bool = True   # WEED_BALANCE_ASSIGN
    force_enabled: Optional[bool] = None  # WEED_BALANCE_ENABLED

    @property
    def enabled(self) -> bool:
        """On unless disabled: a cluster with uniform heat plans no
        moves, so the default loop changes nothing until skew shows."""
        if self.force_enabled is not None:
            return self.force_enabled
        return True

    @classmethod
    def from_env(cls, env: Optional[dict] = None) -> "BalanceConfig":
        env = env if env is not None else os.environ
        force = env.get("WEED_BALANCE_ENABLED", "")
        return cls(
            interval=max(_env_float(env, "WEED_BALANCE_INTERVAL", 30.0),
                         0.05),
            hot_ratio=max(_env_float(env, "WEED_BALANCE_HOT_RATIO", 1.5),
                          1.0),
            cold_ratio=min(max(_env_float(env, "WEED_BALANCE_COLD_RATIO",
                                          0.8), 0.0), 1.0),
            min_rate=max(_env_float(env, "WEED_BALANCE_MIN_RATE", 0.05),
                         0.0),
            max_moves=max(int(_env_float(env, "WEED_BALANCE_MAX_MOVES",
                                         4)), 1),
            cooldown=max(_env_float(env, "WEED_BALANCE_COOLDOWN", 600.0),
                         0.0),
            watermark=min(max(_env_float(env, "WEED_BALANCE_WATERMARK",
                                         0.85), 0.05), 1.0),
            assign_heat_aware=env.get("WEED_BALANCE_ASSIGN", "1")
            not in ("0", "false", "no"),
            force_enabled=(None if force == ""
                           else force not in ("0", "false", "no")),
        )


from .planner import (Move, PlannerState, node_rates,  # noqa: E402
                      pick_replica_target, plan_moves)

__all__ = [
    "BalanceConfig", "Move", "PlannerState", "node_rates",
    "pick_replica_target", "plan_moves",
]
