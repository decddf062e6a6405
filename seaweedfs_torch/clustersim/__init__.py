"""clustersim: a deterministic, in-process control-plane simulator.

The port's copy of seaweedfs_tpu/clustersim/. Where crashsim proves the
data plane survives a crash at any barrier, clustersim runs the port's
real control plane (``Topology``, the balance planner, ``PlannerState``,
the repair placement rule, ``DirectoryRing``) over up to a thousand
scripted nodes and checks that it converges, stays bounded and never
oscillates. Only the substrate (volume servers, wires, disks) is
modeled:

* a virtual clock (clock.py) injected into ``Topology``: no wall-clock
  sleep, so a 1000-node run of 200 virtual seconds takes seconds;
* everything seeded: layout, scripted kills, flaps and rack loss, heat
  skew and the planner's tie-break come from one integer, and the run's
  digest (sha256 of its event log) replays from it;
* scripted heartbeats through the real ``register_heartbeat``,
  ``merge_heat`` and ``prune_dead_nodes``, each gated by the
  ``sim.heartbeat`` fault point;
* a slot pool for the master's shared ``_repair_sem`` that drains
  repairs before balance moves.

The scenarios and their checks are in scenarios.py; ``python -m
seaweedfs_torch.clustersim`` sweeps seeds x scenarios and exits 1 on any
violation.
"""

from .clock import VirtualClock
from .sim import ClusterSim, SimNode

__all__ = ["VirtualClock", "ClusterSim", "SimNode"]
