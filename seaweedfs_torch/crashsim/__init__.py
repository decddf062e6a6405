"""crashsim: power-loss simulation over the port's durable writers.

The port's counterpart of seaweedfs_tpu/crashsim/. A process kill leaves
the disk intact; a power loss can tear a sector, drop an un-synced page,
or revoke a rename that no directory fsync followed. Three layers:

- :mod:`.shim` records every mutation under one directory tree, with
  its fsync barriers, while the workload runs against the real
  filesystem;
- :mod:`.replay` rebuilds the disk state a crash at any point of that
  log could have left, honouring only synced ordering;
- :mod:`.harness` / :mod:`.workloads` run the port's persistence paths
  (volume append, EC encode, the fused warm-down), ack state at their
  durability barriers, reopen the subsystem on each crash tree and hold
  it to the contract: every acked write present and intact, no torn
  state loaded silently, recovery converges.

CLI: ``python -m seaweedfs_torch.crashsim [--seeds N] [--points N]
[--workloads a,b] [--json]``.
"""

from .shim import DiskRecorder, Op
from .replay import build_crash_state
from .harness import CrashWorkload, SweepResult, sweep, sweep_all

__all__ = ["DiskRecorder", "Op", "build_crash_state", "CrashWorkload",
           "SweepResult", "sweep", "sweep_all"]
