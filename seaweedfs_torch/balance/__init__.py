"""Balance plane: placement choices shared by the master's daemons.

The port's reduced copy of seaweedfs_tpu/balance/: only the planner's
``pick_replica_target``, the repair daemon's choice of a node for a lost
replica. Left out: the heat-driven balancer daemon and its move planner.
"""
