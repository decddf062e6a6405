"""The masters' consensus plane (raft.py)."""
