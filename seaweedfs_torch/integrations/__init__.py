"""Adapters to other ecosystems: ``fsspec_fs`` (``seaweedfs://`` for
fsspec), imported only by who needs it."""
