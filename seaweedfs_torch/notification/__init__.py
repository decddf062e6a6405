"""Outbound notification queues for filer metadata events.

The port's copy of seaweedfs_tpu/notification/ (upstream
weed/notification/): every filer CRUD emits an EventNotification to a
configured message queue (notification.toml). Here: ``log`` (logging
output), ``file`` (ndjson appended to a spool directory) and ``webhook``
(an HTTP POST per event, spooled on failure).
"""

from .queues import (FileQueue, LogQueue, WebhookQueue,  # noqa: F401
                     load_notifier)
