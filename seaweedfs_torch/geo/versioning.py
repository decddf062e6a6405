"""S3 object versioning: layout and version-id scheme.

The port's copy of seaweedfs_tpu/geo/versioning.py, whole.

Versioned objects keep the *current* version at the ordinary object
path (so the unversioned GET/list hot paths are untouched) and every
*noncurrent* version as a sibling filer entry under
``<object path>.versions/<version id>`` — ordinary files in the
namespace, which is what makes cross-cluster replication of the full
version history free: the geo replicator ships filer entries and has
no idea versioning exists.

Version ids are ``<time_ns as 16-hex><4 random hex>`` — fixed-width,
so plain lexicographic order IS creation order and "newest remaining
version" is one ``max()``.  Objects created before versioning was
enabled hold the reserved id ``"null"`` (AWS semantics).

Delete markers are chunkless entries in the versions directory carrying
``x-amz-delete-marker: true`` in their extended attributes.
"""

from __future__ import annotations

import secrets
import time

# bucket directory entry attribute: "Enabled" | "Suspended"
VERSIONING_ATTR = "seaweed-versioning"
# object entry attributes (ride the same extended dict as tags)
VERSION_ID_ATTR = "x-amz-version-id"
DELETE_MARKER_ATTR = "x-amz-delete-marker"
# sibling directory holding noncurrent versions of <key>
VERSIONS_SUFFIX = ".versions"

NULL_VERSION = "null"


def new_version_id() -> str:
    """Fixed-width, time-ordered, collision-safe within a gateway."""
    return f"{time.time_ns():016x}{secrets.token_hex(2)}"


def versions_dir(obj_path: str) -> str:
    """Filer directory holding the noncurrent versions of `obj_path`."""
    return obj_path + VERSIONS_SUFFIX


def entry_version_id(entry: dict) -> str:
    """The version id stamped on a filer entry dict (JSON form);
    pre-versioning entries read as "null"."""
    return (entry.get("extended") or {}).get(VERSION_ID_ATTR, NULL_VERSION)


def is_delete_marker(entry: dict) -> bool:
    return (entry.get("extended") or {}).get(
        DELETE_MARKER_ATTR, "") == "true"
