"""Overload plane: admission control and priority shedding.

The port's copy of seaweedfs_tpu/overload/__init__.py. When offered load
exceeds capacity, an unprotected asyncio server keeps accepting work
until queues and memory blow up and every request times out; this
package makes degradation a decision instead:

* every request entering a surface that installs
  :func:`admission_middleware` is classified into a priority class:
  ``fg`` (foreground user traffic, the default), ``bg`` (background
  repair, scrub, replication, vacuum, tagged with the
  ``X-Seaweed-Priority`` header) or ``system`` (the surface's reserved
  ops routes, never shed);
* hierarchical token buckets meter the request stream: a global
  per-process rate plus per-tenant buckets keyed off the S3 access key
  or the ``collection`` param. Tenant exhaustion answers ``429``; global
  exhaustion is overload and answers ``503``;
* per-class concurrency and queue-depth caps bound the work admitted,
  and an event-loop lag sampler watches the loop itself; background
  sheds first, strictly: no ``bg`` request is admitted while any ``fg``
  request is queued or was shed within the last sampler window;
* shed responses carry ``503/429 + Retry-After`` (jittered) and
  ``X-Seaweed-Shed: 1``, which the port's ``utils/retry.py`` reads as
  back-off, not as a dead host;
* ``/healthz`` reports the live shedding state.

Everything is tuned through the reference's ``WEED_ADMISSION_*``
knobs (admission.py). In the port only the S3 gateway installs the
middleware, as the reference's gateway does; admission on the master,
the volume server and the filer, with the ring's hop classes, waits
for ROADMAP A.9. The port's ``faults`` has no ``/admin/faults`` route,
so :func:`faults_admin_paths` is always empty here.
"""

from __future__ import annotations

import contextlib
import contextvars

PRIORITY_HEADER = "X-Seaweed-Priority"
SHED_HEADER = "X-Seaweed-Shed"
# a metaring proxy/mirror hop between filer peers: the request was
# already classified and admitted at the edge peer, so the receiving
# peer classifies it system — metering it again would double-charge one
# user request and could deadlock a full ring under per-class caps.
# The reference honours it only when the surface opts in AND the sender
# is a known ring peer (its middleware's ring_hop predicate); in the
# port the header only marks the hop (metaring/), and its admission class
# waits for ROADMAP A.9.
RING_HOP_HEADER = "X-Seaweed-Ring-Hop"

CLASS_FG = "fg"
CLASS_BG = "bg"
CLASS_SYSTEM = "system"

# header spellings accepted for the background class (the canonical
# outbound form is "bg")
_BG_VALUES = frozenset({"bg", "background", "low"})

# Paths that are cluster control plane or long-lived streams: never
# metered, never shed.  Shedding /heartbeat or raft makes the master
# think nodes died (repair storm); /healthz///metrics must stay
# answerable precisely when overloaded (that's when the LB needs them);
# streams hold their "request" open for hours, so counting them against
# a concurrency cap would wedge the class.
#
# Each surface exempts ONLY the paths its router actually reserves
# ahead of any user catch-all.  A single shared set would let user
# traffic whose path merely collides with another server's control
# plane (an S3 bucket named "status", a filer file at /heartbeat)
# classify as system and bypass admission entirely.  "" / "/" are in
# no set — on S3, GET / is ListBuckets; on webdav, the root PROPFIND:
# real user API calls that must be metered like any other.

# the ops surface every server reserves before its catch-alls — EXACT
# registered routes only.  No prefixes: a "/debug/" prefix would exempt
# arbitrary user paths under /debug/<anything> on the catch-all
# surfaces (filer/webdav file namespace, an S3 bucket named "debug"),
# and /admin/faults exists on the gateways only under
# WEED_FAULTS_ADMIN=1 (see faults_admin_paths below) — exempting a
# route that resolves to user data is an admission bypass
OPS_PATHS = frozenset({"/healthz", "/metrics", "/debug/trace",
                       "/debug/profile", "/debug/pprof",
                       "/debug/events"})
OPS_PREFIXES: tuple = ()

# master has no user namespace: the whole control plane is exempt
MASTER_SYSTEM_PATHS = OPS_PATHS | {
    "/admin/faults", "/ui", "/status", "/heartbeat", "/dir/status",
    "/cluster/status", "/cluster/watch", "/cluster/lock",
    "/cluster/unlock", "/cluster/raft/vote", "/cluster/raft/append",
    "/ec/scrub_report", "/vol/heat", "/vol/heat/report",
    "/lifecycle/status", "/lifecycle/run", "/geo/status", "/geo/run",
    "/dir/ring", "/dir/ring/join", "/dir/ring/leave",
}
# volume fids always contain "," so these can't collide with data paths
VOLUME_SYSTEM_PATHS = OPS_PATHS | {"/admin/faults", "/ui", "/status",
                                   "/admin/tail"}
# filer: exact ops routes + the long-lived meta streams (both
# registered ahead of the path catch-all, so a user file with the same
# name is shadowed by the route anyway)
FILER_SYSTEM_PATHS = OPS_PATHS | {"/ui", "/__meta__/subscribe",
                                  "/__meta__/events"}
# S3/webdav reserve exactly the ops routes (no /ui, no /status)
GATEWAY_SYSTEM_PATHS = OPS_PATHS


def faults_admin_paths() -> frozenset:
    """/admin/faults is system-class on the unguarded gateways only when
    the route exists. The port's ``faults`` registers no such route (its
    admin face is not ported), so the path falls through to the user
    catch-all (an S3 object in bucket "admin") and must be metered: the
    set is always empty."""
    return frozenset()

# the union — default for classify() when no surface set is given
SYSTEM_PATHS = (MASTER_SYSTEM_PATHS | VOLUME_SYSTEM_PATHS
                | FILER_SYSTEM_PATHS)
SYSTEM_PREFIXES = OPS_PREFIXES

# ambient priority class: a background daemon sets it once and every
# outbound HTTP request it makes (aiohttp trace config, http_pool)
# carries the header, exactly like the trace id — so a repair-driven
# ec/copy arriving at a volume server is classified bg there too.
_priority: contextvars.ContextVar[str] = contextvars.ContextVar(
    "sw_priority", default="")


def current_priority() -> str:
    """The ambient priority class ('' when unset = foreground)."""
    return _priority.get()


def is_bg(header_value: str) -> bool:
    """Whether a priority-header value names the background class."""
    return bool(header_value) and \
        header_value.strip().lower() in _BG_VALUES


def set_priority(cls: str) -> contextvars.Token:
    """Bind the ambient priority (long-lived daemon loops); returns the
    reset token."""
    return _priority.set(cls)


def reset_priority(token) -> None:
    if token is not None:
        _priority.reset(token)


@contextlib.contextmanager
def priority(cls: str):
    """Scope a block to a priority class — the repair daemon wraps each
    repair in ``with overload.priority(overload.CLASS_BG):`` so every
    admin call it fans out is tagged and sheds first downstream."""
    token = _priority.set(cls)
    try:
        yield
    finally:
        _priority.reset(token)


def inject(headers: dict) -> dict:
    """Add the priority header to an outbound-request header dict when an
    ambient class is bound (no-op for untagged = foreground traffic)."""
    cls = _priority.get()
    if cls and PRIORITY_HEADER not in headers:
        headers[PRIORITY_HEADER] = cls
    return headers


def classify(header_value: str, path: str,
             system_paths: frozenset = SYSTEM_PATHS,
             system_prefixes: tuple = SYSTEM_PREFIXES) -> str:
    """Map (X-Seaweed-Priority, path) -> priority class.  The path check
    wins: a bg-tagged heartbeat is still control plane.  Pass the
    surface-specific system set (the controller carries it) so user
    paths on catch-all surfaces can't collide into the system class."""
    if path in system_paths or path.startswith(system_prefixes):
        return CLASS_SYSTEM
    if header_value and header_value.strip().lower() in _BG_VALUES:
        return CLASS_BG
    return CLASS_FG


def reserve_ops(app, path: str, get_handler=None, *, post_handler=None,
                reserved=None) -> None:
    """Register an operational route with every other method answered
    405 instead of falling through.  aiohttp routes a method-mismatched
    resource on to the next matching one, so a bare ``add_get`` on a
    catch-all surface would let ``PUT /healthz`` reach the user
    catch-all as a real write — classified system by the admission
    plane and never metered (an overload bypass), and a write the
    shadowing GET route could never read back.  Serving surfaces add
    their ops routes through this one helper so the "*"-reservation
    cannot be forgotten on the next surface; ``reserved`` overrides the
    405 body for protocol-specific error shapes (S3 XML)."""
    from aiohttp import web

    async def _reserved(request: "web.Request") -> "web.Response":
        return web.json_response(
            {"error": f"{request.method} not allowed on reserved "
                      f"path {request.path}"}, status=405)

    if get_handler is not None:
        app.router.add_get(path, get_handler)
    if post_handler is not None:
        app.router.add_post(path, post_handler)
    app.router.add_route("*", path, reserved or _reserved)


def tenant_from_request(request) -> str:
    """Tenant key for the per-tenant bucket: the ``collection`` query
    param (filer/volume/master surfaces) or the S3 access key id from
    the SigV4/V2 Authorization header."""
    tenant = request.query.get("collection", "")
    if tenant:
        return tenant
    auth = request.headers.get("Authorization", "")
    if auth.startswith("AWS4-HMAC-SHA256 "):
        # "... Credential=AKID/date/region/s3/aws4_request, ..."
        idx = auth.find("Credential=")
        if idx >= 0:
            cred = auth[idx + len("Credential="):]
            return cred.split("/", 1)[0].split(",", 1)[0].strip()
    elif auth.startswith("AWS ") and ":" in auth:
        return auth[4:].split(":", 1)[0].strip()
    return ""


from .bucket import TokenBucket, TenantBuckets  # noqa: E402
from .sampler import LoopLagSampler  # noqa: E402
from .admission import (AdmissionController, ShedError,  # noqa: E402
                        admission_middleware, healthz_handler)

__all__ = [
    "PRIORITY_HEADER", "SHED_HEADER", "RING_HOP_HEADER",
    "CLASS_FG", "CLASS_BG",
    "CLASS_SYSTEM", "SYSTEM_PATHS", "SYSTEM_PREFIXES",
    "OPS_PATHS", "OPS_PREFIXES", "MASTER_SYSTEM_PATHS",
    "VOLUME_SYSTEM_PATHS", "FILER_SYSTEM_PATHS",
    "GATEWAY_SYSTEM_PATHS", "faults_admin_paths",
    "current_priority", "set_priority", "reset_priority", "priority",
    "inject", "classify", "is_bg", "tenant_from_request", "reserve_ops",
    "TokenBucket", "TenantBuckets", "LoopLagSampler",
    "AdmissionController", "ShedError", "admission_middleware",
    "healthz_handler",
]
