"""Lifecycle policy: declarative rules evaluated over topology + heat.

The port's copy of seaweedfs_tpu/lifecycle/policy.py. Pure planning (no
sockets, no clocks of its own: ``now`` is an argument), so the rules are
unit-testable like the shell's EC planners; the daemon
(lifecycle/daemon.py) executes what this module plans.

Rules, all tuned by WEED_LIFECYCLE_* env knobs (see LifecycleConfig):

* hot -> warm: a volume that is FULL (read_only, or size past
  WEED_LIFECYCLE_FULL_FRACTION of the cluster volume-size limit) and
  IDLE (no access for WEED_LIFECYCLE_WARM_AFTER, measured from
  max(last_access, first_seen)) is sealed and warmed down into the
  14-shard EC tier: the manual ``ec.encode`` / ``ec.warmdown`` flow made
  time-driven. ``warm_requested`` (vid -> reason) nudges volumes there
  regardless of idleness: the daemon's S3 pass fills it from bucket
  Transition rules (the volumes holding a transitioned object's chunks).
* warm -> hot: an EC volume whose decayed read rate reaches
  WEED_LIFECYCLE_HOT_READ_RATE (reads/s; 0 disables) is decoded back to
  a normal volume (``ec.decode``).
* expiry: TTL volumes (superblock TTL) whose last write is older than
  the TTL plus WEED_LIFECYCLE_TTL_GRACE, and volumes of collections
  listed in WEED_LIFECYCLE_COLLECTION_TTL ("logs=3600,tmp=600", values
  in seconds), are deleted on every holder at once.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

from ..storage.types import TTL


def parse_duration(s: str, default: float = 0.0) -> float:
    """'90'/'90s'/'15m'/'6h'/'7d' -> seconds (0/'' -> default)."""
    s = (s or "").strip().lower()
    if not s:
        return default
    mult = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}
    try:
        if s[-1] in mult:
            return float(s[:-1]) * mult[s[-1]]
        return float(s)
    except ValueError:
        return default


def _parse_collection_ttls(spec: str) -> dict[str, float]:
    """'logs=3600,tmp=10m' -> {'logs': 3600.0, 'tmp': 600.0}."""
    out: dict[str, float] = {}
    for part in (spec or "").split(","):
        name, _, val = part.strip().partition("=")
        if not name or not val:
            continue
        secs = parse_duration(val)
        if secs > 0:
            out[name] = secs
    return out


@dataclass
class LifecycleConfig:
    """All WEED_LIFECYCLE_* knobs in one place (README "Data lifecycle")."""
    warm_after: float = 0.0          # WEED_LIFECYCLE_WARM_AFTER (0=off)
    hot_read_rate: float = 0.0       # WEED_LIFECYCLE_HOT_READ_RATE (0=off)
    interval: float = 60.0           # WEED_LIFECYCLE_INTERVAL
    filer: str = ""                  # WEED_LIFECYCLE_FILER (S3 rules)
    day_seconds: float = 86400.0     # WEED_LIFECYCLE_DAY_SECONDS
    full_fraction: float = 0.9       # WEED_LIFECYCLE_FULL_FRACTION
    ttl_grace: float = 60.0          # WEED_LIFECYCLE_TTL_GRACE
    collection_ttls: dict[str, float] = field(default_factory=dict)
    heat_export_top: int = 64        # WEED_LIFECYCLE_HEAT_EXPORT_TOP
    scan_limit: int = 10000          # WEED_LIFECYCLE_S3_SCAN_LIMIT
    force_enabled: Optional[bool] = None  # WEED_LIFECYCLE_ENABLED override
    # WEED_EC_FUSED (default on): warm transitions use the one-pass
    # fused warm-down (compact + gzip + encode + digest, ec/fused.py)
    # instead of the chained vacuum -> ec/generate steps
    ec_fused: bool = True

    @property
    def enabled(self) -> bool:
        """The daemon runs only when some rule can actually fire (or the
        operator forces it): a cluster with no lifecycle rules must
        behave exactly as before this subsystem existed."""
        if self.force_enabled is not None:
            return self.force_enabled
        return bool(self.warm_after > 0 or self.hot_read_rate > 0
                    or self.collection_ttls or self.filer)

    @classmethod
    def from_env(cls, env: Optional[dict] = None) -> "LifecycleConfig":
        env = env if env is not None else os.environ
        force = env.get("WEED_LIFECYCLE_ENABLED", "")
        return cls(
            warm_after=parse_duration(
                env.get("WEED_LIFECYCLE_WARM_AFTER", "")),
            hot_read_rate=float(
                env.get("WEED_LIFECYCLE_HOT_READ_RATE", "0") or 0),
            interval=max(parse_duration(
                env.get("WEED_LIFECYCLE_INTERVAL", "60"), 60.0), 0.05),
            filer=env.get("WEED_LIFECYCLE_FILER", ""),
            day_seconds=max(parse_duration(
                env.get("WEED_LIFECYCLE_DAY_SECONDS", "86400"),
                86400.0), 0.001),
            full_fraction=float(
                env.get("WEED_LIFECYCLE_FULL_FRACTION", "0.9") or 0.9),
            ttl_grace=parse_duration(
                env.get("WEED_LIFECYCLE_TTL_GRACE", "60"), 60.0),
            collection_ttls=_parse_collection_ttls(
                env.get("WEED_LIFECYCLE_COLLECTION_TTL", "")),
            heat_export_top=int(
                env.get("WEED_LIFECYCLE_HEAT_EXPORT_TOP", "64") or 64),
            scan_limit=int(
                env.get("WEED_LIFECYCLE_S3_SCAN_LIMIT", "10000") or 10000),
            force_enabled=(None if force == ""
                           else force not in ("0", "false", "no")),
            ec_fused=env.get("WEED_EC_FUSED", "1") not in ("0", "false",
                                                           "no"),
        )


@dataclass
class Transition:
    kind: str            # "warm" | "unec" | "expire"
    vid: int
    collection: str
    reason: str
    holders: list = field(default_factory=list)   # urls with the volume
    ec_holders: list = field(default_factory=list)  # urls with shards

    @property
    def key(self) -> tuple:
        return (self.kind, self.vid)


def _ttl_seconds(ttl_str: str) -> float:
    try:
        return TTL.parse(ttl_str).minutes() * 60.0
    except ValueError:
        return 0.0


def plan_transitions(topology, heat_view: dict, cfg: LifecycleConfig,
                     now: float,
                     warm_requested: Optional[dict] = None
                     ) -> list[Transition]:
    """Evaluate every rule against the cluster view; returns the
    transitions that are due this pass (the daemon applies in-flight /
    backoff gating on top).  `topology` is the master's Topology object;
    `heat_view` is Topology.heat_view(now); `warm_requested` maps vid ->
    reason for S3-Transition-nudged volumes."""
    warm_requested = warm_requested or {}
    out: list[Transition] = []

    # vid -> (VolumeInfo, [holder urls]) over normal volumes
    vols: dict[int, tuple] = {}
    for node in topology.nodes.values():
        for vid, vi in node.volumes.items():
            info = vols.get(vid)
            if info is None:
                vols[vid] = (vi, [node.url])
            else:
                info[1].append(node.url)
    # vid -> (collection, {shard ids}, [holder urls]) over EC volumes
    ecs: dict[int, tuple] = {}
    for node in topology.nodes.values():
        for vid, si in node.ec_shards.items():
            info = ecs.get(vid)
            if info is None:
                ecs[vid] = (si.collection, set(si.shard_ids), [node.url])
            else:
                info[1].update(si.shard_ids)
                info[2].append(node.url)

    vacuuming = {vid for layout in topology.layouts.values()
                 for vid in layout.vacuuming}

    for vid, (vi, holders) in sorted(vols.items()):
        h = heat_view.get(vid, {})
        last = max(h.get("last_access", 0.0), h.get("first_seen", now))
        ttl_secs = _ttl_seconds(vi.ttl)
        col_ttl = cfg.collection_ttls.get(vi.collection, 0.0)

        # --- expiry (whole-volume, all holders at once) ---
        expire_after = min((s for s in (ttl_secs, col_ttl) if s > 0),
                           default=0.0)
        if expire_after > 0:
            # anchor on the newest write/access the cluster has seen;
            # first_seen only as the fallback for a volume that has
            # never reported either (a brand-new empty TTL volume must
            # not expire out from under an in-flight assignment)
            written = max(getattr(vi, "last_modified", 0) or 0.0,
                          h.get("last_access", 0.0))
            if written <= 0:
                written = h.get("first_seen", now)
            if now >= written + expire_after + cfg.ttl_grace:
                out.append(Transition(
                    "expire", vid, vi.collection,
                    f"ttl {expire_after:.0f}s elapsed", holders=holders))
            continue  # an expiring volume never also goes warm

    # --- hot -> warm (idle sealed volumes, or S3-transition nudges) ---
        if vid in vacuuming:
            continue
        requested = vid in warm_requested
        idle = (cfg.warm_after > 0
                and now - last >= cfg.warm_after)
        if vid in ecs:
            # dual state: a shard set exists ALONGSIDE the original —
            # a transition crashed between shard mount and retirement.
            # Resume it (the daemon retires the original if the set is
            # complete, re-encodes if not) — but ONLY while the volume
            # is still idle (or explicitly requested): a volume that
            # was just un-EC'd back to hot also shows this dual state
            # through one stale-heartbeat window, and planning a resume
            # there would re-retire the freshly decoded copy. Idleness
            # distinguishes the two: a crashed warm transition's volume
            # stays idle (it qualified by being idle), an un-EC'd one
            # is hot by definition.
            if requested or idle:
                out.append(Transition(
                    "warm", vid, vi.collection,
                    "resume: shard set alongside original",
                    holders=holders))
            continue
        sealed = (vi.read_only
                  or vi.size >= cfg.full_fraction
                  * topology.volume_size_limit)
        if requested or (sealed and idle):
            reason = (warm_requested.get(vid) if requested
                      else f"idle {now - last:.0f}s >= "
                           f"{cfg.warm_after:.0f}s")
            out.append(Transition("warm", vid, vi.collection, reason,
                                  holders=holders))

    # --- expiry of warm (EC-only) volumes: a collection TTL added
    # AFTER data was tiered must still expire it (compliance rules
    # don't care which tier holds the bytes). EC volumes carry no
    # superblock/last_modified here, so the anchor is the newest
    # access the cluster has seen (first_seen as the conservative
    # fallback: at worst expiry waits one TTL from master boot).
    expiring_ec: set[int] = set()
    for vid, (collection, shard_ids, holders) in sorted(ecs.items()):
        if vid in vols:
            continue  # dual state is the warm-resume rule's business
        col_ttl = cfg.collection_ttls.get(collection, 0.0)
        if col_ttl <= 0:
            continue
        h = heat_view.get(vid, {})
        anchor = max(h.get("last_access", 0.0), h.get("first_seen", now))
        if now >= anchor + col_ttl + cfg.ttl_grace:
            expiring_ec.add(vid)
            out.append(Transition(
                "expire", vid, collection,
                f"collection ttl {col_ttl:.0f}s elapsed (warm tier)",
                ec_holders=holders))

    # --- warm -> hot (reconstruct-read rate above threshold) ---
    if cfg.hot_read_rate > 0:
        for vid, (collection, shard_ids, holders) in sorted(ecs.items()):
            if vid in vols:
                continue  # mid-transition: a normal copy still exists
            if vid in expiring_ec:
                continue  # expiring data never also decodes back
            h = heat_view.get(vid, {})
            rate = h.get("read_rate", 0.0)
            if rate >= cfg.hot_read_rate:
                out.append(Transition(
                    "unec", vid, collection,
                    f"read rate {rate:.2f}/s >= {cfg.hot_read_rate}/s",
                    ec_holders=holders))
    return out
