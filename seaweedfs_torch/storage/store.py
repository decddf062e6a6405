"""Store: the volumes and EC volumes one volume server owns on disk.

The port's copy of seaweedfs_tpu/storage/store.py (upstream
weed/storage/store.go:26-49, disk_location.go:18-30, store_ec.go),
reduced to volume management, the needle operations and the EC
lifecycle: encode (``ec_generate``, ``ec_generate_many``), the fused
warm-down (``ec_fused_generate``, ``ec_fused_generate_many``), mount,
unmount, shard reads, degraded reads, deletes, rebuild and decode back
to a volume (``ec_to_volume``). Each collection's RS(k,m) comes from the
geometry policy (``WEED_EC_GEOMETRY``, default
``default=10+4,archive=20+4``) for new encodes, and from the ``.ecm``
marker for shard sets already on disk.

The coder is ``get_coder(coder_name, k, m, device)``: "auto" (the
default) is the CUDA kernel coder and raises on a host without a card;
"torch" with ``device="cpu"`` runs the kernels' plain versions and
"numpy" the table coder, both on request only. Nothing falls back to the
CPU. ``WEED_EC_MESH_DEVICES`` >= 2 lifts the card coders onto a
``MeshCoder`` over that many cards (clamped to the cards present;
``parallel/mesh_coder.py``), as the reference's ``_maybe_mesh`` does.

The volume server reads a store through ``heartbeat()`` and
``status()``, and sets the ``_remote_shard_reader`` hook so that EC reads
fetch shards that live on its peers. It also drives the hot tier's
maintenance through it: ``configure_replication``, ``needle_ids`` and the
vacuum steps ``vacuum_check`` / ``vacuum_compact`` / ``vacuum_commit`` /
``vacuum_cleanup`` (the copy held to a byte rate when asked).

The rest of the storage engine: each volume opens with the store's needle
map kind (``needle_map_kind``); a new volume reserves ``preallocate``
bytes; ``check_free_space`` is the free-space watchdog (below
``min_free_space_percent`` free on a location's disk, its writable
volumes seal, and when space is back only the watchdog's own seals
lift); ``tier_upload`` / ``tier_download`` move a volume's .dat to an
object store and back (storage/backend.py; the ``.vif`` brings a tiered
volume back at the next start); ``delete_expired_volumes`` drops TTL
volumes past their grace.
"""

from __future__ import annotations

import glob
import logging
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

from .. import ec as ec_mod
from ..ec import fused as ec_fused
from ..ec import pipeline as ec_pipeline
from ..ec.coder import ErasureCoder
from ..ec.ec_volume import EcVolume, EcVolumeClosed
from ..ec.striping import read_marker_geometry
from ..parallel import mesh_coder
from ..utils import durable
from . import backend as backend_mod
from . import types as t
from .needle import Needle
from .superblock import ReplicaPlacement, SuperBlock
from .volume import Volume

log = logging.getLogger("store")


class DiskLocation:
    """One storage directory holding volumes and EC shards
    (weed/storage/disk_location.go)."""

    def __init__(self, directory: str, max_volume_count: int = 8,
                 needle_map_kind: str = "memory"):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_volume_count = max_volume_count
        self.needle_map_kind = needle_map_kind
        self.volumes: dict[int, Volume] = {}
        self.ec_volumes: dict[int, EcVolume] = {}
        self.low_space = False

    def load_existing(self, coder_factory, geometry) -> None:
        """Open every volume (``<collection>_<vid>.dat``, or its ``.vif``
        when the .dat is tiered) and every EC
        volume (``.ecx`` with at least one shard) in the directory.
        geometry: a Geometry, or a resolver (base_path, collection) ->
        Geometry; the store passes its marker-or-policy resolver, so a
        disk with RS(10,4) and RS(20,4) sets loads each right. A file
        that fails to open is skipped; a coder that cannot be built
        raises."""
        names = {os.path.basename(p)[:-4]
                 for p in glob.glob(os.path.join(self.directory, "*.dat"))}
        # a tiered volume has no local .dat: its .vif names it
        names |= {os.path.basename(p)[:-4]
                  for p in glob.glob(os.path.join(self.directory, "*.vif"))}

        def load_one(name: str):
            collection, vid = _parse_volume_file_name(name)
            if vid is None:
                return None
            try:
                return vid, Volume(self.directory, collection, vid,
                                   needle_map_kind=self.needle_map_kind)
            except Exception:
                return None

        # .idx replay is the startup cost and parallelizes across volumes
        # (disk_location.go:94-118)
        with ThreadPoolExecutor(max_workers=8) as pool:
            for res in pool.map(load_one, sorted(names)):
                if res is not None:
                    self.volumes[res[0]] = res[1]
        for ecx in sorted(glob.glob(os.path.join(self.directory, "*.ecx"))):
            name = os.path.basename(ecx)[:-4]
            collection, vid = _parse_volume_file_name(name)
            if vid is None or vid in self.volumes:
                continue
            g = (geometry(os.path.join(self.directory, name), collection)
                 if callable(geometry) else geometry)
            coder = coder_factory(g)
            try:
                ev = EcVolume(self.directory, collection, vid, g,
                              coder=coder)
            except Exception:
                continue
            for sid in range(ev.g.total_shards):
                if os.path.exists(ev.base_file_name() + ec_mod.to_ext(sid)):
                    ev.add_shard(sid)
            if ev.shard_ids():
                self.ec_volumes[vid] = ev
            else:
                ev.close()


def safe_collection(name: str) -> bool:
    """Collection names become file-name prefixes ("<collection>_<vid>.dat"),
    so anything that can traverse directories must be rejected before any
    path is built from caller input."""
    return ("/" not in name and "\\" not in name and ".." not in name
            and "\x00" not in name)


def _parse_volume_file_name(name: str) -> tuple[str, Optional[int]]:
    if "_" in name:
        collection, _, vid_str = name.rpartition("_")
    else:
        collection, vid_str = "", name
    try:
        return collection, int(vid_str)
    except ValueError:
        return "", None


class Store:
    def __init__(self, directories: list[str],
                 max_volume_counts: Optional[list[int]] = None,
                 coder_name: str = "auto",
                 geometry: ec_mod.Geometry = ec_mod.DEFAULT,
                 needle_map_kind: str = "memory",
                 min_free_space_percent: float = 1.0,
                 preallocate: int = 0,
                 geometry_policy: "ec_mod.GeometryPolicy | None" = None,
                 device: Optional[str] = None):
        # per-collection RS(k,m): explicit policy > WEED_EC_GEOMETRY env;
        # an explicit non-default `geometry` overrides the default entry
        policy = geometry_policy or ec_mod.GeometryPolicy.from_env()
        if geometry != ec_mod.DEFAULT:
            policy = ec_mod.GeometryPolicy(policy.per_collection, geometry)
        self.geometry_policy = policy
        self.geometry = policy.default
        self.coder_name = coder_name
        self.device = device
        self.needle_map_kind = needle_map_kind
        self.min_free_space_percent = min_free_space_percent
        self.preallocate = preallocate
        self.low_disk_space = False
        self._coders: dict[tuple[int, int], ErasureCoder] = {}
        counts = max_volume_counts or [8] * len(directories)
        self.locations = [DiskLocation(d, c, needle_map_kind)
                          for d, c in zip(directories, counts)]
        self._lock = threading.RLock()
        for loc in self.locations:
            loc.load_existing(self.coder, self._resolve_geometry)

    def check_free_space(self) -> bool:
        """The free-space watchdog (disk_location.go:304, statfs as in
        weed/stats/disk_supported.go): when a location's disk has less
        than min_free_space_percent free, its writable volumes seal;
        when space is back, only the seals the watchdog set lift (a seal
        set since, by an operator, an encode, a move or a tier upload,
        stays). Returns whether any location is low."""
        low_any = False
        for loc in self.locations:
            st = os.statvfs(loc.directory)
            free_pct = st.f_bavail / max(st.f_blocks, 1) * 100.0
            low = free_pct < self.min_free_space_percent
            low_any = low_any or low
            if low and not loc.low_space:
                loc.low_space = True
                for v in list(loc.volumes.values()):
                    v.watchdog_seal()
            elif not low and loc.low_space:
                loc.low_space = False
                for v in list(loc.volumes.values()):
                    v.lift_watchdog_seal()
        self.low_disk_space = low_any
        return low_any

    def coder(self, geometry: Optional[ec_mod.Geometry] = None
              ) -> ErasureCoder:
        """The store's coder for a geometry, made once per (k, m)."""
        g = geometry or self.geometry
        key = (g.data_shards, g.parity_shards)
        c = self._coders.get(key)
        if c is None:
            c = self._coders[key] = (
                self._maybe_mesh(g) or ec_mod.get_coder(
                    self.coder_name, g.data_shards, g.parity_shards,
                    device=self.device))
        return c

    def _maybe_mesh(self, g: ec_mod.Geometry) -> Optional[ErasureCoder]:
        """The MeshCoder that WEED_EC_MESH_DEVICES >= 2 lifts a card
        coder onto ("auto", and "torch" on a card), over that many cards
        clamped to the cards present, in the formulation the single coder
        would have; every encode and rebuild of this store then splits
        its batches over them. None keeps the single coder: no mesh asked
        for, an explicit "numpy" or "torch" on the CPU (they stay what
        was asked for), or a mesh that fails to build, which logs an error
        as the reference does (encode stays on the card and on the kernel,
        and the operator sees that the mesh is not there)."""
        on_card = self.coder_name == "auto" or (
            self.coder_name == "torch"
            and torch.device(self.device or "cuda").type == "cuda")
        n = mesh_coder.mesh_device_count() if on_card else 0
        if n < 2:
            return None
        try:
            return mesh_coder.MeshCoder(g.data_shards, g.parity_shards,
                                        n_devices=n)
        except Exception as e:
            log.error("WEED_EC_MESH_DEVICES asks for %d cards but the mesh "
                      "coder could not be built (%s: %s); keeping the "
                      "single-card coder", n, type(e).__name__, e)
            return None

    def geometry_for(self, collection: str = "") -> ec_mod.Geometry:
        """The policy geometry new encodes of this collection use."""
        return self.geometry_policy.for_collection(collection)

    def _resolve_geometry(self, base: str,
                          collection: str = "") -> ec_mod.Geometry:
        """The geometry an existing shard set was encoded under: the
        .ecm's stamped record when present (a policy change must never
        re-shape bytes already on disk), else the collection policy."""
        return read_marker_geometry(base) or self.geometry_for(collection)

    # --- volume management ---
    def find_volume(self, vid: int) -> Optional[Volume]:
        for loc in self.locations:
            v = loc.volumes.get(vid)
            if v is not None:
                return v
        return None

    def find_ec_volume(self, vid: int) -> Optional[EcVolume]:
        for loc in self.locations:
            ev = loc.ec_volumes.get(vid)
            if ev is not None:
                return ev
        return None

    def has_volume(self, vid: int) -> bool:
        return self.find_volume(vid) is not None

    def add_volume(self, vid: int, collection: str = "",
                   replica_placement: str = "000", ttl: str = "",
                   version: int = t.CURRENT_VERSION) -> Volume:
        """AllocateVolume (weed/server/volume_grpc_admin.go)."""
        with self._lock:
            if self.find_volume(vid) is not None:
                raise ValueError(f"volume {vid} already exists")
            open_locs = [loc for loc in self.locations
                         if len(loc.volumes) < loc.max_volume_count]
            if not open_locs:
                raise RuntimeError("no free volume slots")
            loc = min(open_locs, key=lambda loc: len(loc.volumes))
            sb = SuperBlock(
                version=version,
                replica_placement=ReplicaPlacement.parse(replica_placement),
                ttl=t.TTL.parse(ttl))
            v = Volume(loc.directory, collection, vid, superblock=sb,
                       create=True, needle_map_kind=self.needle_map_kind,
                       preallocate=self.preallocate)
            loc.volumes[vid] = v
            return v

    def delete_volume(self, vid: int) -> bool:
        with self._lock:
            for loc in self.locations:
                v = loc.volumes.pop(vid, None)
                if v is not None:
                    base = v.base_file_name()
                    v.close()
                    # the .sdx and a tiered volume's .vif go too: a
                    # .vif left behind would bring the volume back at
                    # the next start
                    for ext in (".dat", ".idx", ".swm", ".sdx", ".vif"):
                        if os.path.exists(base + ext):
                            os.remove(base + ext)
                    return True
        return False

    def mark_readonly(self, vid: int, read_only: bool = True) -> bool:
        v = self.find_volume(vid)
        if v is None:
            return False
        v.set_read_only(read_only)
        return True

    def unmount_volume(self, vid: int) -> bool:
        """Close a volume and drop it from serving; files stay on disk
        (VolumeUnmount, weed/server/volume_grpc_admin.go)."""
        with self._lock:
            for loc in self.locations:
                v = loc.volumes.pop(vid, None)
                if v is not None:
                    v.close()
                    return True
        return False

    def mount_volume(self, vid: int, collection: str = "") -> Volume:
        """Load an on-disk volume back into serving (VolumeMount); a
        tiered volume (a .vif, no local .dat) mounts too."""
        with self._lock:
            if self.find_volume(vid) is not None:
                raise ValueError(f"volume {vid} already mounted")
            prefix = f"{collection}_" if collection else ""
            for loc in self.locations:
                base = os.path.join(loc.directory, f"{prefix}{vid}")
                if os.path.exists(base + ".dat") or \
                        os.path.exists(backend_mod.vif_path(base)):
                    v = Volume(loc.directory, collection, vid,
                               needle_map_kind=self.needle_map_kind)
                    loc.volumes[vid] = v
                    return v
        raise KeyError(f"volume {vid} not found on disk")

    def _volume(self, vid: int) -> Volume:
        v = self.find_volume(vid)
        if v is None:
            raise KeyError(f"volume {vid} not found")
        return v

    def configure_replication(self, vid: int, replication: str) -> None:
        """Rewrite the superblock replica placement in place
        (VolumeConfigure, weed/server/volume_grpc_admin.go; superblock
        byte 1, super_block.go:12-31)."""
        self._volume(vid).configure_replication(
            ReplicaPlacement.parse(replication))

    # --- the object-store tier (volume_tier.go:15-50,
    #     volume_grpc_tier_upload.go / _download.go) ---
    def tier_upload(self, vid: int, backend_spec: dict) -> dict:
        """Move a volume's .dat to an object store; the .idx stays local
        and reads go through the store. The volume is sealed first (which
        supersedes a watchdog seal, and is refused during a compaction),
        and a `.vif` records where the .dat went, so the volume opens
        tiered after a restart. The local .dat's handle stays open until
        the volume closes, for reads that took it before the swap."""
        v = self._volume(vid)
        if v.is_remote:
            raise ValueError(f"volume {vid} is already tiered")
        was_read_only = v.read_only
        v.seal()
        base = v.base_file_name()
        try:
            store = backend_mod.open_store(backend_spec)
            key = f"{os.path.basename(base)}.dat"
            store.put(key, base + ".dat")
            size = os.path.getsize(base + ".dat")
            info = {"volume_id": vid, "version": v.version,
                    "files": [{"backend": store.spec(), "key": key,
                               "file_size": size,
                               "modified_at": int(os.path.getmtime(
                                   base + ".dat"))}]}
            backend_mod.save_volume_info(base, info)
        except BaseException:
            # the volume keeps taking writes if it did before
            if not was_read_only:
                v.set_read_only(False)
            raise
        with v._lock:
            v._retired_dat = v._dat
            v._dat = backend_mod.RemoteFile(store, key, size)
        os.remove(base + ".dat")
        return info

    def tier_download(self, vid: int) -> dict:
        """Bring a tiered volume's .dat back to local disk and drop the
        `.vif` (VolumeTierMoveDatFromRemote); the volume reopens from its
        local files, read-only as it was."""
        v = self._volume(vid)
        if not v.is_remote:
            raise ValueError(f"volume {vid} is not tiered")
        base = v.base_file_name()
        spec = backend_mod.load_volume_info(base)["files"][0]
        store = backend_mod.open_store(spec["backend"])
        store.get_to_file(spec["key"], base + ".dat")
        with self._lock:
            for loc in self.locations:
                if loc.volumes.get(vid) is v:
                    v.close()
                    os.remove(backend_mod.vif_path(base))
                    fresh = Volume(loc.directory, v.collection, vid,
                                   needle_map_kind=self.needle_map_kind)
                    fresh.set_read_only(True)
                    loc.volumes[vid] = fresh
                    break
        return {"volume_id": vid, "bytes": spec["file_size"]}

    def delete_expired_volumes(self, max_delay_minutes: int = 10
                               ) -> list[int]:
        """Drop the TTL volumes whose grace has passed
        (Store.DeleteExpiredVolumes)."""
        expired = [vid for loc in self.locations
                   for vid, v in list(loc.volumes.items())
                   if v.is_expired()
                   and v.is_expired_long_enough(max_delay_minutes)]
        for vid in expired:
            self.delete_volume(vid)
        return expired

    def needle_ids(self, vid: int) -> list[tuple[int, int]]:
        """Live (needle_id, size) pairs, of a volume or an EC volume (the
        inventory weed/shell/command_volume_fsck.go collects)."""
        v = self.find_volume(vid)
        if v is not None:
            return v.nm.live_entries()
        ev = self.find_ec_volume(vid)
        if ev is not None:
            return ev.live_entries()
        raise KeyError(f"volume {vid} not found")

    # --- vacuum (VacuumVolume{Check,Compact,Commit,Cleanup},
    #     weed/server/volume_grpc_vacuum.go) ---
    def vacuum_check(self, vid: int) -> float:
        return self._volume(vid).garbage_level()

    def vacuum_compact(self, vid: int,
                       compaction_bytes_per_second: int = 0) -> None:
        self._volume(vid).begin_compact(compaction_bytes_per_second)

    def vacuum_commit(self, vid: int) -> None:
        self._volume(vid).commit_compact()

    def vacuum_cleanup(self, vid: int) -> None:
        self._volume(vid).cleanup_compact()

    # --- needle ops ---
    def write_needle(self, vid: int, n: Needle) -> tuple[int, int, bool]:
        v = self.find_volume(vid)
        if v is None:
            raise KeyError(f"volume {vid} not found")
        return v.write_needle(n)

    def read_needle(self, vid: int, needle_id: int,
                    cookie: Optional[int] = None) -> Needle:
        v = self.find_volume(vid)
        if v is not None:
            return v.read_needle(needle_id, cookie=cookie)
        ev = self.find_ec_volume(vid)
        if ev is not None:
            try:
                return ev.read_needle(
                    needle_id, cookie=cookie,
                    shard_reader=self._remote_shard_reader(ev))
            except EcVolumeClosed:
                # a decode swapped the volume in since the lookup
                v = self.find_volume(vid)
                if v is None:
                    raise
                return v.read_needle(needle_id, cookie=cookie)
        raise KeyError(f"volume {vid} not found")

    def delete_needle(self, vid: int, n: Needle) -> int:
        v = self.find_volume(vid)
        if v is None:
            raise KeyError(f"volume {vid} not found")
        return v.delete_needle(n)

    # hook the volume server replaces to fetch shards from its peers
    def _remote_shard_reader(self, ev: EcVolume):
        return None

    # --- EC lifecycle (VolumeEcShardsGenerate etc.,
    #     weed/server/volume_grpc_erasure_coding.go) ---
    def _ec_seal(self, vid: int):
        """Seal a volume for encoding; returns (volume, base, geometry).
        A volume with an open compaction is refused (VolumeCompacting)."""
        v = self.find_volume(vid)
        if v is None:
            raise KeyError(f"volume {vid} not found")
        v.seal()
        return v, v.base_file_name(), self.geometry_for(v.collection)

    def _ec_finish_generate(self, v, base: str,
                            g: ec_mod.Geometry) -> list[int]:
        ec_mod.write_sorted_ecx_from_idx(base, offset_size=v.offset_size)
        # merge-only: the encode pass stamped every digest already
        ec_pipeline.stamp_shard_digests(base, g)
        return list(range(g.total_shards))

    def ec_generate(self, vid: int) -> list[int]:
        """Encode a volume into shard files through the streaming
        pipeline, under its collection's policy geometry (stamped into the
        .ecm for rebuild, mount and decode)."""
        v, base, g = self._ec_seal(vid)
        ec_pipeline.stream_encode(base, self.coder(g), g)
        return self._ec_finish_generate(v, base, g)

    def _seal_window(self, vids: list[int]) -> tuple[dict, list]:
        """Seal a window of volumes, grouped by geometry. The whole window
        is checked first: one missing vid fails the batch before anything
        is sealed, and a volume that refuses its seal lifts the seals
        applied before it."""
        absent = [vid for vid in vids if self.find_volume(vid) is None]
        if absent:
            raise KeyError(f"volume(s) {absent} not found")
        by_geometry: dict[ec_mod.Geometry, list] = {}
        sealed: list = []
        try:
            for vid in vids:
                was_read_only = self.find_volume(vid).read_only
                v, base, g = self._ec_seal(vid)
                by_geometry.setdefault(g, []).append((vid, v, base))
                sealed.append((v, base, was_read_only))
        except BaseException:
            self._unseal_uncommitted(sealed)
            raise
        return by_geometry, sealed

    @staticmethod
    def _unseal_uncommitted(sealed: list) -> None:
        """After a failed window: lift the seals this window applied on
        volumes whose shard set never committed (no .ecm), so the batch
        can be retried."""
        for v, base, was_read_only in sealed:
            if not was_read_only and not os.path.exists(base + ".ecm"):
                v.set_read_only(False)

    def ec_generate_many(self, vids: list[int]) -> dict[int, list[int]]:
        """Encode a window of volumes back to back: the volumes of one
        geometry stream through one governed operating point
        (pipeline.stream_encode_many)."""
        by_geometry, sealed = self._seal_window(vids)
        out: dict[int, list[int]] = {}
        try:
            for g, items in by_geometry.items():
                ec_pipeline.stream_encode_many(
                    [base for _, _, base in items], self.coder(g), g)
                for vid, v, base in items:
                    out[vid] = self._ec_finish_generate(v, base, g)
        except BaseException:
            self._unseal_uncommitted(sealed)
            raise
        return out

    # --- fused warm-down: compact + gzip + RS + digest in one pass ---

    def _ec_fused_promote(self, base: str, staging: str,
                          g: ec_mod.Geometry) -> None:
        """Move a finished fused pass's shard set from its staging base to
        the volume's base. Every staged file is fsynced already, so
        promotion is renames: shards first, then .ecx, and the .ecm marker
        last (its rename is the commit point that makes the set
        mountable). The compacted .dat/.idx were only the encode's
        vehicle and are dropped; the source volume files are untouched."""
        for i in range(g.total_shards):
            durable.replace_atomic(staging + ec_mod.to_ext(i),
                                   base + ec_mod.to_ext(i))
        durable.replace_atomic(staging + ".ecx", base + ".ecx")
        for ext in (".dat", ".idx"):
            try:
                os.remove(staging + ext)
            except OSError:
                pass
        durable.replace_atomic(staging + ".ecm", base + ".ecm")

    def _ec_fused_clean_staging(self, base: str,
                                g: ec_mod.Geometry) -> None:
        """Drop stale staging files a crashed earlier pass left behind
        (uncommitted by construction: no .ecm at the volume base)."""
        staging = base + ".fusing"
        for ext in ([".dat", ".idx", ".ecx", ".ecm"]
                    + [ec_mod.to_ext(i) for i in range(g.total_shards)]):
            try:
                os.remove(staging + ext)
            except OSError:
                pass

    def ec_fused_generate(self, vid: int) -> list[int]:
        """One-pass warm-down (ec/fused.py): compaction, payload gzip, RS
        encode and shard digests in a single pass. The shard set encodes
        the compacted volume, so tombstoned bytes never reach the warm
        tier. The output is promoted to the volume base only after the
        whole pass is durable."""
        v, base, g = self._ec_seal(vid)
        self._ec_fused_clean_staging(base, g)
        staging = base + ".fusing"
        ec_fused.fused_vacuum_gzip_encode(v, staging, self.coder(g), g)
        self._ec_fused_promote(base, staging, g)
        return list(range(g.total_shards))

    def ec_fused_generate_many(self, vids: list[int]) -> dict[int,
                                                              list[int]]:
        """Fused warm-down for a window of volumes: one governed operating
        point per geometry group, the fused twin of ec_generate_many."""
        by_geometry, sealed = self._seal_window(vids)
        out: dict[int, list[int]] = {}
        try:
            for g, items in by_geometry.items():
                for _, _, base in items:
                    self._ec_fused_clean_staging(base, g)
                ec_fused.fused_vacuum_gzip_encode_many(
                    [v for _, v, _ in items],
                    [base + ".fusing" for _, _, base in items],
                    self.coder(g), g)
                for vid, v, base in items:
                    self._ec_fused_promote(base, base + ".fusing", g)
                    out[vid] = list(range(g.total_shards))
        except BaseException:
            self._unseal_uncommitted(sealed)
            raise
        return out

    def ec_mount(self, vid: int, collection: str,
                 shard_ids: list[int]) -> list[int]:
        with self._lock:
            ev = self.find_ec_volume(vid)
            if ev is None:
                loc = self._location_with_ec_files(vid, collection)
                g = self._resolve_geometry(
                    self._base(loc, vid, collection), collection)
                ev = EcVolume(loc.directory, collection, vid, g,
                              coder=self.coder(g))
                loc.ec_volumes[vid] = ev
            return [sid for sid in shard_ids if ev.add_shard(sid)]

    @staticmethod
    def _base(loc: DiskLocation, vid: int, collection: str) -> str:
        prefix = f"{collection}_" if collection else ""
        return os.path.join(loc.directory, f"{prefix}{vid}")

    def _location_with_ec_files(self, vid: int, collection: str):
        for loc in self.locations:
            if os.path.exists(self._base(loc, vid, collection) + ".ecx"):
                return loc
        raise KeyError(f"no .ecx for volume {vid} in any location")

    def ec_unmount(self, vid: int, shard_ids: list[int]) -> list[int]:
        with self._lock:
            ev = self.find_ec_volume(vid)
            if ev is None:
                return []
            removed = [sid for sid in shard_ids if ev.delete_shard(sid)]
            if not ev.shard_ids():
                for loc in self.locations:
                    loc.ec_volumes.pop(vid, None)
                ev.close()
            return removed

    def ec_shard_read(self, vid: int, shard_id: int, offset: int,
                      size: int) -> bytes:
        ev = self.find_ec_volume(vid)
        if ev is None:
            raise KeyError(f"ec volume {vid} not found")
        shard = ev.shards.get(shard_id)
        if shard is None:
            raise KeyError(f"shard {vid}.{shard_id} not here")
        return shard.read_at(offset, size)

    def ec_rebuild(self, vid: int, collection: str = "") -> list[int]:
        """Regenerate the missing shard files from k survivors, fold the
        .ecj's deletes into the .ecx and stamp the rebuilt shards'
        digests. The geometry comes from the .ecm, not the live policy:
        rebuilding an RS(20,4) volume under a changed default would
        reconstruct garbage."""
        loc = self._location_with_ec_files(vid, collection)
        base = self._base(loc, vid, collection)
        g = self._resolve_geometry(base, collection)
        rebuilt = ec_pipeline.stream_rebuild(base, self.coder(g), g)
        ev = self.find_ec_volume(vid)
        ec_mod.rebuild_ecx_file(
            base, offset_size=(ev.offset_size if ev is not None
                               else t.OFFSET_SIZE))
        # merge-only: rebuilt shards get their digest recorded, stamped
        # ids keep the encode-time value
        ec_pipeline.stamp_shard_digests(base, g)
        return rebuilt

    def ec_blob_delete(self, vid: int, needle_id: int) -> None:
        ev = self.find_ec_volume(vid)
        if ev is None:
            raise KeyError(f"ec volume {vid} not found")
        ev.delete_needle(needle_id)

    def ec_delete_shards(self, vid: int, collection: str,
                         shard_ids: list[int]) -> None:
        self.ec_unmount(vid, shard_ids)
        for loc in self.locations:
            base = self._base(loc, vid, collection)
            for sid in shard_ids:
                p = base + ec_mod.to_ext(sid)
                if os.path.exists(p):
                    os.remove(p)

    def ec_to_volume(self, vid: int, collection: str = "") -> None:
        """ShardsToVolume: decode the local data shards back into a normal
        volume (weed/server/volume_grpc_erasure_coding.go:331-391)."""
        with self._lock:
            loc = self._location_with_ec_files(vid, collection)
            base = self._base(loc, vid, collection)
            ev0 = loc.ec_volumes.get(vid)
            w = ev0.offset_size if ev0 is not None else t.OFFSET_SIZE
            dat_size = ec_mod.find_dat_file_size(base, t.CURRENT_VERSION,
                                                 offset_size=w)
            ec_mod.write_dat_file(base, dat_size,
                                  self._resolve_geometry(base, collection))
            ec_mod.write_idx_file_from_ec_index(base, offset_size=w)
            # mount the decoded volume before the EC volume goes, as
            # upstream's ec.decode mounts before it unmounts the shards:
            # a read finds one or the other, never neither
            loc.volumes[vid] = Volume(
                loc.directory, collection, vid,
                needle_map_kind=self.needle_map_kind)
            ev = loc.ec_volumes.pop(vid, None)
            if ev is not None:
                ev.close()

    # --- heartbeat ---
    def heartbeat(self) -> dict:
        """The payload sent to the master (CollectHeartbeat,
        weed/storage/store.go:198). The volume server's handler threads
        change the maps while its heartbeat thread reads them: iterate
        over copies."""
        volumes = []
        ec_shards = []
        max_file_key = 0
        for loc in self.locations:
            for vid, v in list(loc.volumes.items()):
                max_file_key = max(max_file_key, v.nm.maximum_key)
                volumes.append({
                    "id": vid,
                    "collection": v.collection,
                    "size": v.data_file_size(),
                    "file_count": v.file_count(),
                    "delete_count": v.nm.deleted_count,
                    "deleted_bytes": v.nm.deleted_byte_count,
                    "read_only": v.read_only,
                    "replica_placement": str(
                        v.super_block.replica_placement),
                    "ttl": str(v.super_block.ttl),
                    "version": v.version,
                    # newest write (unix s): the master's TTL reference
                    "last_modified": v.last_modified_ts,
                })
            for vid, ev in list(loc.ec_volumes.items()):
                ec_shards.append({
                    "id": vid,
                    "collection": ev.collection,
                    "shard_ids": ev.shard_ids(),
                    "shard_size": ev.shard_size(),
                })
        return {
            "volumes": volumes,
            "ec_shards": ec_shards,
            "max_file_key": max_file_key,
            "max_volume_count": sum(loc.max_volume_count
                                    for loc in self.locations),
        }

    def status(self) -> dict:
        hb = self.heartbeat()
        return {"volumes": hb["volumes"], "ec_shards": hb["ec_shards"]}

    def close(self) -> None:
        for loc in self.locations:
            for v in loc.volumes.values():
                v.close()
            for ev in loc.ec_volumes.values():
                ev.close()
            loc.volumes.clear()
            loc.ec_volumes.clear()
