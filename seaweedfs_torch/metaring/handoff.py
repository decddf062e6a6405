"""HandoffRunner: background partition migration on ring changes.

The port's reduced copy of seaweedfs_tpu/metaring/handoff.py. When a
peer joins or leaves the ring, some directories' replica sets change and
their entries must reach the new members. The runner walks the LOCAL
store's directories (``FilerStore.iter_directories``: a walk from the
root cannot see subtrees whose parents live on other peers), pushes
every entry of a directory whose set changed to its new replica set as
replica upserts, and drops the local copies where this peer left the
set, metadata only (the entries carry their chunk lists; no chunk byte
moves on the volume servers).

Directories are walked in sorted order and the last one fully moved is
kept in the store's KV face under ``ring_handoff/v<version>`` as
``{"dir": ...}``, so a restarted pass resumes after that low watermark
instead of pushing everything again (a push is an idempotent upsert
anyway: the watermark bounds wasted work, not correctness). The
``ring.handoff`` fault point fails a move, the drill of a runner that
dies mid-pass. A pass cancelled after a directory's pushes ends only once
that directory is dropped, counted and watermarked (the reference's can
stop between its drop and its watermark, so a resumed pass finds the
directory gone without having counted it). A directory's pushes go out
``PUSHES_IN_FLIGHT`` at a time
(the reference sends them one by one; each is an upsert of its own
entry, so their order within the directory does not matter). Left out
with the overload plane: the pushes' background priority class.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Optional

from .. import faults
from ..lifecycle import jittered
from .ring import DirectoryRing

log = logging.getLogger("metaring.handoff")

# entries read from the local store at a time
PAGE = 512
# a directory's pushes in flight at once
PUSHES_IN_FLIGHT = 16


def offset_key(version: int) -> str:
    """The KV key of ring version `version`'s low watermark."""
    return f"ring_handoff/v{version}"


def read_watermark(store, version: int) -> str:
    """The last directory a pass for `version` moved, "" if none."""
    raw = store.kv_get(offset_key(version))
    if not raw:
        return ""
    try:
        return json.loads(raw.decode()).get("dir", "")
    except ValueError:
        return ""


class HandoffRunner:
    def __init__(self, filer_server, router):
        self.fs = filer_server
        self.router = router
        self.moved_entries = 0
        self.moved_dirs = 0
        self.last_error = ""
        self.state = "idle"
        self._task: Optional[asyncio.Task] = None

    # --- trigger (a ring change) ---
    def trigger(self, ring: DirectoryRing,
                old_ring: Optional[DirectoryRing] = None) -> None:
        """Start a pass for this ring view; a pass still running for an
        older view is cancelled (its watermark stays, but the new
        membership decides ownership)."""
        if self._task is not None and not self._task.done():
            self._task.cancel()
        # running from here on, so no reader takes an older pass's
        # "done" for this one's
        self.state = "running"
        self._task = asyncio.create_task(self._run_logged(ring, old_ring))

    async def _run_logged(self, ring, old_ring) -> None:
        try:
            await self.run_once(ring, old_ring)
        except Exception:
            pass  # run_once recorded it in state and last_error

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            await asyncio.gather(self._task, return_exceptions=True)
            self._task = None

    # --- one resumable pass ---
    async def run_once(self, ring: DirectoryRing,
                       old_ring: Optional[DirectoryRing] = None) -> int:
        """Re-home every local directory whose replica set changed: its
        entries go to the new members (a joiner that became owner gets
        them even when this peer stays on as successor), and the local
        copies go only where this peer left the set. Returns the
        directories moved."""
        self.state = "running"
        self.last_error = ""
        store = self.fs.filer.store
        key = offset_key(ring.version)
        loop = asyncio.get_running_loop()
        watermark = await loop.run_in_executor(
            None, read_watermark, store, ring.version)
        moved_dirs = 0
        try:
            dirs = sorted(await loop.run_in_executor(
                None, lambda: list(store.iter_directories())))
            for d in dirs:
                if watermark and d <= watermark:
                    continue
                new_set = ring.owners(d)
                stray = self.router.self_url not in new_set
                # a directory this peer stays a replica of moves only when
                # the before view shows another set (the diff is an
                # optimization); a stray always moves, even when the diff
                # shows no change: a cancelled earlier pass may have left
                # it on a peer the ring never routes to again
                if not stray and (old_ring is None
                                  or old_ring.owners(d) == new_set):
                    continue
                await self._push_directory(d, ring)
                # once its entries are pushed, the directory's drop, its
                # count and the watermark (everything <= d is done for
                # this version) finish together: a pass cancelled
                # meanwhile ends after them, so it never leaves a dropped
                # directory behind its watermark
                settle = asyncio.ensure_future(
                    self._settle(store, d, stray, key))
                try:
                    await asyncio.shield(settle)
                except asyncio.CancelledError:
                    await settle
                    raise
                moved_dirs += 1
                # a fleet-wide ring change must not push in lockstep
                await asyncio.sleep(jittered(0.01))
            self.state = "done"
        except asyncio.CancelledError:
            self.state = "cancelled"
            raise
        except Exception as e:
            self.state = "failed"
            self.last_error = str(e)
            log.warning("ring handoff (v%d) failed after %d dirs: %r",
                        ring.version, moved_dirs, e)
            raise
        return moved_dirs

    async def _settle(self, store, d: str, drop: bool, key: str) -> None:
        loop = asyncio.get_running_loop()
        if drop:
            # the local copies go metadata-only: freeing chunks here would
            # tear the bytes from under the moved entries
            await loop.run_in_executor(None, _drop_local_children, store, d)
        self.moved_dirs += 1
        await loop.run_in_executor(None, store.kv_put, key,
                                   json.dumps({"dir": d}).encode())

    async def _push_directory(self, d: str, ring: DirectoryRing) -> None:
        if await faults.fire_async("ring.handoff"):
            raise ConnectionResetError(f"injected ring.handoff drop at {d}")
        store = self.fs.filer.store
        loop = asyncio.get_running_loop()
        targets = [p for p in ring.owners(d) if p != self.router.self_url]
        slots = asyncio.Semaphore(PUSHES_IN_FLIGHT)

        async def push(e) -> None:
            # a replica upsert on every current replica: idempotent, so a
            # resumed pass that pushes the watermark directory again does
            # no harm
            body = {"entry": json.loads(e.to_json()), "o_excl": False,
                    "signatures": [], "free_old_chunks": False}
            async with slots:
                answers = await asyncio.gather(*[self.router.request(
                    peer, "POST", "/__meta__/create_entry", body=body,
                    replica=True, idempotent=True) for peer in targets])
            for peer, (status, _) in zip(targets, answers):
                if status >= 400:
                    raise RuntimeError(f"handoff upsert {e.full_path} -> "
                                       f"{peer}: HTTP {status}")
            self.moved_entries += 1

        start = ""
        while True:
            batch = await loop.run_in_executor(
                None, lambda s=start: store.list_directory_entries(
                    d, s, False, PAGE))
            if not batch:
                break
            results = await asyncio.gather(*[push(e) for e in batch],
                                           return_exceptions=True)
            failed = [r for r in results if isinstance(r, BaseException)]
            if failed:
                raise failed[0]
            if len(batch) < PAGE:
                break
            start = batch[-1].name

    def status(self) -> dict:
        return {"state": self.state, "moved_dirs": self.moved_dirs,
                "moved_entries": self.moved_entries,
                "last_error": self.last_error}


def _drop_local_children(store, d: str) -> None:
    """Remove the local copies of one handed-off directory's children
    (entries only, never the subtree: deeper directories may still be
    owned here, and the walk judges each on its own)."""
    while True:
        batch = store.list_directory_entries(d, "", False, PAGE)
        if not batch:
            return
        for e in batch:
            store.delete_entry(e.full_path)
        if len(batch) < PAGE:
            return
