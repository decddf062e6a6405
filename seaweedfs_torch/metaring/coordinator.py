"""FanoutCoordinator: recursive namespace ops across ring partitions.

The port's copy of seaweedfs_tpu/metaring/coordinator.py. A recursive
delete or a cross-partition rename touches directories that different
peers own (each directory's children live on its owner), so the subtree
walk hops the ring. The per-directory work fans out over a few lanes;
the work of one directory hashes to one lane and runs in order, so one
path's create, overwrite and delete never land out of order, while
different directories run at once.

The walk orders the structure itself: a directory's children are
deleted (and drained) before its own entry, so a crash mid-delete leaves
complete subtrees missing and never a child under a deleted parent. A
rename creates each entry at its new owner (the same chunk list: bytes
never move) before it deletes the old one metadata-only, so a crash
leaves a double entry and never a lost one.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable

from ..filer.entry import Entry

# entries a page of a directory walk asks for
PAGE = 1024


class FanoutCoordinator:
    """``ops`` is the filer server's ring face: ``ring_list``,
    ``ring_delete``, ``ring_create`` and ``ring_find`` coroutines that
    route to the owner and mirror to the replicas."""

    def __init__(self, ops, workers: int = 4):
        self.ops = ops
        self.workers = max(1, workers)

    async def _run_grouped(self, jobs: list[tuple[str, Callable[[],
                                                  Awaitable[None]]]]
                           ) -> None:
        """(directory, thunk) jobs: one directory's in order on one lane,
        different directories at once on the lanes."""
        lanes: list[list] = [[] for _ in range(self.workers)]
        for directory, thunk in jobs:
            lanes[hash(directory) % self.workers].append(thunk)

        async def drain(lane) -> None:
            for thunk in lane:
                await thunk()

        results = await asyncio.gather(
            *[drain(lane) for lane in lanes if lane],
            return_exceptions=True)
        for r in results:
            if isinstance(r, BaseException):
                raise r

    # --- recursive delete across partitions ---
    async def delete_subtree(self, path: str, free_chunks: bool = True,
                             signatures: tuple = ()) -> int:
        """Delete a directory subtree whose directories other peers may
        own, bottom up: each directory's files on its owner (which frees
        their chunks), the subdirectories first, the directory's own
        entry (on its parent's owner) last. Returns the entries
        deleted."""
        deleted = await self._delete_children(path, free_chunks,
                                              signatures)
        await self.ops.ring_delete(path, recursive=True,
                                   free_chunks=free_chunks,
                                   signatures=signatures)
        return deleted + 1

    async def _delete_children(self, dir_path: str, free_chunks: bool,
                               signatures: tuple) -> int:
        deleted = 0
        while True:
            # each page processed is deleted, so the next page is always
            # the first again
            batch = await self.ops.ring_list(dir_path, limit=PAGE)
            if not batch:
                break
            jobs = [(dir_path, self._delete_one(e.full_path, free_chunks,
                                                signatures))
                    for e in batch if not e.is_directory]
            for e in batch:
                if e.is_directory:
                    deleted += await self.delete_subtree(
                        e.full_path, free_chunks=free_chunks,
                        signatures=signatures)
            await self._run_grouped(jobs)
            deleted += len(jobs)
            if len(batch) < PAGE:
                break
        return deleted

    def _delete_one(self, path: str, free_chunks: bool,
                    signatures: tuple):
        async def run() -> None:
            try:
                await self.ops.ring_delete(path, recursive=False,
                                           free_chunks=free_chunks,
                                           signatures=signatures)
            except FileNotFoundError:
                pass  # a retried page deleted it already
        return run

    # --- cross-partition rename ---
    async def rename(self, old_path: str, new_path: str) -> int:
        """Move old_path to new_path across partitions; returns the
        entries moved."""
        entry = await self.ops.ring_find(old_path)
        if entry is None:
            raise FileNotFoundError(old_path)
        return await self._move_entry(entry, new_path)

    async def _move_entry(self, entry: Entry, new_path: str) -> int:
        moved = 1
        await self.ops.ring_create(_moved(entry, new_path),
                                   free_old_chunks=False)
        if entry.is_directory:
            start = ""
            while True:
                batch = await self.ops.ring_list(entry.full_path,
                                                 start=start, limit=PAGE)
                if not batch:
                    break
                files = [e for e in batch if not e.is_directory]
                await self._run_grouped([
                    (entry.full_path,
                     self._move_file(e, f"{new_path}/{e.name}"))
                    for e in files])
                moved += len(files)
                for e in batch:
                    if e.is_directory:
                        moved += await self._move_entry(
                            e, f"{new_path}/{e.name}")
                if len(batch) < PAGE:
                    break
                start = batch[-1].name
        # the old side goes metadata-only: the chunks belong to the new
        # path now
        await self.ops.ring_delete(entry.full_path, recursive=False,
                                   free_chunks=False)
        return moved

    def _move_file(self, entry: Entry, new_path: str):
        async def run() -> None:
            await self.ops.ring_create(_moved(entry, new_path),
                                       free_old_chunks=False)
            try:
                await self.ops.ring_delete(entry.full_path,
                                           recursive=False,
                                           free_chunks=False)
            except FileNotFoundError:
                pass
        return run


def _moved(entry: Entry, new_path: str) -> Entry:
    return Entry(full_path=new_path, attr=entry.attr, chunks=entry.chunks,
                 extended=entry.extended, hard_link_id=entry.hard_link_id)
