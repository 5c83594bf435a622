"""Deferred, coalesced record writes (the workspace's buffering layer), the
port's copy of the reference's ``repro.workspace.buffer``.

A :class:`WriteBuffer` is the context-managed middle layer between the
campaign machinery and the store: ``put`` calls inside the context collect
in memory and flush as **one** journal append when the context exits — so a
1000-point sweep campaign costs O(1) filesystem writes instead of O(P·K),
the same reason signac's buffered collections exist (its
``SharedMemoryFileBufferedCollection`` protocol: share the in-memory store,
defer all I/O, integrity-check the backing file on flush).

Integrity is mtime/size-based, like signac's: entering the context records
the journal's ``(st_size, st_mtime_ns)`` signature; the flush re-stats and
raises :class:`~.store.WorkspaceConflictError` if another
writer appended in between — deferred writes must never silently clobber or
interleave with a concurrent campaign.

Failure semantics are deliberately transactional: if the body raises, the
buffer is **discarded**, not flushed — a crashed chunk leaves no partial
records, and a resumed campaign recomputes exactly that chunk.  Reads
through the buffer (``get``/``in``) see the deferred records immediately,
so within-context code observes its own writes.
"""
from __future__ import annotations

import os
from typing import Optional

from .store import (RunKey, RunRecord, WorkspaceConflictError,
                                   WorkspaceStore)


def _signature(path) -> Optional[tuple]:
    """``(st_size, st_mtime_ns)`` of a file, or None when absent.  Size is
    part of the signature because same-tick appends can leave mtime
    unchanged on coarse-granularity filesystems."""
    try:
        st = os.stat(path)
    except FileNotFoundError:
        return None
    return (st.st_size, st.st_mtime_ns)


class WriteBuffer:
    """Deferred write view of one campaign journal.  Use via
    ``with store.buffered("my-campaign") as buf: buf.put(...)``."""

    def __init__(self, store: WorkspaceStore, campaign: str = "default"):
        self.store = store
        self.campaign = campaign
        self._pending: dict[str, RunRecord] = {}
        self._entry_sig: Optional[tuple] = None
        self._active = False
        self.flushes = 0

    # -- context protocol ----------------------------------------------------
    def __enter__(self) -> "WriteBuffer":
        # validates the campaign name early, before any work is buffered
        self._entry_sig = _signature(self.store.journal_path(self.campaign))
        self._active = True
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._active = False
        if exc_type is not None:
            self._pending.clear()        # transactional: discard, don't flush
            return
        self.flush()

    # -- deferred writes -----------------------------------------------------
    def put(self, record: RunRecord) -> RunKey:
        if not self._active:
            raise RuntimeError(
                "WriteBuffer.put outside its context; use "
                "'with store.buffered(name) as buf: buf.put(...)'")
        self._pending[record.key.key_hash] = record
        return record.key

    def get(self, key: RunKey) -> Optional[RunRecord]:
        """Buffered records first (read-your-writes), then the store."""
        rec = self._pending.get(key.key_hash)
        return rec if rec is not None else self.store.get(key)

    def __contains__(self, key: RunKey) -> bool:
        return key.key_hash in self._pending or key in self.store

    def __len__(self) -> int:
        return len(self._pending)

    # -- flush ---------------------------------------------------------------
    def flush(self) -> int:
        """Coalesce every pending record into one journal append (a single
        filesystem write), after the integrity check.  Returns how many
        records were flushed."""
        if not self._pending:
            return 0
        path = self.store.journal_path(self.campaign)
        if _signature(path) != self._entry_sig:
            pending = len(self._pending)
            self._pending.clear()
            raise WorkspaceConflictError(
                f"journal {path.name} changed while {pending} record(s) "
                f"were buffered (another writer?); buffered data discarded "
                f"— re-run the campaign, it will recompute only what is "
                f"missing")
        records = list(self._pending.values())
        self._pending.clear()
        self.store.journal_append(self.campaign, records)
        self._entry_sig = _signature(path)
        self.flushes += 1
        return len(records)
