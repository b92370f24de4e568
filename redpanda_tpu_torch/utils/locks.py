"""Per-key asyncio lock registry with a lifecycle.

The pattern this replaces — `self._locks.setdefault(key, asyncio.Lock())`
scattered over call sites — works (dict.setdefault is atomic on one
event loop) but has no story for the rest of the lock's life: entries
accumulate forever as keys churn (one lock per peer / tx-id /
partition-id), and teardown cannot tell a parked lock from one a
coroutine still holds. `LockMap` centralizes get-or-create and adds
exactly that lifecycle: `discard`/`prune` refuse to drop a held lock,
`clear` refuses to wipe a map with holders, and `held()` names the
keys still in use so shutdown bugs surface as a key list instead of a
hung await.

Single-event-loop discipline, like everything here: all methods are
sync and therefore loop-atomic; only awaiting the returned lock
suspends.
"""

from __future__ import annotations

import asyncio
from typing import Hashable, Iterable, Optional


class LockMap:
    """Registry of per-key `asyncio.Lock`s (see module docstring)."""

    __slots__ = ("_locks",)

    def __init__(self) -> None:
        self._locks: dict[Hashable, asyncio.Lock] = {}

    def lock(self, key: Hashable) -> asyncio.Lock:
        """Get-or-create the lock for `key` (sync, so loop-atomic:
        two coroutines racing the first access get the same lock)."""
        lk = self._locks.get(key)
        if lk is None:
            lk = self._locks[key] = asyncio.Lock()
        return lk

    def locked(self, key: Hashable) -> bool:
        """True if `key`'s lock exists and is currently held."""
        lk = self._locks.get(key)
        return lk is not None and lk.locked()

    def held(self) -> list:
        """Keys whose locks are currently held, sorted for stable
        shutdown diagnostics."""
        return sorted(
            (k for k, lk in self._locks.items() if lk.locked()),
            key=repr,
        )

    def discard(self, key: Hashable) -> bool:
        """Drop `key`'s lock if it exists and is not held. Returns
        True if an entry was removed; raises RuntimeError rather than
        yank a lock out from under its holder."""
        lk = self._locks.get(key)
        if lk is None:
            return False
        if lk.locked():
            raise RuntimeError(f"LockMap.discard({key!r}): lock is held")
        del self._locks[key]
        return True

    def prune(self, keep: Optional[Iterable[Hashable]] = None) -> int:
        """Drop every unheld lock (not in `keep`, when given); returns
        the number removed. Held locks always survive — the holder's
        critical section stays intact and the entry is reclaimed on a
        later prune."""
        keep_set = None if keep is None else set(keep)
        dead = [
            k
            for k, lk in self._locks.items()
            if not lk.locked() and (keep_set is None or k not in keep_set)
        ]
        for k in dead:
            del self._locks[k]
        return len(dead)

    def clear(self) -> None:
        """Teardown: drop every entry, refusing (RuntimeError naming
        the keys) if any lock is still held."""
        held = self.held()
        if held:
            raise RuntimeError(f"LockMap.clear(): locks held for {held!r}")
        self._locks.clear()

    def __len__(self) -> int:
        return len(self._locks)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._locks

    def keys(self):
        return self._locks.keys()

    def __repr__(self) -> str:
        return f"LockMap({len(self._locks)} keys, {len(self.held())} held)"
