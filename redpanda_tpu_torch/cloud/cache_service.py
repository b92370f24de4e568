"""Disk-backed chunk cache for tiered-storage reads.

Reference: src/v/cloud_storage/cache_service.{h,cc} (disk LRU with
access-time tracking and size-based trim) and the chunk-granular
hydration of src/v/cloud_storage/remote_segment.{h,cc} (segment_chunks:
only the byte ranges a read needs are downloaded, not whole segments).

Layout: one file per (object, chunk) under the cache directory, named
`<sha1(key)>_<chunk_index>`. An in-memory OrderedDict tracks LRU order
and sizes; on restart the directory is rescanned and ordered by mtime,
so a warm cache survives a broker reboot (cache_service.cc recovery).
Writes are tmp+rename so a crash never leaves a torn chunk visible.
"""

from __future__ import annotations

import asyncio
import hashlib
import os
from collections import OrderedDict
from typing import Awaitable, Callable, Optional

from .object_store import StoreError

DEFAULT_CHUNK = 1 << 20


class CloudCache:
    def __init__(
        self,
        directory: str,
        max_bytes: int = 1 << 30,
        chunk_size: int = DEFAULT_CHUNK,
        hydrate_timeout_s: float | None = 10.0,
    ):
        self.dir = directory
        self.max_bytes = max_bytes
        self.chunk_size = chunk_size
        # bound on each coalesced ranged fetch: a wedged object store
        # surfaces as a StoreError here instead of a reader parked
        # forever on the per-key hydration lock (and every follower
        # queued behind it)
        self.hydrate_timeout_s = hydrate_timeout_s
        # (key_hash, chunk_idx) -> size; order = LRU (oldest first)
        self._index: OrderedDict[tuple[str, int], int] = OrderedDict()
        self._bytes = 0
        self._lock = asyncio.Lock()  # guards _index/_bytes ONLY
        # per-key hydration locks: concurrent readers missing the same
        # chunks await one fetch instead of issuing duplicate GETs
        self._klocks: dict[str, asyncio.Lock] = {}
        self._klock_refs: dict[str, int] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        os.makedirs(self.dir, exist_ok=True)
        self._check_geometry()
        self._recover()

    # -- layout --------------------------------------------------------
    @staticmethod
    def _hash(key: str) -> str:
        return hashlib.sha1(key.encode()).hexdigest()

    def _path(self, kh: str, chunk: int) -> str:
        return os.path.join(self.dir, f"{kh}_{chunk}")

    def _check_geometry(self) -> None:
        """Chunk files are only meaningful at the chunk_size that wrote
        them — reinterpreting old files at a new size would serve wrong
        bytes. A geometry stamp detects the change and wipes the dir."""
        stamp = os.path.join(self.dir, "geometry")
        try:
            with open(stamp) as f:
                if int(f.read().strip()) == self.chunk_size:
                    return
        except (OSError, ValueError):
            if not os.listdir(self.dir):
                with open(stamp, "w") as f:
                    f.write(str(self.chunk_size))
                return
        for name in os.listdir(self.dir):
            if name != "geometry":
                try:
                    os.remove(os.path.join(self.dir, name))
                except OSError:
                    pass
        with open(stamp, "w") as f:
            f.write(str(self.chunk_size))

    def _recover(self) -> None:
        entries = []
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                try:
                    os.remove(os.path.join(self.dir, name))
                except OSError:
                    pass
                continue
            kh, _, idx = name.rpartition("_")
            if not kh or not idx.isdigit():
                continue  # geometry stamp and strays
            try:
                st = os.stat(os.path.join(self.dir, name))
            except OSError:
                continue
            entries.append((st.st_mtime, kh, int(idx), st.st_size))
        entries.sort()  # oldest first = least recently used
        for _mt, kh, idx, size in entries:
            self._index[(kh, idx)] = size
            self._bytes += size
        # the budget may have shrunk since the files were written
        self._trim_locked()

    # -- stats ---------------------------------------------------------
    @property
    def cached_bytes(self) -> int:
        return self._bytes

    def stats(self) -> dict:
        return {
            "bytes": self._bytes,
            "max_bytes": self.max_bytes,
            "chunks": len(self._index),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }

    # -- core ----------------------------------------------------------
    def _touch(self, ent: tuple[str, int]) -> None:
        self._index.move_to_end(ent)

    def _trim_locked(self) -> None:
        while self._bytes > self.max_bytes and len(self._index) > 1:
            (kh, idx), size = self._index.popitem(last=False)
            self._bytes -= size
            self.evictions += 1
            try:
                os.remove(self._path(kh, idx))
            except OSError:
                pass

    async def _store_chunk(self, kh: str, idx: int, data: bytes) -> None:
        path = self._path(kh, idx)
        tmp = path + f".{os.getpid()}.tmp"
        with open(tmp, "wb") as f:  # outside the lock: I/O-bound
            f.write(data)
        os.replace(tmp, path)
        ent = (kh, idx)
        async with self._lock:
            prev = self._index.pop(ent, 0)
            self._bytes -= prev
            self._index[ent] = len(data)
            self._bytes += len(data)
            self._trim_locked()

    async def _load_chunk(self, kh: str, idx: int) -> Optional[bytes]:
        ent = (kh, idx)
        async with self._lock:
            if ent not in self._index:
                return None
        try:
            with open(self._path(kh, idx), "rb") as f:  # outside lock
                data = f.read()
        except OSError:
            # evicted between the check and the read, or operator rm
            async with self._lock:
                self._bytes -= self._index.pop(ent, 0)
            return None
        async with self._lock:
            if ent in self._index:
                self._touch(ent)
        return data

    async def read(
        self,
        key: str,
        start: int,
        end: int,
        object_size: int,
        fetch_range: Callable[[int, int], Awaitable[bytes]],
    ) -> bytes:
        """Bytes [start, end) of `key`, assembling cached chunks and
        hydrating missing ones via fetch_range(chunk_start, chunk_end).
        Contiguous missing chunks coalesce into ONE ranged fetch (the
        reference hydrates chunk spans, not single chunks, to keep S3
        request counts down)."""
        end = min(end, object_size)
        if end <= start:
            return b""
        kh = self._hash(key)
        cs = self.chunk_size
        first, last = start // cs, (end - 1) // cs
        # fast path: fully cached — no hydration lock, so warm readers
        # never queue behind another reader's in-flight fetches
        parts: list[Optional[bytes]] = []
        for idx in range(first, last + 1):
            parts.append(await self._load_chunk(kh, idx))
        if all(p is not None for p in parts):
            self.hits += len(parts)
            buf = b"".join(parts)  # type: ignore[arg-type]
            lo = start - first * cs
            return buf[lo : lo + (end - start)]
        klock = self._klocks.get(kh)
        if klock is None:
            klock = self._klocks[kh] = asyncio.Lock()
        # refcount the lock while ANY coroutine holds a reference:
        # popping a lock another waiter already fetched would let a
        # third reader mint a fresh lock for the same key and hydrate
        # the same chunks twice (duplicate S3 range GETs)
        self._klock_refs[kh] = self._klock_refs.get(kh, 0) + 1
        try:
            async with klock:
                parts = await self._hydrate_locked(
                    kh, key, first, last, cs, object_size, fetch_range,
                    parts,
                )
        finally:
            refs = self._klock_refs.get(kh, 1) - 1
            if refs <= 0:
                self._klock_refs.pop(kh, None)
                if len(self._klocks) > 512:
                    self._klocks.pop(kh, None)
            else:
                self._klock_refs[kh] = refs
        buf = b"".join(parts)  # type: ignore[arg-type]
        lo = start - first * cs
        return buf[lo : lo + (end - start)]

    async def _hydrate_locked(
        self, kh, key, first, last, cs, object_size, fetch_range, warm
    ):
        """Chunk hydration under the per-key lock: re-probe only the
        chunks the lock-free pass missed (bytes already loaded there
        stay valid even if since-evicted; an in-flight hydrator may
        have filled the gaps while we queued), fetch+store the rest."""
        parts = []
        for k, idx in enumerate(range(first, last + 1)):
            data = warm[k]
            if data is None:
                data = await self._load_chunk(kh, idx)
            if data is None:
                self.misses += 1
            else:
                self.hits += 1
            parts.append(data)
        i = 0
        while i < len(parts):
            if parts[i] is not None:
                i += 1
                continue
            j = i
            while j < len(parts) and parts[j] is None:
                j += 1
            lo = (first + i) * cs
            hi = min((first + j) * cs, object_size)
            try:
                if self.hydrate_timeout_s is None:
                    blob = await fetch_range(lo, hi)
                else:
                    blob = await asyncio.wait_for(
                        fetch_range(lo, hi), timeout=self.hydrate_timeout_s
                    )
            except asyncio.TimeoutError:
                raise StoreError(
                    f"hydration of {key} [{lo},{hi}) timed out after "
                    f"{self.hydrate_timeout_s:.1f}s"
                ) from None
            if len(blob) != hi - lo:
                # truncated object (manifest size_bytes > stored
                # size): StoreError so the remote read path degrades
                # per partition instead of aborting the whole fetch
                raise StoreError(
                    f"ranged fetch of {key} [{lo},{hi}) returned "
                    f"{len(blob)} bytes"
                )
            for k in range(i, j):
                off = (k - i) * cs
                chunk = blob[off : off + cs]
                await self._store_chunk(kh, first + k, chunk)
                parts[k] = chunk
            i = j
        return parts

    async def invalidate(self, key: str) -> None:
        """Drop every chunk of `key` (segment re-uploaded/merged away)."""
        kh = self._hash(key)
        async with self._lock:
            for ent in [e for e in self._index if e[0] == kh]:
                self._bytes -= self._index.pop(ent)
                try:
                    os.remove(self._path(*ent))
                except OSError:
                    pass

    async def invalidate_range(self, key: str, start: int, end: int) -> None:
        """Drop the chunks covering bytes [start, end) of `key` —
        poisoned-chunk hygiene: when a reader finds a CRC mismatch in
        hydrated bytes, the cached chunks that served them must go, or
        every retry re-reads the same corruption from disk."""
        if end <= start:
            return
        kh = self._hash(key)
        cs = self.chunk_size
        first, last = start // cs, (end - 1) // cs
        async with self._lock:
            for idx in range(first, last + 1):
                ent = (kh, idx)
                if ent in self._index:
                    self._bytes -= self._index.pop(ent)
                    try:
                        os.remove(self._path(kh, idx))
                    except OSError:
                        pass
