"""On-disk log segment + appender + sparse index.

Reference: src/v/storage/segment.{h,cc}, segment_appender.{h,cc},
segment_index.{h,cc}. A segment is a data file of serialized record
batches (internal 69-byte header + body, models.record), a sparse
offset→file-position index with timestamps, and explicit dirty/stable
offset tracking: `flush()` is the fsync boundary raft's flushed_offset
relies on (segment_appender.cc:174-215) — acks=all replies must never
precede it.

Differences from the reference are deliberate: buffered writes +
fsync instead of O_DIRECT DMA chunks (the host runtime is not
Seastar), and recovery rebuilds the index by re-scanning with CRC
verification (log_replayer analog) rather than trusting a separate
checkpoint.
"""

from __future__ import annotations

import asyncio
import bisect
import os
import struct

from ..models.record import (
    HEADER_SIZE,
    RecordBatch,
    RecordBatchHeader,
    peek_base_offset,
    peek_last_offset,
    peek_size_bytes,
)
from ..utils.crc import crc32c
from . import dirsync, file_sanitizer, iofaults

INDEX_INTERVAL_BYTES = 32 * 1024

# read_spans window slack beyond the caller's max_bytes: covers the
# partial batch straddling the budget boundary in the common case, so
# a 1 MiB fetch window stays ONE os.pread
_SPAN_SLACK = 128 * 1024

_IDX_MAGIC = 0x58444E49  # "INDX"
_IDX_HDR = struct.Struct("<II")
_IDX_ENTRY = struct.Struct("<IQq")


class _FdBudget:
    """Process-wide LRU cap on open segment file handles.

    RLIMIT_NOFILE is shared by every log on the shard; a 50k-group
    node holding one write handle (plus a cached pread fd) per active
    segment exhausts any sane limit. Handles are opened lazily, touched
    on use, and the least-recently-used segment's handles are closed
    when the budget is exceeded — closing flushes buffered bytes to the
    OS, so durability semantics (stable_offset advances only on fsync)
    are unchanged. Reference: the fd-bounded readers_cache + segment
    appender pool (src/v/storage/readers_cache.h:31,
    segment_appender.cc fallocation/handle management)."""

    def __init__(self) -> None:
        try:
            import resource

            soft, _hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        except Exception:  # pragma: no cover - non-posix fallback
            soft = 1024
        # leave half the limit for sockets, kvstores, snapshots, etc.
        self.limit = max(256, soft // 2)
        from collections import OrderedDict

        self._lru: "OrderedDict[int, Segment]" = OrderedDict()

    def touch(self, seg: "Segment") -> None:
        key = id(seg)
        lru = self._lru
        if key in lru:
            lru.move_to_end(key)
        else:
            lru[key] = seg
        spared: list[tuple[int, "Segment"]] = []
        while len(lru) + len(spared) > self.limit and lru:
            vkey, victim = lru.popitem(last=False)
            if victim is seg or victim._pins:
                spared.append((vkey, victim))  # in use: re-queue
                continue
            victim._release_handles()
        for vkey, victim in spared:
            lru[vkey] = victim
            lru.move_to_end(vkey, last=False)

    def drop(self, seg: "Segment") -> None:
        self._lru.pop(id(seg), None)


FD_BUDGET = _FdBudget()


class Segment:
    """One segment: data file + sparse index, append at tail only.

    File handles (append handle + cached pread fd) are opened lazily
    and subject to the global FD_BUDGET LRU — any method may find them
    closed and transparently reopen."""

    def __init__(self, directory: str, base_offset: int, term: int):
        self.base_offset = base_offset
        self.term = term
        self._dir = directory
        self._path = os.path.join(directory, f"{base_offset}-{term}.log")
        self._index_path = os.path.join(directory, f"{base_offset}-{term}.index")
        # sparse index: parallel arrays (offsets kept sorted)
        self._idx_offsets: list[int] = []
        self._idx_positions: list[int] = []
        self._idx_timestamps: list[int] = []
        self._bytes_since_index = INDEX_INTERVAL_BYTES  # force first entry
        self.dirty_offset = base_offset - 1  # last appended
        self.stable_offset = base_offset - 1  # last fsynced
        self.max_timestamp = -1
        self._rfd: int | None = None  # cached pread descriptor
        self._file = None  # lazy append handle (FD_BUDGET)
        self._pins = 0  # >0 while an executor fsync uses the fileno
        self._size = 0
        if os.path.exists(self._path):
            self._recover()
            self._size = os.path.getsize(self._path)
        else:
            # the file's existence is what marks this segment (and its
            # base offset) on reopen scans — create it eagerly even
            # though the append handle itself is lazy, and make the
            # dir entry durable: an fsynced segment whose NAME never
            # reached the platter vanishes whole on power loss
            open(self._path, "ab").close()
            dirsync.fsync_dir(directory)

    # -- fd budget ----------------------------------------------------
    def _wfile(self):
        if self._file is None:
            # unbuffered: append() hands the kernel header+body via one
            # writev — a Python-level buffer would just add a third
            # pass over the (cache-cold) batch bytes. In-situ cost per
            # 66 KB append: 194 us buffered → ~60 us writev.
            self._file = file_sanitizer.wrap(
                open(self._path, "ab", buffering=0), self._path
            )
        FD_BUDGET.touch(self)
        return self._file

    def _release_handles(self) -> None:
        """FD_BUDGET eviction: push buffered bytes to the OS and close.
        stable_offset is untouched — only flush()'s fsync advances it."""
        if self._file is not None:
            try:
                self._file.flush()
                self._file.close()
            except OSError:
                pass
            self._file = None
        self._drop_read_fd()

    # -- recovery (log_replayer analog: re-checksum the tail) --------
    def _recover(self) -> None:
        valid_end = 0
        with open(self._path, "rb") as f:
            data = f.read()
        pos = 0
        while pos + HEADER_SIZE <= len(data):
            try:
                header = RecordBatchHeader.unpack(data[pos : pos + HEADER_SIZE])
            except Exception:
                break
            if header.size_bytes < HEADER_SIZE or pos + header.size_bytes > len(data):
                break
            if header.header_crc != header.compute_header_crc():
                break
            batch = RecordBatch(header, data[pos + HEADER_SIZE : pos + header.size_bytes])
            if batch.compute_crc() != header.crc:
                break
            self._maybe_index(batch, pos)
            self.dirty_offset = header.last_offset
            self.max_timestamp = max(self.max_timestamp, header.max_timestamp)
            pos += header.size_bytes
            valid_end = pos
        if valid_end < len(data):
            with open(self._path, "r+b") as f:
                f.truncate(valid_end)
        self.stable_offset = self.dirty_offset

    # -- append path -------------------------------------------------
    def append(self, batch: RecordBatch) -> None:
        if batch.header.base_offset != self.dirty_offset + 1:
            raise ValueError(
                f"non-contiguous append: batch base {batch.header.base_offset}, "
                f"segment dirty {self.dirty_offset}"
            )
        h = batch.header
        h.size_bytes = batch.size_bytes()
        hdr = h.pack()
        self._maybe_index(batch, self._size)
        f = self._wfile()
        if file_sanitizer.enabled() or iofaults.active():
            # sanitizer/iofault proxies need the write to flow through
            # their `write`; one concat is fine in debug builds. Honor
            # short writes (FileIO may return a partial count; the
            # iofault short_write action deliberately does) — silently
            # absorbing one would advance dirty_offset past a torn
            # batch that recovery then truncates, losing acked data.
            data = hdr + batch.body
            n = f.write(data)
            while n is not None and n < len(data):
                data = data[n:]
                n = f.write(data)
        else:
            n = os.writev(f.fileno(), (hdr, batch.body))
            if n != len(hdr) + len(batch.body):  # short write (signal/ENOSPC)
                data = (hdr + batch.body)[n:]
                while data:
                    w = os.write(f.fileno(), data)
                    data = data[w:]
        self._size += h.size_bytes
        self.dirty_offset = batch.header.last_offset
        self.max_timestamp = max(self.max_timestamp, batch.header.max_timestamp)

    def append_verified_spans(self, span_list, batches) -> None:
        """Native fast-path handoff (utils/native.py append_frame):
        `span_list` holds wire-format [header|body] memoryviews whose
        CRCs, sizes, and contiguity were already verified in C, and
        `batches` the matching decoded RecordBatch objects for index
        bookkeeping. One writev lands them all; mirrors append()'s
        per-batch accounting without re-packing any header."""
        f = self._wfile()
        fd = f.fileno()
        total = sum(len(s) for s in span_list)
        n = os.writev(fd, span_list)
        if n != total:  # short write (signal/ENOSPC)
            data = b"".join(bytes(s) for s in span_list)[n:]
            while data:
                data = data[os.write(fd, data) :]
        pos = self._size
        for batch in batches:
            self._maybe_index(batch, pos)
            pos += batch.header.size_bytes
            if batch.header.max_timestamp > self.max_timestamp:
                self.max_timestamp = batch.header.max_timestamp
        self._size = pos
        self.dirty_offset = batches[-1].header.last_offset

    def _maybe_index(self, batch: RecordBatch, pos: int) -> None:
        if self._bytes_since_index >= INDEX_INTERVAL_BYTES:
            self._idx_offsets.append(batch.header.base_offset)
            self._idx_positions.append(pos)
            self._idx_timestamps.append(batch.header.first_timestamp)
            self._bytes_since_index = 0
        self._bytes_since_index += batch.size_bytes()

    def flush(self) -> int:
        """fsync; advances the stable (flushed) offset — the acks=all
        boundary."""
        if self.stable_offset >= self.dirty_offset and self._file is None:
            return self.stable_offset  # nothing unsynced: skip a reopen
        f = self._wfile()
        f.flush()
        os.fsync(f.fileno())
        self.stable_offset = self.dirty_offset
        return self.stable_offset

    async def flush_async(self) -> int:
        """fsync off the event loop so it keeps accepting appends
        while the disk syncs (segment_appender.cc background flush),
        coalesced ACROSS segments: concurrent flush rounds from many
        raft groups share one executor round trip
        (storage.flush_coalescer). Only bytes pushed to the OS before
        the fsync are counted: the stable offset advances to the dirty
        offset captured at call time, never past it."""
        from .flush_coalescer import FlushCoalescer

        if self.stable_offset >= self.dirty_offset and self._file is None:
            return self.stable_offset  # nothing unsynced: skip a reopen
        f = self._wfile()
        f.flush()  # python buffer → OS (loop thread, cheap)
        target = self.dirty_offset
        self._pins += 1  # hold the fileno against FD_BUDGET eviction
        try:
            await FlushCoalescer.get().fsync(f.fileno())
        finally:
            self._pins -= 1
        self.stable_offset = max(self.stable_offset, target)
        return self.stable_offset

    # -- read path ---------------------------------------------------
    def lower_bound_pos(self, offset: int) -> int:
        """File position of the last indexed batch at-or-before offset."""
        i = bisect.bisect_right(self._idx_offsets, offset) - 1
        return self._idx_positions[i] if i >= 0 else 0

    def _read_fd(self) -> int:
        """Cached O_RDONLY descriptor (readers_cache analog): reads go
        through positional os.pread — no seek state, so concurrent
        readers share one fd and repeated fetches skip the
        open/close-per-call syscall pair."""
        if self._rfd is None:
            self._rfd = os.open(self._path, os.O_RDONLY)
        FD_BUDGET.touch(self)
        return self._rfd

    def _drop_read_fd(self) -> None:
        if self._rfd is not None:
            try:
                os.close(self._rfd)
            except OSError:
                pass
            self._rfd = None

    def read_batches(
        self, start_offset: int, max_bytes: int = 1 << 30
    ) -> list[RecordBatch]:
        """Batches whose range intersects [start_offset, dirty]."""
        return self.read_batches_pos(start_offset, max_bytes)[0]

    def read_batches_pos(
        self,
        start_offset: int,
        max_bytes: int = 1 << 30,
        pos: int | None = None,
    ) -> tuple[list[RecordBatch], list[int]]:
        """(batches, file_pos_after_each) for [start_offset, dirty].
        `pos` is an exact file position of the batch containing
        start_offset — a positioned reader resuming where its last
        poll ended (readers_cache.h:31) skips the sparse-index
        scan-forward. The per-batch end positions let the Log cache a
        resume point at EVERY batch boundary of the window."""
        if self._file is not None:
            self._file.flush()
        out: list[RecordBatch] = []
        ends: list[int] = []
        consumed = 0
        fd = self._read_fd()
        if pos is None:
            pos = self.lower_bound_pos(start_offset)
        while consumed < max_bytes:
            hdr_bytes = os.pread(fd, HEADER_SIZE, pos)
            if len(hdr_bytes) < HEADER_SIZE:
                break
            header = RecordBatchHeader.unpack(hdr_bytes)
            body = os.pread(fd, header.size_bytes - HEADER_SIZE, pos + HEADER_SIZE)
            if len(body) < header.size_bytes - HEADER_SIZE:
                break
            pos += header.size_bytes
            if header.last_offset < start_offset:
                continue
            out.append(RecordBatch(header, body))
            ends.append(pos)
            consumed += header.size_bytes
        return out, ends

    def read_spans(
        self,
        start_offset: int,
        max_bytes: int = 1 << 20,
        pos: int | None = None,
    ) -> list[tuple]:
        """Raw batch spans intersecting [start_offset, dirty] as
        (header_view, span, end_pos) rows — the zero-copy twin of
        read_batches_pos: ONE os.pread covers the whole window and the
        header walk is memoryview slices + fixed-offset peeks; no
        RecordBatch objects, no per-batch syscall pair. An oversized
        batch (or a window that outgrows the slack) re-preads from the
        current batch boundary, so the syscall count stays O(window /
        (max_bytes + slack)), not O(batches)."""
        if self._file is not None:
            self._file.flush()
        fd = self._read_fd()
        if pos is None:
            pos = self.lower_bound_pos(start_offset)
        rows: list[tuple] = []
        consumed = 0

        def window(at: int, want: int) -> bytes:
            # cap the allocation at the tracked file size: a corrupt
            # size_bytes must not translate into a GB-sized buffer
            return os.pread(fd, min(want, max(self._size - at, 0)), at)

        win_pos = pos
        win = window(win_pos, max_bytes + _SPAN_SLACK)
        mv = memoryview(win)
        while consumed < max_bytes:
            rel = pos - win_pos
            size = (
                peek_size_bytes(win, rel)
                if rel + HEADER_SIZE <= len(win)
                else None
            )
            if size is not None and size < HEADER_SIZE:
                break  # corrupt length: stop like read_batches_pos
            if size is None or rel + size > len(win):
                # batch straddles the window end: slide to its boundary
                # (one follow-up pread; EOF shows up as a short read)
                win_pos = pos
                win = window(
                    win_pos,
                    max(max_bytes - consumed + _SPAN_SLACK, size or 0),
                )
                mv = memoryview(win)
                rel = 0
                if rel + HEADER_SIZE > len(win):
                    break
                size = peek_size_bytes(win, rel)
                if size < HEADER_SIZE or rel + size > len(win):
                    break
            pos += size
            if peek_last_offset(win, rel) < start_offset:
                continue
            rows.append(
                (mv[rel : rel + HEADER_SIZE], mv[rel : rel + size], pos)
            )
            consumed += size
        return rows

    def timequery(self, ts: int) -> int | None:
        """First indexed offset with timestamp >= ts (sparse — callers
        scan forward from it). Timestamps are non-decreasing in append
        order, so this is a bisect over the parallel timestamp array,
        not a linear scan."""
        i = bisect.bisect_left(self._idx_timestamps, ts)
        return self._idx_offsets[i] if i < len(self._idx_offsets) else None

    # -- truncation --------------------------------------------------
    def truncate(self, offset: int) -> None:
        """Drop everything at-or-after `offset` (suffix truncation used
        by raft on log-matching conflicts)."""
        if self._file is not None:
            self._file.flush()
        # seek to the last indexed batch strictly below the cut and
        # scan forward from there — a 128 MB segment truncated near its
        # tail touches ~32 KiB of header peeks, not the whole file
        i = bisect.bisect_left(self._idx_offsets, offset) - 1
        pos = self._idx_positions[i] if i >= 0 else 0
        keep_end = pos
        new_dirty = (
            self._idx_offsets[i] - 1 if i >= 0 else self.base_offset - 1
        )
        fd = os.open(self._path, os.O_RDONLY)
        try:
            size = os.path.getsize(self._path)
            while pos + HEADER_SIZE <= size:
                hdr = os.pread(fd, HEADER_SIZE, pos)
                if len(hdr) < HEADER_SIZE:
                    break
                if peek_base_offset(hdr) >= offset:
                    break
                bsize = peek_size_bytes(hdr)
                if bsize < HEADER_SIZE:
                    break  # corrupt length: keep what scanned clean
                pos += bsize
                keep_end = pos
                new_dirty = peek_last_offset(hdr)
        finally:
            os.close(fd)
        if self._file is not None:
            self._file.close()
            self._file = None  # lazily reopened via _wfile()
        self._drop_read_fd()  # pread fd may cache pages past the cut
        with open(self._path, "r+b") as f:
            f.truncate(keep_end)
            f.flush()
            os.fsync(f.fileno())
        self._size = keep_end
        self.dirty_offset = new_dirty
        self.stable_offset = min(self.stable_offset, new_dirty)
        # rebuild sparse index below the cut
        keep = bisect.bisect_left(self._idx_positions, keep_end)
        del self._idx_offsets[keep:], self._idx_positions[keep:], self._idx_timestamps[keep:]

    # -- index persistence (segment_index / index_state serde) --------
    def persist_index(self) -> None:
        body = bytearray()
        for o, p, t in zip(self._idx_offsets, self._idx_positions, self._idx_timestamps):
            body += _IDX_ENTRY.pack(o - self.base_offset, p, t)
        with open(self._index_path, "wb") as f:
            f.write(_IDX_HDR.pack(_IDX_MAGIC, len(self._idx_offsets)))
            f.write(body)
            f.write(struct.pack("<I", crc32c(bytes(body))))

    def size_bytes(self) -> int:
        return self._size

    def close(self) -> None:
        self.flush()
        self.persist_index()
        self._drop_read_fd()
        if self._file is not None:
            self._file.close()
            self._file = None
        FD_BUDGET.drop(self)

    def remove_files(self) -> None:
        self._drop_read_fd()
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
            self._file = None
        FD_BUDGET.drop(self)
        for p in (self._path, self._index_path):
            if os.path.exists(p):
                os.remove(p)

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"Segment(base={self.base_offset}, term={self.term}, "
            f"dirty={self.dirty_offset}, stable={self.stable_offset})"
        )
