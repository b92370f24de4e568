"""The per-partition log (reference: src/v/storage/disk_log_impl.{h,cc}).

Segment list + active appender with: offset assignment, size-based
rolling (disk_log_impl.cc:1112), flush tracking (the acks=all fsync
boundary), suffix truncation (raft log-matching conflicts), prefix
truncation (retention / snapshots), offset/term/timestamp queries, and
batch-cache-served reads with CRC-verified disk fallback
(log_reader + parser analog).
"""

from __future__ import annotations

import os
import time

from ..models.record import RecordBatch, WireSpan, span_to_wire
from . import dirsync, file_sanitizer
from .batch_cache import BatchCache, BatchCacheIndex
from .segment import Segment


class LogConfig:
    def __init__(
        self,
        segment_max_bytes: int = 128 * 1024 * 1024,
        retention_bytes: int | None = None,
        retention_ms: int | None = None,
        cleanup_policy: str = "delete",
        max_compacted_segment_bytes: int = 256 * 1024 * 1024,
        local_retention_bytes: int | None = None,
        local_retention_ms: int | None = None,
    ):
        self.segment_max_bytes = segment_max_bytes
        self.retention_bytes = retention_bytes
        self.retention_ms = retention_ms
        # tiered topics (Redpanda semantics): retention.* bounds the
        # TOTAL (cloud) history; retention.local.target.* bounds the
        # locally-kept suffix. Non-tiered topics ignore the local pair.
        self.local_retention_bytes = local_retention_bytes
        self.local_retention_ms = local_retention_ms
        # "delete", "compact", or "compact,delete" (Kafka cleanup.policy)
        self.cleanup_policy = cleanup_policy
        # adjacent-merge budget for compacted segments — deliberately
        # independent of segment_max_bytes (the reference's
        # max_compacted_log_segment_size), so heavily-deduped small
        # segments coalesce even when segment.bytes is small
        self.max_compacted_segment_bytes = max(
            max_compacted_segment_bytes, segment_max_bytes
        )

    @property
    def compaction_enabled(self) -> bool:
        return "compact" in self.cleanup_policy

    @property
    def deletion_enabled(self) -> bool:
        return "delete" in self.cleanup_policy

    @staticmethod
    def from_topic_config(config: dict) -> "LogConfig":
        """Map Kafka topic configs onto storage knobs (the reference
        threads these through cluster::topic_properties into
        storage::ntp_config)."""

        def _int(key: str) -> int | None:
            v = config.get(key)
            if v is None:
                return None
            try:
                n = int(v)
            except (TypeError, ValueError):
                return None
            return n if n >= 0 else None  # -1 = unlimited

        out = LogConfig()
        seg = _int("segment.bytes")
        if seg:
            out.segment_max_bytes = seg
        mcs = _int("max.compacted.segment.bytes")
        if mcs:
            out.max_compacted_segment_bytes = mcs
        out.retention_bytes = _int("retention.bytes")
        out.retention_ms = _int("retention.ms")
        out.local_retention_bytes = _int("retention.local.target.bytes")
        out.local_retention_ms = _int("retention.local.target.ms")
        policy = config.get("cleanup.policy")
        if policy:
            out.cleanup_policy = str(policy)
        return out


def retention_drop_upto(
    entries: "list[tuple[int, int, int]]",
    retention_bytes: int | None,
    retention_ms: int | None,
    now_ms: int | None,
) -> int | None:
    """Shared size/time retention rule over (size_bytes,
    max_timestamp, last_offset) rows oldest-first, never dropping the
    newest row. Returns the last offset of the last dropped row, or
    None. Used by the local log AND the archiver's cloud retention so
    the two tiers can't drift."""
    drop_upto: int | None = None
    if retention_bytes is not None:
        total = sum(size for size, _ts, _off in entries)
        i = 0
        while i + 1 < len(entries) and total > retention_bytes:
            total -= entries[i][0]
            drop_upto = entries[i][2]
            i += 1
    if retention_ms is not None and now_ms is not None:
        i = 0
        while (
            i + 1 < len(entries)
            and entries[i][1] >= 0
            and entries[i][1] < now_ms - retention_ms
        ):
            drop_upto = max(drop_upto or -1, entries[i][2])
            i += 1
    return drop_upto


class LogOffsets:
    """Reference: storage/types.h offset_stats."""

    __slots__ = ("start_offset", "dirty_offset", "committed_offset")

    def __init__(self, start: int, dirty: int, committed: int):
        self.start_offset = start
        self.dirty_offset = dirty
        self.committed_offset = committed  # flushed

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"LogOffsets(start={self.start_offset}, dirty={self.dirty_offset}, "
            f"committed={self.committed_offset})"
        )


class Log:
    def __init__(
        self,
        directory: str,
        config: LogConfig | None = None,
        cache: BatchCache | None = None,
        probe=None,
    ):
        # StorageProbe shared across the shard's logs; standalone Logs
        # (unit fixtures, raft group logs built directly) share a
        # private unscraped one so hot paths never branch on None
        if probe is None:
            from .probe import fixture_probe

            probe = fixture_probe()
        self.probe = probe
        self._observe_append = probe.observe_append
        self._observe_flush_wait = probe.observe_flush_wait
        self._dir = directory
        os.makedirs(directory, exist_ok=True)
        self.config = config or LogConfig()
        self._segments: list[Segment] = []
        self._cache_index: BatchCacheIndex | None = (
            cache.make_index() if cache is not None else None
        )
        # observer hooks (cluster::partition wires its offset
        # translator here; reference threads the translator through
        # disk_log_impl appends in raft/offset_translator.cc)
        self.on_append: list = []  # fn(batch)
        self.on_truncate: list = []  # fn(offset)
        self.on_prefix_truncate: list = []  # fn(new_start_offset)
        # raft-replicated logs install a snapshot-gated retention pass
        # here (Partition.housekeeping); LogManager's housekeeping timer
        # calls it instead of bare apply_retention when present
        self.housekeeping_override = None  # fn(now_ms) | None
        # logical start offset (disk_log_impl's _start_offset): prefix
        # truncation is batch-granular even when the cut lands inside a
        # segment; whole segments below it are reclaimed physically.
        # Durable via a sidecar marker (the reference stores it in the
        # kvstore's storage keyspace, kvstore.h:93).
        self._start_override: int = 0
        # positioned-reader hints (readers_cache.h:31): next_offset ->
        # (segment, exact file pos). Sequential fetch polls resume at
        # the byte where the previous poll ended instead of re-walking
        # from the 32 KiB sparse-index point. Identity-checked against
        # _segments; invalidated wholesale on truncation/compaction.
        from collections import OrderedDict

        self._reader_hints: "OrderedDict[int, tuple]" = OrderedDict()
        self.reader_hits = 0
        self.reader_misses = 0
        self._start_path = os.path.join(directory, "start_offset")
        try:
            with open(self._start_path) as f:
                self._start_override = int(f.read().strip() or 0)
        except (OSError, ValueError):
            pass
        self._recover()

    @property
    def directory(self) -> str:
        return self._dir

    # -- recovery ----------------------------------------------------
    def _recover(self) -> None:
        found = []
        for name in os.listdir(self._dir):
            if name.endswith(".log"):
                base, term = name[:-4].split("-")
                found.append((int(base), int(term)))
        for base, term in sorted(found):
            seg = Segment(self._dir, base, term)
            if self._segments and self._segments[-1].base_offset == base:
                # two files share a base (crash between creating a
                # replacement for an empty placeholder and unlinking
                # it): the empty one is the stale placeholder — keep
                # whichever holds data, preferring the later term on a
                # tie of two empties
                prev = self._segments[-1]
                if seg.dirty_offset < seg.base_offset and (
                    prev.dirty_offset >= prev.base_offset
                ):
                    seg.close()
                    seg.remove_files()
                    continue
                prev.close()
                prev.remove_files()
                self._segments.pop()
            self._segments.append(seg)

    # -- offsets -----------------------------------------------------
    def offsets(self) -> LogOffsets:
        if not self._segments:
            return LogOffsets(0, -1, -1)
        start = max(self._segments[0].base_offset, self._start_override)
        dirty = self._segments[-1].dirty_offset
        # rolled segments are flushed at roll time, so the tail's stable
        # offset is the log's flushed offset
        committed = self._segments[-1].stable_offset
        return LogOffsets(start, dirty, committed)

    def term_of_last_batch(self) -> int:
        if not self._segments:
            return -1
        return self._segments[-1].term

    def get_term(self, offset: int) -> int | None:
        """Term of the segment containing offset (segments roll on term
        change, so per-segment term is exact)."""
        for seg in reversed(self._segments):
            if offset >= seg.base_offset:
                if offset > seg.dirty_offset:
                    return None
                return seg.term
        return None

    def term_boundaries(self) -> list[tuple[int, int]]:
        """Ascending (first_offset, term) pairs — the per-term start
        offsets (segments roll on term change, so the first segment of
        each term marks the boundary). Feeds the shard-array
        term-boundary mirror used by the batched heartbeat build."""
        out: list[tuple[int, int]] = []
        for seg in self._segments:
            if seg.dirty_offset < seg.base_offset:
                continue  # empty tail segment
            if not out or seg.term != out[-1][1]:
                out.append((seg.base_offset, seg.term))
        return out

    # -- append ------------------------------------------------------
    def append(self, batch: RecordBatch, term: int | None = None) -> tuple[int, int]:
        """Assign offsets and append; returns (base, last) offsets.
        The batch's base_offset/term are rewritten to the log's view
        (storage assigns offsets, reference disk_log_impl appender)."""
        offs = self.offsets()
        base = offs.dirty_offset + 1
        if term is None:
            term = batch.header.term if batch.header.term >= 0 else 0
        batch.header.base_offset = base
        batch.header.term = term
        # the body crc (Kafka formula) covers attrs..records only —
        # rewriting base_offset/term invalidates just the header crc.
        # Callers hand over finalized batches (builder.build() and the
        # produce adapter both verify/set the body crc), so skipping
        # the full-body recompute here removes one of the two 100+ MB/s
        # CRC passes from the hot append path. Under the file sanitizer
        # (debug builds) the contract is enforced AT the faulty call
        # site instead of surfacing as a distant recovery CRC mismatch.
        if not batch.finalized:
            # cheap always-on guard (one attr check): builders,
            # finalize_crcs() and the wire decoders all set the flag —
            # an internal caller that constructed/mutated a batch by
            # hand must finalize before it can persist a stale body crc
            raise AssertionError(
                "log.append requires a finalized batch (stale body crc); "
                "call finalize_crcs() after building the body"
            )
        if file_sanitizer.enabled() and batch.header.crc != batch.compute_crc():
            raise AssertionError(
                "log.append requires a finalized batch (stale body crc); "
                "call finalize_crcs() after building the body"
            )
        batch.header.size_bytes = batch.size_bytes()
        batch.header.header_crc = batch.header.compute_header_crc()

        seg = self._active_segment(term)
        t0 = time.monotonic()
        seg.append(batch)
        self._observe_append(time.monotonic() - t0)
        if self._cache_index is not None:
            self._cache_index.put(batch)
        for fn in self.on_append:
            fn(batch)
        return base, batch.header.last_offset

    def append_exactly(self, batch: RecordBatch) -> tuple[int, int]:
        """Append preserving the batch's own base_offset/term (follower
        path: the leader already assigned offsets)."""
        if not batch.finalized:
            raise AssertionError(
                "log.append_exactly requires a finalized batch (stale "
                "body crc); call finalize_crcs() after building the body"
            )
        seg = self._active_segment(batch.header.term)
        seg.append(batch)
        if self._cache_index is not None:
            self._cache_index.put(batch)
        for fn in self.on_append:
            fn(batch)
        return batch.header.base_offset, batch.header.last_offset

    def _active_segment(self, term: int) -> Segment:
        if self._segments:
            seg = self._segments[-1]
            if (
                seg.term == term
                and seg.size_bytes() < self.config.segment_max_bytes
            ):
                return seg
            if seg.dirty_offset < seg.base_offset:
                if seg.term == term:
                    return seg  # empty segment, reuse
                # an empty placeholder (post-truncation boundary) being
                # appended to at a different term: REPLACE it — two
                # same-base segment files with different terms would
                # shadow each other after recovery
                seg.close()
                seg.remove_files()
                self._segments.pop()
                new = Segment(self._dir, seg.base_offset, term)
                self._segments.append(new)
                return new
            seg.flush()
            seg.persist_index()
        base = self.offsets().dirty_offset + 1
        seg = Segment(self._dir, base, term)
        self._segments.append(seg)
        return seg

    def flush(self) -> int:
        """fsync the active segment; returns the flushed offset — the
        value raft reports as _flushed_offset for acks=all."""
        if not self._segments:
            return -1
        return self._segments[-1].flush()

    async def flush_async(self) -> int:
        """Executor-thread fsync of the active segment (replicate
        batcher path: the event loop keeps appending the next round
        while this one syncs). A roll during the fsync is safe — the
        captured segment still syncs its own bytes, and rolled
        segments fsync at roll time."""
        if not self._segments:
            return -1
        seg = self._segments[-1]
        t0 = time.monotonic()
        await seg.flush_async()
        # includes the flush-coalescer queueing delay (storage probe)
        self._observe_flush_wait(time.monotonic() - t0)
        return self._segments[-1].stable_offset

    # -- read --------------------------------------------------------
    def read(
        self, start_offset: int, max_bytes: int = 1 << 20, upto: int | None = None
    ) -> list[RecordBatch]:
        """Batches intersecting [start_offset, upto]. Serves from the
        batch cache when possible, else CRC-trusted segment scan."""
        offs = self.offsets()
        end = offs.dirty_offset if upto is None else min(upto, offs.dirty_offset)
        if start_offset > end:
            return []
        out: list[RecordBatch] = []
        consumed = 0
        pos = start_offset
        while pos <= end and consumed < max_bytes:
            batch = None
            if self._cache_index is not None:
                batch = self._cache_index.get(pos)
            if batch is None:
                batch = self._read_from_disk(pos)
            if batch is None:
                break
            out.append(batch)
            consumed += batch.size_bytes()
            pos = batch.header.last_offset + 1
        return out

    def invalidate_readers(self) -> None:
        """Drop positioned-reader hints (truncation, compaction
        rewrites — anything that moves bytes under cached positions)."""
        self._reader_hints.clear()

    def _read_from_disk(self, offset: int) -> RecordBatch | None:
        for seg in reversed(self._segments):
            if offset >= seg.base_offset:
                if offset > seg.dirty_offset:
                    return None
                pos = None
                hint = self._reader_hints.pop(offset, None)
                if hint is not None and hint[0] is seg:
                    pos = hint[1]
                    self.reader_hits += 1
                else:
                    self.reader_misses += 1
                batches, ends = seg.read_batches_pos(
                    offset, max_bytes=1 << 20, pos=pos
                )
                if not batches:
                    return None
                if self._cache_index is not None:
                    # insert the WHOLE read-ahead window, not just the
                    # first hit: read() asks offset-by-offset, and
                    # discarding the tail meant every ~1 MB disk read
                    # served one batch then re-read the rest next call
                    # (8x read amplification in the consume-path
                    # profile; readers_cache analog)
                    for b in batches:
                        self._cache_index.put(b)
                # positioned readers survive to the next poll — one
                # resume point per batch boundary in the window
                for b, end in zip(batches, ends):
                    self._reader_hints[b.header.last_offset + 1] = (
                        seg,
                        end,
                    )
                while len(self._reader_hints) > 1024:
                    self._reader_hints.popitem(last=False)
                return batches[0]
        return None

    # -- zero-copy wire read (kafka fetch plane) ---------------------
    def read_wire(
        self, start_offset: int, max_bytes: int = 1 << 20, upto: int | None = None
    ) -> list[WireSpan]:
        """WireSpan rows intersecting [start_offset, upto] — the
        fetch-path twin of read(): served from the wire plane of the
        batch cache when possible, else one raw span scan per segment
        window (Segment.read_spans) converted to Kafka wire form ONCE
        and cached. No RecordBatch objects anywhere on this path; the
        byte budget is accounted in internal span sizes so the row set
        matches read()'s batch set exactly."""
        offs = self.offsets()
        end = offs.dirty_offset if upto is None else min(upto, offs.dirty_offset)
        if start_offset > end:
            return []
        out: list[WireSpan] = []
        consumed = 0
        pos = start_offset
        while pos <= end and consumed < max_bytes:
            row = None
            if self._cache_index is not None:
                row = self._cache_index.get_wire(pos)
            if row is None:
                row = self._wire_from_decoded_cache(pos)
            if row is None:
                row = self._wire_from_disk(pos)
            if row is None:
                break
            out.append(row)
            consumed += row.size_bytes()
            pos = row.last_offset + 1
        return out

    def _wire_from_decoded_cache(self, offset: int) -> WireSpan | None:
        """Convert a decoded-plane hit (hot tail: the append path puts
        RecordBatch objects) into a wire row without touching disk; the
        conversion is paid once and lands in the wire plane."""
        if self._cache_index is None:
            return None
        batch = self._cache_index.get(offset)
        if batch is None:
            return None
        h = batch.header
        row = WireSpan(
            h.base_offset, h.last_offset, int(h.type), batch.to_kafka_wire()
        )
        self._cache_index.put_wire(row)
        return row

    def _wire_from_disk(self, offset: int) -> WireSpan | None:
        for seg in reversed(self._segments):
            if offset >= seg.base_offset:
                if offset > seg.dirty_offset:
                    return None
                pos = None
                hint = self._reader_hints.pop(offset, None)
                if hint is not None and hint[0] is seg:
                    pos = hint[1]
                    self.reader_hits += 1
                else:
                    self.reader_misses += 1
                spans = seg.read_spans(offset, max_bytes=1 << 20, pos=pos)
                if not spans:
                    return None
                first: WireSpan | None = None
                for _hdr_view, span, end in spans:
                    row = span_to_wire(span)
                    if first is None:
                        first = row
                    if self._cache_index is not None:
                        # whole read-ahead window, same rationale as
                        # _read_from_disk: the next poll asks for the
                        # following offset and must hit memory
                        self._cache_index.put_wire(row)
                    self._reader_hints[row.last_offset + 1] = (seg, end)
                while len(self._reader_hints) > 1024:
                    self._reader_hints.popitem(last=False)
                return first
        return None

    def drop_wire_cache(self) -> None:
        """Evict this log's wire plane + positioned readers (verify-on-
        read CRC mismatch: don't keep serving a possibly-corrupt cached
        span; the retrying fetch re-reads and re-converts from disk)."""
        if self._cache_index is not None:
            self._cache_index.drop_wire()
        self.invalidate_readers()

    def timequery(self, ts: int) -> int | None:
        log_start = self.offsets().start_offset
        for seg in self._segments:
            if seg.max_timestamp >= ts:
                hint = seg.timequery(ts)
                start = hint if hint is not None else seg.base_offset
                for b in seg.read_batches(start):
                    # batches below the logical start are truncated away
                    if b.header.base_offset < log_start:
                        continue
                    if b.header.max_timestamp >= ts:
                        return b.header.base_offset
        return None

    # -- truncation --------------------------------------------------
    def truncate(self, offset: int) -> None:
        """Remove everything at-or-after offset (suffix truncation)."""
        self.invalidate_readers()
        if not self._segments:
            return
        start = self._segments[0].base_offset
        last_term = self._segments[-1].term
        while self._segments and self._segments[-1].base_offset >= offset:
            seg = self._segments.pop()
            last_term = seg.term
            seg.close()
            seg.remove_files()
        if self._segments:
            self._segments[-1].truncate(offset)
        else:
            # Full-suffix truncation must not forget where the log is
            # positioned: an empty log after prefix truncation still
            # starts at `start`, not 0 (the install_snapshot_reset
            # representation: one empty segment at the boundary).
            # Reaching here implies offset <= start (the first
            # segment's base was >= offset); the base stays `start` so
            # appends can never land below the snapshotted boundary.
            # The placeholder's term is the deleted suffix's term — an
            # upper bound on the true prev term, which can only make
            # this node DENY votes it could have granted (safe) until
            # the leader's replacement entries land.
            self._reset_to(start, max(last_term, 0))
        if self._cache_index is not None:
            self._cache_index.truncate(offset)
        for fn in self.on_truncate:
            fn(offset)

    def _batch_align(self, offset: int) -> int:
        """Base offset of the batch containing `offset` (round DOWN —
        whole batches are the truncation unit; a mid-batch start would
        leak partial batches into reads), or dirty+1 past the end."""
        dirty = self.offsets().dirty_offset
        if offset > dirty:
            return dirty + 1
        for seg in reversed(self._segments):
            if offset >= seg.base_offset:
                batches = seg.read_batches(offset, max_bytes=1)
                if batches:
                    return batches[0].header.base_offset
                return seg.base_offset
        return offset

    def prefix_truncate(self, offset: int) -> None:
        """Advance the logical start to the batch boundary at-or-below
        `offset` and physically drop whole segments entirely below it
        (retention, raft snapshots; disk_log_impl truncate_prefix)."""
        old_start = self.offsets().start_offset
        self.invalidate_readers()
        offset = self._batch_align(offset)
        while (
            len(self._segments) > 1 and self._segments[1].base_offset <= offset
        ):
            seg = self._segments.pop(0)
            seg.close()
            seg.remove_files()
        if offset > self._start_override:
            self._start_override = offset
            self._persist_start()
        new_start = self.offsets().start_offset
        if new_start > old_start:
            if self._cache_index is not None:
                self._cache_index.prefix_truncate(new_start)
            for fn in self.on_prefix_truncate:
                fn(new_start)

    def force_roll(self, term: int | None = None) -> None:
        """Seal the active segment and open a fresh one at dirty+1 —
        lets a snapshot's prefix_truncate physically reclaim the whole
        history below it (the reference rolls on snapshot/term events)."""
        if not self._segments:
            return
        tail = self._segments[-1]
        if tail.dirty_offset < tail.base_offset:
            return  # already an empty head segment
        tail.flush()
        tail.persist_index()
        self._segments.append(
            Segment(
                self._dir,
                tail.dirty_offset + 1,
                tail.term if term is None else term,
            )
        )

    def _reset_to(self, base: int, term: int) -> None:
        """Restart the log as ONE empty segment positioned at `base`
        (shared by full-suffix truncation and install_snapshot_reset)."""
        for seg in self._segments:
            seg.close()
            seg.remove_files()
        self._segments = [Segment(self._dir, base, term)]
        self._start_override = base
        self._persist_start()

    def _persist_start(self) -> None:
        tmp = self._start_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(self._start_override))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._start_path)
        # the rename only durably points the NAME at the new inode
        # once the directory itself is synced
        dirsync.fsync_dir(self._dir)

    def install_snapshot_reset(self, next_offset: int, term: int) -> None:
        """Drop the ENTIRE log and restart it empty at next_offset —
        the follower install_snapshot path (raft snapshot replaces the
        whole local prefix; consensus.cc install_snapshot →
        drop log + start at last_included + 1). Does NOT fire
        on_truncate/on_prefix_truncate: the caller restores derived
        state (offset translator, producer table) from the snapshot
        payload instead of replaying."""
        self._reset_to(next_offset, max(term, 0))
        if self._cache_index is not None:
            self._cache_index.truncate(0)

    # -- housekeeping -------------------------------------------------
    def retention_offset(
        self,
        now_ms: int | None = None,
        limits: "tuple[int | None, int | None] | None" = None,
    ) -> int | None:
        """First offset retention WANTS to keep (None = nothing to do).
        Pure query — raft must take a snapshot covering everything
        below before any data is physically reclaimed
        (max_collectible_offset in the reference's disk_log_impl).
        `limits=(bytes, ms)` REPLACES both config knobs entirely
        (tiered topics trim locally by retention.local.target.*; an
        unset dimension inside the pair means NO limit there, never a
        fallback to the cloud knobs)."""
        cfg = self.config
        if limits is not None:
            retention_bytes, retention_ms = limits
        else:
            retention_bytes, retention_ms = cfg.retention_bytes, cfg.retention_ms
        drop_upto = retention_drop_upto(
            [
                (s.size_bytes(), s.max_timestamp, s.dirty_offset)
                for s in self._segments
            ],
            retention_bytes,
            retention_ms,
            now_ms,
        )
        return drop_upto + 1 if drop_upto is not None else None

    def apply_retention(
        self,
        now_ms: int | None = None,
        max_offset: int | None = None,
        limits: "tuple[int | None, int | None] | None" = None,
    ) -> int:
        """Size/time retention (log_manager housekeeping analog).
        Segments are only reclaimed when entirely below `max_offset`
        (the raft snapshot boundary — dropping data followers may
        still need would strand them). Returns first retained offset."""
        target = self.retention_offset(now_ms, limits=limits)
        if target is not None:
            if max_offset is not None:
                target = min(target, max_offset + 1)
            self.prefix_truncate(target)
        return self.offsets().start_offset

    def compact(self, max_offset: int, visible=None) -> dict:
        """Key-dedupe compaction of closed segments below max_offset
        (see storage/compaction.py for the offset-preserving design).
        `visible(batch, offset)` optionally excludes records (aborted
        tx data) from participating."""
        from .compaction import compact_log

        t0 = time.monotonic()
        out = compact_log(self, max_offset, visible)
        self.probe.compaction_hist.observe(time.monotonic() - t0)
        return out

    def size_bytes(self) -> int:
        """On-disk bytes across all segments (disk_log_impl size probe;
        DescribeLogDirs partition_size)."""
        return sum(s.size_bytes() for s in self._segments)

    def segment_count(self) -> int:
        return len(self._segments)

    def close(self) -> None:
        for seg in self._segments:
            seg.close()
