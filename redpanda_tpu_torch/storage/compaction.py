"""Key-based log compaction.

Reference: src/v/storage/segment_utils.cc (self_compact_segment,
build_compaction_index, do_compact_segment), compaction_reducers.{h,cc}
(copy_data_segment_reducer / index_filter_reducer pipeline) and
spill_key_index.{h,cc}.

Deliberate design differences from the reference:

- Offsets are NEVER renumbered. A surviving record keeps its original
  offset (batch base_offset + per-record offset_delta); a batch whose
  records are all superseded shrinks to a zero-record placeholder
  header at the same [base, last] range. The raft log therefore stays
  contiguous at batch granularity: follower catch-up (`append_exactly`
  requires contiguous batch bases) and the offset translator keep
  working over compacted logs, while readers simply see record gaps —
  the same contract Kafka clients already accept for compacted topics.
- The key index is an exact host-side dict keyed by the raw key bytes.
  The reference hashes keys (xxhash) and spills to disk to bound
  memory; exactness here removes the probabilistic-collision handling
  and the closed-segment sizes involved (<= segment_max_bytes of live
  keys) fit host memory comfortably.
- Only `raft_data`, non-control, keyed records participate. Control
  batches (tx markers), configuration batches, and unkeyed records are
  preserved verbatim — superseding a tx marker would corrupt the
  aborted-range index rebuilt from the log.
"""

from __future__ import annotations

import os

from ..models.record import (
    _DESC_W,
    CompressionType,
    Record,
    RecordBatch,
    RecordBatchType,
    parse_record_descriptors,
)
from ..utils.iobuf import IOBufParser
from . import dirsync

_COMPRESSION_MASK = 0x07


def _is_compactable(header) -> bool:
    return (
        header.type == RecordBatchType.raft_data
        and not header.is_control
        and header.record_count > 0
    )


def build_key_map(segments, participates) -> dict[bytes, int]:
    """key -> offset of its LATEST participating occurrence.
    `participates(batch, offset)` gates which records may supersede:
    records above the commit boundary (raft may still truncate them)
    and undecided/aborted transactional records must NOT supersede a
    committed value — deleting v1 because an uncommitted v2 exists
    would lose the key entirely if v2 never materializes.
    Batches that fail record decode (foreign compression lib absent,
    corrupt body) contribute nothing — their batches are preserved
    verbatim by the rewrite pass."""
    latest: dict[bytes, int] = {}
    for seg in segments:
        if seg.dirty_offset < seg.base_offset:
            continue
        for batch in seg.read_batches(seg.base_offset):
            if not _is_compactable(batch.header):
                continue
            base = batch.header.base_offset
            try:
                # descriptor scan: one native call, then slice only the
                # keys — no Record objects on this whole-log pass
                data = batch._records_body()
                desc = parse_record_descriptors(data, batch.header.record_count)
            except Exception:
                continue
            if desc is not None:
                for o in range(0, len(desc), _DESC_W):
                    key_len = desc[o + 6]
                    if key_len < 0:
                        continue
                    off = base + desc[o + 4]
                    if not participates(batch, off):
                        continue
                    key = data[desc[o + 5] : desc[o + 5] + key_len]
                    if off > latest.get(key, -1):
                        latest[key] = off
                continue
            try:
                # no native lib: decode from the already-decompressed
                # body rather than batch.records() (which would
                # decompress a second time)
                parser = IOBufParser(data)
                records = [
                    Record.decode(parser)
                    for _ in range(batch.header.record_count)
                ]
            except Exception:
                continue
            for r in records:
                if r.key is not None:
                    off = base + r.offset_delta
                    if not participates(batch, off):
                        continue
                    prev = latest.get(r.key, -1)
                    if off > prev:
                        latest[r.key] = off
    return latest


def _filter_batch(
    batch: RecordBatch, key_map: dict[bytes, int], participates
) -> RecordBatch | None:
    """Return a rewritten batch keeping only live records, or None when
    the batch is untouched. Offsets/timestamps are preserved; the body
    is re-encoded uncompressed (the surviving subset rarely compresses
    the way the original did, and host codecs on the read path cost
    more than the bytes saved). Non-participating records (undecided tx
    data) are kept verbatim — fetch-side aborted-range filtering owns
    their visibility; removing them here would race the tx outcome."""
    if not _is_compactable(batch.header):
        return None
    base = batch.header.base_offset
    n = batch.header.record_count
    try:
        data = batch._records_body()
        desc = parse_record_descriptors(data, n)
    except Exception:
        return None
    if desc is not None:
        # verbatim slices: surviving records keep their offset/timestamp
        # deltas, so their wire bytes are reused unchanged
        slices: list[tuple[int, int]] = []
        for o in range(0, len(desc), _DESC_W):
            key_len = desc[o + 6]
            off = base + desc[o + 4]
            if (
                key_len < 0
                or not participates(batch, off)
                or key_map.get(data[desc[o + 5] : desc[o + 5] + key_len]) == off
            ):
                slices.append((desc[o + 0], desc[o + 1]))
        if len(slices) == n:
            return None
        body = b"".join(data[s:e] for s, e in slices)
        n_keep = len(slices)
    else:
        try:
            parser = IOBufParser(data)
            records = [Record.decode(parser) for _ in range(n)]
        except Exception:
            return None
        keep: list[Record] = []
        for r in records:
            off = base + r.offset_delta
            if (
                r.key is None
                or not participates(batch, off)
                or key_map.get(r.key) == off
            ):
                keep.append(r)
        if len(keep) == len(records):
            return None
        body = b"".join(r.encode() for r in keep)
        n_keep = len(keep)
    hdr = batch.header
    new_hdr = type(hdr)(
        header_crc=0,
        size_bytes=0,
        base_offset=hdr.base_offset,
        type=hdr.type,
        crc=0,
        # compaction re-encodes uncompressed: clear the codec bits
        attrs=hdr.attrs & ~_COMPRESSION_MASK | int(CompressionType.none),
        last_offset_delta=hdr.last_offset_delta,
        first_timestamp=hdr.first_timestamp,
        max_timestamp=hdr.max_timestamp,
        producer_id=hdr.producer_id,
        producer_epoch=hdr.producer_epoch,
        base_sequence=hdr.base_sequence,
        record_count=n_keep,
        term=hdr.term,
    )
    out = RecordBatch(new_hdr, body)
    out.header.size_bytes = out.size_bytes()
    out.finalize_crcs()
    return out


def compact_segment(seg, key_map: dict[bytes, int], participates) -> tuple[int, int]:
    """Self-compact one CLOSED segment in place (atomic file replace).
    Returns (records_removed, bytes_reclaimed)."""
    removed = 0
    path = seg._path
    tmp = path + ".compact.tmp"
    old_size = seg.size_bytes()
    wrote = False
    with open(tmp, "wb") as f:
        for batch in seg.read_batches(seg.base_offset):
            nb = _filter_batch(batch, key_map, participates)
            if nb is not None:
                removed += batch.header.record_count - nb.header.record_count
                wrote = True
                batch = nb
            f.write(batch.serialize())
        f.flush()
        os.fsync(f.fileno())
    if not wrote:
        os.remove(tmp)
        return 0, 0
    seg._release_handles()  # old inode is about to be replaced
    os.replace(tmp, path)
    dirsync.fsync_dir(seg._dir)  # rename durable only after dir sync
    if os.path.exists(seg._index_path):
        os.remove(seg._index_path)
    # reopen through recovery: rebuilds the sparse index + offsets from
    # the rewritten file
    seg.__init__(seg._dir, seg.base_offset, seg.term)
    return removed, old_size - seg.size_bytes()


def merge_adjacent(log, max_bytes: int) -> int:
    """Merge adjacent closed same-term segments whose combined size
    fits `max_bytes` (segment_utils.cc adjacent-segment merge). Terms
    must match: Log.get_term/term_boundaries derive the raft term from
    per-segment metadata, which a cross-term merge would corrupt.
    Returns the number of merges performed."""
    merged = 0
    i = 0
    segs = log._segments
    while i + 1 < len(segs) - 1:  # never touch the active tail
        a, b = segs[i], segs[i + 1]
        if a.term != b.term or a.size_bytes() + b.size_bytes() > max_bytes:
            i += 1
            continue
        tmp = a._path + ".merge.tmp"
        with open(tmp, "wb") as f:
            for seg in (a, b):
                for batch in seg.read_batches(seg.base_offset):
                    f.write(batch.serialize())
            f.flush()
            os.fsync(f.fileno())
        log.invalidate_readers()
        a._release_handles()
        b._release_handles()
        os.replace(tmp, a._path)
        dirsync.fsync_dir(a._dir)
        for p in (b._path, a._index_path, b._index_path):
            if os.path.exists(p):
                os.remove(p)
        a.__init__(a._dir, a.base_offset, a.term)
        segs.pop(i + 1)
        merged += 1
    return merged


_NO_WORK = {"segments": 0, "records_removed": 0, "bytes_reclaimed": 0}


def compact_log(log, max_offset: int, visible=None) -> dict[str, int]:
    """One compaction round over `log`: self-compact every closed
    segment entirely below `max_offset` (the commit boundary — never
    rewrite data raft may still truncate), then merge adjacent shrunken
    segments.

    A record participates (may supersede and may be removed) only when
    it is at-or-below `max_offset` AND `visible(batch, offset)` (when
    given) accepts it — the partition passes a predicate that rejects
    aborted/undecided transactional records. Everything else is
    preserved verbatim.

    Passes are incremental: `log._compacted_upto` records the boundary
    of the last pass; a pass with no newly-closed segment below
    `max_offset` is free (no read, no decode) — the steady-state cost
    of the housekeeping timer on an idle log is one list scan."""
    # compaction rewrites move bytes under any positioned readers
    log.invalidate_readers()
    if getattr(log, "_compacted_upto", None) is None:
        log._compacted_upto = -1
    closed = [
        s
        for s in log._segments[:-1]
        if s.dirty_offset <= max_offset and s.dirty_offset >= s.base_offset
    ]
    if not closed or closed[-1].dirty_offset <= log._compacted_upto:
        return dict(_NO_WORK)

    def participates(batch, off):
        if off > max_offset:
            return False
        return visible is None or visible(batch, off)

    key_map = build_key_map(log._segments, participates)
    removed = reclaimed = touched = 0
    for seg in closed:
        first, last = seg.base_offset, seg.dirty_offset
        r, by = compact_segment(seg, key_map, participates)
        if r:
            touched += 1
            removed += r
            reclaimed += by
            # drop only the rewritten range from the cache; the hot
            # tail above stays resident
            if log._cache_index is not None:
                log._cache_index.evict_range(first, last)
    merge_adjacent(log, log.config.max_compacted_segment_bytes)
    log._compacted_upto = closed[-1].dirty_offset
    return {
        "segments": touched,
        "records_removed": removed,
        "bytes_reclaimed": reclaimed,
    }
