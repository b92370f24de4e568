"""Read path over archived segments.

Reference: src/v/cloud_storage/remote_partition.{h,cc} +
remote_segment.{h,cc} (hydrate segment → serve reader),
materialized_segments.h (bounded cache of hydrated segments), and
remote_segment_index.{h,cc} (sparse offset→file-position samples so a
mid-segment read need not scan from byte 0).

A fetch below the local log start locates the covering segment via the
manifest (kafka-space bisect using per-segment delta_offset), hydrates
only the CHUNKS the scan touches through the disk-backed CloudCache
(cache_service.{h,cc}), and walks batches re-deriving each batch's
kafka offset exactly like the local offset translator would — filtered
(non-data) batches advance the running delta. Each scan deposits
sparse (kafka_base, file_pos, delta) samples; later reads start from
the closest sample at-or-before the target instead of byte 0.
"""

from __future__ import annotations

import bisect
from collections import OrderedDict
from typing import Optional

from ..models.record import HEADER_SIZE, RecordBatch, RecordBatchHeader, RecordBatchType
from .cache_service import CloudCache
from .manifest import PartitionManifest, SegmentMeta
from .object_store import (
    CloudUnavailableError,
    ObjectStore,
    RetryingStore,
    StoreError,
)

INDEX_STRIDE = 128 << 10  # one sample per ~128KiB of segment scanned


VIEW_WINDOW = 256 << 10


class _SegmentView:
    """Lazy byte window over one archived segment: reads pull chunks
    through the CloudCache (or, with no cache, a whole-object LRU).
    A window of the most recent VIEW_WINDOW bytes is memoized so the
    sequential batch walk (two small reads per batch) costs one cache
    access per window, not per read.

    Segments archived compressed (manifest size_compressed > 0) bypass
    the chunk window entirely: chunks of a zstd frame are not
    independently decodable, so the first read hydrates the WHOLE
    object, decompresses it (device-side under RP_ZSTD_BACKEND=tpu),
    and serves every position from the decoded-body LRU. `size` is
    always the UNCOMPRESSED size — batch positions live in that space."""

    def __init__(
        self, reader: "RemoteReader", key: str, size: int, comp_size: int = 0
    ):
        self._r = reader
        self.key = key
        self.size = size
        self._comp = comp_size
        self._win_start = 0
        self._win = b""

    async def read(self, pos: int, n: int) -> bytes:
        if pos >= self.size:
            return b""
        end = min(pos + n, self.size)
        if self._comp:
            return await self._r._read_range_zstd(
                self.key, self._comp, self.size, pos, end
            )
        ws = self._win_start
        win = self._win
        if not (ws <= pos and end <= ws + len(win)):
            win_end = min(max(end, pos + VIEW_WINDOW), self.size)
            win = await self._r._read_range(
                self.key, pos, win_end, self.size
            )
            # last-writer-wins window cache: a concurrent read() can
            # overwrite it across our await (worst case the window
            # thrashes and the next miss refetches) — data is always
            # sliced from the locals above, never from self after the
            # suspension
            self._win = win  # rplint: disable=RPL015
            self._win_start = ws = pos  # rplint: disable=RPL015
        off = pos - ws
        return win[off : off + (end - pos)]


class RemoteReader:
    def __init__(
        self,
        store: ObjectStore,
        cache: Optional[CloudCache] = None,
        cache_max_bytes: int = 32 << 20,
    ):
        # fetch-path discipline (rplint RPL013): every hydration runs
        # under a retry budget + per-op deadline, so a wedged store
        # exhausts a bounded budget and surfaces as cloud_unavailable
        # instead of wedging the fetch
        self.store = (
            store
            if isinstance(store, RetryingStore)
            else RetryingStore(store, attempts=3, op_deadline_s=15.0)
        )
        self.cache = cache
        # observability hooks (CloudProbe): on_degraded(kind) when a
        # remote read degrades; on_read(seconds, hydrated) per ranged
        # read for the warm/cold latency histogram
        self.on_degraded = None
        self.on_read = None
        # fallback when no disk cache is configured: whole-object LRU
        self._mem: OrderedDict[str, bytes] = OrderedDict()
        self._mem_bytes = 0
        self._mem_max = cache_max_bytes
        self.hydrations = 0
        # remote_segment_index: key -> sorted [(kafka_base, pos, delta)]
        self._seg_index: OrderedDict[str, list[tuple[int, int, int]]] = (
            OrderedDict()
        )

    def _degrade(self, kind: str) -> None:
        if self.on_degraded is not None:
            self.on_degraded(kind)

    # -- hydration ----------------------------------------------------
    async def _read_range(
        self, key: str, start: int, end: int, size: int
    ) -> bytes:
        if self.on_read is None:
            return await self._read_range_inner(key, start, end, size)
        import time

        t0 = time.monotonic()
        h0 = self.hydrations
        data = await self._read_range_inner(key, start, end, size)
        # cold = at least one object-store fetch happened; warm = pure
        # cache/LRU assembly (the warm/cold split the tiered SLO grades)
        self.on_read(time.monotonic() - t0, self.hydrations > h0)
        return data

    async def _read_range_inner(
        self, key: str, start: int, end: int, size: int
    ) -> bytes:
        if self.cache is not None:

            async def fetch(lo: int, hi: int) -> bytes:
                # RetryingStore.get_range handles stores without native
                # range support (whole get + slice)
                self.hydrations += 1
                return await self.store.get_range(key, lo, hi)

            return await self.cache.read(key, start, end, size, fetch)
        data = self._mem.get(key)
        if data is None:
            data = await self.store.get(key)
            self.hydrations += 1
            self._mem[key] = data
            self._mem_bytes += len(data)
            while self._mem_bytes > self._mem_max and len(self._mem) > 1:
                _k, ev = self._mem.popitem(last=False)
                self._mem_bytes -= len(ev)
        else:
            self._mem.move_to_end(key)
        return data[start:end]

    # -- compressed-segment hydration ---------------------------------
    async def _read_range_zstd(
        self, key: str, comp_size: int, size: int, start: int, end: int
    ) -> bytes:
        """Ranged read over a compressed archived segment: whole-object
        hydrate + decompress on first touch, then every range slices
        the decoded-body LRU. Length mismatches and codec failures
        (including the decompress bomb guard) surface as StoreError so
        read_kafka degrades them exactly like a truncated object."""
        import time

        t0 = time.monotonic()
        h0 = self.hydrations
        body = self._mem.get(key)
        if body is None:
            blob = await self.store.get(key)
            self.hydrations += 1
            if len(blob) != comp_size:
                raise StoreError(
                    f"compressed segment {key} is {len(blob)} bytes, "
                    f"manifest says {comp_size}"
                )
            from ..compression import CompressionType, uncompress

            try:
                body = uncompress(blob, CompressionType.zstd)
            except (ValueError, RuntimeError) as e:
                raise StoreError(
                    f"compressed segment {key} failed to decode: {e}"
                ) from e
            if len(body) != size:
                raise StoreError(
                    f"compressed segment {key} inflates to {len(body)} "
                    f"bytes, manifest says {size}"
                )
            self._mem[key] = body
            self._mem_bytes += len(body)
            while self._mem_bytes > self._mem_max and len(self._mem) > 1:
                _k, ev = self._mem.popitem(last=False)
                self._mem_bytes -= len(ev)
        else:
            self._mem.move_to_end(key)
        if self.on_read is not None:
            self.on_read(time.monotonic() - t0, self.hydrations > h0)
        return body[start:end]

    # -- kafka-space location -----------------------------------------
    @staticmethod
    def kafka_start(meta: SegmentMeta) -> int:
        """First kafka offset at-or-after the segment base."""
        return int(meta.base_offset) - int(meta.delta_offset)

    def cloud_start_kafka(self, manifest: PartitionManifest) -> Optional[int]:
        if not manifest.segments:
            return None
        return self.kafka_start(manifest.segments[0])

    def find_segment(
        self, manifest: PartitionManifest, kafka_offset: int
    ) -> Optional[SegmentMeta]:
        segs = manifest.segments
        if not segs:
            return None
        find_k = getattr(segs, "find_kafka", None)
        if find_k is not None:
            hit = find_k(kafka_offset)
            return hit[1] if hit is not None else None
        starts = [self.kafka_start(s) for s in segs]
        i = bisect.bisect_right(starts, kafka_offset) - 1
        if i < 0:
            return None
        return segs[i]

    # -- sparse index (remote_segment_index.{h,cc}) -------------------
    def _index_seek(self, key: str, kafka_offset: int) -> tuple[int, int] | None:
        """(pos, delta) of the closest indexed batch at-or-before the
        target kafka offset, or None to scan from the start."""
        samples = self._seg_index.get(key)
        if not samples:
            return None
        i = bisect.bisect_right(samples, (kafka_offset, 1 << 62, 0)) - 1
        if i < 0:
            return None
        _k, pos, delta = samples[i]
        return pos, delta

    def _index_add(self, key: str, kbase: int, pos: int, delta: int) -> None:
        samples = self._seg_index.setdefault(key, [])
        ent = (kbase, pos, delta)
        i = bisect.bisect_left(samples, ent)
        if i < len(samples) and samples[i] == ent:
            return
        # stride-gate: keep the index sparse
        if samples and i > 0 and pos - samples[i - 1][1] < INDEX_STRIDE:
            return
        samples.insert(i, ent)
        self._seg_index.move_to_end(key)
        while len(self._seg_index) > 256:
            self._seg_index.popitem(last=False)

    async def invalidate(self, key: str) -> None:
        """Forget a segment (re-uploaded or merged away): sparse index,
        in-memory LRU, AND the disk chunk cache — stale chunks under a
        reused key would otherwise serve old bytes. A read already in
        flight may re-cache old chunks after this returns; callers that
        reuse keys must tolerate one CRC-failed read before retry (the
        archiver avoids the race by never reusing segment keys within
        a term)."""
        self._seg_index.pop(key, None)
        data = self._mem.pop(key, None)
        if data is not None:
            self._mem_bytes -= len(data)
        if self.cache is not None:
            await self.cache.invalidate(key)

    # -- read ---------------------------------------------------------
    async def read_kafka(
        self,
        manifest: PartitionManifest,
        kafka_offset: int,
        max_bytes: int = 1 << 20,
        upto_kafka: Optional[int] = None,
    ) -> list[tuple[int, RecordBatch]]:
        """(kafka_base, batch) pairs from archived segments starting at
        kafka_offset — the same shape Partition.read_kafka returns for
        local data, so the fetch handler frames them identically."""
        out: list[tuple[int, RecordBatch]] = []
        consumed = 0
        meta = self.find_segment(manifest, kafka_offset)
        while meta is not None and consumed < max_bytes:
            key = manifest.segment_key(meta)
            view = _SegmentView(
                self,
                key,
                int(meta.size_bytes),
                int(getattr(meta, "size_compressed", 0)),
            )
            delta = int(meta.delta_offset)
            pos = 0
            seek = self._index_seek(key, kafka_offset)
            if seek is not None:
                pos, delta = seek
            last_sample_pos = pos
            hydration_failed = False
            while pos + HEADER_SIZE <= view.size and consumed < max_bytes:
                try:
                    hdr_bytes = await view.read(pos, HEADER_SIZE)
                except StoreError:
                    hydration_failed = True
                    break
                if len(hdr_bytes) < HEADER_SIZE:
                    break
                header = RecordBatchHeader.unpack(hdr_bytes)
                if (
                    header.size_bytes < HEADER_SIZE
                    or pos + header.size_bytes > view.size
                ):
                    break
                if header.type != RecordBatchType.raft_data:
                    delta += header.last_offset_delta + 1
                    pos += header.size_bytes
                    continue
                kbase = header.base_offset - delta
                klast = kbase + header.last_offset_delta
                if pos - last_sample_pos >= INDEX_STRIDE or pos == 0:
                    self._index_add(key, kbase, pos, delta)
                    last_sample_pos = pos
                if upto_kafka is not None and kbase >= upto_kafka:
                    return out
                if klast >= kafka_offset:
                    try:
                        body = await view.read(
                            pos + HEADER_SIZE, header.size_bytes - HEADER_SIZE
                        )
                    except StoreError:
                        hydration_failed = True
                        break
                    if len(body) != header.size_bytes - HEADER_SIZE:
                        # object shorter than the manifest promised
                        # (truncated upload): partial results, like a
                        # short header read — not a CRC error
                        hydration_failed = True
                        break
                    batch = RecordBatch(header, body)
                    if not batch.verify_crc():
                        # poisoned chunks: drop the cached bytes that
                        # served this batch, or every retry re-reads
                        # the same corruption from disk; then surface a
                        # RETRIABLE error — the re-hydration heals a
                        # torn cache, and true object corruption keeps
                        # failing loudly instead of silently serving
                        self._degrade("crc_mismatch")
                        if self.cache is not None:
                            await self.cache.invalidate_range(
                                key, pos, pos + header.size_bytes
                            )
                        stale = self._mem.pop(key, None)
                        if stale is not None:
                            self._mem_bytes -= len(stale)
                        raise CloudUnavailableError(
                            f"archived batch CRC mismatch at "
                            f"{header.base_offset}"
                        )
                    out.append((kbase, batch))
                    consumed += header.size_bytes
                pos += header.size_bytes
            if hydration_failed:
                if not out:
                    # nothing served and the store's bounded retry
                    # budget is spent: typed degradation the fetch
                    # handler maps to a RETRIABLE Kafka error code —
                    # never a hung fetch, never a bogus out-of-range
                    self._degrade("cloud_unavailable")
                    raise CloudUnavailableError(
                        f"archived read at kafka offset {kafka_offset} "
                        f"failed after bounded retries ({key})"
                    )
                # partial progress: return what hydrated; the client
                # continues from the next offset and retries there
                self._degrade("partial_remote_read")
                break
            # next segment in offset order (O(log) on the columnar
            # store; list fallback keeps .index)
            segs = manifest.segments
            iob = getattr(segs, "index_of_base", None)
            idx = (
                iob(int(meta.base_offset))
                if iob is not None
                else segs.index(meta)
            )
            meta = (
                segs[idx + 1]
                if idx is not None and idx + 1 < len(segs)
                else None
            )
        return out
