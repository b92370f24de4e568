"""Per-partition archival to the object store.

Reference: src/v/archival/ntp_archiver_service.h:140 (upload loop:
closed, committed segments upload in offset order; the manifest is
rewritten after each batch of uploads) and archival_policy.cc
(upload_candidate selection).

Upload ordering invariant: segment objects are put BEFORE the manifest
that references them, so a crashed archiver never publishes a manifest
pointing at missing objects — at worst it re-uploads an orphan.
Compaction note: segments are archived as-is at upload time; a later
compaction rewrite of a local segment is NOT re-uploaded (the cloud
copy keeps the uncompacted records; offsets are identical either way).
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import TYPE_CHECKING, Callable, Optional

from ..cluster import archival_stm
from ..models.record import (
    HEADER_SIZE,
    RecordBatchBuilder,
    RecordBatchHeader,
    RecordBatchType,
)
from ..raft.consensus import NotLeaderError, ReplicateTimeout
from ..utils.tasks import cancel_and_wait
from .manifest import PartitionManifest, SegmentMeta
from .object_store import ObjectStore, RetryingStore, StoreError

if TYPE_CHECKING:  # pragma: no cover
    from ..cluster.partition import Partition

logger = logging.getLogger("cloud.archiver")


def _archive_compression() -> str:
    """Segment-object compression for uploads: RP_ARCHIVE_COMPRESSION=
    zstd compresses each segment on the way to the store (through the
    registry, so RP_ZSTD_BACKEND=tpu makes it the fused device path);
    default "none" stores segments verbatim. Read at call time so the
    bench A/B and tests flip it per-pass. Decoding is driven by the
    manifest's per-segment size_compressed, NOT this knob — mixed
    buckets (some segments compressed, some not) always hydrate
    correctly."""
    return os.environ.get("RP_ARCHIVE_COMPRESSION", "none").strip().lower()


def _compress_segment(data: bytes) -> bytes:
    from .. import compression

    return compression.compress(data, compression.CompressionType.zstd)


def _uncompress_segment(blob: bytes) -> bytes:
    from .. import compression

    return compression.uncompress(blob, compression.CompressionType.zstd)


class NtpArchiver:
    """Leader-side upload loop for one partition.

    Archived-range METADATA lives in the replicated archival stm
    (partition.archival — cluster/archival_stm.py): after each segment
    upload the leader replicates an add_segment command, so every
    replica learns the archived boundary from its own log. The object
    store's manifest.bin is the EXTERNAL record (remote readers, topic
    recovery) and is re-exported from the replicated state after each
    upload. Reference: archival/ntp_archiver_service.cc upload loop +
    archival_metadata_stm command replication."""

    def __init__(self, partition: "Partition", store: ObjectStore):
        self.partition = partition
        # every archiver op must run under a retry budget + deadline
        # (rplint RPL013): wrap raw stores, keep already-budgeted ones
        self.store = (
            store if isinstance(store, RetryingStore) else RetryingStore(store)
        )
        # observability hook: called with a degradation kind (string)
        # when the archiver detects/repairs a fault (CloudProbe)
        self.on_degraded: Optional[Callable] = None
        # async callback(key) invoked after a replaced segment object is
        # deleted (remote-reader cache hygiene); set by ArchivalService
        self.on_replaced: Optional[Callable] = None
        # store-manifest fallback for remote reads before the stm has
        # state (e.g. topic recovery attach before the seed snapshot
        # restores); the property below prefers replicated state
        self._manifest_fallback: Optional[PartitionManifest] = None
        self._synced_term = -1
        # (archived_upto, revision) of the store's exported
        # manifest.bin (learned at sync, advanced by _export_manifest)
        self._store_upto = -1
        self._store_rev = -1

    @property
    def manifest(self) -> Optional[PartitionManifest]:
        # single derivation: the partition's stm-backed view (which
        # consults our _manifest_fallback when the stm is empty)
        return self.partition.cloud_manifest()

    @manifest.setter
    def manifest(self, m: Optional[PartitionManifest]) -> None:
        self._manifest_fallback = m

    @property
    def archived_upto(self) -> int:
        """Last archived raft offset from the REPLICATED stm (-1 =
        nothing known archived; retention then reclaims nothing)."""
        stm = self.partition.archival
        stm.apply_committed(self.partition.consensus.commit_index)
        return stm.archived_upto

    def _manifest_key(self) -> str:
        ntp = self.partition.ntp
        return (
            f"{PartitionManifest.prefix(ntp.ns, ntp.topic, ntp.partition)}"
            "/manifest.bin"
        )

    async def _replicate_cmd(self, key: bytes, value: bytes) -> None:
        b = RecordBatchBuilder(batch_type=RecordBatchType.archival_metadata)
        b.add(value=value, key=key)
        await self.partition.replicate(b.build(), acks=-1)

    async def _sync_from_store(self) -> None:
        """Once per leadership term: if the store manifest is AHEAD of
        the replicated state (crash after upload before the command
        committed, or a bucket-recovered topic), replicate a reset so
        the cluster converges on what the store already holds. Also
        learns how far the store's exported manifest reaches, so
        `_export_manifest` can heal the opposite skew (replicated
        ahead of the store: crash between the commit and the put)."""
        p = self.partition
        if self._synced_term == p.consensus.term:
            return
        key = self._manifest_key()
        self._store_upto = -1
        self._store_rev = -1
        if await self.store.exists(key):
            try:
                store_m = PartitionManifest.decode(await self.store.get(key))
            except StoreError:
                raise
            except Exception as e:
                # torn manifest: the last export was cut mid-write (a
                # partial PUT a non-atomic backend persisted). The
                # replicated stm still holds the previous good state —
                # fall back to it and leave _store_upto at -1 so
                # _export_manifest re-publishes a whole manifest over
                # the torn object. Never decode-and-serve a dangling
                # segment reference from the torn copy.
                logger.warning(
                    "%s: torn store manifest (%s); re-exporting from "
                    "replicated state",
                    p.ntp,
                    e,
                )
                if self.on_degraded is not None:
                    self.on_degraded("torn_manifest")
                self._synced_term = p.consensus.term
                return
            self._store_upto = store_m.archived_upto
            self._store_rev = int(store_m.revision)
            if store_m.archived_upto > self.archived_upto:
                await self._replicate_cmd(archival_stm.RESET, store_m.encode())
        self._synced_term = p.consensus.term

    async def _export_manifest(self) -> None:
        """Re-publish manifest.bin when the replicated state is ahead
        of the store copy (external readers + topic recovery read the
        store, so it must converge even without new uploads)."""
        stm = self.partition.archival
        if (
            stm.archived_upto <= self._store_upto
            and stm.revision == self._store_rev
        ):
            return
        ntp = self.partition.ntp
        await self.store.put(
            self._manifest_key(),
            stm.to_manifest(ntp.ns, ntp.topic, ntp.partition).encode(),
        )
        self._store_upto = stm.archived_upto
        self._store_rev = stm.revision

    async def _cloud_retention_pass(self, now_ms: int | None = None) -> None:
        """Apply retention.* to the ARCHIVED history (the reference's
        archival retention_calculator + garbage collection): without
        it the bucket grows forever. Only runs for topics with split
        retention (retention.local.target.* set) — otherwise
        retention.* already governs the local log and the cloud keeps
        the full history for recovery. Drops whole leading segments,
        never the newest one; the replicated TRUNCATE commits BEFORE
        objects are deleted, so no replica can serve a dropped range
        from a manifest that still lists it."""
        import time as _time

        if now_ms is None:
            now_ms = int(_time.time() * 1000)
        p = self.partition
        cfg = p.log.config
        if (
            cfg.local_retention_bytes is None
            and cfg.local_retention_ms is None
        ):
            return
        if cfg.retention_bytes is None and cfg.retention_ms is None:
            return
        stm = p.archival
        stm.apply_committed(p.consensus.commit_index)
        segs = stm.segments
        if len(segs) <= 1:
            return
        from ..storage.log import retention_drop_upto

        drop_upto = retention_drop_upto(
            [
                (int(s.size_bytes), int(s.max_timestamp), int(s.last_offset))
                for s in segs
            ],
            cfg.retention_bytes,
            cfg.retention_ms,
            now_ms,
        )
        if drop_upto is None:
            return
        new_start = drop_upto + 1
        dropped = [s for s in segs if int(s.last_offset) < new_start]
        ntp = p.ntp
        prefix = PartitionManifest.prefix(ntp.ns, ntp.topic, ntp.partition)
        # replicate FIRST: once committed, no replica's manifest view
        # references the doomed range; object deletion follows
        await self._replicate_cmd(
            archival_stm.TRUNCATE,
            int(new_start).to_bytes(8, "little", signed=True),
        )
        stm.apply_committed(p.consensus.commit_index)
        # publish the truncated manifest BEFORE deleting objects: an
        # external reader following the store manifest must never see
        # entries whose objects are already gone (module invariant)
        await self._export_manifest()
        for meta in dropped:
            try:
                await self.store.delete(f"{prefix}/{meta.name}")
            except StoreError as e:
                # orphaned object: harmless, retried never (reference
                # GC has the same leak-on-crash window)
                logger.warning(
                    "%s: failed to delete archived %s: %s",
                    ntp,
                    meta.name,
                    e,
                )
        logger.info(
            "%s: cloud retention dropped %d archived segments (new "
            "start %d)",
            ntp,
            len(dropped),
            new_start,
        )

    async def housekeeping_pass(
        self, min_bytes: int, target_bytes: int
    ) -> int:
        """Merge ONE run of small adjacent archived segments into a
        single object (archival/adjacent_segment_merger.cc selection +
        segment_reupload.cc reupload): many tiny objects make remote
        reads and manifest scans expensive, so housekeeping compacts
        them. Bounded to one merge per pass — housekeeping shares the
        loop with uploads. Ordering: merged object is PUT before the
        REPLACE commits, old objects are deleted only after the
        truncated manifest is exported (module upload-before-publish
        invariant); a crash at any point leaves only orphans, never a
        manifest entry without its object. Returns merges done (0/1)."""
        p = self.partition
        if min_bytes <= 0 or not p.consensus.is_leader():
            return 0
        stm = p.archival
        stm.apply_committed(p.consensus.commit_index)
        segs = stm.segments
        i = 0
        while i < len(segs) - 1:
            if int(segs[i].size_bytes) >= min_bytes:
                i += 1
                continue
            j = i
            total = 0
            while (
                j < len(segs)
                and int(segs[j].size_bytes) < min_bytes
                and total + int(segs[j].size_bytes) <= target_bytes
                and (
                    j == i
                    or int(segs[j].base_offset)
                    == int(segs[j - 1].last_offset) + 1
                )
            ):
                total += int(segs[j].size_bytes)
                j += 1
            run = segs[i:j]
            if len(run) < 2:
                i = max(j, i + 1)
                continue
            if await self._merge_run(run):
                return 1
            # failed run (corrupt object, store hiccup): keep scanning
            # so one bad run can't livelock merging for the partition
            i = max(j, i + 1)
        return 0

    async def _merge_run(self, run: list[SegmentMeta]) -> int:
        p = self.partition
        ntp = p.ntp
        prefix = PartitionManifest.prefix(ntp.ns, ntp.topic, ntp.partition)
        datas = []
        try:
            for m in run:
                data = await self.store.get(f"{prefix}/{m.name}")
                # the stored object is size_compressed bytes when the
                # segment was archived compressed, size_bytes otherwise
                comp = int(getattr(m, "size_compressed", 0))
                want = comp or int(m.size_bytes)
                if len(data) != want:
                    logger.warning(
                        "%s: merge aborted: %s is %d bytes, manifest "
                        "says %d",
                        ntp,
                        m.name,
                        len(data),
                        want,
                    )
                    return 0
                if comp:
                    data = _uncompress_segment(data)
                    if len(data) != int(m.size_bytes):
                        logger.warning(
                            "%s: merge aborted: %s inflates to %d "
                            "bytes, manifest says %d",
                            ntp,
                            m.name,
                            len(data),
                            m.size_bytes,
                        )
                        return 0
                datas.append(data)
        except (StoreError, ValueError) as e:
            logger.warning("%s: merge download failed: %s", ntp, e)
            return 0
        first, last = run[0], run[-1]
        body = b"".join(datas)
        blob = body
        size_compressed = 0
        suffix = "m.seg"
        if _archive_compression() == "zstd":
            blob = _compress_segment(body)
            size_compressed = len(blob)
            suffix = "m.seg.zst"
        merged = SegmentMeta(
            base_offset=first.base_offset,
            last_offset=last.last_offset,
            term=last.term,
            size_bytes=len(body),
            base_timestamp=first.base_timestamp,
            max_timestamp=max(int(m.max_timestamp) for m in run),
            delta_offset=first.delta_offset,
            delta_offset_end=last.delta_offset_end,
            # never collides with a replaced key (those are base-term);
            # a re-run of the same merge recreates the same name with
            # identical content, so the orphan window is idempotent
            name_hint=(
                f"{first.base_offset}-{last.last_offset}-{last.term}"
                f".{suffix}"
            ),
            size_compressed=size_compressed,
        )
        try:
            await self.store.put(f"{prefix}/{merged.name}", blob)
            await self._replicate_cmd(archival_stm.REPLACE, merged.encode())
            self.partition.archival.apply_committed(
                p.consensus.commit_index
            )
            await self._export_manifest()
        except (StoreError, NotLeaderError, ReplicateTimeout) as e:
            logger.warning("%s: segment merge failed: %s", ntp, e)
            return 0
        for m in run:
            key = f"{prefix}/{m.name}"
            try:
                await self.store.delete(key)
            except StoreError as e:
                logger.warning(
                    "%s: failed to delete merged-away %s: %s", ntp, m.name, e
                )
            if self.on_replaced is not None:
                await self.on_replaced(key)
        logger.info(
            "%s: merged %d archived segments [%d,%d] into %s",
            ntp,
            len(run),
            int(first.base_offset),
            int(last.last_offset),
            merged.name,
        )
        return 1

    async def upload_pass(self) -> int:
        """One archival round: upload every closed segment whose range
        is fully committed+flushed and above the archived boundary, in
        offset order; replicate add_segment after each upload. Returns
        the number of segments uploaded. Followers do nothing — their
        state arrives through the log."""
        p = self.partition
        if not p.consensus.is_leader():
            return 0
        try:
            await self._sync_from_store()
            await self._export_manifest()
        except (StoreError, NotLeaderError, ReplicateTimeout) as e:
            logger.warning("%s: archival store sync failed: %s", p.ntp, e)
            return 0
        log = p.log
        stm = p.archival
        boundary = min(p.consensus.commit_index, log.offsets().committed_offset)
        uploaded = 0
        for seg in list(log._segments[:-1]):  # never the active tail
            if seg.dirty_offset < seg.base_offset:
                continue
            if seg.dirty_offset <= self.archived_upto:
                continue  # fully archived already
            if seg.dirty_offset > boundary:
                break  # in offset order: later segments are above too
            try:
                with open(seg._path, "rb") as f:
                    data = f.read()
            except OSError:
                break
            base = seg.base_offset
            if base <= self.archived_upto:
                # the archived boundary lands INSIDE this segment: a
                # previous leader's segment layout differed (layouts are
                # per-replica; only BATCH boundaries are raft-aligned),
                # or a local merge re-cut them. Skipping the segment
                # would silently drop (archived_upto, dirty] from the
                # archive — the gap chaos caught. Slice the upload at
                # the first unarchived batch instead
                # (archival_policy.cc's offset-aligned candidate cut).
                pos = 0
                sliced = None
                while pos + HEADER_SIZE <= len(data):
                    header = RecordBatchHeader.unpack(
                        data[pos : pos + HEADER_SIZE]
                    )
                    if header.size_bytes < HEADER_SIZE:
                        break
                    if header.base_offset > self.archived_upto:
                        sliced = (header.base_offset, data[pos:])
                        break
                    pos += header.size_bytes
                if sliced is None:
                    # nothing decodable past the boundary: STOP the
                    # pass — uploading later segments over this hole
                    # would commit a permanent archive gap
                    break
                base, data = sliced
            # filtered batches strictly below the segment base: lets a
            # remote reader re-derive every batch's kafka offset by
            # walking the segment (manifest.py delta_offset contract)
            delta = (
                (base - 1) - p.translator.to_kafka(base - 1) if base > 0 else 0
            )
            # size_bytes stays the LOGICAL segment size (retention math,
            # batch-walk offsets); the object body may be a zstd frame
            # whose length the manifest records as size_compressed
            blob = data
            size_compressed = 0
            name_hint = ""
            if _archive_compression() == "zstd":
                blob = _compress_segment(data)
                size_compressed = len(blob)
                name_hint = f"{base}-{seg.term}.seg.zst"
            meta = SegmentMeta(
                base_offset=base,
                last_offset=seg.dirty_offset,
                term=seg.term,
                size_bytes=len(data),
                base_timestamp=-1,
                max_timestamp=seg.max_timestamp,
                delta_offset=delta,
                delta_offset_end=(
                    seg.dirty_offset - p.translator.to_kafka(seg.dirty_offset)
                ),
                name_hint=name_hint,
                size_compressed=size_compressed,
            )
            ntp = p.ntp
            seg_key = (
                f"{PartitionManifest.prefix(ntp.ns, ntp.topic, ntp.partition)}"
                f"/{meta.name}"
            )
            try:
                await self.store.put(seg_key, blob)
                # fault-atomicity: verify the object landed whole BEFORE
                # any manifest/stm references it. A faulty backend can
                # persist a truncated body and still error (the retry
                # loop then re-puts), or — worse — ack a short object;
                # the head check catches both, one re-upload heals it.
                size = await self.store.head(seg_key)
                if size != len(blob):
                    if self.on_degraded is not None:
                        self.on_degraded("partial_upload")
                    logger.warning(
                        "%s: partial upload of %s (%d/%d bytes); "
                        "re-uploading",
                        p.ntp,
                        meta.name,
                        size,
                        len(blob),
                    )
                    await self.store.put(seg_key, blob)
                    size = await self.store.head(seg_key)
                    if size != len(blob):
                        raise StoreError(
                            f"segment {meta.name} truncated in store "
                            f"({size}/{len(blob)} bytes) after re-upload"
                        )
                # replicate FIRST: the archived fact must be raft-agreed
                # before anything (retention!) can act on it. A crash
                # between the replicate and the export leaves the store
                # manifest behind; _export_manifest heals it (here, or
                # on the next pass / next leadership sync).
                await self._replicate_cmd(archival_stm.ADD_SEGMENT, meta.encode())
                stm.apply_committed(p.consensus.commit_index)
                await self._export_manifest()
            except (StoreError, NotLeaderError, ReplicateTimeout) as e:
                logger.warning(
                    "%s: upload failed at segment %d: %s",
                    p.ntp,
                    base,
                    e,
                )
                break
            uploaded += 1
        try:
            # retention AFTER uploads: the pass's own tail upload counts
            # against the budget it is judged by
            await self._cloud_retention_pass()
        except (StoreError, NotLeaderError, ReplicateTimeout) as e:
            logger.warning("%s: cloud retention failed: %s", p.ntp, e)
        return uploaded


class ArchivalService:
    """Broker-level archival driver (the scheduler around per-NTP
    archivers; upload_controller analog). Walks local partitions whose
    topic enables remote writes and runs an upload pass on leaders."""

    def __init__(
        self,
        store: ObjectStore,
        partitions: Callable[[], dict],  # ntp -> Partition
        topic_table,  # cluster.topic_table.TopicTable
        interval_s: float = 1.0,
        sched_group=None,  # resource_mgmt.SchedulingGroup | None
        merge_min_bytes: int = 0,  # 0 disables adjacent-segment merging
        merge_target_bytes: int = 16 << 20,
    ):
        self.merge_min_bytes = merge_min_bytes
        self.merge_target_bytes = merge_target_bytes
        self.merges = 0
        # async callback(key): invalidate remote-reader caches for a
        # deleted object key (set by the broker)
        self.on_replaced: Optional[Callable] = None
        # degradation-event callback(kind) propagated to archivers
        self.on_degraded: Optional[Callable] = None
        self.store = (
            store if isinstance(store, RetryingStore) else RetryingStore(store)
        )
        self._partitions = partitions
        self._topic_table = topic_table
        self.interval_s = interval_s
        self._sched_group = sched_group
        self._archivers: dict = {}
        # tp_ns -> uploaded (partition_count, rf, config) shape
        self._topic_manifests: dict = {}
        self._task: Optional[asyncio.Task] = None

    def archiver_for(self, partition: "Partition") -> NtpArchiver:
        a = self._archivers.get(partition.ntp)
        if a is None or a.partition is not partition:
            a = NtpArchiver(partition, self.store)
            self._archivers[partition.ntp] = a
            partition.archiver = a
        return a

    @staticmethod
    def _truthy(v) -> bool:
        return str(v).lower() in ("true", "1", "yes")

    def remote_write_enabled(self, tp_ns) -> bool:
        md = self._topic_table.get(tp_ns)
        return md is not None and self._truthy(
            md.config.get("redpanda.remote.write")
        )

    async def start(self) -> None:
        self._task = asyncio.ensure_future(self._loop())

    async def stop(self) -> None:
        # cancel every in-flight upload retry loop (retry_chain root
        # abort), then the scheduler task
        self.store.abort()
        task, self._task = self._task, None
        await cancel_and_wait(task)

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                await self.run_once()
            except Exception:
                logger.exception("archival pass failed")

    async def run_once(self) -> int:
        total = 0
        for ntp, p in list(self._partitions().items()):
            if not self.remote_write_enabled(ntp.tp_ns):
                continue

            async def unit(ntp=ntp, p=p) -> int:
                await self._ensure_topic_manifest(ntp.tp_ns)
                a = self.archiver_for(p)
                a.on_replaced = self.on_replaced
                a.on_degraded = self.on_degraded
                n = await a.upload_pass()
                # merges are counted separately: callers assert on
                # upload counts. The await must settle BEFORE the +=
                # touches self.merges: `self.merges += await ...` reads
                # the counter, suspends, and writes the stale sum back,
                # losing every merge another unit counted meanwhile.
                merged = await a.housekeeping_pass(
                    self.merge_min_bytes, self.merge_target_bytes
                )
                self.merges += merged
                return n

            # one partition's upload pass = one unit through the
            # archival scheduling group (when wired): uploads share the
            # loop fairly with compaction instead of racing it
            if self._sched_group is not None:
                total += await self._sched_group.run(unit)
            else:
                total += await unit()
        # drop archivers for partitions no longer hosted
        live = self._partitions()
        for ntp in list(self._archivers):
            if ntp not in live:
                del self._archivers[ntp]
        return total

    async def _ensure_topic_manifest(self, tp_ns) -> None:
        """Topic config/shape for disaster recovery
        (topic_manifest.h): uploaded once, rewritten when it changes."""
        from .manifest import TopicManifest

        md = self._topic_table.get(tp_ns)
        if md is None:
            return
        shape = (
            md.partition_count,
            md.replication_factor,
            tuple(sorted(md.config.items())),
        )
        if self._topic_manifests.get(tp_ns) == shape:
            return
        tm = TopicManifest(
            ns=tp_ns.ns,
            topic=tp_ns.topic,
            partition_count=md.partition_count,
            replication_factor=md.replication_factor,
            config=dict(md.config),
        )
        try:
            await self.store.put(tm.key(), tm.encode())
        except StoreError:
            return
        self._topic_manifests[tp_ns] = shape
