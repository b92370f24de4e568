"""Partition facade (reference: src/v/cluster/partition.{h,cc}).

One replica of one data partition: raft consensus + log + offset
translator, presenting the *Kafka* offset space to the protocol layer
(the reference splits this between cluster::partition and
kafka::replicated_partition — here they are one object since the
translation is the only adaptation needed at this stage).
"""

from __future__ import annotations

import asyncio
import logging
import time

from ..models.fundamental import NTP
from ..models.record import (
    RecordBatch,
    RecordBatchBuilder,
    RecordBatchType,
    WireSpan,
)
from ..raft.consensus import Consensus, NotLeaderError  # noqa: F401 (re-export)
from ..raft.offset_translator import OffsetTranslator
from ..raft.replicate_batcher import ReplicateStages, consume_exc
from ..storage.log import Log
from ..utils import serde
from .archival_stm import ArchivalState
from .producer_state import (
    DuplicateSequence,
    ProducerFenced,
    ProducerStateTable,
)
from .tx_state import COMMIT_MARKER, TxTracker, control_record_key, parse_control_key

logger = logging.getLogger("partition")


class _PartitionSnapshot(serde.Envelope):
    """Partition contribution to the raft snapshot payload
    (rm_stm snapshot analog: translator + producer dedupe + tx state)."""

    SERDE_VERSION = 2
    SERDE_FIELDS = [
        ("translator", serde.bytes_t),
        ("producers", serde.bytes_t),
        ("tx", serde.bytes_t),
        # v2: replicated archival metadata (archival_metadata_stm)
        ("archival", serde.bytes_t),
    ]
    SERDE_DEFAULTS = {"archival": b""}


class Partition:
    # producer.id.expiration.ms analog (rm_stm producer eviction);
    # class-wide so the cluster-config binding reaches every replica
    producer_expiry_ms: int = 24 * 3600 * 1000

    def __init__(self, ntp: NTP, group_id: int, consensus: Consensus):
        self.ntp = ntp
        self.group_id = group_id
        self.consensus = consensus
        self.log: Log = consensus.log
        self.translator = OffsetTranslator(
            kvstore=consensus.kvstore, group_id=group_id
        )
        self.producers = ProducerStateTable()
        self.tx = TxTracker()
        # (pid, epoch, first_seq, last_seq) → in-flight stages: retries
        # arriving before the first attempt lands alias its result
        self._inflight: dict[tuple, ReplicateStages] = {}
        # pid → (epoch, last dispatched seq): the sequencing horizon
        # ahead of the table while appends sit in the batcher
        self._inflight_seq: dict[int, tuple[int, int]] = {}
        # DeleteRecords floors: (marker raft offset, kafka floor).
        # A floor takes effect only once ITS OWN marker commits —
        # honoring an uncommitted marker that later gets truncated
        # would prefix-truncate one replica while the cluster never
        # agreed to delete. Set BEFORE replay.
        self._dr_markers: list[tuple[int, int]] = []
        # replicated archival metadata (archival_metadata_stm analog):
        # every replica learns "archived upto X" from the log, so
        # retention gating and failover never consult the object
        # store. Set BEFORE replay.
        self.archival = ArchivalState()
        if consensus.staged_snapshot("partition") is None:
            self._rebuild_state()
        # else: registration below restores the snapshot payload and
        # replays only the log suffix — running the full-log rebuild
        # first would be thrown-away work
        self.archival.apply_committed(consensus.commit_index)
        self.log.on_append.append(self._on_append)
        self.log.on_truncate.append(self._on_truncate)
        self.log.on_prefix_truncate.append(self._on_prefix_truncate)
        # raft snapshots carry our derived state so a follower restored
        # from one need not replay the discarded prefix
        consensus.register_snapshot_contributor("partition", self)
        self.log.housekeeping_override = self.housekeeping
        # tiered storage (set by ArchivalService for remote.write
        # topics): archiver gates local retention on the uploaded
        # boundary; remote reads serve fetches below the local start
        self.archiver = None

    # -- derived-state maintenance -----------------------------------
    def _replay_from(self, pos: int) -> None:
        """Re-track log batches from pos (idempotent: translator and
        producer table both dedupe already-seen entries)."""
        offs = self.log.offsets()
        pos = max(pos, offs.start_offset, 0)
        while pos <= offs.dirty_offset:
            batches = self.log.read(pos, max_bytes=1 << 22)
            if not batches:
                break
            for b in batches:
                self._observe(b)
                pos = b.header.last_offset + 1

    def _rebuild_state(self) -> None:
        """Recover offset translation + producer dedupe state from the
        log (reference: raft/offset_translator.cc hydration and
        rm_stm.cc log replay)."""
        self._replay_from(0)
        self.translator.checkpoint()

    def _observe(self, batch: RecordBatch) -> None:
        h = batch.header
        self.translator.track(h.type, h.base_offset, h.last_offset)
        if h.type == RecordBatchType.archival_metadata:
            try:
                self.archival.stage_batch(batch)
            except Exception:
                pass  # replay must never wedge on a bad command batch
            return
        if h.type == RecordBatchType.checkpoint:
            # replicated DeleteRecords marker: every replica moves its
            # log start identically once the marker commits (the
            # reference's prefix_truncate batch; kafka DeleteRecords)
            try:
                rec = batch.records()[0]
                if rec.key == b"delete_records" and rec.value:
                    self._dr_markers.append(
                        (
                            h.base_offset,
                            int.from_bytes(rec.value, "little", signed=True),
                        )
                    )
            except Exception:
                pass
            return
        if h.type != RecordBatchType.raft_data or h.producer_id < 0:
            return
        kbase = self.translator.to_kafka(h.base_offset)
        if h.is_control:
            # tx marker written by the coordinator (rm_stm.cc apply of
            # commit/abort control batches)
            try:
                kind = parse_control_key(batch.records()[0].key)
            except Exception:
                kind = None
            if kind is not None:
                self.tx.observe_marker(
                    h.producer_id,
                    h.producer_epoch,
                    kind == COMMIT_MARKER,
                    kbase,
                )
            return
        if h.base_sequence >= 0:
            # last_offset_delta (NOT record_count-1): compaction may
            # shrink record_count but preserves the offset span, and
            # the producer's sequence range tracks the original span
            self.producers.observe(
                h.producer_id,
                h.producer_epoch,
                h.base_sequence,
                h.base_sequence + h.last_offset_delta,
                kbase,
                ts_ms=h.max_timestamp,
            )
        if h.is_transactional:
            self.tx.observe_data(h.producer_id, h.producer_epoch, kbase)

    def _on_append(self, batch: RecordBatch) -> None:
        self._observe(batch)

    def _on_truncate(self, offset: int) -> None:
        self.translator.truncate(offset)
        # a truncated (never-committed) DeleteRecords marker must not
        # leave its floor behind
        self._dr_markers = [
            (moff, floor) for moff, floor in self._dr_markers if moff < offset
        ]
        # sequence/tx state may reference truncated batches: rebuild
        # from the surviving log (rare path — divergent-leader healing)
        self.producers.truncate()
        self.tx.clear()
        # applied archival state covers only COMMITTED commands, which
        # truncation can never reach — only the staged tail rebuilds
        self.archival.drop_pending()
        self._replay_from(0)

    def _on_prefix_truncate(self, new_start: int) -> None:
        self.translator.prefix_truncate(new_start)
        self.translator.checkpoint()
        self.tx.prune(self.start_offset())

    # -- raft snapshot contributor ------------------------------------
    def capture_snapshot(self, upto: int) -> bytes:
        """The producer table tracks appends, so its capture may run
        slightly ahead of `upto`; re-observing those batches after a
        restore is idempotent (observe() dedupes by epoch/seq)."""
        self.archival.apply_committed(self.consensus.commit_index)
        return _PartitionSnapshot(
            translator=self.translator.capture_upto(upto),
            producers=self.producers.encode(),
            tx=self.tx.encode(),
            archival=self.archival.encode(),
        ).encode()

    def restore_snapshot(self, blob: bytes, last_included: int) -> None:
        ps = _PartitionSnapshot.decode(blob)
        self.translator.restore(ps.translator)
        self.producers = ProducerStateTable.decode(ps.producers)
        self.tx = TxTracker.decode(ps.tx)
        self.archival = ArchivalState.decode(ps.archival)
        # re-track whatever survives in the log above the boundary
        # (normally nothing: install resets the log)
        self._replay_from(last_included + 1)
        self.translator.checkpoint()

    # -- delete records ------------------------------------------------
    async def delete_records(self, kafka_offset: int, timeout: float = 10.0) -> int:
        """Kafka DeleteRecords: move the log start to kafka_offset
        (-1 = high watermark). Replicates a marker so every replica —
        and any future replay — applies the same floor, then truncates
        locally. Returns the new low watermark (kafka space)."""
        hw = self.high_watermark()
        target = hw if kafka_offset == -1 else kafka_offset
        if target < 0 or target > hw:
            raise ValueError(f"offset {kafka_offset} outside [0, {hw}]")
        if target <= self.start_offset():
            return self.start_offset()
        b = RecordBatchBuilder(batch_type=RecordBatchType.checkpoint)
        b.add(
            value=int(target).to_bytes(8, "little", signed=True),
            key=b"delete_records",
        )
        await self.replicate(b.build(), acks=-1, timeout=timeout)
        self.apply_delete_records()
        return self.start_offset()

    def apply_delete_records(self) -> None:
        """Apply floors whose MARKER has committed (leader on the
        request path; followers via housekeeping/replay)."""
        commit = self.consensus.commit_index
        floor = -1
        pending = []
        for moff, f in self._dr_markers:
            if moff <= commit:
                floor = max(floor, f)
            else:
                pending.append((moff, f))
        self._dr_markers = pending
        if floor < 0 or floor <= self.start_offset():
            return
        raft_target = self.translator.from_kafka(floor)
        bound = min(raft_target - 1, commit)
        if bound >= 0:
            self.consensus.write_snapshot(bound)

    # -- housekeeping -------------------------------------------------
    def housekeeping(self, now_ms: int | None = None) -> None:
        """Retention + compaction for a raft-replicated log
        (log_manager housekeeping + raft max_collectible_offset).

        Compaction rewrites only segments fully below the raft commit
        boundary — compaction preserves every batch's [base, last]
        range, so replication and the offset translator are unaffected,
        but uncommitted suffixes may still be truncated by a new leader
        and must stay byte-identical.

        Also applies any replicated DeleteRecords floor (followers pick
        it up here; the leader applies on the request path).

        Retention takes a snapshot covering the reclaimable prefix
        first, then drops only segments the snapshot covers — a stopped
        follower recovers via install_snapshot instead of being
        stranded."""
        self.apply_delete_records()
        evicted = self.producers.expire(
            now_ms if now_ms is not None else int(time.time() * 1000),
            self.producer_expiry_ms,
            active=set(self._inflight_seq),
        )
        if evicted:
            logger.info(
                "%s: expired %d idle producer ids", self.ntp, len(evicted)
            )
        if self.log.config.compaction_enabled:
            boundary = min(
                self.consensus.commit_index, self.log.offsets().committed_offset
            )
            if boundary >= 0:
                self.log.compact(boundary, visible=self._record_decided)
        if not self.log.config.deletion_enabled:
            return
        cfg = self.log.config
        local_limits = None
        if self.archiver is not None and (
            cfg.local_retention_bytes is not None
            or cfg.local_retention_ms is not None
        ):
            # tiered topic with split retention (Redpanda semantics):
            # retention.local.target.* trims the local suffix; the
            # archiver applies retention.* to the CLOUD history. The
            # pair REPLACES the cloud knobs for local trimming.
            local_limits = (cfg.local_retention_bytes, cfg.local_retention_ms)
        target = self.log.retention_offset(now_ms, limits=local_limits)
        if target is None:
            return
        if self.archiver is not None:
            # tiered topics: local data may only be reclaimed once it
            # is in the object store. The boundary comes from the
            # REPLICATED archival stm — every replica gates on the
            # same raft-agreed fact, no store reads (reference:
            # archival_metadata_stm retention hand-off)
            self.archival.apply_committed(self.consensus.commit_index)
            target = min(target, self.archival.archived_upto + 1)
            if target <= self.log.offsets().start_offset:
                return
        self.consensus.write_snapshot(target - 1)
        self.log.apply_retention(
            now_ms,
            max_offset=self.consensus.snapshot_index,
            limits=local_limits,
        )

    # -- tiered storage ------------------------------------------------
    def cloud_manifest(self):
        """Archived-range manifest from the REPLICATED stm — available
        on every replica the moment the commands commit, independent of
        whether an archiver object is attached yet (a freshly restarted
        broker can win leadership before its first archival sweep and
        must still serve archived reads). Falls back to the archiver's
        store-loaded manifest (topic recovery attach)."""
        self.archival.apply_committed(self.consensus.commit_index)
        if self.archival.segments:
            return self.archival.to_manifest(
                self.ntp.ns, self.ntp.topic, self.ntp.partition
            )
        if self.archiver is not None:
            return self.archiver._manifest_fallback
        return None

    def cloud_start_kafka(self) -> int | None:
        """First kafka offset readable from the object store, or None
        when nothing is archived / tiering is off."""
        m = self.cloud_manifest()
        if m is None or not m.segments:
            return None
        from ..cloud.remote_partition import RemoteReader

        return RemoteReader.kafka_start(m.segments[0])

    async def read_kafka_remote(
        self,
        reader,
        kafka_offset: int,
        max_bytes: int = 1 << 20,
        upto_kafka: int | None = None,
    ) -> list[tuple[int, RecordBatch]]:
        """Archived-range read (remote_partition.cc): same (kafka_base,
        batch) shape as read_kafka, served from uploaded segments."""
        m = self.cloud_manifest()
        if m is None:
            return []
        return await reader.read_kafka(m, kafka_offset, max_bytes, upto_kafka)

    def recover_from_cloud(self, manifest) -> bool:
        """Seed a FRESH, empty replica from a partition manifest
        (cloud_storage topic recovery): synthesize a local raft
        snapshot at the archived boundary so consensus, the offset
        translator, and the log all resume at archived_upto + 1, while
        the archived prefix serves reads remotely. Replicas that miss
        this seeding heal through normal install_snapshot from one
        that didn't. Producer idempotence state is NOT recovered (the
        manifest carries no producer table — reference recovery has
        the same gap)."""
        from ..raft.offset_translator import _State
        from ..raft.snapshot import RaftSnapshotMetadata, SnapshotPayload
        from ..storage import snapshot as snapfmt

        c = self.consensus
        last = manifest.archived_upto
        if (
            last < 0
            or self.log.offsets().dirty_offset >= 0
            or c.snapshot_index >= 0
        ):
            return False  # only a fresh, empty replica may be seeded
        seg = manifest.segments[-1]
        translator_state = _State(
            filtered=[],
            base=last + 1,
            base_delta=int(seg.delta_offset_end),
        ).encode()
        seeded = ArchivalState()
        seeded.segments = list(manifest.segments)
        seeded.revision = int(manifest.revision)
        payload = _PartitionSnapshot(
            translator=translator_state,
            producers=ProducerStateTable().encode(),
            tx=TxTracker().encode(),
            archival=seeded.encode(),
        ).encode()
        meta = RaftSnapshotMetadata(
            group=c.group_id,
            last_included_index=last,
            last_included_term=int(seg.term),
            config=c.config.encode(),
        )
        snapfmt.write_snapshot(
            c._snapshot_path,
            meta.encode(),
            SnapshotPayload(names=["partition"], blobs=[payload]).encode(),
        )
        c._load_snapshot()
        return True

    def _record_decided(self, batch, raft_offset: int) -> bool:
        """Compaction participation gate for transactional data: only a
        COMMITTED record may supersede (and be superseded). Aborted and
        undecided records neither supersede nor get removed — the
        fetch-side aborted-range filter owns their invisibility
        (rm_stm compaction gating on LSO + aborted-tx index)."""
        h = batch.header
        if not h.is_transactional:
            return True
        koff = self.translator.to_kafka(raft_offset)
        cur = self.tx.open.get(h.producer_id)
        if cur is not None and koff >= cur[1]:
            return False  # inside a still-open transaction
        return not any(
            pid == h.producer_id
            for pid, _first in self.tx.aborted_in(koff, koff + 1)
        )

    def close(self) -> None:
        if self._on_append in self.log.on_append:
            self.log.on_append.remove(self._on_append)
        if self._on_truncate in self.log.on_truncate:
            self.log.on_truncate.remove(self._on_truncate)
        if self._on_prefix_truncate in self.log.on_prefix_truncate:
            self.log.on_prefix_truncate.remove(self._on_prefix_truncate)
        if self.log.housekeeping_override is self.housekeeping:
            self.log.housekeeping_override = None
        self.translator.checkpoint()

    # -- kafka offset surface ----------------------------------------
    @property
    def is_leader(self) -> bool:
        return self.consensus.is_leader()

    @property
    def leader_id(self):
        return self.consensus.leader_id

    def high_watermark(self) -> int:
        """Next kafka offset past the committed prefix."""
        commit = self.consensus.commit_index
        if commit < 0:
            return 0
        return self.translator.to_kafka(commit) + 1

    def last_stable_offset(self) -> int:
        """HW bounded by the earliest open transaction (rm_stm LSO):
        READ_COMMITTED consumers must not observe offsets at or past an
        undecided transaction's first record."""
        hw = self.high_watermark()
        first_open = self.tx.first_open_offset()
        return hw if first_open is None else min(first_open, hw)

    def aborted_in(self, start: int, end: int) -> list[tuple[int, int]]:
        """(producer_id, first_offset) aborted-tx entries overlapping
        the fetch range (fetch response AbortedTransaction rows)."""
        return self.tx.aborted_in(start, end)

    def start_offset(self) -> int:
        """First VISIBLE kafka offset. The raft snapshot boundary is
        the logical log start — physical segment layout may lag behind
        it (a single open segment can't be prefix-dropped, and
        DeleteRecords moves the boundary without waiting for physical
        reclaim, exactly like Kafka's logStartOffset)."""
        offs = self.log.offsets()
        if offs.dirty_offset < 0 and self.consensus.snapshot_index < 0:
            return 0
        raft_start = max(
            offs.start_offset, self.consensus.snapshot_index + 1, 0
        )
        return self.translator.to_kafka(raft_start - 1) + 1

    # -- write -------------------------------------------------------
    async def replicate_in_stages(self, batch: RecordBatch, acks: int = -1):
        """Two-stage write (produce.cc:95-111): returns stages whose
        `enqueued` resolves with the kafka base offset once the batch
        is ordered in the log, and `done` at the requested ack level.

        Idempotence (rm_stm.cc dedupe): a retried batch returns its
        ORIGINAL offset — either from the producer table (already
        appended) or by aliasing the in-flight stages of the first
        attempt (enqueued via the batcher but not yet applied)."""
        h = batch.header
        if (
            h.is_transactional
            and h.producer_id >= 0
            and h.producer_epoch < self.tx.fence_epoch(h.producer_id)
        ):
            # zombie producer from a pre-bump epoch (rm_stm fencing)
            raise ProducerFenced(
                f"pid {h.producer_id} epoch {h.producer_epoch} < fence "
                f"{self.tx.fence_epoch(h.producer_id)}"
            )
        key = None
        if h.producer_id >= 0 and h.base_sequence >= 0:
            pid, epoch = h.producer_id, h.producer_epoch
            last_seq = h.base_sequence + h.record_count - 1
            key = (pid, epoch, h.base_sequence, last_seq)
            inflight = self._inflight.get(key)
            if inflight is not None:
                return inflight
            horizon = self._inflight_seq.get(pid)
            self.producers.check(
                pid,
                epoch,
                h.base_sequence,
                last_seq,
                inflight_last_seq=(
                    horizon[1]
                    if horizon is not None and horizon[0] == epoch
                    else None
                ),
            )
        ps = ReplicateStages()
        if key is not None:
            # register BEFORE any await so a concurrent retry aliases
            # this attempt instead of double-appending, and advance the
            # dispatch horizon so the NEXT sequence range checks clean
            # while this one is still in the batcher
            self._inflight[key] = ps
            pid, epoch, _first, last_seq = key
            cur = self._inflight_seq.get(pid)
            if cur is None or epoch > cur[0] or last_seq > cur[1]:
                self._inflight_seq[pid] = (epoch, last_seq)
            ps.done.add_done_callback(
                lambda f, k=key: self._settle_inflight(k, f)
            )
        try:
            raw = await self.consensus.replicate_in_stages(batch, acks)
        except BaseException as e:
            for fut in (ps.enqueued, ps.done):
                if not fut.done():
                    fut.set_exception(e)
                fut.exception()  # consumed: callers see the raise below
            raise
        self._chain(raw.enqueued, ps.enqueued)
        self._chain(raw.done, ps.done)
        return ps

    def _settle_inflight(self, key: tuple, fut: "asyncio.Future") -> None:
        self._inflight.pop(key, None)
        pid, epoch, _first, last_seq = key
        cur = self._inflight_seq.get(pid)
        if cur is None or cur[0] != epoch:
            return
        failed = fut.cancelled() or fut.exception() is not None
        if failed:
            # roll the horizon back to the table's truth: a retry of
            # this (or any later) range must not read as out-of-order
            self._inflight_seq.pop(pid, None)
        elif cur[1] == last_seq:
            # nothing dispatched beyond this batch: the table (updated
            # at append) is current again
            self._inflight_seq.pop(pid, None)

    def _chain(self, src: "asyncio.Future", dst: "asyncio.Future") -> None:
        """Map a consensus stage future to a kafka-base future. A
        (base, last) result translates at resolution time — the append
        (and its on_append tracking) has already run by then; a None
        result (the enqueued/dispatched stage) passes through."""

        def cb(f: "asyncio.Future") -> None:
            if dst.done():
                return
            if f.cancelled():
                dst.cancel()
                return
            e = f.exception()
            if e is not None:
                dst.set_exception(e)
            elif f.result() is None:
                dst.set_result(None)
            else:
                base, _last = f.result()
                dst.set_result(self.translator.to_kafka(base))

        src.add_done_callback(cb)

    async def replicate(
        self, batch: RecordBatch, acks: int = -1, timeout: float = 10.0
    ) -> int:
        """Returns the kafka base offset assigned to the batch."""
        try:
            ps = await self.replicate_in_stages(batch, acks)
        except DuplicateSequence as dup:
            return dup.base_offset
        try:
            return await asyncio.wait_for(asyncio.shield(ps.done), timeout)
        except asyncio.TimeoutError:
            from ..raft.consensus import ReplicateTimeout

            consume_exc(ps.done)  # abandoned: round settles later
            raise ReplicateTimeout(
                f"{self.ntp}: not acked in {timeout}s"
            ) from None

    async def write_tx_marker(
        self, pid: int, epoch: int, commit: bool, timeout: float = 10.0
    ) -> None:
        """Append a commit/abort control marker for the producer's open
        transaction (the WriteTxnMarkers path the tx coordinator drives
        through the gateway — reference rm_stm commit_tx/abort_tx).
        Idempotent: a redelivered marker for an already-closed tx is a
        no-op success."""
        from ..raft.consensus import NotLeaderError as _NLE

        if not self.consensus.is_leader():
            raise _NLE(self.consensus.leader_id)
        if not self.tx.has_open(pid, epoch) and self.tx.fence_epoch(pid) >= epoch:
            # nothing open AND the fence already covers this epoch:
            # duplicate delivery. (When the fence is still below the
            # marker epoch the marker must be appended even with no
            # open tx — a bumped-epoch abort racing an in-flight first
            # produce relies on the marker raising the fence, else the
            # late old-epoch batch would open an orphan tx that pins
            # the LSO forever; rm_stm writes its fence unconditionally.)
            return
        b = RecordBatchBuilder(
            producer_id=pid,
            producer_epoch=epoch,
            transactional=True,
            control=True,
        )
        b.add(value=b"", key=control_record_key(commit))
        await self.replicate(b.build(), acks=-1, timeout=timeout)

    # -- read --------------------------------------------------------
    def read_kafka(
        self,
        kafka_offset: int,
        max_bytes: int = 1 << 20,
        upto_kafka: int | None = None,
    ) -> list[tuple[int, RecordBatch]]:
        """Committed data batches from kafka_offset, as
        (kafka_base_offset, batch) pairs. The caller frames them for
        the wire with the translated base (the kafka body CRC does not
        cover base_offset, so no payload recompute — reference
        kafka/server/replicated_partition.cc translation)."""
        hw = self.high_watermark()
        bound = hw if upto_kafka is None else min(hw, upto_kafka)
        if kafka_offset >= bound:
            return []
        raft_pos = self.translator.from_kafka(kafka_offset)
        commit = self.consensus.commit_index
        out: list[tuple[int, RecordBatch]] = []
        consumed = 0
        while raft_pos <= commit and consumed < max_bytes:
            batches = self.log.read(
                raft_pos, max_bytes=max_bytes - consumed, upto=commit
            )
            if not batches:
                break
            for b in batches:
                raft_pos = b.header.last_offset + 1
                if b.header.type != RecordBatchType.raft_data:
                    continue
                kbase = self.translator.to_kafka(b.header.base_offset)
                if kbase >= bound:
                    return out
                out.append((kbase, b))
                consumed += b.size_bytes()
                if consumed >= max_bytes:
                    break
        return out

    def read_kafka_wire(
        self,
        kafka_offset: int,
        max_bytes: int = 1 << 20,
        upto_kafka: int | None = None,
    ) -> list[tuple[int, WireSpan]]:
        """Zero-copy twin of read_kafka: committed data batches from
        kafka_offset as (kafka_base_offset, WireSpan) pairs. Rows come
        out of the wire plane already in Kafka wire form; framing a
        fetch response is an 8-byte base-offset patch per span
        (WireSpan.patch_base — CRC-safe per the read_kafka contract),
        never a decode or re-encode. Batch-type filtering is done on
        the header peek the span walk recorded; bounds/budget semantics
        are identical to read_kafka so both paths return the same batch
        set for any (offset, max_bytes, upto_kafka)."""
        hw = self.high_watermark()
        bound = hw if upto_kafka is None else min(hw, upto_kafka)
        if kafka_offset >= bound:
            return []
        raft_pos = self.translator.from_kafka(kafka_offset)
        commit = self.consensus.commit_index
        out: list[tuple[int, WireSpan]] = []
        consumed = 0
        while raft_pos <= commit and consumed < max_bytes:
            rows = self.log.read_wire(
                raft_pos, max_bytes=max_bytes - consumed, upto=commit
            )
            if not rows:
                break
            for row in rows:
                raft_pos = row.last_offset + 1
                if row.batch_type != int(RecordBatchType.raft_data):
                    continue
                kbase = self.translator.to_kafka(row.base_offset)
                if kbase >= bound:
                    return out
                out.append((kbase, row))
                consumed += row.size_bytes()
                if consumed >= max_bytes:
                    break
        return out

    def offset_for_leader_epoch(self, epoch: int) -> tuple[int, int]:
        """(largest epoch <= requested, its exclusive end offset in
        kafka space) — the OffsetForLeaderEpoch contract clients use to
        detect divergence after leadership changes (reference:
        kafka/server/handlers/offset_for_leader_epoch.cc; leader epoch
        == raft term here). Returns (-1, -1) when no such epoch."""
        all_bounds = self.log.term_boundaries()
        # terms ascend, so matching bounds are a prefix of all_bounds
        idx = -1
        for i, (_start, term) in enumerate(all_bounds):
            if term > epoch:
                break
            idx = i
        if idx < 0:
            return -1, -1
        term = all_bounds[idx][1]
        if idx + 1 < len(all_bounds):
            next_start = all_bounds[idx + 1][0]
            end = self.translator.to_kafka(next_start - 1) + 1
        else:
            end = self.high_watermark()
        return term, end

    def timequery(self, ts_ms: int) -> int | None:
        raft_off = self.log.timequery(ts_ms)
        if raft_off is None:
            return None
        return self.translator.to_kafka(raft_off)
