"""Per-shard move endpoints: the freeze/ship/adopt/retire handlers the
PartitionMover drives (reference: the partition_manager move protocol,
src/v/cluster/shard_placement_table.cc x-shard transfer).

One MoveHost wraps one shard's (partition_manager, group_manager,
log_manager) triple — the same object serves as move SOURCE and move
TARGET. Shard 0 calls it in-process; worker shards expose it through
the `partition` invoke service as `move_*` methods, so every frame is
a serde envelope either way (RPL009).

Protocol (coordinator = placement.mover.PartitionMover):

  source.freeze   → MoveManifest (raft hard state + log bounds + blob)
  target.begin    → stage: create log, seed kvstore vote/cfg, snapshot
  source.read     → MoveChunk (RecordBatch.serialize frames)
  target.write    → append_exactly into the staged log
  target.commit   → partition_manager.manage over the staged state:
                    consensus restarts from the seeded hard state and
                    allocates a FRESH lane row (the rebind), derived
                    partition state rebuilds by log replay
  source.retire   → partition_manager.remove (frees the old row,
                    deletes shipped log files, forgets the ledger key)
  ...or on any failure: target.abort + source.thaw (rollback).
"""

from __future__ import annotations

import logging
import os

from ..models.fundamental import NTP
from .envelopes import (
    LaneMove,
    LaneMoveReply,
    MoveAck,
    MoveBegin,
    MoveChunk,
    MoveChunkRequest,
    MoveCommitReply,
    MoveManifest,
    MoveRef,
)

logger = logging.getLogger("placement.host")

CHUNK_BYTES = 1 << 20


class MoveFault(RuntimeError):
    """Raised by the injected fault hook (tests / RP_PLACEMENT_FAULT)."""


def _env_fault_stage() -> str | None:
    return os.environ.get("RP_PLACEMENT_FAULT") or None


class MoveHost:
    """One shard's side of the live-move protocol."""

    def __init__(self, partition_manager, group_manager, log_manager):
        self._pm = partition_manager
        self._gm = group_manager
        self._lm = log_manager
        # group → (ntp, log_config, manifest) staged by begin
        self._staged: dict[int, tuple] = {}
        # test seam: callable(stage: str) raising MoveFault to simulate
        # a host failing mid-protocol; RP_PLACEMENT_FAULT=<stage> arms
        # a one-shot env-driven equivalent for the smoke
        self.fault = None
        self._env_fault = _env_fault_stage()

    def _check_fault(self, stage: str) -> None:
        if self.fault is not None:
            self.fault(stage)
        if self._env_fault == stage:
            self._env_fault = None
            raise MoveFault(f"injected fault at {stage}")

    # -- envelope dispatch (worker-shard invoke service) --------------
    async def handle(self, method: str, payload: bytes) -> bytes:
        if method == "move_freeze":
            return (await self.freeze(MoveRef.decode(payload))).encode()
        if method == "move_read":
            return self.read(MoveChunkRequest.decode(payload)).encode()
        if method == "move_thaw":
            return (await self.thaw(MoveRef.decode(payload))).encode()
        if method == "move_retire":
            return (await self.retire(MoveRef.decode(payload))).encode()
        if method == "move_begin":
            return (await self.begin(MoveBegin.decode(payload))).encode()
        if method == "move_write":
            return (await self.write(MoveChunk.decode(payload))).encode()
        if method == "move_commit":
            return (await self.commit(MoveRef.decode(payload))).encode()
        if method == "move_abort":
            return (await self.abort(MoveRef.decode(payload))).encode()
        if method == "move_lane":
            return (await self.lane_move(LaneMove.decode(payload))).encode()
        raise LookupError(f"move: no such method {method!r}")

    # -- lane migration (same shard, across mesh chips) ----------------
    async def lane_move(self, req: LaneMove) -> LaneMoveReply:
        """Migrate a group's lane row into another chip's block of this
        shard's device mesh: freeze → lane evacuate → lane adopt →
        rebind, then thaw. No log bytes move — the raft log and every
        derived state stay put; only the SoA row (and with it the
        NamedSharding device owning it) changes. Any fault before the
        rebind rolls back (free the staged row, thaw the source — the
        source row never stopped being canonical)."""

        def err(msg: str) -> LaneMoveReply:
            return LaneMoveReply(
                ok=False, error=msg, row=-1, chip=-1,
                src_row=-1, src_chip=-1,
            )

        ntp = NTP(req.ns, req.topic, req.partition)
        p = self._pm.get(ntp)
        if p is None or p.group_id != req.group:
            return err("partition not hosted here")
        arrays = self._gm.arrays
        if req.dst_chip < 0 or req.dst_chip >= arrays.chip_count():
            return err(
                f"no such chip {req.dst_chip} "
                f"(mesh has {arrays.chip_count()})"
            )
        src_row = p.consensus.row
        src_chip = arrays.chip_of(src_row)
        if src_chip == req.dst_chip:
            return LaneMoveReply(
                ok=True, error="", row=src_row, chip=src_chip,
                src_row=src_row, src_chip=src_chip,
            )
        frozen = False
        dst = -1
        try:
            self._check_fault("lane_freeze")
            await self._gm.freeze_group(req.group)
            frozen = True
            self._check_fault("lane_evacuate")
            dst = self._gm.stage_lane(req.group, req.dst_chip)
            self._check_fault("lane_adopt")
            self._check_fault("lane_rebind")
            self._gm.commit_lane(req.group, dst)
            self._gm.thaw_group(req.group)
            return LaneMoveReply(
                ok=True, error="", row=dst, chip=req.dst_chip,
                src_row=src_row, src_chip=src_chip,
            )
        except Exception as e:
            if dst >= 0:
                try:
                    self._gm.abort_lane(dst)
                except Exception:
                    logger.exception("lane abort for group %d", req.group)
            if frozen:
                try:
                    self._gm.thaw_group(req.group)
                except Exception:
                    logger.exception("lane thaw for group %d", req.group)
            logger.warning(
                "lane move of group %d chip %d -> %d rolled back: %s",
                req.group, src_chip, req.dst_chip, e,
            )
            return err(f"lane move failed: {e}")

    # -- source side --------------------------------------------------
    async def freeze(self, ref: MoveRef) -> MoveManifest:
        ntp = NTP(ref.ns, ref.topic, ref.partition)
        p = self._pm.get(ntp)

        def err(msg: str) -> MoveManifest:
            return MoveManifest(
                ok=False, error=msg, group=ref.group, term=-1, voted_for=-1,
                commit_index=-1, start_offset=-1, dirty_offset=-1,
                committed_offset=-1, snap_index=-1, snap_term=-1,
                snap_blob=b"", config=b"", replicas=[], ledger_key="",
                segment_max_bytes=0, retention_bytes=None,
                retention_ms=None, cleanup_policy="",
                local_retention_bytes=None, local_retention_ms=None,
            )

        if p is None or p.group_id != ref.group:
            return err("partition not hosted here")
        try:
            self._check_fault("freeze")
            c = await self._gm.freeze_group(ref.group)
        except Exception as e:
            return err(f"freeze failed: {e}")
        offs = c.log.offsets()
        snap = b""
        if os.path.exists(c._snapshot_path):
            with open(c._snapshot_path, "rb") as f:
                snap = f.read()
        cfg = p.log.config
        return MoveManifest(
            ok=True,
            error="",
            group=ref.group,
            term=c.term,
            voted_for=c._voted_for if c._voted_for is not None else -1,
            commit_index=c.commit_index,
            start_offset=offs.start_offset,
            dirty_offset=offs.dirty_offset,
            committed_offset=offs.committed_offset,
            snap_index=c._snap_index,
            snap_term=c._snap_term,
            snap_blob=snap,
            config=c.config.encode(),
            replicas=list(c.config.all_nodes()),
            ledger_key=c.ledger_key,
            segment_max_bytes=cfg.segment_max_bytes,
            retention_bytes=cfg.retention_bytes,
            retention_ms=cfg.retention_ms,
            cleanup_policy=cfg.cleanup_policy,
            local_retention_bytes=cfg.local_retention_bytes,
            local_retention_ms=cfg.local_retention_ms,
        )

    def read(self, req: MoveChunkRequest) -> MoveChunk:
        self._check_fault("read")
        ntp = NTP(req.ns, req.topic, req.partition)
        p = self._pm.get(ntp)
        if p is None:
            return MoveChunk(
                group=req.group, batches=[], next_pos=req.pos, done=True
            )
        dirty = p.log.offsets().dirty_offset
        if req.pos > dirty:
            return MoveChunk(
                group=req.group, batches=[], next_pos=req.pos, done=True
            )
        batches = p.log.read(req.pos, max_bytes=req.max_bytes)
        if not batches:
            return MoveChunk(
                group=req.group, batches=[], next_pos=req.pos, done=True
            )
        next_pos = batches[-1].header.last_offset + 1
        return MoveChunk(
            group=req.group,
            batches=[b.serialize() for b in batches],
            next_pos=next_pos,
            done=next_pos > dirty,
        )

    async def thaw(self, ref: MoveRef) -> MoveAck:
        try:
            self._gm.thaw_group(ref.group)
            return MoveAck(ok=True, error="")
        except Exception as e:
            return MoveAck(ok=False, error=str(e))

    async def retire(self, ref: MoveRef) -> MoveAck:
        try:
            self._check_fault("retire")
            await self._pm.remove(NTP(ref.ns, ref.topic, ref.partition))
            return MoveAck(ok=True, error="")
        except Exception as e:
            return MoveAck(ok=False, error=str(e))

    # -- target side --------------------------------------------------
    async def begin(self, req: MoveBegin) -> MoveAck:
        from ..raft.consensus import seed_group_state
        from ..storage.log import LogConfig

        man = MoveManifest.decode(bytes(req.manifest))
        ntp = NTP(req.ns, req.topic, req.partition)
        try:
            self._check_fault("begin")
            if self._pm.get(ntp) is not None:
                return MoveAck(ok=False, error="partition already hosted")
            cfg = LogConfig(
                segment_max_bytes=man.segment_max_bytes,
                retention_bytes=man.retention_bytes,
                retention_ms=man.retention_ms,
                cleanup_policy=man.cleanup_policy,
                local_retention_bytes=man.local_retention_bytes,
                local_retention_ms=man.local_retention_ms,
            )
            log = self._lm.manage(ntp, cfg)
            if log.offsets().dirty_offset >= 0:
                # a stale staging leftover: wipe and recreate
                self._lm.remove(ntp)
                log = self._lm.manage(ntp, cfg)
            seed_group_state(
                self._gm.kvstore,
                man.group,
                term=man.term,
                voted_for=man.voted_for,
                config_raw=bytes(man.config),
            )
            if man.snap_blob:
                with open(
                    os.path.join(log.directory, "snapshot"), "wb"
                ) as f:
                    f.write(bytes(man.snap_blob))
            self._staged[man.group] = (ntp, cfg, man)
            return MoveAck(ok=True, error="")
        except Exception as e:
            logger.exception("move begin failed for %s", ntp)
            return MoveAck(ok=False, error=str(e))

    async def write(self, chunk: MoveChunk) -> MoveAck:
        from ..models.record import RecordBatch

        staged = self._staged.get(chunk.group)
        if staged is None:
            return MoveAck(ok=False, error="no staged move for group")
        ntp, _cfg, _man = staged
        log = self._lm.get(ntp)
        if log is None:
            return MoveAck(ok=False, error="staged log vanished")
        try:
            self._check_fault("write")
            for raw in chunk.batches:
                log.append_exactly(RecordBatch.deserialize(bytes(raw)))
            return MoveAck(ok=True, error="")
        except Exception as e:
            return MoveAck(ok=False, error=str(e))

    async def commit(self, ref: MoveRef) -> MoveCommitReply:
        staged = self._staged.pop(ref.group, None)
        if staged is None:
            return MoveCommitReply(
                ok=False, error="no staged move", row=-1,
                dirty_offset=-1, committed_offset=-1,
            )
        ntp, cfg, man = staged
        try:
            self._check_fault("commit")
            log = self._lm.get(ntp)
            if log is not None:
                await log.flush_async()
            p = await self._pm.manage(
                ntp, ref.group, list(man.replicas), log_config=cfg
            )
            offs = p.log.offsets()
            return MoveCommitReply(
                ok=True,
                error="",
                row=p.consensus.row,
                dirty_offset=offs.dirty_offset,
                committed_offset=offs.committed_offset,
                chip=self._gm.arrays.chip_of(p.consensus.row),
            )
        except Exception as e:
            logger.exception("move commit failed for %s", ntp)
            self._staged[ref.group] = staged
            return MoveCommitReply(
                ok=False, error=str(e), row=-1,
                dirty_offset=-1, committed_offset=-1,
            )

    async def abort(self, ref: MoveRef) -> MoveAck:
        staged = self._staged.pop(ref.group, None)
        if staged is None:
            return MoveAck(ok=True, error="")
        ntp, _cfg, _man = staged
        try:
            from ..raft.consensus import unseed_group_state

            self._lm.remove(ntp)
            unseed_group_state(self._gm.kvstore, ref.group)
            return MoveAck(ok=True, error="")
        except Exception as e:
            return MoveAck(ok=False, error=str(e))
