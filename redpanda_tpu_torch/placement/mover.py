"""The live-move coordinator: freeze → ship → adopt → retire, bounded
by a per-window move budget (reference: partition_balancer's bounded
reassignment batches; the freeze/ship protocol itself mirrors
shard_placement_table.cc x-shard transfer).

Runs on shard 0. Endpoints resolve through one seam: shard 0's own
MoveHost is called in-process, worker shards through `invoke_on` with
the placement envelopes — so the coordinator logic is identical for
0→k, k→0 and k→k moves.

Failure discipline: any fault before target-commit rolls back (abort
the staged adoption, thaw the source — the partition never stopped
being owned by the source, so no committed record is lost). After
target-commit the move is final: the placement table is rebound first,
then the source copy is retired; a retire failure leaks a frozen
source copy (logged, re-retired on the next move of that group) but
never forks the serving path, because every produce/fetch route
consults the table.
"""

from __future__ import annotations

import logging
import time

import numpy as np

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
from .host import CHUNK_BYTES, MoveHost

logger = logging.getLogger("placement.mover")


class MoveError(RuntimeError):
    pass


class MoveBudgetExhausted(MoveError):
    pass


class MoveBudget:
    """Token window: at most `moves_per_window` live moves per
    `window_s` seconds. Alert-driven rebalancing must be BOUNDED —
    an oscillating signal may not thrash partitions across shards
    faster than the window refills."""

    def __init__(
        self,
        moves_per_window: int = 4,
        window_s: float = 30.0,
        clock=time.monotonic,
    ):
        self.moves_per_window = max(1, int(moves_per_window))
        self.window_s = float(window_s)
        self._clock = clock
        self._stamps: list[float] = []
        self.denied = 0

    def try_acquire(self) -> bool:
        now = self._clock()
        horizon = now - self.window_s
        self._stamps = [t for t in self._stamps if t > horizon]
        if len(self._stamps) >= self.moves_per_window:
            self.denied += 1
            return False
        self._stamps.append(now)
        return True

    def available(self) -> int:
        horizon = self._clock() - self.window_s
        self._stamps = [t for t in self._stamps if t > horizon]
        return self.moves_per_window - len(self._stamps)

    def describe(self) -> dict:
        return {
            "moves_per_window": self.moves_per_window,
            "window_s": self.window_s,
            "available": self.available(),
            "denied": self.denied,
        }


class MoveStats:
    """Per-broker move accounting; freeze_ms is the unavailability
    window (freeze acked → target commit acked) the bench grades."""

    def __init__(self):
        self.ok = 0
        self.rolled_back = 0
        self.failed = 0
        self.freeze_ms: list[float] = []

    def freeze_p99_ms(self) -> float:
        if not self.freeze_ms:
            return 0.0
        return round(float(np.percentile(self.freeze_ms, 99)), 3)

    def describe(self) -> dict:
        return {
            "ok": self.ok,
            "rolled_back": self.rolled_back,
            "failed": self.failed,
            "freeze_p50_ms": (
                round(float(np.percentile(self.freeze_ms, 50)), 3)
                if self.freeze_ms
                else 0.0
            ),
            "freeze_p99_ms": self.freeze_p99_ms(),
        }


class PartitionMover:
    """Coordinator for live partition moves between this broker's
    shards. `router` is the ssx ShardRouter (None on single-process
    brokers, where only the degenerate 0→0 no-op exists)."""

    def __init__(
        self,
        table,
        local_host: MoveHost,
        router=None,
        budget: MoveBudget | None = None,
        clock=time.monotonic,
    ):
        self.table = table
        self.local_host = local_host
        self.router = router
        self.budget = budget or MoveBudget()
        self.stats = MoveStats()
        self._clock = clock
        self._moving: set[int] = set()

    async def _call(self, shard: int, method: str, payload: bytes) -> bytes:
        if shard == 0:
            return await self.local_host.handle(method, payload)
        if self.router is None:
            raise MoveError(f"no router for worker shard {shard}")
        return await self.router.move_invoke(shard, method, payload)

    async def move(
        self,
        ntp: NTP,
        dst_shard: int,
        *,
        charge_budget: bool = True,
    ) -> dict:
        """Move `ntp`'s raft group to `dst_shard` live. Returns a
        summary dict; raises MoveError on failure (source thawed,
        target aborted — state as if the move never started)."""
        group = self.table.group_of(ntp)
        src = self.table.shard_for(ntp)
        if group is None or src is None:
            raise MoveError(f"{ntp} not in the placement table")
        if dst_shard == src:
            return {"moved": False, "reason": "already there", "shard": src}
        if dst_shard < 0 or dst_shard >= self.table.shard_count:
            raise MoveError(f"no such shard {dst_shard}")
        if group in self._moving:
            raise MoveError(f"group {group} already moving")
        if charge_budget and not self.budget.try_acquire():
            raise MoveBudgetExhausted(
                f"move budget exhausted ({self.budget.describe()})"
            )
        self._moving.add(group)
        try:
            return await self._move_locked(ntp, group, src, dst_shard)
        finally:
            self._moving.discard(group)

    async def _move_locked(
        self, ntp: NTP, group: int, src: int, dst: int
    ) -> dict:
        ref = MoveRef(
            ns=ntp.ns, topic=ntp.topic, partition=ntp.partition, group=group
        ).encode()
        t0 = self._clock()
        man = MoveManifest.decode(await self._call(src, "move_freeze", ref))
        if not man.ok:
            self.stats.failed += 1
            raise MoveError(f"freeze on shard {src}: {man.error}")
        shipped = 0
        began = False
        try:
            ack = MoveAck.decode(
                await self._call(
                    dst,
                    "move_begin",
                    MoveBegin(
                        ns=ntp.ns,
                        topic=ntp.topic,
                        partition=ntp.partition,
                        manifest=man.encode(),
                    ).encode(),
                )
            )
            if not ack.ok:
                raise MoveError(f"begin on shard {dst}: {ack.error}")
            began = True
            pos = max(man.start_offset, 0)
            while True:
                chunk = MoveChunk.decode(
                    await self._call(
                        src,
                        "move_read",
                        MoveChunkRequest(
                            ns=ntp.ns,
                            topic=ntp.topic,
                            partition=ntp.partition,
                            group=group,
                            pos=pos,
                            max_bytes=CHUNK_BYTES,
                        ).encode(),
                    )
                )
                if chunk.batches:
                    wack = MoveAck.decode(
                        await self._call(
                            dst, "move_write", chunk.encode()
                        )
                    )
                    if not wack.ok:
                        raise MoveError(
                            f"write on shard {dst}: {wack.error}"
                        )
                    shipped += len(chunk.batches)
                pos = chunk.next_pos
                if chunk.done:
                    break
            com = MoveCommitReply.decode(
                await self._call(dst, "move_commit", ref)
            )
            if not com.ok:
                raise MoveError(f"commit on shard {dst}: {com.error}")
            if com.dirty_offset != man.dirty_offset:
                # the differential invariant: the adopted log must end
                # exactly where the frozen source ended
                raise MoveError(
                    f"shipped log mismatch: source dirty "
                    f"{man.dirty_offset}, target dirty {com.dirty_offset}"
                )
        except Exception as e:
            # rollback: the source still owns the partition
            if began:
                try:
                    await self._call(dst, "move_abort", ref)
                except Exception:
                    logger.exception("move abort on shard %d failed", dst)
            try:
                await self._call(src, "move_thaw", ref)
            except Exception:
                logger.exception("move thaw on shard %d failed", src)
            self.stats.rolled_back += 1
            if isinstance(e, MoveError):
                raise
            raise MoveError(str(e)) from e
        # point of no return: rebind the table BEFORE retiring the
        # source so there is never a moment with no route
        self.table.record_move(ntp, group, dst)
        self.table.bind_lane(group, com.row, chip=com.chip)
        freeze_ms = (self._clock() - t0) * 1e3
        self.stats.freeze_ms.append(freeze_ms)
        self.stats.ok += 1
        try:
            rack = MoveAck.decode(await self._call(src, "move_retire", ref))
            if not rack.ok:
                logger.error(
                    "retire of moved group %d on shard %d failed: %s",
                    group, src, rack.error,
                )
        except Exception:
            logger.exception("retire of group %d on shard %d", group, src)
        logger.info(
            "moved %s (group %d) shard %d -> %d: %d batches, "
            "freeze window %.1f ms",
            ntp, group, src, dst, shipped, freeze_ms,
        )
        return {
            "moved": True,
            "group": group,
            "from": src,
            "to": dst,
            "batches": shipped,
            "freeze_ms": round(freeze_ms, 3),
        }

    async def move_lane(
        self,
        ntp: NTP,
        dst_chip: int,
        *,
        charge_budget: bool = True,
    ) -> dict:
        """Migrate `ntp`'s lane row into `dst_chip`'s block of its
        owning shard's device mesh — the (chip, lane) half of the
        placement coordinate. The freeze → evacuate → adopt → rebind
        protocol runs entirely on the owning shard (no log bytes
        cross anything); only the table rebind happens here, and only
        after the shard acks. Raises MoveError on failure with the
        source state intact."""
        group = self.table.group_of(ntp)
        shard = self.table.shard_for(ntp)
        if group is None or shard is None:
            raise MoveError(f"{ntp} not in the placement table")
        if group in self._moving:
            raise MoveError(f"group {group} already moving")
        if charge_budget and not self.budget.try_acquire():
            raise MoveBudgetExhausted(
                f"move budget exhausted ({self.budget.describe()})"
            )
        self._moving.add(group)
        t0 = self._clock()
        try:
            rep = LaneMoveReply.decode(
                await self._call(
                    shard,
                    "move_lane",
                    LaneMove(
                        ns=ntp.ns,
                        topic=ntp.topic,
                        partition=ntp.partition,
                        group=group,
                        dst_chip=dst_chip,
                    ).encode(),
                )
            )
            if not rep.ok:
                self.stats.rolled_back += 1
                raise MoveError(f"lane move on shard {shard}: {rep.error}")
        finally:
            self._moving.discard(group)
        if rep.chip == rep.src_chip and rep.row == rep.src_row:
            return {
                "moved": False,
                "reason": "already there",
                "chip": rep.chip,
            }
        self.table.bind_lane(group, rep.row, chip=rep.chip)
        freeze_ms = (self._clock() - t0) * 1e3
        self.stats.freeze_ms.append(freeze_ms)
        self.stats.ok += 1
        logger.info(
            "lane-moved %s (group %d) shard %d chip %d -> %d "
            "(row %d -> %d), freeze window %.1f ms",
            ntp, group, shard, rep.src_chip, rep.chip,
            rep.src_row, rep.row, freeze_ms,
        )
        return {
            "moved": True,
            "group": group,
            "shard": shard,
            "from_chip": rep.src_chip,
            "to_chip": rep.chip,
            "row": rep.row,
            "freeze_ms": round(freeze_ms, 3),
        }

    def describe(self) -> dict:
        return {
            "budget": self.budget.describe(),
            "stats": self.stats.describe(),
            "moving": sorted(self._moving),
        }
