"""Replicate batcher — coalesces concurrent leader writes.

Reference: src/v/raft/replicate_batcher.{h,cc} (cache_and_wait :32,
do_flush :190,316; memory backpressure :138) and
consensus::replicate_in_stages (consensus.cc:728).

Every `replicate()` used to be its own append + fsync: with N
concurrent producers that is N fsyncs per interval. The batcher
accumulates requests that arrive while a flush round is in flight and
commits them with ONE log append pass + ONE fsync + ONE dispatch kick,
so fsyncs/interval stays O(1) in producer count. The fsync itself runs
on an executor thread (storage.segment.flush_async), which is what
creates the accumulation window on a single event loop.

Two-stage future (produce.cc:95-111 dispatched/produced):
  stages.enqueued — resolves (with None) the moment the batch is
      cached in the batcher's FIFO: its queue position IS its log
      order, so a dispatcher can move to the next request immediately
      (the reference's request_enqueued resolves at cache time too —
      resolving at append would serialize rounds and kill coalescing).
  stages.done — resolves with (base, last) when the requested ack
      level is satisfied (acks=0: at append; acks=1: after leader
      fsync; acks=-1: after quorum commit).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import TYPE_CHECKING, Optional

from ..models.record import RecordBatch, RecordBatchBuilder
from ..models.consensus_state import SELF_SLOT
from ..observability import trace

if TYPE_CHECKING:  # pragma: no cover
    from .consensus import Consensus

logger = logging.getLogger("raft.batcher")


def consume_exc(fut: asyncio.Future) -> None:
    """Mark a future's eventual exception as retrieved — for stages
    abandoned by a caller (timeout) so asyncio doesn't log
    'exception was never retrieved' when the round settles later."""

    def cb(f: asyncio.Future) -> None:
        if not f.cancelled():
            f.exception()

    fut.add_done_callback(cb)


class ReplicateStages:
    __slots__ = ("enqueued", "done")

    def __init__(self) -> None:
        loop = asyncio.get_event_loop()
        self.enqueued: asyncio.Future = loop.create_future()
        self.done: asyncio.Future = loop.create_future()


class _Item:
    __slots__ = (
        "batch", "acks", "stages", "size", "base", "last", "t0", "t_q0",
        "span",
    )

    def __init__(self, batch: RecordBatch, acks: int, size: int):
        self.batch = batch
        self.acks = acks
        self.stages = ReplicateStages()
        self.size = size
        self.base = -1
        self.last = -1
        # enqueue stamp for the commit-latency probe
        # (consensus._resolve_quorum_items observes now - t0)
        self.t0 = time.monotonic()
        # fsync-done stamp (re-set by _flush_round): quorum-stage
        # latency = resolve time - t_q0, the pure commit-wait tail
        self.t_q0 = self.t0
        # requester's open trace span (the produce dispatch), captured
        # here because the flush round runs in a different task — it
        # parents the round's raft.append/raft.flush spans
        self.span = trace.current_span()


class ReplicateBatcher:
    def __init__(
        self,
        consensus: "Consensus",
        max_pending_bytes: int = 4 * 1024 * 1024,
        quorum_timeout_s: float = 30.0,
    ):
        self._c = consensus
        self._max_pending = max_pending_bytes
        self._quorum_timeout = quorum_timeout_s
        self._items: list[_Item] = []
        self._pending_bytes = 0
        self._drained = asyncio.Event()
        self._drained.set()
        self._flush_task: Optional[asyncio.Task] = None
        self._closed = False
        self.flush_rounds = 0  # observability: fsync rounds executed
        # EWMA of items-per-round: the accumulation tick (sleep(0))
        # only pays when concurrent producers actually coalesce; at 1k
        # partitions under rotating producers rounds carry ~1 item and
        # the tick is a pure extra reschedule per round
        self._items_ewma = 1.0

    async def stop(self) -> None:
        self._closed = True
        if self._flush_task is not None:
            self._flush_task.cancel()
            try:
                await self._flush_task
            except asyncio.CancelledError:
                pass
        self._fail_all(asyncio.CancelledError())

    def _fail_all(self, exc: BaseException) -> None:
        items, self._items = self._items, []
        for it in items:
            for fut in (it.stages.enqueued, it.stages.done):
                if not fut.done():
                    fut.set_exception(exc)
        self._pending_bytes = 0
        self._drained.set()

    async def replicate_in_stages(
        self, batch: RecordBatch, acks: int
    ) -> ReplicateStages:
        """Enqueue one batch. Backpressure: waits while the pending
        cache exceeds its byte budget (replicate_batcher.cc:138)."""
        from .consensus import NotLeaderError, Role

        while self._pending_bytes > self._max_pending and not self._closed:
            self._drained.clear()
            await self._drained.wait()
        if self._closed or self._c._closed:
            # stopping: the flush loop would never run this item
            raise NotLeaderError(self._c.leader_id)
        if self._c.role != Role.LEADER:
            raise NotLeaderError(self._c.leader_id)
        item = _Item(batch, acks, batch.size_bytes())
        self._items.append(item)
        self._pending_bytes += item.size
        item.stages.enqueued.set_result(None)  # FIFO position = order
        if self._flush_task is None or self._flush_task.done():
            self._flush_task = asyncio.ensure_future(self._flush_loop())
        return item.stages

    async def _flush_loop(self) -> None:
        try:
            while self._items and not self._closed:
                # one tick: let every concurrently-ready producer land
                # in this round — but only when this group actually
                # sees coalescing (EWMA > 1.1); otherwise skip the
                # reschedule (single-producer-per-partition shape)
                if self._items_ewma > 1.1 or len(self._items) > 1:
                    await asyncio.sleep(0)
                # the sleep(0) above is the coalescing point: producers
                # append across it ON PURPOSE, and this single-statement
                # swap then takes every item that landed (submit()
                # guarantees one flush task per batcher)
                items, self._items = self._items, []  # rplint: disable=RPL015
                self._items_ewma += 0.05 * (len(items) - self._items_ewma)
                for it in items:
                    self._pending_bytes -= it.size
                self._drained.set()
                await self._flush_round(items)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # never silently drop waiters
            logger.exception("g%d: flush round failed", self._c.group_id)
            self._fail_all(e)

    async def _flush_round(self, items: list[_Item]) -> None:
        """One coalesced round: append all, fsync once, dispatch once
        (replicate_batcher.cc do_flush)."""
        from .consensus import NotLeaderError, ReplicateTimeout, Role

        c = self._c
        if c.role != Role.LEADER or c._closed:
            exc = NotLeaderError(c.leader_id)
            for it in items:
                self._resolve_exc(it, exc)
            return
        term = c.term
        row = c.row
        round_last = -1
        appended: list[_Item] = []
        t_append = time.monotonic()
        # coalesce stage: enqueue -> this round picking the item up
        observe_coalesce = c.probe.observe_stage_coalesce
        for it in items:
            observe_coalesce(t_append - it.t0)
        with trace.span("raft.append", parent=items[0].span, items=len(items)):
            with trace.section("log_append", c.probe.registry):
                for it in items:
                    it.base, it.last = c.log.append(it.batch, term=term)
                    round_last = it.last
                    if it.acks == 0 and not it.stages.done.done():
                        it.stages.done.set_result((it.base, it.last))
                    appended.append(it)
        c.probe.observe_append(time.monotonic() - t_append)
        c.probe.note_append(c.ledger_key, sum(it.size for it in items))
        self.flush_rounds += 1
        with trace.span("raft.flush", parent=items[0].span):
            flushed = await c.log.flush_async()
        # leadership may have moved while the fsync ran
        if c._closed or c.role != Role.LEADER or c.term != term:
            exc = NotLeaderError(c.leader_id)
            for it in appended:
                self._resolve_exc(it, exc)
            return
        c.arrays.match_index[row, SELF_SLOT] = max(
            int(c.arrays.match_index[row, SELF_SLOT]), round_last
        )
        c.arrays.flushed_index[row, SELF_SLOT] = max(
            int(c.arrays.flushed_index[row, SELF_SLOT]), flushed
        )
        c.arrays.touch()
        # SELF-slot movement (the flush-clamp release): with a shard
        # tick frame wired the quorum recompute batches into the next
        # frame flush (one vectorized call for every group's round);
        # direct fixtures keep the per-round scalar oracle
        frame = c._tick_frame
        if frame is not None:
            frame.note_self(row)
        elif c.arrays.scalar_commit_update(row):
            c._notify_commit()
        c.kick_quorum_ackers()
        t_q0 = time.monotonic()
        quorum_waiters = []
        for it in appended:
            if it.stages.done.done():
                continue
            if it.acks == 1:
                it.stages.done.set_result((it.base, it.last))
            else:
                it.t_q0 = t_q0
                quorum_waiters.append(it)
        if quorum_waiters:
            # resolved inline by consensus._notify_commit (offset-keyed
            # heap) — no waiter task / Event churn per round
            c.add_quorum_waiter(
                term, round_last, quorum_waiters, self._quorum_timeout
            )

    def _resolve_exc(self, it: _Item, exc: BaseException) -> None:
        for fut in (it.stages.enqueued, it.stages.done):
            if not fut.done():
                fut.set_exception(exc)

