"""Per-peer append_entries multiplexing.

Reference: src/v/raft/append_entries_buffer.{h,cc} batches appends
within one group; at 1k+ single-producer groups there is nothing to
batch per group — the waste is ACROSS groups sharing a node pair: each
produce round issued one RPC per (group, follower), so per-call
overhead (framing, correlation, task wakeups, reply dispatch) scaled
with partition count (r4 spans: ~200 µs/call × 2 calls/round).

The aggregator wraps the node's raw send function transparently:
APPEND_ENTRIES calls to the same peer that arrive while a flush is in
flight ride ONE `APPEND_ENTRIES_BATCH` frame; everything else passes
through untouched. A singleton batch degrades to a plain
APPEND_ENTRIES call, so the wire behavior with no concurrency is
byte-identical to the unwrapped path (and remains compatible with
peers on either path).
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import Callable

from . import types as rt

logger = logging.getLogger("raft.append_agg")

# Sub-appends per APPEND_ENTRIES_BATCH frame. The follower services a
# frame sequentially (service.append_entries_batch), so an unbounded
# frame makes one wire call's work proportional to however many groups
# dispatched in the window — a mass-catch-up herd (N leaderships won
# at once) lands N sub-appends in ONE frame, the follower cannot
# answer it inside the RPC timeout, ALL N waiters fail together, and
# the recovery scan re-kicks them in lockstep: a livelock where only
# the singleton fast-path winner advances per timeout cycle. Capping
# the frame bounds each wire call's service time (the timeout applies
# per frame; queue wait does not count, matching
# append_entries_buffer.h's bounded-buffer semantics), so the herd
# drains as a pipeline of small frames instead of one doomed jumbo.
_FRAME_CAP = int(os.environ.get("RP_APPEND_FRAME_CAP", "512"))


class AppendAggregator:
    def __init__(self, raw_send: Callable):
        self._raw = raw_send
        self._q: dict[int, list[tuple[bytes, asyncio.Future]]] = {}
        self._flushing: set[int] = set()

    async def send(
        self, peer: int, method_id: int, payload: bytes, timeout: float
    ) -> bytes:
        if method_id != rt.APPEND_ENTRIES:
            return await self._raw(peer, method_id, payload, timeout)
        if peer not in self._flushing and not self._q.get(peer):
            # uncontended fast path: direct call — no future, no flush
            # fiber, no extra wakeups (at 1k partitions most dispatch
            # windows carry exactly one append per peer). The flag is
            # held so concurrent arrivals queue and a fiber drains
            # them as one frame once this call returns.
            self._flushing.add(peer)
            try:
                return await self._raw(
                    peer, rt.APPEND_ENTRIES, payload, timeout
                )
            finally:
                self._flushing.discard(peer)
                if self._q.get(peer):
                    self._flushing.add(peer)
                    asyncio.ensure_future(self._flush(peer, timeout))
        fut = asyncio.get_event_loop().create_future()
        self._q.setdefault(peer, []).append((payload, fut))
        if peer not in self._flushing:
            self._flushing.add(peer)
            asyncio.ensure_future(self._flush(peer, timeout))
        return await fut

    async def _flush(self, peer: int, timeout: float) -> None:
        try:
            await self._flush_rounds(peer, timeout)
        finally:
            self._flushing.discard(peer)
            # cancellation (loop teardown, connection-cache close) must
            # not strand waiters: a fiber stuck on `fut` would hold its
            # per-peer lock AND its hb_suppress count forever,
            # suppressing heartbeats and recovery for that follower
            leftovers = self._q.pop(peer, [])
            for _, fut in leftovers:
                if not fut.done():
                    fut.set_exception(ConnectionError("append flush aborted"))

    async def _flush_rounds(self, peer: int, timeout: float) -> None:
        while self._q.get(peer):
            # one tick: let every concurrently-dispatching group land
            # in this frame (replicate_batcher's accumulation trick
            # applied to the RPC layer)
            await asyncio.sleep(0)
            q = self._q.get(peer)
            if not q:
                self._q.pop(peer, None)
                break
            if len(q) > _FRAME_CAP:
                batch = q[:_FRAME_CAP]
                self._q[peer] = q[_FRAME_CAP:]
            else:
                batch = self._q.pop(peer)
            try:
                if len(batch) == 1:
                    payload, fut = batch[0]
                    raw = await self._raw(
                        peer, rt.APPEND_ENTRIES, payload, timeout
                    )
                    if not fut.done():
                        fut.set_result(raw)
                    continue
                req = rt.encode_multi([p for p, _ in batch])
                raw = await self._raw(
                    peer, rt.APPEND_ENTRIES_BATCH, req, timeout
                )
                replies = rt.decode_multi(raw)
                if len(replies) != len(batch):
                    raise ValueError(
                        f"append batch reply count {len(replies)} != "
                        f"{len(batch)}"
                    )
                for (_, fut), rep in zip(batch, replies):
                    if not fut.done():
                        fut.set_result(rep)
            except BaseException as e:
                # fail THIS batch's waiters on any interruption —
                # including CancelledError, which must still propagate
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(
                            e
                            if isinstance(e, Exception)
                            else ConnectionError("append flush cancelled")
                        )
                if not isinstance(e, Exception):
                    raise
