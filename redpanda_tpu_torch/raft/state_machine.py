"""State machine base (reference: src/v/raft/state_machine.{h,cc}).

A background apply fiber reads committed batches from the group's log —
from `last_applied + 1` up to the commit index — and feeds them to
`apply()`. Subclasses (controller stm, group coordinator, rm_stm…)
implement apply; `wait(offset)` blocks until the STM has applied at
least that offset (the reference's stm::wait).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from ..models.record import RecordBatch, RecordBatchType
from .consensus import Consensus

logger = logging.getLogger("raft.stm")


class StateMachine:
    def __init__(self, consensus: Consensus):
        self.consensus = consensus
        self.last_applied = -1
        self._task: Optional[asyncio.Task] = None
        self._applied_event = asyncio.Event()
        self._closed = False
        # health flag: set after repeated apply failures at one offset
        # (a deterministic decode/apply bug — the reference vasserts).
        # The fiber keeps retrying with capped backoff so a transient
        # cause can still clear it; health reporting reads this flag.
        self.failed = False

    async def apply(self, batch: RecordBatch) -> None:  # pragma: no cover
        raise NotImplementedError

    async def start(self) -> None:
        self._task = asyncio.ensure_future(self._apply_loop())

    async def stop(self) -> None:
        self._closed = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def _apply_loop(self) -> None:
        while not self._closed:
            commit = self.consensus.commit_index
            if self.last_applied >= commit:
                try:
                    await self.consensus.wait_committed(
                        self.last_applied + 1, timeout=3600.0
                    )
                except Exception:
                    continue
                commit = self.consensus.commit_index
            batches = self.consensus.log.read(
                self.last_applied + 1, upto=commit
            )
            if not batches:
                await asyncio.sleep(0.01)
                continue
            for batch in batches:
                if batch.header.base_offset > commit:
                    break
                attempts = 0
                while not self._closed:
                    # a committed batch must never be skipped: silently
                    # advancing last_applied past a failed apply would
                    # diverge this replica's state machine from its
                    # peers'. Retry with escalating backoff; after
                    # enough rounds flag the STM unhealthy so health
                    # reports surface the wedge instead of it hiding
                    # behind an apparently-live node.
                    try:
                        if (
                            batch.header.type
                            == RecordBatchType.raft_configuration
                        ):
                            self.consensus.apply_configuration_batch(batch)
                        else:
                            await self.apply(batch)
                        if self.failed:
                            self.failed = False
                            logger.warning(
                                "g%d: stm recovered at offset %d",
                                self.consensus.group_id,
                                batch.header.base_offset,
                            )
                        break
                    except Exception:
                        attempts += 1
                        delay = min(0.1 * (2 ** min(attempts, 6)), 5.0)
                        if attempts >= 5 and not self.failed:
                            self.failed = True
                            logger.error(
                                "g%d: stm WEDGED at offset %d after %d "
                                "attempts — likely deterministic "
                                "decode/apply failure; marking unhealthy",
                                self.consensus.group_id,
                                batch.header.base_offset,
                                attempts,
                            )
                        logger.exception(
                            "g%d: stm apply failed at %d (retry in %.1fs)",
                            self.consensus.group_id,
                            batch.header.base_offset,
                            delay,
                        )
                        await asyncio.sleep(delay)
                if self._closed:
                    return
                self.last_applied = batch.header.last_offset
            ev = self._applied_event
            self._applied_event = asyncio.Event()
            ev.set()

    async def wait_applied(self, offset: int, timeout: float = 10.0) -> None:
        deadline = asyncio.get_event_loop().time() + timeout
        while self.last_applied < offset:
            remaining = deadline - asyncio.get_event_loop().time()
            if remaining <= 0:
                raise TimeoutError(f"stm not applied to {offset}")
            ev = self._applied_event
            try:
                await asyncio.wait_for(ev.wait(), remaining)
            except asyncio.TimeoutError:
                continue
