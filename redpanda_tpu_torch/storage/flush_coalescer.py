"""Node-level fsync coalescing across logs.

The replicate batcher coalesces fsyncs *within* one raft group, but a
broker hosting 1k groups under rotating producers issues one executor
round-trip per group per produce — at ~1.1 ms measured queue latency
each, the executor hand-off dominated the leader flush path
(bench_profiles, r4 span `batcher.fsync`). The reference hits the same
wall differently and solves it in segment_appender's shared flush
queue; here one coalescer per event loop gathers every fsync request
that arrives while an executor round is in flight and settles them in
ONE `run_in_executor` call (looping os.fsync over the unique fds), so
executor trips per interval are O(1) in group count.

Error isolation is per-fd: one bad descriptor fails only its waiters.
"""

from __future__ import annotations

import asyncio
import os
from typing import Optional


def _fsync_all(
    fds: list[int],
) -> list[tuple[Optional[BaseException], float]]:
    import time

    out: list[tuple[Optional[BaseException], float]] = []
    for fd in fds:
        t0 = time.perf_counter()
        try:
            os.fsync(fd)
            out.append((None, time.perf_counter() - t0))
        except BaseException as e:  # per-fd isolation
            out.append((e, time.perf_counter() - t0))
    return out


class FlushCoalescer:
    _by_loop: dict = {}

    def __init__(self) -> None:
        self._pending: list[tuple[int, asyncio.Future]] = []
        self._running = False

    @classmethod
    def get(cls) -> "FlushCoalescer":
        loop = asyncio.get_event_loop()
        inst = cls._by_loop.get(loop)
        if inst is None:
            inst = cls()
            cls._by_loop[loop] = inst
            # don't let dead loops accumulate instances (test suites
            # create thousands of loops)
            if len(cls._by_loop) > 8:
                cls._by_loop = {
                    l: i for l, i in cls._by_loop.items() if not l.is_closed()
                }
        return inst

    # device-speed estimate: EWMA of the raw fsync syscall time. Below
    # the inline threshold (tmpfs, fast NVMe appends) the syscall runs
    # directly on the event loop — the executor hand-off costs ~1-2 ms
    # of GIL/wakeup latency on a busy loop, an order of magnitude more
    # than the fast-device syscall it wraps. Slow devices keep the
    # off-loop path. Starts optimistic; one slow fsync flips it over.
    INLINE_THRESHOLD_S = 0.0002
    _ewma_s = 0.0

    async def fsync(self, fd: int) -> None:
        import time

        if FlushCoalescer._ewma_s < self.INLINE_THRESHOLD_S:
            t0 = time.perf_counter()
            os.fsync(fd)
            dt = time.perf_counter() - t0
            FlushCoalescer._ewma_s += 0.2 * (dt - FlushCoalescer._ewma_s)
            return
        loop = asyncio.get_event_loop()
        fut = loop.create_future()
        self._pending.append((fd, fut))
        if not self._running:
            self._running = True
            asyncio.ensure_future(self._run())
        await fut

    async def _run(self) -> None:
        loop = asyncio.get_event_loop()
        try:
            while self._pending:
                batch, self._pending = self._pending, []
                # dedupe: several waiters on one fd need one fsync
                order: list[int] = []
                seen: set[int] = set()
                for fd, _ in batch:
                    if fd not in seen:
                        seen.add(fd)
                        order.append(fd)
                try:
                    results = await loop.run_in_executor(
                        None, _fsync_all, order
                    )
                    by_fd = dict(zip(order, results))
                    for _, dt in results:
                        FlushCoalescer._ewma_s += 0.2 * (
                            dt - FlushCoalescer._ewma_s
                        )
                except asyncio.CancelledError:
                    raise  # teardown must propagate, not land in futures
                except BaseException as e:  # executor itself failed
                    by_fd = {fd: (e, 0.0) for fd in order}
                for fd, fut in batch:
                    if fut.done():
                        continue
                    err, _dt = by_fd.get(fd, (None, 0.0))
                    if err is None:
                        fut.set_result(None)
                    else:
                        fut.set_exception(err)
        finally:
            self._running = False


# RP_SAN=1: the pending/running pair is the classic coalescer handoff
# (submit appends, the drain task swaps) — NOT _ewma_s, which is
# class-level state a descriptor would be clobbered by. No-op when
# RP_SAN is unset.
from ..utils import rpsan as _rpsan  # noqa: E402

_rpsan.instrument(FlushCoalescer, ("_pending", "_running"))
