"""Node-wide recovery throttle + memory quota.

Reference: src/v/raft/recovery_throttle.h (one shared token bucket of
recovery bytes/sec for every raft group on the shard — a rejoining
node with thousands of lagging groups must not saturate the leader's
disk and network) and recovery_memory_quota.{h,cc} (bounds the memory
concurrently pinned by in-flight recovery reads).

Catch-up fibers (consensus._catch_up → _dispatch_append) pass through
`throttle()` before shipping a read log range; regular replication
(replicate_batcher / replicate_entries) is never throttled.
"""

from __future__ import annotations

import asyncio

from ..utils.retry_chain import RetryChainNode
from ..utils.token_bucket import TokenBucket


class RecoveryThrottle:
    # reference default raft_learner_recovery_rate: 100 MiB/s; scaled
    # to this single-core host's measured produce ceiling so recovery
    # cannot starve foreground traffic
    DEFAULT_RATE = 64 * 1024 * 1024
    # max concurrent in-flight recovery dispatches (≈ rounds × 1 MiB
    # read cap = the recovery memory quota)
    DEFAULT_CONCURRENCY = 32

    def __init__(
        self,
        rate_bytes_s: float = DEFAULT_RATE,
        concurrency: int = DEFAULT_CONCURRENCY,
    ):
        # now=0.0: constructed before the loop runs; the first refill
        # sees a huge dt and simply caps tokens at burst
        self._bucket = TokenBucket(rate_bytes_s, rate_bytes_s, 0.0)
        self._sem = asyncio.Semaphore(concurrency)
        self.throttled_s = 0.0  # cumulative wait (probe/metrics)
        # node-wide retry/abort root (retry_chain_node.h): every
        # group's send-loop backoff (catch-up rounds, snapshot chunks)
        # hangs off this tree, so GroupManager.stop() cancels all
        # nested retries in one abort instead of waiting out sleeps
        self.retry_root = RetryChainNode(
            base_backoff_s=0.02, max_backoff_s=0.5
        )

    def set_rate(self, rate_bytes_s: float) -> None:
        """Live binding target (cluster config raft_learner_recovery_rate)."""
        self._bucket.rate = float(rate_bytes_s)
        self._bucket.burst = float(rate_bytes_s)

    async def throttle(self, nbytes: int) -> None:
        """Account `nbytes` of recovery traffic and sleep off any debt.
        Spend-then-wait (the reference's bucket works the same way), so
        a single oversized round is never blocked forever."""
        now = asyncio.get_event_loop().time()
        self._bucket.record(nbytes, now)
        delay = self._bucket.throttle_delay_s(now)
        if delay > 0:
            slept = min(delay, 5.0)
            self.throttled_s += slept
            await asyncio.sleep(slept)

    def dispatch_slot(self) -> "asyncio.Semaphore":
        """Memory quota: hold while a recovery round's read range is
        in flight (async with throttle.dispatch_slot(): ...)."""
        return self._sem
