"""Hierarchical retry/abort tree for long-running remote operations.

Reference: src/v/utils/retry_chain_node.h — cloud operations carry a
node in a tree rooted at the subsystem; each node has its own backoff
budget but shares the root's deadline and abort source, so stopping an
archiver cancels every nested upload retry loop at once, and a child's
retries can never outlive its parent's budget.
"""

from __future__ import annotations

import asyncio
import random
import time


class RetryChainAborted(Exception):
    pass


class RetryChainNode:
    def __init__(
        self,
        deadline_s: float | None = None,
        base_backoff_s: float = 0.1,
        max_backoff_s: float = 5.0,
        _parent: "RetryChainNode | None" = None,
    ):
        self._parent = _parent
        root = _parent._root if _parent is not None else self
        self._root = root
        self._base = base_backoff_s
        self._max = max_backoff_s
        self._attempt = 0
        if _parent is None:
            self._abort = asyncio.Event()
            self._deadline = (
                time.monotonic() + deadline_s if deadline_s is not None else None
            )
        else:
            # children share the root's abort + deadline, tightened by
            # their own if given
            self._abort = root._abort
            own = time.monotonic() + deadline_s if deadline_s is not None else None
            self._deadline = (
                min(x for x in (own, _parent._deadline) if x is not None)
                if (own is not None or _parent._deadline is not None)
                else None
            )

    # -- tree ---------------------------------------------------------
    def child(
        self,
        deadline_s: float | None = None,
        base_backoff_s: float | None = None,
    ) -> "RetryChainNode":
        return RetryChainNode(
            deadline_s=deadline_s,
            base_backoff_s=base_backoff_s or self._base,
            max_backoff_s=self._max,
            _parent=self,
        )

    # -- abort --------------------------------------------------------
    def abort(self) -> None:
        """Cancels every node in the tree (root abort source)."""
        self._abort.set()

    def reset(self) -> None:
        """Re-arm an aborted root (admin service restart): children
        created AFTER the reset run normally; in-flight children that
        already observed the abort stay cancelled."""
        self._abort = asyncio.Event()

    @property
    def aborted(self) -> bool:
        return self._abort.is_set()

    def check_abort(self) -> None:
        if self._abort.is_set():
            raise RetryChainAborted()

    # -- budget -------------------------------------------------------
    def remaining_s(self) -> float | None:
        if self._deadline is None:
            return None
        return self._deadline - time.monotonic()

    def may_retry(self) -> bool:
        if self.aborted:
            return False
        rem = self.remaining_s()
        return rem is None or rem > 0

    async def backoff(self) -> bool:
        """Sleep the next jittered exponential delay. Returns False
        when the budget is exhausted (deadline passed or would pass
        mid-sleep), raises RetryChainAborted on abort."""
        self.check_abort()
        delay = min(self._base * (2**self._attempt), self._max)
        delay *= 0.5 + random.random()
        self._attempt += 1
        rem = self.remaining_s()
        if rem is not None:
            if rem <= 0:
                return False
            delay = min(delay, rem)
        try:
            await asyncio.wait_for(self._abort.wait(), timeout=delay)
        except asyncio.TimeoutError:
            pass
        self.check_abort()
        return self.may_retry()
