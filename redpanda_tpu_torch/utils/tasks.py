"""Task lifecycle helpers.

The classic stop() shape

    if self._task is not None:
        self._task.cancel()
        await self._task        # <- suspension point
        self._task = None       # <- torn check-then-act (RPL015)

is racy under concurrent stop(): both callers pass the None check,
both await the same task, and the second `self._task = None` can
clobber a task a concurrent start() installed during the await. The
race-free idiom is swap-then-await — publish the None *before* the
first suspension point, then settle the detached task:

    task, self._task = self._task, None
    await cancel_and_wait(task)

The swap is a single statement with no await, so it is atomic on the
event loop; concurrent stop() callers each detach at most once and
the second caller awaits None (a no-op).
"""

from __future__ import annotations

import asyncio
from typing import Optional


async def cancel_and_wait(task: Optional[asyncio.Task]) -> None:
    """Cancel `task` and wait for it to settle; None is a no-op.
    CancelledError from the task is absorbed (that's the expected
    outcome); any other exception propagates so shutdown bugs are not
    silently eaten."""
    if task is None:
        return
    task.cancel()
    try:
        await task
    except asyncio.CancelledError:
        pass
