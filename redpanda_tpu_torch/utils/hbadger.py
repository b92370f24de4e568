"""Failure-injection registry — the finjector "honey badger" analog
(reference: src/v/finjector/hbadger.h:23-70).

Tests (and the admin API later) arm probes keyed by (module, point):
a probe can delay, raise, or both. Every RPC dispatch and any
instrumented code path calls `maybe_inject`. Disarmed lookups are one
dict hit — negligible, so probes stay compiled in (the reference gates
on debug builds; we gate on registry emptiness).
"""

from __future__ import annotations

import asyncio
from typing import Optional


class Probe:
    def __init__(
        self,
        delay_s: float = 0.0,
        exception: Optional[BaseException] = None,
        count: Optional[int] = None,
    ):
        self.delay_s = delay_s
        self.exception = exception
        self.count = count  # remaining firings; None = forever


class HoneyBadger:
    def __init__(self):
        self._probes: dict[tuple[str, str], Probe] = {}

    def arm(self, module: str, point: str, probe: Probe) -> None:
        self._probes[(module, point)] = probe

    def disarm(self, module: str, point: str = "") -> None:
        if point:
            self._probes.pop((module, point), None)
        else:
            for key in [k for k in self._probes if k[0] == module]:
                self._probes.pop(key)

    def clear(self) -> None:
        self._probes.clear()

    @property
    def active(self) -> bool:
        """Cheap hot-path predicate: any probes armed? (Callers skip
        the maybe_inject coroutine allocation per dispatch when idle.)"""
        return bool(self._probes)

    async def maybe_inject(self, module: str, point: str) -> None:
        if not self._probes:
            return
        probe = self._probes.get((module, point))
        if probe is None:
            return
        if probe.count is not None:
            if probe.count <= 0:
                return
            probe.count -= 1
        if probe.delay_s:
            await asyncio.sleep(probe.delay_s)
        if probe.exception is not None:
            raise probe.exception


honey_badger = HoneyBadger()
