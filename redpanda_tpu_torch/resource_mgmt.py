"""Scheduling groups: weighted-fair CPU partitioning for background
work (P6).

Reference: src/v/resource_mgmt/cpu_scheduling.h:23-40 — Seastar
scheduling groups with shares (admin=100, raft=1000, kafka=1000,
cluster=300, compaction, archival, ...) keep maintenance work from
starving the hot path. The asyncio re-imagining: latency-critical
paths (raft ticks, kafka handlers) stay direct on the event loop, and
the *background work* — compaction passes, retention sweeps, archival
uploads, balancer planning — is split into awaitable UNITS submitted
through weighted-fair group queues. Units within a group run serially
(single-threading stays the synchronization model); DIFFERENT groups
run concurrently, so an I/O-bound archival unit never head-of-line
blocks a compaction unit. Fairness is enforced at unit START: each
completion charges measured wall time / shares against the group's
virtual time, and a group may only start while not ahead of the
busiest competitor — so a group with 10x the shares gets 10x the
units over any contended window, and the event loop yields between
units instead of blocking for a whole all-partitions sweep.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from collections import deque
from typing import Any, Awaitable, Callable

from .observability import trace
from .utils.tasks import cancel_and_wait

logger = logging.getLogger("resource_mgmt")

# the reference's share table (cpu_scheduling.h:23-40)
DEFAULT_SHARES = {
    "admin": 100,
    "raft": 1000,
    "kafka": 1000,
    "cluster": 300,
    "compaction": 100,
    "archival": 100,
    "recovery": 200,
}

_MIN_COST_S = 1e-6


class SchedulingGroup:
    def __init__(self, scheduler: "FairScheduler", name: str, shares: int):
        self.scheduler = scheduler
        self.name = name
        self.shares = max(1, shares)
        self.vtime = 0.0
        self.queue: deque[tuple[Callable[[], Awaitable[Any]], asyncio.Future]] = (
            deque()
        )
        # observability: cumulative wall seconds burned by this group
        self.consumed_s = 0.0
        self.units_run = 0
        self.inflight: asyncio.Task | None = None  # at most one

    def submit(self, fn: Callable[[], Awaitable[Any]]) -> asyncio.Future:
        """Enqueue one unit; resolves with fn()'s result."""
        return self.scheduler._submit(self, fn)

    async def run(self, fn: Callable[[], Awaitable[Any]]) -> Any:
        return await self.submit(fn)


class FairScheduler:
    """Deficit-style weighted-fair runner over scheduling groups."""

    def __init__(self, shares: dict[str, int] | None = None):
        self.groups: dict[str, SchedulingGroup] = {}
        for name, s in (shares or DEFAULT_SHARES).items():
            self.groups[name] = SchedulingGroup(self, name, s)
        self._wakeup = asyncio.Event()
        self._runner: asyncio.Task | None = None
        self._stopped = False
        # system virtual time: the vtime of the last unit run. A group
        # activating after an idle spell is lifted to it, so it neither
        # banks credit (monopolizing until others catch up) nor carries
        # debt from a solo-run period (being locked out until the
        # newcomer catches up) — classic WFQ virtual-clock restart.
        self._vnow = 0.0

    def group(self, name: str) -> SchedulingGroup:
        return self.groups[name]

    def add_group(self, name: str, shares: int) -> SchedulingGroup:
        g = self.groups[name] = SchedulingGroup(self, name, shares)
        return g

    # -- lifecycle ----------------------------------------------------
    def start(self) -> None:
        if self._runner is None:
            self._stopped = False
            self._runner = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        self._stopped = True
        self._wakeup.set()
        runner, self._runner = self._runner, None
        await cancel_and_wait(runner)
        # fail queued units so callers never hang on shutdown
        for g in self.groups.values():
            while g.queue:
                _fn, fut = g.queue.popleft()
                if not fut.done():
                    fut.cancel()

    # -- submission ---------------------------------------------------
    def _vmin_other(self, group: SchedulingGroup) -> float | None:
        """Minimum vtime over OTHER groups with queued or in-flight
        work; None when this group is alone."""
        vals = [
            g.vtime
            for g in self.groups.values()
            if g is not group and (g.queue or g.inflight)
        ]
        return min(vals) if vals else None

    def _submit(self, group: SchedulingGroup, fn) -> asyncio.Future:
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        if not group.queue and not group.inflight:
            # activation lift: enter level with the busiest competitor
            # (no banked credit) but never behind it (no banked debt)
            floor = self._vmin_other(group)
            group.vtime = max(
                group.vtime, self._vnow if floor is None else floor
            )
        group.queue.append((fn, fut))
        self._wakeup.set()
        return fut

    # -- the runner ---------------------------------------------------
    async def _exec(self, g: SchedulingGroup, fn, fut) -> None:
        t0 = time.perf_counter()
        try:
            result = await fn()
        except asyncio.CancelledError:
            if not fut.done():
                fut.cancel()
            raise
        except Exception as e:
            if not fut.done():
                fut.set_exception(e)
        else:
            if not fut.done():
                fut.set_result(result)
        finally:
            cost = max(time.perf_counter() - t0, _MIN_COST_S)
            g.vtime += cost / g.shares
            self._vnow = max(self._vnow, g.vtime)
            g.consumed_s += cost
            g.units_run += 1
            g.inflight = None
            self._wakeup.set()

    async def _run(self) -> None:
        """Dispatch loop: at most ONE in-flight unit per group (units
        within a group stay serial — the single-threading model), but
        DIFFERENT groups run concurrently, so an I/O-bound archival
        unit can never head-of-line block a compaction unit. Fairness
        is enforced at START time: a group may only start a unit while
        its vtime is at the minimum over backlogged groups — a group
        whose shares it has outrun waits for virtual time (i.e. other
        groups' completions) to catch up."""
        def eligible(g: SchedulingGroup) -> bool:
            if not g.queue or g.inflight is not None:
                return False
            floor = self._vmin_other(g)
            return floor is None or g.vtime <= floor

        try:
            while not self._stopped:
                started = False
                for g in sorted(
                    self.groups.values(), key=lambda g: g.vtime
                ):
                    if eligible(g):
                        fn, fut = g.queue.popleft()
                        g.inflight = asyncio.ensure_future(
                            self._exec(g, fn, fut)
                        )
                        started = True
                if started:
                    await asyncio.sleep(0)  # yield between dispatches
                    continue
                self._wakeup.clear()
                # re-check: a completion/submit may have raced the clear
                if any(eligible(g) for g in self.groups.values()):
                    continue
                await self._wakeup.wait()
        finally:
            for g in self.groups.values():
                if g.inflight is not None:
                    g.inflight.cancel()

    # -- observability ------------------------------------------------
    def stats(self) -> dict[str, dict]:
        return {
            name: {
                "shares": g.shares,
                "queued": len(g.queue),
                "units_run": g.units_run,
                "consumed_s": round(g.consumed_s, 6),
            }
            for name, g in self.groups.items()
        }


# ---------------------------------------------------------------- loop


class LoopMonitor:
    """Reactor utilization and stall accounting for the asyncio loop
    (the counterpart of Seastar's reactor utilization and stall
    detector).

    The loop's selector is hooked once: `select` is the only place an
    iteration of `BaseEventLoop._run_once` waits, so the time from one
    `select` returning to the next one being entered is that
    iteration's busy time. Each iteration is one observation of
    `reactor_busy_seconds`; one that lasted at least `stall_ms` (the
    admin server's `blocked_reactor_notify_ms`) is also one of
    `reactor_stall_seconds`. Two clock reads an iteration. An iteration
    in which torch.profiler started or stopped is not counted: the
    profiler's own start-up (seconds, on a card) is not the program's.

    The loop is process-wide, so the families live in exactly one
    registry, the one `bind` was given: summing over every broker's
    registry counts each iteration once."""

    def __init__(self, stall_ms: float = 25.0):
        self.stall_ms = stall_ms
        self._busy = None
        self._stall = None
        self._selectors: list = []

    def bind(self, registry) -> None:
        """Observe into `registry` from now on (None: observe nowhere)."""
        if registry is None:
            self._busy = self._stall = None
            return
        self._busy = registry.histogram(
            "reactor_busy_seconds",
            "Event-loop time outside select, one observation an iteration",
        ).observe
        self._stall = registry.histogram(
            "reactor_stall_seconds",
            "Event-loop iterations at or over blocked_reactor_notify_ms",
        ).observe

    def hook(self, loop) -> None:
        """Time `loop`'s selector; once a selector (no-op for a loop
        with no Python selector)."""
        sel = getattr(loop, "_selector", None)
        if sel is None or "select" in vars(sel):
            return
        inner = sel.select
        clock = time.perf_counter
        profiling = trace.profiler_running
        ready = None
        profiled = False

        def select(timeout=None):
            nonlocal ready, profiled
            t = clock()
            if (
                ready is not None
                and self._busy is not None
                and profiling() == profiled
            ):
                busy = t - ready
                self._busy(busy)
                if busy * 1e3 >= self.stall_ms:
                    self._stall(busy)
            try:
                return inner(timeout)
            finally:
                profiled = profiling()
                ready = clock()

        sel.select = select
        self._selectors.append(sel)

    def unhook(self) -> None:
        for sel in self._selectors:
            vars(sel).pop("select", None)
        self._selectors.clear()


# ---------------------------------------------------------------- memory


class MemoryGovernor:
    """CPython GC discipline for the broker hot path.

    The reference never faces this (seastar pre-allocates and never
    runs a tracing collector); CPython's gen2 mark pass over a large
    settled broker heap is a latency cliff — measured r4 on this box:
    one 837 ms gen2 pause inside a 6 s replicated-produce window, and
    freezing the boot graph tripled acks=all throughput
    (bench_profiles/profile_replicated.py, 10.0 -> 28.2 MB/s,
    p99 233 -> 59 ms).

    Policy:
      - on start: collect once, then gc.freeze() the settled object
        graph out of the collector (the CPython trick for large
        steady-state server heaps);
      - raise the gen0 threshold (default 700 is tuned for scripts,
        not servers holding thousands of raft groups) and make gen2
        passes rare — transient request garbage dies young or by
        refcount;
      - optionally re-freeze on a long cadence: one *deliberate*
        collect+freeze at a known time instead of a surprise gen2
        pause at a random one;
      - track pause times for /metrics (the probe the reference gets
        from seastar's reactor stall detector), each pause also the
        `gc` loop section (observability/trace.section).

    Process-global by nature (the collector is); refcounted so
    multi-broker fixtures start/stop it once. The loop monitor runs
    under the same refcount. The process-wide families (the loop
    monitor's and `loop_section_seconds{section=gc}`) are observed in
    the registry of the earliest-started broker still running, so the
    sum over brokers' registries counts each pause and iteration once.
    """

    _instance: "MemoryGovernor | None" = None

    def __init__(
        self,
        gen0_threshold: int = 50_000,
        gen1_threshold: int = 20,
        gen2_threshold: int = 100,
        # periodic collect+freeze: objects settling AFTER start (e.g.
        # partitions materialized post-boot) join the frozen graph at a
        # deliberate, bounded cadence instead of being full-scanned by
        # every eventual gen2 pass. 0 disables.
        refreeze_interval_s: float = 300.0,
    ):
        self.gen0_threshold = gen0_threshold
        self.gen1_threshold = gen1_threshold
        self.gen2_threshold = gen2_threshold
        self.refreeze_interval_s = refreeze_interval_s
        self.pauses_total = 0
        self.pause_sum_ms = 0.0
        self.pause_max_ms = 0.0
        self.gen2_total = 0
        self.loop = LoopMonitor()
        self._registries: list = []
        self._owner = None
        self._gc_section = None
        self._refs = 0
        self._saved_threshold: tuple | None = None
        self._t0 = 0.0
        self._task: asyncio.Task | None = None

    @classmethod
    def instance(cls) -> "MemoryGovernor":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def _gc_cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_section = trace.section("gc", self._owner).__enter__()
            self._t0 = time.perf_counter()
        else:
            dt_ms = (time.perf_counter() - self._t0) * 1e3
            if self._gc_section is not None:
                self._gc_section.__exit__(None, None, None)
                self._gc_section = None
            self.pauses_total += 1
            self.pause_sum_ms += dt_ms
            if dt_ms > self.pause_max_ms:
                self.pause_max_ms = dt_ms
            if info.get("generation") == 2:
                self.gen2_total += 1

    def _bind(self) -> None:
        self._owner = self._registries[0] if self._registries else None
        self.loop.bind(self._owner)

    def start(self, registry=None) -> None:
        """Called from a running loop; `registry` is the starting
        broker's, None for a caller that keeps no metrics."""
        import gc

        self._refs += 1
        if registry is not None:
            self._registries.append(registry)
            self._bind()
        self.loop.hook(asyncio.get_running_loop())
        if self._refs > 1:
            return
        self._saved_threshold = gc.get_threshold()
        gc.set_threshold(
            self.gen0_threshold, self.gen1_threshold, self.gen2_threshold
        )
        gc.callbacks.append(self._gc_cb)
        gc.collect()
        gc.freeze()
        if self.refreeze_interval_s > 0:
            self._task = asyncio.ensure_future(self._refreeze_loop())

    async def _refreeze_loop(self) -> None:
        import gc

        while True:
            await asyncio.sleep(self.refreeze_interval_s)
            gc.collect()
            gc.freeze()

    def stop(self, registry=None) -> None:
        import gc

        if registry in self._registries:
            self._registries.remove(registry)
            self._bind()
        self._refs = max(0, self._refs - 1)
        if self._refs > 0:
            return
        self.loop.unhook()
        if self._task is not None:
            self._task.cancel()
            self._task = None
        if self._gc_cb in gc.callbacks:
            gc.callbacks.remove(self._gc_cb)
        if self._saved_threshold is not None:
            gc.set_threshold(*self._saved_threshold)
            self._saved_threshold = None
        # return frozen objects to the collector: without this, every
        # start/stop cycle (multi-broker fixtures, embedding apps)
        # would permanently exempt the previous broker's cyclic garbage
        gc.unfreeze()
        gc.collect()

    def _after_fork_child(self) -> None:
        """A forked worker's families belong to its own brokers: the
        copies of the parent's registries, which nothing there scrapes,
        own none of them."""
        self._registries.clear()
        self._bind()

    def stats(self) -> dict:
        return {
            "gc_pauses_total": self.pauses_total,
            "gc_pause_sum_ms": round(self.pause_sum_ms, 3),
            "gc_pause_max_ms": round(self.pause_max_ms, 3),
            "gc_gen2_total": self.gen2_total,
        }


def _after_fork_child() -> None:
    if MemoryGovernor._instance is not None:
        MemoryGovernor._instance._after_fork_child()


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_after_fork_child)
