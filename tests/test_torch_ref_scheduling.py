"""tests/test_scheduling.py run on the port: all 7 cases, with imports
pointed at redpanda_tpu_torch. An autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu", as
in every mirror. Nothing is left out.

Weighted-fair scheduling groups (P6).

Reference model: src/v/resource_mgmt/cpu_scheduling.h — shares keep
maintenance from starving the hot path. The oracle here: over a busy
window, completed units per group track the share ratio; a high-share
unit never waits behind more than one in-flight low-share unit; errors
propagate to the submitter without killing the runner; stop() cancels
queued work.
"""

import asyncio

import pytest

from redpanda_tpu_torch.resource_mgmt import FairScheduler
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


def run(coro):
    return asyncio.run(coro)


def test_share_ratio_over_busy_window():
    async def main():
        s = FairScheduler({"big": 1000, "small": 100})
        s.start()
        done = {"big": 0, "small": 0}

        async def unit(name):
            # equal-cost units: fixed tiny sleep ~ equal wall time
            await asyncio.sleep(0.001)
            done[name] += 1

        futs = []
        for _ in range(66):
            futs.append(s.group("big").submit(lambda: unit("big")))
            futs.append(s.group("small").submit(lambda: unit("small")))
        # sample mid-flight: after ~55 units ran, the ratio must track
        # shares (10:1), not submission order (1:1)
        while done["big"] + done["small"] < 55:
            await asyncio.sleep(0.002)
        big, small = done["big"], done["small"]
        assert big >= 5 * max(small, 1), (big, small)
        await asyncio.gather(*futs)
        assert done == {"big": 66, "small": 66}  # everything completes
        await s.stop()

    run(main())


def test_high_share_unit_not_starved():
    async def main():
        s = FairScheduler({"hot": 1000, "bg": 10})
        s.start()

        async def slow():
            await asyncio.sleep(0.02)

        for _ in range(50):
            s.group("bg").submit(slow)
        await asyncio.sleep(0.005)  # bg is mid-unit
        t0 = asyncio.get_event_loop().time()
        await s.group("hot").run(lambda: asyncio.sleep(0))
        waited = asyncio.get_event_loop().time() - t0
        # at most ~one in-flight bg unit of delay (no queue-drain wait)
        assert waited < 0.1, waited
        await s.stop()

    run(main())


def test_idle_group_does_not_bank_credit():
    async def main():
        s = FairScheduler({"a": 100, "b": 100})
        s.start()

        async def unit():
            await asyncio.sleep(0.001)

        # a runs alone for a while
        for _ in range(20):
            await s.group("a").run(unit)
        # b wakes with zero vtime; without the floor-lift it would
        # monopolize until catching up with a's 20 units
        order = []

        async def tagged(name):
            order.append(name)
            await asyncio.sleep(0.001)

        futs = []
        for _ in range(6):
            futs.append(s.group("a").submit(lambda: tagged("a")))
            futs.append(s.group("b").submit(lambda: tagged("b")))
        await asyncio.gather(*futs)
        # equal shares -> roughly alternating, not a b-monopoly prefix
        assert "a" in order[:4], order
        await s.stop()

    run(main())


def test_unit_error_propagates_and_runner_survives():
    async def main():
        s = FairScheduler({"g": 100})
        s.start()

        async def boom():
            raise RuntimeError("unit failed")

        with pytest.raises(RuntimeError, match="unit failed"):
            await s.group("g").run(boom)
        # runner still alive
        assert await s.group("g").run(lambda: _ret(42)) == 42
        await s.stop()

    async def _ret(v):
        return v

    run(main())


def test_stop_cancels_queued_units():
    async def main():
        s = FairScheduler({"g": 100})
        s.start()

        async def slow():
            await asyncio.sleep(0.05)

        futs = [s.group("g").submit(slow) for _ in range(10)]
        await asyncio.sleep(0.01)
        await s.stop()
        cancelled = sum(1 for f in futs if f.cancelled())
        assert cancelled >= 8, cancelled

    run(main())


def test_groups_run_concurrently_units_serial():
    """An I/O-stalled unit in one group must not head-of-line block
    another group (the archival-outage case); units WITHIN a group
    stay strictly serial."""

    async def main():
        s = FairScheduler({"io": 100, "cpu": 100})
        s.start()
        stall = asyncio.Event()

        async def stuck():
            await stall.wait()

        f_stuck = s.group("io").submit(stuck)
        await asyncio.sleep(0.01)
        t0 = asyncio.get_event_loop().time()
        await s.group("cpu").run(lambda: asyncio.sleep(0))
        assert asyncio.get_event_loop().time() - t0 < 0.5  # not blocked
        # serial within the group: a second io unit waits for the first
        running = []

        async def second():
            running.append(1)

        f2 = s.group("io").submit(second)
        await asyncio.sleep(0.02)
        assert not running  # still queued behind the stalled unit
        stall.set()
        await asyncio.gather(f_stuck, f2)
        assert running == [1]
        await s.stop()

    run(main())


def test_stats_shape():
    async def main():
        s = FairScheduler()
        s.start()
        await s.group("compaction").run(lambda: asyncio.sleep(0))
        st = s.stats()
        assert st["compaction"]["units_run"] == 1
        assert st["raft"]["shares"] == 1000
        await s.stop()

    run(main())
