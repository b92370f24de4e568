"""tests/test_locks.py run on the port: utils/locks.LockMap and
utils/tasks.cancel_and_wait (verbatim copies of the reference's), with
the deterministic interleaving regressions for a torn `+=` across an
await and a torn check-then-act in concurrent stop().

The reference file is copied with its imports pointed at
redpanda_tpu_torch. Carried: every case. Left out: nothing.
"""

import asyncio

import pytest

from redpanda_tpu_torch.utils.locks import LockMap
from redpanda_tpu_torch.utils.tasks import cancel_and_wait


# -- LockMap -----------------------------------------------------------


def test_lockmap_get_or_create_identity():
    async def run():
        m = LockMap()
        a = m.lock("peer-1")
        assert m.lock("peer-1") is a  # loop-atomic get-or-create
        assert m.lock("peer-2") is not a
        assert len(m) == 2
        assert "peer-1" in m and "peer-3" not in m
        assert sorted(m.keys()) == ["peer-1", "peer-2"]

    asyncio.run(run())


def test_lockmap_locked_and_held():
    async def run():
        m = LockMap()
        assert not m.locked("x")  # no entry: not held
        async with m.lock("x"):
            assert m.locked("x")
            assert m.held() == ["x"]
        assert not m.locked("x")
        assert m.held() == []

    asyncio.run(run())


def test_lockmap_discard():
    async def run():
        m = LockMap()
        assert m.discard("missing") is False
        m.lock("x")
        assert m.discard("x") is True
        assert "x" not in m
        async with m.lock("y"):
            with pytest.raises(RuntimeError, match="lock is held"):
                m.discard("y")
        assert "y" in m  # refusal left the entry intact

    asyncio.run(run())


def test_lockmap_prune_keep_and_held_survival():
    async def run():
        m = LockMap()
        for k in ("a", "b", "c"):
            m.lock(k)
        async with m.lock("a"):
            assert m.prune(keep=["b"]) == 1  # only "c" dropped
            assert sorted(m.keys()) == ["a", "b"]
            assert m.prune() == 1  # "b" dropped; held "a" survives
            assert list(m.keys()) == ["a"]
        assert m.prune() == 1
        assert len(m) == 0

    asyncio.run(run())


def test_lockmap_clear_refuses_holders():
    async def run():
        m = LockMap()
        m.lock("idle")
        async with m.lock("busy"):
            with pytest.raises(RuntimeError, match="'busy'"):
                m.clear()
        m.clear()
        assert len(m) == 0

    asyncio.run(run())


def test_lockmap_concurrent_first_access_single_lock():
    """Two coroutines racing the first access serialize on ONE lock —
    the exact property the old setdefault call sites relied on."""

    async def run():
        m = LockMap()
        order = []

        async def worker(tag):
            async with m.lock("shared"):
                order.append(("enter", tag))
                await asyncio.sleep(0)
                order.append(("exit", tag))

        await asyncio.gather(worker("a"), worker("b"))
        assert order == [
            ("enter", "a"), ("exit", "a"), ("enter", "b"), ("exit", "b")
        ]
        assert len(m) == 1

    asyncio.run(run())


def test_lockmap_repr():
    async def run():
        m = LockMap()
        m.lock("x")
        async with m.lock("y"):
            assert repr(m) == "LockMap(2 keys, 1 held)"

    asyncio.run(run())


# -- cancel_and_wait ---------------------------------------------------


def test_cancel_and_wait_none_noop():
    asyncio.run(cancel_and_wait(None))


def test_cancel_and_wait_settles_and_absorbs_cancel():
    async def run():
        started = asyncio.Event()

        async def body():
            started.set()
            await asyncio.sleep(60)

        t = asyncio.ensure_future(body())
        await started.wait()
        await cancel_and_wait(t)
        assert t.cancelled()

    asyncio.run(run())


def test_cancel_and_wait_propagates_real_errors():
    async def run():
        async def body():
            raise ValueError("shutdown bug")

        t = asyncio.ensure_future(body())
        await asyncio.sleep(0)  # let it fail before the cancel
        with pytest.raises(ValueError, match="shutdown bug"):
            await cancel_and_wait(t)

    asyncio.run(run())


def test_cancel_and_wait_already_done():
    async def run():
        async def body():
            return 7

        t = asyncio.ensure_future(body())
        await asyncio.sleep(0)
        await cancel_and_wait(t)  # cancel after completion: no-op
        assert t.result() == 7

    asyncio.run(run())


# -- interleaving regressions for the fixed race families -------------


def test_hoisted_await_rmw_not_torn():
    """cloud/archiver.py regression shape: `self.merges += await
    pass_once()` tears (both tasks load the counter before
    suspending); the fix — await into a local, then a loop-atomic
    `+=` — keeps every increment under the same forced interleaving."""

    class Harness:
        def __init__(self, gate):
            self.gate = gate
            self.merges = 0

        async def _pass(self):
            await self.gate.wait()
            return 1

        async def run_once_torn(self):
            # the bug under test, preserved on purpose
            self.merges += await self._pass()  # rplint: disable=RPL015

        async def run_once_fixed(self):
            merged = await self._pass()
            self.merges += merged

    async def drive(method):
        gate = asyncio.Event()
        h = Harness(gate)
        tasks = [asyncio.ensure_future(getattr(h, method)()) for _ in range(2)]
        await asyncio.sleep(0)
        await asyncio.sleep(0)  # both parked on the gate
        gate.set()
        await asyncio.gather(*tasks)
        return h.merges

    assert asyncio.run(drive("run_once_torn")) == 1  # the bug: one lost
    assert asyncio.run(drive("run_once_fixed")) == 2


def test_swap_then_await_concurrent_stop():
    """Concurrent stop() regression: both callers detach at most once,
    the worker is cancelled exactly once, and a start() racing the
    stop is never clobbered — the swap publishes None before any
    suspension point."""

    class Service:
        def __init__(self):
            self._task = None
            self.cancels = 0

        def start(self):
            async def body():
                try:
                    await asyncio.sleep(60)
                except asyncio.CancelledError:
                    self.cancels += 1
                    raise

            self._task = asyncio.ensure_future(body())

        async def stop(self):
            task, self._task = self._task, None
            await cancel_and_wait(task)

    async def run():
        svc = Service()
        svc.start()
        await asyncio.sleep(0)
        await asyncio.gather(svc.stop(), svc.stop())
        assert svc.cancels == 1
        assert svc._task is None

        # stop() racing a restart: the restarted task must survive —
        # the old torn shape (`await; self._task = None`) nulled it
        svc.start()
        first = svc._task
        stopper = asyncio.ensure_future(svc.stop())
        await asyncio.sleep(0)  # stopper swapped + awaiting `first`
        svc.start()  # restart during the stop's suspension
        second = svc._task
        await stopper
        assert first.cancelled()
        assert svc._task is second and not second.done()
        await svc.stop()

    asyncio.run(run())
