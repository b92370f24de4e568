"""The shard runtime's heartbeat deadline counts only time in which the
supervisor pinged: a restart whose re-adoption hook holds the reap loop
past the deadline must not make the reborn shard a gray failure, and a
SIGSTOP'd shard is still found while the supervisor pings on time."""

import asyncio
import os
import signal

from redpanda_tpu_torch.ssx.shards import ShardRuntime


async def _echo_child(ctx):
    async def echo(method, payload):
        return b"%d" % ctx.shard_id if method == "whoami" else payload

    ctx.register("echo", echo)
    return None


def _runtime():
    return ShardRuntime(2, _echo_child, restart_limit=2, heartbeat_interval=0.1, heartbeat_deadline=0.8)


def test_slow_restart_hook_is_not_a_gray_failure():
    """on_shard_up (the broker re-adopting the shard's partitions) holds
    the reap loop for 2.5 deadlines; no ping goes out meanwhile, so the
    reborn shard is not killed when supervision resumes."""

    async def main():
        rt = _runtime()
        restarted = asyncio.Event()

        async def readopt(sid):
            await asyncio.sleep(2.0)

        rt.on_shard_up = readopt
        rt.on_restart = lambda _rt: restarted.set()
        await rt.start()
        try:
            os.kill(rt.shard_pids[1], signal.SIGKILL)
            await asyncio.wait_for(restarted.wait(), 15.0)
            reborn = rt.shard_pids[1]
            await asyncio.sleep(2.0)  # twenty heartbeat passes
            assert rt.gray_failures == {}, rt.gray_failures
            assert rt.shard_restarts == {1: 1} and rt.shard_pids[1] == reborn
            assert await rt.invoke_on(1, "echo", "whoami", timeout=5.0) == b"1"
        finally:
            await rt.stop()

    asyncio.run(main())


def test_stopped_shard_after_a_slow_restart_is_a_gray_failure():
    """The credit covers only the supervisor's own silence: a shard that
    stops answering after the slow restart is still escalated."""

    async def main():
        rt = _runtime()
        restarted = asyncio.Event()

        async def readopt(sid):
            await asyncio.sleep(2.0)

        rt.on_shard_up = readopt
        rt.on_restart = lambda _rt: restarted.set()
        await rt.start()
        try:
            os.kill(rt.shard_pids[1], signal.SIGKILL)
            await asyncio.wait_for(restarted.wait(), 15.0)
            os.kill(rt.shard_pids[1], signal.SIGSTOP)
            deadline = asyncio.get_event_loop().time() + 15.0
            while rt.gray_failures.get(1, 0) == 0:
                assert asyncio.get_event_loop().time() < deadline, "the stopped shard was never escalated"
                await asyncio.sleep(0.1)
        finally:
            await rt.stop()

    asyncio.run(main())
