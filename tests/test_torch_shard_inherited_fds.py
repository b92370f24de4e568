"""A worker forked through the shard runtime's fork server inherits the
parent's Python objects, among them sockets whose fds the fork hygiene
(`ssx/shards._close_inherited_sockets`) takes away. When such an object
is finalized in the worker (an unclosed event loop the asyncio policy
held, an unclosed transport in a reference cycle) it closes its fd
number. A plain close of the inherited fd let the worker's own event
loop take that number, so the finalizer closed the worker's epoll and
the worker died at its first poll (EBADF) on every restart: the
procnemesis mirror's `test_unavailable_shard_answers_retriable_not_hang`
failed so when an earlier test in its process had left such a loop."""

import asyncio
import gc
import os
import socket

from redpanda_tpu_torch.ssx import shards
from redpanda_tpu_torch.ssx.shards import ShardRuntime


async def _echo_child(ctx):
    async def echo(method, payload):
        return b"%d" % ctx.shard_id if method == "whoami" else payload

    ctx.register("echo", echo)
    # the worker's cyclic GC, now rather than at its allocator's whim:
    # it finalizes the parent's objects the worker no longer reaches
    gc.collect()
    return None


def test_stale_socket_object_cannot_close_a_new_fd():
    """In a forked child: after the hygiene, fds opened up to past the
    stale socket's number stay open when the parent's socket object is
    closed there."""
    a, b = socket.socketpair()
    pid = os.fork()
    if pid == 0:
        code = 1
        try:
            shards._close_inherited_sockets(set())
            fresh = []
            while not fresh or max(fresh) <= max(a.fileno(), b.fileno()):
                fresh.extend(os.pipe())
            a.close()
            b.close()
            for fd in fresh:
                os.fstat(fd)
            code = 0
        except OSError:
            code = 3
        finally:
            os._exit(code)
    _, status = os.waitpid(pid, 0)
    a.close()
    b.close()
    assert os.waitstatus_to_exitcode(status) == 0


def test_worker_outlives_a_stale_loop_of_its_parent():
    """The asyncio policy of the process that starts the runtime holds
    an unclosed loop (as `asyncio.get_event_loop()` outside a running
    loop leaves one); each worker drops it when it sets its own loop,
    and its GC closes the loop's self-pipe sockets."""
    policy = asyncio.get_event_loop_policy()
    # no frame may hold it: in the worker the policy's is the last reference
    policy.set_event_loop(asyncio.new_event_loop())

    async def main():
        rt = ShardRuntime(2, _echo_child, restart_limit=2)
        await rt.start()
        try:
            assert await rt.invoke_on(1, "echo", "whoami", timeout=10.0) == b"1"
            assert rt.restarts == 0 and rt.crashed == {}
        finally:
            await rt.stop()

    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(asyncio.wait_for(main(), 60.0))
    finally:
        loop.close()
        policy.get_event_loop().close()
        policy.set_event_loop(None)
