"""tests/test_feature_barrier.py run on the port: all 5 test functions,
with imports pointed at redpanda_tpu_torch. An autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
`seed_cluster` and `wait_until` come from `test_torch_ref_membership`.
Nothing is left out.


Feature barrier: tag-based cluster rendezvous.

Reference behaviors: cluster/feature_barrier.{h,cc} — a barrier
completes only when EVERY member has entered; auto-enter hooks let
nodes answer barriers implicitly; feature activation rides a barrier
so a down or lagging node defers it (proved live, not just registered).
"""

import pytest

import asyncio

from redpanda_tpu_torch.cluster.feature_barrier import (
    FEATURE_BARRIER,
    FeatureBarrier,
)
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


def _mesh(n):
    """n barrier instances wired directly to each other's exchange."""
    nodes: dict[int, FeatureBarrier] = {}

    def make_send(src):
        async def send(dst, method_id, payload, timeout):
            assert method_id == FEATURE_BARRIER
            if dst not in nodes:
                raise ConnectionError("down")
            return await nodes[dst].exchange(payload)

        return send

    members = lambda: list(range(n))  # noqa: E731
    for i in range(n):
        nodes[i] = FeatureBarrier(i, make_send(i), members)
    return nodes


def test_barrier_completes_when_all_enter():
    async def main():
        nodes = _mesh(3)
        done = await asyncio.gather(
            *(nodes[i].enter("t:x", timeout=5.0) for i in range(3))
        )
        assert done == [True, True, True]

    asyncio.run(main())


def test_barrier_times_out_on_missing_member():
    async def main():
        nodes = _mesh(3)
        # only nodes 0 and 1 enter: node 2 never does
        done = await asyncio.gather(
            nodes[0].enter("t:y", timeout=0.5),
            nodes[1].enter("t:y", timeout=0.5),
        )
        assert done == [False, False]
        # the laggard finally enters: everyone can now complete
        done2 = await asyncio.gather(
            *(nodes[i].enter("t:y", timeout=5.0) for i in range(3))
        )
        assert done2 == [True, True, True]

    asyncio.run(main())


def test_auto_enter_hook():
    async def main():
        nodes = _mesh(3)
        # nodes 1 and 2 auto-enter "feature:" tags; node 0 drives
        for i in (1, 2):
            nodes[i].register_auto_enter("feature:", lambda tag: True)
        assert await nodes[0].enter("feature:f:2", timeout=5.0)
        # a REFUSING hook blocks the rendezvous
        nodes2 = _mesh(3)
        nodes2[1].register_auto_enter("feature:", lambda tag: True)
        nodes2[2].register_auto_enter("feature:", lambda tag: False)
        assert not await nodes2[0].enter("feature:f:2", timeout=0.5)

    asyncio.run(main())


def test_dead_peer_blocks_until_reachable():
    async def main():
        nodes = _mesh(3)
        dead = nodes.pop(2)  # unreachable: sends raise
        assert not await nodes[0].enter("t:z", timeout=0.5)
        nodes[2] = dead  # comes back
        assert await asyncio.gather(
            *(nodes[i].enter("t:z", timeout=5.0) for i in range(3))
        ) == [True, True, True]
        # re-entering a completed barrier is instant (state retained)
        assert await nodes[1].enter("t:z", timeout=0.1)

    asyncio.run(main())


def test_feature_activation_rides_the_barrier(tmp_path):
    """e2e: on a healthy cluster features activate (the barrier
    completes through the real RPC services); the barrier state shows
    every member entered the activation tags."""
    from test_torch_ref_membership import seed_cluster, wait_until

    async def main():
        async with seed_cluster(tmp_path, n=3) as (net, brokers):
            await wait_until(
                lambda: all(
                    b.controller.features.is_active("migrations")
                    for b in brokers
                ),
                msg="features active cluster-wide",
            )
            leader = next(
                b for b in brokers if b.controller.is_leader
            )
            st = leader.controller.barrier._state
            tags = [t for t in st if t.startswith("feature:")]
            assert tags, "activation did not ride the barrier"
            for t in tags:
                assert st[t] >= {0, 1, 2}, (t, st[t])

    asyncio.run(main())
