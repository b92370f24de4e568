"""tests/test_recovery_throttle.py run on the port: all 6 cases, with
imports pointed at redpanda_tpu_torch. `RaftCluster`, `data_batch` and
`run` come from `test_torch_ref_raft` (every GroupManager on the CPU,
`device="cpu"`). As the reference's conftest does for
test_recovery_throttle.py, an autouse fixture arms the SAME-frame
fingerprint check (`shard_state.SAME_DEBUG`); another sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
Nothing is left out.

Recovery throttle + node-wide (snc) quotas.

Reference: src/v/raft/recovery_throttle.h (shared catch-up rate budget),
recovery_memory_quota.{h,cc}, and kafka/server/snc_quota_manager.h:36
(node-wide ingress/egress caps over all clients).
"""

import asyncio

import pytest

from redpanda_tpu_torch.config import ClusterConfig
from redpanda_tpu_torch.kafka.quotas import QuotaManager
from redpanda_tpu_torch.raft.recovery import RecoveryThrottle
from redpanda_tpu_torch.ops import default_device
from redpanda_tpu_torch.raft import shard_state


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


@pytest.fixture(autouse=True)
def _same_debug(monkeypatch):
    # the reference's conftest arms the SAME-frame fingerprint check for
    # test_recovery_throttle.py; the port's flag is its own
    monkeypatch.setattr(shard_state, "SAME_DEBUG", True)


def test_recovery_throttle_paces_bytes():
    async def main():
        t = RecoveryThrottle(rate_bytes_s=1_000_000, concurrency=2)
        loop = asyncio.get_event_loop()
        t0 = loop.time()
        # first burst rides the full bucket; the next spends into debt
        await t.throttle(1_000_000)
        await t.throttle(500_000)
        # now ~0.5 MB in debt at 1 MB/s: the next call must sleep ~0.5s
        await t.throttle(1)
        waited = loop.time() - t0
        assert waited >= 0.3, waited
        assert t.throttled_s > 0

    asyncio.run(main())


def test_recovery_throttle_live_rate_rebind():
    async def main():
        t = RecoveryThrottle(rate_bytes_s=100, concurrency=2)
        t.set_rate(1e12)  # effectively unlimited
        loop = asyncio.get_event_loop()
        t0 = loop.time()
        for _ in range(5):
            await t.throttle(10_000_000)
        assert loop.time() - t0 < 0.2

    asyncio.run(main())


def test_recovery_memory_quota_bounds_concurrency():
    async def main():
        t = RecoveryThrottle(rate_bytes_s=1e12, concurrency=2)
        active = 0
        peak = 0

        async def round_():
            nonlocal active, peak
            async with t.dispatch_slot():
                active += 1
                peak = max(peak, active)
                await asyncio.sleep(0.02)
                active -= 1

        await asyncio.gather(*(round_() for _ in range(8)))
        assert peak <= 2, peak

    asyncio.run(main())


def test_snc_node_quota_caps_aggregate_over_clients():
    """Per-client buckets alone cannot bound a node: N distinct client
    ids each get their own allowance. The snc bucket throttles the
    AGGREGATE regardless of client-id cardinality."""

    async def main():
        cfg = ClusterConfig()
        cfg.apply({"kafka_throughput_limit_node_in_bps": "1000000"}, [])
        q = QuotaManager(cfg)
        # 10 different clients, 300 KB each = 3 MB against a 1 MB/s cap
        delays = [
            q.record_and_throttle("produce", f"c{i}", 300_000)
            for i in range(10)
        ]
        assert delays[-1] > 0, delays
        # egress untouched (separate direction bucket)
        assert q.record_and_throttle("fetch", "c0", 300_000) == 0

    asyncio.run(main())


def test_snc_and_per_client_take_max():
    async def main():
        cfg = ClusterConfig()
        cfg.apply(
            {
                "kafka_throughput_limit_node_in_bps": "100000000",
                "quota_produce_bytes_per_s": "1000",
            },
            [],
        )
        q = QuotaManager(cfg)
        q.record_and_throttle("produce", "small", 1000)
        d = q.record_and_throttle("produce", "small", 5000)
        # the per-client cap binds long before the node-wide one
        assert d >= 4000, d

    asyncio.run(main())


def test_normal_replication_is_never_throttled(tmp_path):
    """The batcher ships every flush round through the catch-up fiber:
    round 0 must NOT touch the recovery budget (only a follower still
    behind after a full round is recovering)."""
    from test_torch_ref_raft import RaftCluster, data_batch, run

    async def main():
        cluster = RaftCluster(tmp_path, n_nodes=3)
        await cluster.start()
        await cluster.create_group()
        leader = await cluster.wait_leader()
        gm = cluster.nodes[leader.node_id]
        # a tiny budget that ANY throttled traffic would trip
        gm.recovery_throttle.set_rate(1)
        for i in range(20):
            await leader.replicate(data_batch(b"x" * 2000, 2), acks=-1)
        assert gm.recovery_throttle.throttled_s == 0.0
        await cluster.stop()

    run(main())
