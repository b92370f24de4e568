"""tests/test_upgrade.py run on the port: all 1 test functions, with
imports pointed at redpanda_tpu_torch. Every broker is the port's on the
CPU (`BrokerConfig(device="cpu")`), and an autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
Nothing is left out.


Rolling upgrade across feature levels (mixed-version cluster).

Reference model: tests/rptest/tests/compatibility/ upgrade tests via
redpanda_installer — old builds join, features stay off until EVERY
member runs the new level, then activate exactly once; version-gated
APIs refuse service while any member lags.
"""

import asyncio

import pytest

from redpanda_tpu_torch.app import Broker, BrokerConfig
from redpanda_tpu_torch.cluster.features import LATEST_LOGICAL_VERSION
from redpanda_tpu_torch.kafka.client import KafkaClient
from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")

OLD = LATEST_LOGICAL_VERSION - 1


def _cfg(tmp_path, i, members, version):
    return BrokerConfig(
        device="cpu",
        node_id=i,
        data_dir=str(tmp_path / f"n{i}"),
        members=members,
        election_timeout_s=0.15,
        heartbeat_interval_s=0.03,
        logical_version=version,
    )


async def _rolling_upgrade(tmp_path):
    net = LoopbackNetwork()
    members = [0, 1, 2]
    # phase 1: the whole cluster runs the OLD feature level
    brokers = {
        i: Broker(_cfg(tmp_path, i, members, OLD), loopback=net)
        for i in members
    }
    for b in brokers.values():
        await b.start()
    c0 = brokers[0].controller
    await c0.wait_leader()

    async def wait_registered(n):
        deadline = asyncio.get_event_loop().time() + 10
        while len(c0.members_table.registered()) < n:
            assert asyncio.get_event_loop().time() < deadline
            await asyncio.sleep(0.05)

    async def live_leader():
        deadline = asyncio.get_event_loop().time() + 10
        while True:
            b = next(
                (b for b in brokers.values() if b.controller.is_leader),
                None,
            )
            if b is not None:
                return b.controller
            assert asyncio.get_event_loop().time() < deadline
            await asyncio.sleep(0.05)

    await wait_registered(3)
    await asyncio.sleep(1.0)  # several feature passes
    leader = await live_leader()
    # v3-gated features must NOT be active on an OLD cluster, and the
    # one-shot migration gated on them must not have run
    assert not leader.features.is_active("migrations")
    assert leader.features.cluster_version < LATEST_LOGICAL_VERSION
    assert "offsets_topic_compaction" not in leader.migrations_done

    # phase 2: roll nodes to the NEW level one at a time; features must
    # stay inactive while ANY member still advertises the old level
    for i in [1, 2]:
        await brokers[i].stop()
        brokers[i] = Broker(
            _cfg(tmp_path, i, members, None), loopback=net
        )
        await brokers[i].start()
        await asyncio.sleep(0.8)
        live = await live_leader()
        assert not live.features.is_active("migrations"), (
            f"feature activated with node 0 still at v{OLD}"
        )

    # final node upgrades: activation must follow
    await brokers[0].stop()
    brokers[0] = Broker(_cfg(tmp_path, 0, members, None), loopback=net)
    await brokers[0].start()
    deadline = asyncio.get_event_loop().time() + 15
    while True:
        live = next(
            (b for b in brokers.values() if b.controller.is_leader), None
        )
        if (
            live is not None
            and live.controller.features.is_active("migrations")
            and "offsets_topic_compaction" in live.controller.migrations_done
        ):
            break
        assert asyncio.get_event_loop().time() < deadline, (
            live and live.controller.features.snapshot()
        )
        await asyncio.sleep(0.1)
    assert live.controller.features.cluster_version == LATEST_LOGICAL_VERSION

    # the upgraded cluster still serves end to end
    client = KafkaClient([b.kafka_advertised for b in brokers.values()])
    await client.create_topic("post-upgrade", partitions=1, replication_factor=3)
    await client.produce("post-upgrade", 0, [(b"k", b"v")])
    got = await client.fetch("post-upgrade", 0, 0)
    assert [(k, v) for _o, k, v in got] == [(b"k", b"v")]
    await client.close()
    for b in brokers.values():
        await b.stop()


def test_rolling_upgrade_gates_features(tmp_path):
    asyncio.run(_rolling_upgrade(tmp_path))
