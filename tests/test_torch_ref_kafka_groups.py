"""tests/test_kafka_groups.py run on the port: all 11 cases, with
imports pointed at redpanda_tpu_torch. The brokers come from
`test_torch_ref_kafka_e2e`'s fixtures, on the CPU
(`BrokerConfig(device="cpu")`). An autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu" (the
kernels' plain versions). Nothing is left out.

Consumer-group coordinator e2e tests.

Reference test model: kafka/server/tests/group_membership_test.cc,
consumer_groups_test.cc and tests/rptest group membership suites —
join/sync/heartbeat/leave lifecycle, offset commit/fetch durability,
two-member rebalance, coordinator routing.
"""

import asyncio

import pytest

from redpanda_tpu_torch.kafka.client import KafkaClient, KafkaClientError
from redpanda_tpu_torch.kafka.protocol import ErrorCode

from test_torch_ref_kafka_e2e import broker_cluster, client_for
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")

PROTO = [("range", b"meta-v0")]


def test_join_sync_heartbeat_leave(tmp_path):
    async def run():
        async with broker_cluster(tmp_path, 1) as brokers:
            async with client_for(brokers) as client:
                g = client.group("g1")
                join = await g.join(PROTO)
                assert join.leader == join.member_id  # sole member leads
                assert join.generation_id >= 1
                assert [m.member_id for m in join.members] == [join.member_id]
                assignment = await g.sync([(g.member_id, b"assign-0")])
                assert assignment == b"assign-0"
                assert await g.heartbeat() == 0
                await g.leave()

    asyncio.run(run())


def test_offset_commit_fetch_roundtrip(tmp_path):
    async def run():
        async with broker_cluster(tmp_path, 1) as brokers:
            async with client_for(brokers) as client:
                await client.create_topic("t1", partitions=2)
                g = client.group("g2")
                await g.join(PROTO)
                await g.sync([(g.member_id, b"")])
                await g.commit_offsets({("t1", 0): 5, ("t1", 1): 9})
                got = await g.fetch_offsets({"t1": [0, 1]})
                assert got == {("t1", 0): 5, ("t1", 1): 9}
                # fetch-all form
                got_all = await g.fetch_offsets(None)
                assert got_all == {("t1", 0): 5, ("t1", 1): 9}
                # unknown partition reports no offset
                got2 = await g.fetch_offsets({"t1": [0, 1, 7]})
                assert ("t1", 7) not in got2

    asyncio.run(run())


def test_two_member_rebalance(tmp_path):
    async def run():
        async with broker_cluster(tmp_path, 1) as brokers:
            async with client_for(brokers) as c1, client_for(brokers) as c2:
                g1 = c1.group("g3")
                g2 = c2.group("g3")
                # both join concurrently → same generation, one leader
                j1, j2 = await asyncio.gather(g1.join(PROTO), g2.join(PROTO))
                assert j1.generation_id == j2.generation_id
                leaders = {j1.leader, j2.leader}
                assert len(leaders) == 1
                leader = g1 if j1.leader == j1.member_id else g2
                follower = g2 if leader is g1 else g1
                members = (j1 if leader is g1 else j2).members
                assert len(members) == 2
                assigns = [
                    (m.member_id, b"part-%d" % i) for i, m in enumerate(members)
                ]
                a_leader, a_follower = await asyncio.gather(
                    leader.sync(assigns), follower.sync([])
                )
                assert {a_leader, a_follower} == {b"part-0", b"part-1"}
                # leaving triggers a rebalance for the survivor
                await follower.leave()
                code = await leader.heartbeat()
                assert code == int(ErrorCode.rebalance_in_progress)
                j3 = await leader.join(PROTO)
                assert j3.generation_id > j1.generation_id
                assert len(j3.members) == 1

    asyncio.run(run())


def test_offsets_survive_restart(tmp_path):
    async def run():
        from redpanda_tpu_torch.app import Broker, BrokerConfig
        from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork

        cfg = BrokerConfig(
            device="cpu",
            node_id=0,
            data_dir=str(tmp_path / "node0"),
            members=[0],
            election_timeout_s=0.15,
            heartbeat_interval_s=0.03,
        )
        b = Broker(cfg, loopback=LoopbackNetwork())
        await b.start()
        client = KafkaClient([b.kafka_advertised])
        await client.create_topic("t1", partitions=1)
        g = client.group("g4")
        await g.join(PROTO)
        await g.sync([(g.member_id, b"")])
        await g.commit_offsets({("t1", 0): 42})
        await client.close()
        await b.stop()

        b2 = Broker(cfg, loopback=LoopbackNetwork())
        await b2.start()
        try:
            client = KafkaClient([b2.kafka_advertised])
            g = client.group("g4")
            deadline = asyncio.get_event_loop().time() + 5
            while True:
                try:
                    got = await g.fetch_offsets({"t1": [0]})
                    break
                except KafkaClientError:
                    if asyncio.get_event_loop().time() > deadline:
                        raise
                    await asyncio.sleep(0.05)
            assert got == {("t1", 0): 42}
            await client.close()
        finally:
            await b2.stop()

    asyncio.run(run())


def test_session_expiration_evicts_member(tmp_path):
    async def run():
        async with broker_cluster(tmp_path, 1) as brokers:
            async with client_for(brokers) as client:
                g = client.group("g5")
                await g.join(PROTO, session_timeout_ms=600)
                await g.sync([(g.member_id, b"x")])
                # stop heartbeating; the expiration sweep evicts us
                await asyncio.sleep(1.5)
                code = await g.heartbeat()
                assert code == int(ErrorCode.unknown_member_id)

    asyncio.run(run())


def test_describe_and_list_and_delete_groups(tmp_path):
    async def run():
        from redpanda_tpu_torch.kafka.protocol.group_apis import (
            DELETE_GROUPS,
            DESCRIBE_GROUPS,
            LIST_GROUPS,
        )
        from redpanda_tpu_torch.kafka.protocol import Msg

        async with broker_cluster(tmp_path, 1) as brokers:
            async with client_for(brokers) as client:
                g = client.group("g6")
                await g.join(PROTO)
                await g.sync([(g.member_id, b"a0")])
                conn = await g.coordinator()
                desc = await conn.request(
                    DESCRIBE_GROUPS, Msg(groups=["g6"]), 1
                )
                d = desc.groups[0]
                assert d.group_state == "Stable"
                assert d.protocol_data == "range"
                assert len(d.members) == 1
                listed = await conn.request(LIST_GROUPS, Msg(), 1)
                assert "g6" in [x.group_id for x in listed.groups]
                # delete fails while non-empty, succeeds after leave
                res = await conn.request(
                    DELETE_GROUPS, Msg(groups_names=["g6"]), 1
                )
                assert res.results[0].error_code == int(
                    ErrorCode.non_empty_group
                )
                await g.leave()
                res = await conn.request(
                    DELETE_GROUPS, Msg(groups_names=["g6"]), 1
                )
                assert res.results[0].error_code == 0

    asyncio.run(run())


def test_delete_topic_via_api(tmp_path):
    async def run():
        async with broker_cluster(tmp_path, 1) as brokers:
            async with client_for(brokers) as client:
                await client.create_topic("doomed", partitions=1)
                await client.produce("doomed", 0, [(None, b"x")])
                await client.delete_topic("doomed")
                md = await client.metadata(["doomed"])
                assert md.topics[0].error_code == int(
                    ErrorCode.unknown_topic_or_partition
                )
                with pytest.raises(KafkaClientError):
                    await client.delete_topic("doomed")

    asyncio.run(run())


def test_group_coordinator_on_three_brokers(tmp_path):
    """Groups work when the coordinator partition lives on any broker;
    requests land on the right node via FindCoordinator routing."""

    async def run():
        async with broker_cluster(tmp_path, 3) as brokers:
            async with client_for(brokers) as client:
                await client.create_topic("t1", partitions=1, replication_factor=3)
                for i in range(4):  # several groups → several partitions
                    g = client.group(f"grp-{i}")
                    await g.join(PROTO)
                    await g.sync([(g.member_id, b"")])
                    await g.commit_offsets({("t1", 0): i * 10})
                    got = await g.fetch_offsets({"t1": [0]})
                    assert got == {("t1", 0): i * 10}

    asyncio.run(run())


def test_static_membership(tmp_path):
    """KIP-345: a restarting static member (same group.instance.id)
    takes over its slot without a rebalance; zombies with the old
    member id are fenced; admin removes static members by instance id."""

    async def run():
        async with broker_cluster(tmp_path, 1) as brokers:
            async with client_for(brokers) as c1, client_for(brokers) as c2:
                g1 = c1.group("sg")
                g2 = c2.group("sg")
                j1, j2 = await asyncio.gather(
                    g1.join(PROTO, group_instance_id="inst-a"),
                    g2.join(PROTO),
                )
                gen0 = j1.generation_id
                leader = g1 if j1.leader == j1.member_id else g2
                members = (j1 if leader is g1 else j2).members
                # instance id is visible in the leader's member list
                by_id = {m.member_id: m.group_instance_id for m in members}
                assert by_id[j1.member_id] == "inst-a"
                assigns = [
                    (m.member_id, b"assign-%d" % i)
                    for i, m in enumerate(members)
                ]
                follower = g2 if leader is g1 else g1
                a1, a2 = await asyncio.gather(
                    leader.sync(assigns), follower.sync([])
                )
                static_assignment = a1 if leader is g1 else a2
                old_static_id = g1.member_id

                # "restart" of the static member: fresh client, same
                # instance id, empty member id
                async with client_for(brokers) as c3:
                    g3 = c3.group("sg")
                    j3 = await g3.join(PROTO, group_instance_id="inst-a")
                    # same generation: NO rebalance happened
                    assert j3.generation_id == gen0
                    assert j3.member_id != old_static_id
                    # inherited assignment via sync
                    got = await g3.sync([])
                    assert got == static_assignment
                    # the dynamic member never saw a rebalance
                    assert await g2.heartbeat() == 0

                    # zombie (old member id) is FENCED on heartbeat and
                    # on join with the stale id
                    from redpanda_tpu_torch.kafka.protocol import Msg
                    from redpanda_tpu_torch.kafka.protocol.group_apis import (
                        HEARTBEAT,
                        JOIN_GROUP,
                    )

                    conn = await g1.coordinator()
                    resp = await conn.request(
                        HEARTBEAT,
                        Msg(
                            group_id="sg",
                            generation_id=gen0,
                            member_id=old_static_id,
                            group_instance_id="inst-a",
                        ),
                        3,
                    )
                    assert resp.error_code == int(
                        ErrorCode.fenced_instance_id
                    )
                    resp = await conn.request(
                        JOIN_GROUP,
                        Msg(
                            group_id="sg",
                            session_timeout_ms=10000,
                            rebalance_timeout_ms=10000,
                            member_id=old_static_id,
                            group_instance_id="inst-a",
                            protocol_type="consumer",
                            protocols=[
                                Msg(name=n, metadata=md) for n, md in PROTO
                            ],
                        ),
                        5,
                    )
                    assert resp.error_code == int(
                        ErrorCode.fenced_instance_id
                    )

                    # admin removal by instance id alone (LeaveGroup v4)
                    rows = await g2.remove_members([(None, "inst-a")])
                    assert rows[0].error_code == 0
                    # the survivor now rebalances into a new generation
                    code = await g2.heartbeat()
                    assert code == int(ErrorCode.rebalance_in_progress)
                    j4 = await g2.join(PROTO)
                    assert j4.generation_id > gen0
                    assert len(j4.members) == 1

    asyncio.run(run())


def test_static_membership_survives_coordinator_restart(tmp_path):
    """The instance-id registration is part of the replicated group
    metadata: after a broker restart (log replay), a static takeover
    still resolves and is still fenced correctly."""

    async def run():
        from redpanda_tpu_torch.app import Broker, BrokerConfig
        from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork

        cfg = lambda: BrokerConfig(
            device="cpu",
            node_id=0,
            data_dir=str(tmp_path / "n0"),
            members=[0],
            election_timeout_s=0.15,
            heartbeat_interval_s=0.03,
        )
        b = Broker(cfg(), loopback=LoopbackNetwork())
        await b.start()
        b.config.peer_kafka_addresses = {0: b.kafka_advertised}
        await b.wait_controller_leader()
        client = KafkaClient([b.kafka_advertised])
        g = client.group("sgr")
        await g.join(PROTO, group_instance_id="inst-p")
        await g.sync([(g.member_id, b"sticky")])
        await client.close()
        await b.stop()

        b2 = Broker(cfg(), loopback=LoopbackNetwork())
        await b2.start()
        b2.config.peer_kafka_addresses = {0: b2.kafka_advertised}
        await b2.wait_controller_leader()
        client2 = KafkaClient([b2.kafka_advertised])
        g2 = client2.group("sgr")
        j = await g2.join(PROTO, group_instance_id="inst-p")
        # static slot recovered from the replicated metadata: the
        # takeover inherits the checkpointed assignment
        got = await g2.sync([])
        assert got == b"sticky"
        await client2.close()
        await b2.stop()

    asyncio.run(run())


def test_offset_expiration_for_empty_group(tmp_path):
    """KIP-211: committed offsets of an EMPTY group expire after
    group_offset_retention_ms; a live group's offsets never do."""

    async def run():
        async with broker_cluster(tmp_path, 1) as brokers:
            b = brokers[0]
            async with client_for(brokers) as client:
                await client.create_topic("t", partitions=1)
                g = client.group("exp")
                await g.join(PROTO)
                await g.sync([(g.member_id, b"")])
                await g.commit_offsets({("t", 0): 42})
                # live group: offsets stay even with tiny retention
                b.controller.cluster_config.apply(
                    {"group_offset_retention_ms": "100"}, []
                )
                await asyncio.sleep(1.2)
                assert await g.fetch_offsets({"t": [0]}) == {("t", 0): 42}
                # empty group: retention clock starts at leave
                await g.leave()
                deadline = asyncio.get_event_loop().time() + 10.0
                gone = False
                while asyncio.get_event_loop().time() < deadline:
                    got = await g.fetch_offsets({"t": [0]})
                    if ("t", 0) not in got:
                        gone = True
                        break
                    await asyncio.sleep(0.2)
                assert gone, "offsets never expired"
                # the emptied group itself is garbage-collected
                coord = b.group_coordinator
                deadline = asyncio.get_event_loop().time() + 10.0
                while asyncio.get_event_loop().time() < deadline:
                    if all(
                        gg.group_id != "exp" for gg in coord.local_groups()
                    ):
                        break
                    await asyncio.sleep(0.2)
                assert all(
                    gg.group_id != "exp" for gg in coord.local_groups()
                ), "dead group never collected"

    asyncio.run(run())
