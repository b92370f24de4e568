"""tests/test_membership.py run on the port: all 8 test functions, with
imports pointed at redpanda_tpu_torch. Every broker is the port's on the
CPU (`BrokerConfig(device="cpu")`), and an autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
`cluster` and `http` come from `test_torch_ref_admin_server`. Nothing is
left out.


Dynamic membership, node liveness, and replica movement.

Reference test model: cluster/tests/members_manager_test.cc,
rptest/tests/nodes_decommissioning_test.py, node_status tests —
start a cluster, join a node through the controller, move replicas
onto it, kill a node, observe health.
"""

import asyncio
import contextlib

import pytest

from redpanda_tpu_torch.app import Broker, BrokerConfig
from redpanda_tpu_torch.kafka.client import KafkaClient
from redpanda_tpu_torch.models.fundamental import kafka_ntp
from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


@contextlib.asynccontextmanager
async def seed_cluster(tmp_path, n=3, **cfg_kw):
    net = LoopbackNetwork()
    members = list(range(n))
    brokers = [
        Broker(
            BrokerConfig(
                device="cpu",
                node_id=i,
                data_dir=str(tmp_path / f"node{i}"),
                members=members,
                election_timeout_s=0.15,
                heartbeat_interval_s=0.03,
                node_status_interval_s=0.1,
                **cfg_kw,
            ),
            loopback=net,
        )
        for i in members
    ]
    for b in brokers:
        await b.start()
    try:
        await brokers[0].wait_controller_leader()
        yield net, brokers
    finally:
        for b in brokers:
            await b.stop()


async def wait_until(pred, timeout=8.0, interval=0.05, msg="condition"):
    deadline = asyncio.get_event_loop().time() + timeout
    while True:
        if pred():
            return
        if asyncio.get_event_loop().time() > deadline:
            raise TimeoutError(f"timed out waiting for {msg}")
        await asyncio.sleep(interval)


async def _join_move_kill_health(tmp_path):
    async with seed_cluster(tmp_path, n=3) as (net, brokers):
        # every seed registers its endpoints through the controller log
        ctrl = brokers[0].controller
        await wait_until(
            lambda: len(ctrl.members_table.registered()) == 3,
            msg="seed registration",
        )

        # a topic on the seeds
        client = KafkaClient([brokers[0].kafka_advertised])
        await client.create_topic("mt", partitions=1, replication_factor=3)
        await client.produce("mt", 0, [(b"k", b"v0")])

        # ---- join a 4th broker (not in the seed set) ----
        joiner = Broker(
            BrokerConfig(
                device="cpu",
                node_id=3,
                data_dir=str(tmp_path / "node3"),
                members=[0, 1, 2],  # seeds only; self not included
                election_timeout_s=0.15,
                heartbeat_interval_s=0.03,
                node_status_interval_s=0.1,
            ),
            loopback=net,
        )
        await joiner.start()
        try:
            # registration replicates + raft0 voter set grows to 4
            await wait_until(
                lambda: 3 in ctrl.members_table.registered(),
                msg="joiner registered",
            )
            await wait_until(
                lambda: set(ctrl.consensus.config.voters) == {0, 1, 2, 3}
                and not ctrl.consensus.config.is_joint(),
                msg="joiner voted into raft0",
            )
            # the joiner converges the controller state (sees the topic)
            await wait_until(
                lambda: joiner.controller.topic_table.get(
                    kafka_ntp("mt", 0).tp_ns
                )
                is not None,
                msg="joiner topic table convergence",
            )

            # ---- move a replica onto the new node ----
            await ctrl.move_partition_replicas("mt", 0, [1, 2, 3])
            await wait_until(
                lambda: joiner.partition_manager.get(kafka_ntp("mt", 0))
                is not None,
                msg="joiner hosts the partition",
            )
            p3 = joiner.partition_manager.get(kafka_ntp("mt", 0))
            await wait_until(
                lambda: set(p3.consensus.config.voters) == {1, 2, 3}
                and not p3.consensus.config.is_joint(),
                msg="group reconfigured onto joiner",
            )
            # node 0 gives up its replica
            await wait_until(
                lambda: brokers[0].partition_manager.get(kafka_ntp("mt", 0))
                is None,
                msg="node 0 dropped the moved replica",
            )
            # data followed the move: the joiner catches up the log
            await wait_until(
                lambda: p3.high_watermark() >= 1,
                msg="joiner caught up data",
            )
            # produce again through the new replica set
            await client.produce("mt", 0, [(b"k", b"v1")])
            got = await client.fetch("mt", 0, 0)
            assert [v for _o, _k, v in got] == [b"v0", b"v1"]

            # ---- kill a broker; health reports it down ----
            victim = brokers[2]
            net.isolate(victim.node_id)
            await wait_until(
                lambda: not brokers[0].node_status.is_alive(victim.node_id),
                msg="liveness detects the dead node",
            )
            report = brokers[0].health_monitor.report()
            assert victim.node_id in report.nodes_down
            alive_ids = {
                n.node_id for n in report.nodes if n.is_alive
            }
            assert alive_ids == {0, 1, 3}
            net.heal(victim.node_id)
            await wait_until(
                lambda: brokers[0].node_status.is_alive(victim.node_id),
                msg="liveness recovers after heal",
            )
        finally:
            await joiner.stop()
        await client.close()


def test_join_move_kill_health(tmp_path):
    asyncio.run(_join_move_kill_health(tmp_path))


async def _decommission_drains_replicas(tmp_path):
    async with seed_cluster(tmp_path, n=3) as (net, brokers):
        ctrl = brokers[0].controller
        await wait_until(
            lambda: len(ctrl.members_table.registered()) == 3,
            msg="seed registration",
        )
        client = KafkaClient([brokers[0].kafka_advertised])
        await client.create_topic("dt", partitions=2, replication_factor=1)
        await client.produce("dt", 0, [(b"a", b"1")])
        await client.produce("dt", 1, [(b"b", b"2")])

        # join a 4th node to receive the drained replicas
        joiner = Broker(
            BrokerConfig(
                device="cpu",
                node_id=3,
                data_dir=str(tmp_path / "node3"),
                members=[0, 1, 2],
                election_timeout_s=0.15,
                heartbeat_interval_s=0.03,
                node_status_interval_s=0.1,
            ),
            loopback=net,
        )
        await joiner.start()
        try:
            await wait_until(
                lambda: 3 in ctrl.members_table.registered(),
                msg="joiner registered",
            )
            # decommission a node that hosts at least one replica
            hosted = {
                nid: [
                    a
                    for md in ctrl.topic_table.topics().values()
                    for a in md.assignments.values()
                    if nid in a.replicas
                ]
                for nid in (0, 1, 2)
            }
            victim = next(nid for nid, parts in hosted.items() if parts)
            await ctrl.decommission_node(victim)
            assert ctrl.members_table.is_draining(victim)

            def drained():
                for md in ctrl.topic_table.topics().values():
                    for a in md.assignments.values():
                        if victim in a.replicas:
                            return False
                return True

            await wait_until(drained, timeout=15.0, msg="drain moves replicas off")
            # data survived the moves
            got0 = await client.fetch("dt", 0, 0)
            got1 = await client.fetch("dt", 1, 0)
            assert [v for _o, _k, v in got0] == [b"1"]
            assert [v for _o, _k, v in got1] == [b"2"]
        finally:
            await joiner.stop()
        await client.close()


def test_decommission_drains_replicas(tmp_path):
    asyncio.run(_decommission_drains_replicas(tmp_path))


def test_rack_aware_allocation():
    """Replicas spread across racks when labels exist; capacity still
    wins when a rack-diverse placement is impossible."""
    from redpanda_tpu_torch.cluster.allocator import PartitionAllocator

    a = PartitionAllocator()
    for nid, rack in ((0, "a"), (1, "a"), (2, "b"), (3, "b"), (4, "c")):
        a.register_node(nid, rack=rack)
    out = a.allocate(6, 3, next_group=1)
    racks = {0: "a", 1: "a", 2: "b", 3: "b", 4: "c"}
    for assign in out:
        assert len({racks[r] for r in assign.replicas}) == 3, assign.replicas
    # RF larger than rack count: still allocates (soft constraint)
    b = PartitionAllocator()
    for nid, rack in ((0, "a"), (1, "a"), (2, "b")):
        b.register_node(nid, rack=rack)
    out = b.allocate(2, 3, next_group=1)
    for assign in out:
        assert sorted(assign.replicas) == [0, 1, 2]


async def _leader_balancer(tmp_path):
    """All leaderships forced onto one node; the balancer spreads them
    back out (leader_balancer.cc greedy transfers)."""
    async with seed_cluster(tmp_path, n=3) as (net, brokers):
        # the test drives balance passes explicitly: keep the
        # background timer from undoing the forced skew mid-setup
        for b in brokers:
            b.controller.leader_balancer_enabled = False
        client = KafkaClient([brokers[0].kafka_advertised])
        await client.create_topic("lb", partitions=6, replication_factor=3)

        # wait until every partition has a leader, then force them all
        # onto node 0
        def leaders():
            out = {}
            for pid in range(6):
                ntp = kafka_ntp("lb", pid)
                lid = brokers[0].metadata_cache.leader_of(ntp)
                if lid is None:
                    return None
                out[pid] = lid
            return out

        await wait_until(lambda: leaders() is not None, msg="all leaders")
        for pid in range(6):
            ntp = kafka_ntp("lb", pid)
            for b in brokers:
                p = b.partition_manager.get(ntp)
                if p is not None and p.is_leader and b.node_id != 0:
                    try:
                        await p.consensus.transfer_leadership(0)
                    except Exception:
                        pass
        await wait_until(
            lambda: (lm := leaders()) is not None
            and sum(1 for v in lm.values() if v == 0) >= 5,
            msg="leadership skewed onto node 0",
        )

        # the controller leader's balance passes spread leadership out
        await wait_until(
            lambda: any(b.controller.is_leader for b in brokers),
            msg="controller leader",
        )
        ctrl = next(b.controller for b in brokers if b.controller.is_leader)
        ctrl.leader_balancer_enabled = True

        async def balanced():
            for _ in range(20):
                await ctrl._leader_balance_pass()
                # production paces passes ~5s apart; here just outwait
                # the leadership-dissemination gossip between moves
                await asyncio.sleep(0.5)
                lm = leaders()
                if lm is not None:
                    counts = {}
                    for v in lm.values():
                        counts[v] = counts.get(v, 0) + 1
                    if counts and max(counts.values()) - min(
                        counts.get(n, 0) for n in (0, 1, 2)
                    ) <= 1:
                        return True
            return False

        assert await balanced(), leaders()
        await client.close()


def test_leader_balancer(tmp_path):
    asyncio.run(_leader_balancer(tmp_path))


async def _partition_balancer(tmp_path):
    """A freshly joined empty node pulls replicas automatically
    (partition_balancer_backend.cc count-based rebalancing)."""
    async with seed_cluster(tmp_path, n=3) as (net, brokers):
        ctrl = brokers[0].controller
        await wait_until(
            lambda: len(ctrl.members_table.registered()) == 3,
            msg="seed registration",
        )
        client = KafkaClient([brokers[0].kafka_advertised])
        await client.create_topic("pb", partitions=6, replication_factor=1)
        for pid in range(6):
            await client.produce("pb", pid, [(b"k", b"v%d" % pid)])

        joiner = Broker(
            BrokerConfig(
                device="cpu",
                node_id=3,
                data_dir=str(tmp_path / "node3"),
                members=[0, 1, 2],
                election_timeout_s=0.15,
                heartbeat_interval_s=0.03,
                node_status_interval_s=0.1,
            ),
            loopback=net,
        )
        await joiner.start()
        try:
            await wait_until(
                lambda: 3 in ctrl.members_table.registered(),
                msg="joiner registered",
            )

            def replica_counts():
                counts = {n: 0 for n in (0, 1, 2, 3)}
                for md in ctrl.topic_table.topics().values():
                    for a in md.assignments.values():
                        for r in a.replicas:
                            counts[r] = counts.get(r, 0) + 1
                return counts

            # the background balancer (one move per ~5 idle seconds)
            # pulls replicas onto the empty joiner; drive passes
            # directly to keep the test fast
            leader_ctrl = None

            async def converged():
                nonlocal leader_ctrl
                for _ in range(40):
                    leader_ctrl = next(
                        (
                            b.controller
                            for b in brokers + [joiner]
                            if b.controller.is_leader
                        ),
                        None,
                    )
                    if leader_ctrl is not None:
                        await leader_ctrl._partition_balance_pass()
                    await asyncio.sleep(0.3)
                    c = replica_counts()
                    if max(c.values()) - min(c.values()) <= 1:
                        return True
                return False

            assert await converged(), replica_counts()
            # data survived every move
            for pid in range(6):
                got = await client.fetch("pb", pid, 0)
                assert [(k, v) for _o, k, v in got] == [(b"k", b"v%d" % pid)]
        finally:
            await joiner.stop()
        await client.close()


def test_partition_balancer(tmp_path):
    asyncio.run(_partition_balancer(tmp_path))


def test_maintenance_mode_drains_leadership_keeps_replicas(tmp_path):
    """Maintenance mode (ref drain_manager.cc + maintenance_mode_cmd):
    leaderships transfer away and the balancer mutes the node, but its
    replicas stay; disabling restores normal placement."""
    import asyncio

    from test_torch_ref_admin_server import cluster, http

    async def main():
        async with cluster(tmp_path, n=3) as brokers:
            from redpanda_tpu_torch.cluster.members import MembershipState
            from redpanda_tpu_torch.kafka.client import KafkaClient
            from redpanda_tpu_torch.models.fundamental import kafka_ntp

            client = KafkaClient([b.kafka_advertised for b in brokers])
            await client.create_topic("mt", partitions=6,
                                      replication_factor=3)
            # every partition elects a leader
            ntps = [kafka_ntp("mt", p) for p in range(6)]

            def leaders():
                out = {}
                for ntp in ntps:
                    for b in brokers:
                        part = b.partition_manager.get(ntp)
                        if part is not None and part.is_leader:
                            out[ntp] = b.node_id
                return out

            deadline = asyncio.get_event_loop().time() + 15
            while len(leaders()) < 6:
                assert asyncio.get_event_loop().time() < deadline
                await asyncio.sleep(0.1)

            # pick a node that leads something; put it in maintenance
            victim = next(iter(leaders().values()))
            # self-registration is async at startup: wait for the
            # victim's RegisterNodeCmd to commit before flipping state
            deadline = asyncio.get_event_loop().time() + 15
            while brokers[0].controller.members_table.get(victim) is None:
                assert asyncio.get_event_loop().time() < deadline
                await asyncio.sleep(0.1)
            st, _ = await http(
                brokers[0].admin.address, "PUT",
                f"/v1/brokers/{victim}/maintenance",
            )
            assert st in (200, 204)
            # replicated state converges + leaderships drain off
            deadline = asyncio.get_event_loop().time() + 30
            while True:
                led = leaders()
                state_ok = all(
                    b.controller.members_table.get(victim).state
                    == MembershipState.maintenance
                    for b in brokers
                )
                if (
                    state_ok
                    and len(led) == 6
                    and victim not in led.values()
                ):
                    break
                assert asyncio.get_event_loop().time() < deadline, (
                    f"leaderships never drained: {led}"
                )
                await asyncio.sleep(0.2)
            # replicas STAYED on the victim (no data movement)
            assert all(
                brokers[victim].partition_manager.get(ntp) is not None
                for ntp in ntps
            )
            # writes keep flowing during maintenance
            await client.produce("mt", 0, [(b"k", b"v")])
            # status surfaces on the brokers endpoint
            st, body = await http(brokers[0].admin.address, "GET", "/v1/brokers")
            row = next(
                r for r in body["brokers"] if r["node_id"] == victim
            )
            assert row["membership_status"] == "maintenance"

            # disable: node becomes eligible again
            st, _ = await http(
                brokers[0].admin.address, "DELETE",
                f"/v1/brokers/{victim}/maintenance",
            )
            assert st in (200, 204)
            deadline = asyncio.get_event_loop().time() + 15
            while (
                brokers[0].controller.members_table.get(victim).state
                != MembershipState.active
            ):
                assert asyncio.get_event_loop().time() < deadline
                await asyncio.sleep(0.1)
            await client.close()

    asyncio.run(main())


def test_maintenance_guards(tmp_path):
    """STM-side invariants: maintenance never overwrites a decommission,
    recommission never clears maintenance, and topic creation falls
    back to soft-muting when RF needs every node."""
    import asyncio

    from test_torch_ref_admin_server import cluster

    async def main():
        async with cluster(tmp_path, n=3) as brokers:
            c0 = brokers[0].controller
            deadline = asyncio.get_event_loop().time() + 15
            while any(
                c0.members_table.get(n) is None for n in (0, 1, 2)
            ):
                assert asyncio.get_event_loop().time() < deadline
                await asyncio.sleep(0.1)
            from redpanda_tpu_torch.cluster.members import MembershipState

            # RF == cluster size still creatable during maintenance
            await c0.set_maintenance(2, True)
            await _wait_state(brokers, 2, MembershipState.maintenance)
            await c0.create_topic("soft", partitions=1, replication_factor=3)
            md = c0.topic_table.get(
                __import__("redpanda_tpu_torch.models.fundamental",
                           fromlist=["TopicNamespace"]).TopicNamespace(
                    "kafka", "soft"
                )
            )
            assert md is not None and len(md.assignments[0].replicas) == 3

            # recommission must NOT clear maintenance
            await c0.recommission_node(2)
            await asyncio.sleep(0.3)
            assert (
                c0.members_table.get(2).state == MembershipState.maintenance
            )
            await c0.set_maintenance(2, False)
            await _wait_state(brokers, 2, MembershipState.active)

            # maintenance must NOT overwrite draining
            await c0.decommission_node(2)
            await _wait_state(brokers, 2, MembershipState.draining)
            # route the enable through a FOLLOWER view (the stale-view
            # race the STM guard closes)
            try:
                await brokers[1].controller.set_maintenance(2, True)
            except Exception:
                pass
            await asyncio.sleep(0.3)
            assert (
                c0.members_table.get(2).state == MembershipState.draining
            )

    async def _wait_state(brokers, nid, state):
        import asyncio

        deadline = asyncio.get_event_loop().time() + 15
        while brokers[0].controller.members_table.get(nid).state != state:
            assert asyncio.get_event_loop().time() < deadline
            await asyncio.sleep(0.1)

    asyncio.run(main())


async def _cluster_bootstrap(tmp_path):
    """Cluster genesis (bootstrap_backend/cluster_discovery): the first
    leader replicates a cluster UUID exactly once; every member
    converges on it; node-id reservations are idempotent and survive
    controller snapshots; wrong-UUID joins are rejected."""
    from redpanda_tpu_torch.cluster.commands import RegisterNodeCmd
    from redpanda_tpu_torch.cluster.controller import TopicError, discover_node_id
    from redpanda_tpu_torch.cluster.features import LATEST_LOGICAL_VERSION

    async with seed_cluster(tmp_path, n=3) as (net, brokers):
        # genesis: all nodes converge on ONE non-empty uuid
        await wait_until(
            lambda: all(b.controller.cluster_uuid for b in brokers),
            msg="cluster uuid replicated",
        )
        uuids = {b.controller.cluster_uuid for b in brokers}
        assert len(uuids) == 1
        (uuid,) = uuids
        assert len(uuid) == 32

        # id discovery through any node (routed to the leader by retry)
        send = brokers[0].send_rpc
        nid_a = await discover_node_id(send, [0, 1, 2], "uuid-aaa")
        nid_b = await discover_node_id(send, [0, 1, 2], "uuid-bbb")
        assert nid_a != nid_b
        assert nid_a not in (0, 1, 2) and nid_b not in (0, 1, 2)
        # retry with the same node uuid: same reservation
        assert await discover_node_id(send, [0, 1, 2], "uuid-aaa") == nid_a

        # wrong-cluster join rejected
        leader = next(b for b in brokers if b.controller.is_leader)
        cmd = RegisterNodeCmd(
            node_id=99,
            rpc_host="h", rpc_port=1, kafka_host="h", kafka_port=2,
            rack="", logical_version=LATEST_LOGICAL_VERSION,
            cluster_uuid="f" * 32,
        )
        try:
            await leader.controller.join_node_local(cmd)
            raise AssertionError("wrong-uuid join was accepted")
        except TopicError as e:
            assert e.code == "invalid_cluster"

        # matching uuid joins fine
        cmd2 = RegisterNodeCmd(
            node_id=7,
            rpc_host="h", rpc_port=1, kafka_host="h", kafka_port=2,
            rack="", logical_version=LATEST_LOGICAL_VERSION,
            cluster_uuid=uuid,
        )
        await leader.controller.join_node_local(cmd2)
        assert 7 in leader.controller.members

        # snapshot round-trip carries genesis state
        from redpanda_tpu_torch.cluster.controller_snapshot import (
            ControllerSnapshotter,
        )

        snapper = ControllerSnapshotter(leader.controller)
        blob = snapper.capture_snapshot(
            leader.controller.consensus.commit_index
        )
        other = brokers[1] if brokers[1] is not leader else brokers[2]
        # decode-only check against the envelope (restore on a live
        # controller is exercised by the controller-snapshot suite)
        from redpanda_tpu_torch.cluster.controller_snapshot import (
            ControllerSnapshotE,
        )

        snap = ControllerSnapshotE.decode(blob)
        assert str(snap.cluster_uuid) == uuid
        m = {str(k): int(v) for k, v in dict(snap.node_uuid_map).items()}
        assert m["uuid-aaa"] == nid_a and m["uuid-bbb"] == nid_b


def test_cluster_bootstrap(tmp_path):
    asyncio.run(_cluster_bootstrap(tmp_path))
