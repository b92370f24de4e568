"""tests/test_controller_snapshot.py run on the port: all 2 cases, with
imports pointed at redpanda_tpu_torch. Brokers run on the CPU
(`BrokerConfig(device="cpu")`). An autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu" (the
kernels' plain versions). Nothing is left out.

Controller snapshot: bounded raft0 replay across restarts.

Reference: src/v/cluster/controller_snapshot.h:211 (the table-aggregate
snapshot) and controller_stm.h's maybe_write_snapshot — without it the
controller log replays from genesis every boot and grows unboundedly.
"""

import asyncio

import pytest

from redpanda_tpu_torch.app import Broker, BrokerConfig
from redpanda_tpu_torch.cluster.controller import Controller
from redpanda_tpu_torch.kafka.client import KafkaClient
from redpanda_tpu_torch.models.fundamental import TopicNamespace
from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork
from redpanda_tpu_torch.security import scram
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


def _broker(tmp_path, net):
    return Broker(
        BrokerConfig(
            device="cpu",
            node_id=0,
            data_dir=str(tmp_path / "node0"),
            members=[0],
            election_timeout_s=0.15,
            heartbeat_interval_s=0.03,
        ),
        loopback=net,
    )


def _table_fingerprint(c: Controller) -> dict:
    """Everything the snapshot claims to carry, in comparable form."""
    topics = {
        (tp.ns, tp.topic): (
            md.partition_count,
            md.replication_factor,
            sorted(
                (a.partition, a.group, tuple(a.replicas))
                for a in md.assignments.values()
            ),
            tuple(sorted((k, v) for k, v in md.config.items())),
        )
        for tp, md in c.topic_table.topics().items()
    }
    return {
        "topics": topics,
        "next_group": c.topic_table.next_group_id,
        "users": {
            u: sorted(c.credentials._users[u]) for u in c.credentials.users()
        },
        "acls": sorted(
            (b.principal, b.resource_name, int(b.operation))
            for b in c.acls.all()
        ),
        "config": c.cluster_config.raw_overrides(),
        "members": sorted(
            (e.node_id, e.rack, e.state.value)
            for e in c.members_table.registered().values()
        ),
        "features": dict(c.features._state),
        "migrations": sorted(c.migrations_done),
    }


async def _apply_commands(b: Broker, start: int, n_topics: int) -> None:
    c = b.controller
    for i in range(start, start + n_topics):
        await c.create_topic(f"t{i}", partitions=1, replication_factor=1)
    # churn beyond creates: deletes re-apply on replay too
    for i in range(start, start + n_topics, 3):
        await c.delete_topic(f"t{i}")


def test_controller_snapshot_bounded_replay(tmp_path, monkeypatch):
    """~hundreds of controller commands, snapshot kicks in, restart
    proves (a) raft0 prefix-truncated, (b) bounded replay, (c) tables
    identical, (d) the controller still accepts commands."""
    monkeypatch.setattr(Controller, "SNAPSHOT_MAX_REPLAY", 64)

    async def main():
        net = LoopbackNetwork()
        b = _broker(tmp_path, net)
        await b.start()
        try:
            c = b.controller
            await _apply_commands(b, 0, 60)
            await c.create_user(
                "alice", scram.encode_credential(
                    scram.make_credential("pw", "SCRAM-SHA-256")
                )
            )
            from redpanda_tpu_torch.security.acl import (
                AclBinding,
                AclOperation,
                AclPatternType,
                AclPermission,
                AclResourceType,
            )

            await c.create_acls([
                AclBinding(
                    resource_type=AclResourceType.topic,
                    pattern_type=AclPatternType.literal,
                    resource_name="t1",
                    principal="User:alice",
                    host="*",
                    operation=AclOperation.read,
                    permission=AclPermission.allow,
                )
            ])
            await c.set_cluster_config(
                {"default_topic_retention_ms": "77777"}, []
            )
            # drive past the threshold so the housekeeping pass fires
            await _apply_commands(b, 100, 40)
            deadline = asyncio.get_event_loop().time() + 20.0
            while c.consensus._snap_index < 0:
                if asyncio.get_event_loop().time() > deadline:
                    raise TimeoutError("controller never snapshotted")
                await asyncio.sleep(0.1)
            snap_idx = c.consensus._snap_index
            log_start = c.consensus.log.offsets().start_offset
            assert log_start > 0, "raft0 was not prefix-truncated"
            assert log_start == snap_idx + 1
            fp_before = _table_fingerprint(c)
            applied_before = c.stm.last_applied
        finally:
            await b.stop()

        # ---- restart: replay must begin at the snapshot, not genesis
        net2 = LoopbackNetwork()
        b2 = _broker(tmp_path, net2)
        await b2.start()
        try:
            c2 = b2.controller
            await b2.wait_controller_leader()
            # bounded replay: the STM began at the snapshot boundary
            assert c2.consensus._snap_index >= snap_idx
            assert c2.stm.last_applied >= c2.consensus._snap_index
            assert c2.consensus.log.offsets().start_offset > 0
            # tables converge to the pre-restart state
            deadline = asyncio.get_event_loop().time() + 20.0
            while c2.stm.last_applied < applied_before:
                if asyncio.get_event_loop().time() > deadline:
                    raise TimeoutError("stm never caught up")
                await asyncio.sleep(0.05)
            assert _table_fingerprint(c2) == fp_before
            # restored topics materialize LOCAL PARTITIONS, not just
            # table rows (restore re-emits reconciliation deltas — the
            # backend is edge-driven and never saw the create commands)
            from redpanda_tpu_torch.models.fundamental import NTP

            survivor = next(
                tp.topic
                for tp in c2.topic_table.topics()
                if tp.topic.startswith("t")
            )
            deadline = asyncio.get_event_loop().time() + 20.0
            while b2.partition_manager.get(
                NTP("kafka", survivor, 0)
            ) is None:
                if asyncio.get_event_loop().time() > deadline:
                    raise TimeoutError(
                        f"partition for restored topic {survivor} "
                        "never materialized"
                    )
                await asyncio.sleep(0.05)
            # still a functional controller
            await c2.create_topic("after-restart", partitions=1,
                                  replication_factor=1)
            assert c2.topic_table.get(
                TopicNamespace("kafka", "after-restart")
            ) is not None
        finally:
            await b2.stop()

    asyncio.run(main())


def test_snapshot_capture_restore_roundtrip(tmp_path):
    """Pure capture→restore: a second controller hydrated from the
    blob reports identical tables (no raft involved)."""

    async def main():
        net = LoopbackNetwork()
        b = _broker(tmp_path, net)
        await b.start()
        try:
            c = b.controller
            await _apply_commands(b, 0, 10)
            await c.set_cluster_config({"fetch_max_wait_cap_ms": "444"}, [])
            blob = c._snapshotter.capture_snapshot(c.stm.last_applied)
            fp = _table_fingerprint(c)

            # hydrate a fresh broker's controller from the blob alone
            net2 = LoopbackNetwork()
            b2 = _broker(tmp_path / "other", net2)
            await b2.start()
            try:
                c2 = b2.controller
                c2._snapshotter.restore_snapshot(blob, 1000)
                fp2 = _table_fingerprint(c2)
                # node registration state may differ (b2 self-registered
                # commands replayed after restore); compare the
                # snapshot-carried stores
                for key in ("topics", "next_group", "users", "acls",
                            "config", "features", "migrations"):
                    assert fp2[key] == fp[key], key
            finally:
                await b2.stop()
        finally:
            await b.stop()

    asyncio.run(main())
