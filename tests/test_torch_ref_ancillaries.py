"""tests/test_ancillaries.py run on the port: all 8 cases, with imports
pointed at redpanda_tpu_torch. `broker_cluster` comes from
`test_torch_ref_kafka_e2e` (brokers on the CPU,
`BrokerConfig(device="cpu")`), and an autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
Nothing is left out.

syschecks, one-shot cluster migrations, stats reporter.

Reference models: src/v/syschecks + application.cc:357 crash-loop,
src/v/migrations (feature-driven one-shot migrators), and
cluster/metrics_reporter.cc.
"""

import asyncio
import json
import os
import urllib.request

import pytest

from redpanda_tpu_torch import syschecks

from test_torch_ref_kafka_e2e import broker_cluster
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


# ------------------------------------------------------------ syschecks
def test_fsync_probe_fatal_on_unwritable_dir(tmp_path):
    # a path under a regular FILE can never become a data dir (works
    # even as root, where permission bits don't bind)
    blocker = tmp_path / "blocker"
    blocker.write_text("x")
    with pytest.raises(RuntimeError, match="data dir"):
        syschecks.run_startup_checks(str(blocker / "data"))


def test_checks_pass_on_normal_dir(tmp_path):
    warnings = syschecks.run_startup_checks(str(tmp_path))
    assert isinstance(warnings, list)  # advisory only


def test_pidlock_mutual_exclusion(tmp_path):
    d = str(tmp_path)
    lock = syschecks.acquire_pidlock(d)
    with pytest.raises(RuntimeError, match="already in use"):
        syschecks.acquire_pidlock(d)
    lock.release()
    assert not os.path.exists(os.path.join(d, "pid.lock"))
    lock2 = syschecks.acquire_pidlock(d)  # re-acquirable after release
    lock2.release()


def test_version_gated_join_rejected(tmp_path):
    """A build below the active cluster version must be refused at
    join: it cannot replay feature-gated controller commands."""

    async def run():
        from redpanda_tpu_torch.cluster.commands import RegisterNodeCmd
        from redpanda_tpu_torch.cluster.controller import TopicError

        async with broker_cluster(tmp_path, 1) as brokers:
            c = brokers[0].controller
            await c.wait_leader()
            # wait for feature activation to lift the cluster version
            deadline = asyncio.get_event_loop().time() + 10
            while c.features.cluster_version < 3:
                assert asyncio.get_event_loop().time() < deadline
                await asyncio.sleep(0.05)
            with pytest.raises(TopicError, match="active cluster version"):
                await c.join_node_local(
                    RegisterNodeCmd(
                        node_id=9,
                        rpc_host="127.0.0.1",
                        rpc_port=1,
                        kafka_host="127.0.0.1",
                        kafka_port=1,
                        rack="",
                        logical_version=2,  # older build
                    )
                )

    asyncio.run(run())


def test_crash_loop_counting(tmp_path):
    d = str(tmp_path)
    assert syschecks.note_startup(d) == 0  # first start
    # "crash": no clean stop before the next start
    assert syschecks.note_startup(d) == 1
    assert syschecks.note_startup(d) == 2
    syschecks.note_clean_stop(d)
    assert syschecks.note_startup(d) == 0  # reset after clean shutdown


# ----------------------------------------------------------- migrations
async def _migration_once(tmp_path):
    from redpanda_tpu_torch.cluster import migrations as mig

    calls = []

    async def test_apply(controller):
        calls.append(controller.node_id)

    mig.register_migration("test_once", "migrations", test_apply)
    try:
        async with broker_cluster(tmp_path, 3) as brokers:
            # the feature activates once all members register at v3;
            # then the leader runs the migration and replicates done
            deadline = asyncio.get_event_loop().time() + 15
            while asyncio.get_event_loop().time() < deadline:
                if all(
                    "test_once" in b.controller.migrations_done
                    for b in brokers
                ):
                    break
                await asyncio.sleep(0.1)
            for b in brokers:
                assert "test_once" in b.controller.migrations_done, (
                    b.node_id,
                    b.controller.migrations_done,
                )
            assert len(calls) == 1, calls  # exactly one application
            # built-in migration completed too
            assert any(
                "offsets_topic_compaction" in b.controller.migrations_done
                for b in brokers
            )
            # several more controller passes: no re-run
            await asyncio.sleep(1.0)
            assert len(calls) == 1, calls
    finally:
        mig._REGISTRY[:] = [
            m for m in mig._REGISTRY if m.name != "test_once"
        ]


def test_migration_runs_once_cluster_wide(tmp_path):
    asyncio.run(_migration_once(tmp_path))


async def _offsets_backfill(tmp_path):
    from redpanda_tpu_torch.cluster.migrations import _offsets_topic_compaction
    from redpanda_tpu_torch.kafka.coordinator.group_manager import OFFSETS_TOPIC
    from redpanda_tpu_torch.models.fundamental import DEFAULT_NS, TopicNamespace

    async with broker_cluster(tmp_path, 1) as brokers:
        c = brokers[0].controller
        await c.wait_leader()
        # an offsets topic created WITHOUT compaction (old-cluster shape)
        await c.create_topic(OFFSETS_TOPIC, partitions=1, replication_factor=1)
        tp = TopicNamespace(DEFAULT_NS, OFFSETS_TOPIC)
        assert "compact" not in (c.topic_table.get(tp).config.get("cleanup.policy") or "")
        await _offsets_topic_compaction(c)
        deadline = asyncio.get_event_loop().time() + 5
        while asyncio.get_event_loop().time() < deadline:
            if "compact" in (
                c.topic_table.get(tp).config.get("cleanup.policy") or ""
            ):
                break
            await asyncio.sleep(0.05)
        assert "compact" in c.topic_table.get(tp).config.get("cleanup.policy")
        # idempotent: second run is a no-op (no error)
        await _offsets_topic_compaction(c)


def test_offsets_compaction_backfill(tmp_path):
    asyncio.run(_offsets_backfill(tmp_path))


# ------------------------------------------------------- stats reporter
async def _stats(tmp_path):
    async with broker_cluster(tmp_path, 1) as brokers:
        b = brokers[0]
        from redpanda_tpu_torch.kafka.client import KafkaClient

        c = KafkaClient([b.kafka_advertised])
        await c.create_topic("st", partitions=2, replication_factor=1)
        await c.produce("st", 0, [(b"k", b"v" * 100)])
        await c.close()
        loop = asyncio.get_event_loop()
        raw = await loop.run_in_executor(
            None,
            lambda: urllib.request.urlopen(
                f"http://127.0.0.1:{b.admin.port}/v1/cluster/stats", timeout=5
            ).read(),
        )
        stats = json.loads(raw)
        assert stats["node_id"] == 0
        assert stats["members"] == 1
        assert stats["topics"] >= 1
        assert stats["partitions"] >= 2
        assert stats["local_replicas"] >= 2
        assert stats["local_log_bytes"] > 0
        assert "migrations_done" in stats


def test_stats_endpoint(tmp_path):
    asyncio.run(_stats(tmp_path))
