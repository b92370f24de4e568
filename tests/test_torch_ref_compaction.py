"""tests/test_compaction.py run on the port: all 9 cases, with imports
pointed at redpanda_tpu_torch. The end-to-end broker is the port's on
the CPU (`BrokerConfig(device="cpu")`), and an autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
Nothing is left out.

Key-based log compaction.

Reference coverage model: storage/tests/compaction_e2e_test.cc,
log_compaction_test (segment_utils self-compaction + adjacent merge),
and rptest compacted-topic behavior (latest value per key survives,
offsets never renumber).
"""

import asyncio

from redpanda_tpu_torch.models import RecordBatchBuilder, RecordBatchType
from redpanda_tpu_torch.storage import Log, LogConfig
import pytest

from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


def kv_batch(pairs, ts=1_700_000_000_000, btype=RecordBatchType.raft_data):
    b = RecordBatchBuilder(btype, timestamp_ms=ts)
    for k, v in pairs:
        b.add(v, key=k)
    return b.build()


def log_records(log, start=0):
    out = []
    for batch in log.read(start, max_bytes=1 << 30):
        if batch.header.type != RecordBatchType.raft_data:
            continue
        base = batch.header.base_offset
        for r in batch.records():
            out.append((base + r.offset_delta, r.key, r.value))
    return out


def fill_segments(log, rounds=3, keys=("a", "b", "c")):
    """Append `rounds` passes over the same keys, rolling segments so
    older values land in closed segments."""
    for i in range(rounds):
        for k in keys:
            log.append(kv_batch([(k.encode(), f"v{i}-{k}".encode())]), term=1)
        log._active_segment(term=1)  # touch
        log.flush()
        # force a roll by pretending the segment is full
        log._segments[-1]._size = log.config.segment_max_bytes + 1


class TestCompaction:
    def test_latest_value_per_key_survives(self, tmp_path):
        log = Log(str(tmp_path / "l"), LogConfig(cleanup_policy="compact"))
        fill_segments(log, rounds=3)
        before = log_records(log)
        dirty = log.offsets().dirty_offset
        stats = log.compact(dirty)
        assert stats["records_removed"] > 0
        after = log_records(log)
        # survivors: exactly the latest offset per key (the final round)
        latest = {}
        for off, k, v in before:
            latest[k] = (off, v)
        assert sorted(after) == sorted(
            (off, k, v) for k, (off, v) in latest.items()
        )
        # offsets preserved, not renumbered
        for off, k, v in after:
            assert (off, k, v) in before

    def test_batch_placeholders_keep_log_contiguous(self, tmp_path):
        log = Log(str(tmp_path / "l"), LogConfig(cleanup_policy="compact"))
        fill_segments(log, rounds=2)
        dirty = log.offsets().dirty_offset
        log.compact(dirty)
        # every batch range is still present and contiguous
        batches = log.read(0, max_bytes=1 << 30)
        expect = 0
        for b in batches:
            assert b.header.base_offset == expect
            expect = b.header.last_offset + 1
        assert expect == dirty + 1
        # placeholder batches decode to zero records but keep offsets
        empties = [b for b in batches if b.header.record_count == 0]
        assert empties, "superseded batches should shrink to placeholders"
        for b in empties:
            assert b.records() == []

    def test_term_boundaries_stable_across_compaction(self, tmp_path):
        log = Log(str(tmp_path / "l"), LogConfig(cleanup_policy="compact"))
        for term in (1, 1, 2, 3):
            log.append(kv_batch([(b"k", b"v%d" % term)]), term=term)
            log.flush()
            log._segments[-1]._size = log.config.segment_max_bytes + 1
        bounds_before = log.term_boundaries()
        log.compact(log.offsets().dirty_offset)
        assert log.term_boundaries() == bounds_before
        assert log.get_term(0) == 1
        assert log.get_term(3) == 3

    def test_unkeyed_and_control_batches_preserved(self, tmp_path):
        log = Log(str(tmp_path / "l"), LogConfig(cleanup_policy="compact"))
        log.append(kv_batch([(None, b"unkeyed-1")]), term=1)
        log.append(kv_batch([(b"k", b"old")]), term=1)
        cfg = kv_batch(
            [(b"cfgkey", b"cfg")], btype=RecordBatchType.raft_configuration
        )
        log.append(cfg, term=1)
        log.flush()
        log._segments[-1]._size = log.config.segment_max_bytes + 1
        log.append(kv_batch([(b"k", b"new")]), term=1)
        log.flush()
        log._segments[-1]._size = log.config.segment_max_bytes + 1
        log.compact(log.offsets().dirty_offset)
        recs = log_records(log)
        assert (0, None, b"unkeyed-1") in recs
        assert (1, b"k", b"old") not in [r for r in recs]
        assert any(k == b"k" and v == b"new" for _o, k, v in recs)
        # the configuration batch is untouched
        cfg_batches = [
            b
            for b in log.read(0, max_bytes=1 << 30)
            if b.header.type == RecordBatchType.raft_configuration
        ]
        assert len(cfg_batches) == 1
        assert cfg_batches[0].header.record_count == 1

    def test_compaction_survives_reopen(self, tmp_path):
        path = str(tmp_path / "l")
        log = Log(path, LogConfig(cleanup_policy="compact"))
        fill_segments(log, rounds=3)
        dirty = log.offsets().dirty_offset
        log.compact(dirty)
        want = sorted(log_records(log))
        log.close()
        log2 = Log(path, LogConfig(cleanup_policy="compact"))
        assert log2.offsets().dirty_offset == dirty
        assert sorted(log_records(log2)) == want
        log2.close()

    def test_adjacent_merge_reduces_segment_count(self, tmp_path):
        log = Log(str(tmp_path / "l"), LogConfig(cleanup_policy="compact"))
        fill_segments(log, rounds=4, keys=("a",))
        n_before = log.segment_count()
        log.compact(log.offsets().dirty_offset)
        assert log.segment_count() < n_before
        # reads still serve the surviving record
        recs = log_records(log)
        assert [v for _o, k, v in recs if k == b"a"] == [b"v3-a"]

    def test_compaction_gated_on_boundary(self, tmp_path):
        """Records above max_offset neither supersede nor get removed:
        raft may still truncate that suffix, so deleting a committed
        value because an uncommitted newer one exists would lose the
        key if the suffix is truncated."""
        log = Log(str(tmp_path / "l"), LogConfig(cleanup_policy="compact"))
        fill_segments(log, rounds=3)
        # boundary below round 1: round-0 records are the LATEST
        # participating occurrence of each key — nothing may be removed
        boundary = 2  # offsets 0..2 are round 0
        stats = log.compact(boundary)
        assert stats["records_removed"] == 0
        recs = log_records(log)
        assert any(v.startswith(b"v0-") for _o, _k, v in recs)
        # boundary covering rounds 0+1: round-0 gone (superseded within
        # the boundary), round-1 and round-2 intact
        stats = log.compact(5)
        assert stats["records_removed"] == 3
        recs = log_records(log)
        assert not any(v.startswith(b"v0-") for _o, _k, v in recs)
        assert any(v.startswith(b"v1-") for _o, _k, v in recs)
        assert any(v.startswith(b"v2-") for _o, _k, v in recs)


class TestVisibilityPredicate:
    def test_invisible_records_neither_supersede_nor_vanish(self, tmp_path):
        """The partition passes a predicate rejecting aborted/undecided
        tx records: they must not supersede a committed value, and they
        must be preserved verbatim (fetch-side filtering owns them)."""
        log = Log(str(tmp_path / "l"), LogConfig(cleanup_policy="compact"))
        log.append(kv_batch([(b"k", b"committed-old")]), term=1)
        log.flush()
        log._segments[-1]._size = log.config.segment_max_bytes + 1
        log.append(kv_batch([(b"k", b"aborted-new")]), term=1)
        log.flush()
        log._segments[-1]._size = log.config.segment_max_bytes + 1
        log.append(kv_batch([(b"x", b"tail")]), term=1)
        log.flush()

        aborted_offset = 1

        def visible(batch, off):
            return off != aborted_offset

        log.compact(log.offsets().dirty_offset, visible=visible)
        recs = log_records(log)
        # the aborted record did NOT supersede the committed value
        assert (0, b"k", b"committed-old") in recs
        # and was itself preserved, not compacted away
        assert (1, b"k", b"aborted-new") in recs


class TestCompactedTopicE2E:
    def test_compacted_topic_end_to_end(self, tmp_path):
        asyncio.run(self._run(tmp_path))

    async def _run(self, tmp_path):
        from redpanda_tpu_torch.app import Broker, BrokerConfig
        from redpanda_tpu_torch.kafka.client import KafkaClient
        from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork

        net = LoopbackNetwork()
        b = Broker(
            BrokerConfig(
                node_id=0,
                data_dir=str(tmp_path / "n0"),
                members=[0],
                election_timeout_s=0.15,
                heartbeat_interval_s=0.03,
                housekeeping_interval_s=0,  # drive manually
                device="cpu",
            ),
            loopback=net,
        )
        await b.start()
        b.config.peer_kafka_addresses = {0: b.kafka_advertised}
        try:
            client = KafkaClient([b.kafka_advertised])
            await client.create_topic(
                "ct",
                partitions=1,
                replication_factor=1,
                configs={
                    "cleanup.policy": "compact",
                    "segment.bytes": "512",
                },
            )
            for i in range(6):
                await client.produce(
                    "ct", 0, [(b"key-%d" % (i % 2), b"val-%d" % i)]
                )
            # everything committed+flushed on a 1-node group
            from redpanda_tpu_torch.models.fundamental import kafka_ntp

            p = b.broker_partition = b.partition_manager.get(kafka_ntp("ct", 0))
            assert p.log.config.compaction_enabled
            assert p.log.segment_count() > 1
            p.log.flush()
            b.storage.log_mgr.housekeeping()
            # fetch from 0: latest value per key survives with original
            # (kafka-space) offsets
            got = await client.fetch("ct", 0, 0)
            by_key = {}
            for off, k, v in got:
                by_key[k] = (off, v)
            assert by_key[b"key-0"] == (4, b"val-4")
            assert by_key[b"key-1"] == (5, b"val-5")
            # altering cleanup.policy live rebinds the log config
            await client.alter_topic_configs("ct", {"cleanup.policy": "delete"})
            await asyncio.sleep(0.1)  # backend delta tick
            assert not p.log.config.compaction_enabled
            await client.close()
        finally:
            await b.stop()
