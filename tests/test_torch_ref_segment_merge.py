"""tests/test_segment_merge.py run on the port: all 5 cases, with imports
pointed at redpanda_tpu_torch. Every broker is the port's on the CPU
(`BrokerConfig(device="cpu")`), and an autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
Nothing is left out.

Archival housekeeping: adjacent segment merging.

Reference behaviors: archival/adjacent_segment_merger.cc (select runs
of small adjacent archived segments), segment_reupload.cc (reupload as
one object, replace manifest entries), and the upload-before-publish
ordering invariant (merged object PUT before the manifest references
it; old objects deleted only after the manifest stops referencing
them).
"""

import asyncio

from redpanda_tpu_torch.app import Broker, BrokerConfig
from redpanda_tpu_torch.cloud.manifest import PartitionManifest, SegmentMeta
from redpanda_tpu_torch.cloud.object_store import MemoryObjectStore
from redpanda_tpu_torch.cluster import archival_stm
from redpanda_tpu_torch.kafka.client import KafkaClient
from redpanda_tpu_torch.models.fundamental import kafka_ntp
from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork
import pytest

from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


# -- stm REPLACE unit --------------------------------------------------


def _meta(base, last, term=1, size=100, name_hint=""):
    return SegmentMeta(
        base_offset=base,
        last_offset=last,
        term=term,
        size_bytes=size,
        base_timestamp=-1,
        max_timestamp=0,
        delta_offset=0,
        delta_offset_end=0,
        name_hint=name_hint,
    )


def test_replace_exact_run():
    st = archival_stm.ArchivalState()
    for b, l in [(0, 4), (5, 9), (10, 14), (15, 19)]:
        st._apply(archival_stm.ADD_SEGMENT, _meta(b, l).encode())
    merged = _meta(5, 14, size=200, name_hint="5-14-1.m.seg")
    st._apply(archival_stm.REPLACE, merged.encode())
    assert [(int(s.base_offset), int(s.last_offset)) for s in st.segments] == [
        (0, 4),
        (5, 14),
        (15, 19),
    ]
    assert st.segments[1].name == "5-14-1.m.seg"
    # replay is a no-op (idempotent)
    rev = st.revision
    st._apply(archival_stm.REPLACE, merged.encode())
    assert st.revision == rev


def test_replace_misaligned_range_ignored():
    st = archival_stm.ArchivalState()
    for b, l in [(0, 4), (5, 9), (10, 14)]:
        st._apply(archival_stm.ADD_SEGMENT, _meta(b, l).encode())
    rev = st.revision
    # range ends mid-segment: must not apply
    st._apply(archival_stm.REPLACE, _meta(5, 12).encode())
    assert len(st.segments) == 3 and st.revision == rev
    # range starting at a non-boundary: must not apply
    st._apply(archival_stm.REPLACE, _meta(7, 14).encode())
    assert len(st.segments) == 3 and st.revision == rev


def test_segment_meta_name_hint_wire_evolution():
    """A GENUINE pre-name_hint blob (v1: envelope ends before the
    field) decodes with the default filled — the rolling-upgrade
    guarantee for manifests already written by older brokers."""
    import struct

    m = _meta(10, 19, term=3)
    raw = bytearray(m.encode())
    ver, compat, size = struct.unpack("<BBI", raw[:6])
    # strip the trailing v3 size_compressed (i64) and the empty-string
    # name_hint (4-byte length prefix), rewriting the envelope header
    # to the v1 layout
    v1 = struct.pack("<BBI", 1, compat, size - 12) + bytes(raw[6:-12])
    back = SegmentMeta.decode(v1)
    assert back.name_hint == ""
    assert back.name == "10-3.seg"
    assert int(back.last_offset) == 19
    # a v2 blob (name_hint present, no size_compressed) decodes with
    # the verbatim-stored default
    v2 = struct.pack("<BBI", 2, compat, size - 8) + bytes(raw[6:-8])
    back2 = SegmentMeta.decode(v2)
    assert int(back2.size_compressed) == 0
    assert back2.name == "10-3.seg"
    hinted = _meta(10, 19, term=3, name_hint="x.m.seg")
    assert SegmentMeta.decode(hinted.encode()).name == "x.m.seg"


# -- broker e2e --------------------------------------------------------


async def _merge_e2e(tmp_path):
    store = MemoryObjectStore()
    net = LoopbackNetwork()
    b = Broker(
        BrokerConfig(
            node_id=0,
            data_dir=str(tmp_path / "n0"),
            members=[0],
            election_timeout_s=0.15,
            heartbeat_interval_s=0.03,
            housekeeping_interval_s=0,
            archival_interval_s=0,
            cloud_storage_segment_merge_min_bytes=64 << 10,
            cloud_storage_segment_merge_target_bytes=1 << 20,
            device="cpu",
        ),
        loopback=net,
        object_store=store,
    )
    await b.start()
    b.config.peer_kafka_addresses = {0: b.kafka_advertised}
    try:
        await b.wait_controller_leader()
        client = KafkaClient([b.kafka_advertised])
        await client.create_topic(
            "mt",
            partitions=1,
            replication_factor=1,
            configs={
                "redpanda.remote.write": "true",
                "redpanda.remote.read": "true",
                "segment.bytes": "600",
                "retention.bytes": "600",
            },
        )
        for i in range(40):
            await client.produce("mt", 0, [(b"k%d" % i, b"v%d" % i)])
        p = b.partition_manager.get(kafka_ntp("mt", 0))
        p.log.flush()
        b.archival.merge_min_bytes = 0  # uploads only, no merging yet
        await b.archival.run_once()
        b.archival.merge_min_bytes = 64 << 10
        m0 = p.archiver.manifest
        n_before = len(m0.segments)
        assert n_before >= 3, "need several small archived segments"
        keys_before = {m0.segment_key(s) for s in m0.segments}

        # merging compacts runs of tiny segments across passes
        for _ in range(8):
            await b.archival.run_once()
            if b.archival.merges and len(p.archiver.manifest.segments) == 1:
                break
        m1 = p.archiver.manifest
        assert b.archival.merges >= 1
        assert len(m1.segments) < n_before
        merged_names = [s.name for s in m1.segments if s.name_hint]
        assert merged_names, "no merged segment in manifest"

        # every referenced object exists; replaced objects are deleted
        for s in m1.segments:
            assert await store.exists(m1.segment_key(s))
        live = {m1.segment_key(s) for s in m1.segments}
        for k in keys_before - live:
            assert not await store.exists(k), f"replaced object {k} leaked"

        # store manifest.bin converged to the replicated view
        exported = PartitionManifest.decode(
            await store.get(p.archiver._manifest_key())
        )
        assert [s.name for s in exported.segments] == [
            s.name for s in m1.segments
        ]

        # remote reads over the merged object return the full history
        b.storage.log_mgr.housekeeping()
        assert p.log.offsets().start_offset > 0, "local prefix not trimmed"
        got = await client.fetch("mt", 0, 0, max_bytes=1 << 24)
        assert [(k, v) for _o, k, v in got] == [
            (b"k%d" % i, b"v%d" % i) for i in range(40)
        ]
        await client.close()
    finally:
        await b.stop()


def test_adjacent_segment_merge_e2e(tmp_path):
    asyncio.run(_merge_e2e(tmp_path))


async def _merge_crash_window(tmp_path):
    """Orphaned merged object (crash between PUT and REPLACE): the next
    pass redoes the merge with the same name — byte-identical content,
    no manifest corruption."""
    store = MemoryObjectStore()
    net = LoopbackNetwork()
    b = Broker(
        BrokerConfig(
            node_id=0,
            data_dir=str(tmp_path / "n0"),
            members=[0],
            election_timeout_s=0.15,
            heartbeat_interval_s=0.03,
            housekeeping_interval_s=0,
            archival_interval_s=0,
            cloud_storage_segment_merge_min_bytes=64 << 10,
            device="cpu",
        ),
        loopback=net,
        object_store=store,
    )
    await b.start()
    b.config.peer_kafka_addresses = {0: b.kafka_advertised}
    try:
        await b.wait_controller_leader()
        client = KafkaClient([b.kafka_advertised])
        await client.create_topic(
            "ct",
            partitions=1,
            replication_factor=1,
            configs={
                "redpanda.remote.write": "true",
                "segment.bytes": "600",
            },
        )
        for i in range(30):
            await client.produce("ct", 0, [(b"k%d" % i, b"v%d" % i)])
        p = b.partition_manager.get(kafka_ntp("ct", 0))
        p.log.flush()
        b.archival.merge_min_bytes = 0  # uploads only, no merging yet
        await b.archival.run_once()
        b.archival.merge_min_bytes = 64 << 10
        segs = list(p.archival.segments)
        assert len(segs) >= 2

        # simulate the crash: PUT the merged object, but never REPLACE
        a = p.archiver
        run = segs[:2]
        datas = [
            await store.get(a.manifest.segment_key(m)) for m in run
        ]
        orphan_name = (
            f"{int(run[0].base_offset)}-{int(run[1].last_offset)}-"
            f"{int(run[1].term)}.m.seg"
        )
        ntp = p.ntp
        prefix = PartitionManifest.prefix(ntp.ns, ntp.topic, ntp.partition)
        await store.put(f"{prefix}/{orphan_name}", b"".join(datas))

        # the real merge pass overwrites the orphan and completes
        merges = 0
        for _ in range(8):
            await b.archival.run_once()
            merges = b.archival.merges
            if merges:
                break
        assert merges >= 1
        m1 = p.archiver.manifest
        for s in m1.segments:
            assert await store.exists(m1.segment_key(s))
        got = await client.fetch("ct", 0, 0, max_bytes=1 << 24)
        assert len(got) == 30
        await client.close()
    finally:
        await b.stop()


def test_merge_crash_window_idempotent(tmp_path):
    asyncio.run(_merge_crash_window(tmp_path))
