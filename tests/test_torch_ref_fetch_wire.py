"""tests/test_fetch_wire.py run on the port: all 17 cases, with imports
pointed at redpanda_tpu_torch,
`test_verify_on_read_flags_disk_corruption` included (RP_FETCH_VERIFY=1:
the fetch's CRC verify through `ops.crc32c.crc32c_batch_device`).
Brokers run on the CPU (`BrokerConfig(device="cpu")`) and an autouse
fixture sets `ops.default_device` (the codec and CRC entries' device) to
"cpu", the kernels' plain versions. Nothing is left out.

Zero-copy fetch plane tests.

The wire plane (Segment.read_spans → Log.read_wire → WireSpan rows →
Partition.read_kafka_wire → read_fetch_rows) must be observationally
IDENTICAL to the decoded plane (RecordBatch.deserialize →
to_kafka_wire → _frame_kafka) for every interleaving of appends,
truncations, compaction-style rewrites, cache evictions and random
fetch windows — the only permitted difference is copy count. This
file proves it three ways:

  * unit: span→wire conversion and the in-place base-offset patch are
    byte-equal to decode+re-encode, and the patch never touches the
    CRC-covered region;
  * differential fuzz: 10k+ randomized `read_wire` calls against
    `read` on a mutating log (seeded — failures replay);
  * end-to-end: a live broker serves byte-identical fetch responses
    with `RP_FETCH_WIRE` on and off, and `RP_FETCH_VERIFY=1` converts
    an on-disk span corruption into a retriable storage error via one
    device-batched CRC dispatch.

Also hosts the read-path satellite tests: segment truncate lands on
batch boundaries via the sparse index, and timequery bisects.
"""

import asyncio
import os
import random

import pytest

from redpanda_tpu_torch.models import RecordBatchBuilder, RecordBatchType
from redpanda_tpu_torch.models.record import (
    HEADER_SIZE,
    KAFKA_BATCH_OVERHEAD,
    RecordBatch,
    pack_wire_base,
    span_to_wire,
    walk_kafka_wire,
    wire_crc_payloads,
)
from redpanda_tpu_torch.storage import BatchCache, Log, LogConfig
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


def make_batch(
    n=3,
    ts=1_700_000_000_000,
    value_size=32,
    btype=RecordBatchType.raft_data,
):
    b = RecordBatchBuilder(btype, timestamp_ms=ts)
    for i in range(n):
        b.add(os.urandom(value_size), key=f"k{i}".encode())
    return b.build()


class TestSpanToWire:
    def test_matches_decoded_reencode(self, tmp_path):
        """span_to_wire on raw segment bytes == deserialize +
        to_kafka_wire, across batch types and record shapes."""
        log = Log(str(tmp_path))
        shapes = [
            (1, 16, RecordBatchType.raft_data),
            (7, 300, RecordBatchType.raft_data),
            (2, 64, RecordBatchType.raft_configuration),
            (3, 0, RecordBatchType.tx_fence),
            (12, 128, RecordBatchType.checkpoint),
        ]
        for n, vs, bt in shapes:
            log.append(make_batch(n, value_size=vs, btype=bt), term=1)
        log.flush()
        for seg in log._segments:
            for _hdr, span, _pos in seg.read_spans(seg.base_offset):
                row = span_to_wire(span)
                batch = RecordBatch.deserialize(bytes(span))
                assert bytes(row.wire) == batch.to_kafka_wire()
                assert row.base_offset == batch.header.base_offset
                assert row.last_offset == batch.header.last_offset
                assert row.batch_type == int(batch.header.type)
                assert row.size_bytes() == batch.size_bytes()
        log.close()

    def test_base_patch_is_crc_safe(self):
        """Patching the kafka base offset rewrites ONLY the first 8
        bytes; the CRC field and the CRC-covered region are untouched,
        so the stored body CRCs keep verifying after translation."""
        batch = make_batch(5, value_size=80)
        row = span_to_wire(batch.serialize())
        patched = row.patch_base(row.base_offset + 1234)
        assert patched[8:] == bytes(row.wire[8:])
        assert int.from_bytes(patched[:8], "big") == row.base_offset + 1234
        # same-base patch is the identity (no copy taken)
        assert row.patch_base(row.base_offset) is row.wire
        # stored CRCs still verify over the patched buffer
        bufs, crcs = wire_crc_payloads(patched)
        assert len(bufs) == 1
        from redpanda_tpu_torch.utils.crc import crc32c as _crc32c

        assert _crc32c(bufs[0]) == crcs[0]

    def test_pack_wire_base_in_place(self):
        batch = make_batch(2)
        row = span_to_wire(batch.serialize())
        buf = bytearray(row.wire)
        pack_wire_base(buf, 0, 7777)
        assert int.from_bytes(buf[:8], "big") == 7777
        assert buf[8:] == row.wire[8:]

    def test_walk_kafka_wire_concat(self):
        batches = [make_batch(i + 1, value_size=10 * i) for i in range(4)]
        wires = [span_to_wire(b.serialize()).wire for b in batches]
        cat = b"".join(bytes(w) for w in wires)
        walked = walk_kafka_wire(cat)
        assert len(walked) == 4
        pos = 0
        for (start, end), w in zip(walked, wires):
            assert start == pos and end == pos + len(w)
            pos = end

    def test_wire_size_accounting_matches_internal(self):
        batch = make_batch(6, value_size=50)
        row = span_to_wire(batch.serialize())
        assert (
            row.size_bytes()
            == len(row.wire) + HEADER_SIZE - KAFKA_BATCH_OVERHEAD
        )
        assert row.size_bytes() == batch.size_bytes()


def _assert_rows_equal(wire_rows, batches, ctx):
    assert len(wire_rows) == len(batches), ctx
    for row, batch in zip(wire_rows, batches):
        assert row.base_offset == batch.header.base_offset, ctx
        assert row.last_offset == batch.header.last_offset, ctx
        assert row.batch_type == int(batch.header.type), ctx
        assert row.size_bytes() == batch.size_bytes(), ctx
        assert bytes(row.wire) == batch.to_kafka_wire(), ctx


_FUZZ_TYPES = [
    RecordBatchType.raft_data,
    RecordBatchType.raft_data,
    RecordBatchType.raft_data,  # weighted: data dominates real logs
    RecordBatchType.raft_configuration,
    RecordBatchType.tx_fence,
    RecordBatchType.archival_metadata,
]


class TestLogWireDifferential:
    """Seeded fuzz: mutate a log, then hammer read_wire vs read with
    random windows. Byte-identity must hold through truncations,
    prefix truncations, rolls, wire-plane drops, cache evictions and
    mid-stream appends. 3 seeds x 3500 comparisons > the 10k floor."""

    READS_PER_SEED = 3500

    @pytest.mark.parametrize("seed", [11, 23, 47])
    def test_fuzz(self, tmp_path, seed):
        rnd = random.Random(seed)
        cache = BatchCache(max_bytes=256 * 1024)  # small: force eviction
        log = Log(
            str(tmp_path / f"s{seed}"),
            LogConfig(segment_max_bytes=8192),
            cache=cache,
        )
        for _ in range(8):  # never fuzz an empty log
            log.append(make_batch(rnd.randint(1, 6)), term=1)
        reads = 0
        step = 0
        while reads < self.READS_PER_SEED:
            step += 1
            op = rnd.random()
            offs = log.offsets()
            if op < 0.45:
                log.append(
                    make_batch(
                        rnd.randint(1, 8),
                        value_size=rnd.choice([0, 8, 40, 200]),
                        btype=rnd.choice(_FUZZ_TYPES),
                    ),
                    term=rnd.randint(1, 3),
                )
            elif op < 0.55 and offs.dirty_offset > offs.start_offset + 10:
                log.truncate(
                    rnd.randint(offs.start_offset + 1, offs.dirty_offset)
                )
            elif op < 0.63 and offs.dirty_offset > offs.start_offset + 10:
                log.prefix_truncate(
                    rnd.randint(offs.start_offset + 1, offs.dirty_offset - 5)
                )
            elif op < 0.70:
                log.force_roll(term=rnd.randint(1, 3))
            elif op < 0.78:
                log.drop_wire_cache()
            elif op < 0.84:
                lo = rnd.randint(0, max(0, offs.dirty_offset))
                log._cache_index.evict_range(lo, lo + rnd.randint(0, 20))
            # a burst of random fetch windows after every mutation
            offs = log.offsets()
            for _ in range(rnd.randint(20, 40)):
                start = rnd.randint(
                    max(0, offs.start_offset - 3), offs.dirty_offset + 3
                )
                max_bytes = rnd.choice([64, 500, 4096, 1 << 20])
                upto = (
                    None
                    if rnd.random() < 0.5
                    else rnd.randint(start, offs.dirty_offset + 5)
                )
                wire_rows = log.read_wire(start, max_bytes=max_bytes, upto=upto)
                batches = log.read(start, max_bytes=max_bytes, upto=upto)
                _assert_rows_equal(
                    wire_rows,
                    batches,
                    f"seed={seed} step={step} start={start} "
                    f"max_bytes={max_bytes} upto={upto}",
                )
                reads += 1
        log.close()

    def test_total_comparisons_clear_floor(self):
        assert 3 * self.READS_PER_SEED >= 10_000


class TestWireCachePlane:
    def test_repeat_read_hits_wire_plane(self, tmp_path):
        cache = BatchCache()
        log = Log(str(tmp_path), cache=cache)
        for _ in range(10):
            log.append(make_batch(4), term=1)
        first = log.read_wire(0)
        h0 = cache.wire_hits
        second = log.read_wire(0)
        assert cache.wire_hits > h0
        assert [bytes(r.wire) for r in first] == [
            bytes(r.wire) for r in second
        ]
        log.close()

    def test_append_tail_served_from_decoded_conversion(self, tmp_path):
        """Hot tail: the append path populates the decoded plane; the
        first wire read converts it without touching disk (no reader
        miss), and the conversion lands in the wire plane."""
        cache = BatchCache()
        log = Log(str(tmp_path), cache=cache)
        log.append(make_batch(3), term=1)
        misses0 = log.reader_misses
        rows = log.read_wire(0)
        assert len(rows) == 1
        assert log.reader_misses == misses0  # never went to disk
        assert cache.wire_misses > 0
        h0 = cache.wire_hits
        log.read_wire(0)
        assert cache.wire_hits > h0
        log.close()

    def test_drop_wire_cache_rereads_identically(self, tmp_path):
        cache = BatchCache()
        log = Log(str(tmp_path), cache=cache)
        for _ in range(6):
            log.append(make_batch(5, value_size=100), term=1)
        log.flush()
        before = [bytes(r.wire) for r in log.read_wire(0)]
        log.drop_wire_cache()
        after = [bytes(r.wire) for r in log.read_wire(0)]
        assert before == after
        log.close()

    def test_truncate_drops_stale_wire_rows(self, tmp_path):
        cache = BatchCache()
        log = Log(str(tmp_path), cache=cache)
        for _ in range(8):
            log.append(make_batch(2), term=1)
        log.read_wire(0)  # populate the wire plane
        cut = log.offsets().dirty_offset // 2
        log.truncate(cut)
        log.append(make_batch(2, value_size=99), term=2)
        _assert_rows_equal(log.read_wire(0), log.read(0), "post-truncate")
        log.close()


class TestSegmentSatellites:
    def test_truncate_lands_on_batch_boundary(self, tmp_path):
        log = Log(str(tmp_path), LogConfig(segment_max_bytes=4096))
        for _ in range(30):
            log.append(make_batch(5, value_size=64), term=1)
        # cut mid-batch: batches are the truncation unit — the batch
        # whose base is below the cut survives whole (sparse-index
        # seek to the last indexed batch below 52, bounded forward walk)
        log.truncate(52)
        assert log.offsets().dirty_offset == 54
        # cut exactly on a base drops that batch
        log.truncate(50)
        assert log.offsets().dirty_offset == 49
        batches = log.read(0)
        assert batches[-1].header.last_offset == 49
        log.close()

    def test_timequery_bisects_across_segments(self, tmp_path):
        log = Log(str(tmp_path), LogConfig(segment_max_bytes=2048))
        t0 = 1_700_000_000_000
        for i in range(40):
            log.append(make_batch(2, ts=t0 + i * 1000, value_size=64), term=1)
        assert log.segment_count() > 1
        assert log.timequery(t0) == 0
        assert log.timequery(t0 + 10_500) == 22  # first batch with ts >= q
        assert log.timequery(t0 + 39_000) == 78
        assert log.timequery(t0 + 40_000) is None
        log.close()


# -- end-to-end: live broker, wire vs decoded, verify-on-read ----------


async def _boot_single(tmp_path):
    from redpanda_tpu_torch.app import Broker, BrokerConfig
    from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork

    b = Broker(
        BrokerConfig(
            device="cpu",
            node_id=0,
            data_dir=str(tmp_path / "n0"),
            members=[0],
            election_timeout_s=0.15,
            heartbeat_interval_s=0.03,
        ),
        loopback=LoopbackNetwork(),
    )
    await b.start()
    await b.wait_controller_leader()
    return b


def test_broker_fetch_wire_vs_decoded_differential(tmp_path, monkeypatch):
    """The same live broker answers byte-identical fetch responses with
    the wire plane on and off, across randomized offsets/budgets."""

    async def run():
        from redpanda_tpu_torch.kafka.client import KafkaClient

        b = await _boot_single(tmp_path)
        client = KafkaClient([b.kafka_advertised])
        try:
            await client.create_topic("dw", partitions=1)
            for i in range(60):
                await client.produce(
                    "dw",
                    0,
                    [
                        (b"k%d-%d" % (i, j), os.urandom(20 + (i * 13) % 150))
                        for j in range(3)
                    ],
                    acks=-1,
                )
            rnd = random.Random(3)
            for _ in range(60):
                off = rnd.randint(0, 179)  # hw is 180
                mb = rnd.choice([200, 1500, 1 << 16, 1 << 20])
                monkeypatch.delenv("RP_FETCH_WIRE", raising=False)
                wire, next_w = await client.fetch_raw(
                    "dw", 0, off, max_bytes=mb
                )
                monkeypatch.setenv("RP_FETCH_WIRE", "0")
                decoded, next_d = await client.fetch_raw(
                    "dw", 0, off, max_bytes=mb
                )
                monkeypatch.delenv("RP_FETCH_WIRE", raising=False)
                assert wire == decoded, (off, mb)
                assert next_w == next_d, (off, mb)
        finally:
            await client.close()
            await b.stop()

    asyncio.run(run())


def test_verify_on_read_flags_disk_corruption(tmp_path, monkeypatch):
    """RP_FETCH_VERIFY=1: a span corrupted on disk BELOW append-time
    verification is caught by the per-response device CRC pass and
    answered as a retriable storage error; the wire cache is dropped
    so the retry re-reads from disk instead of re-serving the cached
    corrupt copy. Without verify, the trust-append-time plane serves
    the bytes as stored (the stand-down contract)."""

    async def run():
        from redpanda_tpu_torch.kafka.client import KafkaClient, KafkaClientError
        from redpanda_tpu_torch.kafka.protocol.headers import ErrorCode
        from redpanda_tpu_torch.models.fundamental import kafka_ntp

        b = await _boot_single(tmp_path)
        client = KafkaClient([b.kafka_advertised])
        try:
            await client.create_topic("vc", partitions=1)
            for i in range(10):
                await client.produce(
                    "vc", 0, [(b"k%d" % i, b"v" * 200)], acks=-1
                )
            part = b.partition_manager.get(kafka_ntp("vc", 0))
            log = part.log
            log.flush()
            # flip one body byte in the newest segment file, then drop
            # every cached copy so the fetch must re-read the disk
            seg_path = log._segments[-1]._path
            with open(seg_path, "r+b") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(size - 16)
                orig = f.read(1)
                f.seek(size - 16)
                f.write(bytes([orig[0] ^ 0xFF]))
            log._cache_index.truncate(0)
            log.invalidate_readers()

            monkeypatch.setenv("RP_FETCH_VERIFY", "1")
            with pytest.raises(KafkaClientError) as ei:
                await client.fetch("vc", 0, 0)
            assert ei.value.code == int(ErrorCode.kafka_storage_error)

            # stand-down: trust-append-time serves the stored bytes
            monkeypatch.delenv("RP_FETCH_VERIFY", raising=False)
            log._cache_index.truncate(0)
            log.invalidate_readers()
            wire, _next = await client.fetch_raw("vc", 0, 0, max_bytes=1 << 20)
            assert wire  # served, unverified — the stand-down contract
        finally:
            await client.close()
            await b.stop()

    asyncio.run(run())
