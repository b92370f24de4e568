"""tests/test_fused_codec.py run on the port: the fused CRC-32C + LZ4
entry, `RecordBatch.recompressed`, and the broker's produce-side
recompression.

The reference cases are copied with their imports pointed at
redpanda_tpu_torch; an autouse fixture points the codec and CRC entries,
which take the card by default in the port, at the CPU (the kernels'
plain versions; chip_smoke.py holds the CUDA kernels against those).
The broker cases boot the port's brokers through
`test_torch_ref_kafka_e2e`'s fixtures (`device="cpu"`). All nine cases
are carried; nothing is left out.
"""

import asyncio
import os

import numpy as np
import pytest

from redpanda_tpu_torch.compression import CompressionType, lz4_codec
from redpanda_tpu_torch.models.record import (
    CrcMismatch,
    RecordBatchBuilder,
)
from redpanda_tpu_torch.ops.fused import crc_lz4_fused
from redpanda_tpu_torch.utils import crc as host_crc
from redpanda_tpu_torch.ops import crc32c as crc_ops
from redpanda_tpu_torch.ops import fused as fused_ops
from redpanda_tpu_torch.ops import lz4 as lz4_ops
from redpanda_tpu_torch.ops import snappy as snappy_ops
from redpanda_tpu_torch.ops import zstd as zstd_ops

from test_torch_ref_kafka_e2e import broker_cluster, client_for  # noqa: F401


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's device codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    for mod in (lz4_ops, snappy_ops, zstd_ops, fused_ops, crc_ops):
        monkeypatch.setattr(mod, "DEFAULT_DEVICE", "cpu")


def _payloads(rng, n, max_len=4000):
    out = []
    for i in range(n):
        if i % 3 == 0:
            out.append(rng.integers(0, 256, rng.integers(32, max_len)).astype(np.uint8).tobytes())
        else:  # compressible
            out.append((b"abcd%d" % i) * (rng.integers(8, max_len // 8)))
    return out


def test_fused_matches_host_crc_and_roundtrips_lz4():
    rng = np.random.default_rng(11)
    bodies = _payloads(rng, 24)
    prefixes = [bytes(rng.integers(0, 256, 40, np.uint8)) for _ in bodies]
    crcs, blocks = crc_lz4_fused(prefixes, bodies)
    for p, b, c, blk in zip(prefixes, bodies, crcs, blocks):
        assert int(c) == host_crc.crc32c(b, host_crc.crc32c(p))
        # the block decompresses (or was stored raw by the fallback)
        if len(blk) < len(b):
            assert lz4_codec.decompress_block(blk, len(b)) == b


def test_fused_frame_assembly_interops_with_frame_decoder():
    rng = np.random.default_rng(5)
    bodies = _payloads(rng, 6, max_len=30000)
    prefixes = [b"\x00" * 40 for _ in bodies]
    _crcs, blocks = crc_lz4_fused(prefixes, bodies)
    for body, blk in zip(bodies, blocks):
        frame = lz4_codec.frame_from_blocks([blk], [body])
        assert lz4_codec.decompress_frame(frame) == body


def test_recompressed_batch_device_and_host_agree(monkeypatch):
    b = RecordBatchBuilder(base_offset=7)
    for i in range(50):
        b.add(b"value-%d" % i * 20, key=b"k%d" % i)
    batch = b.build()
    host = batch.recompressed(CompressionType.lz4, verify_crc=batch.header.crc)
    monkeypatch.setenv("RP_CODEC_BACKEND", "device")
    dev = batch.recompressed(CompressionType.lz4, verify_crc=batch.header.crc)
    for out in (host, dev):
        assert out.header.compression == CompressionType.lz4
        assert out.verify_crc()
        # records identical after decompression
        got = [(r.key, r.value) for r in out.records()]
        want = [(r.key, r.value) for r in batch.records()]
        assert got == want
    # device verify catches a corrupt wire crc in the same pass
    with pytest.raises(CrcMismatch):
        batch.recompressed(CompressionType.lz4, verify_crc=batch.header.crc ^ 1)


def test_matching_codec_still_crc_verified():
    """A batch already in the topic's codec must STILL be rejected on a
    corrupt wire CRC (the server delegates verification here)."""
    b = RecordBatchBuilder(compression=CompressionType.lz4)
    for i in range(5):
        b.add(b"v%d" % i * 50, key=b"k%d" % i)
    batch = b.build()
    assert batch.recompressed(
        CompressionType.lz4, verify_crc=batch.header.crc
    ) is batch
    with pytest.raises(CrcMismatch):
        batch.recompressed(CompressionType.lz4, verify_crc=batch.header.crc ^ 1)


async def _produce_recompression(tmp_path, backend):
    saved = os.environ.get("RP_CODEC_BACKEND")
    if backend:
        os.environ["RP_CODEC_BACKEND"] = backend
    else:
        os.environ.pop("RP_CODEC_BACKEND", None)
    try:
        async with broker_cluster(tmp_path, 1) as brokers:
            async with client_for(brokers) as client:
                await client.create_topic(
                    "comp",
                    partitions=1,
                    replication_factor=1,
                    configs={"compression.type": "lz4"},
                )
                records = [(b"k%d" % i, b"payload-%d" % i * 30) for i in range(40)]
                await client.produce("comp", 0, records)
                # stored batch is LZ4 on disk (the broker recompressed)
                from redpanda_tpu_torch.models.fundamental import kafka_ntp

                p = brokers[0].partition_manager.get(kafka_ntp("comp", 0))
                stored = [
                    bt
                    for bt in p.log.read(0, max_bytes=1 << 24)
                    if bt.header.type.name == "raft_data"
                ]
                assert stored, "no data batches on disk"
                assert all(
                    bt.header.compression == CompressionType.lz4
                    for bt in stored
                )
                # and consumers read the records back transparently
                got = await client.fetch("comp", 0, 0, max_wait_ms=300)
                assert [(k, v) for _o, k, v in got] == records
    finally:
        if saved is None:
            os.environ.pop("RP_CODEC_BACKEND", None)
        else:
            os.environ["RP_CODEC_BACKEND"] = saved


def test_produce_recompression_host(tmp_path):
    asyncio.run(_produce_recompression(tmp_path, None))


def test_produce_recompression_device(tmp_path):
    asyncio.run(_produce_recompression(tmp_path, "device"))


def test_producer_codec_kept_when_config_is_producer(tmp_path):
    async def main():
        async with broker_cluster(tmp_path, 1) as brokers:
            async with client_for(brokers) as client:
                await client.create_topic("plain", partitions=1,
                                          replication_factor=1)
                await client.produce("plain", 0, [(b"k", b"v" * 100)])
                from redpanda_tpu_torch.models.fundamental import kafka_ntp

                p = brokers[0].partition_manager.get(kafka_ntp("plain", 0))
                stored = [
                    bt
                    for bt in p.log.read(0, max_bytes=1 << 24)
                    if bt.header.type.name == "raft_data"
                ]
                assert all(
                    bt.header.compression == CompressionType.none
                    for bt in stored
                )

    asyncio.run(main())


def test_codec_mismatch_transcoded(tmp_path):
    """A producer using gzip against a compression.type=lz4 topic gets
    deep-recompressed to lz4 (Kafka LogValidator semantics)."""

    async def main():
        async with broker_cluster(tmp_path, 1) as brokers:
            async with client_for(brokers) as client:
                await client.create_topic(
                    "xcode", partitions=1, replication_factor=1,
                    configs={"compression.type": "lz4"},
                )
                b = RecordBatchBuilder(compression=CompressionType.gzip)
                recs = [(b"k%d" % i, b"v%d" % i * 40) for i in range(20)]
                for k, v in recs:
                    b.add(v, key=k)
                wire = b.build().to_kafka_wire()
                await client.produce_wire("xcode", 0, wire, acks=-1)
                from redpanda_tpu_torch.models.fundamental import kafka_ntp

                p = brokers[0].partition_manager.get(kafka_ntp("xcode", 0))
                stored = [
                    bt
                    for bt in p.log.read(0, max_bytes=1 << 24)
                    if bt.header.type.name == "raft_data"
                ]
                assert all(
                    bt.header.compression == CompressionType.lz4
                    for bt in stored
                ), [bt.header.compression for bt in stored]
                got = await client.fetch("xcode", 0, 0, max_wait_ms=300)
                assert [(k, v) for _o, k, v in got] == recs

    asyncio.run(main())


def test_uncompressed_config_forces_decompression(tmp_path):
    """compression.type=uncompressed decompresses producer batches
    (LogValidator semantics)."""

    async def main():
        async with broker_cluster(tmp_path, 1) as brokers:
            async with client_for(brokers) as client:
                await client.create_topic(
                    "unc", partitions=1, replication_factor=1,
                    configs={"compression.type": "uncompressed"},
                )
                b = RecordBatchBuilder(compression=CompressionType.gzip)
                recs = [(b"k%d" % i, b"v%d" % i * 30) for i in range(10)]
                for k, v in recs:
                    b.add(v, key=k)
                await client.produce_wire(
                    "unc", 0, b.build().to_kafka_wire(), acks=-1
                )
                from redpanda_tpu_torch.models.fundamental import kafka_ntp

                p = brokers[0].partition_manager.get(kafka_ntp("unc", 0))
                stored = [
                    bt
                    for bt in p.log.read(0, max_bytes=1 << 24)
                    if bt.header.type.name == "raft_data"
                ]
                assert all(
                    bt.header.compression == CompressionType.none
                    for bt in stored
                )
                got = await client.fetch("unc", 0, 0, max_wait_ms=300)
                assert [(k, v) for _o, k, v in got] == recs

    asyncio.run(main())
