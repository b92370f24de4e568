"""tests/test_fused_codec.py's broker-free cases run on the port:
the fused CRC-32C + LZ4 entry and `RecordBatch.recompressed`.

The reference cases are copied with their imports pointed at
redpanda_tpu_torch; an autouse fixture points the codec entries, which
take the card by default in the port, at the CPU (the kernels' plain
versions; chip_smoke.py holds the CUDA kernels against those).
Carried: `test_fused_matches_host_crc_and_roundtrips_lz4`,
`test_fused_frame_assembly_interops_with_frame_decoder`,
`test_recompressed_batch_device_and_host_agree`,
`test_matching_codec_still_crc_verified`. Left out: the cases that boot
brokers through `test_kafka_e2e`'s fixtures
(`test_produce_recompression_host`, `test_produce_recompression_device`,
`test_producer_codec_kept_when_config_is_producer`,
`test_codec_mismatch_transcoded`,
`test_uncompressed_config_forces_decompression`); the port has no
broker yet (ROADMAP queue 1 step 5).
"""

import numpy as np
import pytest

from redpanda_tpu_torch.compression import CompressionType, lz4_codec
from redpanda_tpu_torch.models.record import (
    CrcMismatch,
    RecordBatchBuilder,
)
from redpanda_tpu_torch.ops.fused import crc_lz4_fused
from redpanda_tpu_torch.utils import crc as host_crc
from redpanda_tpu_torch.ops import fused as fused_ops
from redpanda_tpu_torch.ops import lz4 as lz4_ops
from redpanda_tpu_torch.ops import snappy as snappy_ops
from redpanda_tpu_torch.ops import zstd as zstd_ops


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's device codec entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    for mod in (lz4_ops, snappy_ops, zstd_ops, fused_ops):
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
