"""tests/test_device_snappy.py run on the port: raw snappy blocks
decodable by libsnappy, the xerial stream, fused CRC + snappy, the
registry seam.

The reference file is copied with its imports pointed at
redpanda_tpu_torch. Carried: every case. Left out: nothing. The codec
entries take the card by default in the port, so an autouse fixture
points them at the CPU (the kernels' plain versions; the CUDA kernels
are held against those by chip_smoke.py).
"""

import os
import random

import pytest

from redpanda_tpu_torch import compression
from redpanda_tpu_torch.compression import CompressionType, snappy_codec, tpu_backend
from redpanda_tpu_torch.ops.cellparse import CELL
from redpanda_tpu_torch.ops.snappy import compress_chunks, out_bound
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's device codec entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


def _payloads():
    rng = random.Random(11)
    return {
        "empty": b"",
        "one": b"Z",
        "zeros": b"\x00" * 4096,
        "rle_mix": b"".join(
            bytes([i % 11]) * (i % 29 + 1) for i in range(200)
        ),
        "text": b"the quick brown fox jumps over the lazy dog. " * 90,
        "json": b'{"k":"aaaa","v":123,"flag":true},' * 120,
        "random": bytes(rng.getrandbits(8) for _ in range(3000)),
        "cell_edge": b"ab" * (CELL // 2) * 3 + b"\x01",
        "period_cell": bytes(range(CELL)) * 64,
        "alt": (b"\x00\xff" * 2048),
        "long_lit": bytes(rng.getrandbits(8) for _ in range(300)),
        "max_chunk": bytes(rng.getrandbits(8) for _ in range(65536)),
        "max_zeros": b"\x00" * 65536,
    }


def test_blocks_decode_with_libsnappy():
    cases = _payloads()
    outs = compress_chunks(list(cases.values()))
    for (name, orig), comp in zip(cases.items(), outs):
        assert snappy_codec.decompress_raw(comp) == orig, name


def test_ratio_not_pathological():
    """Periodic payloads must compress (the absorption/merge path):
    the device parse trades ratio for parallelism but must stay in
    liblz4-era ballpark, not degrade to all-literal."""
    period = bytes(range(CELL)) * 64
    zeros = b"\x00" * 65536
    outs = compress_chunks([period, zeros])
    assert len(outs[0]) < len(period) // 4
    # snappy caps copies at 64 bytes -> 3 bytes per 64 is the FORMAT's
    # floor for runs (~3 KiB for 64 KiB of zeros; libsnappy emits the
    # same structure), unlike LZ4's 255-run extensions
    ref = snappy_codec.compress_raw(zeros)
    assert len(outs[1]) < max(4096, len(ref) * 2)


def test_out_bound_holds_for_adversarial_input():
    rng = random.Random(3)
    worst = bytes(rng.getrandbits(8) for _ in range(4096))
    (out,) = compress_chunks([worst])
    assert len(out) <= out_bound(4096) + 3  # +preamble


def test_xerial_stream_roundtrip():
    bufs = [
        b"x" * 100000,
        os.urandom(40000),
        b"",
        b"hello " * 20000,
    ]
    outs = tpu_backend.compress_many_snappy(bufs)
    for src, out in zip(bufs, outs):
        assert snappy_codec.decompress_java(out) == src


def test_registry_seam_device_snappy():
    tpu_backend.enable()
    try:
        data = b"registry snappy seam " * 500
        wire = compression.compress(data, CompressionType.snappy)
        # host-side (backend-off) consumer reads the stream fine
        tpu_backend.disable()
        assert compression.uncompress(wire, CompressionType.snappy) == data
    finally:
        tpu_backend.disable()


def test_fused_crc_snappy():
    from redpanda_tpu_torch.ops.fused import PREFIX, crc_snappy_fused
    from redpanda_tpu_torch.utils.crc import crc32c

    rng = random.Random(5)
    bodies = [
        b"fused snappy body " * 100,
        bytes(rng.getrandbits(8) for _ in range(5000)),
        b"",
        bytes(70) * 100,
    ]
    prefixes = [os.urandom(PREFIX) for _ in bodies]
    crcs, blocks = crc_snappy_fused(prefixes, bodies)
    for p, b, c, blk in zip(prefixes, bodies, crcs, blocks):
        assert snappy_codec.decompress_raw(blk) == b
        assert int(c) == crc32c(p + b)


def test_random_chunk_fuzz():
    rng = random.Random(13)
    cases = []
    for _ in range(30):
        size = rng.randrange(1, 60000)
        base = bytes(rng.getrandbits(8) for _ in range(rng.randrange(8, 64)))
        reps = size // len(base) + 1
        mix = (base * reps)[:size]
        cut = rng.randrange(0, size)
        cases.append(
            mix[:cut]
            + bytes(rng.getrandbits(8) for _ in range(size - cut))
        )
    outs = compress_chunks(cases)
    for src, comp in zip(cases, outs):
        assert snappy_codec.decompress_raw(comp) == src
