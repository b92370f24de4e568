"""tests/test_device_lz4.py run on the port: device LZ4 blocks
decodable by liblz4, frame integration, the registry seam.

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
from redpanda_tpu_torch.compression import CompressionType, lz4_codec, tpu_backend
from redpanda_tpu_torch.ops.lz4 import CELL, compress_chunks, out_bound
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's device codec entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


def _payloads():
    rng = random.Random(7)
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
    }


def test_blocks_decode_with_liblz4():
    cases = {k: v for k, v in _payloads().items() if v}
    outs = compress_chunks(list(cases.values()))
    for (name, orig), comp in zip(cases.items(), outs):
        rt = lz4_codec.decompress_block(comp, len(orig))
        assert rt == orig, name


def test_out_bound_holds_on_adversarial_input():
    rng = random.Random(1)
    # inputs engineered for dense sequence emission: alternating
    # matchable / unmatchable cells
    bad = []
    for _ in range(8):
        buf = bytearray()
        while len(buf) < 2048:
            buf += bytes([rng.getrandbits(8) for _ in range(CELL)])
            buf += buf[-CELL:]  # immediate repeat: a match every cell
        bad.append(bytes(buf))
    outs = compress_chunks(bad)  # internal assert checks out_bound
    for orig, comp in zip(bad, outs):
        assert lz4_codec.decompress_block(comp, len(orig)) == orig
        assert len(comp) <= out_bound(len(orig))


def test_frames_roundtrip():
    for name, data in _payloads().items():
        frame = tpu_backend.compress(data)
        assert lz4_codec.decompress_frame(frame) == data, name


def test_multiblock_frame():
    # > 64 KiB: multiple independent blocks in one frame
    data = (b"block-content-%d " * 1200 + os.urandom(300)) * 5
    assert len(data) > 65536
    frame = tpu_backend.compress(data)
    assert lz4_codec.decompress_frame(frame) == data


def test_compress_many_batches():
    bufs = list(_payloads().values()) + [os.urandom(70000)]
    frames = tpu_backend.compress_many(bufs)
    for data, frame in zip(bufs, frames):
        assert lz4_codec.decompress_frame(frame) == data


def test_registry_backend_seam():
    data = b'{"device":"codec"},' * 500
    host = compression.compress(data, CompressionType.lz4)
    try:
        tpu_backend.enable()
        dev = compression.compress(data, CompressionType.lz4)
        # both are standard frames: each side decodes the other
        assert compression.uncompress(dev, CompressionType.lz4) == data
        assert lz4_codec.decompress_frame(dev) == data
    finally:
        tpu_backend.disable()
    assert compression.uncompress(host, CompressionType.lz4) == data
    assert compression.uncompress(dev, CompressionType.lz4) == data


def test_chunk_size_cap():
    with pytest.raises(ValueError):
        compress_chunks([b"x" * 65537])
