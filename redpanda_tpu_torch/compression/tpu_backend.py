"""The device codec backend: card-batched LZ4 and snappy behind the registry.

Reference seam: src/v/compression/compression.cc gates codecs by type;
the device backend slot registers compressors whose blocks come from
the CUDA kernels of ops/lz4.py and ops/snappy.py (port of
redpanda_tpu/compression/tpu_backend.py). `enable()` registers an LZ4
compressor whose blocks are wrapped into a standard LZ4 frame (64 KiB
independent blocks) and a snappy compressor whose raw blocks are
wrapped into a snappy-java (xerial) stream, so ANY consumer — external
Kafka clients, or the host path with the backend disabled — decodes
them with plain liblz4 / libsnappy. Decompression stays on the host.

`compress_many` is the real batched entry: it flattens every 64 KiB
chunk of every buffer into one padded batch, runs ONE parse + emission
on the card, and reassembles frames. The entries take no device
argument: they run on ops.lz4.DEFAULT_DEVICE / ops.snappy.DEFAULT_DEVICE
(the card), and raise on a machine without one.

The zstd leg (device huff0, redpanda_tpu/compression/tpu_backend.py
`compress_zstd`, `compress_many_zstd`, `uncompress_zstd`) is not ported
yet: its entries raise.
"""

from __future__ import annotations

import struct

from . import lz4_codec

_MAGIC = 0x184D2204
_BLOCK = 65536  # BD byte 4: 64 KiB max block, fits 16-bit lz4 offsets


def _frame_header() -> bytes:
    from ..utils.hash import xxh32

    flg = (1 << 6) | (1 << 5)  # v1, block-independent, no content checksum
    bd = 4 << 4  # 64 KiB max block size
    desc = bytes([flg, bd])
    hc = (xxh32(desc) >> 8) & 0xFF
    return struct.pack("<I", _MAGIC) + desc + bytes([hc])


def _assemble_frame(chunks: list[bytes], blocks: list[bytes]) -> bytes:
    out = bytearray(_frame_header())
    for raw, comp in zip(chunks, blocks):
        if len(comp) >= len(raw):
            out += struct.pack("<I", len(raw) | 0x80000000) + raw
        else:
            out += struct.pack("<I", len(comp)) + comp
    out += struct.pack("<I", 0)  # end mark
    return bytes(out)


def _split(data: bytes) -> list[bytes]:
    return [data[o : o + _BLOCK] for o in range(0, len(data), _BLOCK)] or [b""]


def compress(data: bytes) -> bytes:
    """Single-buffer entry used behind the registry slot."""
    return compress_many([data])[0]


def compress_many(buffers: list[bytes]) -> list[bytes]:
    """Batch-compress buffers into LZ4 frames with ONE parse + emission
    over all of their 64 KiB chunks."""
    from ..ops.lz4 import compress_chunks

    plan: list[list[bytes]] = [_split(b) for b in buffers]
    flat = [c for chunks in plan for c in chunks if c]
    compressed = iter(compress_chunks(flat))
    out = []
    for chunks in plan:
        blocks = [next(compressed) if c else b"" for c in chunks]
        out.append(_assemble_frame([c for c in chunks if c], [b for b in blocks if b]))
    return out


# ---- snappy leg (xerial stream framing over device raw blocks) ------
_SNAPPY_BLOCK = 32768  # snappy-java chunk convention


def compress_snappy(data: bytes) -> bytes:
    return compress_many_snappy([data])[0]


def compress_many_snappy(buffers: list[bytes]) -> list[bytes]:
    """Batch-compress buffers into snappy-java (xerial) streams whose
    raw blocks come from ONE parse + emission (ops/snappy.py); any
    consumer decodes them with plain libsnappy."""
    from . import snappy_codec
    from ..ops.snappy import compress_chunks

    plan = [
        [
            data[o : o + _SNAPPY_BLOCK]
            for o in range(0, len(data), _SNAPPY_BLOCK)
        ]
        or [b""]
        for data in buffers
    ]
    flat = [c for chunks in plan for c in chunks]
    blocks = iter(compress_chunks(flat))
    out = []
    for chunks in plan:
        body = bytearray(snappy_codec.xerial_header())
        for _ in chunks:
            blk = next(blocks)
            body += struct.pack(">i", len(blk))
            body += blk
        out.append(bytes(body))
    return out


# ---- zstd leg: not ported yet ----------------------------------------
def _zstd_not_ported(*_args, **_kwargs):
    raise NotImplementedError(
        "device zstd (ops/zstd.py huff0 encode/decode) is not ported to CUDA yet "
        "(ROADMAP.md, queue 1 step 8: zstd)"
    )


compress_zstd = compress_many_zstd = uncompress_zstd = _zstd_not_ported


def enable() -> None:
    """Register the device LZ4 + snappy compressors; uncompress stays
    host-side (the emitted frames/streams are standard, so liblz4 and
    libsnappy read them)."""
    from . import CompressionType, register_backend, snappy_codec

    register_backend(
        CompressionType.lz4, compress, lz4_codec.decompress_frame
    )
    register_backend(
        CompressionType.snappy, compress_snappy, snappy_codec.decompress_java
    )


def disable() -> None:
    from . import clear_backend

    clear_backend()
