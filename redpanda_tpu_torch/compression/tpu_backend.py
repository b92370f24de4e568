"""The device codec backend: card-batched LZ4, snappy and zstd behind the registry.

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
argument: they run on ops.default_device (the card), and raise on a
machine without one.

The zstd leg (selected by RP_ZSTD_BACKEND=tpu through the registry's
_zstd_* entries) compresses with the device huff0 encode of ops/zstd.py
and decompresses profile frames with its device decode: the host walks
the block scaffolding, then every huff0 stream of every compressed block
decodes in one launch. Its entries take no device argument either: they
run on ops.default_device.
"""

from __future__ import annotations

import os
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


# ---- zstd leg (single-segment frames over device huff0 blocks) ------
# Selected by RP_ZSTD_BACKEND=tpu via the registry's _zstd_* entries —
# NOT by enable() — so the host leg stays the default differential
# oracle and the stand-down (RP_ZSTD_BACKEND=host) needs no
# re-registration. Frames are stock RFC 8878: raw/RLE/compressed
# blocks with 4-stream huff0 literals (see compression/zstd_frame.py),
# so plain libzstd decodes them.

_ZSTD_BLOCK = _BLOCK  # 64 KiB default, same plan shape as the LZ4 leg


def _zstd_block_size() -> int:
    """Encode-side chunking knob (RP_ZSTD_BLOCK, default 64 KiB).

    Smaller chunks quarantine incompressible spans (a poisoned chunk
    goes raw, its neighbours still compress) at the cost of per-block
    scaffolding and a wider device batch. Clamped to [1 KiB, 64 KiB] —
    the upper bound is the kernel's bucket ceiling."""
    v = int(os.environ.get("RP_ZSTD_BLOCK", _ZSTD_BLOCK))
    return max(1 << 10, min(v, _ZSTD_BLOCK))


def _zstd_split(data: bytes) -> "list[bytes]":
    blk = _zstd_block_size()
    return [data[o : o + blk] for o in range(0, len(data), blk)] or [b""]


def compress_zstd(data: bytes) -> bytes:
    return compress_many_zstd([data])[0]


def compress_many_zstd(buffers: "list[bytes]") -> "list[bytes]":
    """Batch-compress buffers into zstd frames whose entropy stage ran
    as ONE `rp_zstd_encode` launch over every chunk (ops/zstd.py);
    block choice (raw vs RLE vs compressed) is byte-counting host work."""
    from . import zstd_frame as zf
    from ..ops.zstd import encode_chunks

    plan = [_zstd_split(b) for b in buffers]
    flat = [c for chunks in plan for c in chunks if c]
    encs = iter(encode_chunks(flat))
    out = []
    for buf, chunks in zip(buffers, plan):
        frame = bytearray(zf.frame_header(len(buf)))
        real = [c for c in chunks if c]
        if not real:  # empty buffer still needs one (empty raw) block
            frame += zf.raw_block(b"", True)
        for i, c in enumerate(real):
            nbits, streams = next(encs)
            frame += zf.build_block(c, nbits, streams, i == len(real) - 1)
        out.append(bytes(frame))
    return out


def _decompress_device(frame: bytes) -> bytes:
    """Profile-frame decode: host walks the block/literals scaffolding,
    then EVERY huff0 stream of every compressed block decodes in one
    launch on the card. Raises ZstdFormatError on shapes outside the
    profile (caller punts to the host codec byte-for-byte) and
    ValueError on size-cap violations (the decompress bomb guard —
    checked from declared sizes BEFORE any output is materialized)."""
    from . import _zstd_nosize_limit, zstd_frame as zf
    from ..ops.zstd import decode_streams

    declared, pos = zf.parse_frame_header(frame)
    if int.from_bytes(frame[:4], "little") != zf.MAGIC or frame[4] & 3:
        raise zf.ZstdFormatError("skippable/dictionary frame (punt)")
    limit = declared if declared is not None else _zstd_nosize_limit()
    pieces: "list[bytes | int]" = []  # literal bytes, or stream index
    bufs, regs, tbls = [], [], []
    total = 0
    last = False
    while not last:
        if pos + 3 > len(frame):
            raise zf.ZstdFormatError("truncated block header")
        bh = int.from_bytes(frame[pos : pos + 3], "little")
        pos += 3
        last = bool(bh & 1)
        btype = (bh >> 1) & 3
        size = bh >> 3
        if btype == 0:
            if pos + size > len(frame):
                raise zf.ZstdFormatError("truncated raw block")
            pieces.append(frame[pos : pos + size])
            pos += size
            total += size
        elif btype == 1:
            if pos + 1 > len(frame):
                raise zf.ZstdFormatError("truncated RLE block")
            total += size
            if total <= limit:  # guard before the *size multiplication
                pieces.append(frame[pos : pos + 1] * size)
            pos += 1
        elif btype == 2:
            nbits, streams = zf.split_compressed_block(
                frame[pos : pos + size]
            )
            pos += size
            tbl = zf.decode_table(nbits)
            for buf, rg in streams:
                pieces.append(len(bufs))
                bufs.append(buf)
                regs.append(rg)
                tbls.append(tbl)
                total += rg
        else:
            raise zf.ZstdFormatError("reserved block type")
        if total > limit:
            if declared is not None:
                raise ValueError(
                    f"zstd frame inflates past its declared size "
                    f"({declared}): corrupt or hostile frame"
                )
            raise ValueError(
                f"zstd frame has no declared content size and inflates "
                f"past the configured limit ({limit})"
            )
    if pos != len(frame):
        raise zf.ZstdFormatError("trailing bytes after last block")
    if declared is not None and total != declared:
        raise ValueError(
            f"zstd frame regenerates {total} bytes, header declared "
            f"{declared}"
        )
    decoded = decode_streams(bufs, regs, tbls) if bufs else []
    return b"".join(
        p if isinstance(p, bytes) else decoded[p] for p in pieces
    )


def uncompress_zstd(data: bytes) -> bytes:
    """Device-side zstd decompress with byte-for-byte host punt for any
    frame shape outside the kernel profile (dict frames, FSE trees,
    sequences, 1-stream literals, multi-frame inputs). Only the host
    walk's ZstdFormatError punts: decode_streams raises a plain
    ValueError and a kernel failure a KernelError, and both propagate."""
    from . import _zstd_uncompress_host, zstd_frame as zf

    try:
        return _decompress_device(data)
    except zf.ZstdFormatError:
        return _zstd_uncompress_host(data)


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
