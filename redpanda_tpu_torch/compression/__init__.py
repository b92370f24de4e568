"""Compression registry (reference: src/v/compression/compression.h:21).

`compress(data, type)` / `uncompress(data, type)` dispatch over the same
codec set the reference supports — gzip, snappy (java framing), lz4
(frame format), zstd — with `CompressionType` values matching the Kafka
record-batch attribute bits (reference: src/v/model/compression.h).

Like the reference's registry (which the north-star `backend=tpu` codec
slots behind), device-side codecs can be registered at runtime via
`register_backend`; the host path stays intact when none is registered.
"""

from __future__ import annotations

import enum
import os
import threading
import zlib
from typing import Callable

try:
    import zstandard
except ImportError:  # gated: image may lack the wheel; zstd raises at use
    zstandard = None

from . import lz4_codec, snappy_codec, zstd_frame


class CompressionType(enum.IntEnum):
    """Matches Kafka batch attribute low bits and the reference's
    model::compression enum."""

    none = 0
    gzip = 1
    snappy = 2
    lz4 = 3
    zstd = 4


def _gzip_compress(data: bytes) -> bytes:
    co = zlib.compressobj(level=zlib.Z_DEFAULT_COMPRESSION, wbits=31)
    return co.compress(data) + co.flush()


def _gzip_uncompress(data: bytes) -> bytes:
    # wbits=47: accept zlib or gzip wrappers, like the reference's
    # gzip_compressor tolerates both.
    return zlib.decompress(data, wbits=47)


# Per-thread zstd contexts: zstandard contexts are not thread-safe and
# release the GIL mid-(de)compress. The reference allocates per-core
# workspaces for the same reason (redpanda/application.cc:408-416).
_zstd_tls = threading.local()


def _zstd_ctx() -> tuple:
    if zstandard is None:
        raise RuntimeError(
            "zstd codec unavailable: the zstandard module is not installed"
        )
    ctx = getattr(_zstd_tls, "ctx", None)
    if ctx is None:
        ctx = (zstandard.ZstdCompressor(level=3), zstandard.ZstdDecompressor())
        _zstd_tls.ctx = ctx
    return ctx


# zstd leg selection (the device-codec seam): RP_ZSTD_BACKEND=tpu selects
# the device kernel, which raises until it is ported to CUDA; "host" — the
# default and the differential oracle — keeps the zstandard contexts.
# Read at call time so tests and the bench A/B can flip it per-call.
def _zstd_backend() -> str:
    return os.environ.get("RP_ZSTD_BACKEND", "host").strip().lower()


# Decompress-bomb guard: a hostile archived chunk must not balloon
# memory on hydration. Frames that declare a content size are capped AT
# that size (a frame inflating past its own header is corruption, never
# an allocation); frames without one are refused past this output
# limit. Applied by BOTH legs before any codec context is touched.
_ZSTD_NOSIZE_LIMIT_DEFAULT = 1 << 26  # 64 MiB


def _zstd_nosize_limit() -> int:
    return int(
        os.environ.get("RP_ZSTD_NOSIZE_LIMIT", _ZSTD_NOSIZE_LIMIT_DEFAULT)
    )


def zstd_declared_size(data: bytes) -> "int | None":
    """Declared frame content size, or None (absent / unparseable)."""
    return zstd_frame.frame_content_size(data)


def _device_codec_not_ported() -> None:
    # the device zstd codec (ops/zstd.py in the JAX package) has no CUDA
    # kernel yet: refuse rather than quietly take the host leg
    raise NotImplementedError(
        "RP_ZSTD_BACKEND=tpu: the device codecs are not ported to CUDA yet "
        "(ROADMAP.md, port queue: codecs)"
    )


def _zstd_compress(data: bytes) -> bytes:
    if _zstd_backend() == "tpu":
        _device_codec_not_ported()
    return _zstd_compress_host(data)


def _zstd_compress_host(data: bytes) -> bytes:
    return _zstd_ctx()[0].compress(data)


def _zstd_uncompress(data: bytes) -> bytes:
    if _zstd_backend() == "tpu":
        _device_codec_not_ported()
    return _zstd_uncompress_host(data)


def _zstd_uncompress_host(data: bytes) -> bytes:
    declared = zstd_declared_size(data)
    limit = _zstd_nosize_limit()
    d = _zstd_ctx()[1]
    if declared is None:
        # No declared size: the streaming path is unbounded, so inflate
        # through decompress() whose max_output_size errors out instead
        # of allocating past the configured ceiling.
        return d.decompress(data, max_output_size=limit)
    out = d.decompress(data, max_output_size=max(declared, 1))
    if len(out) != declared:
        raise ValueError(
            f"zstd frame regenerated {len(out)} bytes, header declared "
            f"{declared}"
        )
    return out


_COMPRESSORS: dict[CompressionType, Callable[[bytes], bytes]] = {
    CompressionType.none: lambda d: d,
    CompressionType.gzip: _gzip_compress,
    CompressionType.snappy: snappy_codec.compress_java,
    CompressionType.lz4: lz4_codec.compress_frame,
    CompressionType.zstd: _zstd_compress,
}

_UNCOMPRESSORS: dict[CompressionType, Callable[[bytes], bytes]] = {
    CompressionType.none: lambda d: d,
    CompressionType.gzip: _gzip_uncompress,
    CompressionType.snappy: snappy_codec.decompress_java,
    CompressionType.lz4: lz4_codec.decompress_frame,
    CompressionType.zstd: _zstd_uncompress,
}

# Optional accelerator backend (the `backend=tpu` seam). Maps
# CompressionType -> (compress, uncompress); consulted first when set.
_backend: dict[CompressionType, tuple[Callable, Callable]] = {}


def register_backend(
    ctype: CompressionType,
    compress_fn: Callable[[bytes], bytes],
    uncompress_fn: Callable[[bytes], bytes],
) -> None:
    _backend[ctype] = (compress_fn, uncompress_fn)


def clear_backend() -> None:
    _backend.clear()


def compress(data: bytes, ctype: CompressionType | int) -> bytes:
    ctype = CompressionType(ctype)
    if ctype in _backend:
        return _backend[ctype][0](data)
    return _COMPRESSORS[ctype](data)


def uncompress(data: bytes, ctype: CompressionType | int) -> bytes:
    ctype = CompressionType(ctype)
    if ctype in _backend:
        return _backend[ctype][1](data)
    return _UNCOMPRESSORS[ctype](data)
