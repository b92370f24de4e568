"""tests/test_zstd_device.py run on the port: the device zstd leg
against stock zstd, the registry seam, punt shapes and the
decompress-bomb guard.

The reference file is copied with its imports pointed at
redpanda_tpu_torch; an autouse fixture points the codec entries, which
take the card by default in the port, at the CPU (the kernels' plain
versions; chip_smoke.py holds the CUDA kernels against those).
Carried: every case but one, with the reference's own conditional
skips on the zstandard wheel / libzstd. Left out:
`test_ratio_within_10pct_of_host_on_bench_corpus` — it imports the
root `bench.py` (the JAX package's benchmark) for its corpus, which
the port does not have.
"""

import ctypes
import ctypes.util
import random
import struct

import numpy as np
import pytest

from redpanda_tpu_torch import compression
from redpanda_tpu_torch.compression import (
    CompressionType,
    tpu_backend,
    zstd_frame as zf,
)
from redpanda_tpu_torch.ops.fused import crc_zstd_fused
from redpanda_tpu_torch.ops.zstd import encode_chunks
from redpanda_tpu_torch.utils import crc as host_crc
from redpanda_tpu_torch.ops import default_device

try:
    import zstandard as _zstd_wheel
except ImportError:
    _zstd_wheel = None


class _LibZstd:
    """Minimal ctypes bridge to the system libzstd — the stock-decoder
    oracle for images that bake the shared library but not the wheel."""

    def __init__(self, lib: ctypes.CDLL) -> None:
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
            ctypes.c_size_t,
        ]
        lib.ZSTD_compress.restype = ctypes.c_size_t
        lib.ZSTD_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
            ctypes.c_size_t, ctypes.c_int,
        ]
        lib.ZSTD_compressBound.restype = ctypes.c_size_t
        lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
        self._lib = lib

    def decompress(self, frame: bytes, capacity: int) -> bytes:
        buf = ctypes.create_string_buffer(max(capacity, 1))
        r = self._lib.ZSTD_decompress(buf, capacity, frame, len(frame))
        if self._lib.ZSTD_isError(r):
            raise ValueError(f"libzstd decompress error ({r})")
        return buf.raw[:r]

    def compress(self, data: bytes, level: int = 3) -> bytes:
        cap = self._lib.ZSTD_compressBound(len(data))
        buf = ctypes.create_string_buffer(cap)
        r = self._lib.ZSTD_compress(buf, cap, data, len(data), level)
        if self._lib.ZSTD_isError(r):
            raise ValueError(f"libzstd compress error ({r})")
        return buf.raw[:r]


def _load_libzstd() -> "_LibZstd | None":
    name = ctypes.util.find_library("zstd")
    if not name:
        return None
    try:
        return _LibZstd(ctypes.CDLL(name))
    except OSError:
        return None


_LIB = _load_libzstd()


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's device codec entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


def _stock_decompress(frame: bytes, expect_len: int) -> bytes:
    if _zstd_wheel is not None:
        return _zstd_wheel.ZstdDecompressor().decompress(
            frame, max_output_size=max(expect_len, 1)
        )
    assert _LIB is not None
    return _LIB.decompress(frame, expect_len)


def _stock_compress(data: bytes) -> bytes:
    if _zstd_wheel is not None:
        return _zstd_wheel.ZstdCompressor(level=3).compress(data)
    assert _LIB is not None
    return _LIB.compress(data)


have_stock = pytest.mark.skipif(
    _zstd_wheel is None and _LIB is None,
    reason="neither the zstandard wheel nor libzstd is available",
)
have_wheel = pytest.mark.skipif(
    _zstd_wheel is None, reason="zstandard wheel not installed"
)
wheel_absent = pytest.mark.skipif(
    _zstd_wheel is not None, reason="zstandard wheel IS installed"
)

_JSON = b'{"key":"user-000001","topic":"orders","seq":12345,"flag":true},'


def _varinted(base: bytes, rng: random.Random, gap: int = 137) -> bytes:
    """Sprinkle bytes >= 0x80 the way record-batch varint framing does —
    the shape that forces FSE-compressed weight descriptions."""
    b = bytearray(base)
    for i in range(0, len(b), gap):
        b[i] = 0x80 | rng.randrange(128)
    return bytes(b)


def _payloads() -> dict:
    rng = random.Random(7)
    return {
        "empty": b"",
        "one": b"Z",
        "below_huffman_min": b"ab" * 31,  # 62 < MIN_HUFFMAN_LEN
        "rle": b"\x00" * 4096,
        "rle_high": b"\xfe" * 70000,  # multi-block, RLE per block
        "text": b"the quick brown fox jumps over the lazy dog. " * 90,
        "json": _JSON * 120,
        "json_varint": _varinted(_JSON * 120, rng),
        "random": bytes(rng.getrandbits(8) for _ in range(3000)),
        "wide_alphabet": bytes(
            rng.choice(range(120, 256)) for _ in range(2000)
        ),
        "block_edge": _JSON * (65536 // len(_JSON) + 1),  # > one block
        "multi_block": _varinted((_JSON * 4000)[:200000], rng),
    }


def test_frames_roundtrip_reference():
    for name, data in _payloads().items():
        frame = tpu_backend.compress_zstd(data)
        assert zf.frame_content_size(frame) == len(data), name
        assert zf.reference_decompress(frame) == data, name
        assert tpu_backend._decompress_device(frame) == data, name


@have_stock
def test_frames_decode_under_stock_zstd():
    for name, data in _payloads().items():
        frame = tpu_backend.compress_zstd(data)
        assert _stock_decompress(frame, len(data)) == data, name


def test_high_alphabet_engages_compression():
    # Regression: symbols > 128 exceed the direct weight description;
    # the FSE-compressed description must keep the block compressed
    # instead of punting the chunk to raw.
    rng = random.Random(3)
    data = _varinted(_JSON * 120, rng)
    nbits, _streams = encode_chunks([data])[0]
    assert int(np.nonzero(nbits)[0][-1]) > zf.MAX_DIRECT_SYMBOL
    assert zf.direct_weights_desc(nbits) is None
    assert zf.fse_weights_desc(nbits) is not None
    frame = tpu_backend.compress_zstd(data)
    assert len(frame) < 0.8 * len(data)
    assert zf.reference_decompress(frame) == data


def test_fse_weight_description_roundtrip():
    rng = random.Random(9)
    for trial in range(40):
        alpha = rng.sample(range(256), rng.randrange(16, 257))
        data = bytes(rng.choice(alpha) for _ in range(1500))
        nbits, _ = encode_chunks([data])[0]
        desc = zf.fse_weights_desc(nbits)
        if desc is None:  # FSE-degenerate weight runs fall back to raw
            continue
        assert desc[0] == len(desc) - 1 < 128
        got, pos = zf.parse_tree_description(desc, 0)
        assert pos == len(desc)
        assert np.array_equal(got, np.asarray(nbits, np.int64)), trial


@have_stock
def test_differential_fuzz_10k():
    """>= 10k device frames, every one decoded by stock zstd and a
    sample re-checked against the host reference decoder."""
    rng = random.Random(1234)
    cases: list = []
    for i in range(10000):
        kind = i % 5
        if kind == 0:  # compressible json with varint-style high bytes
            n = rng.randrange(1, 1500)
            cases.append(
                _varinted((_JSON * (n // len(_JSON) + 1))[:n], rng,
                          gap=rng.randrange(60, 300))
            )
        elif kind == 1:  # narrow random alphabet
            alpha = rng.sample(range(256), rng.randrange(2, 40))
            cases.append(
                bytes(rng.choice(alpha) for _ in range(rng.randrange(1, 800)))
            )
        elif kind == 2:  # wide random alphabet
            alpha = rng.sample(range(256), rng.randrange(40, 257))
            cases.append(
                bytes(rng.choice(alpha) for _ in range(rng.randrange(1, 800)))
            )
        elif kind == 3:  # runs and repeats
            pat = bytes(rng.getrandbits(8) for _ in range(rng.randrange(1, 9)))
            cases.append(pat * rng.randrange(1, 300))
        else:  # edge sizes around the huffman floor and tiny frames
            n = rng.choice([0, 1, 2, 63, 64, 65, 255, 256, 257])
            cases.append(bytes(rng.getrandbits(8) for _ in range(n)))
    # batch by size so one big chunk doesn't widen every bucket
    order = sorted(range(len(cases)), key=lambda i: len(cases[i]))
    frames: dict = {}
    for at in range(0, len(order), 500):
        idx = order[at : at + 500]
        for i, frame in zip(idx, tpu_backend.compress_many_zstd(
                [cases[i] for i in idx])):
            frames[i] = frame
    for i, data in enumerate(cases):
        assert _stock_decompress(frames[i], len(data)) == data, i
        if i % 25 == 0:
            assert zf.reference_decompress(frames[i]) == data, i


@have_stock
def test_stock_frames_through_device_path():
    # Stock-compressed frames either decode on the device path or punt
    # with ZstdFormatError (sequences are outside the profile) — never
    # wrong bytes, never a non-format exception.
    rng = random.Random(21)
    for n in (1, 50, 400, 5000, 70000):
        data = _varinted((_JSON * (n // len(_JSON) + 1))[:n], rng)
        stock = _stock_compress(data)
        try:
            assert tpu_backend._decompress_device(stock) == data
        except zf.ZstdFormatError:
            pass


@have_wheel
def test_device_and_host_legs_cross_decode(monkeypatch):
    data = _varinted(_JSON * 300, random.Random(2))
    monkeypatch.setenv("RP_ZSTD_BACKEND", "host")
    host = compression.compress(data, CompressionType.zstd)
    monkeypatch.setenv("RP_ZSTD_BACKEND", "tpu")
    dev = compression.compress(data, CompressionType.zstd)
    assert compression.uncompress(host, CompressionType.zstd) == data
    assert compression.uncompress(dev, CompressionType.zstd) == data
    monkeypatch.setenv("RP_ZSTD_BACKEND", "host")
    assert compression.uncompress(dev, CompressionType.zstd) == data
    assert compression.uncompress(host, CompressionType.zstd) == data


@wheel_absent
def test_host_leg_stands_down_without_wheel(monkeypatch):
    # RP_ZSTD_BACKEND=host (also the default) must fail loudly, not
    # fall back to the device leg behind the operator's back.
    data = _JSON * 10
    for env in ("host", None):
        if env is None:
            monkeypatch.delenv("RP_ZSTD_BACKEND", raising=False)
        else:
            monkeypatch.setenv("RP_ZSTD_BACKEND", env)
        with pytest.raises(RuntimeError, match="zstandard"):
            compression.compress(data, CompressionType.zstd)
    monkeypatch.setenv("RP_ZSTD_BACKEND", "tpu")
    frame = compression.compress(data, CompressionType.zstd)
    assert compression.uncompress(frame, CompressionType.zstd) == data


def test_punt_shapes_raise_format_error():
    data = _JSON * 40
    frame = tpu_backend.compress_zstd(data)
    # skippable frame
    skip = struct.pack("<II", 0x184D2A50, 4) + b"\x00" * 4
    with pytest.raises(zf.ZstdFormatError):
        tpu_backend._decompress_device(skip)
    # dictionary frame: set a Dictionary_ID_Flag in the FHD
    dframe = frame[:4] + bytes([frame[4] | 1]) + b"\x07" + frame[5:]
    with pytest.raises(zf.ZstdFormatError):
        tpu_backend._decompress_device(dframe)
    # multi-frame input (trailing bytes after the last block)
    with pytest.raises(zf.ZstdFormatError):
        tpu_backend._decompress_device(frame + frame)
    # reserved block type 3
    bad = bytearray(tpu_backend.compress_zstd(b""))
    bad[-3:] = struct.pack("<I", 1 | (3 << 1))[:3]
    with pytest.raises(zf.ZstdFormatError):
        tpu_backend._decompress_device(bytes(bad))
    # truncated compressed block
    with pytest.raises(zf.ZstdFormatError):
        tpu_backend._decompress_device(frame[: len(frame) - 5])
    # not zstd at all
    with pytest.raises(zf.ZstdFormatError):
        tpu_backend._decompress_device(b"\x00" * 16)


def test_bomb_guard_declared_size_lies():
    # Frame declares 16 bytes but its RLE block regenerates 1 MiB: the
    # guard must trip on declared-vs-regenerated BEFORE materializing.
    frame = zf.frame_header(16) + zf.rle_block(0x41, 1 << 20, True)
    with pytest.raises(ValueError, match="inflates past"):
        tpu_backend._decompress_device(frame)


def test_bomb_guard_missing_content_size(monkeypatch):
    # Window_Descriptor header with NO content size: the configurable
    # ceiling applies instead of the declared size.
    fhd = 0  # fcs_code 0, not single-segment, no dict
    header = struct.pack("<IBB", zf.MAGIC, fhd, 0x88)  # 16 MiB window
    frame = header + zf.rle_block(0x42, 1 << 20, True)
    assert zf.frame_content_size(frame) is None
    monkeypatch.setenv("RP_ZSTD_NOSIZE_LIMIT", "65536")
    with pytest.raises(ValueError, match="no declared content size"):
        tpu_backend._decompress_device(frame)
    monkeypatch.setenv("RP_ZSTD_NOSIZE_LIMIT", str(1 << 21))
    assert tpu_backend._decompress_device(frame) == b"\x42" * (1 << 20)


def test_bomb_guard_regenerated_size_mismatch():
    frame = zf.frame_header(1 << 20) + zf.rle_block(0x43, 100, True)
    with pytest.raises(ValueError, match="regenerates"):
        tpu_backend._decompress_device(frame)


def test_fused_crc_zstd_matches_host_crc():
    rng = np.random.default_rng(11)
    bodies = []
    for i in range(18):
        if i % 3 == 0:
            bodies.append(
                rng.integers(0, 256, int(rng.integers(32, 4000)))
                .astype(np.uint8).tobytes()
            )
        else:
            bodies.append((b"abcd%d," % i) * int(rng.integers(8, 500)))
    prefixes = [bytes(rng.integers(0, 256, 40, np.uint8)) for _ in bodies]
    crcs, frames = crc_zstd_fused(prefixes, bodies)
    for p, b, c, frame in zip(prefixes, bodies, crcs, frames):
        assert int(c) == host_crc.crc32c(b, host_crc.crc32c(p))
        assert zf.reference_decompress(frame) == b
        if _zstd_wheel is not None or _LIB is not None:
            assert _stock_decompress(frame, len(b)) == b


def test_block_size_knob(monkeypatch):
    data = _varinted(_JSON * 200, random.Random(5))  # ~12.6 KiB
    monkeypatch.setenv("RP_ZSTD_BLOCK", "1024")
    assert tpu_backend._zstd_block_size() == 1024
    frame = tpu_backend.compress_zstd(data)
    assert zf.reference_decompress(frame) == data
    # count blocks: 3-byte headers walked the same way the decoder does
    declared, pos = zf.parse_frame_header(frame)
    nblocks, last = 0, False
    while not last:
        bh = int.from_bytes(frame[pos : pos + 3], "little")
        last, btype, size = bool(bh & 1), (bh >> 1) & 3, bh >> 3
        pos += 3 + (1 if btype == 1 else size)
        nblocks += 1
    assert nblocks == (len(data) + 1023) // 1024
    # clamping: floor 1 KiB, ceiling 64 KiB (the kernel bucket cap)
    monkeypatch.setenv("RP_ZSTD_BLOCK", "7")
    assert tpu_backend._zstd_block_size() == 1024
    monkeypatch.setenv("RP_ZSTD_BLOCK", str(1 << 22))
    assert tpu_backend._zstd_block_size() == 65536
