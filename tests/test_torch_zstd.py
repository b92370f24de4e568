"""Port vs reference: the device zstd codec (huff0 encode and decode).

Seeded inputs go through the JAX package (its jitted programs on the
CPU, as tests/test_zstd_device.py runs them) and through
redpanda_tpu_torch on the CPU (the plain PyTorch versions, with the
port's `ops.default_device` set to "cpu"). Every output is integer or bytes,
so every comparison is exact: code lengths, all SB bytes of every
stream, stream bit counts, decoded rows and `end` on every row, the
decode errors, frames, fused CRCs and recompressed record batches.

The CUDA kernels of csrc/zstd.cu cannot run here. Their schemes are
replayed in Python below and held against the plain versions and the
JAX programs: the encode's cluster of four CTAs a row at both launch
shapes (quarters staged at their alignment, per-warp histograms of
runs of units, the Kraft down loop in closed form and the up loop as a
walk down the levels, codes from packed per-lane counts scanned over a
warp, 4-symbol packed codes placed by a warp scan into an image at the
stream row's alignment), the closed form also against the JAX loops
on seeded and fixed count vectors; and the decoder's grouped walk: one
stream per thread, four threads per table, the 64-bit window of 32-bit
words, the ring of words staged ahead (its reads and refills checked),
the select-only window step and the unclamped position.
"""

import ctypes
import ctypes.util
import random
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from redpanda_tpu import compression as jcompression
from redpanda_tpu.compression import tpu_backend as jbackend
from redpanda_tpu.models import record as jrecord
from redpanda_tpu.ops import fused as jfused
from redpanda_tpu.ops import zstd as jz
from redpanda_tpu_torch import compression as tcompression
from redpanda_tpu_torch.compression import CompressionType
from redpanda_tpu_torch.compression import tpu_backend as tbackend
from redpanda_tpu_torch.compression import zstd_frame as zf
from redpanda_tpu_torch.models import record as trecord
from redpanda_tpu_torch.ops import _build
from redpanda_tpu_torch.ops import crc32c as tcrc
from redpanda_tpu_torch.ops import default_device
from redpanda_tpu_torch.ops import fused as tfused
from redpanda_tpu_torch.ops import zstd as tz
from redpanda_tpu_torch.utils import crc as host_crc

BUCKETS = (256, 4096, 65536)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


class _LibZstd:
    """Minimal ctypes bridge to the system libzstd, the stock decoder."""

    def __init__(self, lib: ctypes.CDLL) -> None:
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
        ]
        self._lib = lib

    def decompress(self, frame: bytes, capacity: int) -> bytes:
        buf = ctypes.create_string_buffer(max(capacity, 1))
        r = self._lib.ZSTD_decompress(buf, capacity, frame, len(frame))
        if self._lib.ZSTD_isError(r):
            raise ValueError(f"libzstd decompress error ({r})")
        return buf.raw[:r]


def _load_libzstd():
    name = ctypes.util.find_library("zstd")
    if not name:
        return None
    try:
        return _LibZstd(ctypes.CDLL(name))
    except OSError:
        return None


_LIB = _load_libzstd()

_JSON = b'{"key":"user-000001","topic":"orders","seq":12345,"flag":true},'


def _varinted(base: bytes, rng: random.Random, gap: int = 137) -> bytes:
    b = bytearray(base)
    for i in range(0, len(b), gap):
        b[i] = 0x80 | rng.randrange(128)
    return bytes(b)


def _payloads() -> dict:
    """The payload set of tests/test_zstd_device.py."""
    rng = random.Random(7)
    return {
        "empty": b"",
        "one": b"Z",
        "below_huffman_min": b"ab" * 31,
        "rle": b"\x00" * 4096,
        "rle_high": b"\xfe" * 70000,
        "text": b"the quick brown fox jumps over the lazy dog. " * 90,
        "json": _JSON * 120,
        "json_varint": _varinted(_JSON * 120, rng),
        "random": bytes(rng.getrandbits(8) for _ in range(3000)),
        "wide_alphabet": bytes(rng.choice(range(120, 256)) for _ in range(2000)),
        "block_edge": _JSON * (65536 // len(_JSON) + 1),
        "multi_block": _varinted((_JSON * 4000)[:200000], rng),
    }


def _seed_sum(row: bytes) -> int:
    """sum(u) after the Kraft seed, before either repair loop."""
    counts = np.bincount(np.frombuffer(row, np.uint8), minlength=256)
    v = max(len(row), 1)
    q = np.clip((counts * 2048 + v - 1) // v, 1, 2048)
    u = np.where(counts > 0, np.minimum(1 << np.floor(np.log2(q)).astype(int), 1024), 0)
    return int(u.sum())


def _edge_rows(n: int, seed: int = 0) -> list:
    """chip_smoke's edge rows of one bucket: short lengths around the
    huff0 floor and the 4-stream split, one- and two-symbol rows, a
    uniform 256-symbol row, 200 rare symbols, the Kraft down-loop row,
    skewed and random full rows."""
    return chip_smoke.zstd_edge_rows(np.random.default_rng(seed + n), n)


def _stage(rows, n: int):
    batch = np.zeros((len(rows), n), np.uint8)
    valid = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        batch[i, : len(r)] = np.frombuffer(r, np.uint8)
        valid[i] = len(r)
    return batch, valid


def _encode_both(rows, n):
    batch, valid = _stage(rows, n)
    got = [t.numpy() for t in tz._encode_chunks(torch.from_numpy(batch), torch.from_numpy(valid), n)]
    want = [np.asarray(a) for a in jz._encode_chunks(jnp.asarray(batch), jnp.asarray(valid), n)]
    return got, want


def test_down_loop_row_overshoots():
    """The edge rows of the larger buckets hold a row whose Kraft seed
    overshoots 2,048 slots by 100, so the down loop runs 100 steps."""
    for n in (4096, 65536):
        assert _seed_sum(chip_smoke.kraft_down_row(np.random.default_rng(0), n)) == 2148
        assert 2148 in [_seed_sum(r) for r in _edge_rows(n)]


@pytest.mark.parametrize("n", BUCKETS)
def test_encode_matches_jax(n):
    rows = _edge_rows(n)
    (nbits, streams, bits), (jnbits, jstreams, jbits) = _encode_both(rows, n)
    assert streams.shape == (len(rows), 4, tz.stream_byte_bound(n))
    np.testing.assert_array_equal(nbits, jnbits)
    np.testing.assert_array_equal(bits, jbits)
    np.testing.assert_array_equal(streams, jstreams)
    # every row of two or more symbols gets code lengths that fill the 2^11 slots exactly
    for r, nb in zip(rows, nbits.astype(np.int64)):
        if len(set(r)) >= 2:
            assert int((1 << (11 - nb[nb > 0])).sum()) == 2048


def _stream_set(rows, n):
    """Every stream of the rows' blocks that the host would compress,
    with its regenerated size and decode table."""
    (nbits, streams, bits), _ = _encode_both(rows, n)
    return chip_smoke.stream_items(rows, nbits, streams, bits)


def _per_stream(bufs, tbits, regen, tsym, tnb, index):
    """The staged matrices with one table per stream (the JAX signature)."""
    return bufs, tbits, regen, tsym[index], tnb[index]


def _decode_both(items):
    """The port's staged decode (each table object once) and the JAX
    program (one table per stream) on the same streams; the port's
    JAX-signature entry on the per-stream matrices must give the staged
    decode's outputs."""
    *m, sbytes, rmax = tz.stage_streams(*zip(*items))
    groups = torch.from_numpy(tz.decode_groups(m[5]))
    got = [t.numpy() for t in tz.decode_staged(*(torch.from_numpy(a) for a in m), sbytes, rmax, groups)]
    per = _per_stream(*m)
    alone = [t.numpy() for t in tz._decode_streams(*(torch.from_numpy(a) for a in per), sbytes, rmax)]
    for a, b in zip(alone, got):
        np.testing.assert_array_equal(a, b)
    want = [np.asarray(a) for a in jz._decode_streams(*(jnp.asarray(a) for a in per), sbytes, rmax)]
    return got, want


def _trap_streams(items):
    """A tampered stream (an extra byte past the marker: end != 0), a
    truncated one (its top half: it runs out and sticks at bit 0), a
    regen = 0 stream with tbits > 0, and a stream asked for more symbols
    than it holds."""
    (s0, rg0, t0), (s1, rg1, t1), (s2, _, t2), (s3, rg3, t3) = items[:4]
    return [
        (s0 + b"\x05", rg0, t0),
        (s1[len(s1) // 2 :], rg1, t1),
        (s2, 0, t2),
        (s3, rg3 + 40, t3),
    ]


@pytest.mark.parametrize("n", BUCKETS)
def test_decode_matches_jax(n):
    items = _stream_set(_edge_rows(n), n)
    items += _trap_streams(items)
    (out, end), (jout, jend) = _decode_both(items)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(end, jend)
    k = len(items) - 4
    assert not end[:k].any()
    assert end[k] != 0  # tampered
    assert end[k + 1] == 0 and out[k + 1, items[k + 1][1] - 1] == out[k + 1, items[k + 1][1] - 2]
    assert end[k + 2] > 0  # regen 0 reports f[tbits]
    assert not out[k + 2].any()


def test_decode_errors_match_jax():
    items = _stream_set(_edge_rows(4096), 4096)
    traps = _trap_streams(items)
    batch = items[:5] + [traps[0]] + items[5:9] + [traps[2]]
    args = [list(x) for x in zip(*batch)]
    with pytest.raises(ValueError) as got:
        tz.decode_streams(*args)
    with pytest.raises(ValueError) as want:
        jz.decode_streams(*args)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("huffman stream 5 did not consume its bits exactly")
    assert type(got.value) is ValueError  # never a ZstdFormatError, which would punt
    # truncation sticks at 0 and is not an error, in the reference as in the port
    trunc = [list(x) for x in zip(items[0], traps[1])]
    assert tz.decode_streams(*trunc) == jz.decode_streams(*trunc)
    for bad in (b"", items[0][0][:-1] + b"\x00"):
        args = [[bad], [10], [items[0][2]]]
        with pytest.raises(ValueError, match="missing its end marker") as got:
            tz.decode_streams(*args)
        with pytest.raises(ValueError, match="missing its end marker"):
            jz.decode_streams(*args)


def test_encode_entry_matches_jax_and_limit():
    rows = _edge_rows(4096, seed=3)
    got = tz.encode_chunks(rows)
    want = jz.encode_chunks(rows)
    assert len(got) == len(want)
    for (nb, st), (jnb, jst) in zip(got, want):
        np.testing.assert_array_equal(nb, jnb)
        assert st == jst
    with pytest.raises(ValueError, match="device zstd chunks must be <= 64 KiB"):
        tz.encode_chunks([b"x" * 65537])
    assert tz.encode_chunks([]) == [] and tz.decode_streams([], [], []) == []


def test_encode_reads_rows_in_place():
    """The encode at column offset 40 of wider rows equals the encode of
    the same chunks staged alone."""
    rows = _edge_rows(4096, seed=5)
    batch, valid = _stage(rows, 4096)
    wide = np.full((len(rows), 40 + 4096 + 472), 0x5A, np.uint8)
    wide[:, 40 : 40 + 4096] = batch
    got = tz._encode_chunks(torch.from_numpy(wide), torch.from_numpy(valid), 4096, 40)
    want = tz._encode_chunks(torch.from_numpy(batch), torch.from_numpy(valid), 4096)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_frames_match_jax_and_decode():
    payloads = _payloads()
    frames = tbackend.compress_many_zstd(list(payloads.values()))
    jframes = jbackend.compress_many_zstd(list(payloads.values()))
    assert frames == jframes
    for (name, data), frame in zip(payloads.items(), frames):
        assert tbackend.compress_zstd(data) == frame, name
        assert zf.reference_decompress(frame) == data, name
        assert tbackend._decompress_device(frame) == data, name
        assert jbackend._decompress_device(frame) == data, name
        if _LIB is not None:
            assert _LIB.decompress(frame, len(data)) == data, name


def test_block_size_knob_matches_jax(monkeypatch):
    data = _varinted(_JSON * 200, random.Random(5))
    for knob, size in (("1024", 1024), ("7", 1024), (str(1 << 22), 65536)):
        monkeypatch.setenv("RP_ZSTD_BLOCK", knob)
        assert tbackend._zstd_block_size() == jbackend._zstd_block_size() == size
    monkeypatch.setenv("RP_ZSTD_BLOCK", "1024")
    frame = tbackend.compress_zstd(data)
    assert frame == jbackend.compress_zstd(data)
    assert tbackend._decompress_device(frame) == data


def test_fused_matches_jax_and_host_crc():
    rng = np.random.default_rng(11)
    bodies = [b""]
    for i in range(13):
        if i % 3 == 0:
            bodies.append(rng.integers(0, 256, int(rng.integers(32, 4000)), dtype=np.uint8).tobytes())
        else:
            bodies.append((b"abcd%d," % i) * int(rng.integers(8, 500)))
    prefixes = [rng.integers(0, 256, 40, dtype=np.uint8).tobytes() for _ in bodies]
    crcs, frames = tfused.crc_zstd_fused(prefixes, bodies)
    jcrcs, jframes = jfused.crc_zstd_fused(prefixes, bodies)
    assert crcs.dtype == np.uint32
    np.testing.assert_array_equal(crcs, np.asarray(jcrcs))
    assert frames == jframes
    for p, b, c, frame in zip(prefixes, bodies, crcs, frames):
        assert int(c) == host_crc.crc32c(b, host_crc.crc32c(p))
        assert zf.reference_decompress(frame) == b
    with pytest.raises(ValueError, match="fused codec bodies must be <= 64 KiB"):
        tfused.crc_zstd_fused([b"\x00" * 40], [b"x" * 65537])


def test_fused_encode_equals_plain_encode():
    """_fused_zstd's encode outputs at offset 40 equal `_encode_chunks`
    of the bodies alone, and its CRC the host's."""
    rows = _edge_rows(4096, seed=9)
    width = ((40 + 4096 + 511) // 512) * 512
    mat = np.zeros((len(rows), width), np.uint8)
    mat[:, :40] = 0x11
    for i, r in enumerate(rows):
        mat[i, 40 : 40 + len(r)] = np.frombuffer(r, np.uint8)
    batch, valid = _stage(rows, 4096)
    crc, *enc = tfused._fused_zstd(torch.from_numpy(mat), torch.from_numpy(valid), 4096)
    want = tz._encode_chunks(torch.from_numpy(batch), torch.from_numpy(valid), 4096)
    for g, w in zip(enc, want):
        assert torch.equal(g, w)
    assert [int(c) for c in crc] == [host_crc.crc32c(r, host_crc.crc32c(b"\x11" * 40)) for r in rows]


BAD_FRAMES = ("skippable", "dictionary", "multi_frame", "reserved_block", "truncated",
              "not_zstd", "declared_lies", "no_size", "size_mismatch")


def _bad_frame(case: str) -> bytes:
    frame = jbackend.compress_zstd(_JSON * 40)
    bad = bytearray(zf.frame_header(0) + zf.raw_block(b"", True))
    bad[-3:] = struct.pack("<I", 1 | (3 << 1))[:3]
    header = struct.pack("<IBB", zf.MAGIC, 0, 0x88)  # no content size
    return {
        "skippable": struct.pack("<II", 0x184D2A50, 4) + b"\x00" * 4,
        "dictionary": frame[:4] + bytes([frame[4] | 1]) + b"\x07" + frame[5:],
        "multi_frame": frame + frame,
        "reserved_block": bytes(bad),
        "truncated": frame[: len(frame) - 5],
        "not_zstd": b"\x00" * 16,
        "declared_lies": zf.frame_header(16) + zf.rle_block(0x41, 1 << 20, True),
        "no_size": header + zf.rle_block(0x42, 1 << 20, True),
        "size_mismatch": zf.frame_header(1 << 20) + zf.rle_block(0x43, 100, True),
    }[case]


@pytest.mark.parametrize("case", BAD_FRAMES)
def test_punt_and_bomb_guards_match_jax(monkeypatch, case):
    monkeypatch.setenv("RP_ZSTD_NOSIZE_LIMIT", "65536")
    frame = _bad_frame(case)
    with pytest.raises(ValueError) as got:
        tbackend._decompress_device(frame)
    with pytest.raises(ValueError) as want:
        jbackend._decompress_device(frame)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    punts = isinstance(got.value, zf.ZstdFormatError)
    assert punts == (case not in ("declared_lies", "no_size", "size_mismatch"))


def test_no_size_frame_under_the_limit(monkeypatch):
    header = struct.pack("<IBB", zf.MAGIC, 0, 0x88)
    frame = header + zf.rle_block(0x42, 1 << 20, True)
    monkeypatch.setenv("RP_ZSTD_NOSIZE_LIMIT", str(1 << 21))
    assert tbackend._decompress_device(frame) == b"\x42" * (1 << 20)


def test_kernel_value_error_is_not_punted(monkeypatch):
    """A stream that fails the exact-consumption check raises a plain
    ValueError out of uncompress_zstd: the host codec is never asked.
    The frame holds one compressed block whose first stream carries an
    extra byte past its marker, so the host walk parses it and only the
    decode's end check fails."""
    data = _varinted(_JSON * 300, random.Random(2))
    nbits, streams = tz.encode_chunks([data])[0]
    desc = zf.direct_weights_desc(nbits) or zf.fse_weights_desc(nbits)
    frame = zf.frame_header(len(data)) + zf.compressed_block(
        len(data), desc, [streams[0] + b"\x05"] + streams[1:], True)

    def no_punt(_data):
        raise AssertionError("punted to the host codec")

    monkeypatch.setattr(tcompression, "_zstd_uncompress_host", no_punt)
    with pytest.raises(ValueError, match="huffman stream 0 did not consume its bits exactly") as got:
        tbackend.uncompress_zstd(frame)
    assert not isinstance(got.value, zf.ZstdFormatError)
    with pytest.raises(ValueError, match="did not consume its bits exactly"):
        jbackend.uncompress_zstd(frame)
    monkeypatch.setenv("RP_ZSTD_BACKEND", "tpu")
    with pytest.raises(ValueError, match="did not consume its bits exactly"):
        tcompression.uncompress(frame, CompressionType.zstd)


def test_registry_routes_tpu(monkeypatch):
    monkeypatch.setenv("RP_ZSTD_BACKEND", "tpu")
    data = _varinted(_JSON * 300, random.Random(2))
    frame = tcompression.compress(data, CompressionType.zstd)
    assert frame == tbackend.compress_zstd(data)
    assert tcompression.uncompress(frame, CompressionType.zstd) == data


def _zstd_batch(mod, seed):
    rng = np.random.default_rng(seed)
    b = mod.RecordBatchBuilder(base_offset=7, timestamp_ms=1_700_000_000_000)
    for i in range(16):
        if i % 2:
            v = rng.integers(0, 256, 1024, dtype=np.uint8).tobytes()
        else:
            v = b'{"id":%d,"name":"user-%d","tags":["a","b"]},' % (i, int(rng.integers(0, 99))) * 24
        b.add(v, key=b"k%d" % i)
    return b.build()


def test_recompressed_zstd_matches_jax(monkeypatch):
    monkeypatch.setenv("RP_ZSTD_BACKEND", "tpu")
    tb, jb = _zstd_batch(trecord, 21), _zstd_batch(jrecord, 21)
    assert tb.header.crc == jb.header.crc
    got = tb.recompressed(CompressionType.zstd, verify_crc=tb.header.crc)
    want = jb.recompressed(jcompression.CompressionType.zstd, verify_crc=jb.header.crc)
    assert got.body == want.body
    assert got.header.crc == want.header.crc
    assert got.header.compression == CompressionType.zstd
    assert [(r.key, r.value) for r in got.records()] == [(r.key, r.value) for r in tb.records()]
    with pytest.raises(trecord.CrcMismatch):
        tb.recompressed(CompressionType.zstd, verify_crc=tb.header.crc ^ 1)


def _fuzz_cases(count: int):
    rng = random.Random(1234)
    cases = []
    for i in range(count):
        kind = i % 5
        if kind == 0:
            n = rng.randrange(1, 1500)
            cases.append(_varinted((_JSON * (n // len(_JSON) + 1))[:n], rng, gap=rng.randrange(60, 300)))
        elif kind == 1:
            alpha = rng.sample(range(256), rng.randrange(2, 40))
            cases.append(bytes(rng.choice(alpha) for _ in range(rng.randrange(1, 800))))
        elif kind == 2:
            alpha = rng.sample(range(256), rng.randrange(40, 257))
            cases.append(bytes(rng.choice(alpha) for _ in range(rng.randrange(1, 800))))
        elif kind == 3:
            pat = bytes(rng.getrandbits(8) for _ in range(rng.randrange(1, 9)))
            cases.append(pat * rng.randrange(1, 300))
        else:
            n = rng.choice([0, 1, 2, 63, 64, 65, 255, 256, 257])
            cases.append(bytes(rng.getrandbits(8) for _ in range(n)))
    return cases


def test_differential_fuzz_2k():
    """2,000 mixed frames from the port: every one decoded by libzstd
    (when present), a sample by the pure-Python reference decoder and
    by the port's own device-path decode."""
    cases = _fuzz_cases(2000)
    order = sorted(range(len(cases)), key=lambda i: len(cases[i]))
    frames = {}
    for at in range(0, len(order), 500):
        idx = order[at : at + 500]
        for i, frame in zip(idx, tbackend.compress_many_zstd([cases[i] for i in idx])):
            frames[i] = frame
    sample = list(range(0, len(cases), 25))
    for i, data in enumerate(cases):
        if _LIB is not None:
            assert _LIB.decompress(frames[i], len(data)) == data, i
    for i in sample:
        assert zf.reference_decompress(frames[i]) == cases[i], i
    got = [tbackend._decompress_device(frames[i]) for i in sample[::4]]
    assert got == [cases[i] for i in sample[::4]]


# ------------------------------------------------------ kernel replays
ENC_THREADS = (512, 256)  # csrc/zstd.cu: threads a CTA for few rows and for many
ENC_UNIT = 16  # bytes of symbols a lane takes a step


def _seed_u(counts: np.ndarray, v: int) -> np.ndarray:
    """The Kraft seed: u = clip(2^floor_log2(q), 1, 1024) for present
    symbols, q = clip(ceil(c * 2048 / v), 1, 2048)."""
    vv = max(v, 1)
    q = np.clip((counts * 2048 + vv - 1) // vv, 1, 2048)
    return np.where(counts > 0, np.minimum(1 << (np.floor(np.log2(q)).astype(np.int64)), 1024), 0)


def _pow2floor(x: int) -> int:
    return 1 << (x.bit_length() - 1)


def _replay_kraft(counts: np.ndarray, v: int) -> tuple:
    """rp_zstd_encode's Kraft lengths: the down loop in closed form (each
    candidate's weighted rank over (count, symbol) keys, broadcast over
    the 256 pairs), then the up loop as one warp runs it, lane l holding
    symbols 8l..8l+7: a step is one max over keys (log2 u, 255 - symbol)
    and takes the chosen symbol's whole climb (k doublings while
    2^l (2^k - 1) <= deficit, up to 1024); the deficit is carried, never
    re-summed. Returns (nbits, down symbols touched, climbs)."""
    counts = np.asarray(counts, np.int64)
    u = _seed_u(counts, v)
    present = counts > 0
    s_sum = int(u.sum())
    touched = 0
    if s_sum > 2048:
        e = s_sum - 2048
        key = counts * 256 + np.arange(256)
        w = np.where(present, u - 1, 0)
        new = u.copy()
        for s in np.flatnonzero(present & (u >= 2)):
            r = e - int(w[present & (key < key[s])].sum())
            if r > 0:
                new[s] = 1 if u[s] - r < 1 else _pow2floor(int(u[s]) - r)
                touched += 1
        u = new
    lanes = u.reshape(32, 8).copy()
    pres = lanes > 0
    lg = np.where(pres, np.log2(np.maximum(lanes, 1)).astype(np.int64), 0)
    sym = np.arange(256).reshape(32, 8)
    d = 2048 - int(lanes.sum())  # one warp sum before the first step
    steps = 0
    while d > 0:
        keys = np.where(pres & (lanes <= d) & (lanes < 1024), lg * 256 + (255 - sym), -1)
        best = int(keys.max(axis=1).max())  # per-lane max, then __reduce_max_sync
        if best < 0:
            break
        s, lev = 255 - (best & 255), best >> 8
        k = min(((d >> lev) + 1).bit_length() - 1, 10 - lev)
        lanes[s // 8, s % 8] <<= k
        lg[s // 8, s % 8] += k
        d -= ((1 << k) - 1) << lev
        steps += 1
    u = lanes.reshape(256)
    nb = np.where(present, 11 - np.floor(np.log2(np.maximum(u, 1))).astype(np.int64), 0)
    return nb, touched, steps


def _replay_codes(nbits: np.ndarray) -> np.ndarray:
    """Canonical codes as the kernel's warp 0 computes them: lane l holds
    symbols 8l..8l+7 and counts its symbols of each length, packed 8 bits
    a length into three words; a warp scan of the packed words gives each
    lane the lower lanes' counts (<= 248, so no field overflows); lane 31
    turns the totals into each length's first code (past the slots of
    every longer code); a symbol adds its lane's lower symbols of its
    length."""
    nb = nbits.reshape(32, 8).astype(np.int64)
    own = np.zeros((32, 3), np.int64)
    for lane in range(32):
        for x in nb[lane]:
            own[lane, x >> 2] += 1 << (8 * (x & 3))
    incl = np.cumsum(own, 0)
    ex = incl - own
    assert (ex < 1 << 32).all()
    field = lambda words, b: (int(words[b >> 2]) >> (8 * (b & 3))) & 255  # noqa: E731
    first, slots = [0] * 12, 0
    for b in range(11, 0, -1):
        first[b] = slots >> (11 - b)
        slots += (field(ex[31], b) + field(own[31], b)) << (11 - b)
    codes = np.zeros(256, np.int64)
    for lane in range(32):
        for k in range(8):
            b = int(nb[lane, k])
            if b:
                codes[8 * lane + k] = first[b] + field(ex[lane], b) + int((nb[lane, :k] == b).sum())
    return codes


def _quarters(v: int):
    m4 = (v + 3) // 4
    return [(s * m4, m4 if s < 3 else max(v - 3 * m4, 0)) for s in range(4)]


def _units(a: int, slen: int, warps: int):
    """The 16-byte units of a staged quarter (shared bytes a .. a + slen)
    and each warp's run of them, a multiple of 32 units."""
    nun = (a + slen + ENC_UNIT - 1) // ENC_UNIT
    return nun, -(-nun // (32 * warps)) * 32


def _replay_encode(mat: np.ndarray, valid: np.ndarray, n: int, offset: int = 0, threads: int = ENC_THREADS[1]):
    """rp_zstd_encode on a staged matrix (rows of `stride` bytes, the
    chunk at column `offset`, the matrix 16-byte aligned): four CTAs a
    row, CTA s staging quarter s at shared byte (its address & 15), per-
    warp histograms of runs of 16-byte chunks, the four summed, the
    Kraft lengths and codes above, the warps' bit totals from their
    histograms of runs of units, the four pushed to every CTA and summed,
    the Kraft lengths and codes above, the warps' bit totals from their
    histograms, a lane packing each word of its unit into one code of
    <= 44 bits, a warp scan of the units' lengths, each code OR-ed into
    an image shifted by the stream row's address & 15, and the flush of
    SB bytes; at `threads` a CTA. Returns (nbits,
    codes, streams, bits) and the Kraft step counts per row."""
    b_n, stride = mat.shape
    warps, unit = threads // 32, ENC_UNIT
    sb = tz.stream_byte_bound(n)
    nbits = np.zeros((b_n, 256), np.uint8)
    codes = np.zeros((b_n, 256), np.int32)
    streams = np.zeros((b_n, 4, sb), np.uint8)
    bits = np.zeros((b_n, 4), np.int32)
    steps = []
    for r in range(b_n):
        v = min(max(int(valid[r]), 0), n)
        row = mat[r, offset : offset + n]
        staged, subs, hv = [], [], []
        for start, slen in _quarters(v):
            a = (r * stride + offset + start) % 16
            sh = np.zeros(a + slen + unit, np.int64)
            sh[a : a + slen] = row[start : start + slen]
            nun, cw = _units(a, slen, warps)
            h = min(max(v - start, 0), slen)
            sub = np.zeros((warps, 256), np.int64)
            for w in range(warps):
                for j in range(w * cw, min((w + 1) * cw, nun)):
                    for k in range(unit):
                        if 0 <= unit * j + k - a < h:
                            sub[w, sh[unit * j + k]] += 1
            staged.append((a, slen, sh, nun, cw))
            subs.append(sub)
            hv.append(h)
        counts = sum(sub.sum(0) for sub in subs)  # pushed into every CTA of the cluster
        np.testing.assert_array_equal(counts, np.bincount(row[:v], minlength=256))
        nb, touched, up = _replay_kraft(counts, v)
        steps.append((touched, up))
        code = _replay_codes(nb)
        nbits[r], codes[r] = nb, code
        for s, ((a, slen, sh, nun, cw), sub, h) in enumerate(zip(staged, subs, hv)):
            tot = []
            for w in range(warps):
                t = int((sub[w] * nb).sum())
                lo, hi = max(w * cw * unit - a, h), min(min((w + 1) * cw, nun) * unit - a, slen)
                t += sum(int(nb[sh[a + i]]) for i in range(lo, hi))  # past v: uncounted
                tot.append(t)
            tb = sum(tot)
            a_dst = ((r * 4 + s) * sb) % 16
            img = np.zeros((a_dst + sb + 15) // 16 * 4 + 1, np.uint64)
            top = tb + 8 * a_dst
            img[top >> 5] |= np.uint64(1 << (top & 31))  # the end marker
            for w in range(warps):
                carry = sum(tot[:w])
                end = min((w + 1) * cw, nun)
                for j0 in range(w * cw, end, 32):
                    packs = []  # per lane: its unit's 4-symbol codes (value, bits), first symbol highest
                    for lane in range(32):
                        j = j0 + lane
                        pk = []
                        for g in range(unit // 4):
                            val = ln = 0
                            for k in range(4 * g, 4 * g + 4):
                                if j < end and 0 <= unit * j + k - a < slen:
                                    x = int(nb[sh[unit * j + k]])
                                    val = (val << x) | (int(code[sh[unit * j + k]]) & ((1 << x) - 1))
                                    ln += x
                            assert ln <= 44
                            pk.append((val, ln))
                        packs.append(pk)
                    incl = np.cumsum([sum(ln for _, ln in pk) for pk in packs])
                    for pk, c in zip(packs, incl):
                        below = top - carry - (int(c) - sum(ln for _, ln in pk))
                        for val, ln in pk:
                            below -= ln
                            for jw in range(3):  # <= 44 bits at any offset: three words
                                img[(below >> 5) + jw] |= np.uint64(((val << (below & 31)) >> (32 * jw)) & 0xFFFFFFFF)
                    carry += int(incl[-1])
            assert carry == tb
            raw = img.astype("<u4").tobytes()
            streams[r, s] = np.frombuffer(raw[a_dst : a_dst + sb], np.uint8)
            bits[r, s] = tb
    return (nbits, codes, streams, bits), steps


def _fshr(lo: int, hi: int, shift: int) -> int:
    """__funnelshift_r: hi:lo shifted right by shift & 31, low 32 bits."""
    return ((hi << 32 | lo) >> (shift & 31)) & 0xFFFFFFFF


def _replay_decode(bufs, tbits, regen, tsym, tnb, index, sbytes: int, rmax: int,
                   ring: int = 32, ahead: int = 33):
    """rp_zstd_decode on staged matrices: decode_groups' groups, one
    thread per stream. A thread holds hi:lo (words k + 1, k), the next two
    words below (n1, n2) and the shift u; the words below those come from
    a ring of `ring` words filled down to word k - `ahead` in 8-byte chunks
    (zeros below word 0) before the walk and after every 8 steps. A step
    reads nb and sym at (window & 2047) and the ring word k - 3, then
    selects on m = -1 when u - nb < 0 (the window steps down one word),
    else 0: no branch. It runs max(K, 1) steps, 8 at a time, then the
    rest; the output keeps the first K symbols; `end` is the unclamped
    position after the last step, clamped at 0. The replay checks the
    ring: every read finds the word it wants, and every refill overwrites
    a word at or above k - 1."""
    s_n = bufs.shape[0]
    nw = sbytes // 4
    out = np.zeros((s_n, rmax), np.uint8)
    end = np.zeros(s_n, np.int32)
    for grp in tz.decode_groups(index):
        nbt, symt = tnb[grp[0]], tsym[grp[0]]
        for sid in (int(x) for x in grp[1:] if x >= 0):
            words = np.frombuffer(bufs[sid].tobytes(), "<u4").astype(object)
            slots = [None] * ring  # (word index, value) per ring slot
            w = dict(k=(int(tbits[sid]) - 11) >> 5, u=(int(tbits[sid]) - 11) & 31)

            def word(j):
                return int(words[j]) if 0 <= j < nw else 0

            def top_up():
                while 2 * w["fill"] >= w["k"] - ahead:
                    for j in (2 * w["fill"], 2 * w["fill"] + 1):
                        old = slots[j % ring]
                        assert old is None or old[0] >= w["k"] - 1, (old, w["k"])
                        slots[j % ring] = (j, word(j))
                    w["fill"] -= 1

            def step():
                idx = w["x"] & 2047
                held = slots[(w["k"] - 3) % ring]
                assert held is not None and held[0] == w["k"] - 3, (held, w["k"])
                un = w["u"] - int(nbt[idx])
                xa, xb = _fshr(w["lo"], w["hi"], un), _fshr(w["n1"], w["lo"], un)
                if un < 0:
                    w["hi"], w["lo"], w["n1"], w["n2"] = w["lo"], w["n1"], w["n2"], held[1]
                    w["k"] -= 1
                w["x"] = xb if un < 0 else xa
                w["u"] = un & 31
                return int(symt[idx])

            k = w["k"]
            w.update(lo=word(k), hi=word(k + 1), n1=word(k - 1), n2=word(k - 2), fill=(k - 3) >> 1)
            w["x"] = _fshr(w["lo"], w["hi"], w["u"])
            top_up()
            k_n = min(max(int(regen[sid]), 0), rmax)
            steps = max(k_n, 1)
            syms = []
            for _ in range(steps >> 3):
                syms += [step() for _ in range(8)]
                top_up()
            syms += [step() for _ in range(steps & 7)]
            out[sid, :k_n] = syms[:k_n]
            end[sid] = max(32 * w["k"] + w["u"] + 11, 0)
    return out, end


def _replay_rows(n: int) -> list:
    """The edge rows plus lengths 1-5 and v = 1, 5, 15 (mod 64): quarters
    at every alignment, empty streams, rows shorter than four."""
    rng = np.random.default_rng(31 + n)
    extra = [bytes([7] * k) for k in (1, 2, 3, 4)] + [b"ab\x00cd"]
    extra += [rng.integers(0, 40, k, dtype=np.uint8).tobytes() for k in (65, 69, 79, 129, 133, 143) if k <= n]
    return _edge_rows(n, seed=13) + extra


@pytest.mark.parametrize("n", (256, 4096))
def test_kernel_replay_encode_matches_plain(n):
    """The encode kernel's scheme, replayed, against the plain version and
    the JAX program: in place at column 40 of 512-byte-aligned rows (the
    fused layout) and at column 0 of rows of n bytes."""
    rows = _replay_rows(n)
    batch, valid = _stage(rows, n)
    want = [t.numpy() for t in tz._encode_chunks(torch.from_numpy(batch), torch.from_numpy(valid), n)]
    jwant = [np.asarray(x) for x in jz._encode_chunks(jnp.asarray(batch), jnp.asarray(valid), n)]
    _, codes = tz._lengths_plain(torch.from_numpy(batch), torch.from_numpy(valid), n)
    width = (40 + n + 511) // 512 * 512
    wide = np.zeros((len(rows), width), np.uint8)
    wide[:, 40 : 40 + n] = batch
    for mat, offset, threads in ((batch, 0, ENC_THREADS[0]), (batch, 0, ENC_THREADS[1]), (wide, 40, ENC_THREADS[1])):
        (nbits, got_codes, streams, bits), _ = _replay_encode(mat, valid, n, offset, threads)
        for got, w, jw in zip((nbits, streams, bits), want, jwant):
            np.testing.assert_array_equal(got, w)
            np.testing.assert_array_equal(got, jw)
        np.testing.assert_array_equal(got_codes, codes.numpy())


_JAX_KRAFT = jax.jit(jz._kraft_nbits)


def _jax_nbits(counts: np.ndarray) -> np.ndarray:
    return np.asarray(_JAX_KRAFT(jnp.asarray(counts.astype(np.int32)), jnp.int32(int(counts.sum()))))


KRAFT_FIXED = {
    "one_symbol_65536": np.bincount(np.full(65536, 9), minlength=256),
    "down_loop_100": np.bincount(np.frombuffer(chip_smoke.kraft_down_row(np.random.default_rng(0), 65536),
                                               np.uint8), minlength=256),
    "uniform_256": np.full(256, 256),
    "two_symbols": np.bincount(np.array([3] * 5 + [200] * 65531), minlength=256),
}


@pytest.mark.parametrize("case", KRAFT_FIXED)
def test_kraft_closed_form_fixed_vectors(case):
    counts = KRAFT_FIXED[case].astype(np.int64)
    nb, touched, _ = _replay_kraft(counts, int(counts.sum()))
    np.testing.assert_array_equal(nb, _jax_nbits(counts))
    np.testing.assert_array_equal(nb, tz._kraft_nbits(torch.from_numpy(counts)[None], torch.tensor([int(counts.sum())]))[0].numpy())
    if case == "down_loop_100":
        assert touched == 100


@pytest.mark.parametrize("seed", range(8))
def test_kraft_closed_form_matches_jax(seed):
    """Seeded count vectors (a few to all 256 symbols present, flat to
    heavy-tailed, rare symbols beside dominant ones, rare symbols just
    past one slot beside power-of-two shares) through the closed form and
    the JAX loops; some overshoot the 2,048 slots in every seed."""
    rng = np.random.default_rng(seed)
    overshoot = 0
    for _ in range(24):
        k = int(rng.integers(2, 257))
        counts = np.zeros(256, np.int64)
        at = rng.choice(256, k, replace=False)
        kind = int(rng.integers(0, 6))
        if kind >= 3:  # rare symbols just past one slot beside power-of-two shares: the seed overshoots
            unit = 32
            rare = np.zeros(256, np.int64)
            rare[at] = unit + rng.integers(1, unit, k)
            left = 2048 * unit - int(rare.sum())
            for sym in rng.permutation(np.setdiff1d(np.arange(256), at)):
                share = unit << int(rng.integers(2, 10))
                if left <= 0:
                    break
                rare[sym] = min(share, left)
                left -= rare[sym]
            counts = rare
        elif kind == 0:
            counts[at] = rng.integers(1, 400, k)
        elif kind == 1:
            counts[at] = np.maximum(1, (rng.pareto(1.2, k) * 30).astype(np.int64))
        else:
            counts[at] = rng.integers(1, 3, k)
            counts[at[: int(rng.integers(1, 6))]] = rng.integers(2000, 60000)
        counts = np.minimum(counts, 65536 // 2)
        nb, touched, _ = _replay_kraft(counts, int(counts.sum()))
        overshoot += touched > 0
        np.testing.assert_array_equal(nb, _jax_nbits(counts), err_msg=str(counts.tolist()))
    assert overshoot > 0


def test_kernel_replay_decode_matches_plain():
    """The kernel's grouped walk on the edge rows' streams and the trap
    streams: tampered, truncated (it runs out and sticks at bit 0), regen 0
    with tbits 0, more symbols than the row holds, all in one group, so
    the four threads of one table walk chains of unequal K; and two
    streams on a random table."""
    items = _stream_set(_edge_rows(4096, seed=17), 4096)
    items += _trap_streams(items)
    *m, sbytes, rmax = tz.stage_streams(*zip(*items))
    m[1][-2] = 0  # regen 0 with tbits 0
    m[2][-1] = rmax + 9  # more symbols than the row holds
    groups = tz.decode_groups(m[5])
    assert len(set(groups[-1, 1:].tolist())) == 4 and groups[-1, 1] == len(items) - 4
    # two more streams on a random table
    rng = np.random.default_rng(29)
    bufs, tbits, regen, tsym, tnb, index = m
    m = [np.concatenate([bufs, rng.integers(0, 256, (2, sbytes), dtype=np.uint8)]),
         np.concatenate([tbits, [8 * sbytes, 1000]]).astype(np.int32),
         np.concatenate([regen, [300, 41]]).astype(np.int32),
         np.concatenate([tsym, rng.integers(0, 256, (1, 2048), dtype=np.uint8)]),
         np.concatenate([tnb, rng.integers(0, 12, (1, 2048)).astype(np.int32)]),
         np.concatenate([index, [tsym.shape[0]] * 2]).astype(np.int32)]
    groups = torch.from_numpy(tz.decode_groups(m[5]))
    out, end = (t.numpy() for t in tz.decode_staged(*(torch.from_numpy(a) for a in m), sbytes, rmax, groups))
    got_out, got_end = _replay_decode(*m, sbytes, rmax)
    np.testing.assert_array_equal(got_out, out)
    np.testing.assert_array_equal(got_end, end)
    assert got_end[-5] == 0 and got_end[-6] != 0  # truncated sticks at 0; tampered


def test_decode_groups_cut_runs_of_one_table():
    """Runs of consecutive streams with one table, cut every 4 streams;
    a table that comes back later opens a new group."""
    groups = tz.decode_groups(np.array([0, 0, 0, 0, 0, 1, 1, 2, 0], np.int32))
    np.testing.assert_array_equal(groups, [
        [0, 0, 1, 2, 3], [0, 4, -1, -1, -1], [1, 5, 6, -1, -1], [2, 7, -1, -1, -1], [0, 8, -1, -1, -1],
    ])
    assert tz.decode_groups(np.zeros(0, np.int32)).shape == (0, 5)
    index = np.random.default_rng(3).integers(0, 6, 500).astype(np.int32)
    groups = tz.decode_groups(index)
    ids = groups[:, 1:][groups[:, 1:] >= 0]
    np.testing.assert_array_equal(np.sort(ids), np.arange(500))
    for g in groups:
        assert (index[g[1:][g[1:] >= 0]] == g[0]).all()


@pytest.mark.parametrize("shared", (True, False))
def test_decode_streams_match_jax_with_shared_tables(shared):
    """decode_streams gives the JAX package's bytes whether the streams
    of a block pass one table object (staged once) or each its own copy
    (staged once per stream)."""
    items = _stream_set(_edge_rows(4096, seed=23), 4096)
    if not shared:
        items = [(st, rg, (t[0].copy(), t[1].copy())) for st, rg, t in items]
    streams, regens, tables = (list(x) for x in zip(*items))
    tsym = tz.stage_streams(streams, regens, tables)[3]
    assert tsym.shape[0] == (len({id(t) for t in tables}) if shared else len(items))
    assert tsym.shape[0] < len(items) if shared else True
    assert tz.decode_streams(streams, regens, tables) == jz.decode_streams(streams, regens, tables)


# ------------------------------------------------- rp_fused_zstd's CRC
FULL = 0xFFFFFFFF


def _fold_units(n: int, threads: int) -> tuple:
    """(fold, K) of an rp_fused_zstd CTA of `threads` at bucket n: every
    warp but the Kraft loop's folds (csrc/zstd.cu crc_fold_threads), K
    16-byte units a thread so that fold K units cover CTA 0's range, the
    prefix and a quarter of the bucket (crc_units)."""
    fold = threads - 32
    return fold, -(-(-(-(tfused.PREFIX + n // 4) // 16)) // fold)


def _apply(tables, v):
    """An operator (eight nibble tables) on uint32 vectors."""
    o = np.zeros_like(v)
    for c in range(8):
        o ^= tables[c][(v >> np.uint32(4 * c)) & np.uint32(15)]
    return o


def _slice4(c, w):
    t = tcrc._TABLES
    c = c ^ w
    return (t[3][c & 255] ^ t[2][(c >> np.uint32(8)) & 255] ^ t[1][(c >> np.uint32(16)) & 255]
            ^ t[0][c >> np.uint32(24)])


def _apply_cols(cols, r: int) -> int:
    """A 32 x 32 operator held as its columns on one register: the xor of
    the columns r's bits select (the kernel's warp reduction)."""
    out = 0
    for b in range(32):
        if r >> b & 1:
            out ^= int(cols[b])
    return out


def _shift(cols, r: int, s: int) -> int:
    """Z^s(r) from the bits of s, as the kernel's crc_shift: Z^(2^j) for
    each set bit j, each applied by its columns."""
    for j in range(tfused.ZSTD_POW2):
        if s >> j & 1:
            r = _apply_cols(cols[j], r)
    return r


def _replay_fused_crc(row: np.ndarray, v: int, n: int, threads: int, align: int) -> int:
    """rp_fused_zstd's CRC of one row (its columns [0, PREFIX + v) at a
    device address = align mod 16): CTA q stages its quarter (CTA 0 the
    prefix before it) at byte (address & 15) of a symbol region whose
    other bytes are garbage; its counted range [a - pre, a + hv) is cut
    into 16-byte units counted from the end, thread t < fold folding
    units [t K, t K + K) slice-by-4 from register 0, earliest first (bytes
    before the range masked, words wholly before it skipped; CTA 0 xors
    the initial 0xFFFFFFFF into the message's first 4 bytes); each warp's
    lanes joined by Z^(16 K 2^j) (warps holding units), the warps by Z^(16
    and the warps by Z^(16 K 32 2^j), in trees whose level j only lanes
    that are multiples of 2^(j + 1) compute; the part moved by Z^(v -
    start - hv) built from the bits of the shift; CTA 0 xors the four
    parts and inverts."""
    fold, k = _fold_units(n, threads)
    ops = tfused.zstd_crc_ops(k)
    lanes_op = ops[1024 : 1024 + 5 * 128].reshape(5, 8, 16)
    warps_op = ops[1024 + 5 * 128 : 1024 + 9 * 128].reshape(4, 8, 16)
    cols = ops[1024 + 9 * 128 :].reshape(tfused.ZSTD_POW2, 32)
    warps = fold // 32
    m4 = (v + 3) // 4
    crc = 0
    for q in range(4):
        start = q * m4
        slen = m4 if q < 3 else max(v - 3 * m4, 0)
        hv = min(max(v - start, 0), slen)
        pre = tfused.PREFIX if q == 0 else 0
        a_s = (align + tfused.PREFIX + start - pre) % 16
        a = a_s + pre
        base = 16  # the symbol region: 16-byte aligned, garbage before and after
        smem = np.full(base + a + slen + 64, 0xA5, np.uint8)
        smem[base + a_s : base + a + slen] = row[tfused.PREFIX + start - pre : tfused.PREFIX + start + slen]
        lo, e = base + a - pre, base + a + hv
        nu = -(-(e - lo) // 16)
        t = np.arange(fold)
        f = np.zeros(fold, np.uint32)
        for u in range(k - 1, -1, -1):
            un = t * k + u
            x0 = e - 16 * (un + 1)
            for w in range(4):
                x = x0 + 4 * w
                rel = x - lo
                use = (un < nu) & (rel > -4)
                xs = np.where(use, x, base)[:, None] + np.arange(4)[None, :]
                wd = (smem[xs].astype(np.uint64) << (np.arange(4, dtype=np.uint64) * 8)).sum(1).astype(np.uint32)
                neg = (np.clip(-rel, 0, 3) * 8).astype(np.uint64)
                wd &= ((np.uint64(FULL) << neg) & np.uint64(FULL)).astype(np.uint32)
                if pre:
                    init = np.where(rel >= 0, np.uint64(FULL) >> (np.clip(rel, 0, 3) * 8).astype(np.uint64),
                                    (np.uint64(FULL) << neg) & np.uint64(FULL))
                    wd ^= np.where(rel < 4, init, 0).astype(np.uint32)
                f = np.where(use, _slice4(f, wd), f)
        ln = f.reshape(warps, 32)
        active = 32 * k * np.arange(warps) < nu
        for j in range(5):  # lanes that are multiples of 2^(j+1) take Z^(16 K 2^j) of lane l + 2^j
            up = np.concatenate([ln[:, 1 << j :], ln[:, -(1 << j) :]], axis=1)
            at = (np.arange(32) & ((2 << j) - 1)) == 0
            ln = np.where(active[:, None] & at[None, :], ln ^ _apply(lanes_op[j], up), ln)
        fw = np.zeros(32, np.uint32)
        fw[:warps] = ln[:, 0]
        j = 0
        while 1 << j < warps:  # the same tree across the warps' parts
            at = (np.arange(32) & ((2 << j) - 1)) == 0
            fw = np.where(at, fw ^ _apply(warps_op[j], np.concatenate([fw[1 << j :], fw[-(1 << j) :]])), fw)
            j += 1
        crc ^= _shift(cols, int(fw[0]), max(v - start - hv, 0))
    return crc ^ FULL


def _fused_rows(n: int, seed: int):
    """Bodies of the fused CRC tests at bucket n: v in {0, 1, 3, 4, 5, 8,
    9, 12, 4097, n - 1, n} (those <= n) of random bytes, one of a single
    repeated byte, and their prefixes."""
    rng = np.random.default_rng(seed)
    vs = [v for v in (0, 1, 3, 4, 5, 8, 9, 12, 4097, n - 1, n) if v <= n]
    bodies = [rng.integers(0, 256, v, dtype=np.uint8).tobytes() for v in vs] + [b"\x61" * (n - 3)]
    prefixes = [rng.integers(0, 256, tfused.PREFIX, dtype=np.uint8).tobytes() for _ in bodies]
    return prefixes, bodies


@pytest.mark.parametrize("n", (512, 4096, 32768, 65536))
def test_kernel_replay_fused_crc_matches_host_and_jax(n):
    """rp_fused_zstd's CRC stage replayed at both launch shapes (512 and
    256 threads) with the row's address at every residue mod 16 (so each
    quarter starts at every residue): equal to the host CRC of prefix ||
    body and to the JAX crc_zstd_fused CRCs."""
    prefixes, bodies = _fused_rows(n, seed=n + 7)
    mat, body_len, nn = tfused.stage_fused(prefixes, bodies, tfused._zstd_width)
    assert nn == n
    jcrcs, _ = jfused.crc_zstd_fused(prefixes, bodies)
    for i, (p, b) in enumerate(zip(prefixes, bodies)):
        want = host_crc.crc32c(b, host_crc.crc32c(p))
        assert want == int(np.asarray(jcrcs)[i])
        for threads in ENC_THREADS:
            for align in range(16):
                got = _replay_fused_crc(mat[i], int(body_len[i]), n, threads, align)
                assert got == want, (len(b), threads, align)


def test_crc_shift_from_bits_appends_zeros():
    """Z^L built from the bits of L with the host's Z^(2^j) columns (as the
    kernel shifts a piece) equals appending L zero bytes, for random L <
    2^17 and both ends of the range."""
    cols = tfused.zstd_crc_ops(1)[1024 + 9 * 128 :].reshape(tfused.ZSTD_POW2, 32)
    rng = np.random.default_rng(5)
    regs = rng.integers(0, 2**32, 3, dtype=np.uint64).astype(np.uint32)
    lengths = [0, 1, 40, 65536 + 40, (1 << 17) - 1] + [int(x) for x in rng.integers(0, 1 << 17, 3)]
    walked, at = regs.copy(), 0
    for length in sorted(lengths):
        for _ in range(length - at):  # one zero byte: r = T0[r & 255] ^ (r >> 8)
            walked = tcrc._TABLES[0][walked & 255] ^ (walked >> np.uint32(8))
        at = length
        assert [_shift(cols, int(r), length) for r in regs] == [int(x) for x in walked], length


def test_fused_crc_shape():
    """K units a folding thread (every warp but one) cover CTA 0's longest
    range (the prefix and a quarter of the bucket) at both launch shapes,
    within the warps (<= 16) whose tree the constants hold; the constants
    are the kernel's 2,720 words, their operators those of K's units."""
    for n in (512, 4096, 32768, 65536):
        for threads in ENC_THREADS:
            fold, k = _fold_units(n, threads)
            units = -(-(tfused.PREFIX + n // 4) // 16)
            assert fold * k >= units > fold * (k - 1)
            assert fold // 32 <= 1 << tfused.ZSTD_WARP_OPS and n < 1 << tfused.ZSTD_POW2
            ops = tfused.zstd_crc_ops(k)
            assert ops.shape == (1024 + 9 * 128 + tfused.ZSTD_POW2 * 32,)
            assert np.array_equal(ops[1024 : 1024 + 128], tcrc.op_tables(16 * k).reshape(-1))


def test_fused_zstd_cpu_path_is_the_plain_chain():
    """On the CPU `_fused_zstd` is the plain chain (the CRC, then the
    encode), equal to `_fused_zstd_sequence` and launching nothing."""
    prefixes, bodies = _fused_rows(4096, seed=3)
    mat, body_len, n = tfused.stage_fused(prefixes, bodies, tfused._zstd_width)
    data, valid = torch.from_numpy(mat), torch.from_numpy(body_len)
    before = dict(tfused.LAUNCHES)
    got = tfused._fused_zstd(data, valid, n)
    for g, w in zip(got, tfused._fused_zstd_sequence(data, valid, n)):
        assert torch.equal(g, w)
    assert tfused.LAUNCHES == before
    want = [host_crc.crc32c(b, host_crc.crc32c(p)) for p, b in zip(prefixes, bodies)]
    assert got[0].tolist() == want


class _RefusingZstdLib:
    """A zstd library whose fused launch the card refuses."""

    @staticmethod
    def rp_fused_zstd(*_args):
        return 9

    @staticmethod
    def rp_fused_zstd_units(_b, _offset, _n):
        return 1

    @staticmethod
    def rp_error_string(_rc):
        return b"invalid configuration argument"


def test_a_refused_fused_zstd_launch_raises(monkeypatch):
    """A refused rp_fused_zstd launch raises KernelError and counts
    nothing; the wrapper routes the rows nowhere else (no fallback to the
    two-launch sequence)."""
    monkeypatch.setattr(tz, "_LIB", _RefusingZstdLib())
    monkeypatch.setattr(_build, "stream_of", lambda _t: 0)
    monkeypatch.setattr(tfused, "zstd_crc_consts", lambda _dev, _k: torch.zeros(1, dtype=torch.int32))
    mat, blen, n = tfused.stage_fused([bytes(40)], [b"abc" * 100], tfused._zstd_width)
    before = dict(tfused.LAUNCHES)
    with pytest.raises(_build.KernelError, match="fused_zstd"):
        tfused.launch_fused_zstd(torch.from_numpy(mat), torch.from_numpy(blen), n)
    assert tfused.LAUNCHES == before
