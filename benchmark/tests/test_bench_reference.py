"""The reference's pieces on known vectors: CRC-32C, xxHash32, LZ4
frames and blocks, zstd frames, Kafka record batches; and the check on
hand-made runs, sound and broken."""

from __future__ import annotations

import ctypes
import ctypes.util
import random
import zlib

import pytest

from harness import check, lz4, traffic, wire, zstd
from harness.crc32c import crc32c, crc32c_rows


def test_crc32c_known_vectors():
    assert crc32c(b"") == 0
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(bytes(32)) == 0x8A9136AA
    assert crc32c(b"\xff" * 32) == 0x62A8AB43


def test_crc32c_rows_equal_one_by_one():
    rng = random.Random(5)
    rows = [bytes(rng.getrandbits(8) for _ in range(rng.randrange(0, 300))) for _ in range(40)]
    assert crc32c_rows(rows, block=7) == [crc32c(r) for r in rows]


def test_xxh32_known_vectors():
    assert lz4.xxh32(b"") == 0x02CC5D05
    assert lz4.xxh32(b"a") == 0x550D7456
    assert lz4.xxh32(b"abc") == 0x32D153FF
    assert lz4.xxh32(b"Nobody inspects the spammish repetition") == 0xE2293B2F


def _liblz4():
    name = ctypes.util.find_library("lz4")
    if name is None:
        pytest.skip("no liblz4 on this machine to cross-check with")
    lib = ctypes.CDLL(name)
    lib.LZ4_compress_default.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.LZ4_decompress_safe.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    return lib


@pytest.mark.parametrize("kind", ["json", "random", "zeros", "short"])
def test_lz4_blocks_against_liblz4(kind):
    import numpy as np

    rng = np.random.default_rng(3)
    data = {"json": b"".join(traffic.json_values(rng, 16, 1024)), "random": rng.bytes(16384),
            "zeros": bytes(20000), "short": b"abcabcabcabcabc"}[kind]
    lib = _liblz4()
    out = ctypes.create_string_buffer(len(data) + len(data) // 255 + 64)
    n = lib.LZ4_compress_default(data, out, len(data), len(out))
    assert lz4.decompress_block(out.raw[:n], len(data)) == data
    ours = lz4.compress_block(data)
    back = ctypes.create_string_buffer(len(data))
    assert lib.LZ4_decompress_safe(ours, back, len(ours), len(data)) == len(data)
    assert back.raw == data


def test_lz4_frames_round_trip_and_refuse_damage():
    data = b"".join(b'{"k":%d,"v":"%s"},' % (i, b"x" * (i % 7)) for i in range(3000))
    frame = lz4.compress_frame(data)
    assert lz4.decompress_frame(frame) == data
    with pytest.raises(ValueError):
        lz4.decompress_frame(frame[:6] + bytes([frame[6] ^ 1]) + frame[7:])  # header checksum
    # a frame with a content checksum, as the broker's codec writes it
    desc = bytes([0x64, 0x40])
    block = lz4.compress_block(data[:60000])
    checked = (lz4.MAGIC.to_bytes(4, "little") + desc + bytes([(lz4.xxh32(desc) >> 8) & 0xFF])
               + len(block).to_bytes(4, "little") + block + bytes(4) + lz4.xxh32(data[:60000]).to_bytes(4, "little"))
    assert lz4.decompress_frame(checked) == data[:60000]
    with pytest.raises(ValueError):
        lz4.decompress_frame(checked[:-1] + bytes([checked[-1] ^ 1]))


def test_zstd_frames_from_libzstd():
    if ctypes.util.find_library("zstd") is None:
        pytest.skip("no libzstd on this machine")
    data = b"".join(traffic.json_values(__import__("numpy").random.default_rng(9), 16, 1024))
    assert zstd.decompress(zstd.compress(data)) == data
    with pytest.raises(ValueError):
        zstd.decompress(zstd.compress(data)[:-3])


def test_records_and_batches_round_trip():
    recs = [(b"k%d" % i, bytes([i]) * (i * 37)) for i in range(20)] + [(b"none", b"")]
    section = wire.encode_records(recs)
    assert [(k, v) for _, k, v in wire.decode_records(section, len(recs))] == recs
    assert sum(wire.record_size(k, v, i) for i, (k, v) in enumerate(recs)) == len(section)
    with pytest.raises(ValueError):
        wire.decode_records(section, len(recs) - 1)
    tail = wire.batch_tail(0, len(recs) - 1, 1_700_000_000_000, 1_700_000_000_000, -1, -1, -1, len(recs)) + section
    batch = wire.batch_wire(tail, crc32c(tail))
    [(base, view)] = wire.split_batches(batch + batch[:30])
    f = wire.batch_fields(view)
    assert (base, f["record_count"], f["last_offset_delta"], f["magic"]) == (0, len(recs), len(recs) - 1, 2)
    assert f["crc"] == crc32c(batch[wire.CRC_FROM:])


def _run(mix, codec):
    """A hand-made sound run of two partitions: what the generator and
    the stored logs would hold."""
    pool = traffic.pool(mix, 11)
    per = len(pool[0]["records"])
    gen = {"t0": 0.0, "t1": 10.0, "attempts": [], "acks": [], "failed": [], "receipts": [], "hwm": {}}
    stored = {}
    for p in range(2):
        log = []
        for k in range(3):
            idx = traffic.pool_index(mix, p, k)
            body = pool[idx]["section"] if codec == 0 else lz4.compress_frame(pool[idx]["section"])
            tail = wire.batch_tail(codec, per - 1, 5, 5, -1, -1, -1, per) + body
            fields = (crc32c(tail), codec, per - 1, 5, 5, -1, -1, -1, per)
            log.append((fields, body))
            t = 1.0 + k
            gen["attempts"].append([p, k, t, t + 0.1, 0])
            gen["acks"].append([p, k, idx, t, t + 0.1, k * per])
            gen["receipts"].append([p, k * per, t + 0.2, zlib.crc32(tail), 9 + len(tail), fields[0], per, len(tail)])
        gen["hwm"][str(p)] = 3 * per
        stored[p] = [list(log), list(log), list(log)]
    return gen, stored, pool


MIX = {"pool_batches": 4, "pool_stride": 3, "record_bytes": 100, "records_per_batch": 5, "producer_codec": "none"}


def _failing(compared):
    return {name for name, v, limit in compared if v > limit}


def test_check_passes_a_sound_run_and_fails_each_break():
    gen, stored, pool = _run(MIX, 3)
    compared, counted = check.check(gen, stored, pool, 3, 3, 1, 100)
    assert _failing(compared) == set() and counted["acked_batches"] == 6

    g, s, _ = _run(MIX, 3)
    s[1][2] = None  # a replica missing
    assert _failing(check.check(g, s, pool, 3, 3, 1, 100)[0]) == {"missing_replicas"}

    g, s, _ = _run(MIX, 3)
    fields, body = s[0][0][1]
    s[0][0][1] = (fields, body[:-1] + bytes([body[-1] ^ 1]))  # the leader's body altered: CRC and decode
    assert {"crc_errors", "replica_mismatches", "decode_errors", "consumer_mismatch"} <= _failing(
        check.check(g, s, pool, 3, 3, 1, 100)[0])

    g, s, _ = _run(MIX, 3)
    g["acks"][1][5] += 1  # acknowledged at another offset
    assert "offset_errors" in _failing(check.check(g, s, pool, 3, 3, 1, 100)[0])

    g, s, _ = _run(MIX, 3)
    g["receipts"].pop()
    g["hwm"]["0"] = 7
    assert _failing(check.check(g, s, pool, 3, 3, 1, 100)[0]) == {"consumer_missing", "hwm_errors"}

    g, s, _ = _run(MIX, 3)
    assert "codec_errors" in _failing(check.check(g, s, pool, 4, 3, 1, 100)[0])

    g, s, _ = _run(MIX, 3)
    g["failed"].append([0, 3, 2])
    assert "failed_batches" in _failing(check.check(g, s, pool, 3, 3, 1, 100)[0])
