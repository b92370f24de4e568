"""Port vs reference: the device LZ4 / snappy codecs and the fused CRC.

Seeded inputs go through the JAX package (JAX on the CPU, as
tests/test_device_lz4.py runs it) and through redpanda_tpu_torch on the
CPU (the plain PyTorch versions). Every output is integer or bytes, so
every comparison is exact: the seven per-cell parse vectors, the
[B, out_bound(n)] block matrices and their lengths, the fused CRCs and
blocks, and the broker's recompressed frames are byte-equal.

The CUDA kernels of csrc/codec.cu cannot run here. Their schemes are
replayed in Python below, step for step (the block-wide radix sort of
the positions by hash, the block scans as warp shuffles, the emission's
staged row, packed size scan, head writers with their deferred parts,
per-cell literal copy and 16-byte flush), and held against the plain
versions and the JAX programs, the way test_torch_crc32c.py replays its
segment scheme.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from redpanda_tpu import compression as jcompression
from redpanda_tpu.compression import tpu_backend as jbackend
from redpanda_tpu.models import record as jrecord
from redpanda_tpu.ops import cellparse as jcp
from redpanda_tpu.ops import fused as jfused
from redpanda_tpu.ops import lz4 as jlz4
from redpanda_tpu.ops import snappy as jsnappy
from redpanda_tpu_torch import compression as tcompression
from redpanda_tpu_torch.compression import CompressionType, lz4_codec, snappy_codec
from redpanda_tpu_torch.compression import tpu_backend as tbackend
from redpanda_tpu_torch.models import record as trecord
from redpanda_tpu_torch.ops import cellparse as tcp
from redpanda_tpu_torch.ops import fused as tfused
from redpanda_tpu_torch.ops import lz4 as tlz4
from redpanda_tpu_torch.ops import snappy as tsnappy
from redpanda_tpu_torch.utils import crc as host_crc

CELL = tcp.CELL


def _payloads():
    """The payload set of tests/test_device_lz4.py."""
    rng = random.Random(7)
    return {
        "empty": b"",
        "one": b"Z",
        "zeros": b"\x00" * 4096,
        "rle_mix": b"".join(bytes([i % 11]) * (i % 29 + 1) for i in range(200)),
        "text": b"the quick brown fox jumps over the lazy dog. " * 90,
        "json": b'{"k":"aaaa","v":123,"flag":true},' * 120,
        "random": bytes(rng.getrandbits(8) for _ in range(3000)),
        "cell_edge": b"ab" * (CELL // 2) * 3 + b"\x01",
        "period_cell": bytes(range(CELL)) * 64,
        "alt": (b"\x00\xff" * 2048),
    }


def _ragged(seed, count=12, max_len=6000):
    """Ragged lengths, a mix of random bytes and repeated text."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        size = int(rng.integers(0, max_len))
        if i % 3 == 0:
            out.append(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        else:
            words = [b"redpanda", b"kafka", b"%d" % i, b'{"k":', b"raft ", b"\x00\x01"]
            buf = b"".join(words[int(w)] for w in rng.integers(0, len(words), size // 4 + 1))
            out.append(buf[:size])
    return out


def _full_row():
    """One full 64 KiB row: JSON-like records with seeded fields."""
    rng = np.random.default_rng(64)
    parts, size = [], 0
    while size < 65536:
        rec = b'{"key":"user-%06d","topic":"orders","seq":%d,"flag":%s},' % (
            int(rng.integers(0, 10**6)), int(rng.integers(0, 10**9)),
            b"true" if rng.random() < 0.5 else b"false")
        parts.append(rec)
        size += len(rec)
    return b"".join(parts)[:65536]


CASES = {
    "payloads": lambda: list(_payloads().values()),
    "ragged": lambda: _ragged(3),
    "full_64k": lambda: [_full_row()],
    # the parse's skew edges: every 4-gram one hash; every 4-gram distinct
    "one_byte_64k": lambda: [b"\x61" * 65536],
    "distinct_64k": lambda: [chip_smoke.distinct_grams_row(65536)],
}


def _stage(chunks):
    batch, valid, n = tlz4.stage_chunks(tlz4.as_arrays(chunks), "lz4")
    return batch, valid, n


_jax_parse = jax.jit(jcp.cell_parse, static_argnums=2)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cell_parse_matches_jax(case):
    batch, valid, n = _stage(CASES[case]())
    got = tcp.cell_parse(torch.from_numpy(batch), torch.from_numpy(valid), n)
    assert len(got) == len(tcp.FIELDS)
    for i in range(batch.shape[0]):
        want = _jax_parse(jnp.asarray(batch[i]), jnp.int32(valid[i]), n)
        for name, w, g in zip(tcp.FIELDS, want, got):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w), err_msg=f"{case} row {i} {name}")


@pytest.mark.parametrize("codec", ["lz4", "snappy"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_compress_chunks_match_jax(codec, case):
    jmod, tmod = {"lz4": (jlz4, tlz4), "snappy": (jsnappy, tsnappy)}[codec]
    batch, valid, n = _stage(CASES[case]())
    out, out_len = tmod._compress_chunks(torch.from_numpy(batch), torch.from_numpy(valid), n)
    jout, jlen = jmod._compress_chunks(jnp.asarray(batch), jnp.asarray(valid), n)
    assert tuple(out.shape) == (batch.shape[0], tmod.out_bound(n))
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(jlen))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


@pytest.mark.parametrize("case", sorted(CASES))
def test_entries_match_jax_and_decode_with_system_libs(case):
    chunks = CASES[case]()
    lz4_blocks = tlz4.compress_chunks(chunks, device="cpu")
    snappy_blocks = tsnappy.compress_chunks(chunks, device="cpu")
    assert lz4_blocks == jlz4.compress_chunks(chunks)
    assert snappy_blocks == jsnappy.compress_chunks(chunks)
    for raw, lz, sn in zip(chunks, lz4_blocks, snappy_blocks):
        if raw:
            assert lz4_codec.decompress_block(lz, len(raw)) == raw
        assert snappy_codec.decompress_raw(sn) == raw


def _adversarial():
    """Dense sequence emission: alternating unmatchable / matchable
    cells, so every other cell emits a sequence."""
    rng = random.Random(1)
    bad = []
    for _ in range(8):
        buf = bytearray()
        while len(buf) < 2048:
            buf += bytes(rng.getrandbits(8) for _ in range(CELL))
            buf += buf[-CELL:]
        bad.append(bytes(buf))
    return bad


@pytest.mark.parametrize("codec", ["lz4", "snappy"])
def test_out_bound_holds_on_adversarial_input(codec):
    tmod, jmod = {"lz4": (tlz4, jlz4), "snappy": (tsnappy, jsnappy)}[codec]
    bad = _adversarial()
    blocks = tmod.compress_chunks(bad, device="cpu")  # asserts out_bound inside
    assert blocks == jmod.compress_chunks(bad)
    for raw, blk in zip(bad, blocks):
        if codec == "lz4":
            assert len(blk) <= tmod.out_bound(len(raw))
            assert lz4_codec.decompress_block(blk, len(raw)) == raw
        else:
            assert snappy_codec.decompress_raw(blk) == raw


def test_chunk_limit():
    with pytest.raises(ValueError):
        tlz4.compress_chunks([b"x" * 65537], device="cpu")
    with pytest.raises(ValueError):
        tsnappy.compress_chunks([b"x" * 65537], device="cpu")
    with pytest.raises(ValueError):
        tfused.crc_lz4_fused([b"\x00" * 40], [b"x" * 65537], device="cpu")


def _fused_inputs(seed):
    bodies = _ragged(seed, count=10, max_len=5000) + [b"", b"abc" * 700]
    rng = np.random.default_rng(seed + 1)
    prefixes = [rng.integers(0, 256, tfused.PREFIX, dtype=np.uint8).tobytes() for _ in bodies]
    return prefixes, bodies


@pytest.mark.parametrize("codec", ["lz4", "snappy"])
def test_fused_matches_jax_and_host_crc(codec):
    prefixes, bodies = _fused_inputs(5)
    tfn = {"lz4": tfused.crc_lz4_fused, "snappy": tfused.crc_snappy_fused}[codec]
    jfn = {"lz4": jfused.crc_lz4_fused, "snappy": jfused.crc_snappy_fused}[codec]
    crcs, blocks = tfn(prefixes, bodies, device="cpu")
    jcrcs, jblocks = jfn(prefixes, bodies)
    assert crcs.dtype == np.uint32
    np.testing.assert_array_equal(crcs, np.asarray(jcrcs))
    assert blocks == jblocks
    for p, b, c in zip(prefixes, bodies, crcs):
        assert int(c) == host_crc.crc32c(b, host_crc.crc32c(p))


def test_fused_reads_bodies_in_place():
    """The parse at column offset PREFIX of the fused rows equals the
    parse of the same bodies staged alone."""
    prefixes, bodies = _fused_inputs(9)
    mat, body_len, n = tfused.stage_fused(prefixes, bodies)
    got = tcp.cell_parse(torch.from_numpy(mat), torch.from_numpy(body_len), n, tfused.PREFIX)
    alone = np.zeros((len(bodies), n + CELL), np.uint8)
    alone[:, : n] = mat[:, tfused.PREFIX : tfused.PREFIX + n]
    want = tcp.cell_parse(torch.from_numpy(alone), torch.from_numpy(body_len), n)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _batch(mod, seed, text=True):
    rng = np.random.default_rng(seed)
    b = mod.RecordBatchBuilder(base_offset=7, timestamp_ms=1_700_000_000_000)
    for i in range(16):
        if text:
            v = b'{"id":%d,"name":"user-%d","tags":["a","b"]},' % (i, int(rng.integers(0, 99))) * 24
        else:
            v = rng.integers(0, 256, 1024, dtype=np.uint8).tobytes()
        b.add(v, key=b"k%d" % i)
    return b.build()


@pytest.mark.parametrize("text", [True, False], ids=["json", "random"])
def test_recompressed_matches_jax(monkeypatch, text):
    monkeypatch.setattr(tfused, "DEFAULT_DEVICE", "cpu")
    monkeypatch.setenv("RP_CODEC_BACKEND", "device")
    tb, jb = _batch(trecord, 11), _batch(jrecord, 11)
    if not text:
        tb, jb = _batch(trecord, 12, text=False), _batch(jrecord, 12, text=False)
    assert tb.header.crc == jb.header.crc
    got = tb.recompressed(CompressionType.lz4, verify_crc=tb.header.crc)
    want = jb.recompressed(jcompression.CompressionType.lz4, verify_crc=jb.header.crc)
    assert got.body == want.body
    assert got.header.crc == want.header.crc
    assert got.header.compression == CompressionType.lz4
    assert [r.value for r in got.records()] == [r.value for r in tb.records()]
    bad = tb.header.crc ^ 0x1
    with pytest.raises(trecord.CrcMismatch):
        tb.recompressed(CompressionType.lz4, verify_crc=bad)
    with pytest.raises(jrecord.CrcMismatch):
        jb.recompressed(jcompression.CompressionType.lz4, verify_crc=bad)


def test_recompressed_device_without_cuda_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks a machine without one")
    monkeypatch.setenv("RP_CODEC_BACKEND", "device")
    batch = _batch(trecord, 13)
    with pytest.raises(RuntimeError, match="CUDA"):
        batch.recompressed(CompressionType.lz4, verify_crc=batch.header.crc)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbackend.compress_many([b"x" * 100])
    with pytest.raises(RuntimeError, match="CUDA"):
        tbackend.compress_many_snappy([b"x" * 100])


@pytest.mark.parametrize("fault", ["none", "missing", "dtype", "shape", "strided"])
def test_emission_launch_checks_parse(fault):
    """An emission launch reads the parse vectors by pointer, so it takes
    only cell_parse's seven contiguous tensors of its dtypes and shapes."""
    batch, valid, n = _stage(list(_payloads().values())[:3])
    data = torch.from_numpy(batch)
    parse = list(tcp.cell_parse(data, torch.from_numpy(valid), n))
    if fault == "missing":
        parse = parse[:-1]
    elif fault == "dtype":
        parse[3] = parse[3].long()
    elif fault == "shape":
        parse[4] = parse[4][:, :-1]
    elif fault == "strided":
        parse[2] = torch.stack([parse[2], parse[2]], dim=2)[:, :, 0]
        assert not parse[2].is_contiguous()
    if fault == "none":
        tlz4.check_parse(data, parse, n)
    else:
        with pytest.raises(ValueError, match="parse"):
            tlz4.check_parse(data, parse, n)


def test_backend_registry_round_trips(monkeypatch):
    monkeypatch.setattr(tlz4, "DEFAULT_DEVICE", "cpu")
    monkeypatch.setattr(tsnappy, "DEFAULT_DEVICE", "cpu")
    bufs = list(_payloads().values()) + [_full_row() * 2 + b"tail"]
    assert tbackend.compress_many(bufs) == jbackend.compress_many(bufs)
    assert tbackend.compress_many_snappy(bufs) == jbackend.compress_many_snappy(bufs)
    tbackend.enable()
    try:
        for data in bufs:
            for ctype in (CompressionType.lz4, CompressionType.snappy):
                frame = tcompression.compress(data, ctype)
                assert tcompression.uncompress(frame, ctype) == data
        assert lz4_codec.decompress_frame(tbackend.compress(bufs[-1])) == bufs[-1]
        assert snappy_codec.decompress_java(tbackend.compress_snappy(bufs[-1])) == bufs[-1]
    finally:
        tbackend.disable()
    assert tcompression.compress(b"abc", CompressionType.lz4) == lz4_codec.compress_frame(b"abc")


# ------------------------------------------------------------- replays
FULL = 0xFFFFFFFF


def _shfl(vals, o, down):
    if down:
        return [vals[l + o] if l + o < 32 else vals[l] for l in range(32)]
    return [vals[l - o] if l >= o else vals[l] for l in range(32)]


def _block_scan_excl(xs, op, identity, suffix):
    """csrc/codec.cu block_scan_excl over one value per thread."""
    nw = len(xs) // 32
    incs = []
    for w in range(nw):
        inc = list(xs[32 * w : 32 * w + 32])
        o = 1
        while o < 32:
            y = _shfl(inc, o, suffix)
            inc = [op(inc[l], y[l]) if (l + o < 32 if suffix else l >= o) else inc[l] for l in range(32)]
            o <<= 1
        incs.append(inc)
    sh = [inc[0 if suffix else 31] for inc in incs]
    w = [sh[l] if l < nw else identity for l in range(32)]
    o = 1
    while o < 32:
        y = _shfl(w, o, suffix)
        w = [op(w[l], y[l]) if (l + o < 32 if suffix else l >= o) else w[l] for l in range(32)]
        o <<= 1
    we = _shfl(w, 1, suffix)
    we[31 if suffix else 0] = identity
    out = []
    for wi, inc in enumerate(incs):
        te = _shfl(inc, 1, suffix)
        te[31 if suffix else 0] = identity
        out.extend(op(we[wi], te[l]) for l in range(32))
    return out


def _hash(d, p):
    gram = int(d[p]) | int(d[p + 1]) << 8 | int(d[p + 2]) << 16 | int(d[p + 3]) << 24
    return ((gram * 2654435761) & FULL) >> 16


_LOWER = np.tril(np.ones((32, 32), bool), -1)  # [lane, peer]: peer < lane


def _ballot(bits):
    return int(sum(1 << l for l in range(32) if bits[l]))


def _replay_radix_pass(key_at, walk_end, shift, warps=32):
    """One pass of the kernel's radix sort: each warp owns a run of the
    input. Count sweep: one shared atomic per key into its warp's digit
    count (order-free). A block scan over (digit, warp), digit-major,
    gives offsets. Scatter sweep, 32 keys a tile: each active lane ORs its
    bit into its digit's lane mask, reads (mask, offset) back, lands at
    the offset plus its lower peers, and the lowest lane clears the mask
    and advances the offset."""
    run = -(-walk_end // (warps * 32)) * 32
    runs = [(min(w * run, walk_end), min(min(w * run, walk_end) + run, walk_end)) for w in range(warps)]
    cnt = np.zeros((warps, 256), np.int64)
    for w, (r0, r1) in enumerate(runs):
        if r1 > r0:
            np.add.at(cnt[w], (key_at(np.arange(r0, r1)) >> shift) & 255, 1)
    flat = cnt.T.reshape(-1)  # (digit, warp), digit-major
    off = (np.cumsum(flat) - flat).reshape(256, warps).T.copy()
    out = np.zeros(walk_end, np.int64)
    for w, (r0, r1) in enumerate(runs):
        mask = np.zeros(256, np.int64)
        for base in range(r0, r1, 32):
            i = base + np.arange(32)
            act = i < r1
            keys = key_at(np.minimum(i, r1 - 1))
            dig = (keys >> shift) & 255
            for l in np.flatnonzero(act):  # atomicOr of the lane bits
                mask[dig[l]] |= 1 << int(l)
            for l in np.flatnonzero(act):
                peers = int(mask[dig[l]])
                lower = bin(peers & ((1 << int(l)) - 1)).count("1")
                out[off[w, dig[l]] + lower] = keys[l]
            for l in np.flatnonzero(act):  # the lowest lane of each digit
                peers = int(mask[dig[l]])
                if peers and peers & ((1 << int(l)) - 1) == 0:
                    off[w, dig[l]] += bin(peers).count("1")
                    mask[dig[l]] = 0
    return out


def _replay_candidates(d, walk_end):
    """The kernel's candidates: (hash << 16 | pos) keys of [0, walk_end)
    radix-sorted by the hash's low then high byte, then each key's
    predecessor in sorted order where the hashes agree; 0xFFFF for none."""
    d = np.asarray(d, np.int64)
    pos = np.arange(walk_end)
    gram = d[pos] | d[pos + 1] << 8 | d[pos + 2] << 16 | d[pos + 3] << 24
    keys0 = (((gram * 2654435761) & FULL) >> 16) << 16 | pos
    ka = _replay_radix_pass(lambda i: keys0[i], walk_end, 16)
    kb = _replay_radix_pass(lambda i: ka[i], walk_end, 24)
    cand = np.full(walk_end, 0xFFFF, np.int64)
    same = np.zeros(walk_end, bool)
    same[1:] = (kb[1:] >> 16) == (kb[:-1] >> 16)
    cand[kb & 0xFFFF] = np.where(same, np.roll(kb, 1) & 0xFFFF, 0xFFFF)
    return cand.tolist()


def _replay_parse(d, v, n, threads=1024, items=4):
    """csrc/codec.cu cell_parse_kernel on one row d (n + CELL bytes)."""
    v = min(max(v, 0), n)
    walk_end = min(v + 1, n)
    cand_s = _replay_candidates(d, walk_end)

    def cand_at(p):
        if p < 0:
            return -1
        if p >= walk_end:
            return p - 1
        return -1 if cand_s[p] == 0xFFFF else cand_s[p]

    def word(at):  # the little-endian 32-bit word of d at byte `at`
        return int.from_bytes(bytes(int(x) for x in d[at : at + 4]), "little")

    def verify(p, q, e):  # from the cell end: aligned cell words, the first one masked
        if q < 0:
            return False
        back = e - p
        for k in range(4, back + 4, 4):
            at = q + back - k
            qw = word(at) if at >= 0 else (word(0) << (-8 * at)) & FULL
            x = word(e - k) ^ qw
            if k > back:
                x &= (FULL << (8 * (k - back))) & FULL
            if x:
                return False
        return True

    # one thread per position (candidates looked up lazily); a half-warp
    # ballot picks each cell's first good position; the cell-start lane
    # writes the cell, with the third candidate of its start if none
    nc = n // CELL
    has_s, j_s, offs_s = [0] * nc, [0] * nc, [0] * nc
    for base in range(0, n, threads):
        for w in range(threads // 32):
            sel = [-1] * 32
            for lane in range(32):
                p = base + 32 * w + lane
                jj, cstart = p % CELL, p - p % CELL
                if p < n and jj <= CELL - 4 and cstart + CELL <= v - 12:
                    c1 = cand_at(p)
                    if verify(p, c1, cstart + CELL):
                        sel[lane] = c1
                    elif c1 >= 0:
                        c2 = cand_at(c1)
                        if verify(p, c2, cstart + CELL):
                            sel[lane] = c2
                        elif c2 >= 0:
                            c3 = cand_at(c2)
                            if verify(p, c3, cstart + CELL):
                                sel[lane] = c3
            good = _ballot([x >= 0 for x in sel])
            for half in (0, 16):
                p = base + 32 * w + half
                if p >= n:
                    continue
                g = (good >> half) & 0xFFFF
                j = (g & -g).bit_length() - 1 if g else 0
                c = p // CELL
                has_s[c], j_s[c] = g != 0, j
                if g:
                    offs_s[c] = p + j - sel[half + j]
                else:
                    c1 = cand_at(p)
                    c2 = cand_at(c1) if c1 >= 0 else -1
                    offs_s[c] = p - (cand_at(c2) if c2 >= 0 else -1)

    heads, bnds, jvs, aggs = [], [], [], []
    for t in range(threads):
        h_t, b_t, j_t = [], [], []
        for i in range(items):
            c = t * items + i
            h = ab = False
            jv = 0
            if c < nc:
                h, jv = has_s[c], j_s[c]
                ab = c > 0 and h and has_s[c - 1] and jv == 0 and offs_s[c] == offs_s[c - 1]
            h_t.append(h and not ab)
            b_t.append(c if c < nc and not ab else nc)
            j_t.append(jv)
        heads.append(h_t), bnds.append(b_t), jvs.append(j_t), aggs.append(min(b_t))
    after = _block_scan_excl(aggs, min, nc, suffix=True)
    nbs, contribs, aggm = [], [], []
    for t in range(threads):
        run, nb = after[t], [0] * items
        for i in reversed(range(items)):
            nb[i] = run
            run = min(run, bnds[t][i])
        co = [nb[i] * CELL if heads[t][i] else 0 for i in range(items)]
        nbs.append(nb), contribs.append(co), aggm.append(max(co))
    before = _block_scan_excl(aggm, max, 0, suffix=False)
    out = {f: [0] * nc for f in tcp.FIELDS[:-1]}
    last_end = None
    for t in range(threads):
        prev_end = before[t]
        for i in range(items):
            c = t * items + i
            if c >= nc:
                break
            hd, jv, nb = heads[t][i], jvs[t][i], nbs[t][i]
            mstart = c * CELL + jv
            out["has"][c] = hd
            out["mstart"][c] = mstart
            out["offs"][c] = offs_s[c]
            out["mlen"][c] = (nb - c) * CELL - jv if hd else 0
            out["lit_start"][c] = prev_end
            out["lit_len"][c] = mstart - prev_end if hd else 0
            prev_end = max(prev_end, contribs[t][i])
            if c == nc - 1:
                last_end = prev_end
    return out, last_end


def _lz4_n_extra(x):
    return (x - 15) // 255 + 1 if x >= 15 else 0


def _sn_lit_extra(x):
    return 0 if x <= 60 else (1 if x <= 256 else 2)


# csrc/codec.cu's head writers: every byte of a run but its literals, a long
# regular part (an LZ4 255-run of more than 4 bytes, more than four snappy
# copies) handed to `defer(position, length, a, b)`; part_byte(a, b, i) is
# byte i of such a part. mlen < 0 marks the final run.
def _lz4_part_byte(x, _b, i):
    return min(max(x - 255 * i, 0), 255)


def _lz4_run(put, p, length, defer):
    ne = _lz4_n_extra(length)
    if ne > 4:
        defer(p, ne, length - 15, 0)
    else:
        for i in range(ne):
            put(p + i, _lz4_part_byte(length - 15, 0, i))


def _lz4_put_head(put, st, lit, mlen, offs, defer):
    put(st, (min(lit, 15) << 4) | min(max(mlen - 4, 0), 15))
    _lz4_run(put, st + 1, lit, defer)
    if mlen < 0:
        return
    a = st + 1 + _lz4_n_extra(lit) + lit
    put(a, offs & 255)
    put(a + 1, (offs >> 8) & 255)
    _lz4_run(put, a + 2, mlen - 4, defer)


def _sn_part_byte(mlen, offs, i):
    ci, role = divmod(i, 3)
    clen = min(max(mlen - 64 * ci, 1), 64)
    return 2 | ((clen - 1) << 2) if role == 0 else (offs & 255 if role == 1 else (offs >> 8) & 255)


def _sn_put_head(put, st, lit, mlen, offs, defer):
    p = st
    if lit > 0:
        ex = _sn_lit_extra(lit)
        put(p, (lit - 1) << 2 if ex == 0 else (60 << 2 if ex == 1 else 61 << 2))
        for k in range(ex):
            put(p + 1 + k, ((lit - 1) >> (8 * k)) & 255)
        p += 1 + ex + lit
    if mlen < 0:
        return
    nb = 3 * ((mlen + 63) // 64)
    if nb > 12:
        defer(p, nb, mlen, offs)
    else:
        for i in range(nb):
            put(p + i, _sn_part_byte(mlen, offs, i))


REPLAY_CODECS = {
    # size(has, lit, mlen), final_size(f_lit), put_head, part_byte,
    # out_bound, lit_head(lit): where a run's literals start
    "lz4": (
        lambda has, lit, mlen: 1 + _lz4_n_extra(lit) + lit + 2 + _lz4_n_extra(mlen - 4) if has else 0,
        lambda f_lit: 1 + _lz4_n_extra(f_lit) + f_lit,
        _lz4_put_head,
        _lz4_part_byte,
        tlz4.out_bound,
        lambda lit: 1 + _lz4_n_extra(lit),
    ),
    "snappy": (
        lambda has, lit, mlen: ((1 + _sn_lit_extra(lit) + lit if lit > 0 else 0)
                                + 3 * ((mlen + 63) // 64)) if has else 0,
        lambda f_lit: 1 + _sn_lit_extra(f_lit) + f_lit if f_lit > 0 else 0,
        _sn_put_head,
        _sn_part_byte,
        tsnappy.out_bound,
        lambda lit: 1 + _sn_lit_extra(lit),
    ),
}
EMIT_THREADS, DEFER_CAP = 1024, 256


def _replay_emit(codec, row, v, parse, n, src_mis=0, dst_mis=0, threads=EMIT_THREADS):
    """csrc/codec.cu emit_kernel on one row (`row`: its n + CELL bytes),
    the source at `src_mis` bytes past a 16-byte boundary and the output
    row at `dst_mis`: the staged row with its unaligned head and tail, the
    size pass (16-byte loads of four cells a lane) with its one packed
    scan, each sequence's head written by its cell, the long heads by the
    whole block, the per-cell literal bytes and shifts, the literal copy a
    row word a thread (funnel-shifted), and the flush (16-byte stores, the
    row's first and last 16 bytes byte by byte). Returns (the block bytes
    on [0, out_len), out_len)."""
    size_fn, final_size, put_head, part_byte, bound, lit_head = REPLAY_CODECS[codec]
    has, _, offs, mlen, lit_start, lit_len, last_end = parse
    nc, m = n // CELL, bound(n)
    v = min(max(v, 0), n)
    garbage = 0xA5
    # staging: row_s sits src_mis bytes into its buffer, so the source's
    # aligned chunks land on aligned shared addresses
    sbuf = bytearray([garbage]) * (n + CELL + 16)
    base = src_mis
    head = min((16 - src_mis) & 15, v)
    nvec = (v - head) >> 4
    tail = head + 16 * nvec
    for i in range(head):
        sbuf[base + i] = row[i]
    for k in range(nvec):
        x = head + 16 * k
        assert (src_mis + x) % 16 == 0 and (base + x) % 16 == 0, "a cp.async chunk is misaligned"
        sbuf[base + x : base + x + 16] = bytes(row[x : x + 16])
    for i in range(tail, v):
        sbuf[base + i] = row[i]

    # size pass: warp w owns [w * per_warp, (w + 1) * per_warp), lane l the
    # four cells at 4 l of each 128; only the cells below v
    ncv = min(nc, (v + CELL - 1) // CELL)
    per_warp = (ncv + threads * 4 - 1) // (threads * 4) * 128
    for c in range(ncv, nc):
        assert not has[c], "a cell at or past v holds a match"

    def pack(c):
        return (1 << 18) | size_fn(True, lit_len[c], mlen[c]) if c < ncv and has[c] else 0

    cells, wruns = [], []  # (cell, exclusive pack within its warp)
    for w in range(threads // 32):
        wrun = 0
        for i in range(per_warp // 128):
            lanes = [[w * per_warp + 128 * i + 4 * l + k for k in range(4)] for l in range(32)]
            xs = [sum(pack(c) for c in cs) for cs in lanes]
            inc, o = list(xs), 1
            while o < 32:
                y = _shfl(inc, o, False)
                inc = [inc[l] + y[l] if l >= o else inc[l] for l in range(32)]
                o <<= 1
            for l, cs in enumerate(lanes):
                at = wrun + inc[l] - xs[l]
                for c in cs:
                    cells.append((w, c, at))
                    at += pack(c)
            wrun += inc[31]
        wruns.append(wrun)
    bases = _block_scan_excl([wruns[t // 32] if t % 32 == 31 else 0 for t in range(threads)],
                             lambda a, b: a + b, 0, suffix=False)
    total_pk = bases[threads - 1] + wruns[-1]
    ns, total = total_pk >> 18, total_pk & 0x3FFFF
    f_lit = max(v - last_end, 0)
    fl0 = total + lit_head(f_lit)
    out_len = total + final_size(f_lit)

    out_s = bytearray([garbage]) * (m + 32)  # the block, out_s[dst_mis + o] = byte o
    seq_s, def_s = {}, []
    for w, c, at in cells:
        if c < ncv and has[c]:
            at += bases[32 * w]
            for f in (lit_start[c], lit_len[c], mlen[c], offs[c]):
                assert 0 <= f < 1 << 16, "a sequence field does not fit 16 bits"
            seq_s[at >> 18] = (at & 0x3FFFF, lit_start[c], lit_len[c], mlen[c], offs[c])
    assert sorted(seq_s) == list(range(ns))
    seq_s[ns] = (total, last_end, f_lit, -1, 0)  # the final run

    def put(p, val):
        if p < m:
            out_s[dst_mis + p] = val

    def defer(p, length, a, b):
        def_s.append((p, length, a, b))

    for q in range(ns + 1):  # a thread a sequence, the final run last
        st, _, lit, ml, of = seq_s[q]
        put_head(put, st, lit, ml, of, defer)
    assert len(def_s) <= DEFER_CAP

    for p, length, a, b in def_s:  # the deferred parts, each by the block
        for i in range(length):
            put(p + i, part_byte(a, b, i))

    # per cell, in the copy: its literal bytes [lo, hi) and their shift,
    # from the run of the first sequence at or after it (its scan count)
    cell_s = {}
    for w, c, at in cells:
        if c < ncv:
            q = (at + bases[32 * w]) >> 18
            st, ls, lit, _, _ = seq_s[q]
            lend = ls + lit if q < ns else v
            l0 = st + lit_head(lit)
            lo = min(max(ls - CELL * c, 0), CELL)
            hi = min(max(lend - CELL * c, lo), CELL)
            cell_s[c] = (lo, hi, l0 - ls)

    def word(a):  # the little-endian shared word at buffer address a (4-aligned)
        return int.from_bytes(sbuf[a : a + 4], "little")

    for g in range(0, ncv, 32):  # a warp's group of 32 cells, skipped whole without literals
        group = [cell_s.get(g + lane, (CELL, CELL, 0)) for lane in range(32)]
        if not any(lo < hi for lo, hi, _ in group):
            continue
        for wi in range(128):  # lane wi % 32 copies the group's row word wi
            lo, hi, delta = group[wi >> 2]
            x, j0 = CELL * g + 4 * wi, 4 * (wi & 3)
            if hi <= j0 or lo >= j0 + 4:
                continue
            a = base + x
            wv = (((word((a & ~3) + 4) << 32) | word(a & ~3)) >> (8 * (a & 3))) & FULL
            for b in range(4):
                if lo <= j0 + b < hi and x + b + delta < m:
                    out_s[dst_mis + x + b + delta] = (wv >> (8 * b)) & 255

    end = min(out_len, m)
    out = bytearray([0xEE]) * (m + 16)
    for j in range((dst_mis + end + 15) // 16):
        o0 = 16 * j - dst_mis
        if o0 >= 0 and o0 + 16 <= end:
            assert (dst_mis + o0) % 16 == 0
            out[dst_mis + o0 : dst_mis + o0 + 16] = out_s[16 * j : 16 * j + 16]
        else:
            for o in range(max(o0, 0), min(o0 + 16, end)):
                out[dst_mis + o] = out_s[dst_mis + o]
    return bytes(out[dst_mis : dst_mis + end]), out_len


def _roles(codec, parse, v, n):
    """The role of every output byte: token (LZ4 token, snappy tag),
    length (LZ4 255-run bytes, snappy literal length bytes), literal,
    offset."""
    size_fn, final_size, _, _, _, lit_head = REPLAY_CODECS[codec]
    has, _, offs, mlen, lit_start, lit_len, last_end = parse
    roles = []
    for c in range(n // CELL):
        if not has[c]:
            continue
        lit, ml = lit_len[c], mlen[c]
        lh = lit_head(lit)
        if codec == "lz4":
            seq = ["token"] + ["length"] * (lh - 1) + ["literal"] * lit + ["offset"] * 2
            seq += ["length"] * (size_fn(True, lit, ml) - len(seq))
        else:
            seq = (["token"] + ["length"] * (lh - 1) + ["literal"] * lit if lit else [])
            seq += ["token", "offset", "offset"] * ((ml + 63) // 64)
        assert len(seq) == size_fn(True, lit, ml)
        roles += seq
    f_lit = max(min(max(v, 0), n) - last_end, 0)
    if final_size(f_lit):
        fh = lit_head(f_lit)
        roles += ["token"] + ["length"] * (fh - 1) + ["literal"] * f_lit
    return roles


def test_kernel_walk_matches_sorted_candidates():
    """The block's radix sort gives the sort's cand on every sorted
    position (including hash collisions inside a tile)."""
    rows = [b"abcd" * 300, bytes(range(256)) * 4, _ragged(21, count=1, max_len=1)[0] + b"x" * 40]
    rng = np.random.default_rng(2)
    rows.append(rng.integers(0, 4, 1200, dtype=np.uint8).tobytes())  # dense collisions
    rows.append(rng.integers(0, 256, 2000, dtype=np.uint8).tobytes())
    for raw in rows:
        batch, valid, n = _stage([raw])
        d = batch[0]
        h = tcp._hash(torch.from_numpy(batch).to(torch.int64), n)
        want = tcp._candidates(h)[0].numpy()
        walk_end = min(int(valid[0]) + 1, n)
        got = np.array(_replay_candidates(d, walk_end), np.int64)
        got[got == 0xFFFF] = -1
        np.testing.assert_array_equal(got, want[:walk_end])
        # past the sorted positions the row is zeros: cand[p] = p - 1
        np.testing.assert_array_equal(want[walk_end + 1 :], np.arange(walk_end, n - 1))


_jax_cand = jax.jit(lambda d, n: _jax_sorted_candidates(d, n), static_argnums=1)


def _jax_sorted_candidates(d, n):
    """redpanda_tpu/ops/cellparse.py:41-61: the JAX program's candidates
    (each (hash << 17 | pos) key's predecessor in sorted order)."""
    pos = jnp.arange(n, dtype=jnp.int32)
    d32 = d.astype(jnp.uint32)
    gram = d32[pos] | (d32[pos + 1] << 8) | (d32[pos + 2] << 16) | (d32[pos + 3] << 24)
    h = ((gram * jnp.uint32(2654435761)) >> 16).astype(jnp.int32)
    sk = jnp.sort((h.astype(jnp.int64) << 17) | pos.astype(jnp.int64))
    sh, sp = (sk >> 17).astype(jnp.int32), (sk & 0x1FFFF).astype(jnp.int32)
    prev_ok = jnp.concatenate([jnp.zeros(1, bool), sh[1:] == sh[:-1]])
    return jnp.zeros(n, jnp.int32).at[sp].set(jnp.where(prev_ok, jnp.roll(sp, 1), -1))


@pytest.mark.parametrize("n", (512, 65536))
@pytest.mark.parametrize("kind", ("zeros", "one_byte", "distinct"))
def test_kernel_sort_matches_jax_sort(kind, n):
    """The replayed sort against the JAX sort on the skew extremes (an
    all-zero row, one repeated byte: one digit in every tile) and a row
    whose 4-grams are all distinct, at v in {0, 1, 3, 4, 5, n}."""
    full = {"zeros": bytes(n), "one_byte": b"\x61" * n, "distinct": chip_smoke.distinct_grams_row(n)}[kind]
    for v in (0, 1, 3, 4, 5, n):
        d = np.zeros(n + CELL, np.uint8)
        d[:v] = np.frombuffer(full[:v], np.uint8)
        want = np.asarray(_jax_cand(jnp.asarray(d), n)).astype(np.int64)
        walk_end = min(v + 1, n)
        got = np.array(_replay_candidates(d, walk_end), np.int64)
        got[got == 0xFFFF] = -1
        np.testing.assert_array_equal(got, want[:walk_end], err_msg=f"v={v}")
        np.testing.assert_array_equal(want[walk_end + 1 :], np.arange(walk_end, n - 1))


@pytest.mark.parametrize("which", ["payloads", "ragged"])
def test_kernel_replay_matches_plain(which):
    chunks = {"payloads": lambda: list(_payloads().values())[:8],
              "ragged": lambda: _ragged(17, count=4, max_len=2000)}[which]()
    batch, valid, n = _stage(chunks)
    plain = tcp.cell_parse(torch.from_numpy(batch), torch.from_numpy(valid), n)
    blocks = {
        "lz4": tlz4._compress_chunks(torch.from_numpy(batch), torch.from_numpy(valid), n),
        "snappy": tsnappy._compress_chunks(torch.from_numpy(batch), torch.from_numpy(valid), n),
    }
    for i in range(batch.shape[0]):
        fields, last_end = _replay_parse(batch[i], int(valid[i]), n)
        for name, g in zip(tcp.FIELDS[:-1], plain[:-1]):
            np.testing.assert_array_equal(np.array(fields[name], np.int64),
                                          g[i].numpy().astype(np.int64), err_msg=f"row {i} {name}")
        assert last_end == int(plain[-1][i])
        parse = [fields[f] for f in tcp.FIELDS[:-1]] + [last_end]
        for codec, (out, out_len) in blocks.items():
            dst_mis = i * REPLAY_CODECS[codec][4](n) % 16  # the row's place in [B, out_bound(n)]
            got, got_len = _replay_emit(codec, batch[i], int(valid[i]), parse, n, dst_mis=dst_mis)
            assert got_len == int(out_len[i]), (codec, i)
            assert got == out[i, :got_len].numpy().tobytes(), (codec, i)


def _tile_row(kind):
    """"long": 8,000 random bytes, then 1,200 of b"a", 400 random, 300 of
    b"b": the first sequence's head has long parts (LZ4: a 32-byte literal
    length run; snappy: 19 copies after a 61 << 2 tag and its two length
    bytes), which the kernel defers to the block. "short": ten literals before
    the first match."""
    rng = np.random.default_rng(11)
    lead = rng.integers(0, 256, 8000, dtype=np.uint8).tobytes() if kind == "long" else b"0123456789"
    return (lead + b"a" * 1200 + rng.integers(0, 256, 400, dtype=np.uint8).tobytes() + b"b" * 300)


# The block leaves shared memory in 16-byte tiles aligned in device memory;
# a row whose output starts `dst_mis` bytes past a 16-byte boundary has its
# first tile boundary at o = 16 - dst_mis. (row, dst_mis, role before the
# boundary, role after it) putting that boundary right after a token, inside
# a length run and inside a literal run (the tests check the roles)
TILE_ROWS = {
    ("lz4", "token"): ("long", 15, "token", "length"),
    ("lz4", "length"): ("long", 14, "length", "length"),
    ("lz4", "literal"): ("short", 14, "literal", "literal"),
    ("snappy", "token"): ("long", 15, "token", "length"),
    ("snappy", "length"): ("long", 14, "length", "length"),
    ("snappy", "literal"): ("short", 14, "literal", "literal"),
}


def _edge_rows(case, codec):
    """(staged matrix, valid, n, offset) of one emission edge case."""
    rng = np.random.default_rng(23)
    if case.startswith("fused"):
        bodies = [_full_row()[:30000], rng.integers(0, 256, 32768, dtype=np.uint8).tobytes(), b"",
                  b"\x61" * 20001, b"Z"]
        prefixes = [rng.integers(0, 256, tfused.PREFIX, dtype=np.uint8).tobytes() for _ in bodies]
        mat, blen, n = tfused.stage_fused(prefixes, bodies)
        assert mat.shape[1] == n + 56
        return mat, blen, n, tfused.PREFIX
    if case == "cells17":  # n = 272: 17 cells a row, not a multiple of four
        n = 272
        chunks = [_full_row()[:n], rng.integers(0, 256, n, dtype=np.uint8).tobytes(), b"a" * 200, b""]
        batch = np.zeros((len(chunks), n + CELL), np.uint8)
        for i, c in enumerate(chunks):
            batch[i, : len(c)] = np.frombuffer(c, np.uint8)
        return batch, np.array([len(c) for c in chunks], np.int32), n, 0
    chunks = {
        "random_64k": lambda: [rng.integers(0, 256, 65536, dtype=np.uint8).tobytes()],
        "one_byte_64k": lambda: [b"\x61" * 65536],
        "v0": lambda: [b""],
        "v1": lambda: [b"Z"],
        "near_empty_and_full": lambda: [b"Z", _full_row(), b"", rng.integers(0, 256, 65536, dtype=np.uint8).tobytes()],
        "tile_token": lambda: [_tile_row(TILE_ROWS[(codec, "token")][0])],
        "tile_length": lambda: [_tile_row(TILE_ROWS[(codec, "length")][0])],
        "tile_literal": lambda: [_tile_row(TILE_ROWS[(codec, "literal")][0])],
    }[case]()
    batch, valid, n = _stage(chunks)
    return batch, valid, n, 0


EDGE_CASES = ("random_64k", "one_byte_64k", "v0", "v1", "fused_offset40", "near_empty_and_full",
              "tile_token", "tile_length", "tile_literal", "cells17")


@pytest.mark.parametrize("codec", ["lz4", "snappy"])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_kernel_replay_edges_match_plain_and_jax(case, codec):
    """The emission's edge rows, each through the replayed kernel (the
    source's and the output row's alignment as on the card), the plain
    version and the JAX program: an all-random 64 KiB row (no sequence,
    the longest final literal), one repeated byte (one long match: LZ4
    255-runs, 64-byte snappy copies), v = 0 and v = 1, fused rows read at
    offset 40 (bodies 8-byte but not 16-byte aligned), a near-empty row
    beside full ones, rows whose first 16-byte tile boundary falls right
    after a token, inside a length run and inside a literal run (the long
    rows also split a head between its sequence and the block), and rows
    of 17 cells (n = 272), where the size pass loads cells one by one."""
    jmod, tmod = {"lz4": (jlz4, tlz4), "snappy": (jsnappy, tsnappy)}[codec]
    data, valid, n, offset = _edge_rows(case, codec)
    td, tv = torch.from_numpy(data), torch.from_numpy(valid)
    out, out_len = tmod._compress_chunks(td, tv, n, offset)
    jout, jlen = jmod._compress_chunks(jnp.asarray(data[:, offset : offset + n + CELL]), jnp.asarray(valid), n)
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(jlen))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    parse = tcp.cell_parse(td, tv, n, offset)
    m = tmod.out_bound(n)
    stride = data.shape[1]
    for i in range(data.shape[0]):
        fields = [t[i].to(torch.int64).tolist() for t in parse[:-1]] + [int(parse[-1][i])]
        dst_mis = i * m % 16  # the row's place in [B, out_bound(n)]
        if case.startswith("tile_"):
            _, dst_mis, before, after = TILE_ROWS[(codec, case[5:])]
            roles = _roles(codec, fields, int(valid[i]), n)
            assert (roles[15 - dst_mis], roles[16 - dst_mis]) == (before, after)
        for threads in (1024, 512):  # the block at <= 132 rows a launch, and past that
            got, got_len = _replay_emit(codec, data[i, offset : offset + n + CELL], int(valid[i]), fields, n,
                                        src_mis=(i * stride + offset) % 16, dst_mis=dst_mis, threads=threads)
            assert got_len == int(out_len[i]), (case, codec, i, threads)
            assert got == out[i, :got_len].numpy().tobytes(), (case, codec, i, threads)
    if case == "random_64k":
        assert int(parse[0].sum()) == 0  # no sequence: the whole block is the final run
        assert int(out_len[0]) == (65536 + 1 + (65536 - 15) // 255 + 1 if codec == "lz4" else 65536 + 3)
    if case == "fused_offset40":
        assert {(i * stride + offset) % 16 for i in range(data.shape[0])} == {0, 8}


def test_chip_smoke_decoders_read_port_frames(monkeypatch):
    """chip_smoke.py decodes the card's frames without liblz4/libsnappy:
    its decoders must read what the port writes."""
    monkeypatch.setattr(tlz4, "DEFAULT_DEVICE", "cpu")
    monkeypatch.setattr(tsnappy, "DEFAULT_DEVICE", "cpu")
    monkeypatch.setattr(tfused, "DEFAULT_DEVICE", "cpu")
    monkeypatch.setenv("RP_CODEC_BACKEND", "device")
    bufs = list(_payloads().values()) + [_full_row()]
    for data, frame, stream in zip(
        bufs, tbackend.compress_many(bufs), tbackend.compress_many_snappy(bufs)
    ):
        assert chip_smoke.lz4_frame_decode(frame) == data
        assert chip_smoke.xerial_decode(stream) == data
        assert chip_smoke.xerial_decode(snappy_codec.compress_java(data)) == data
    batches = chip_smoke.build_batches(np.random.default_rng(1), count=4)
    for b in batches:
        out = b.recompressed(CompressionType.lz4, verify_crc=b.header.crc)
        assert chip_smoke.lz4_frame_decode(out.body) == b.body
    with pytest.raises(ValueError):
        chip_smoke.lz4_frame_decode(b"\x00" * 16)
