"""Port vs reference: the fused CRC + LZ4 / snappy kernel's scheme
(csrc/fused.cu).

The kernel runs only on a card. Its arithmetic is replayed here in numpy,
step for step, and held against the JAX package and the plain versions:

  * the cluster-wide stable LSD radix sort: each CTA's run of the keys
    (hash << 16 | pos), its warps' runs and 32-key steps (lane masks
    beside running offsets), the CTAs' digit counts pushed to every CTA,
    the offsets over (digit, CTA, warp) digit-major, each key stored at
    its rank's owner; then each rank's predecessor where the hashes
    agree (a CTA's first rank reads its neighbour's last). Against the
    JAX program's sorted candidates at C in {2, 8, 16};
  * the CRC split over the cluster: 16-byte units counted from the row's
    end, P a CTA and K a thread, the initial 0xFFFFFFFF folded into the
    first four bytes, the lanes', warps' and CTAs' joins by the operators
    ops/fused.py builds for the shape, against utils/crc on prefix || body;
  * the per-CTA scans joined by the two exchanges (absorption across a
    CTA boundary, run ends from the later CTAs, the first sequence's
    literal start from the earlier ones) and each CTA's output range,
    against the plain parse and the plain LZ4 and snappy emissions, and
    each codec's range_bound (csrc/lz77.cuh) against the largest range;
  * the wrapper's plan (the cluster size by rows, bucket and the card's
    resident clusters of the codec's kernel, skipping a size whose
    shared memory does not fit) and its refusal to route a failed launch
    anywhere else; the CPU path of both entries, the plain chain.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from redpanda_tpu.ops import fused as jfused
from test_torch_codecs import _jax_cand  # the JAX program's sorted candidates
from redpanda_tpu_torch.ops import _build
from redpanda_tpu_torch.ops import cellparse as tcp
from redpanda_tpu_torch.ops import crc32c as tcrc
from redpanda_tpu_torch.ops import fused as tfused
from redpanda_tpu_torch.ops import lz4 as tlz4
from redpanda_tpu_torch.ops import snappy as tsnappy
from redpanda_tpu_torch.utils import crc as host_crc

CELL = tcp.CELL
FULL = 0xFFFFFFFF
THREADS = tfused.FUSED_THREADS
WARPS = THREADS // 32


def cdiv(a, b):
    return -(-a // b)


# ------------------------------------------------------------ the sort
def _keys(d, walk_end):
    d = np.asarray(d, np.int64)
    pos = np.arange(walk_end)
    gram = d[pos] | d[pos + 1] << 8 | d[pos + 2] << 16 | d[pos + 3] << 24
    return (((gram * 2654435761) & FULL) >> 16) << 16 | pos


def _replay_pass(keys_of, walk_end, c, shift):
    """One pass of the kernel's cluster sort. keys_of(k) gives CTA k's
    input keys (its ranks [k run, (k + 1) run) of the previous order);
    returns each CTA's output buffer as it stands after the barrier."""
    run = cdiv(walk_end, c)
    wrun = cdiv(cdiv(run, WARPS), 32) * 32
    assert wrun // 32 <= 16, "the keys a lane holds (csrc/fused.cu max_kpt)"
    cta_keys = [keys_of(k) for k in range(c)]
    # count: each warp's digits (shared atomics), each CTA's 256 totals into every CTA
    cnt = np.zeros((c, WARPS, 256), np.int64)
    for k, ks in enumerate(cta_keys):
        for w in range(WARPS):
            part = ks[w * wrun : (w + 1) * wrun]
            np.add.at(cnt[k, w], (part >> shift) & 255, 1)
    inbox = cnt.sum(axis=1)  # [CTA, digit], what every CTA holds after the barrier
    out = [np.full(min(run, max(walk_end - k * run, 0)), -1, np.int64) for k in range(c)]
    tot = inbox.sum(axis=0)
    for k, ks in enumerate(cta_keys):
        # thread (dig, q4): the digit's base (a block scan of the totals,
        # q4 == 0 contributing), the earlier CTAs' counts, the earlier
        # quarters', then its eight warps in order
        base = np.cumsum(tot) - tot
        bef = inbox[:k].sum(axis=0)
        off = np.zeros((WARPS, 256), np.int64)
        for q4 in range(4):
            x_before = cnt[k, : 8 * q4].sum(axis=0)
            o = base + bef + x_before
            for w in range(8 * q4, 8 * q4 + 8):
                off[w] = o
                o = o + cnt[k, w]
        # the stable scatter: 32 keys a step, lane masks beside running offsets
        for w in range(WARPS):
            part = ks[w * wrun : (w + 1) * wrun]
            for s0 in range(0, part.size, 32):
                step = part[s0 : s0 + 32]
                dig = (step >> shift) & 255
                lanes = np.arange(step.size)
                same = (dig[:, None] == dig[None, :]) & (lanes[None, :] < lanes[:, None])
                rank = off[w, dig] + same.sum(axis=1)
                owner = rank // run
                for key, r, ow in zip(step, rank, owner):
                    assert out[ow][r - ow * run] == -1, "two keys at one rank"
                    out[ow][r - ow * run] = key
                np.add.at(off[w], dig, 1)
    return out, run


def _replay_cluster_candidates(d, walk_end, c):
    """The kernel's cand for positions [0, walk_end): two passes, then
    each rank's predecessor where the hashes agree (the first rank of a
    CTA reads the previous CTA's last), stored with the position."""
    keys0 = _keys(d, walk_end)
    run = cdiv(walk_end, c)
    a, run = _replay_pass(lambda k: keys0[k * run : min((k + 1) * run, walk_end)], walk_end, c, 16)
    b, run = _replay_pass(lambda k: a[k], walk_end, c, 24)
    cand = np.full(walk_end, -2, np.int64)
    for k in range(c):
        for i, key in enumerate(b[k]):
            g = k * run + i
            cc = -1
            if g > 0:
                prev = b[k][i - 1] if i > 0 else b[k - 1][run - 1]
                if prev >> 16 == key >> 16:
                    cc = prev & 0xFFFF
            cand[key & 0xFFFF] = cc
    assert (cand >= -1).all()
    return cand


def _sort_row(kind, n):
    rng = np.random.default_rng(41)
    return {
        "zeros": bytes(n),
        "one_byte": b"\x61" * n,
        "distinct": chip_smoke.distinct_grams_row(n),
        "random": rng.integers(0, 256, n, dtype=np.uint8).tobytes(),
        "collisions": rng.integers(0, 4, n, dtype=np.uint8).tobytes(),
    }[kind]


def _sort_lengths(n, c):
    """v in {0, 1, 3, 4, 5, n} and where walk_end = v + 1 lands at every
    CTA run boundary of the full row, +- 1."""
    run = cdiv(n, c)
    vs = {0, 1, 3, 4, 5, n}
    for k in range(1, c):
        vs |= {k * run - 2, k * run - 1, k * run}
    return sorted(v for v in vs if 0 <= v <= n)


@pytest.mark.parametrize("c", (2, 8, 16))
@pytest.mark.parametrize("kind", ("zeros", "one_byte", "distinct", "random", "collisions"))
def test_cluster_sort_matches_jax_at_512(kind, c):
    n = 512
    full = _sort_row(kind, n)
    for v in _sort_lengths(n, c):
        d = np.zeros(n + CELL, np.uint8)
        d[:v] = np.frombuffer(full[:v], np.uint8)
        walk_end = min(v + 1, n)
        want = np.asarray(_jax_cand(jnp.asarray(d), n)).astype(np.int64)
        got = _replay_cluster_candidates(d, walk_end, c)
        np.testing.assert_array_equal(got, want[:walk_end], err_msg=f"v={v}")


@pytest.mark.parametrize("c", (2, 8, 16))
@pytest.mark.parametrize("kind", ("one_byte", "distinct", "collisions"))
def test_cluster_sort_matches_jax_at_65536(kind, c):
    """The full bucket (C = 2 would sort 32,768 keys a CTA, more than the
    kernel's registers hold: the plan never takes it at n = 65,536, so the
    replay runs it on the first half of the row)."""
    n = 65536
    full = _sort_row(kind, n)
    lengths = (0, 5, n // 2 - 1) if c == 2 else (0, 5, cdiv(n, c) - 1, cdiv(n, c), n)
    for v in lengths:
        d = np.zeros(n + CELL, np.uint8)
        d[:v] = np.frombuffer(full[:v], np.uint8)
        walk_end = min(v + 1, n)
        want = np.asarray(_jax_cand(jnp.asarray(d), n)).astype(np.int64)
        got = _replay_cluster_candidates(d, walk_end, c)
        np.testing.assert_array_equal(got, want[:walk_end], err_msg=f"v={v}")


# ------------------------------------------------------------- the CRC
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


def _replay_crc(msg: bytes, n: int, c: int, align: int) -> int:
    """The kernel's CRC of msg (a row of bucket n): the row staged `align`
    bytes past a 16-byte boundary after 16 lead bytes of garbage; CTA k
    folding the units [k P, (k + 1) P) counted from the end, its thread t
    the K units [k P + t K, ... + K) (words read by funnel shifts of
    aligned words), joined across lanes (warps with units only), warps and
    CTAs by crc_ops_for(n, c), CTA 0 xoring the parts."""
    ops = tfused.crc_ops_for(n, c)
    piece, k = tfused.crc_piece(n, c)
    length = len(msg)
    smem = np.full(32 + length + 48, 0xA5, np.uint8)
    base = 16 + align
    smem[base : base + length] = np.frombuffer(msg, np.uint8)

    def row_words(x):  # the four bytes at each x (x may be -3..-1: lead garbage), as the funnel shift reads them
        idx = base + x[:, None] + np.arange(4)[None, :]
        return (smem[idx].astype(np.uint32) << (np.arange(4, dtype=np.uint32) * 8)).sum(axis=1, dtype=np.uint64).astype(np.uint32)

    nu = cdiv(length, 16)
    crc = np.uint32(0)
    t = np.arange(THREADS)
    for cta in range(c):
        p0, p1 = cta * piece, min(cta * piece + piece, nu)
        f = np.zeros(THREADS, np.uint32)
        for u in range(k - 1, -1, -1):  # each thread's units, the earliest bytes first
            e = p0 + t * k + u
            live = (e < p1) & (t * k + u < piece)  # no unit, or wholly before the row: skipped
            x0 = length - 16 * (e + 1)
            for w in range(4):
                x = np.where(live, x0 + 4 * w, 0)
                wd = np.where(x > -4, row_words(np.maximum(x, -3)), np.uint32(0)).astype(np.uint32)
                neg = np.minimum(-x, 4).clip(0) * 8
                pre = np.where(x < 0, (np.uint64(FULL) << neg.astype(np.uint64)) & np.uint64(FULL), np.uint64(FULL))
                wd &= pre.astype(np.uint32)
                init = np.where(x >= 0, np.uint64(FULL) >> (np.clip(x, 0, 4) * 8).astype(np.uint64), pre)
                wd ^= np.where(x < 4, init, 0).astype(np.uint32)
                f = np.where(live, _slice4(f, wd), f)
        lanes = f.reshape(WARPS, 32)
        active = np.array([p0 + 32 * w * k < p1 for w in range(WARPS)])
        for j in range(5):  # lanes: v ^= Z^(16 K 2^j)(the lane 2^j above), warps with units only
            up = np.concatenate([lanes[:, 1 << j :], lanes[:, -(1 << j) :]], axis=1)
            lanes = np.where(active[:, None], lanes ^ _apply(ops[j], up), lanes)
        warps = lanes[:, 0]
        w_n = cdiv(piece, 32 * k)  # the warps that hold units: ceil(log2 W) levels
        for j in range(5):
            if 1 << j >= w_n:
                break
            up = np.concatenate([warps[1 << j :], warps[-(1 << j) :]])
            warps = warps ^ _apply(ops[5 + j], up)
        part = warps[0]
        if cta > 0:
            part = _apply(ops[10 + cta - 1], np.array([part], np.uint32))[0]
        crc ^= part
    if length < 4:
        crc ^= np.uint32(FULL >> (8 * length))
    return int(crc ^ np.uint32(FULL))


@pytest.mark.parametrize("n,c", ((512, 2), (32768, 2), (32768, 8), (2048, 16)))
def test_split_crc_matches_host(n, c):
    """Lengths 0-3 (the final term), every start alignment, and rows
    ending on and beside the unit, thread, warp and CTA piece boundaries
    (16, 16 K, 16 K 32, 16 P); (32768, 2) takes K = 2 units a thread."""
    piece, k = tfused.crc_piece(n, c)
    rng = np.random.default_rng(n + c)
    lengths = [0, 1, 2, 3, 4, 5, 15, 16, 17, 40, 41, tfused.PREFIX + n]
    for b in (16, 16 * k, 16 * k * 32, 16 * piece, 16 * piece * 2):
        lengths += [b - 1, b, b + 1]
    for length in sorted({x for x in lengths if x <= tfused.PREFIX + n}):
        msg = rng.integers(0, 256, length, dtype=np.uint8).tobytes()
        for align in ((0, 8, 15) if length > 200 else range(16)):
            assert _replay_crc(msg, n, c, align) == host_crc.crc32c(msg), (length, align)


def test_crc_pieces_cover_the_row():
    """P units a CTA and K a thread: the cluster covers PREFIX + n bytes,
    the W = ceil(P / 32 K) warps holding them are a CTA's at most, and a
    lane folds about CRC_LANE_UNITS units (more only past 32 warps)."""
    for n in (512, 2048, 32768, 65536):
        for c in tfused.CLUSTERS:
            piece, k = tfused.crc_piece(n, c)
            assert 16 * piece * c >= tfused.PREFIX + n > 16 * (piece - 1) * c
            w = cdiv(piece, 32 * k)
            assert w <= WARPS and 32 * w * k >= piece
            assert k <= tfused.CRC_LANE_UNITS or w == WARPS


def test_crc_operators_append_zeros():
    """crc_ops_for's operators: Z^(16 K 2^j), Z^(16 K 32 2^j) and
    Z^(16 P r), checked by extending registers with zero bytes."""
    n, c = 32768, 2
    piece, k = tfused.crc_piece(n, c)
    ops = tfused.crc_ops_for(n, c)
    amounts = [16 * k << j for j in range(5)] + [16 * k * 32 << j for j in range(5)]
    amounts += [16 * piece * r for r in range(1, tfused.CTA_OPS + 1)]
    rng = np.random.default_rng(3)
    regs = rng.integers(0, 2**32, 4, dtype=np.uint64).astype(np.uint32)
    for op, amount in zip(ops, amounts):
        if amount > 70000:  # the byte-wise walk below is slow past a row
            continue
        want = regs.copy()
        for _ in range(amount):  # one zero byte: r = T0[r & 255] ^ (r >> 8)
            want = tcrc._TABLES[0][want & 255] ^ (want >> np.uint32(8))
        np.testing.assert_array_equal(_apply(op, regs), want, err_msg=str(amount))


# ---------------------------------------------- the scans and the ranges
def _lz4_extra(x):
    return (x - 15) // 255 + 1 if x >= 15 else 0


def _lz4_size(lit, mlen):
    return 1 + _lz4_extra(lit) + lit + 2 + _lz4_extra(mlen - 4)


def _snappy_lit_size(lit):
    return 1 + (0 if lit <= 60 else 1 if lit <= 256 else 2) + lit if lit > 0 else 0


def _snappy_size(lit, mlen):
    return _snappy_lit_size(lit) + 3 * cdiv(mlen, 64)


# csrc/lz77.cuh: a sequence's bytes (size), the final run's (final_size)
# and range_bound(n, cells), the bytes a CTA's range of `cells` cells may take
CODEC_RULES = {
    "lz4": (_lz4_size, lambda f: 1 + _lz4_extra(f) + f, lambda n, cells: n + n // 255 + 5 * cells + 2),
    "snappy": (_snappy_size, _snappy_lit_size, lambda n, cells: n + 3 * cells + 3),
}


def _replay_cluster_scans(has, j, offs, v, n, c, codec="lz4", fixups=None):
    """The kernel's steps after the verification, CTA by CTA: absorption
    inside each CTA, exchange 1 (first and last cells, least boundary
    after the first), run ends from the later CTAs, local literal starts
    and sizes, exchange 2 (the run end and size sum a CTA, its first
    sequence), each CTA's base, ranges and sequences, by the codec's
    sizes. Returns (sequences as (cell, start, lit_start, lit, mlen,
    offs), f_start, out_len, [(base, end)] a CTA); `fixups` (a list)
    takes (local literals, literals) of each CTA's first sequence."""
    size, final_size, _ = CODEC_RULES[codec]
    walk_end = min(v + 1, n)
    ncw = cdiv(walk_end, CELL)
    cpc = cdiv(ncw, c)
    nobnd = 1 << 31
    s1, cells = [], []
    for k in range(c):
        lo, hi = min(k * cpc, ncw), min(min(k * cpc, ncw) + cpc, ncw)
        hd, bnd = [], []
        for cc in range(lo, hi):
            ab = cc > lo and has[cc] and has[cc - 1] and j[cc] == 0 and offs[cc] == offs[cc - 1]
            hd.append(bool(has[cc]) and not ab)
            bnd.append(nobnd if ab else cc)
        cells.append((lo, hi, hd, bnd))
        s1.append(dict(ncell=hi - lo, first=(has[lo], j[lo], offs[lo]) if hi > lo else (0, 0, 0),
                       last=(has[hi - 1], offs[hi - 1]) if hi > lo else (0, 0),
                       min_rest=min(bnd[1:], default=nobnd)))

    def first_absorbed(r):
        return (r > 0 and s1[r]["ncell"] > 0 and s1[r]["first"][0] and s1[r - 1]["last"][0]
                and s1[r]["first"][1] == 0 and s1[r]["first"][2] == s1[r - 1]["last"][1])

    s2, local = [], []
    for k in range(c):
        lo, hi, hd, bnd = cells[k]
        if hi > lo and first_absorbed(k):
            hd[0], bnd[0] = False, nobnd
        after = nobnd
        for r in range(c - 1, k, -1):
            if s1[r]["ncell"]:
                after = min(after, min(nobnd if first_absorbed(r) else r * cpc, s1[r]["min_rest"]))
        nb, r = [0] * len(bnd), after
        for i in range(len(bnd) - 1, -1, -1):
            nb[i], r = r, min(r, bnd[i])
        seqs, pe, total, first = [], 0, 0, None
        for i, cc in enumerate(range(lo, hi)):
            if hd[i]:
                mstart, mlen = cc * CELL + j[cc], (nb[i] - cc) * CELL - j[cc]
                if pe == 0:
                    first = (mstart, mlen)
                seqs.append([cc, total, pe, mstart, mlen, offs[cc]])
                total += size(mstart - pe, mlen)
                pe = nb[i] * CELL
        local.append(seqs)
        s2.append(dict(max_contrib=pe, size_sum=total, heads=len(seqs), first=first))
    incoming, base, bases, ranges = 0, 0, [], []
    for r in range(c):
        t, fix = s2[r]["size_sum"], 0
        if s2[r]["heads"]:
            ms, ml = s2[r]["first"]
            fix = size(ms - incoming, ml) - size(ms, ml)
            if fixups is not None:
                fixups.append((ms, ms - incoming))
        bases.append((base, incoming, fix))
        base += t + fix
        incoming = max(incoming, s2[r]["max_contrib"])
    total, f_start = base, incoming
    f_lit = max(v - f_start, 0)
    out_len = total + final_size(f_lit)
    seqs = []
    for k in range(c):
        b0, inc, fix = bases[k]
        for q, (cc, before, pe, mstart, mlen, of) in enumerate(local[k]):
            ls = inc if q == 0 else pe
            seqs.append((cc, b0 + before + (fix if q else 0), ls, mstart - ls, mlen, of))
        end = out_len if k == c - 1 else (bases[k + 1][0] if k + 1 < c else total)
        ranges.append((b0, end))
    return seqs, f_start, out_len, ranges


def _scan_rows():
    rng = np.random.default_rng(17)
    long_lead = rng.integers(0, 256, 8000, dtype=np.uint8).tobytes()
    return [
        b"the quick brown fox jumps over the lazy dog. " * 90,
        b"a" * 4000,  # one absorbed run across every CTA boundary
        long_lead + b"a" * 1200 + rng.integers(0, 256, 400, dtype=np.uint8).tobytes() + b"b" * 300,
        chip_smoke.json_text(rng, 16000),
        rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(),  # no sequence: the final run alone
        b"",
        b"xyz",
    ]


@pytest.mark.parametrize("c", (2, 4, 8, 16))
def test_cluster_scans_match_plain(c):
    """The per-CTA scans and the two exchanges give the plain parse's
    sequences and the plain LZ4 emission's starts and length, and the
    CTAs' output ranges tile [0, out_len)."""
    bodies = _scan_rows()
    batch, valid, n = tlz4.stage_chunks(tlz4.as_arrays(bodies), "lz4")
    data, vt = torch.from_numpy(batch), torch.from_numpy(valid)
    parse = [t.numpy() for t in tcp.cell_parse(data, vt, n)]
    _, out_len = tlz4.lz4_emit(data, vt, tcp.cell_parse(data, vt, n), n)
    has, mstart, offs, mlen, lit_start, lit_len, last_end = parse
    for i, body in enumerate(bodies):
        v = len(body)
        # the verification's per-cell outputs, before absorption (the plain
        # parse reports only the heads)
        raw_has, raw_j, raw_offs = _raw_cells(batch[i], v, n)
        seqs, f_start, got_len, ranges = _replay_cluster_scans(raw_has, raw_j, raw_offs, v, n, c)
        heads = np.flatnonzero(has[i])
        assert [s[0] for s in seqs] == heads.tolist()
        starts = np.cumsum([0] + [_lz4_size(lit_len[i][h], mlen[i][h]) for h in heads])[:-1]
        for s, h, st in zip(seqs, heads, starts):
            assert s[1:] == (st, lit_start[i][h], lit_len[i][h], mlen[i][h], offs[i][h]), (i, h)
        assert f_start == last_end[i] and got_len == int(out_len[i]), i
        assert ranges[0][0] == 0 and ranges[-1][1] == got_len
        for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
            assert a0 <= a1 == b0


def _adjacent_matches_row():
    """P | Q | P[:512] | Q[:512] | random: the run copying P ends at byte
    2,560 (cell 160), where the copy of Q starts at another offset, so the
    sequence there has no literals; with v = 5,119 (320 cells walked)
    cell 160 starts a CTA at C = 2, 4, 8 and 16, so that CTA sizes its
    first sequence with 2,560 literals until the fix-up takes them all
    away (snappy: its literal tag too)."""
    rng = np.random.default_rng(29)
    p = rng.integers(0, 256, 1024, dtype=np.uint8).tobytes()
    q = rng.integers(0, 256, 1024, dtype=np.uint8).tobytes()
    return p + q + p[:512] + q[:512] + rng.integers(0, 256, 2047, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("c", (2, 4, 8, 16))
@pytest.mark.parametrize("codec", ("lz4", "snappy"))
def test_cluster_scans_match_plain_by_codec(codec, c):
    """The per-CTA scans and the two exchanges, with the codec's sizes,
    give the plain parse's sequences and the plain emission's starts and
    length (snappy: a zero-literal sequence has no tag, the final run
    none when it is empty), the CTAs' ranges tile [0, out_len), and the
    fix-up takes a CTA's first sequence from local literals to none."""
    bodies = _scan_rows() + [_adjacent_matches_row()]
    batch, valid, n = tlz4.stage_chunks(tlz4.as_arrays(bodies), codec)
    data, vt = torch.from_numpy(batch), torch.from_numpy(valid)
    parse = [t.numpy() for t in tcp.cell_parse(data, vt, n)]
    emit = tlz4.lz4_emit if codec == "lz4" else tsnappy.snappy_emit
    _, out_len = emit(data, vt, tcp.cell_parse(data, vt, n), n)
    has, mstart, offs, mlen, lit_start, lit_len, last_end = parse
    size = CODEC_RULES[codec][0]
    fixups = []
    for i, body in enumerate(bodies):
        v = len(body)
        raw_has, raw_j, raw_offs = _raw_cells(batch[i], v, n)
        seqs, f_start, got_len, ranges = _replay_cluster_scans(raw_has, raw_j, raw_offs, v, n, c, codec, fixups)
        heads = np.flatnonzero(has[i])
        assert [s[0] for s in seqs] == heads.tolist()
        starts = np.cumsum([0] + [size(lit_len[i][h], mlen[i][h]) for h in heads])[:-1]
        for s, h, st in zip(seqs, heads, starts):
            assert s[1:] == (st, lit_start[i][h], lit_len[i][h], mlen[i][h], offs[i][h]), (i, h)
        assert f_start == last_end[i] and got_len == int(out_len[i]), i
        assert ranges[0][0] == 0 and ranges[-1][1] == got_len
        for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
            assert a0 <= a1 == b0
    assert any(local > 0 and lit == 0 for local, lit in fixups), "no first sequence lost all its literals"


def _edge_rows(n):
    return {"one_byte": b"a" * n, "distinct": chip_smoke.distinct_grams_row(n),
            "random": np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes(), "zeros": bytes(n)}


@pytest.mark.parametrize("n", (512, 65536))
@pytest.mark.parametrize("codec", ("lz4", "snappy"))
def test_range_bound_holds_every_cta_range(codec, n):
    """Each codec's range_bound(n, ceil(n / 16 / C)) (Layout's image
    region less its 32 bytes of alignment) is at least every CTA's output
    range on the skew edges (one repeated byte: one sequence whose copies
    the owner defers; distinct 4-grams and random bytes: the final run
    alone; zeros), at v in {0, 1, 3, 4, 5, n} and C = 2 to 16, and the
    replay's length is the plain emission's."""
    _, _, bound = CODEC_RULES[codec]
    emit = tlz4.lz4_emit if codec == "lz4" else tsnappy.snappy_emit
    for kind, full in _edge_rows(n).items():
        bodies = [full[:v] for v in (0, 1, 3, 4, 5, n)]
        batch, valid, nn = tlz4.stage_chunks(tlz4.as_arrays(bodies), codec)
        data, vt = torch.from_numpy(batch), torch.from_numpy(valid)
        _, out_len = emit(data, vt, tcp.cell_parse(data, vt, nn), nn)
        for i, body in enumerate(bodies):
            raw = _raw_cells_of(batch[i].tobytes(), len(body), nn)
            for c in tfused.CLUSTERS:
                _, _, got_len, ranges = _replay_cluster_scans(*raw, len(body), nn, c, codec)
                assert got_len == int(out_len[i]), (kind, len(body), c)
                widest = max(e - b for b, e in ranges)
                assert widest <= bound(nn, cdiv(nn // CELL, c)), (kind, len(body), c, widest)


@functools.cache
def _raw_cells_of(row: bytes, v, n):
    """_raw_cells of a staged row, once a row for both codecs' tests."""
    return _raw_cells(np.frombuffer(row, np.uint8), v, n)


def _raw_cells(d, v, n):
    """has / j / offs per cell as the verification leaves them (before
    absorption): the plain parse with absorption taken back out, from the
    JAX program's own steps (ops/cellparse.py _parse_rows)."""
    dt = torch.from_numpy(np.asarray(d)[None, : n + CELL]).to(torch.int64)
    vt = torch.tensor([v], dtype=torch.int64)
    cand = tcp._candidates(tcp._hash(dt, n))
    pos = torch.arange(n)
    cell_end = (pos // CELL + 1) * CELL
    cap = torch.minimum(cell_end[None, :], vt[:, None]) - pos[None, :]
    k = torch.arange(CELL)
    dp = torch.gather(dt, 1, (pos[:, None] + k[None, :]).reshape(1, -1)).view(1, n, CELL)
    eligible = (cap >= 4) & (cell_end[None, :] <= vt[:, None] - 12)

    def verify(q):
        qk = torch.clamp(q[:, :, None] + k, 0, n - 1).reshape(1, -1)
        eq = (dp == torch.gather(dt, 1, qk).view(1, n, CELL)) & (k < cap[:, :, None])
        return (torch.cumprod(eq.to(torch.int32), dim=2).sum(dim=2) == cap) & eligible & (q >= 0)

    def follow(c):
        return torch.where(c >= 0, torch.gather(cand, 1, torch.clamp(c, 0, n - 1)), -1)

    c1 = cand
    c2 = follow(c1)
    c3 = follow(c2)
    g1, g2, g3 = verify(c1), verify(c2), verify(c3)
    good = (g1 | g2 | g3).view(n // CELL, CELL)
    sel = torch.where(g1, c1, torch.where(g2, c2, c3))[0]
    has = good.any(dim=1)
    j = torch.where(has, torch.where(good, k, CELL).min(dim=1).values, 0)
    ms = torch.arange(n // CELL) * CELL + j
    offs = torch.where(has, ms - sel[ms], 0)
    return has.numpy().astype(np.int64), j.numpy().astype(np.int64), offs.numpy().astype(np.int64)


# ------------------------------------------------------------- the plan
# an H100's resident clusters of each size at one CTA an SM (the card's
# cudaOccupancyMaxActiveClusters; PERF.md), and a smaller card's
H100 = {2: 66, 4: 30, 8: 15, 16: 7}
SMALL = {2: 20, 4: 8, 8: 3, 16: 1}


def test_plan_by_rows_and_resident_clusters():
    """C from the row count and the card's resident clusters: the one-row
    size while every cluster is resident, halved until it is, never
    below the bucket's least size (n = 65,536 sorts its keys at C >= 4)."""
    one = tfused.CLUSTER_ONE_ROW
    assert tfused.min_cluster(65536) == 4 and tfused.min_cluster(32768) == 2
    for card in (H100, SMALL):
        for b in (1, 2, 4, 8, 15, 16, 30, 31, 64, 66, 67, 128, 256, 1024):
            for n in (512, 32768, 65536):
                c = tfused.plan(b, n, card)
                floor = tfused.min_cluster(n)
                assert c in tfused.CLUSTERS and floor <= c <= max(one, floor)
                assert b <= card[c] or c == floor  # resident, unless at the floor
                assert c == max(one, floor) or b > card[c * 2]  # the largest resident size
    assert tfused.plan(1, 32768, H100) == one
    assert [tfused.plan(b, 32768, H100) for b in (15, 16, 30, 31, 66, 67)] == [8, 4, 4, 2, 2, 2]


def test_plan_skips_sizes_the_shared_memory_refuses(monkeypatch):
    """A size the card reports no resident cluster of (its shared memory
    does not fit: rp_fused_shape) is never chosen, also as the floor: at
    n = 65,536 without C = 4 the floor is 8; with no size left plan
    raises. `sizes`, which the harnesses hold every size of, lists what
    plan can choose. plan_for reads the codec's own resident clusters."""
    refused = {**H100, 4: 0}
    assert tfused.sizes(65536, refused) == [8, 16] and tfused.sizes(65536, H100) == [4, 8, 16]
    assert tfused.sizes(512, H100) == list(tfused.CLUSTERS)
    for b in (1, 7, 8, 15, 16, 30, 31, 256):
        c = tfused.plan(b, 65536, refused)
        assert c in tfused.sizes(65536, refused) and refused[c] > 0
        assert c == 16 or b > refused[16]
    assert tfused.plan(256, 65536, H100) == 4
    assert tfused.plan(1, 512, {2: 66, 4: 30, 8: 15, 16: 0}) == 8
    with pytest.raises(ValueError, match="no cluster size"):
        tfused.plan(1, 65536, {2: 66, 4: 0, 8: 0, 16: 0})
    data = torch.zeros((64, tfused.PREFIX + 65536 + CELL), dtype=torch.uint8)
    monkeypatch.setitem(tfused._RESIDENT, (str(data.device), 65536, "lz4"), dict(H100))
    monkeypatch.setitem(tfused._RESIDENT, (str(data.device), 65536, "snappy"), refused)
    assert tfused.plan_for(data, 65536, "lz4") == 4
    assert tfused.plan_for(data, 65536, "snappy") == 8


def test_snappy_layout_fits_where_lz4_does():
    """Layout's image region (csrc/fused.cu): snappy's range_bound is at
    most LZ4's at every bucket and cluster size, so its kernel's shared
    memory never exceeds the LZ4 kernel's."""
    lz4_bound, snappy_bound = CODEC_RULES["lz4"][2], CODEC_RULES["snappy"][2]
    for n in (512, 4096, 32768, 65536):
        for c in tfused.CLUSTERS:
            cells = cdiv(n // CELL, c)
            assert snappy_bound(n, cells) <= lz4_bound(n, cells)


class _RefusingLib:
    """A library whose fused launches report a refused cluster launch."""

    @staticmethod
    def rp_fused_lz4(*_args):
        return 9  # cudaErrorInvalidConfiguration

    @staticmethod
    def rp_fused_snappy(*_args):
        return 9

    @staticmethod
    def rp_error_string(_rc):
        return b"invalid configuration argument"


def test_a_refused_launch_raises(monkeypatch):
    """A launch the card refuses raises KernelError and counts nothing;
    the wrapper routes the rows nowhere else (ops/fused.py holds no try:
    test_torch_isolation)."""
    monkeypatch.setattr(tfused, "_LIB", _RefusingLib())
    monkeypatch.setattr(_build, "stream_of", lambda _t: 0)
    monkeypatch.setattr(tfused, "crc_consts", lambda _dev, _n, _c: torch.zeros(1, dtype=torch.int32))
    prefixes, bodies = [bytes(40)], [b"abc" * 100]
    mat, blen, n = tfused.stage_fused(prefixes, bodies)
    before = dict(tfused.LAUNCHES)
    with pytest.raises(_build.KernelError, match="fused_lz4"):
        tfused.launch_fused(torch.from_numpy(mat), torch.from_numpy(blen), n, 8)
    assert tfused.LAUNCHES == before
    with pytest.raises(ValueError, match="cluster size"):
        tfused.launch_fused(torch.from_numpy(mat), torch.from_numpy(blen), n, 3)
    with pytest.raises(ValueError, match="cluster size"):
        tfused.launch_fused(torch.from_numpy(mat), torch.from_numpy(blen), 65536, 2)


def test_a_refused_snappy_launch_raises(monkeypatch):
    """The same for rp_fused_snappy: KernelError, nothing counted, no
    fallback to the three-launch sequence."""
    monkeypatch.setattr(tfused, "_LIB", _RefusingLib())
    monkeypatch.setattr(_build, "stream_of", lambda _t: 0)
    monkeypatch.setattr(tfused, "crc_consts", lambda _dev, _n, _c: torch.zeros(1, dtype=torch.int32))
    mat, blen, n = tfused.stage_fused([bytes(40)], [b"abc" * 100])
    before = dict(tfused.LAUNCHES)
    with pytest.raises(_build.KernelError, match="fused_snappy"):
        tfused.launch_fused(torch.from_numpy(mat), torch.from_numpy(blen), n, 8, "snappy")
    assert tfused.LAUNCHES == before
    with pytest.raises(ValueError, match="cluster size"):
        tfused.launch_fused(torch.from_numpy(mat), torch.from_numpy(blen), 65536, 2, "snappy")


def test_fused_snappy_cpu_path_is_the_plain_chain():
    """On the CPU `_fused_snappy` is the plain chain: equal to the
    three-launch sequence's CPU twin, and its entry to the JAX program."""
    rng = np.random.default_rng(9)
    bodies = [chip_smoke.json_text(rng, 3000), b"", rng.integers(0, 256, 900, dtype=np.uint8).tobytes()]
    prefixes = [rng.integers(0, 256, 40, dtype=np.uint8).tobytes() for _ in bodies]
    mat, blen, n = tfused.stage_fused(prefixes, bodies)
    data, valid = torch.from_numpy(mat), torch.from_numpy(blen)
    for got, want in zip(tfused._fused_snappy(data, valid, n), tfused._fused_snappy_sequence(data, valid, n)):
        assert torch.equal(got, want)
    assert tfused.LAUNCHES["fused_snappy"] == 0
    crcs, blocks = tfused.crc_snappy_fused(prefixes, bodies, device="cpu")
    jcrcs, jblocks = jfused.crc_snappy_fused(prefixes, bodies)
    np.testing.assert_array_equal(crcs, np.asarray(jcrcs))
    assert blocks == jblocks


@pytest.mark.parametrize("n", (512, 65536))
def test_crc_snappy_fused_matches_jax_on_skew_edges(n):
    """crc_snappy_fused on the CPU against the JAX program on the skew
    edges (one repeated byte, distinct 4-grams, random bytes, zeros) at
    v in {0, 1, 3, 4, 5, n}: CRCs and blocks (preamble included) equal."""
    rng = np.random.default_rng(n + 1)
    for kind, full in _edge_rows(n).items():
        bodies = [full[:v] for v in (0, 1, 3, 4, 5, n)]
        prefixes = [rng.integers(0, 256, 40, dtype=np.uint8).tobytes() for _ in bodies]
        crcs, blocks = tfused.crc_snappy_fused(prefixes, bodies, device="cpu")
        jcrcs, jblocks = jfused.crc_snappy_fused(prefixes, bodies)
        np.testing.assert_array_equal(crcs, np.asarray(jcrcs), err_msg=kind)
        assert blocks == jblocks, kind


def test_fused_cpu_path_is_the_plain_chain():
    """On the CPU `_fused` is the plain chain (the kernel's twin): equal
    to the JAX program's CRCs and blocks."""
    rng = np.random.default_rng(8)
    bodies = [chip_smoke.json_text(rng, 3000), b"", rng.integers(0, 256, 900, dtype=np.uint8).tobytes()]
    prefixes = [rng.integers(0, 256, 40, dtype=np.uint8).tobytes() for _ in bodies]
    crcs, blocks = tfused.crc_lz4_fused(prefixes, bodies, device="cpu")
    jcrcs, jblocks = jfused.crc_lz4_fused(prefixes, bodies)
    np.testing.assert_array_equal(crcs, np.asarray(jcrcs))
    assert blocks == jblocks


def test_chip_fused_stands_alone(tmp_path):
    """chip_fused.py imports nothing of jax or of the reference package,
    and without a card it exits non-zero and prints no result."""
    import ast
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parent.parent
    tree = ast.parse((repo / "chip_fused.py").read_text())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0 else [])
        assert not [x for x in names if x.split(".")[0] in ("jax", "jaxlib", "redpanda_tpu")], names
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks a machine without one")
    out = subprocess.run([sys.executable, str(repo / "chip_fused.py"), "ab", str(tmp_path)],
                         capture_output=True, text=True, timeout=120, cwd=str(repo))
    assert out.returncode != 0 and '"ok"' not in out.stdout
