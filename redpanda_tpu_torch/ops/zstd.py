"""Batched zstd entropy stage on the card — the codec of the tiered path.

Replaces redpanda_tpu/ops/zstd.py:190 `_encode_chunks` and :274
`_decode_streams`. Each <= 64 KiB chunk becomes a raw / RLE / compressed
zstd block whose compressed form is a 4-stream huff0 literals section
with zero sequences; the frame and block scaffolding is host work
(compression/zstd_frame.py). This module is the O(n) device work.

  encode — per chunk: the byte histogram, exactly-Kraft code lengths
  over the fixed 2^11 huff0 slot space (power-of-two slot counts seeded
  from each symbol's share, then repaired: halve the smallest-count
  symbol while over budget, double the largest feasible one while
  under; ties go to the first index), canonical huff0 codes (longer
  codes in the low table regions, symbols ascending within a length
  class), and four reversed bitstreams, each closed by an end-marker
  bit. On the card: one `rp_zstd_encode` launch, a cluster of four CTAs
  a row (csrc/zstd.cu): CTA s stages stream s's quarter of the row and
  histograms it, the four histograms meet over distributed shared
  memory, every CTA derives the lengths (the down loop in closed form,
  the up loop as a walk down the levels) and codes, and writes its
  stream from its staged quarter.

  decode — huff0 streams are sequential: with f[p] = max(p -
  nb[peek(p)], 0) over bit positions (peek(p) = the 11 bits just below
  p, zeros below bit 0), pos[0] = tbits and pos[k+1] = f[pos[k]]; out[k]
  = sym[peek(pos[k])] for k < regen, end = f[pos[max(regen - 1, 0)]]
  must be 0. A stream that runs out sticks at bit 0. Decode tables are
  staged once per distinct table ([T, 2048], matched by the identity of
  the table object, as the backend passes the four streams of a block
  the same object) with a stream -> table index [S]; `decode_groups`
  cuts the streams into groups of up to four consecutive streams that
  share a table. On the card `rp_zstd_decode` runs one warp per 8
  groups, the groups' tables in shared memory, one stream walk per
  thread (csrc/zstd.cu says why). `_decode_streams` keeps the
  JAX signature (one table per stream). The plain version keeps the JAX
  program's pointer jumping (a transition table over every bit
  position, log2(rmax) doubling rounds): ~6 int64 tensors of 8 * sbytes
  entries per stream, so it runs a few streams at a time.

Rows on the card launch the kernels or raise; rows on the CPU run the
plain versions, which follow `_encode_one` / `_kraft_nbits` /
`_huff_codes` / `_decode_one` step by step in int64 (torch has no
uint32 shifts on the CPU). All outputs are compared in full: every
stream byte up to the byte bound, every `bits`, `nbits`, `out` and
`end`, padding rows included.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.consensus_state import check_device
from . import _build
from .lz4 import as_arrays

TABLELOG = 11
TSIZE = 1 << TABLELOG
MAX_N = 65536
DECODE_SLOTS = 4  # streams per decode group (one zstd block's four); csrc/zstd.cu DEC_SLOTS

LAUNCHES = {"zstd_encode": 0, "zstd_decode": 0}

# entries with device=None run here; the CPU tests set it to "cpu"
DEFAULT_DEVICE = "cuda"

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("zstd")
        _build.bind(lib, "rp_zstd_encode", 6, 4)
        _build.bind(lib, "rp_zstd_decode", 8, 3)
        _build.bind(lib, "rp_fused_zstd", 8, 4)
        lib.rp_fused_zstd_units.argtypes = [ctypes.c_int64] * 3
        lib.rp_fused_zstd_units.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def stream_cap(n: int) -> int:
    """Max symbols one of the 4 literal streams can carry for an
    n-byte chunk (streams 1-3 take ceil(len/4), stream 4 the rest)."""
    return n // 4 + 1


def stream_byte_bound(n: int) -> int:
    """Worst-case bytes of one emitted stream (11 bits/symbol + the
    end-marker bit, rounded up)."""
    return (TABLELOG * stream_cap(n)) // 8 + 2


# ------------------------------------------------------------ encode
def _floor_log2(x: torch.Tensor, hi: int) -> torch.Tensor:
    """Integer floor(log2(x)) for x in [1, 2^hi], by bit probes."""
    j = torch.arange(1, hi + 1, device=x.device)
    return ((x[..., None] >> j) > 0).sum(-1)


def _kraft_nbits(counts: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Exactly-Kraft code lengths for each row of counts int64 [b, 256]
    (v int64 [b]): the JAX program's two while_loops, run for all rows
    at once, each row stepping only while its own condition holds."""
    present = counts > 0
    v64 = v.clamp(min=1)[:, None]
    q = ((counts * TSIZE + v64 - 1) // v64).clamp(1, TSIZE)
    u = torch.where(present, (1 << _floor_log2(q, TABLELOG + 1)).clamp(1, 1024), 0)
    sym = torch.arange(256, device=counts.device)
    big = torch.iinfo(torch.int64).max
    while True:  # halve the smallest-count symbol (first index on ties)
        cand = present & (u >= 2)
        active = (u.sum(1) > TSIZE) & cand.any(1)
        if not bool(active.any()):
            break
        rows = active.nonzero()[:, 0]
        i = torch.where(cand, counts * 256 + sym, big).argmin(1)[rows]
        u[rows, i] = u[rows, i] >> 1
    while True:  # double the largest feasible symbol (first index on ties)
        d = TSIZE - u.sum(1, keepdim=True)
        cand = present & (u <= d) & (u < 1024)
        active = (d[:, 0] > 0) & cand.any(1)
        if not bool(active.any()):
            break
        rows = active.nonzero()[:, 0]
        i = torch.where(cand, u * 256 + (255 - sym), -1).argmax(1)[rows]
        u[rows, i] = u[rows, i] * 2
    return torch.where(present, TABLELOG - _floor_log2(u.clamp(min=1), TABLELOG), 0)


def _huff_codes(nbits: torch.Tensor) -> torch.Tensor:
    """Canonical huff0 code values from lengths int64 [b, 256]."""
    present = nbits > 0
    b = torch.arange(TABLELOG + 1, device=nbits.device)
    onehot = ((nbits[:, :, None] == b) & present[:, :, None]).to(torch.int64)
    rc = onehot.sum(1)
    slots = torch.where(b > 0, rc << (TABLELOG - b), 0)
    tail = slots.flip(1).cumsum(1).flip(1)  # tail[b] = sum_{j>=b} slots[j]
    base = torch.cat([tail[:, 1:], torch.zeros_like(tail[:, :1])], 1)
    order = (onehot.cumsum(1) - onehot).gather(2, nbits[:, :, None])[:, :, 0]
    codes = (base.gather(1, nbits) >> (TABLELOG - nbits).clamp(min=0)) + order
    return torch.where(present, codes, 0)


def _emit_rows(d, v, nbits, codes, n: int):
    """The four reversed bitstreams of rows d int64 [b, n]: each output
    bit finds its covering symbol by a right-sided searchsorted over the
    symbols' bit positions, as the JAX program does."""
    b = d.shape[0]
    dev = d.device
    mcap, sb = stream_cap(n), stream_byte_bound(n)
    m4 = (v + 3) // 4
    starts = torch.stack([0 * m4, m4, 2 * m4, 3 * m4], 1)
    slens = torch.stack([m4, m4, m4, (v - 3 * m4).clamp(min=0)], 1)
    i = torch.arange(mcap, device=dev)
    pos = (starts[:, :, None] + i).clamp(0, n - 1).view(b, -1)
    sym = d.gather(1, pos).view(b, 4, mcap)
    nb = torch.where(i < slens[:, :, None], nbits.gather(1, sym.view(b, -1)).view(b, 4, mcap), 0)
    csum = nb.cumsum(2)
    tb = csum[:, :, -1]
    # symbols are written in REVERSE order (huff0 reads backward):
    # symbol i occupies bits [tb - csum[i], tb - csum[i] + nb[i])
    bitpos = (tb[:, :, None] - csum).view(b * 4, mcap)
    j = torch.arange(8 * sb, device=dev).expand(b * 4, -1).contiguous()
    k = torch.searchsorted(bitpos.flip(1).contiguous(), j, right=True) - 1
    idx = (mcap - 1 - k).clamp(0, mcap - 1)
    shift = (j - bitpos.gather(1, idx)).clamp(0, 31)
    code = codes.repeat_interleave(4, 0).gather(1, sym.view(b * 4, mcap).gather(1, idx))
    bit = (code >> shift) & 1
    tbf = tb.view(b * 4, 1)
    bit = torch.where(j < tbf, bit, (j == tbf).to(torch.int64))
    byts = (bit.view(b, 4, sb, 8) << torch.arange(8, device=dev)).sum(-1)
    return byts.to(torch.uint8), tb.to(torch.int32)


def _row_step(n: int) -> int:
    """Rows per step of the plain emission: its [4 * rows, 8 * SB]
    tensors stay near 2^22 elements."""
    return max(1, (1 << 22) // (32 * stream_byte_bound(n)))


def _lengths_plain(data, valid, n: int, offset: int = 0):
    """Plain PyTorch version of the code lengths and codes of
    `rp_zstd_encode`: (nbits uint8 [B, 256],
    codes int32 [B, 256]). The histogram is row-chunked; the Kraft loops
    run over all rows at once."""
    d = data[:, offset : offset + n]
    b, dev = d.shape[0], d.device
    v = valid.to(torch.int64)
    step = _row_step(n)
    counts = torch.zeros(b, 256, dtype=torch.int64, device=dev)
    for r in range(0, b, step):
        pos_valid = torch.arange(n, device=dev) < v[r : r + step, None]
        counts[r : r + step].scatter_add_(1, d[r : r + step].to(torch.int64), pos_valid.to(torch.int64))
    nbits = _kraft_nbits(counts, v)
    return nbits.to(torch.uint8), _huff_codes(nbits).to(torch.int32)


def _emit_plain(data, valid, nbits, codes, n: int, offset: int = 0):
    """Plain PyTorch version of the bitstreams of `rp_zstd_encode`,
    row-chunked: (streams
    uint8 [B, 4, SB], bits int32 [B, 4])."""
    d = data[:, offset : offset + n]
    b, dev = d.shape[0], d.device
    v = valid.to(torch.int64)
    nb64, codes64 = nbits.to(torch.int64), codes.to(torch.int64)
    step = _row_step(n)
    streams = torch.empty(b, 4, stream_byte_bound(n), dtype=torch.uint8, device=dev)
    bits = torch.empty(b, 4, dtype=torch.int32, device=dev)
    for r in range(0, b, step):
        streams[r : r + step], bits[r : r + step] = _emit_rows(
            d[r : r + step].to(torch.int64), v[r : r + step], nb64[r : r + step],
            codes64[r : r + step], n)
    return streams, bits


def _encode_chunks_plain(data, valid, n: int, offset: int = 0):
    """Plain PyTorch version of `_encode_chunks`."""
    nbits, codes = _lengths_plain(data, valid, n, offset)
    return (nbits, *_emit_plain(data, valid, nbits, codes, n, offset))


def _check_encode(data, valid, n: int, offset: int) -> None:
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"data: expected a [B, S] uint8 tensor, got {data.dtype} {tuple(data.shape)}")
    if n < 4 or n > MAX_N or n & (n - 1):
        raise ValueError(f"n={n}: expected a power of two in [4, {MAX_N}]")
    if offset < 0 or data.shape[1] < offset + n:
        raise ValueError(f"rows of {data.shape[1]} bytes cannot hold offset {offset} + n {n}")
    b = data.shape[0]
    if valid.dtype != torch.int32 or tuple(valid.shape) != (b,) or valid.device != data.device:
        raise ValueError(f"valid: expected int32 ({b},) on {data.device}")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"zstd kernels run on cuda or cpu tensors, not {data.device}")
    if data.device.type == "cuda" and not (data.is_contiguous() and valid.is_contiguous()):
        raise ValueError("data and valid must be contiguous")


def launch_encode(data, valid, n: int, offset: int):
    """One `rp_zstd_encode` launch: (nbits uint8 [B, 256], codes int32
    [B, 256], streams uint8 [B, 4, SB], bits int32 [B, 4]). The codes are
    written for the comparison with `_lengths_plain`; the launch reads
    each row's valid bytes once."""
    b, stride = data.shape
    dev = data.device
    nbits = torch.empty((b, 256), dtype=torch.uint8, device=dev)
    codes = torch.empty((b, 256), dtype=torch.int32, device=dev)
    streams = torch.empty((b, 4, stream_byte_bound(n)), dtype=torch.uint8, device=dev)
    bits = torch.empty((b, 4), dtype=torch.int32, device=dev)
    if b:
        lib = _lib()
        rc = lib.rp_zstd_encode(data.data_ptr(), valid.data_ptr(), nbits.data_ptr(), codes.data_ptr(),
                                streams.data_ptr(), bits.data_ptr(), b, stride, offset, n,
                                _build.stream_of(data))
        _build.check(lib, rc, "zstd_encode")
        LAUNCHES["zstd_encode"] += 1
    return nbits, codes, streams, bits


def _encode_chunks(data: torch.Tensor, valid: torch.Tensor, n: int, offset: int = 0):
    """data: uint8 [B, S] holding each chunk at columns [offset, offset
    + n), zero-padded past its valid length; valid: int32 [B]. Returns
    (nbits uint8 [B, 256], streams uint8 [B, 4, SB], bits int32 [B, 4])
    with SB = stream_byte_bound(n)."""
    _check_encode(data, valid, n, offset)
    if data.device.type == "cpu":
        return _encode_chunks_plain(data, valid, n, offset)
    nbits, _, streams, bits = launch_encode(data, valid, n, offset)
    return nbits, streams, bits


def streams_of(nbits, streams, bits, count: int) -> "list[tuple[np.ndarray, list[bytes]]]":
    """(code lengths, the 4 huff0 streams cut at their marker byte) for
    the first `count` rows of an encode's host copies."""
    return [
        (nbits[i].astype(np.int64),
         [streams[i, s, : bits[i, s] // 8 + 1].tobytes() for s in range(4)])
        for i in range(count)
    ]


def encode_chunks(chunks: "list[bytes | np.ndarray]", device=None) -> "list[tuple[np.ndarray, list[bytes]]]":
    """Encode each <= 64 KiB chunk on the card: (code lengths, 4 huff0
    streams) per chunk, one upload and one encode launch for all of
    them. Frame / block assembly from these is
    zstd_frame.build_block's job."""
    if not chunks:
        return []
    dev = check_device(device or DEFAULT_DEVICE)
    arrs = as_arrays(chunks)
    longest = max(a.size for a in arrs)
    if longest > MAX_N:
        raise ValueError("device zstd chunks must be <= 64 KiB")
    n = 256
    while n < longest:
        n *= 2
    batch = np.zeros((len(arrs), n), np.uint8)
    valid = np.zeros(len(arrs), np.int32)
    for i, a in enumerate(arrs):
        batch[i, : a.size] = a
        valid[i] = a.size
    nbits, streams, bits = _encode_chunks(
        torch.from_numpy(batch).to(dev), torch.from_numpy(valid).to(dev), n
    )
    return streams_of(nbits.cpu().numpy(), streams.cpu().numpy(), bits.cpu().numpy(), len(arrs))


# ------------------------------------------------------------ decode
def _decode_rows(bufs, tb, rg, tsym, tnb, sbytes: int, rmax: int):
    """The JAX program's pointer jumping on streams bufs int64 [s, sbytes]."""
    s = bufs.shape[0]
    dev = bufs.device
    # padded by 2 zero bytes so every 11-bit window read is in-bounds
    padded = torch.cat([torch.zeros(s, 2, dtype=torch.int64, device=dev), bufs], 1)
    p = torch.arange(8 * sbytes + 1, device=dev)
    lo = p + 16 - TABLELOG  # window start bit in padded space (>= 0)
    q = lo >> 3
    w = (padded[:, q] | (padded[:, q + 1] << 8) | (padded[:, (q + 2).clamp(0, sbytes + 1)] << 16))
    peek = (w >> (lo - (q << 3))) & (TSIZE - 1)
    s_at = tsym.gather(1, peek)
    f = (p - tnb.gather(1, peek)).clamp(min=0)
    f[:, 0] = 0
    ar = torch.arange(rmax, device=dev)
    pos = torch.zeros(s, rmax, dtype=torch.int64, device=dev)
    pos[:, 0] = tb
    jtab, size = f, 1
    for _ in range(max(1, (rmax - 1).bit_length())):
        hop = jtab.gather(1, pos.gather(1, (ar - size).clamp(0, rmax - 1).expand(s, -1)))
        pos = torch.where((ar >= size) & (ar < 2 * size), hop, pos)
        jtab = jtab.gather(1, jtab)
        size *= 2
    out = torch.where(ar < rg[:, None], s_at.gather(1, pos), 0).to(torch.uint8)
    end = f.gather(1, pos.gather(1, (rg - 1).clamp(0, rmax - 1)[:, None]))[:, 0]
    return out, end.to(torch.int32)


def _decode_streams_plain(bufs, tbits, regen, tsym, tnb, sbytes: int, rmax: int):
    """Plain PyTorch version of `_decode_streams`, row-chunked."""
    step = max(1, (1 << 21) // (8 * sbytes + 1))
    i64 = torch.int64
    parts = [
        _decode_rows(bufs[r : r + step].to(i64), tbits[r : r + step].to(i64),
                     regen[r : r + step].to(i64), tsym[r : r + step].to(i64),
                     tnb[r : r + step].to(i64), sbytes, rmax)
        for r in range(0, bufs.shape[0], step)
    ]
    if not parts:
        return (torch.zeros(0, rmax, dtype=torch.uint8, device=bufs.device),
                torch.zeros(0, dtype=torch.int32, device=bufs.device))
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _check_decode(bufs, tbits, regen, tsym, tnb, index, sbytes: int, rmax: int) -> None:
    s = bufs.shape[0] if bufs.dim() == 2 else -1
    if bufs.dtype != torch.uint8 or tuple(bufs.shape) != (s, sbytes):
        raise ValueError(f"bufs: expected uint8 [S, {sbytes}], got {bufs.dtype} {tuple(bufs.shape)}")
    if sbytes < 8 or sbytes % 8 or rmax < 8 or rmax % 8:
        raise ValueError(f"sbytes={sbytes}, rmax={rmax}: expected positive multiples of 8")
    t = tsym.shape[0] if tsym.dim() == 2 else -1
    for name, x, dt, shape in (
        ("tbits", tbits, torch.int32, (s,)), ("regen", regen, torch.int32, (s,)),
        ("tsym", tsym, torch.uint8, (t, TSIZE)), ("tnb", tnb, torch.int32, (t, TSIZE)),
        ("index", index, torch.int32, (s,)),
    ):
        if x.dtype != dt or tuple(x.shape) != shape or x.device != bufs.device:
            raise ValueError(f"{name}: expected {dt} {shape} on {bufs.device}")
    if bufs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"zstd kernels run on cuda or cpu tensors, not {bufs.device}")
    if s and bool(((tbits < 0) | (tbits > 8 * sbytes)).any()):
        raise ValueError(f"tbits must lie in [0, {8 * sbytes}]")
    if t and bool(((tnb < 0) | (tnb > TABLELOG)).any()):
        raise ValueError(f"tnb entries must be code lengths in [0, {TABLELOG}]")
    if s and bool(((index < 0) | (index >= t)).any()):
        raise ValueError(f"index entries must name one of the {t} tables")


def decode_groups(index: np.ndarray) -> np.ndarray:
    """int32 [G, 1 + DECODE_SLOTS] rows of (table, stream ids, -1 for an
    empty slot): runs of consecutive streams with one table, cut every
    DECODE_SLOTS streams. Every stream is in exactly one group."""
    index = np.asarray(index, np.int64)
    s = index.size
    if not s:
        return np.zeros((0, 1 + DECODE_SLOTS), np.int32)
    at = np.arange(s)
    new = np.ones(s, bool)
    new[1:] = index[1:] != index[:-1]
    rank = at - np.maximum.accumulate(np.where(new, at, 0))
    slot = rank % DECODE_SLOTS
    gid = np.cumsum(slot == 0) - 1
    groups = np.full((int(gid[-1]) + 1, 1 + DECODE_SLOTS), -1, np.int32)
    groups[gid, 0] = index
    groups[gid, 1 + slot] = at
    return groups


def launch_decode(bufs, tbits, regen, tsym, tnb, index, sbytes: int, rmax: int, groups):
    """One `rp_zstd_decode` launch on checked inputs: (out, end).
    `groups` is `decode_groups(index)` as int32 [G, 5] on the card."""
    s = bufs.shape[0]
    dev = bufs.device
    out = torch.empty((s, rmax), dtype=torch.uint8, device=dev)
    end = torch.empty(s, dtype=torch.int32, device=dev)
    if s:
        if groups.dtype != torch.int32 or groups.dim() != 2 or groups.shape[1] != 1 + DECODE_SLOTS \
                or groups.device != dev:
            raise ValueError(f"groups: expected int32 [G, {1 + DECODE_SLOTS}] on {dev}")
        ts = [t.contiguous() for t in (bufs, tbits, regen, tsym, tnb, groups)]
        if ts[0].data_ptr() % 16 or ts[3].data_ptr() % 4 or ts[4].data_ptr() % 16:
            raise ValueError("bufs and tnb must be 16-byte aligned, tsym 4-byte aligned")
        lib = _lib()
        rc = lib.rp_zstd_decode(*(t.data_ptr() for t in ts), out.data_ptr(), end.data_ptr(),
                                groups.shape[0], sbytes, rmax, _build.stream_of(bufs))
        _build.check(lib, rc, "zstd_decode")
        LAUNCHES["zstd_decode"] += 1
    return out, end


def decode_staged(bufs, tbits, regen, tsym, tnb, index, sbytes: int, rmax: int, groups):
    """bufs uint8 [S, sbytes]; tbits / regen / index int32 [S]; tsym
    uint8 [T, 2048], tnb int32 [T, 2048]: stream i decodes with table
    index[i]; groups int32 [G, 5] = `decode_groups(index)`, on the
    streams' device. Returns (out uint8 [S, rmax], end int32 [S]); `end`
    must be 0 for every valid stream (exact consumption)."""
    _check_decode(bufs, tbits, regen, tsym, tnb, index, sbytes, rmax)
    if bufs.device.type == "cpu":
        i = index.to(torch.int64)
        return _decode_streams_plain(bufs, tbits, regen, tsym[i], tnb[i], sbytes, rmax)
    return launch_decode(bufs, tbits, regen, tsym, tnb, index, sbytes, rmax, groups)


def _decode_streams(bufs, tbits, regen, tsym, tnb, sbytes: int, rmax: int):
    """The JAX signature: tsym uint8 [S, 2048] and tnb int32 [S, 2048],
    one table per stream, so each stream is a group of its own. Returns
    (out uint8 [S, rmax], end int32 [S])."""
    index = torch.arange(bufs.shape[0] if bufs.dim() == 2 else 0, dtype=torch.int32, device=bufs.device)
    groups = torch.full((index.shape[0], 1 + DECODE_SLOTS), -1, dtype=torch.int32, device=bufs.device)
    groups[:, 0] = index
    groups[:, 1] = index
    return decode_staged(bufs, tbits, regen, tsym, tnb, index, sbytes, rmax, groups)


def stage_streams(streams, regens, tables):
    """Host matrices for `decode_staged`: (bufs, tbits, regen, tsym,
    tnb, index, sbytes, rmax), each distinct table object staged once,
    sbytes and rmax the powers of two >= 64 that hold the longest stream
    and the largest regenerated size."""
    smax = max(len(s) for s in streams)
    rmax_need = max(regens)
    sbytes = 64
    while sbytes < smax:
        sbytes *= 2
    rmax = 64
    while rmax < rmax_need:
        rmax *= 2
    rows = len(streams)
    bufs = np.zeros((rows, sbytes), np.uint8)
    tbits = np.zeros(rows, np.int32)
    for i, s in enumerate(streams):
        if not s or s[-1] == 0:
            raise ValueError("huffman stream missing its end marker")
        bufs[i, : len(s)] = np.frombuffer(s, np.uint8)
        tbits[i] = 8 * (len(s) - 1) + s[-1].bit_length() - 1
    regen = np.asarray(regens, np.int32)
    slot, distinct = {}, []
    index = np.empty(rows, np.int32)
    for i, t in enumerate(tables):
        index[i] = slot.setdefault(id(t), len(distinct))
        if index[i] == len(distinct):
            distinct.append(t)
    tsym = np.zeros((len(distinct), TSIZE), np.uint8)
    tnb = np.zeros((len(distinct), TSIZE), np.int32)
    for i, t in enumerate(distinct):
        tsym[i] = t[0]
        tnb[i] = t[1]
    return bufs, tbits, regen, tsym, tnb, index, sbytes, rmax


def check_ends(end: np.ndarray) -> None:
    """Raise ValueError naming the first stream that did not consume its
    bits exactly."""
    if int(np.abs(end).max(initial=0)) != 0:
        bad = int(np.flatnonzero(end)[0])
        raise ValueError(
            f"huffman stream {bad} did not consume its bits exactly "
            f"({int(end[bad])} left)"
        )


def decode_streams(
    streams: "list[bytes]",
    regens: "list[int]",
    tables: "list[tuple[np.ndarray, np.ndarray]]",
    device=None,
) -> "list[bytes]":
    """Batch-decode huff0 streams on the card. streams[i] regenerates
    regens[i] bytes using decode table tables[i] (sym[2048], nb[2048]
    from zstd_frame.decode_table). Raises ValueError on any stream that
    does not consume its bits exactly (corrupt frame)."""
    if not streams:
        return []
    dev = check_device(device or DEFAULT_DEVICE)
    *mats, index, sbytes, rmax = stage_streams(streams, regens, tables)
    groups = torch.from_numpy(decode_groups(index)).to(dev)
    out, end = decode_staged(*(torch.from_numpy(m).to(dev) for m in (*mats, index)), sbytes, rmax, groups)
    check_ends(end.cpu().numpy())
    out = out.cpu().numpy()
    return [out[i, : regens[i]].tobytes() for i in range(len(streams))]
