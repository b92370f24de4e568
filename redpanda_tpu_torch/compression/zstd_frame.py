"""Host-side zstd frame format layer for the device codec (RFC 8878).

The device zstd leg (ops/zstd.py + tpu_backend.compress_zstd) splits
work exactly like the LZ4 leg: O(n) bit/byte emission runs as one
batched XLA program, while the branchy, tiny frame scaffolding —
frame headers, block headers, the Huffman tree description, stream
jump tables — is assembled here from the kernel's per-chunk outputs.
Everything in this module is pure format logic with no jax imports,
so the compression registry can parse frame headers (the decompress
bomb guard) without touching the device stack.

Profile emitted (the SplitZip/single-stage-Huffman first cut,
arxiv 2605.01708 + 2601.10673): single-segment frames with a frame
content size, whose blocks are raw, RLE, or compressed with a
4-stream Huffman *literals-only* section (0 sequences) and a
direct-representation weight table. Anything outside that profile —
FSE-described trees, sequences, dictionaries, 1-stream literals —
is rejected by `reference_decompress` and punted to the host codec
by the device decode path.

`reference_decompress` is a spec-faithful pure-Python decoder of the
profile. It exists so the >=10k differential fuzz (tests/
test_zstd_device.py) has an oracle even on images without the
`zstandard` wheel (the known tier-1 env gap); where the wheel is
present, stock `zstandard` must agree with it byte-for-byte.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = 0xFD2FB528
SKIPPABLE_LO = 0x184D2A50
SKIPPABLE_HI = 0x184D2A5F

TABLELOG = 11  # huff0 max table log; the device kernel's fixed slot space
TSIZE = 1 << TABLELOG

# 4-stream compressed literals need every stream non-empty: streams 1-3
# regenerate ceil(l/4) each, stream 4 the rest, which is only guaranteed
# positive for l >= this floor (below it a raw block wins anyway).
MIN_HUFFMAN_LEN = 64

# direct weight representation caps at 128 transmitted weights, i.e.
# the last present symbol must be <= 128 (its own weight is implied)
MAX_DIRECT_SYMBOL = 128


class ZstdFormatError(ValueError):
    """Frame violates the spec or falls outside the device profile."""


# ---------------------------------------------------------------- headers
def frame_header(content_size: int) -> bytes:
    """Single-segment frame header with an explicit content size (the
    decompress bomb guard relies on every archived frame carrying one).
    Window_Size = content size, so blocks never need a descriptor."""
    if content_size < 0:
        raise ZstdFormatError("negative content size")
    if content_size <= 255:
        fcs_code, fcs = 0, struct.pack("<B", content_size)
    elif content_size <= 65535 + 256:
        fcs_code, fcs = 1, struct.pack("<H", content_size - 256)
    elif content_size < 1 << 32:
        fcs_code, fcs = 2, struct.pack("<I", content_size)
    else:
        fcs_code, fcs = 3, struct.pack("<Q", content_size)
    fhd = (fcs_code << 6) | (1 << 5)  # single-segment, no checksum/dict
    return struct.pack("<IB", MAGIC, fhd) + fcs


def parse_frame_header(data: bytes) -> tuple["int | None", int]:
    """(declared content size or None, header length) of a zstd frame.

    Understands the full spec header (window descriptor, dictionary id,
    every FCS field size) — not just the device profile — because the
    decompress bomb guard must read the declared size of ANY frame the
    host codec is about to inflate. Raises ZstdFormatError when `data`
    is not a zstd frame at all."""
    if len(data) < 5:
        raise ZstdFormatError("short frame header")
    magic = struct.unpack_from("<I", data)[0]
    if SKIPPABLE_LO <= magic <= SKIPPABLE_HI:
        return None, 8  # skippable frame: no content, 4B size follows
    if magic != MAGIC:
        raise ZstdFormatError(f"bad magic 0x{magic:08x}")
    fhd = data[4]
    fcs_code = fhd >> 6
    single = (fhd >> 5) & 1
    if fhd & 0x18:
        raise ZstdFormatError("reserved/unused FHD bits set")
    dict_len = (0, 1, 2, 4)[fhd & 3]
    pos = 5 + (0 if single else 1) + dict_len
    fcs_len = (1 if single else 0, 2, 4, 8)[fcs_code]
    if len(data) < pos + fcs_len:
        raise ZstdFormatError("truncated frame header")
    if fcs_len == 0:
        return None, pos
    v = int.from_bytes(data[pos : pos + fcs_len], "little")
    if fcs_len == 2:
        v += 256
    return v, pos + fcs_len


def frame_content_size(data: bytes) -> "int | None":
    """Declared content size, or None when absent/not parseable as a
    zstd frame (the caller then applies the no-declared-size policy)."""
    try:
        return parse_frame_header(data)[0]
    except ZstdFormatError:
        return None


def block_header(last: bool, btype: int, size: int) -> bytes:
    if not 0 <= size < 1 << 21:
        raise ZstdFormatError(f"block size {size} out of range")
    v = (1 if last else 0) | (btype << 1) | (size << 3)
    return struct.pack("<I", v)[:3]


def raw_block(data: bytes, last: bool) -> bytes:
    return block_header(last, 0, len(data)) + data


def rle_block(byte_val: int, count: int, last: bool) -> bytes:
    # RLE block: Block_Size is the REGENERATED size, content is 1 byte
    return block_header(last, 1, count) + bytes([byte_val])


# ------------------------------------------------------- huffman weights
def weights_from_nbits(nbits: np.ndarray) -> np.ndarray:
    """Per-symbol zstd weight (0 = absent) from code lengths with an
    exact Kraft sum of 2^TABLELOG (the device kernel's invariant).

    Weights are relative to the tree's ACTUAL max depth, not the
    kernel's TABLELOG cap: HUF_readStats recovers tableLog from
    sum 2^(w-1) and requires >= 2 weight-1 (deepest) symbols, so a
    tree shallower than TABLELOG described against TABLELOG has zero
    weight-1 entries and stock libzstd rejects it as corruption."""
    nbits = np.asarray(nbits, np.int64)
    present = nbits > 0
    if int((present * (1 << (TABLELOG - nbits * present))).sum()) != TSIZE:
        raise ZstdFormatError("code lengths are not Kraft-exact")
    depth = int(nbits[present].max()) if present.any() else 0
    return np.where(present, depth + 1 - nbits, 0).astype(np.int64)


def direct_weights_desc(nbits: np.ndarray) -> "bytes | None":
    """Direct-representation Huffman tree description, or None when the
    chunk is outside the directly-representable shape (last present
    symbol > 128, or fewer than 2 symbols)."""
    w = weights_from_nbits(nbits)
    present = np.nonzero(w)[0]
    if len(present) < 2:
        return None
    last = int(present[-1])
    if last > MAX_DIRECT_SYMBOL:
        return None
    # weights for symbols 0..last-1 are transmitted; symbol `last` is
    # implied (completes the 2^(w-1) sum to the next power of two)
    listed = w[:last]
    out = bytearray([127 + last])
    for i in range(0, last, 2):
        hi = int(listed[i]) << 4
        lo = int(listed[i + 1]) if i + 1 < last else 0
        out.append(hi | lo)
    return bytes(out)


# ------------------------------------- FSE-compressed huffman weights
# RFC 8878 §4.2.1.2/§4.1.1: a tree-description headerByte < 128 means
# the weights are FSE-compressed (headerByte = compressed size). This
# matters beyond host-frame compatibility: record-batch framing puts
# varint continuation bytes (>= 0x80) every few hundred bytes of a log
# segment, so the direct representation's 128-symbol alphabet cap
# would punt essentially every real segment chunk to a raw block. The
# FSE description lifts the alphabet to the full 256 symbols; the
# device kernels already code all 256, only the description changes.
# Host-side work either way — a weight table is <= 255 nibbles.

FSE_WEIGHT_AL = 6  # max Accuracy_Log for huffman-weight tables


class _BitWriter:
    """Forward LSB-first accumulator (zstd's BIT_addBits layout)."""

    def __init__(self) -> None:
        self.acc = 0
        self.n = 0
        self.out = bytearray()

    def add(self, v: int, nb: int) -> None:
        self.acc |= (v & ((1 << nb) - 1)) << self.n
        self.n += nb
        while self.n >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.n -= 8

    def close(self, marker: bool = True) -> bytes:
        if marker:  # BIT_closeCStream's 1-bit end mark
            self.add(1, 1)
        if self.n:
            self.out.append(self.acc & 0xFF)
            self.acc = 0
            self.n = 0
        return bytes(self.out)


def _read_fse_ncount(data: bytes) -> tuple[list, int, int]:
    """FSE table description -> (normalized counts, accuracy_log,
    bytes consumed). Forward bitstream (FSE_readNCount)."""
    if len(data) < 1:
        raise ZstdFormatError("empty FSE table description")
    bits = int.from_bytes(data, "little")
    bitpos = 0

    def take(nb):
        nonlocal bitpos
        v = (bits >> bitpos) & ((1 << nb) - 1)
        bitpos += nb
        if (bitpos + 7) // 8 > len(data):
            raise ZstdFormatError("truncated FSE table description")
        return v

    al = take(4) + 5
    if al > TABLELOG:
        raise ZstdFormatError(f"FSE accuracy_log {al} too large")
    remaining = (1 << al) + 1
    threshold = 1 << al
    nb_bits = al + 1
    norm: list = []
    previous0 = False
    while remaining > 1 and len(norm) <= 255:
        if previous0:
            while take(16) == 0xFFFF:
                norm.extend([0] * 24)
            bitpos -= 16  # peeked
            while take(2) == 3:
                norm.extend([0] * 3)
            bitpos -= 2
            norm.extend([0] * take(2))
        maxv = (2 * threshold - 1) - remaining
        low = (bits >> bitpos) & (threshold - 1)
        if low < maxv:
            count = low
            bitpos += nb_bits - 1
        else:
            count = (bits >> bitpos) & (2 * threshold - 1)
            bitpos += nb_bits
            if count >= threshold:
                count -= maxv
        if (bitpos + 7) // 8 > len(data):
            raise ZstdFormatError("truncated FSE table description")
        count -= 1  # +1 encoding: 0 means "less than 1" (-1)
        remaining -= -count if count < 0 else count
        norm.append(count)
        previous0 = count == 0
        while remaining < threshold:
            nb_bits -= 1
            threshold >>= 1
    if remaining != 1:
        raise ZstdFormatError("FSE counts do not sum to table size")
    return norm, al, (bitpos + 7) // 8


def _write_fse_ncount(norm: list, al: int) -> bytes:
    """FSE table description bytes (FSE_writeNCount mirror)."""
    bw = _BitWriter()
    bw.add(al - 5, 4)
    remaining = (1 << al) + 1
    threshold = 1 << al
    nb_bits = al + 1
    i = 0
    previous0 = False
    while remaining > 1:
        if previous0:
            start = i
            while i < len(norm) and norm[i] == 0:
                i += 1
            while i >= start + 24:
                start += 24
                bw.add(0xFFFF, 16)
            while i >= start + 3:
                start += 3
                bw.add(3, 2)
            bw.add(i - start, 2)
        if i >= len(norm):
            raise ZstdFormatError("FSE norm ended before table filled")
        count = norm[i]
        i += 1
        maxv = (2 * threshold - 1) - remaining
        remaining -= -count if count < 0 else count
        count += 1
        if count >= threshold:
            count += maxv
        bw.add(count, nb_bits - 1 if count < maxv else nb_bits)
        previous0 = count == 1
        while remaining < threshold:
            nb_bits -= 1
            threshold >>= 1
    return bw.close(marker=False)


def _fse_spread(norm: list, al: int) -> list:
    """Symbol layout over the state table — identical for the encode
    and decode table builds (they must agree bit-for-bit)."""
    tsize = 1 << al
    table = [0] * tsize
    high = tsize - 1
    for s, c in enumerate(norm):
        if c == -1:
            table[high] = s
            high -= 1
    step = (tsize >> 1) + (tsize >> 3) + 3
    mask = tsize - 1
    pos = 0
    for s, c in enumerate(norm):
        for _ in range(max(c, 0)):
            table[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdFormatError("FSE spread did not return to position 0")
    return table


def _fse_dtable(norm: list, al: int) -> tuple[list, list, list]:
    """(symbol, nbits, baseline) per decode state."""
    tsize = 1 << al
    spread = _fse_spread(norm, al)
    nxt = [1 if c == -1 else c for c in norm]
    dsym = [0] * tsize
    dnb = [0] * tsize
    dbase = [0] * tsize
    for i in range(tsize):
        s = spread[i]
        x = nxt[s]
        nxt[s] += 1
        nb = al - (x.bit_length() - 1)
        dsym[i] = s
        dnb[i] = nb
        dbase[i] = (x << nb) - tsize
    return dsym, dnb, dbase


def _fse_decode_interleaved(
    stream: bytes, norm: list, al: int, maxout: int = 255
) -> list:
    """Two alternating FSE states over a backward bitstream
    (FSE_decompress_usingDTable's tail loop): each emits its symbol,
    then re-reads; the first over-read ends the stream with the OTHER
    state's final symbol."""
    if not stream or stream[-1] == 0:
        raise ZstdFormatError("FSE stream missing its end marker")
    dsym, dnb, dbase = _fse_dtable(norm, al)
    bits = int.from_bytes(stream, "little")
    p = 8 * (len(stream) - 1) + stream[-1].bit_length() - 1

    def read(nb):
        nonlocal p
        p -= nb
        if p >= 0:
            return (bits >> p) & ((1 << nb) - 1)
        if p <= -nb:
            return 0
        return (bits << -p) & ((1 << nb) - 1)

    s1 = read(al)
    s2 = read(al)
    if p < 0:
        raise ZstdFormatError("FSE stream shorter than two states")
    out: list = []
    while True:
        out.append(dsym[s1])
        s1 = dbase[s1] + read(dnb[s1])
        if p < 0:
            out.append(dsym[s2])
            break
        out.append(dsym[s2])
        s2 = dbase[s2] + read(dnb[s2])
        if p < 0:
            out.append(dsym[s1])
            break
        if len(out) > maxout:
            raise ZstdFormatError("FSE stream emits too many symbols")
    if len(out) > maxout:
        raise ZstdFormatError("FSE stream emits too many symbols")
    return out


def _fse_ctable(norm: list, al: int) -> tuple[list, list]:
    """(next-state table, per-symbol (deltaNbBits, deltaFindState)) —
    FSE_buildCTable."""
    tsize = 1 << al
    spread = _fse_spread(norm, al)
    cumul = [0] * (len(norm) + 1)
    for s, c in enumerate(norm):
        cumul[s + 1] = cumul[s] + (1 if c == -1 else c)
    table = [0] * tsize
    cum = list(cumul[:-1])
    for pos in range(tsize):
        s = spread[pos]
        table[cum[s]] = tsize + pos
        cum[s] += 1
    tt: list = []
    total = 0
    for c in norm:
        if c == 0:
            tt.append((((al + 1) << 16) - tsize, 0))
        elif c in (-1, 1):
            tt.append(((al << 16) - tsize, total - 1))
            total += 1
        else:
            max_bits = al - ((c - 1).bit_length() - 1)
            tt.append(((max_bits << 16) - (c << max_bits), total - c))
            total += c
    return table, tt


def _fse_encode_interleaved(syms: list, norm: list, al: int) -> bytes:
    """FSE_compress_usingCTable's two-state reverse-order encode; the
    decoder above (and libzstd) reads it back forward."""
    table, tt = _fse_ctable(norm, al)
    bw = _BitWriter()

    def init_state(sym):
        dnb, dfs = tt[sym]
        nb = (dnb + (1 << 15)) >> 16
        return table[(((nb << 16) - dnb) >> nb) + dfs]

    def enc(state, sym):
        dnb, dfs = tt[sym]
        nb = (state + dnb) >> 16
        bw.add(state, nb)
        return table[(state >> nb) + dfs]

    n = len(syms)
    if n < 2:
        raise ZstdFormatError("FSE needs at least two symbols")
    if n & 1:
        s1 = init_state(syms[n - 1])
        s2 = init_state(syms[n - 2])
        s1 = enc(s1, syms[n - 3])
        i = n - 3
    else:
        s2 = init_state(syms[n - 1])
        s1 = init_state(syms[n - 2])
        i = n - 2
    while i > 0:
        s2 = enc(s2, syms[i - 1])
        s1 = enc(s1, syms[i - 2])
        i -= 2
    bw.add(s2, al)  # flush order: state2 then state1, so the decoder
    bw.add(s1, al)  # initializes state1 first from the stream top
    return bw.close()


def parse_fse_weights(comp: bytes) -> list:
    """FSE-compressed weight blob -> weight list (implied last symbol
    NOT included)."""
    norm, al, consumed = _read_fse_ncount(comp)
    if al > FSE_WEIGHT_AL:
        raise ZstdFormatError(
            f"weight accuracy_log {al} > {FSE_WEIGHT_AL}"
        )
    return _fse_decode_interleaved(comp[consumed:], norm, al)


def _fse_normalize(counts: list, al: int) -> list:
    """Normalize a histogram to sum 2^al, every present symbol >= 1."""
    total = sum(counts)
    tsize = 1 << al
    norm = [
        max(1, (c * tsize) // total) if c else 0 for c in counts
    ]
    diff = tsize - sum(norm)
    order = sorted(
        (s for s, c in enumerate(counts) if c),
        key=lambda s: counts[s],
        reverse=True,
    )
    k = 0
    while diff > 0:
        norm[order[k % len(order)]] += 1
        diff -= 1
        k += 1
    while diff < 0:
        k = max(
            (s for s in order if norm[s] > 1),
            key=lambda s: norm[s],
        )
        norm[k] -= 1
        diff += 1
    return norm


def fse_weights_desc(nbits: np.ndarray) -> "bytes | None":
    """FSE-compressed Huffman tree description (headerByte < 128), or
    None when the weight sequence isn't FSE-representable. Self-checks
    the emitted blob through parse_fse_weights so a coder bug degrades
    to a raw block, never a corrupt frame."""
    w = weights_from_nbits(nbits)
    present = np.nonzero(w)[0]
    if len(present) < 2:
        return None
    last = int(present[-1])
    weights = [int(x) for x in w[:last]]
    if len(weights) < 2:
        return None
    counts = [0] * (max(weights) + 1)
    for x in weights:
        counts[x] += 1
    if sum(1 for c in counts if c) < 2:
        return None  # single-valued weight run: FSE degenerates
    al = FSE_WEIGHT_AL
    try:
        norm = _fse_normalize(counts, al)
        comp = _write_fse_ncount(norm, al) + _fse_encode_interleaved(
            weights, norm, al
        )
        if len(comp) >= 128 or parse_fse_weights(comp) != weights:
            return None
    except ZstdFormatError:
        return None
    return bytes([len(comp)]) + comp


def _nbits_from_weights(w: np.ndarray, n_weights: int) -> np.ndarray:
    """Shared completion: listed weights -> code lengths with the
    implied last symbol (HUF_readStats)."""
    total = int((1 << (w[w > 0] - 1)).sum())
    if total == 0:
        raise ZstdFormatError("empty weight table")
    tablelog = total.bit_length()  # highbit+1 (HUF_readStats)
    if tablelog > TABLELOG:
        raise ZstdFormatError(f"tableLog {tablelog} > {TABLELOG}")
    rest = (1 << tablelog) - total
    if rest <= 0 or rest & (rest - 1):
        raise ZstdFormatError("weights do not complete to a power of 2")
    w[n_weights] = rest.bit_length()  # implied last symbol
    return np.where(w > 0, tablelog + 1 - w, 0).astype(np.int64)


def parse_tree_description(data: bytes, pos: int) -> tuple[np.ndarray, int]:
    """Huffman tree description -> (nbits[256], new pos): direct
    representation (headerByte >= 128) or FSE-compressed weights
    (headerByte = compressed size < 128)."""
    hb = data[pos]
    pos += 1
    if hb < 128:
        if pos + hb > len(data):
            raise ZstdFormatError("truncated FSE tree description")
        weights = parse_fse_weights(data[pos : pos + hb])
        if len(weights) > 255:
            raise ZstdFormatError("too many huffman weights")
        w = np.zeros(256, np.int64)
        for i, x in enumerate(weights):
            if x > TABLELOG:
                raise ZstdFormatError(f"huffman weight {x} > {TABLELOG}")
            w[i] = x
        return _nbits_from_weights(w, len(weights)), pos + hb
    n_weights = hb - 127
    nbytes = (n_weights + 1) // 2
    if pos + nbytes > len(data):
        raise ZstdFormatError("truncated tree description")
    w = np.zeros(256, np.int64)
    for i in range(n_weights):
        b = data[pos + i // 2]
        w[i] = (b >> 4) if i % 2 == 0 else (b & 0xF)
    pos += nbytes
    return _nbits_from_weights(w, n_weights), pos


def huffman_codes(nbits: np.ndarray) -> np.ndarray:
    """Canonical huff0 code values: longer codes occupy the low table
    regions, symbols ascend within a length class (the RFC 8878
    'prefix codes distributed in sequential order from lowest weight'
    rule). code[s] is nbits[s] wide; 0 for absent symbols."""
    nbits = np.asarray(nbits, np.int64)
    rank_count = np.bincount(nbits, minlength=TABLELOG + 1)
    rank_count[0] = 0
    slots = rank_count * (1 << (TABLELOG - np.arange(TABLELOG + 1)))
    # base[b] = first table index of the b-bit region (longer first)
    base = np.concatenate([np.cumsum(slots[::-1])[::-1][1:], [0]])
    order = np.zeros(256, np.int64)
    for b in range(1, TABLELOG + 1):
        cls = nbits == b
        order[cls] = np.arange(int(cls.sum()))
    codes = np.where(
        nbits > 0, (base[nbits] >> (TABLELOG - nbits)) + order, 0
    )
    return codes.astype(np.int64)


def decode_table(nbits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(symbol[2048], nbits[2048]) huff0 decode table: an 11-bit peek
    (MSB = next stream bit) indexes both. Entries for a b-bit code are
    replicated 2^(11-b) times, so any tableLog <= 11 description uses
    the same fixed-size table (the device decode kernel's shape)."""
    nbits = np.asarray(nbits, np.int64)
    codes = huffman_codes(nbits)
    present = np.nonzero(nbits)[0]
    if len(present) == 0:
        raise ZstdFormatError("no symbols in table")
    starts = codes[present] << (TABLELOG - nbits[present])
    widths = 1 << (TABLELOG - nbits[present])
    order = np.argsort(starts)
    sym = np.repeat(present[order], widths[order]).astype(np.uint8)
    nb = np.repeat(nbits[present][order], widths[order]).astype(np.int32)
    if len(sym) != TSIZE:
        raise ZstdFormatError("decode table does not cover 2^11 slots")
    return sym, nb


# --------------------------------------------------------- block assembly
def stream_splits(length: int) -> list[int]:
    """Per-stream regenerated sizes for 4-stream literals."""
    m = (length + 3) // 4
    return [m, m, m, length - 3 * m]


def compressed_block(
    chunk_len: int,
    tree_desc: bytes,
    streams: list[bytes],
    last: bool,
) -> bytes:
    """Compressed block: 4-stream Huffman literals section + the empty
    sequences section (one 0x00 byte: the block output IS the regenerated
    literals)."""
    assert len(streams) == 4
    jump = struct.pack(
        "<HHH", len(streams[0]), len(streams[1]), len(streams[2])
    )
    comp_size = len(tree_desc) + len(jump) + sum(len(s) for s in streams)
    if chunk_len >= 1 << 18 or comp_size >= 1 << 18:
        raise ZstdFormatError("literals sizes exceed 18-bit fields")
    # Literals_Section_Header, Size_Format 3: 5 bytes, 18-bit sizes,
    # type = 2 (Compressed_Literals_Block)
    hdr_v = 2 | (3 << 2) | (chunk_len << 4) | (comp_size << 22)
    body = (
        hdr_v.to_bytes(5, "little")
        + tree_desc
        + jump
        + b"".join(streams)
        + b"\x00"  # Number_of_Sequences = 0
    )
    return block_header(last, 2, len(body)) + body


def build_block(
    chunk: bytes,
    nbits: "np.ndarray | None",
    streams: "list[bytes] | None",
    last: bool,
) -> bytes:
    """Cheapest valid block for one chunk given the device kernel's
    (code lengths, 4 huff0 streams) output: RLE when the chunk is one
    repeated byte, the compressed form when it is representable AND
    actually smaller, raw otherwise. `nbits`/`streams` may be None
    (e.g. the chunk was below MIN_HUFFMAN_LEN) to force raw/RLE."""
    length = len(chunk)
    if length == 0:
        raise ZstdFormatError("empty chunk has no block form")
    if chunk.count(chunk[0]) == length:
        return rle_block(chunk[0], length, last)
    raw = raw_block(chunk, last)
    if nbits is None or streams is None or length < MIN_HUFFMAN_LEN:
        return raw
    desc = direct_weights_desc(nbits)
    if desc is None:
        # alphabet reaches past symbol 128 (real segments do, via
        # varint continuation bytes) -> FSE-compressed weights
        desc = fse_weights_desc(nbits)
    if desc is None:
        return raw
    comp = compressed_block(length, desc, streams, last)
    return comp if len(comp) < len(raw) else raw


# ------------------------------------------------------ reference decode
def _decode_stream(
    buf: bytes, regen: int, sym: np.ndarray, nb: np.ndarray
) -> bytes:
    """One huff0 bitstream, read backward from the 1-marker bit; the
    stream must land exactly on bit 0 after `regen` symbols."""
    if not buf or buf[-1] == 0:
        raise ZstdFormatError("huffman stream missing its end marker")
    bits = int.from_bytes(buf, "little")
    p = 8 * (len(buf) - 1) + buf[-1].bit_length() - 1  # marker position
    out = bytearray()
    for _ in range(regen):
        if p >= TABLELOG:
            peek = (bits >> (p - TABLELOG)) & (TSIZE - 1)
        else:
            peek = (bits << (TABLELOG - p)) & (TSIZE - 1)
        out.append(int(sym[peek]))
        p -= int(nb[peek])
        if p < 0:
            raise ZstdFormatError("huffman stream over-read")
    if p != 0:
        raise ZstdFormatError(f"huffman stream under-consumed ({p} bits)")
    return bytes(out)


def split_compressed_block(
    body: bytes,
) -> tuple[np.ndarray, list[tuple[bytes, int]]]:
    """Parse a profile compressed block WITHOUT decoding its streams:
    (tree nbits[256], [(stream bytes, regenerated size) x4]). The
    device decompress path uses this to batch every stream of every
    block through one ops/zstd.py decode program."""
    if len(body) < 5:
        raise ZstdFormatError("short literals section")
    hdr_v = int.from_bytes(body[:5], "little")
    ltype = hdr_v & 3
    size_format = (hdr_v >> 2) & 3
    if ltype != 2 or size_format != 3:
        raise ZstdFormatError(
            f"literals type {ltype}/format {size_format} outside profile"
        )
    regen = (hdr_v >> 4) & 0x3FFFF
    comp = (hdr_v >> 22) & 0x3FFFF
    pos = 5
    end_lit = pos + comp
    if end_lit > len(body):
        raise ZstdFormatError("literals section exceeds block")
    nbits, pos = parse_tree_description(body, pos)
    if pos + 6 > end_lit:
        raise ZstdFormatError("missing stream jump table")
    l1, l2, l3 = struct.unpack_from("<HHH", body, pos)
    pos += 6
    l4 = end_lit - pos - l1 - l2 - l3
    if l4 <= 0:
        raise ZstdFormatError("stream 4 is empty")
    sizes = stream_splits(regen)
    if sizes[3] <= 0:
        raise ZstdFormatError("regenerated size too small for 4 streams")
    streams = []
    for ln, rg in zip((l1, l2, l3, l4), sizes):
        streams.append((body[pos : pos + ln], rg))
        pos += ln
    if body[end_lit : end_lit + 1] != b"\x00":
        raise ZstdFormatError("sequences section outside profile (punt)")
    if end_lit + 1 != len(body):
        raise ZstdFormatError("trailing bytes after sequences")
    return nbits, streams


def decode_compressed_block(body: bytes) -> bytes:
    """Block content of a profile compressed block -> regenerated bytes."""
    nbits, streams = split_compressed_block(body)
    sym, nb = decode_table(nbits)
    out = bytearray()
    for buf, rg in streams:
        out += _decode_stream(buf, rg, sym, nb)
    return bytes(out)


def reference_decompress(frame: bytes) -> bytes:
    """Pure-Python decoder for the device profile — the differential
    oracle when the zstandard wheel is absent, and the device decode
    path's per-block fallback shape check. Honors the declared frame
    content size (a mismatch is corruption, never an allocation)."""
    declared, pos = parse_frame_header(frame)
    out = bytearray()
    last = False
    while not last:
        if pos + 3 > len(frame):
            raise ZstdFormatError("truncated block header")
        bh = int.from_bytes(frame[pos : pos + 3], "little")
        pos += 3
        last = bool(bh & 1)
        btype = (bh >> 1) & 3
        size = bh >> 3
        if btype == 0:  # raw
            if pos + size > len(frame):
                raise ZstdFormatError("truncated raw block")
            out += frame[pos : pos + size]
            pos += size
        elif btype == 1:  # RLE: size = regenerated count, 1 content byte
            if pos + 1 > len(frame):
                raise ZstdFormatError("truncated RLE block")
            out += frame[pos : pos + 1] * size
            pos += 1
        elif btype == 2:
            if pos + size > len(frame):
                raise ZstdFormatError("truncated compressed block")
            out += decode_compressed_block(frame[pos : pos + size])
            pos += size
        else:
            raise ZstdFormatError("reserved block type")
        if declared is not None and len(out) > declared:
            raise ZstdFormatError(
                f"frame inflates past its declared size ({declared})"
            )
    if pos != len(frame):
        raise ZstdFormatError("trailing bytes after last block")
    if declared is not None and len(out) != declared:
        raise ZstdFormatError(
            f"regenerated {len(out)} bytes, header declared {declared}"
        )
    return bytes(out)
