"""Batched raw-snappy compression on the card.

Replaces redpanda_tpu/ops/snappy.py:52 `_compress_chunks`. The
reference broker compresses via libsnappy one buffer at a time
(src/v/compression/internal/snappy_java_compressor.{h,cc}); here many
independent chunks run per launch, each producing a standard raw
snappy block (decodable by snappy_uncompress). The snappy-java
("xerial") stream framing stays host-side, like the LZ4 frame wrap.

The parse is the shared cell grid of ops/cellparse.py. Emission maps
each sequence to snappy elements:

  [literal element]  tag (len-1)<<2, or 60<<2 / 61<<2 followed by 1 or
                     2 LE bytes of len-1
  [copy elements]    ceil(mlen/64) 2-byte-offset copies (tag & 3 == 2)
                     of the same offset, each at most 64 bytes long

The uncompressed-length preamble varint is prepended on the host (the
kernel emits elements only). Offsets fit 16 bits because chunks are
<= 64 KiB. On the card `_compress_chunks` launches the parse kernel and
`rp_snappy_emit` (csrc/codec.cu); on the CPU `snappy_emit_plain`
follows the JAX program byte for byte.
"""

from __future__ import annotations

import torch

from ..models.consensus_state import check_device
from . import cellparse as cp
from . import lz4
from .cellparse import CELL

LAUNCHES = {"snappy_emit": 0}

# entries with device=None run here; the CPU tests set it to "cpu"
DEFAULT_DEVICE = "cuda"


def out_bound(n: int) -> int:
    """Worst-case output for an n-byte chunk: all-literal cells plus
    per-sequence overhead (3-byte literal header + 3 bytes per 64-byte
    copy span per cell)."""
    return n + (n // CELL + 1) * 6 + 64


def _lit_extra(length):
    """Extra length bytes after the literal tag (0 for len <= 60; else
    1 or 2 little-endian bytes of len-1; chunks <= 64 KiB need <= 2)."""
    return torch.where(length <= 60, 0, torch.where(length <= 256, 1, 2))


def _emit_rows(d, v, parse, n: int):
    """The JAX emission on rows d: uint8 [b, n + CELL], v: int64 [b]."""
    has, mstart, offs, mlen, lit_start, lit_len, last_end = (t.to(torch.int64) for t in parse)
    has = has.bool()
    b, nc = has.shape
    m = out_bound(n)
    dl = d.to(torch.int64)

    lit_ex = _lit_extra(lit_len)
    litsz = torch.where(lit_len > 0, 1 + lit_ex + lit_len, 0)
    ncop = torch.where(has, (mlen + 63) // 64, 0)
    size = torch.where(has, litsz + 3 * ncop, 0)
    csum = torch.cumsum(size, dim=1)
    starts = csum - size
    total = csum[:, -1:]

    f_lit_start = last_end[:, None]
    f_lit_len = torch.clamp(v[:, None] - f_lit_start, min=0)
    f_ex = _lit_extra(f_lit_len)
    out_len = total + torch.where(f_lit_len > 0, 1 + f_ex + f_lit_len, 0)

    def lit_byte_val(length, ex, start, r):
        # r == 0 → tag; r-1 < ex → length byte; else literal data
        tag = torch.where(ex == 0, (length - 1) << 2, torch.where(ex == 1, 60 << 2, 61 << 2))
        len_b = ((length - 1) >> (8 * torch.clamp(r - 1, min=0))) & 255
        data_b = torch.gather(dl, 1, torch.clamp(start + r - 1 - ex, 0, n - 1))
        return torch.where(r == 0, tag, torch.where(r - 1 < ex, len_b, data_b))

    o = torch.arange(m, device=d.device).expand(b, m)
    s = torch.clamp(torch.searchsorted(starts, o.contiguous(), right=True) - 1, 0, nc - 1)
    r = o - torch.gather(starts, 1, s)
    litsz_s = torch.gather(litsz, 1, s)
    lit_v = lit_byte_val(
        torch.gather(lit_len, 1, s), torch.gather(lit_ex, 1, s), torch.gather(lit_start, 1, s), r
    )
    c = r - litsz_s
    ci = torch.div(c, 3, rounding_mode="floor")
    role = c - 3 * ci
    clen = torch.clamp(torch.gather(mlen, 1, s) - 64 * ci, 1, 64)
    off_s = torch.gather(offs, 1, s)
    copy_v = torch.where(
        role == 0, 2 | ((clen - 1) << 2), torch.where(role == 1, off_s & 255, off_s >> 8)
    )
    val = torch.where(r < litsz_s, lit_v, copy_v)
    f_val = lit_byte_val(f_lit_len, f_ex, f_lit_start, o - total)
    out = torch.where(o < total, val, torch.where(o < out_len, f_val, 0))
    return out.to(torch.uint8), out_len[:, 0].to(torch.int32)


def snappy_emit_plain(data, valid, parse, n: int, offset: int = 0):
    """Plain PyTorch version of the snappy emission kernel."""
    return lz4.emit_plain(_emit_rows, data, valid, parse, n, offset)


def snappy_emit(data, valid, parse, n: int, offset: int = 0):
    """Raw snappy elements (no preamble) from a parse of the same rows."""
    cp.check_rows(data, valid, n, offset)
    if data.device.type == "cpu":
        return snappy_emit_plain(data, valid, parse, n, offset)
    return lz4.launch_emit("rp_snappy_emit", LAUNCHES, "snappy_emit", data, valid, parse, n,
                           offset, out_bound(n))


def _compress_chunks(data: torch.Tensor, valid: torch.Tensor, n: int, offset: int = 0):
    """data: uint8 [B, S] holding each input at columns [offset, offset
    + n + CELL), zero-padded; valid: int32 [B]. Returns (out: uint8
    [B, out_bound(n)] WITHOUT the length preamble, out_len: int32 [B])."""
    return snappy_emit(data, valid, cp.cell_parse(data, valid, n, offset), n, offset)


def _preamble(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def compress_chunks(chunks: "list", device=None) -> "list[bytes]":
    """Compress each <= 64 KiB chunk into a standard raw snappy block
    (preamble prepended on the host), one upload and one parse +
    emission launch for all of them."""
    if not chunks:
        return []
    dev = check_device(device or DEFAULT_DEVICE)
    batch, valid, n = lz4.stage_chunks(lz4.as_arrays(chunks), "snappy")
    out, out_len = _compress_chunks(
        torch.from_numpy(batch).to(dev), torch.from_numpy(valid).to(dev), n
    )
    out, out_len = out.cpu().numpy(), out_len.cpu().numpy()
    assert int(out_len.max()) <= out_bound(n), "snappy out_bound violated"
    return [_preamble(int(valid[i])) + out[i, : out_len[i]].tobytes() for i in range(len(chunks))]
