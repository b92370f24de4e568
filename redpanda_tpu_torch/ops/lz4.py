"""Batched LZ4 block compression on the card — the device LZ4 codec.

Replaces redpanda_tpu/ops/lz4.py:59 `_compress_chunks`. The reference
broker compresses on the CPU one buffer at a time
(src/v/compression/internal/lz4_frame_compressor.cc over liblz4); here
many independent chunks of at most 64 KiB are compressed per launch,
each into a standard LZ4 *block* (decodable by LZ4_decompress_safe)
that the host wraps into an LZ4 *frame*.

The parse is the shared cell grid of ops/cellparse.py (one sequence
decision per 16-byte cell). Emission: every cell with a match emits
one sequence — token `(min(lit, 15) << 4) | min(mlen - 4, 15)`, the
255-run extra literal-length bytes, the literals, a 2-byte LE offset,
the 255-run extra match-length bytes — at the exclusive prefix sum of
the sequence sizes; a final literals-only sequence covers
[last_end, valid). Blocks trade ratio for parallelism (no match
crosses a cell boundary) but are bit-valid LZ4: the last sequence is
literals-only, no match starts within the final 12 bytes, and offsets
are <= 65535.

On the card `_compress_chunks` launches the parse kernel and the
emission kernel `rp_lz4_emit` (csrc/codec.cu); on the CPU it runs
`lz4_emit_plain`, which follows the JAX program: each output byte
finds its (sequence, role) by a right-sided searchsorted over the
sequence starts and gathers its value. Both give the same bytes on
[0, out_len); the plain version also zero-fills the rest of the row.
"""

from __future__ import annotations

import numpy as np
import torch

from ..observability import devplane
from . import _build, default_device
from . import cellparse as cp
from .cellparse import CELL

LAUNCHES = devplane.count_launches({"lz4_emit": 0})


def out_bound(n: int) -> int:
    """Worst-case output bytes for an n-byte chunk (all-literal cells
    plus per-cell sequence overhead plus 255-run length bytes)."""
    return n + (n // CELL + 1) * 5 + n // 64 + 64


def _n_extra(length):
    return torch.where(length >= 15, (length - 15) // 255 + 1, 0)


def _extra_byte(length, i):
    # i-th byte of the 255-run encoding of (length - 15)
    return torch.clamp(length - 15 - 255 * i, 0, 255)


def _emit_rows(d, v, parse, n: int):
    """The JAX emission on rows d: uint8 [b, n + CELL], v: int64 [b]."""
    has, mstart, offs, mlen, lit_start, lit_len, last_end = (t.to(torch.int64) for t in parse)
    has = has.bool()
    b, nc = has.shape
    m = out_bound(n)
    nk = _n_extra(lit_len)
    mex = torch.where(has, _n_extra(mlen - 4), 0)
    size = torch.where(has, 1 + nk + lit_len + 2 + mex, 0)
    csum = torch.cumsum(size, dim=1)
    starts = csum - size
    total = csum[:, -1:]

    f_lit_start = last_end[:, None]
    f_lit_len = torch.clamp(v[:, None] - f_lit_start, min=0)
    f_nk = _n_extra(f_lit_len)
    out_len = total + 1 + f_nk + f_lit_len

    o = torch.arange(m, device=d.device).expand(b, m)
    s = torch.clamp(torch.searchsorted(starts, o.contiguous(), right=True) - 1, 0, nc - 1)
    r = o - torch.gather(starts, 1, s)
    lit_len_s = torch.gather(lit_len, 1, s)
    nk_s = torch.gather(nk, 1, s)
    mlen_s = torch.gather(mlen, 1, s)
    token = (torch.clamp(lit_len_s, max=15) << 4) | torch.clamp(mlen_s - 4, 0, 15)
    a1 = 1 + nk_s
    a2 = a1 + lit_len_s
    dl = d.to(torch.int64)
    lit_byte = torch.gather(dl, 1, torch.clamp(torch.gather(lit_start, 1, s) + (r - a1), 0, n - 1))
    offs_s = torch.gather(offs, 1, s)
    val = torch.where(
        r == 0, token,
        torch.where(r < a1, _extra_byte(lit_len_s, r - 1),
        torch.where(r < a2, lit_byte,
        torch.where(r == a2, offs_s & 255,
        torch.where(r == a2 + 1, offs_s >> 8, _extra_byte(mlen_s - 4, r - (a2 + 2)))))),
    )
    fo = o - total
    f_a1 = 1 + f_nk
    f_lit_byte = torch.gather(dl, 1, torch.clamp(f_lit_start + fo - f_a1, 0, n - 1))
    f_val = torch.where(
        fo == 0, torch.clamp(f_lit_len, max=15) << 4,
        torch.where(fo < f_a1, _extra_byte(f_lit_len, fo - 1), f_lit_byte),
    )
    out = torch.where(o < total, val, torch.where(o < out_len, f_val, 0))
    return out.to(torch.uint8), out_len[:, 0].to(torch.int32)


def emit_plain(emit_rows, data, valid, parse, n: int, offset: int):
    """Row-chunked driver shared by the LZ4 and snappy plain emitters."""
    d = data[:, offset : offset + n + CELL]
    v = valid.to(torch.int64)
    step = cp.row_chunk(n)
    parts = [
        emit_rows(d[i : i + step], v[i : i + step], [t[i : i + step] for t in parse], n)
        for i in range(0, d.shape[0], step)
    ] or [emit_rows(d, v, parse, n)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def lz4_emit_plain(data, valid, parse, n: int, offset: int = 0):
    """Plain PyTorch version of the LZ4 emission kernel."""
    return emit_plain(_emit_rows, data, valid, parse, n, offset)


def check_parse(data, parse, n: int) -> None:
    """The parse vectors a kernel launch reads by pointer: `cell_parse`'s
    seven tensors, contiguous, of its dtypes and shapes ([B, n / CELL],
    last_end [B]), on the rows' device."""
    b, dev = data.shape[0], data.get_device()
    shapes = ((b, n // CELL),) * 6 + ((b,),)
    dtypes = (torch.bool,) + (torch.int32,) * 6
    if len(parse) != len(cp.FIELDS) or not all(
        t.dtype == dt and t.shape == sh and t.get_device() == dev and t.is_contiguous()
        for t, sh, dt in zip(parse, shapes, dtypes)
    ):
        got = [(t.dtype, tuple(t.shape), str(t.device), t.is_contiguous()) for t in parse]
        raise ValueError(f"parse: expected {len(cp.FIELDS)} contiguous tensors {cp.FIELDS} of dtypes "
                         f"{dtypes}, shapes {shapes} on {data.device}; got {got}")


def launch_emit(entry: str, counter: dict, key: str, data, valid, parse, n: int,
                offset: int, m: int):
    """One launch of an emission kernel: out [B, m] (bytes past each
    row's out_len are left unwritten) and out_len [B] int32."""
    check_parse(data, parse, n)
    b, stride = data.shape
    out = torch.empty((b, m), dtype=torch.uint8, device=data.device)
    out_len = torch.empty(b, dtype=torch.int32, device=data.device)
    if b:
        lib = cp._lib()
        rc = getattr(lib, entry)(
            data.data_ptr(), valid.data_ptr(), *(t.data_ptr() for t in parse),
            out.data_ptr(), out_len.data_ptr(), b, stride, offset, n, m,
            _build.stream_of(data),
        )
        _build.check(lib, rc, key)
        counter[key] += 1
    return out, out_len


def lz4_emit(data, valid, parse, n: int, offset: int = 0):
    """LZ4 blocks from a parse of the same rows (see `cell_parse`)."""
    cp.check_rows(data, valid, n, offset)
    if data.device.type == "cpu":
        return lz4_emit_plain(data, valid, parse, n, offset)
    return launch_emit("rp_lz4_emit", LAUNCHES, "lz4_emit", data, valid, parse, n, offset,
                       out_bound(n))


def _compress_chunks(data: torch.Tensor, valid: torch.Tensor, n: int, offset: int = 0):
    """data: uint8 [B, S] holding each input at columns [offset, offset
    + n + CELL), zero-padded; valid: int32 [B]. Returns (out: uint8
    [B, out_bound(n)], out_len: int32 [B])."""
    return lz4_emit(data, valid, cp.cell_parse(data, valid, n, offset), n, offset)


def stage_chunks(arrs, what: str):
    """(padded [rows, n + CELL] matrix, valid lengths, n) for chunks of
    at most 64 KiB, n the power of two >= 256 that holds the longest."""
    longest = max(a.size for a in arrs)
    if longest > cp.MAX_N:
        raise ValueError(f"device {what} chunks must be <= 64 KiB")
    n = 256
    while n < longest:
        n *= 2
    batch = np.zeros((len(arrs), n + CELL), np.uint8)
    valid = np.zeros(len(arrs), np.int32)
    for i, a in enumerate(arrs):
        batch[i, : a.size] = a
        valid[i] = a.size
    return batch, valid, n


def as_arrays(chunks) -> list:
    return [np.frombuffer(c, np.uint8) if isinstance(c, (bytes, bytearray, memoryview)) else c
            for c in chunks]


def compress_chunks(chunks: "list[bytes | np.ndarray]", device=None) -> "list[bytes]":
    """Compress each <= 64 KiB chunk into a standard LZ4 block, one
    upload and one parse + emission launch for all of them."""
    if not chunks:
        return []
    dev = default_device.resolve(device)
    batch, valid, n = stage_chunks(as_arrays(chunks), "lz4")
    out, out_len = _compress_chunks(
        torch.from_numpy(batch).to(dev), torch.from_numpy(valid).to(dev), n
    )
    out, out_len = out.cpu().numpy(), out_len.cpu().numpy()
    assert int(out_len.max()) <= out_bound(n), "lz4 out_bound violated"
    return [out[i, : out_len[i]].tobytes() for i in range(len(chunks))]


# ----------------------------------------------------- devplane probes
# The names the live path looks up are bound to their devplane probes
# (observability/devplane.py; each IS the function while RP_DEVPLANE is
# unset). The fused sequence calls `_compress_chunks_raw`, so
# one call counts once, under its own name.
_compress_chunks_raw = _compress_chunks
_compress_chunks = devplane.probe(_compress_chunks_raw, "lz4.compress_chunks")
