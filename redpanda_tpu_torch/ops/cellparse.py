"""Shared cell-grid LZ77 parse for the device codecs (lz4, snappy).

Replaces redpanda_tpu/ops/cellparse.py:30 `cell_parse` (run there once
per row inside the vmapped codec programs). The parse reshapes the
sequential greedy LZ77 scan into one decision per fixed CELL-byte cell:

  1. each position's nearest earlier position with the same 4-gram hash
     (`h = (gram * 2654435761 mod 2^32) >> 16`), walked 3 deep;
  2. verification: a candidate is kept only if it matches from its
     in-cell start to the cell end, and no cell ending within the last
     12 bytes matches;
  3. per cell the FIRST good position; run merging: a cell that starts
     its match at its first byte with the previous cell's offset is
     absorbed into that cell's match;
  4. literal-run attribution by an exclusive running max.

Both codecs emit (literal run | match to cell end) sequences from the
per-cell vectors; only the byte-level emission differs.

`cell_parse` takes a [B, S] uint8 matrix, each row holding its input at
columns [offset, offset + n + CELL), zero past the row's valid length.
The fused CRC + codec path passes the uploaded [prefix | body] rows with
offset = 40 so the body is read in place. Rows on the card run the
CUDA kernel `rp_cell_parse` in csrc/codec.cu: one block per row gets
the candidates from the same sort, done as a block-wide stable radix
sort of the positions by hash (two 8-bit passes through a [B, 2, n]
uint32 scratch this wrapper allocates once per launch), then each key's
predecessor in sorted order. Rows on the CPU run `cell_parse_plain`,
which follows the JAX program step by step (a sort of (hash << 17 |
pos) keys for the candidates, gathers of [n, CELL] windows for the
verification).

Outputs, per row (nc = n // CELL cells):
  has[nc] bool, mstart[nc], offs[nc], mlen[nc], lit_start[nc],
  lit_len[nc] int32, and last_end int32 (one per row). `offs` and
  `mstart` are defined for every cell, as the JAX program leaves them
  (for a cell with no match they come from its first position's third
  candidate); that part depends on the zero padding past `valid`.
"""

from __future__ import annotations

import torch

from . import _build

CELL = 16  # parse grid: one sequence decision per CELL bytes
MAX_N = 65536  # 16-bit offsets and positions (the kernel's sort keys are hash << 16 | pos)
_HASH_BITS = 16
_TAIL_GUARD = 12  # no match may start near the end (LZ4 spec; safe for snappy)
_PRIME = 2654435761

LAUNCHES = {"cell_parse": 0}

_LIB = None

FIELDS = ("has", "mstart", "offs", "mlen", "lit_start", "lit_len", "last_end")


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("codec")
        _build.bind(lib, "rp_cell_parse", 10, 4)
        _build.bind(lib, "rp_lz4_emit", 11, 5)
        _build.bind(lib, "rp_snappy_emit", 11, 5)
        _LIB = lib
    return _LIB


def check_rows(data: torch.Tensor, valid: torch.Tensor, n: int, offset: int) -> None:
    """Shape, type and range checks shared by the parse and the emitters."""
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"data: expected a [B, S] uint8 tensor, got {data.dtype} {tuple(data.shape)}")
    if n % CELL or not CELL <= n <= MAX_N:
        raise ValueError(f"n={n}: expected a multiple of {CELL} in [{CELL}, {MAX_N}]")
    if offset < 0 or data.shape[1] < offset + n + CELL:
        raise ValueError(f"rows of {data.shape[1]} bytes cannot hold offset {offset} + n {n} + {CELL}")
    b = data.shape[0]
    if valid.dtype != torch.int32 or tuple(valid.shape) != (b,) or valid.device != data.device:
        raise ValueError(f"valid: expected int32 ({b},) on {data.device}")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"codec kernels run on cuda or cpu tensors, not {data.device}")
    if data.device.type == "cuda" and not (data.is_contiguous() and valid.is_contiguous()):
        raise ValueError("data and valid must be contiguous")


def _hash(d: torch.Tensor, n: int) -> torch.Tensor:
    """16-bit multiplicative hash of the 4-gram at each of n positions
    (d: int64 [B, n + CELL]). The u32 product is split in 16-bit halves
    so nothing overflows int64."""
    gram = d[:, 0:n] | (d[:, 1 : n + 1] << 8) | (d[:, 2 : n + 2] << 16) | (d[:, 3 : n + 3] << 24)
    lo = (gram & 0xFFFF) * _PRIME
    hi = ((gram >> 16) * _PRIME) & 0xFFFF
    return ((lo + (hi << 16)) & 0xFFFFFFFF) >> (32 - _HASH_BITS)


def _candidates(h: torch.Tensor) -> torch.Tensor:
    """cand[p] = the largest q < p with h[q] == h[p], else -1: each key
    (h << 17 | pos)'s predecessor in sorted order, as the JAX program
    takes it."""
    b, n = h.shape
    pos = torch.arange(n, device=h.device).expand(b, n)
    sk = torch.sort((h << 17) | pos, dim=1).values
    sh, sp = sk >> 17, sk & 0x1FFFF
    prev_ok = torch.zeros_like(sh, dtype=torch.bool)
    prev_ok[:, 1:] = sh[:, 1:] == sh[:, :-1]
    cand_sorted = torch.where(prev_ok, torch.roll(sp, 1, dims=1), -1)
    return torch.empty_like(sp).scatter_(1, sp, cand_sorted)


def _parse_rows(d: torch.Tensor, v: torch.Tensor, n: int):
    """The JAX program on rows d: uint8 [b, n + CELL], v: int64 [b]."""
    b = d.shape[0]
    dev = d.device
    nc = n // CELL
    cand = _candidates(_hash(d.to(torch.int64), n))

    pos = torch.arange(n, device=dev)
    cell_end = (pos // CELL + 1) * CELL
    cap = torch.minimum(cell_end[None, :], v[:, None]) - pos[None, :]  # [b, n]
    k = torch.arange(CELL, device=dev)
    pk = (pos[:, None] + k[None, :]).reshape(1, -1).expand(b, -1)
    dp = torch.gather(d, 1, pk).view(b, n, CELL)
    eligible = (cap >= 4) & (cell_end[None, :] <= v[:, None] - _TAIL_GUARD)

    def verify(q):
        qk = torch.clamp(q[:, :, None] + k, 0, n - 1).reshape(b, -1)
        eq = (dp == torch.gather(d, 1, qk).view(b, n, CELL)) & (k < cap[:, :, None])
        run = torch.cumprod(eq.to(torch.int32), dim=2).sum(dim=2)
        return (run == cap) & eligible & (q >= 0)

    def follow(c):
        return torch.where(c >= 0, torch.gather(cand, 1, torch.clamp(c, 0, n - 1)), -1)

    cand1 = cand
    cand2 = follow(cand1)
    cand3 = follow(cand2)
    g1, g2, g3 = verify(cand1), verify(cand2), verify(cand3)
    good = g1 | g2 | g3
    csel = torch.where(g1, cand1, torch.where(g2, cand2, cand3))

    # one sequence per cell: first in-cell position whose match runs to
    # the cell end (argmax's first index; 0 when the cell has none)
    goodc = good.view(b, nc, CELL)
    has = goodc.any(dim=2)
    j = torch.where(goodc, k, CELL).min(dim=2).values
    j = torch.where(has, j, 0)
    cell_idx = torch.arange(nc, device=dev)
    mstart = cell_idx * CELL + j
    offs = mstart - torch.gather(csel, 1, mstart)

    # run absorption: a cell continuing the previous cell's match
    absorb = torch.zeros_like(has)
    absorb[:, 1:] = has[:, 1:] & has[:, :-1] & (j[:, 1:] == 0) & (offs[:, 1:] == offs[:, :-1])
    head = has & ~absorb
    boundary = torch.where(~absorb, cell_idx, nc)
    rev_min = torch.flip(torch.cummin(torch.flip(boundary, (1,)), dim=1).values, (1,))
    next_boundary = torch.full_like(boundary, nc)
    next_boundary[:, :-1] = rev_min[:, 1:]
    run_end = torch.where(head, next_boundary, 0)
    mlen = torch.where(head, (run_end - cell_idx) * CELL - j, 0)

    # literal-run starts: the end of the previous match run
    contrib = torch.where(head, run_end * CELL, 0)
    cmax = torch.cummax(contrib, dim=1).values
    prev_end = torch.zeros_like(cmax)
    prev_end[:, 1:] = cmax[:, :-1]
    lit_len = torch.where(head, mstart - prev_end, 0)
    last_end = torch.clamp(cmax[:, -1], min=0)
    i32 = torch.int32
    return (head, mstart.to(i32), offs.to(i32), mlen.to(i32), prev_end.to(i32),
            lit_len.to(i32), last_end.to(i32))


def row_chunk(n: int) -> int:
    """Rows per step of a plain version: its [rows, n, CELL] gathers stay
    near 2^21 elements, so the card's memory holds them at any batch."""
    return max(1, (1 << 21) // n)


def cell_parse_plain(data: torch.Tensor, valid: torch.Tensor, n: int, offset: int = 0):
    """Plain PyTorch version of `cell_parse`, row-chunked."""
    d = data[:, offset : offset + n + CELL]
    v = valid.to(torch.int64)
    step = row_chunk(n)
    parts = [_parse_rows(d[i : i + step], v[i : i + step], n) for i in range(0, d.shape[0], step)]
    if not parts:
        parts = [_parse_rows(d, v, n)]
    return tuple(torch.cat(cols) for cols in zip(*parts))


def launch_parse(data: torch.Tensor, valid: torch.Tensor, n: int, offset: int) -> tuple:
    """One launch of the parse kernel (checked arguments on the card)."""
    b, stride = data.shape
    i32 = dict(dtype=torch.int32, device=data.device)
    out = (
        torch.empty((b, n // CELL), dtype=torch.bool, device=data.device),
        *(torch.empty((b, n // CELL), **i32) for _ in range(5)),
        torch.empty(b, **i32),
    )
    if b:
        lib = _lib()
        keys = torch.empty((b, 2, n), dtype=torch.int32, device=data.device)
        rc = lib.rp_cell_parse(
            data.data_ptr(), valid.data_ptr(), *(t.data_ptr() for t in out),
            keys.data_ptr(), b, stride, offset, n, _build.stream_of(data),
        )
        _build.check(lib, rc, "cell_parse")
        LAUNCHES["cell_parse"] += 1
    return out


def cell_parse(data: torch.Tensor, valid: torch.Tensor, n: int, offset: int = 0) -> tuple:
    """Per-cell parse of each row's input at columns [offset, offset + n
    + CELL): data [B, S] uint8 (zero past each row's valid length),
    valid [B] int32 (each <= n). Returns (has, mstart, offs, mlen,
    lit_start, lit_len, last_end): [B, n // CELL] bool / int32 and
    [B] int32."""
    check_rows(data, valid, n, offset)
    if data.device.type == "cpu":
        return cell_parse_plain(data, valid, n, offset)
    return launch_parse(data, valid, n, offset)
