"""Batched CRC-32C on the card — validate many record batches per call.

The device-side record-batch validator (north star: BASELINE.md —
record-batch CRC as a batched kernel; host analog
model/record_utils.h:23-31 + the native rp_crc32c_batch).

`crc32c_device` runs csrc/crc32c.cu for rows on the card: each row,
padded at its end to a 16-byte boundary, is cut into tiles laid out from
that end and shared by a team of warps; a lane folds one piece of each of
its warp's tiles with slice-by-4 and carries its register from tile to
tile with one fixed operator, and the pieces are joined in trees of
fixed operators (CRC-32C is linear over GF(2), so appending n zero bytes
to a register is a fixed linear map Z^n, and Z is invertible). The
slice-by-4 tables and every operator, as eight nibble tables each, are
built here on the host with the same algebra as redpanda_tpu/ops/crc32c.py
and uploaded once per device. For rows on the CPU it runs
`crc32c_device_plain`, a byte-wise table fold in int64 (torch has no
uint32 shifts on the CPU).

`crc32c_batch_device` keeps the JAX package's numpy contract: a padded
[n, stride] uint8 matrix and lens in, np.uint32 checksums out.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..models.consensus_state import check_device
from ..observability import devplane
from ..utils.crc import _TABLE as _BYTE_TABLE
from . import _build

# crc32c_batch_device(device=None) runs here; the CPU tests set it to "cpu"
DEFAULT_DEVICE = "cuda"

LAUNCHES = {"crc32c_device": 0}

# csrc/crc32c.cu's two shapes, (warps a team, bytes a lane folds per
# tile of 32 lanes): ONE when there are no more rows than SMs, else MANY
ONE = (8, 80)
MANY = (2, 144)

_LIB = None
_CONSTS: dict = {}  # device -> the uploaded slice-by-4 and operator tables


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("crc32c")
        _build.bind(lib, "rp_crc32c", 4, 4)
        _LIB = lib
    return _LIB


def _make_tables(n: int = 4) -> np.ndarray:
    """Slice-by-n tables: row 0 is the shared byte table from utils.crc
    (same polynomial by construction); row k is row 0 followed by k zero
    bytes."""
    t = np.zeros((n, 256), dtype=np.uint32)
    t[0] = _BYTE_TABLE
    for k in range(1, n):
        t[k] = t[0][t[k - 1] & 0xFF] ^ (t[k - 1] >> np.uint32(8))
    return t


_TABLES = _make_tables()


# -- GF(2) linear-algebra helpers (host-side, numpy) -----------------
def _apply_cols(cols: np.ndarray, vecs: np.ndarray) -> np.ndarray:
    """Apply a 32x32 GF(2) matrix (given as its 32 uint32 columns) to
    an array of uint32 vectors."""
    out = np.zeros_like(vecs, dtype=np.uint32)
    for k in range(32):
        out ^= np.where((vecs >> np.uint32(k)) & 1, cols[k], np.uint32(0))
    return out


@functools.cache
def _z_cols() -> np.ndarray:
    """Columns of Z, the one-zero-byte register extension:
    Z(s) = T0[s & 0xff] ^ (s >> 8)."""
    t0 = _TABLES[0]
    return np.array(
        [t0[(1 << k) & 0xFF] ^ (np.uint32(1 << k) >> np.uint32(8)) for k in range(32)],
        dtype=np.uint32,
    )


@functools.cache
def _z_pow2_cols() -> np.ndarray:
    """Columns of Z^(2^j) for j < 32: [32, 32] uint32."""
    pows = [_z_cols()]
    for _ in range(31):
        pows.append(_apply_cols(pows[-1], pows[-1]))
    return np.stack(pows)


def _z_pow_cols(n: int) -> np.ndarray:
    """Columns of Z^n, the operator that appends n zero bytes."""
    cols = np.uint32(1) << np.arange(32, dtype=np.uint32)  # the identity
    for j, pow_cols in enumerate(_z_pow2_cols()):
        if n >> j & 1:
            cols = _apply_cols(pow_cols, cols)
    return cols


def _z_inv(v: np.ndarray) -> np.ndarray:
    """Z^-1 on uint32 vectors: Z(s) = T0[s & 0xff] ^ (s >> 8), and the top
    bytes of T0's 256 entries are distinct, so the top byte of Z(s) names
    s & 0xff."""
    t0 = _TABLES[0]
    byte = np.argsort(t0 >> np.uint32(24)).astype(np.uint32)[v >> np.uint32(24)]
    return ((v ^ t0[byte]) << np.uint32(8)) | byte


def _nibble_tables(cols: np.ndarray) -> np.ndarray:
    """A 32x32 GF(2) matrix (its 32 columns) as eight nibble tables,
    [8, 16] uint32: M(v) is the xor over c of table[c][(v >> 4c) & 0xf]."""
    x = np.arange(16, dtype=np.uint32)
    return np.stack([_apply_cols(cols, x << np.uint32(4 * c)) for c in range(8)])


def op_tables(n: int) -> np.ndarray:
    """Z^n as eight nibble tables, for n >= 0, and for n < 0 the inverse
    of Z^-n (zeros taken off a register's end)."""
    if n >= 0:
        return _nibble_tables(_z_pow_cols(n))
    cols = np.uint32(1) << np.arange(32, dtype=np.uint32)
    for _ in range(-n):
        cols = _z_inv(cols)
    return _nibble_tables(cols)


def team_ops(team: int, w: int) -> np.ndarray:
    """A shape's operators, [22 + log2(team), 8, 16], with a tile of
    tile = 32 * w bytes: Z^(team * tile) (a warp's carry from one of its
    tiles to the next), Z^(w / 2) (a piece is folded as two halves),
    Z^(w * 2^j) for j < 5 (the join across a warp's lanes),
    Z^(tile * 2^j) for j < log2(team) (across its warps), then Z^-z for
    z = 1..15 (the kernel pads each row's end with z zero bytes to a
    16-byte boundary and takes them back off the CRC's register)."""
    tile = 32 * w
    return np.stack(
        [op_tables(team * tile), op_tables(w // 2)]
        + [op_tables(w << j) for j in range(5)]
        + [op_tables(tile << j) for j in range(team.bit_length() - 1)]
        + [op_tables(-z) for z in range(1, 16)]
    )


def lane_copies() -> np.ndarray:
    """The slice-by-4 tables as the MANY shape reads them, [512, 32]
    uint32: row q * 256 + i holds entry i of byte 2q's table (T(3 - 2q))
    in words 0-15 and of byte 2q + 1's (T(2 - 2q)) in words 16-31, so
    each lane finds the entry it needs in its own bank."""
    rows = np.empty((2, 256, 32), np.uint32)
    for q in range(2):
        rows[q, :, :16] = _TABLES[3 - 2 * q][:, None]
        rows[q, :, 16:] = _TABLES[2 - 2 * q][:, None]
    return rows.reshape(512, 32)


def _consts(device: torch.device) -> torch.Tensor:
    """The slice-by-4 tables T0..T3, their lane copies, then the ONE and
    the MANY shape's operators, as one int32 buffer on `device` (the
    kernel reads the words as uint32)."""
    key = str(device)
    buf = _CONSTS.get(key)
    if buf is None:
        words = np.concatenate(
            [_TABLES.reshape(-1), lane_copies().reshape(-1), team_ops(*ONE).reshape(-1),
             team_ops(*MANY).reshape(-1)]
        )
        buf = torch.from_numpy(words.view(np.int32).copy()).to(device)
        _CONSTS[key] = buf
    return buf


def crc32c_device_plain(data: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch CRC-32C: one byte-wise table step per column, in
    int64 with & 0xFFFFFFFF; rows stop advancing at their length."""
    b, s = data.shape
    t0 = torch.from_numpy(_TABLES[0].astype(np.int64)).to(data.device)
    crc = torch.full((b,), 0xFFFFFFFF, dtype=torch.int64, device=data.device)
    wide = data.to(torch.int64)
    for c in range(s):
        step = t0[(crc ^ wide[:, c]) & 0xFF] ^ (crc >> 8)
        crc = torch.where(lens > c, step, crc)
    return crc ^ 0xFFFFFFFF


def crc32c_device(data: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """CRC-32C of each row: data [B, S] uint8, lens [B] int64 (each in
    [0, S]; bytes past a row's length are never read).

    Returns [B] int64 holding the finalized unsigned 32-bit checksums
    (torch keeps no uint32 arithmetic, so the values ride in int64)."""
    if lens.dtype != torch.int64:
        raise ValueError(f"lens: expected int64, got {lens.dtype}")
    return crc32c_rows(data, lens)


def crc32c_rows(data: torch.Tensor, lens: torch.Tensor, add: int = 0) -> torch.Tensor:
    """`crc32c_device` over the first lens[i] + add bytes of each row, with
    lens int64 or int32: the fused codec entries pass their int32 body
    lengths and the prefix length, so no cast or add runs on the card
    ahead of the CRC."""
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"data: expected a [B, S] uint8 tensor, got {data.dtype} {tuple(data.shape)}")
    b, s = data.shape
    if lens.dtype not in (torch.int64, torch.int32) or tuple(lens.shape) != (b,) or lens.device != data.device:
        raise ValueError(f"lens: expected int64 or int32 ({b},) on {data.device}")
    if data.device.type == "cpu":
        return crc32c_device_plain(data, lens.to(torch.int64) + add)
    if data.device.type != "cuda":
        raise ValueError(f"crc32c kernels run on cuda or cpu tensors, not {data.device}")
    if not data.is_contiguous() or not lens.is_contiguous():
        raise ValueError("data and lens must be contiguous")
    if b >= 1 << 31 or s >= 1 << 31:
        raise ValueError(f"[{b}, {s}] exceeds the kernel's 2^31 - 1 rows and row bytes")
    out = torch.empty(b, dtype=torch.int64, device=data.device)
    if b:
        lib = _lib()
        rc = lib.rp_crc32c(
            data.data_ptr(),
            lens.data_ptr(),
            _consts(data.device).data_ptr(),
            out.data_ptr(),
            b, s, int(lens.dtype == torch.int32), add,
            _build.stream_of(data),
        )
        _build.check(lib, rc, "crc32c_device")
        LAUNCHES["crc32c_device"] += 1
    return out


def crc32c_batch_device(bufs: np.ndarray, lens: np.ndarray, device=None) -> np.ndarray:
    """Drop-in device counterpart of utils.crc.crc32c_batch (same padded
    [n, stride] layout produced by models.record.batch_crcs)."""
    dev = check_device(device or DEFAULT_DEVICE)
    bufs = np.ascontiguousarray(bufs, dtype=np.uint8)
    lens = np.asarray(lens, dtype=np.int64)
    if lens.size and int(lens.max()) > bufs.shape[1]:
        raise ValueError(
            f"lens.max()={int(lens.max())} exceeds stride={bufs.shape[1]}"
        )
    if bufs.ndim != 2 or lens.shape != (bufs.shape[0],):
        raise ValueError("bufs must be [n, stride] with one len per row")
    out = crc32c_device(
        torch.from_numpy(bufs).to(dev), torch.from_numpy(lens).to(dev)
    )
    return out.cpu().numpy().astype(np.uint32)


# ----------------------------------------------------- devplane probes
# The names the live path looks up are bound to their devplane probes
# (observability/devplane.py; each IS the function while RP_DEVPLANE is
# unset).
crc32c_device = devplane.probe(crc32c_device, "crc32c.device")
