"""Batched CRC-32C on the card — validate many record batches per call.

The device-side record-batch validator (north star: BASELINE.md —
record-batch CRC as a batched kernel; host analog
model/record_utils.h:23-31 + the native rp_crc32c_batch).

`crc32c_device` runs csrc/crc32c.cu for rows on the card: slice-by-8
table folds over contiguous segments of each row, joined through the
GF(2) shift operator Z^k (CRC-32C is linear over GF(2), so appending k
zero bytes to a register is a fixed 32x32 bit matrix). The slice-by-8
tables and the binary powers Z^(2^j) are built here on the host, with
the same algebra as redpanda_tpu/ops/crc32c.py, and uploaded once per
device. For rows on the CPU it runs `crc32c_device_plain`, a byte-wise
table fold in int64 (torch has no uint32 shifts on the CPU).

`crc32c_batch_device` keeps the JAX package's numpy contract: a padded
[n, stride] uint8 matrix and lens in, np.uint32 checksums out.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..models.consensus_state import check_device
from ..utils.crc import _TABLE as _BYTE_TABLE
from . import _build

LAUNCHES = {"crc32c_device": 0}

_POW_MATS = 31  # Z^(2^j) for j < 31 (csrc/crc32c.cu POW_MATS)
_BLOCKS_PER_SM = 8  # 256-thread blocks resident per SM

_LIB = None
_CONSTS: dict = {}  # device -> uploaded tables + shift matrices


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("crc32c")
        _build.bind(lib, "rp_crc32c", 4, 3)
        _LIB = lib
    return _LIB


def _make_tables() -> np.ndarray:
    """Slice-by-8 tables: row 0 is the shared byte table from utils.crc
    (same polynomial by construction); rows 1..7 are derived."""
    t = np.zeros((8, 256), dtype=np.uint32)
    t[0] = _BYTE_TABLE
    for n in range(256):
        c = t[0, n]
        for k in range(1, 8):
            c = t[0, c & 0xFF] ^ (c >> np.uint32(8))
            t[k, n] = c
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
    """Columns of Z^(2^j) for j in [0, _POW_MATS): [J, 32] uint32 —
    the shift operators the kernel composes to append k zero bytes."""
    pows = [_z_cols()]
    for _ in range(_POW_MATS - 1):
        pows.append(_apply_cols(pows[-1], pows[-1]))
    return np.stack(pows)


def _consts(device: torch.device) -> torch.Tensor:
    """Slice-by-8 tables then shift-matrix columns, as one int32 buffer
    on `device` (the kernel reads the words as uint32)."""
    key = str(device)
    buf = _CONSTS.get(key)
    if buf is None:
        words = np.concatenate([_TABLES.reshape(-1), _z_pow2_cols().reshape(-1)])
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
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"data: expected a [B, S] uint8 tensor, got {data.dtype} {tuple(data.shape)}")
    b, s = data.shape
    if lens.dtype != torch.int64 or tuple(lens.shape) != (b,) or lens.device != data.device:
        raise ValueError(f"lens: expected int64 ({b},) on {data.device}")
    if data.device.type == "cpu":
        return crc32c_device_plain(data, lens)
    if data.device.type != "cuda":
        raise ValueError(f"crc32c kernels run on cuda or cpu tensors, not {data.device}")
    if not data.is_contiguous() or not lens.is_contiguous():
        raise ValueError("data and lens must be contiguous")
    if s >= 1 << _POW_MATS:
        raise ValueError(f"stride {s} exceeds the kernel's 2^{_POW_MATS} limit")
    out = torch.empty(b, dtype=torch.int64, device=data.device)
    if b:
        lib = _lib()
        sms = torch.cuda.get_device_properties(data.device).multi_processor_count
        rc = lib.rp_crc32c(
            data.data_ptr(),
            lens.data_ptr(),
            _consts(data.device).data_ptr(),
            out.data_ptr(),
            b, s, sms * _BLOCKS_PER_SM,
            _build.stream_of(data),
        )
        _build.check(lib, rc, "crc32c_device")
        LAUNCHES["crc32c_device"] += 1
    return out


def crc32c_batch_device(bufs: np.ndarray, lens: np.ndarray, device="cuda") -> np.ndarray:
    """Drop-in device counterpart of utils.crc.crc32c_batch (same padded
    [n, stride] layout produced by models.record.batch_crcs)."""
    dev = check_device(device)
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
