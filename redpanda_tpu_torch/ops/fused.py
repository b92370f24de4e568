"""Fused CRC-32C + LZ4 / snappy / zstd over record-batch bodies: ONE upload.

Replaces redpanda_tpu/ops/fused.py:42 `_fused`, :69 `_fused_snappy` and
:89 `_fused_zstd`.
Validation and compression share one host->device copy of the rows,
so the transfer is paid once for both.

Row layout ([B, PREFIX + n + CELL] uint8, zero-padded):

    [ crc_prefix (40 B) | records body (n bucket) | CELL guard ]

The Kafka batch CRC covers crc_prefix || body (model/record.h:398), so
`crc32c_rows` (csrc/crc32c.cu) runs over the whole rows with lengths
body_len + PREFIX, taking the int32 body lengths and PREFIX itself (no
cast or add kernel ahead of it); it reads only those bytes, so it needs
neither the JAX program's 512-byte-aligned slice nor its optimization
barrier. The parse and emission kernels then read each body in place,
at column offset PREFIX of the same rows: no second upload, no copy.
All three launches go on the current stream, back to back.

The zstd leg uses the JAX program's row width, PREFIX + n rounded up to
512 bytes (no CELL guard: the huff0 encode reads only [0, n) of the
body), and runs two launches: the CRC, then `rp_zstd_encode`
(csrc/zstd.cu) on the body at column offset PREFIX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.consensus_state import check_device
from . import lz4, snappy, zstd
from .cellparse import CELL
from .crc32c import crc32c_rows

PREFIX = 40  # models/record.py _CRC_PREFIX packed size

# entries with device=None run here; the CPU tests set it to "cpu"
DEFAULT_DEVICE = "cuda"


def _fused(data: torch.Tensor, body_len: torch.Tensor, n: int):
    """data [B, PREFIX + n + CELL] uint8; body_len int32 [B]. Returns
    (crc int64 [B] over prefix || body, lz4 blocks, their lengths)."""
    crc = crc32c_rows(data, body_len, PREFIX)
    out, out_len = lz4._compress_chunks(data, body_len, n, PREFIX)
    return crc, out, out_len


def _fused_snappy(data: torch.Tensor, body_len: torch.Tensor, n: int):
    """Same layout as `_fused`, snappy emission instead of LZ4."""
    crc = crc32c_rows(data, body_len, PREFIX)
    out, out_len = snappy._compress_chunks(data, body_len, n, PREFIX)
    return crc, out, out_len


def _lz4_width(n: int) -> int:
    return PREFIX + n + CELL


def _zstd_width(n: int) -> int:
    return ((PREFIX + n + 511) // 512) * 512


def stage_fused(prefixes, bodies, width=_lz4_width):
    """(matrix [rows, width(n)], body lengths, n) with n the power of two
    >= 512 that holds the longest body. The LZ4 / snappy rows end in a
    CELL guard; the zstd rows take the JAX program's 512-byte-aligned
    width."""
    arrs = lz4.as_arrays(bodies)
    longest = max(a.size for a in arrs)
    if longest > 65536:
        raise ValueError("fused codec bodies must be <= 64 KiB")
    n = 512
    while n < longest:
        n *= 2
    batch = np.zeros((len(arrs), width(n)), np.uint8)
    body_len = np.zeros(len(arrs), np.int32)
    for i, (p, a) in enumerate(zip(prefixes, arrs)):
        assert len(p) == PREFIX, f"prefix must be {PREFIX} bytes"
        batch[i, :PREFIX] = np.frombuffer(p, np.uint8)
        batch[i, PREFIX : PREFIX + a.size] = a
        body_len[i] = a.size
    return batch, body_len, n


def _fused_entry(prefixes, bodies, kernel, bound_fn, preamble_fn, device):
    assert len(prefixes) == len(bodies)
    if not bodies:
        return np.empty(0, np.uint32), []
    dev = check_device(device or DEFAULT_DEVICE)
    batch, body_len, n = stage_fused(prefixes, bodies)
    crc, out, out_len = kernel(
        torch.from_numpy(batch).to(dev), torch.from_numpy(body_len).to(dev), n
    )
    crc = crc.cpu().numpy().astype(np.uint32)
    out, out_len = out.cpu().numpy(), out_len.cpu().numpy()
    assert int(out_len.max()) <= bound_fn(n)
    blocks = []
    for i in range(len(bodies)):
        blk = out[i, : out_len[i]].tobytes()
        if preamble_fn is not None:
            blk = preamble_fn(int(body_len[i])) + blk
        blocks.append(blk)
    return crc, blocks


def crc_lz4_fused(prefixes: "list[bytes]", bodies: "list", device=None):
    """One upload: per-row Kafka CRC (over prefix || body) and the body
    compressed into a standard LZ4 block. Bodies must be <= 64 KiB (the
    parse's bound); callers chunk larger bodies and assemble
    multi-block frames on the host. Returns (np.uint32 [B], blocks)."""
    return _fused_entry(prefixes, bodies, _fused, lz4.out_bound, None, device)


def crc_snappy_fused(prefixes: "list[bytes]", bodies: "list", device=None):
    """One upload: per-row Kafka CRC + raw snappy blocks (preamble
    prepended on the host)."""
    return _fused_entry(prefixes, bodies, _fused_snappy, snappy.out_bound,
                        snappy._preamble, device)


def _fused_zstd(data: torch.Tensor, body_len: torch.Tensor, n: int):
    """data [B, ceil((PREFIX + n) / 512) * 512] uint8; body_len int32
    [B]. Returns (crc int64 [B] over prefix || body, and the body's zstd
    entropy stage: nbits uint8 [B, 256], streams uint8 [B, 4, SB], bits
    int32 [B, 4])."""
    crc = crc32c_rows(data, body_len, PREFIX)
    nbits, streams, bits = zstd._encode_chunks(data, body_len, n, PREFIX)
    return crc, nbits, streams, bits


def crc_zstd_fused(prefixes: "list[bytes]", bodies: "list", device=None):
    """One upload: per-row Kafka CRC (over prefix || body) and the
    body's zstd entropy stage; each body comes back as a complete
    single-block zstd frame (raw / RLE / compressed, stock-decodable).
    Bodies must be <= 64 KiB like the LZ4 leg; larger buffers go
    through compression.tpu_backend.compress_many_zstd. Returns
    (np.uint32 [B], frames)."""
    from ..compression import zstd_frame as zf

    assert len(prefixes) == len(bodies)
    if not bodies:
        return np.empty(0, np.uint32), []
    dev = check_device(device or DEFAULT_DEVICE)
    batch, body_len, n = stage_fused(prefixes, bodies, _zstd_width)
    crc, nbits, streams, bits = _fused_zstd(
        torch.from_numpy(batch).to(dev), torch.from_numpy(body_len).to(dev), n
    )
    crc = crc.cpu().numpy().astype(np.uint32)
    encs = zstd.streams_of(nbits.cpu().numpy(), streams.cpu().numpy(), bits.cpu().numpy(), len(bodies))
    frames = []
    for a, (nb, sl) in zip(lz4.as_arrays(bodies), encs):
        if a.size == 0:
            frames.append(zf.frame_header(0) + zf.raw_block(b"", True))
            continue
        frames.append(zf.frame_header(a.size) + zf.build_block(a.tobytes(), nb, sl, True))
    return crc, frames
