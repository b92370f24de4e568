"""Fused CRC-32C + LZ4 / snappy / zstd over record-batch bodies: ONE upload.

Replaces redpanda_tpu/ops/fused.py:42 `_fused`, :69 `_fused_snappy` and
:89 `_fused_zstd`.
Validation and compression share one host->device copy of the rows,
so the transfer is paid once for both.

Row layout ([B, PREFIX + n + CELL] uint8, zero-padded):

    [ crc_prefix (40 B) | records body (n bucket) | CELL guard ]

The Kafka batch CRC covers crc_prefix || body (model/record.h:398).

`_fused` (CRC + LZ4) and `_fused_snappy` (CRC + snappy) on the card are
each ONE launch of the cluster kernel of csrc/fused.cu (`rp_fused_lz4`,
`rp_fused_snappy`: one template, the codec's byte rules from
csrc/lz77.cuh): a thread-block cluster of C CTAs a row, which stages the
row in every CTA, folds the CRC in C pieces, sorts the body's positions
by hash across the cluster, verifies, scans and emits the block, the
parse vectors never leaving shared memory (`LAUNCHES["fused_lz4"]`,
`LAUNCHES["fused_snappy"]`). `plan` picks C from the row count, the
bucket and the clusters of the codec's kernel the card holds at once:
CLUSTER_ONE_ROW CTAs a row, halved while the rows' clusters would not
all be resident, down to the smallest size that sorts the bucket's keys
and fits the card's shared memory. On an H100 the cluster launch beat
the three-launch sequence it replaced at every row count measured (1 to
256 rows, PERF.md), so every CUDA call takes it; a launch that is
refused raises. On the CPU both run the plain chain
(`crc32c_device_plain`, `cell_parse_plain`, the codec's plain emission),
the kernel's twin; `_fused_sequence` / `_fused_snappy_sequence` keep the
three launches (`crc32c_rows`, then the parse and emission kernels of
csrc/codec.cu reading each body in place at column PREFIX) for the
harnesses that time them.

The zstd leg uses the JAX program's row width, PREFIX + n rounded up to
512 bytes (no CELL guard: the huff0 encode reads only [0, n) of the
body). `_fused_zstd` on the card is ONE launch of `rp_fused_zstd`
(csrc/zstd.cu: the encode's cluster of four CTAs a row with its CRC
stage, `LAUNCHES["fused_zstd"]`): after the cluster barrier, while warp
0 runs the Kraft loop, CTA q's other warps fold the CRC of the bytes of
its quarter it counts from its staged copy (CTA 0 the prefix too), in
units and joins fixed by the shape (K from the library's
`rp_fused_zstd_units`, operators from `zstd_crc_consts`); one warp joins them, moves the part to the message's
end by Z^L with L from the row's length and sends it to CTA 0. A
launch that is refused raises. On the CPU it is the plain chain;
`_fused_zstd_sequence` keeps the two launches it replaced
(`crc32c_rows`, then `rp_zstd_encode` on the body at column PREFIX)
for the harnesses.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..observability import devplane
from . import _build, default_device, lz4, snappy, zstd
from . import cellparse as cp
from . import crc32c as crc_ops
from .cellparse import CELL
from .crc32c import crc32c_rows

PREFIX = 40  # models/record.py _CRC_PREFIX packed size


LAUNCHES = devplane.count_launches({"fused_lz4": 0, "fused_snappy": 0, "fused_zstd": 0})

# the codecs of the cluster kernel: each one's id in the C entries (CODEC_*
# in csrc/fused.cu), its launch entry, its block's bound and its parse +
# emission as separate launches (the plain sequence's second half)
CODECS = {"lz4": (0, "rp_fused_lz4", lz4.out_bound, lz4._compress_chunks_raw),
          "snappy": (1, "rp_fused_snappy", snappy.out_bound, snappy._compress_chunks_raw)}

# csrc/fused.cu: threads a CTA, the cluster sizes it is built for, the CRC
# operators a K
FUSED_THREADS = 1024
CLUSTERS = (2, 4, 8, 16)
CTA_OPS = 15
# the plan's cluster size at one row (measured on an H100, PERF.md)
CLUSTER_ONE_ROW = 16

_LIB = None
_CONSTS: dict = {}  # (device, n, C) or (device, "zstd", n, threads) -> the CRC tables and operators
_RESIDENT: dict = {}  # (device, n, codec) -> {C: clusters of that size resident at once}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare csrc/fused.cu's entry points on a loaded library."""
    for _, entry, _, _ in CODECS.values():
        _build.bind(lib, entry, 6, 8)
    _build.bind(lib, "rp_fused_empty", 0, 5)
    lib.rp_fused_shape.argtypes = [ctypes.c_int64] * 4 + [ctypes.c_void_p]
    lib.rp_fused_shape.restype = ctypes.c_int
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = bind(_build.load("fused"))
    return _LIB


def shape_info(n: int, c: int, codec: str = "lz4") -> tuple:
    """(dynamic shared memory bytes, resident clusters) of the codec's
    kernel for bucket n at cluster size c, as the card reports them (no
    cluster where the shared memory does not fit)."""
    lib = _lib()
    out = (ctypes.c_int32 * 2)()
    _build.check(lib, lib.rp_fused_shape(PREFIX, n, c, CODECS[codec][0], ctypes.addressof(out)), "fused shape")
    return int(out[0]), int(out[1])


def launch_empty(data: torch.Tensor, n: int, c: int, codec: str = "lz4") -> None:
    """An empty kernel at launch_fused's grid, cluster and shared memory."""
    lib = _lib()
    rc = lib.rp_fused_empty(data.shape[0], PREFIX, n, c, CODECS[codec][0], _build.stream_of(data))
    _build.check(lib, rc, "fused empty")


def sort_keys(c: int) -> int:
    """The keys a CTA of a c-CTA cluster can sort (csrc/fused.cu max_kpt:
    16 a lane up to C = 4, 64 / C past it)."""
    return (64 // c if c >= 4 else 16) * FUSED_THREADS


def min_cluster(n: int) -> int:
    """The smallest cluster whose CTAs each sort their share of n keys."""
    return next(c for c in CLUSTERS if -(-n // c) <= sort_keys(c))


def sizes(n: int, resident: dict) -> list:
    """The cluster sizes `plan` can choose for bucket n: those that sort
    the bucket's keys and of which `resident` (as `plan` takes it) holds
    at least one cluster."""
    return [c for c in CLUSTERS if c >= min_cluster(n) and resident[c] > 0]


def plan(b: int, n: int, resident: dict) -> int:
    """The cluster size C for a launch of b rows of bucket n. `resident`
    maps each size to the clusters of it the card holds at once (one CTA
    an SM; a cluster's CTAs share one GPC, so an H100's 132 SMs hold 66
    of 2, 30 of 4, 15 of 8, 7 of 16; 0 where the shared memory does not
    fit): CLUSTER_ONE_ROW, halved while the b clusters would not all be
    resident, down to the smallest of `sizes`. Raises where there is
    none."""
    fit = sizes(n, resident)
    if not fit:
        raise ValueError(f"no cluster size fits bucket n={n} on this card (resident {resident})")
    floor = fit[0]
    c = max(CLUSTER_ONE_ROW, floor)
    while c > floor and b > resident[c]:
        c //= 2
    return c


CRC_LANE_UNITS = 4  # units a lane folds where a CTA's P allows: fewer warps to join


def crc_piece(n: int, c: int) -> tuple:
    """(P, K): the 16-byte units of prefix || body (counted from the row's
    end) a CTA folds, so that c CTAs cover a full row of bucket n, and the
    units a thread folds: about CRC_LANE_UNITS, so that W = ceil(P / 32 K)
    warps (at most a CTA's 32) hold them."""
    p = -(-(-(-(PREFIX + n) // 16)) // c)
    w = min(FUSED_THREADS // 32, -(-p // (32 * CRC_LANE_UNITS)))
    return p, -(-p // (32 * w))


@functools.cache
def crc_ops_for(n: int, c: int) -> np.ndarray:
    """The kernel's CRC operators for the shape, [25, 8, 16]: Z^(16 K 2^j)
    (lanes) and Z^(16 K 32 2^j) (warps), j < 5, then Z^(16 P r) for
    r = 1..15 (CTA r's part to the row's end)."""
    p, k = crc_piece(n, c)
    return np.stack([crc_ops.op_tables((16 * k) << j) for j in range(5)]
                    + [crc_ops.op_tables((16 * k * 32) << j) for j in range(5)]
                    + [crc_ops.op_tables(16 * p * r) for r in range(1, CTA_OPS + 1)])


def crc_consts(device, n: int, c: int) -> torch.Tensor:
    """The slice-by-4 tables then `crc_ops_for(n, c)`, one int32 buffer on
    `device` (the kernel reads the words as uint32), built once."""
    key = (str(device), n, c)
    buf = _CONSTS.get(key)
    if buf is None:
        words = np.concatenate([crc_ops._TABLES.reshape(-1), crc_ops_for(n, c).reshape(-1)])
        buf = torch.from_numpy(words.view(np.int32).copy()).to(device)
        _CONSTS[key] = buf
    return buf


def resident(device, n: int, codec: str = "lz4") -> dict:
    """{C: clusters of C CTAs resident at once} of the codec's kernel for
    bucket n on `device`, as the card reports them (once per device,
    bucket and codec)."""
    key = (str(device), n, codec)
    if key not in _RESIDENT:
        with torch.cuda.device(device):
            _RESIDENT[key] = {c: shape_info(n, c, codec)[1] if -(-n // c) <= sort_keys(c) else 0
                              for c in CLUSTERS}
    return _RESIDENT[key]


def plan_for(data: torch.Tensor, n: int, codec: str = "lz4") -> int:
    """`plan` for these rows on their card."""
    return plan(data.shape[0], n, resident(data.device, n, codec))


def launch_fused(data: torch.Tensor, body_len: torch.Tensor, n: int, c: int, codec: str = "lz4"):
    """One launch of the codec's cluster kernel with c CTAs a row: (crc
    int64 [B], out uint8 [B, out_bound(n)] (bytes past each out_len
    unwritten), out_len int32 [B])."""
    if c not in CLUSTERS or -(-n // c) > sort_keys(c):
        raise ValueError(f"cluster size {c} cannot take n={n} (sizes {CLUSTERS}, >= {min_cluster(n)})")
    _, entry, bound, _ = CODECS[codec]
    b, stride = data.shape
    m = bound(n)
    dev = data.device
    crc = torch.empty(b, dtype=torch.int64, device=dev)
    out = torch.empty((b, m), dtype=torch.uint8, device=dev)
    out_len = torch.empty(b, dtype=torch.int32, device=dev)
    if b:
        piece, k = crc_piece(n, c)
        lib = _lib()
        rc = getattr(lib, entry)(
            data.data_ptr(), body_len.data_ptr(), crc_consts(dev, n, c).data_ptr(), crc.data_ptr(),
            out.data_ptr(), out_len.data_ptr(), b, stride, PREFIX, n, m, piece, k, c, _build.stream_of(data),
        )
        _build.check(lib, rc, f"fused_{codec}")
        LAUNCHES[f"fused_{codec}"] += 1
    return crc, out, out_len


def _sequence(data: torch.Tensor, body_len: torch.Tensor, n: int, codec: str):
    """The CRC, the parse and the codec's emission one after the other:
    on the CPU the plain chain; on the card the three launches the
    codec's cluster kernel replaced (chip_smoke and chip_fused time them
    beside it)."""
    crc = crc32c_rows(data, body_len, PREFIX)
    out, out_len = CODECS[codec][3](data, body_len, n, PREFIX)
    return crc, out, out_len


def _fused_sequence(data: torch.Tensor, body_len: torch.Tensor, n: int):
    """`_sequence` for LZ4 (`rp_fused_lz4` replaced it)."""
    return _sequence(data, body_len, n, "lz4")


def _fused(data: torch.Tensor, body_len: torch.Tensor, n: int):
    """data [B, PREFIX + n + CELL] uint8; body_len int32 [B]. Returns
    (crc int64 [B] over prefix || body, lz4 blocks, their lengths)."""
    return _fused_codec(data, body_len, n, "lz4")


def _fused_codec(data: torch.Tensor, body_len: torch.Tensor, n: int, codec: str):
    """The codec's plain chain on the CPU, one cluster launch on the card."""
    cp.check_rows(data, body_len, n, PREFIX)
    if data.device.type == "cpu":
        return _sequence(data, body_len, n, codec)
    return launch_fused(data, body_len, n, plan_for(data, n, codec), codec)


def _fused_snappy_sequence(data: torch.Tensor, body_len: torch.Tensor, n: int):
    """`_sequence` for snappy (`rp_fused_snappy` replaced it)."""
    return _sequence(data, body_len, n, "snappy")


def _fused_snappy(data: torch.Tensor, body_len: torch.Tensor, n: int):
    """Same layout as `_fused`, snappy elements instead of the LZ4 block
    (the length preamble is the host's)."""
    return _fused_codec(data, body_len, n, "snappy")


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
    dev = default_device.resolve(device)
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


# csrc/zstd.cu's CRC stage: operators across a warp's lanes and across
# warps, and the Z^(2^j) a piece's shift is built from (a shift < 2^17)
ZSTD_LANE_OPS, ZSTD_WARP_OPS, ZSTD_POW2 = 5, 4, 17


@functools.cache
def zstd_crc_ops(k: int) -> np.ndarray:
    """The CRC stage's constants for K 16-byte units a folding thread
    (the library's rp_fused_zstd_units), uint32 words: the slice-by-4
    tables, Z^(16 K 2^j) for j < 5 (lanes) and Z^(16 K 32 2^j) for j < 4
    (warps) as nibble tables, then Z^(2^j) for j < 17 as their 32
    columns."""
    ops = ([crc_ops.op_tables((16 * k) << j) for j in range(ZSTD_LANE_OPS)]
           + [crc_ops.op_tables((16 * k * 32) << j) for j in range(ZSTD_WARP_OPS)])
    return np.concatenate([crc_ops._TABLES.reshape(-1), np.stack(ops).reshape(-1),
                           crc_ops._z_pow2_cols()[:ZSTD_POW2].reshape(-1)])


def zstd_crc_consts(device, k: int) -> torch.Tensor:
    """`zstd_crc_ops(k)` as one int32 buffer on `device`, built once."""
    key = (str(device), "zstd", k)
    buf = _CONSTS.get(key)
    if buf is None:
        buf = torch.from_numpy(zstd_crc_ops(k).view(np.int32).copy()).to(device)
        _CONSTS[key] = buf
    return buf


def launch_fused_zstd(data: torch.Tensor, body_len: torch.Tensor, n: int):
    """One `rp_fused_zstd` launch: (crc int64 [B], nbits uint8 [B, 256],
    codes int32 [B, 256], streams uint8 [B, 4, SB], bits int32 [B, 4]).
    The codes are written for the comparison with the plain version."""
    b, stride = data.shape
    dev = data.device
    crc = torch.empty(b, dtype=torch.int64, device=dev)
    nbits = torch.empty((b, 256), dtype=torch.uint8, device=dev)
    codes = torch.empty((b, 256), dtype=torch.int32, device=dev)
    streams = torch.empty((b, 4, zstd.stream_byte_bound(n)), dtype=torch.uint8, device=dev)
    bits = torch.empty((b, 4), dtype=torch.int32, device=dev)
    if b:
        lib = zstd._lib()
        consts = zstd_crc_consts(dev, lib.rp_fused_zstd_units(b, PREFIX, n))
        rc = lib.rp_fused_zstd(
            data.data_ptr(), body_len.data_ptr(), consts.data_ptr(), crc.data_ptr(), nbits.data_ptr(),
            codes.data_ptr(), streams.data_ptr(), bits.data_ptr(), b, stride, PREFIX, n, _build.stream_of(data),
        )
        _build.check(lib, rc, "fused_zstd")
        LAUNCHES["fused_zstd"] += 1
    return crc, nbits, codes, streams, bits


def _fused_zstd_sequence(data: torch.Tensor, body_len: torch.Tensor, n: int):
    """The CRC, then the encode: on the CPU the plain chain; on the card
    the two launches `rp_fused_zstd` replaced (chip_smoke and
    chip_zstd_encode time them beside it)."""
    crc = crc32c_rows(data, body_len, PREFIX)
    nbits, streams, bits = zstd._encode_chunks_raw(data, body_len, n, PREFIX)
    return crc, nbits, streams, bits


def _fused_zstd(data: torch.Tensor, body_len: torch.Tensor, n: int):
    """data [B, ceil((PREFIX + n) / 512) * 512] uint8; body_len int32
    [B]. Returns (crc int64 [B] over prefix || body, and the body's zstd
    entropy stage: nbits uint8 [B, 256], streams uint8 [B, 4, SB], bits
    int32 [B, 4]). The plain chain on the CPU, one launch on the card."""
    zstd._check_encode(data, body_len, n, PREFIX)
    if data.device.type == "cpu":
        return _fused_zstd_sequence(data, body_len, n)
    crc, nbits, _, streams, bits = launch_fused_zstd(data, body_len, n)
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
    dev = default_device.resolve(device)
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


# ----------------------------------------------------- devplane probes
# The names the live path looks up are bound to their devplane probes
# (observability/devplane.py; each IS the function while RP_DEVPLANE is
# unset). The sequences call the codecs' `*_raw` functions, so
# one call counts once, under its own name.
_fused = devplane.probe(_fused, "fused.crc_lz4")
_fused_snappy = devplane.probe(_fused_snappy, "fused.crc_snappy")
_fused_zstd = devplane.probe(_fused_zstd, "fused.crc_zstd")
