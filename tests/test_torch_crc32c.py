"""Port vs reference: batched CRC-32C.

Seeded ragged rows go through redpanda_tpu.ops.crc32c (JAX on the
CPU), redpanda_tpu_torch.ops.crc32c on device="cpu" (the plain
version) and the host utils/crc.crc32c_batch. Checksums are integers:
exact equality. The segment-and-shift scheme the CUDA kernel uses is
replayed here in numpy against the same host-built constants it
uploads, so the algebra is checked on the CPU too.
"""

import numpy as np
import pytest
import torch

from redpanda_tpu.ops import crc32c as jcrc
from redpanda_tpu_torch.ops import crc32c as tcrc
from redpanda_tpu_torch.utils import crc as host_crc


def ragged_rows(rng, n, stride):
    lens = rng.integers(0, stride + 1, n).astype(np.int64)
    lens[0] = 0
    lens[1] = stride
    mat = np.zeros((n, stride), np.uint8)
    for i in range(n):
        mat[i, : lens[i]] = rng.integers(0, 256, lens[i], dtype=np.uint8)
    return mat, lens


@pytest.mark.parametrize("seed,stride", [(0, 64), (1, 256), (2, 1024), (3, 1000)])
def test_batch_matches_jax_and_host(seed, stride):
    mat, lens = ragged_rows(np.random.default_rng(seed), 24, stride)
    got = tcrc.crc32c_batch_device(mat, lens, device="cpu")
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jcrc.crc32c_batch_device(mat, lens))
    np.testing.assert_array_equal(got, host_crc.crc32c_batch(mat, lens.astype(np.uint64)))
    assert got[0] == 0  # len 0


def test_known_vector():
    data = np.zeros((1, 16), np.uint8)
    data[0, :9] = np.frombuffer(b"123456789", np.uint8)
    assert int(tcrc.crc32c_batch_device(data, np.array([9]), device="cpu")[0]) == 0xE3069283


def test_tensor_entry_returns_int64_checksums():
    mat, lens = ragged_rows(np.random.default_rng(7), 8, 128)
    out = tcrc.crc32c_device(torch.from_numpy(mat), torch.from_numpy(lens))
    assert out.dtype == torch.int64 and tuple(out.shape) == (8,)
    assert int(out.min()) >= 0 and int(out.max()) < 2**32
    np.testing.assert_array_equal(
        out.numpy().astype(np.uint32), host_crc.crc32c_batch(mat, lens.astype(np.uint64))
    )


def test_lens_past_stride_rejected():
    with pytest.raises(ValueError):
        tcrc.crc32c_batch_device(np.zeros((2, 8), np.uint8), np.array([3, 9]), device="cpu")


def _kernel_replay(row: bytes, threads: int) -> int:
    """csrc/crc32c.cu's per-row algorithm in Python: per-thread
    slice-by-8 over word-aligned segments, then Z^k shifts by the
    host-built powers and an xor reduction."""
    tab = [[int(x) for x in t] for t in tcrc._TABLES]
    pows = [[int(x) for x in m] for m in tcrc._z_pow2_cols()]

    def apply(cols, v):
        out = 0
        for b in range(32):
            if (v >> b) & 1:
                out ^= cols[b]
        return out

    def shift(v, k):
        j = 0
        while k and v:
            if k & 1:
                v = apply(pows[j], v)
            k >>= 1
            j += 1
        return v

    n = len(row)
    seg = ((n + threads - 1) // threads + 7) & ~7
    acc = 0
    for t in range(threads):
        lo = min(t * seg, n)
        hi = min(lo + seg, n)
        crc = 0xFFFFFFFF if t == 0 else 0
        i = lo
        while i + 8 <= hi:
            crc ^= int.from_bytes(row[i : i + 4], "little")
            crc = (
                tab[7][crc & 0xFF] ^ tab[6][(crc >> 8) & 0xFF]
                ^ tab[5][(crc >> 16) & 0xFF] ^ tab[4][crc >> 24]
                ^ tab[3][row[i + 4]] ^ tab[2][row[i + 5]]
                ^ tab[1][row[i + 6]] ^ tab[0][row[i + 7]]
            )
            i += 8
        while i < hi:
            crc = tab[0][(crc ^ row[i]) & 0xFF] ^ (crc >> 8)
            i += 1
        acc ^= shift(crc, n - hi)
    return acc ^ 0xFFFFFFFF


@pytest.mark.parametrize("n,threads", [(0, 256), (9, 256), (257, 256), (1000, 256), (4099, 64)])
def test_segment_shift_scheme_matches_host(n, threads):
    row = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert _kernel_replay(row, threads) == host_crc.crc32c(row)
