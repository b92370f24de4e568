"""Port vs reference: batched CRC-32C.

Seeded ragged rows go through redpanda_tpu.ops.crc32c (JAX on the
CPU), redpanda_tpu_torch.ops.crc32c on device="cpu" (the plain
version) and the host utils/crc.crc32c_batch. Checksums are integers:
exact equality. The CUDA kernel's scheme (tiles from the row's end,
padded to 16 bytes, shared by a team of warps, pieces carried by a
fixed operator and joined in trees of fixed operators) is replayed
here in numpy against the same host-built tables it uploads, at every
row start mod 16, so the algebra and the staging are checked on the CPU
too.
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


@pytest.mark.parametrize(
    "seed,stride", [(0, 64), (1, 256), (2, 1024), (3, 1000), (4, 40 + 512 + 16), (5, 1001)]
)
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


def _le_words(buf: np.ndarray) -> np.ndarray:
    return buf.view("<u4").astype(np.uint32)


def _apply(op: np.ndarray, v: np.ndarray) -> np.ndarray:
    """An operator given as eight nibble tables, on uint32 vectors."""
    out = np.zeros_like(v)
    for c in range(8):
        out ^= op[c][(v >> np.uint32(4 * c)) & 0xF]
    return out


def _slice4(c, w):
    t = tcrc._TABLES
    c = c ^ w
    return t[3][c & 0xFF] ^ t[2][(c >> 8) & 0xFF] ^ t[1][(c >> 16) & 0xFF] ^ t[0][c >> 24]


def _kernel_replay(mem: np.ndarray, pa: int, n: int, team: int, w: int) -> int:
    """csrc/crc32c.cu's scheme for one row of n bytes at address pa of
    `mem`, shared by a team of `team` warps of 32 lanes that fold w bytes
    a tile each, in numpy: the row padded at its end with z zero bytes to
    a 16-byte boundary; tiles of 32 * w bytes laid out from that end, warp w taking the tiles w, w + team, ...
    from the end; each tile staged into a buffer of stale bytes (16-byte
    words of the aligned middle, scalar head and tail, the padding's
    zeros, zeros before the row's start); a lane's piece read as aligned
    words and folded with slice-by-4 from register 0 as two halves, each
    carried from tile to tile by Z^(team * tile) and joined by Z^(w / 2)
    at the row's end; the join across lanes by Z^(w * 2^j) and across
    the team's warps by Z^(tile * 2^j); then Z^-z. Every operator is
    host-built, and every read of `mem` is checked to lie inside the
    row."""
    tile = 32 * w
    v_words = w // 16
    ops = tcrc.team_ops(team, w)
    pad = (16 - (pa + n) % 16) % 16
    padded = n + pad
    nt = max(1, -(-padded // tile))
    stale = np.random.default_rng(n + pa).integers(0, 256, tile, dtype=np.uint8)
    lane = np.arange(32)

    def read(x, size=1):
        assert 0 <= x and x + size <= n, f"read [{x}, {x + size}) outside the row of {n}"
        return mem[pa + x : pa + x + size]

    def shfl_down(v, k):
        return np.where(lane + k < 32, v[np.minimum(lane + k, 31)], v)

    warp_regs = np.zeros(32, np.uint32)
    for member in range(team):
        m = (nt - 1 - member) // team + 1 if member < nt else 1
        r0 = r1 = np.zeros(32, np.uint32)
        for i in range(m):
            d = member + team * (m - 1 - i)
            e = padded - d * tile
            s = e - tile
            hd = min(n, (pa + 19) // 16 * 16 - pa)
            tl = max((pa + n) // 16 * 16 - pa, hd)
            buf = stale.copy()  # buf[x - s]: row position x
            for x in range(max(s, hd), min(e, tl), 16):  # the bulk copy's words
                assert (pa + x) % 16 == 0 and (x - s) % 16 == 0 and x - s + 16 <= tile
                buf[x - s : x - s + 16] = read(x, 16)
            for t in range(32):
                if t < hd and s <= t < e:
                    buf[t - s] = read(t)[0] ^ (0xFF if t < 4 else 0)
                if tl + t < n and s <= tl + t < e:
                    buf[tl + t - s] = read(tl + t)[0]
                if d == 0 and n + t < e:
                    buf[n + t - s] = 0
                for x in range(t - w, 0, 32) if e > 0 else ():
                    if x >= s:
                        buf[x - s] = 0
            words = _le_words(buf).reshape(32, 4 * v_words)
            halves = []
            for h in range(2):  # two chains over the piece's halves
                fh = np.zeros(32, np.uint32)
                for j in range(2 * v_words * h, 2 * v_words * (h + 1)):
                    fh = _slice4(fh, words[:, j])
                halves.append(np.where(s + (lane + 1) * w > 0, fh, np.uint32(0)))
            f0, f1 = halves
            r0, r1 = (f0, f1) if i == 0 else (_apply(ops[0], r0) ^ f0, _apply(ops[0], r1) ^ f1)
        r = _apply(ops[1], r0) ^ r1
        for j in range(5):  # across lanes
            r = _apply(ops[2 + j], r) ^ shfl_down(r, 1 << j)
        warp_regs[member] = r[0]
    v = warp_regs
    levels = team.bit_length() - 1
    for j in range(levels):  # across the team's warps
        v = v ^ _apply(ops[7 + j], shfl_down(v, 1 << j))
    if pad:
        v = _apply(ops[7 + levels + pad - 1], v)
    reg = int(v[0])
    if n < 4:
        reg ^= 0xFFFFFFFF >> (8 * n)
    return reg ^ 0xFFFFFFFF


def _replay_lengths(team: int, w: int) -> list:
    tile = 32 * w
    return [0, 1, 3, 4, 5, 7, 8, 9, 15, 16, 17, 19, 20, w - 1, w, w + 1,
            tile - 1, tile, tile + 1, 2 * tile - 1, 2 * tile + 1,
            team * tile - 1, team * tile + 1, (2 * team + 1) * tile + 3]


@pytest.mark.parametrize("shape", ["one", "many"])
@pytest.mark.parametrize("start", range(16))
def test_segment_shift_scheme_matches_host(shape, start):
    team, w = tcrc.ONE if shape == "one" else tcrc.MANY
    lengths = _replay_lengths(team, w)
    rng = np.random.default_rng(start)
    mem = rng.integers(0, 256, 64 + max(lengths), dtype=np.uint8)
    pa = 32 + start
    for n in lengths:
        row = mem[pa : pa + n].tobytes()
        assert _kernel_replay(mem, pa, n, team, w) == host_crc.crc32c(row), (shape, start, n)


def test_operator_tables_append_zeros():
    """Each host-built operator Z^n equals n byte steps of zeros, and
    Z^-z takes z of them back."""
    vals = np.random.default_rng(3).integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    t0 = tcrc._TABLES[0]
    for n in (1, 4, 15, 40, 72, 80, 144, 2560, 4608, 9216, 20480):
        want = vals.copy()
        for _ in range(n):
            want = t0[want & 0xFF] ^ (want >> np.uint32(8))
        np.testing.assert_array_equal(_apply(tcrc.op_tables(n), vals), want)
        if n < 16:
            np.testing.assert_array_equal(_apply(tcrc.op_tables(-n), want), vals)


def test_lane_copies_keep_each_lane_in_its_bank():
    """The MANY shape's table copies: lane l reads word l of a row in one
    slot and word l ^ 16 in the other, and finds there the entry of the
    table its byte selector names (csrc/crc32c.cu slice4)."""
    rows = tcrc.lane_copies()
    rng = np.random.default_rng(5)
    c = rng.integers(0, 2**32, 32, dtype=np.uint64).astype(np.uint32)
    lane = np.arange(32)
    got = np.zeros(32, np.uint32)
    for q in range(2):
        for slot in range(2):
            byte = 2 * q + ((lane >> 4) ^ slot)  # the PRMT selector's byte
            idx = (c >> (8 * byte).astype(np.uint32)) & 0xFF
            word = lane ^ (16 * slot)
            assert len(set((word % 32).tolist())) == 32  # one bank a lane
            got ^= rows[q * 256 + idx, word]
    np.testing.assert_array_equal(got, _slice4(np.zeros(32, np.uint32), c))


def test_rows_take_int32_lengths_and_an_offset():
    """crc32c_rows over lens + add, as the fused codec entries call it."""
    mat, lens = ragged_rows(np.random.default_rng(11), 16, 300)
    lens = np.minimum(lens, 260)
    want = host_crc.crc32c_batch(mat, (lens + 40).astype(np.uint64))
    got = tcrc.crc32c_rows(torch.from_numpy(mat), torch.from_numpy(lens.astype(np.int32)), 40)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
