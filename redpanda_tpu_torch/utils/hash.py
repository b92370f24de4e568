"""Non-cryptographic hashes implemented in-tree.

Reference: src/v/hashing/ — xxhash (xxhash.h), murmur (murmur.h),
jump_consistent_hash (jump_consistent_hash.h). The reference links
vendored C libraries; here the algorithms are implemented directly
(pure integer arithmetic, differential-tested against the system
xxhash module and published test vectors) so the data plane does not
depend on an optional binding. murmur2 matches Kafka's default
partitioner (org.apache.kafka.common.utils.Utils.murmur2), which is
what keyed produce uses to pick partitions.
"""

from __future__ import annotations

_M64 = (1 << 64) - 1
_M32 = (1 << 32) - 1

# -- xxh64 ------------------------------------------------------------
_P64_1 = 0x9E3779B185EBCA87
_P64_2 = 0xC2B2AE3D27D4EB4F
_P64_3 = 0x165667B19E3779F9
_P64_4 = 0x85EBCA77C2B2AE63
_P64_5 = 0x27D4EB2F165667C5


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round64(acc: int, lane: int) -> int:
    acc = (acc + lane * _P64_2) & _M64
    return (_rotl64(acc, 31) * _P64_1) & _M64


def _merge64(acc: int, val: int) -> int:
    acc ^= _round64(0, val)
    return ((acc * _P64_1) + _P64_4) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    n = len(data)
    p = 0
    if n >= 32:
        v1 = (seed + _P64_1 + _P64_2) & _M64
        v2 = (seed + _P64_2) & _M64
        v3 = seed & _M64
        v4 = (seed - _P64_1) & _M64
        while p + 32 <= n:
            v1 = _round64(v1, int.from_bytes(data[p : p + 8], "little"))
            v2 = _round64(v2, int.from_bytes(data[p + 8 : p + 16], "little"))
            v3 = _round64(v3, int.from_bytes(data[p + 16 : p + 24], "little"))
            v4 = _round64(v4, int.from_bytes(data[p + 24 : p + 32], "little"))
            p += 32
        h = (
            _rotl64(v1, 1) + _rotl64(v2, 7) + _rotl64(v3, 12) + _rotl64(v4, 18)
        ) & _M64
        h = _merge64(h, v1)
        h = _merge64(h, v2)
        h = _merge64(h, v3)
        h = _merge64(h, v4)
    else:
        h = (seed + _P64_5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h ^= _round64(0, int.from_bytes(data[p : p + 8], "little"))
        h = (_rotl64(h, 27) * _P64_1 + _P64_4) & _M64
        p += 8
    if p + 4 <= n:
        h ^= (int.from_bytes(data[p : p + 4], "little") * _P64_1) & _M64
        h = (_rotl64(h, 23) * _P64_2 + _P64_3) & _M64
        p += 4
    while p < n:
        h ^= (data[p] * _P64_5) & _M64
        h = (_rotl64(h, 11) * _P64_1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P64_2) & _M64
    h ^= h >> 29
    h = (h * _P64_3) & _M64
    h ^= h >> 32
    return h


# -- xxh32 ------------------------------------------------------------
_P32_1 = 0x9E3779B1
_P32_2 = 0x85EBCA77
_P32_3 = 0xC2B2AE3D
_P32_4 = 0x27D4EB2F
_P32_5 = 0x165667B1


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def xxh32(data: bytes, seed: int = 0) -> int:
    n = len(data)
    p = 0
    if n >= 16:
        v1 = (seed + _P32_1 + _P32_2) & _M32
        v2 = (seed + _P32_2) & _M32
        v3 = seed & _M32
        v4 = (seed - _P32_1) & _M32
        while p + 16 <= n:
            for i, v in enumerate((v1, v2, v3, v4)):
                lane = int.from_bytes(data[p + 4 * i : p + 4 * i + 4], "little")
                v = (v + lane * _P32_2) & _M32
                v = (_rotl32(v, 13) * _P32_1) & _M32
                if i == 0:
                    v1 = v
                elif i == 1:
                    v2 = v
                elif i == 2:
                    v3 = v
                else:
                    v4 = v
            p += 16
        h = (
            _rotl32(v1, 1) + _rotl32(v2, 7) + _rotl32(v3, 12) + _rotl32(v4, 18)
        ) & _M32
    else:
        h = (seed + _P32_5) & _M32
    h = (h + n) & _M32
    while p + 4 <= n:
        h = (h + int.from_bytes(data[p : p + 4], "little") * _P32_3) & _M32
        h = (_rotl32(h, 17) * _P32_4) & _M32
        p += 4
    while p < n:
        h = (h + data[p] * _P32_5) & _M32
        h = (_rotl32(h, 11) * _P32_1) & _M32
        p += 1
    h ^= h >> 15
    h = (h * _P32_2) & _M32
    h ^= h >> 13
    h = (h * _P32_3) & _M32
    h ^= h >> 16
    return h


# -- murmur2 (Kafka partitioner variant) ------------------------------
def murmur2(data: bytes, seed: int = 0x9747B28C) -> int:
    """32-bit murmur2 exactly as Kafka's default partitioner computes
    it (Utils.murmur2: seed ^ length, signed-byte widening)."""
    m = 0x5BD1E995
    n = len(data)
    h = (seed ^ n) & _M32
    p = 0
    while p + 4 <= n:
        k = int.from_bytes(data[p : p + 4], "little")
        k = (k * m) & _M32
        k ^= k >> 24
        k = (k * m) & _M32
        h = (h * m) & _M32
        h ^= k
        p += 4
    left = n - p
    # Kafka widens trailing bytes as SIGNED ints before or-ing
    def sb(i: int) -> int:
        b = data[p + i]
        return b - 256 if b >= 128 else b

    if left == 3:
        h ^= (sb(2) << 16) & _M32
    if left >= 2:
        h ^= (sb(1) << 8) & _M32
    if left >= 1:
        h ^= sb(0) & _M32
        h = (h * m) & _M32
    h ^= h >> 13
    h = (h * m) & _M32
    h ^= h >> 15
    return h


def kafka_partition_for_key(key: bytes, num_partitions: int) -> int:
    """Kafka DefaultPartitioner: murmur2 masked positive, modulo."""
    return (murmur2(key) & 0x7FFFFFFF) % num_partitions


# -- murmur3_x86_32 ---------------------------------------------------
def murmur3_32(data: bytes, seed: int = 0) -> int:
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & _M32
    n = len(data)
    p = 0
    while p + 4 <= n:
        k = int.from_bytes(data[p : p + 4], "little")
        k = (k * c1) & _M32
        k = _rotl32(k, 15)
        k = (k * c2) & _M32
        h ^= k
        h = _rotl32(h, 13)
        h = (h * 5 + 0xE6546B64) & _M32
        p += 4
    k = 0
    left = n - p
    if left == 3:
        k ^= data[p + 2] << 16
    if left >= 2:
        k ^= data[p + 1] << 8
    if left >= 1:
        k ^= data[p]
        k = (k * c1) & _M32
        k = _rotl32(k, 15)
        k = (k * c2) & _M32
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    h ^= h >> 16
    return h


# -- fast-path dispatch -----------------------------------------------
# The data plane checksums whole payloads; prefer the C binding when
# present (same algorithm — utils/hash is differential-tested against
# it) and keep the in-tree implementation as the no-dependency
# fallback, mirroring how native/crc32c.cc falls back to pure Python.
try:  # pragma: no cover - environment dependent
    import xxhash as _xxhash_c

    def xxh32_fast(data: bytes, seed: int = 0) -> int:
        return _xxhash_c.xxh32(data, seed=seed).intdigest()

    def xxh64_fast(data: bytes, seed: int = 0) -> int:
        return _xxhash_c.xxh64(data, seed=seed).intdigest()

except ImportError:  # pragma: no cover
    xxh32_fast = xxh32
    xxh64_fast = xxh64


# -- jump consistent hash ---------------------------------------------
def jump_consistent_hash(key: int, num_buckets: int) -> int:
    """Lamping & Veach (the reference's shard-assignment hash,
    hashing/jump_consistent_hash.h): maps key -> [0, num_buckets) with
    minimal movement as buckets grow."""
    if num_buckets <= 0:
        raise ValueError("num_buckets must be positive")
    key &= _M64
    b, j = -1, 0
    while j < num_buckets:
        b = j
        key = (key * 2862933555777941757 + 1) & _M64
        j = int((b + 1) * (float(1 << 31) / float((key >> 33) + 1)))
    return b
