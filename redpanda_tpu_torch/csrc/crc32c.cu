// Batched CRC-32C (Castagnoli, reflected) over rows of a byte matrix.
//
// Replaces redpanda_tpu/ops/crc32c.py:226 crc32c_device: the finalized
// CRC-32C of the first lens[i] + add bytes of each row of a [B, S] uint8
// matrix (init and final xor 0xFFFFFFFF; a length of 0 gives 0). Bytes
// past a row's length are never read.
//
// What bounds it on an H100: bytes. Every byte is read once, so 1,024
// rows of ~16.4 KiB are ~16.8 MB, ~5 us at 3.35 TB/s. The TPU design
// (a GF(2) bit-matrix product per 512-byte chunk on the MXU, then an
// un-extend of the padding) existed because the TPU's vector unit is
// poor at table gathers; an SM does table lookups from shared memory,
// so slice-by-4 fits here instead. What the card spends beyond the
// bytes is instructions: 14 for every 4 bytes folded (a byte select, an
// address and a lookup a byte, two 3-way xors), and the latency of each
// row's first length, its tiles' staging and its joins, which the warps
// of an SM hide from one another only in part.
//
// Design. CRC-32C is linear over GF(2): with f(M) the register of M
// folded from 0 and Z^n the operator that appends n zero bytes,
// f(A || B) = Z^|B|(f(A)) ^ f(B). A team of TEAM warps owns a row:
//   * The row is padded at its end with 0-15 zero bytes so that it ends
//     on a 16-byte boundary (taken back off the register at the end by
//     Z^-pad), and cut into tiles of TILE = 32 * W bytes laid out from
//     that end: every tile but the first is full, and every tile and
//     every lane's piece of W bytes starts on a 16-byte boundary. Warp w
//     of the team takes the tiles w, w + TEAM, ... counted from the end
//     (one empty tile if it has none); lane l folds piece l of each.
//   * A warp stages its tiles in a ring of NSTAGE shared-memory buffers,
//     issued NSTAGE - 1 tiles ahead: each tile's aligned middle by one
//     bulk copy (cp.async.bulk, completed in bytes on the slot's
//     mbarrier). Rows start at any byte: the row's first 4-19 and last
//     0-15 bytes go by scalar loads, held in registers until the tile is
//     consumed, and the padding and the bytes before the row's start as
//     zeros. The CRC's initial 0xFFFFFFFF is xored into the row's first
//     4 bytes as they are stored (for rows under 4 bytes a final term
//     repairs the rest). Rows of any length stream through the ring.
//   * A lane reads its piece as V aligned 16-byte words (V odd, so a
//     warp's reads hit every bank group once) and folds its two halves
//     as two independent slice-by-4 chains from register 0, each carried
//     from the warp's tile to its next by the fixed operator
//     Z^(TEAM * TILE).
//   * At the row's end the halves are joined by Z^(W / 2), the lanes in a
//     tree whose level j applies Z^(W * 2^j) (warp shuffles), and the
//     team's warps in a tree of Z^(TILE * 2^j) through shared memory:
//     the other warps post their registers and move on (mbarriers full
//     and empty, two row parities), the first warp waits and writes the
//     CRC. No thread shifts by a variable amount.
//   * Every operator is applied by eight nibble-table lookups (16 words a
//     table: a warp's lookup touches distinct banks). The slice-by-4
//     tables (or their copies) and the operators are built on the host
//     (ops/crc32c.py) and copied in once a block: the copies by one bulk
//     copy, the rest by 16-byte cp.async copies.
// Two instantiations, chosen by the row count. Up to one row an SM
// (one call's row): a team of ONE_TEAM warps a row, pieces of ONE_WORDS
// words, reading the one copy of the slice-by-4 tables (their bank
// conflicts cost less than making copies). More rows (record-batch
// batches): teams of MANY_TEAM warps, up to MANY_TEAMS a block and one
// block an SM, pieces of MANY_WORDS words, reading the tables through
// copies laid out in the lanes' banks (64 KiB; see Lanes), so no lookup
// conflicts.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <mutex>

#include "crc_ops.cuh"

typedef long long i64;

#define SLICE_WORDS (4 * 256)         // slice-by-4 tables T0..T3
#define LANE_WORDS (16 * SLICE_WORDS)  // the same, 16 copies in lane banks (64 KiB)
#define MAX_DEVICES 64

// The two shapes (ops/crc32c.py builds their operators): a team of ONE_TEAM
// warps a row when there are no more rows than SMs, else teams of
// MANY_TEAM warps, up to MANY_TEAMS teams a block. A lane's piece of a
// tile is *_WORDS 16-byte words, an odd count, so a warp's 16-byte reads
// of its pieces hit every bank group once.
#define ONE_TEAM 8
#define ONE_WORDS 5
#define ONE_STAGES 2
#define MANY_TEAM 2
#define MANY_WORDS 9
#define MANY_STAGES 2
#define MANY_TEAMS 8

__host__ __device__ constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x >> 1); }

// a team's operators: Z^(TEAM * TILE) (the carry), Z^(W / 2) (a piece's
// two halves), Z^(W * 2^j) for the join across lanes (j < 5),
// Z^(TILE * 2^j) for the join across the team's warps, and Z^-z for
// z = 1..15 (the zeros that pad a row's end to 16 bytes, taken back)
template <int TEAM>
__host__ __device__ constexpr int op_words() {
    return (7 + log2i(TEAM) + 15) * OP_WORDS;
}

#define MAX_WARPS 16  // a block's warps: the shared registers and mbarriers are sized for it
static_assert(ONE_TEAM <= MAX_WARPS && MANY_TEAM * MANY_TEAMS <= MAX_WARPS, "too many warps a block");

// the tables (or their copies), the operators, the warps' registers (32
// words), the mbarriers (a warp's NSTAGE, 32 for the teams, one for the
// copies and one unused, for alignment), the warps' rings
template <int TEAM, int V, int NSTAGE, bool COPIES>
static int smem_bytes(int teams) {
    return 4 * ((COPIES ? LANE_WORDS : SLICE_WORDS) + op_words<TEAM>() + 32) +
           8 * (MAX_WARPS * NSTAGE + 34) + teams * TEAM * NSTAGE * (32 * 16 * V);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// a tile's aligned middle: one bulk copy, its completion counted in bytes
// on an mbarrier that the warp then waits on
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                 ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT;\n"
        "}\n" ::"r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// Where a lane finds the slice-by-4 tables. With COPIES (built on the
// host, ops/crc32c.py lane_copies), the tables of the bytes 2q and 2q + 1
// share rows of 32 words: row q * 256 + i holds entry i of byte 2q's
// table 16 times (banks 0-15), then byte 2q + 1's (banks 16-31). Lane l
// reads word l of a row in slot 0 and word l ^ 16 in slot 1, so each lane
// keeps to its own bank in both, and it picks the byte whose table that
// word holds: no lookup of a warp conflicts, and the copies take 64 KiB.
// Without, the one copy (entry i of table k at k * 1 KiB + i * 4).
struct Lanes {
    const char* base[2];  // the lane's word of row 0, slots 0 and 1
    uint32_t sel[2];      // PRMT selectors of the bytes read in slots 0 and 1 (pair 0)
};

// register c folded over the 4 bytes w, slice-by-4
template <bool COPIES>
__device__ __forceinline__ uint32_t slice4(const Lanes& t, uint32_t c, uint32_t w) {
    c ^= w;
    if (COPIES) {
        auto look = [&](int q, int s) {
            return *reinterpret_cast<const uint32_t*>(t.base[s] + q * 256 * 128 +
                                                      (__byte_perm(c, 0, t.sel[s] + 2 * q) << 7));
        };
        return look(0, 0) ^ look(0, 1) ^ look(1, 0) ^ look(1, 1);
    }
    auto look = [&](int k, uint32_t i) { return *reinterpret_cast<const uint32_t*>(t.base[0] + k * 1024 + (i << 2)); };
    return look(3, __byte_perm(c, 0, 0x4440)) ^ look(2, __byte_perm(c, 0, 0x4441)) ^
           look(1, __byte_perm(c, 0, 0x4442)) ^ look(0, __byte_perm(c, 0, 0x4443));
}

// One tile of a warp, and the scalar bytes this thread loaded for it.
// The bytes stay untouched in registers until the tile is consumed, so
// their loads are in flight with the tile's bulk copy. Row
// positions are 32-bit: the host takes no row longer than 2^31 - 1.
struct Tile {
    int row;      // >= b_n: no tile
    int len;      // the row's length (clamped to [0, stride])
    int d;        // tiles between this one and the row's end
    int at;       // bit 0: the warp's first tile of the row; bit 1: its last
    uint32_t hb;  // this thread's head byte, if fl & 1
    uint32_t tb;  // this thread's tail byte, if fl & 2
    uint32_t fl;
};

// Row geometry: the row is padded at its end with pad (0-15) zero bytes
// so that it ends on a 16-byte boundary; tiles and pieces are laid out
// from that end, so each starts on one too. Row position x of the tile
// sits at buf + (x - s).
__device__ __forceinline__ int end_pad(const uint8_t* p, int len) {
    return (int)((16u - (((uintptr_t)p + (uint32_t)len) & 15u)) & 15u);
}

template <int TILE>
struct Geo {
    int s, e;  // the tile's row positions [s, e); s < 0 for a short first tile
    int hd;    // [0, hd): the scalar head (holds the first 4 bytes)
    int tl;    // [tl, len): the scalar tail; [hd, tl) whole 16-byte words
    __device__ __forceinline__ Geo(const uint8_t* p, const Tile& t) {
        const int pa = (int)((uintptr_t)p & 15u);
        e = t.len + end_pad(p, t.len) - t.d * TILE;
        s = e - TILE;
        hd = min(t.len, ((pa + 19) & ~15) - pa);
        tl = max(((pa + t.len) & ~15) - pa, hd);
    }
};

template <int TEAM, int V, int NSTAGE, bool COPIES>
__global__ void __launch_bounds__(TEAM == ONE_TEAM ? 32 * ONE_TEAM : 32 * MANY_TEAM * MANY_TEAMS)
crc32c_kernel(const uint8_t* __restrict__ data, const void* __restrict__ lens, int lens32, i64 add,
              const uint32_t* __restrict__ tables, const uint32_t* __restrict__ ops,
              i64* __restrict__ out, i64 b_n, i64 stride) {
    constexpr int W = 16 * V;     // bytes a lane folds per tile
    constexpr int TILE = 32 * W;  // a warp's tile, and its ring buffer
    extern __shared__ __align__(16) uint8_t smem[];
    uint32_t* tab = reinterpret_cast<uint32_t*>(smem);  // the tables, or their copies (COPIES)
    uint32_t* opt = tab + (COPIES ? LANE_WORDS : SLICE_WORDS);  // the team's operators
    uint32_t* part = opt + op_words<TEAM>();              // the warps' registers, by row parity
    uint64_t* bars = reinterpret_cast<uint64_t*>(part + 32);  // a warp's NSTAGE mbarriers
    uint64_t* team_bars = bars + MAX_WARPS * NSTAGE;          // a team's full[2], empty[2]
    const uint32_t copies_bar = smem_addr(team_bars + 32);
    uint8_t* bufs = reinterpret_cast<uint8_t*>(team_bars + 34);
    const uint32_t* op_carry = opt;
    const uint32_t* op_half = opt + OP_WORDS;
    const uint32_t* op_lane = opt + 2 * OP_WORDS;
    const uint32_t* op_warp = opt + 7 * OP_WORDS;
    const uint32_t* op_unpad = op_warp + log2i(TEAM) * OP_WORDS;  // Z^-1 .. Z^-15

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int teams = blockDim.x / (32 * TEAM), team = warp / TEAM, member = warp % TEAM;
    const int step = gridDim.x * teams;
    // a row's length as loaded, then clamped where it is used, so the
    // next row's load is in flight for a whole row
    auto load_len = [&](int row) -> i64 {
        if (row >= b_n) return -add;
        return lens32 ? (i64) reinterpret_cast<const int32_t*>(lens)[row] : reinterpret_cast<const i64*>(lens)[row];
    };
    auto clamp_len = [&](i64 n) -> int {
        n += add;
        return (int)(n < 0 ? 0 : (n > stride ? stride : n));
    };
    // the first rows' lengths are requested before the tables, which would
    // queue ahead of them
    int row = blockIdx.x * teams + team;
    const i64 first_len = load_len(row);
    i64 next_len = load_len(row + step);

    // -- the tables, in flight with the first tiles: the copies (COPIES,
    //    built on the host) by one bulk copy, else the tables and the
    //    operators by 16-byte copies
    if (COPIES && threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(copies_bar));
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        bulk_copy(smem_addr(tab), tables, 4 * LANE_WORDS, copies_bar);
    }
    if (!COPIES)
        for (int i = threadIdx.x; i < SLICE_WORDS / 4; i += blockDim.x) cp_async16(tab + 4 * i, tables + 4 * i);
    for (int i = threadIdx.x; i < op_words<TEAM>() / 4; i += blockDim.x) cp_async16(opt + 4 * i, ops + 4 * i);
    cp_commit();

    const Lanes lt{{reinterpret_cast<const char*>(tab + (COPIES ? lane : 0)),
                    reinterpret_cast<const char*>(tab + (lane ^ 16))},
                   {0x4440u + (lane >> 4), 0x4440u + ((lane >> 4) ^ 1)}};
    uint8_t* ring = bufs + warp * NSTAGE * TILE;
    const uint32_t bar0 = smem_addr(bars + warp * NSTAGE);
    // a team's registers pass through part[16 * p + warp] for rows of parity
    // p: full[p] counts the other warps' writes, empty[p] the first warp's
    // read, so no warp but the first waits at a row's end
    const uint32_t full0 = smem_addr(team_bars + 4 * team), empty0 = full0 + 16;
    if (lane == 0) {
        for (int u = 0; u < NSTAGE; ++u) asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0 + 8 * u));
        if (member == 0 && TEAM > 1)
            for (int q = 0; q < 2; ++q) {
                asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(full0 + 8 * q), "r"(TEAM - 1));
                asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(empty0 + 8 * q));
            }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncwarp();
    uint32_t phases = 0;  // bit u: the parity slot u completes next
    // this warp's tiles of a row: d = member, member + TEAM, ... below the
    // row's tile count, taken from the row's start; one empty tile if none
    auto count = [&](int row, int len) {
        const int padded = row < b_n ? len + end_pad(data + row * stride, len) : 0;
        const int nt = padded == 0 ? 1 : (padded + TILE - 1) / TILE;
        return member < nt ? (nt - 1 - member) / TEAM + 1 : 1;
    };

    // the issue cursor: (row, i) over this team's rows
    int len = clamp_len(first_len);
    int i = 0, m = count(row, len);

    // stage the cursor's tile into ring buffer `slot`; returns its Tile
    auto issue = [&](int slot) -> Tile {
        Tile t{row < b_n ? row : (int)b_n, len, member + TEAM * (m - 1 - i), (i == 0) | (i == m - 1) << 1,
               0u, 0u, 0u};
        if (row < b_n) {
            const uint8_t* p = data + row * stride;
            const Geo<TILE> g(p, t);
            uint8_t* buf = ring + slot * TILE - g.s;  // buf[x]: row position x
            // the whole 16-byte words of [hd, tl) in [s, e)
            const int lo = max(g.s, g.hd), hi = min(g.e, g.tl);
            const int n_words = hi > lo ? (hi - lo) >> 4 : 0;
            if (lane == 0) {
                // the buffer's last reads (generic proxy) come before the copy
                asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
                if (n_words > 0)
                    bulk_copy(smem_addr(buf + lo), p + lo, 16 * n_words, bar0 + 8 * slot);
                else
                    bar_arrive(bar0 + 8 * slot);
            }
            const int xt = g.tl + lane;
            if (lane < g.hd && lane >= g.s && lane < g.e) {
                t.hb = p[lane];
                t.fl |= 1u;
            }
            if (xt < len && xt >= g.s && xt < g.e) {
                t.tb = p[xt];
                t.fl |= 2u;
            }
            if (++i == m) {
                row += step;
                len = clamp_len(next_len);
                m = count(row, len);
                i = 0;
                next_len = load_len(row + step);
            }
        } else if (lane == 0) {
            bar_arrive(bar0 + 8 * slot);
        }
        return t;
    };

    // consume tile t from ring buffer `slot`
    uint32_t r0 = 0, r1 = 0;  // the registers of the lane's half-pieces
    int rows = 0;  // rows this warp has finished
    auto consume = [&](const Tile& t, int slot) {
        bar_wait(bar0 + 8 * slot, (phases >> slot) & 1u);
        phases ^= 1u << slot;
        const Geo<TILE> g(data + t.row * stride, t);
        uint8_t* buf = ring + slot * TILE - g.s;  // buf[x]: row position x
        // the scalar bytes, the initial 0xFFFFFFFF on the first four, the
        // zeros of the end's padding, and zeros before the row's start
        // where the first piece reads them
        if (t.fl & 1u) buf[lane] = (uint8_t)(t.hb ^ (lane < 4 ? 0xFFu : 0u));
        if (t.fl & 2u) buf[g.tl + lane] = (uint8_t)t.tb;
        if (t.d == 0 && t.len + lane < g.e) buf[t.len + lane] = 0;
        if (g.s < 0 && g.e > 0)
            for (int x = lane - W; x < 0; x += 32)
                if (x >= g.s) buf[x] = 0;
        __syncwarp();

        // -- this lane's piece: V aligned 16-byte words, folded as two
        //    halves, each carried by its own register
        uint32_t f0 = 0, f1 = 0;
        if (g.s + (lane + 1) * W > 0) {
            const uint4* q = reinterpret_cast<const uint4*>(buf + g.s) + lane * V;
            uint32_t w[4 * V];
#pragma unroll
            for (int j = 0; j < V; ++j) {
                const uint4 c = q[j];
                w[4 * j] = c.x;
                w[4 * j + 1] = c.y;
                w[4 * j + 2] = c.z;
                w[4 * j + 3] = c.w;
            }
#pragma unroll
            for (int j = 0; j < 2 * V; ++j) {
                f0 = slice4<COPIES>(lt, f0, w[j]);
                f1 = slice4<COPIES>(lt, f1, w[2 * V + j]);
            }
        }
        if (t.at & 1) {
            r0 = f0;
            r1 = f1;
        } else {
            r0 = apply_op(op_carry, r0) ^ f0;
            r1 = apply_op(op_carry, r1) ^ f1;
        }
        __syncwarp();  // the buffer is refilled next

        // -- the warp's last tile of the row: join its lanes' registers, then
        //    the team's warps
        if (t.at & 2) {
            uint32_t v = apply_op(op_half, r0) ^ r1;
#pragma unroll
            for (int j = 0; j < 5; ++j) {
                const uint32_t o = __shfl_down_sync(0xFFFFFFFFu, v, 1 << j);
                v = apply_op(op_lane + j * OP_WORDS, v) ^ o;
            }
            if (TEAM > 1) {
                const int q = rows & 1;
                const uint32_t ph = (rows >> 1) & 1;
                uint32_t* slots = part + 16 * q + team * TEAM;
                ++rows;
                if (member != 0) {
                    bar_wait(empty0 + 8 * q, ph ^ 1u);
                    if (lane == 0) {
                        slots[member] = v;
                        bar_arrive(full0 + 8 * q);
                    }
                } else {
                    bar_wait(full0 + 8 * q, ph);
                    v = lane > 0 && lane < TEAM ? slots[lane] : v;
                    __syncwarp();
                    if (lane == 0) bar_arrive(empty0 + 8 * q);
#pragma unroll
                    for (int j = 0; j < log2i(TEAM); ++j) {
                        const uint32_t o = __shfl_down_sync(0xFFFFFFFFu, v, 1 << j);
                        v ^= apply_op(op_warp + j * OP_WORDS, o);
                    }
                }
            }
            if (member == 0 && lane == 0) {
                const int pad = end_pad(data + t.row * stride, t.len);
                if (pad) v = apply_op(op_unpad + (pad - 1) * OP_WORDS, v);
                if (t.len < 4) v ^= 0xFFFFFFFFu >> (8 * t.len);
                out[t.row] = (i64)(v ^ 0xFFFFFFFFu);
            }
        }
    };

    // the ring: slot u holds pend[u]. The loop is unrolled by NSTAGE so
    // every slot index is a constant and no Tile is copied while its
    // scalar loads are in flight.
    Tile pend[NSTAGE];
#pragma unroll
    for (int u = 0; u < NSTAGE - 1; ++u) pend[u] = issue(u);
    cp_wait<0>();  // the tables and operators
    __syncthreads();
    if (COPIES) bar_wait(copies_bar, 0);
    for (bool more = true; more;) {
#pragma unroll
        for (int u = 0; u < NSTAGE; ++u) {
            more = more && pend[u].row < b_n;
            if (more) {
                pend[(u + NSTAGE - 1) % NSTAGE] = issue((u + NSTAGE - 1) % NSTAGE);
                consume(pend[u], u);
            }
        }
    }
}

// no work: the launch floor at the CRC's launch shape
__global__ void empty_kernel() {}

// Per device, once: its SM count, and the dynamic shared memory both
// instantiations (and the empty kernel beside them) may opt in to.
static cudaError_t crc_device(int dev, int* sms) {
    static std::mutex mu;
    static int dev_sms[MAX_DEVICES];  // 0 until the device is set up
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(mu);
    if (dev_sms[dev] == 0) {
        const int many = smem_bytes<MANY_TEAM, MANY_WORDS, MANY_STAGES, true>(MANY_TEAMS);
        int count = 0;
        cudaError_t e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(crc32c_kernel<ONE_TEAM, ONE_WORDS, ONE_STAGES, false>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     smem_bytes<ONE_TEAM, ONE_WORDS, ONE_STAGES, false>(1));
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(crc32c_kernel<MANY_TEAM, MANY_WORDS, MANY_STAGES, true>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, many);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, many);
        if (e != cudaSuccess) return e;
        dev_sms[dev] = count;
    }
    *sms = dev_sms[dev];
    return cudaSuccess;
}

struct Launch {
    bool one;
    unsigned grid, threads;
    int smem;
};

static cudaError_t plan(i64 b_n, Launch* l) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = crc_device(dev, &sms);
    if (e != cudaSuccess) return e;
    if (b_n <= sms) {
        *l = {true, (unsigned)b_n, 32 * ONE_TEAM, smem_bytes<ONE_TEAM, ONE_WORDS, ONE_STAGES, false>(1)};
    } else {
        // enough teams a block that one block an SM covers the rows, each
        // block's tables serving up to MANY_TEAMS teams' rows
        i64 teams = (b_n + sms - 1) / sms;
        teams = teams > MANY_TEAMS ? MANY_TEAMS : teams;
        const i64 blocks = (b_n + teams - 1) / teams;
        *l = {false, (unsigned)(blocks < sms ? blocks : sms), (unsigned)(32 * MANY_TEAM * teams),
              smem_bytes<MANY_TEAM, MANY_WORDS, MANY_STAGES, true>((int)teams)};
    }
    return cudaSuccess;
}

extern "C" {

const char* rp_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// consts (ops/crc32c.py _consts): the slice-by-4 tables, their copies
// (see Lanes), ONE's operators, MANY's. lens: int64, or int32 when
// lens32 != 0; each row's length is lens[i] + add, clamped to [0, stride].
int rp_crc32c(const uint8_t* data, const void* lens, const uint32_t* consts, i64* out, i64 b_n,
              i64 stride, i64 lens32, i64 add, void* stream) {
    if (b_n <= 0) return 0;
    if (b_n > INT_MAX || stride > INT_MAX) return (int)cudaErrorInvalidValue;
    Launch l;
    cudaError_t e = plan(b_n, &l);
    if (e != cudaSuccess) return (int)e;
    cudaStream_t s = (cudaStream_t)stream;
    const uint32_t* copies = consts + SLICE_WORDS;
    const uint32_t* one_ops = copies + LANE_WORDS;
    const uint32_t* many_ops = one_ops + op_words<ONE_TEAM>();
    if (l.one)
        crc32c_kernel<ONE_TEAM, ONE_WORDS, ONE_STAGES, false><<<l.grid, l.threads, l.smem, s>>>(
            data, lens, (int)lens32, add, consts, one_ops, out, b_n, stride);
    else
        crc32c_kernel<MANY_TEAM, MANY_WORDS, MANY_STAGES, true><<<l.grid, l.threads, l.smem, s>>>(
            data, lens, (int)lens32, add, copies, many_ops, out, b_n, stride);
    return (int)cudaGetLastError();
}

// an empty kernel with rp_crc32c's grid, block and shared memory for b_n rows
int rp_crc32c_empty(i64 b_n, void* stream) {
    Launch l;
    cudaError_t e = plan(b_n, &l);
    if (e != cudaSuccess) return (int)e;
    empty_kernel<<<l.grid, l.threads, l.smem, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

}  // extern "C"
