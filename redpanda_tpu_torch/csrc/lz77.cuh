// Device code shared by the LZ4 / snappy kernels of csrc/codec.cu and the
// fused CRC + codec kernels of csrc/fused.cu: the parse grid's constants,
// the block scan, the two codecs' byte rules (Lz4 / Snappy put_head, the
// one place they live) and the staging helpers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

typedef long long i64;

#define CELL 16
#define TAIL_GUARD 12
#define NO_CAND 0xFFFFu
#define MAX_N 65536
#define MAX_CELLS (MAX_N / CELL)
#define MAX_OUT 131072  // block bytes a row may take (the packed starts have 17 bits)
// Deferred head parts: an LZ4 255-run of more than 4 bytes encodes a
// literal run or a match of >= 1,035 bytes, a snappy run of more than four
// copies a match of > 256 bytes; literal runs and matches are disjoint
// parts of <= 65,536 bytes, so a row defers at most 255 parts.
#define DEFER_CAP 256
#define FULL 0xFFFFFFFFu

struct OpMin { __device__ int operator()(int a, int b) const { return a < b ? a : b; } };
struct OpMax { __device__ int operator()(int a, int b) const { return a > b ? a : b; } };
struct OpAdd { __device__ int operator()(int a, int b) const { return a + b; } };

// Exclusive scan of one value per thread over the block, in thread order
// (prefix) or in reverse thread order (suffix). `sh` holds 32 ints; with
// REUSE the scan ends in a barrier so the next scan may write `sh` at once.
template <bool SUFFIX, class Op, bool REUSE = true>
__device__ int block_scan_excl(int x, Op op, int identity, int* sh) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    int inc = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        int y = SUFFIX ? __shfl_down_sync(FULL, inc, o) : __shfl_up_sync(FULL, inc, o);
        if (SUFFIX ? lane + o < 32 : lane >= o) inc = op(inc, y);
    }
    if (lane == (SUFFIX ? 0 : 31)) sh[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        int w = lane < nw ? sh[lane] : identity;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            int y = SUFFIX ? __shfl_down_sync(FULL, w, o) : __shfl_up_sync(FULL, w, o);
            if (SUFFIX ? lane + o < 32 : lane >= o) w = op(w, y);
        }
        int we = SUFFIX ? __shfl_down_sync(FULL, w, 1) : __shfl_up_sync(FULL, w, 1);
        if (lane == (SUFFIX ? 31 : 0)) we = identity;
        if (lane < nw) sh[lane] = we;
    }
    __syncthreads();
    const int warp_excl = sh[warp];
    int te = SUFFIX ? __shfl_down_sync(FULL, inc, 1) : __shfl_up_sync(FULL, inc, 1);
    if (lane == (SUFFIX ? 31 : 0)) te = identity;
    if (REUSE) __syncthreads();  // sh is reused by the next scan
    return op(warp_excl, te);
}

// ------------------------------------------------------- the byte rules
// The byte rules of the two codecs. A sequence is (its head bytes, its
// literals, its tail bytes); `put_head` writes every byte but the literals,
// straight-line, except a long regular part (an LZ4 255-run, a run of
// snappy copies) longer than SELF_PART bytes, which it hands to `defer` as
// (position, length, a, b): `part_byte(a, b, i)` is byte i of that part,
// and the block writes such parts in parallel. `lit_head` says where a
// run's literals start (the final run's too). mlen < 0 marks the final run.
__device__ __forceinline__ void put(uint8_t* o, int p, int v, int m) {
    if (p < m) o[p] = (uint8_t)v;
}

struct Lz4 {
    static constexpr int SELF_PART = 4;  // 255-run bytes a sequence writes itself
    // the most bytes the sequences of `cells` cells and the final run take
    // for an n-byte row: a sequence is 3 + its literals + its match's and
    // its literals' 255-runs (<= len / 255 + 1 each); literals and matches
    // are disjoint parts of the row
    static __host__ __device__ constexpr int range_bound(int n, int cells) { return n + n / 255 + 5 * cells + 2; }
    static __device__ int n_extra(int len) { return len >= 15 ? (len - 15) / 255 + 1 : 0; }
    static __device__ int size(bool has, int lit, int mlen) {
        return has ? 1 + n_extra(lit) + lit + 2 + n_extra(mlen - 4) : 0;
    }
    static __device__ int final_size(int f_lit) { return 1 + n_extra(f_lit) + f_lit; }
    static __device__ int lit_head(int lit) { return 1 + n_extra(lit); }
    // byte i of the 255-run of len - 15: 255, ..., the remainder
    static __device__ int part_byte(int x, int, int i) {
        const int r = x - 255 * i;
        return r < 0 ? 0 : (r > 255 ? 255 : r);
    }
    template <class Defer>
    static __device__ void run(uint8_t* o, int p, int len, int m, Defer defer) {
        const int ne = n_extra(len);
        if (ne > SELF_PART) {
            defer(p, ne, len - 15, 0);
        } else {
            for (int i = 0; i < ne; ++i) put(o, p + i, part_byte(len - 15, 0, i), m);
        }
    }
    // the token, the literal length's 255-run, [the literals,] the offset
    // (little-endian) and the match length's 255-run
    template <class Defer>
    static __device__ void put_head(uint8_t* o, int st, int lit, int mlen, int offs, int m,
                                    Defer defer) {
        const int ml = mlen - 4 < 0 ? 0 : (mlen - 4 > 15 ? 15 : mlen - 4);
        put(o, st, ((lit < 15 ? lit : 15) << 4) | ml, m);
        run(o, st + 1, lit, m, defer);
        if (mlen < 0) return;
        const int a = st + lit_head(lit) + lit;
        put(o, a, offs & 255, m);
        put(o, a + 1, (offs >> 8) & 255, m);
        run(o, a + 2, mlen - 4, m, defer);
    }
};

struct Snappy {
    static constexpr int SELF_PART = 12;  // copy bytes a sequence writes itself (four copies)
    // the most bytes the sequences of `cells` cells and the final run take
    // for an n-byte row: a sequence is its literal tag (<= 3 bytes, none
    // without literals), its literals and 3 ceil(mlen / 64) bytes of
    // copies, which is <= mlen since a match is >= 4 bytes; literals and
    // matches are disjoint parts of the row, a cell starts at most one
    // sequence and the final run adds one more tag
    static __host__ __device__ constexpr int range_bound(int n, int cells) { return n + 3 * cells + 3; }
    static __device__ int lit_extra(int len) { return len <= 60 ? 0 : (len <= 256 ? 1 : 2); }
    static __device__ int lit_size(int lit) { return lit > 0 ? 1 + lit_extra(lit) + lit : 0; }
    static __device__ int size(bool has, int lit, int mlen) {
        return has ? lit_size(lit) + 3 * ((mlen + 63) / 64) : 0;
    }
    static __device__ int final_size(int f_lit) { return lit_size(f_lit); }
    static __device__ int lit_head(int lit) { return 1 + lit_extra(lit); }
    // byte i of the copies of a match: ceil(mlen / 64) copies of at most 64
    // bytes at one offset, each a tag (2 | (len - 1) << 2) and the offset
    static __device__ int part_byte(int mlen, int offs, int i) {
        const int ci = i / 3, role = i - 3 * ci;
        int clen = mlen - 64 * ci;
        clen = clen < 1 ? 1 : (clen > 64 ? 64 : clen);
        return role == 0 ? 2 | ((clen - 1) << 2) : (role == 1 ? offs & 255 : (offs >> 8) & 255);
    }
    // the literal tag ((len - 1) << 2, or 60 << 2 / 61 << 2 and one or two
    // little-endian bytes of len - 1), [the literals,] the copies
    template <class Defer>
    static __device__ void put_head(uint8_t* o, int st, int lit, int mlen, int offs, int m,
                                    Defer defer) {
        int p = st;
        if (lit > 0) {
            const int ex = lit_extra(lit);
            put(o, p, ex == 0 ? (lit - 1) << 2 : (ex == 1 ? 60 << 2 : 61 << 2), m);
            if (ex >= 1) put(o, p + 1, (lit - 1) & 255, m);
            if (ex == 2) put(o, p + 2, ((lit - 1) >> 8) & 255, m);
            p += 1 + ex + lit;
        }
        if (mlen < 0) return;
        const int nb = 3 * ((mlen + 63) / 64);
        if (nb > SELF_PART) {
            defer(p, nb, mlen, offs);
        } else {
            for (int i = 0; i < nb; ++i) put(o, p + i, part_byte(mlen, offs, i), m);
        }
    }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
}

// the four row bytes [x, x + 4) of the staged row, one funnel shift of
// the two aligned words that hold them
__device__ __forceinline__ uint32_t row_word(const uint8_t* row_s, int x) {
    const uintptr_t a = (uintptr_t)(row_s + x);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3);
    return __funnelshift_r(w[0], w[1], (int)(a & 3) * 8);
}
