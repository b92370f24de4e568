// Device zstd entropy stage: huff0 literals encode and decode.
//
// Replaces, from the JAX package:
//   rp_zstd_lengths  redpanda_tpu/ops/zstd.py:190 _encode_chunks (histogram,
//                    _kraft_nbits :72, _huff_codes :124)
//   rp_zstd_emit     redpanda_tpu/ops/zstd.py:190 _encode_chunks (the four
//                    reversed bitstreams of _encode_one :147)
//   rp_zstd_decode   redpanda_tpu/ops/zstd.py:274 _decode_streams (_decode_one
//                    :244)
// and with csrc/crc32c.cu the fused program of redpanda_tpu/ops/fused.py:89.
//
// Encode rows hold their chunk at columns [offset, offset + n) of a
// [B, stride] uint8 matrix, zero past the valid length v <= n <= 65536; the
// fused path passes the uploaded [40-byte CRC prefix | body] rows with
// offset 40, so the body is read in place.
//
// zstd_lengths — one block of 256 threads per row (thread = symbol). Bound by
// bytes: each row's valid bytes are read once (16-byte loads after a scalar
// head up to alignment) into one shared histogram per warp, so a skewed row
// does not pile every atomicAdd onto one bin. Warp 0 then runs the JAX
// program's two Kraft repair loops with each lane holding 8 symbols: each
// step reduces sum(u) and the arg-min (down loop: smallest count, first
// index) or arg-max (up loop: largest u, first index) over the warp with
// composite keys (count * 256 + symbol, u * 256 + 255 - symbol), so ties go
// to the first index exactly as jnp.argmin / argmax do. The loops run a few
// hundred steps at most on real rows; one warp is enough. Each thread then
// computes its symbol's canonical code: base from the per-length counts,
// rank = the number of lower symbols of the same length.
//
// zstd_emit — one block of 512 threads per (row, stream). Bound by bytes:
// the stream's symbols are read once into shared memory, the whole SB-byte
// stream (zeros past the marker included) written once. Each thread takes a
// contiguous run of symbols; a block scan of their code lengths gives every
// symbol's bit position, and each code is OR-ed (atomicOr on 32-bit words;
// a code of <= 11 bits spans at most two) into a shared-memory image of the
// stream. The JAX program's per-output-bit searchsorted becomes one
// placement per symbol; the bits are the same.
//
// zstd_decode — latency-bound: a huff0 stream is one dependent chain
// (each symbol's position depends on every earlier code length), 16,384
// symbols long at a 64 KiB block, so the time is the chain's step times
// its length. What the design does about it:
//   * one table per zstd block: the wrapper stages each distinct table once
//     ([T, 2048]) and hands the kernel groups of up to four streams that
//     share one table (the four streams of a block), so the tables are
//     read and held once, not once per stream;
//   * one wave of whole warps: a block is one warp, 8 groups of 4 threads,
//     one stream per thread; its 8 tables (nb[2048] | sym[2048] bytes,
//     4 KiB each, 2048-byte aligned in the shared window) are built by all
//     its threads; at one 128 MiB segment (1,846 blocks of 4 streams) all
//     231 warps are resident at once. Two streams per thread, interleaved,
//     were no faster on an H100 (equal times at one batch's four streams
//     and at a 128 MiB segment): the step is bound by its instruction
//     issue as much as by its latency, and a second chain doubles the one
//     and does not hide the other;
//   * a short step with no branch and no predicate: each stream holds a
//     64-bit window of two 32-bit words (hi:lo), the next two words below
//     (n1, n2) and a shift u in [0, 31]. A symbol is one shared-memory byte
//     load at (window & 2047) | table (nb; sym beside it, off the chain),
//     one subtraction, two funnel shifts and a bitwise select on the sign
//     of u - nb, which says whether the window steps down one word; the
//     register words move by the same select;
//   * no load in the step waits on device memory: the words below n2 wait
//     in a 32-word ring per stream in shared memory, filled ~1,000 bits
//     ahead by cp.async copies of 8-byte chunks after every 8 symbols; the
//     step reads the ring word that may enter the registers (k - 3) before
//     it knows whether it will, so it never waits on a register loaded
//     from global memory (which a warp's select would, on every step);
//   * the K checks leave the step: a stream runs max(K, 1) steps, 8 at a
//     time with the symbols packed by byte permutes into one 8-byte store,
//     then its remainder.
// Positions are not clamped at 0 during the walk: every window at or below
// bit 0 reads zero (the ring holds zeros below word 0), so an unclamped
// position emits what the clamped one does, and `end` is clamped once.
// Semantics kept exactly: bits below 0 read as zero, a stream that runs out
// sticks at bit 0 and keeps emitting sym[peek(0)], end = the position
// after min(regen, rmax) symbols, or f(tbits) when regen <= 0; the output
// is zero past K; no stream row is read past sbytes. The JAX program's
// pointer jumping (an int32 transition table over every bit position,
// squared log2(rmax) times) would need ~8.6 GB per table at one segment;
// the walk needs none.

#include <cuda_runtime.h>
#include <stdint.h>

typedef long long i64;

#define TABLELOG 11
#define TSIZE 2048
#define MAX_N 65536
#define MAX_STREAM_SYMS (MAX_N / 4 + 1)
#define MAX_STREAM_WORDS (((TABLELOG * MAX_STREAM_SYMS) / 8 + 2 + 3) / 4)
#define LEN_THREADS 256
#define LEN_WARPS (LEN_THREADS / 32)
#define EMIT_THREADS 512
#define DEC_THREADS 32                             // one warp per block, one stream per thread
#define DEC_SLOTS 4                                // streams per group (one table)
#define DEC_GROUPS (DEC_THREADS / DEC_SLOTS)       // groups (tables) per block
#define DEC_TAB (2 * TSIZE)                        // bytes of one table: nb | sym
#define DEC_TAB_ALIGN TSIZE                        // tables start 2048-byte aligned
#define DEC_RING 32                                // staged words per stream (a power of two)
#define DEC_AHEAD (DEC_RING + 1)                   // fill down to word k - DEC_AHEAD
#define DEC_WAIT_GROUPS 8                          // copy groups left in flight
#define DEC_SMEM (DEC_TAB_ALIGN + DEC_GROUPS * DEC_TAB + DEC_THREADS * DEC_RING * 4)
#define FULL 0xFFFFFFFFu

__host__ __device__ constexpr int stream_cap(int n) { return n / 4 + 1; }
__host__ __device__ constexpr int stream_bytes(int n) { return (TABLELOG * stream_cap(n)) / 8 + 2; }

__device__ __forceinline__ int floor_log2(int x) { return 31 - __clz(x); }

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
    return x;
}

// Exclusive prefix sum of one value per thread over the block, in thread
// order; *total receives the block's sum. `sh` holds 32 ints.
__device__ int block_scan_excl_sum(int x, int* sh, int* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    int inc = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        int y = __shfl_up_sync(FULL, inc, o);
        if (lane >= o) inc += y;
    }
    if (lane == 31) sh[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        int w = lane < nw ? sh[lane] : 0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            int y = __shfl_up_sync(FULL, w, o);
            if (lane >= o) w += y;
        }
        if (lane == 31) *total = w;
        int we = __shfl_up_sync(FULL, w, 1);
        if (lane == 0) we = 0;
        if (lane < nw) sh[lane] = we;
    }
    __syncthreads();
    return sh[warp] + inc - x;
}

__global__ void __launch_bounds__(LEN_THREADS)
zstd_lengths_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ valid,
                    uint8_t* __restrict__ nbits_out, int32_t* __restrict__ codes_out,
                    i64 stride, i64 offset, int n) {
    __shared__ int hist[LEN_WARPS][256];
    __shared__ int u_s[256];
    __shared__ int nb_s[256];
    __shared__ int rc[TABLELOG + 1];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const i64 row = blockIdx.x;
    const uint8_t* src = data + row * stride + offset;
    int v = valid[row];
    v = v < 0 ? 0 : (v > n ? n : v);

    for (int i = tid; i < LEN_WARPS * 256; i += LEN_THREADS) (&hist[0][0])[i] = 0;
    if (tid <= TABLELOG) rc[tid] = 0;
    __syncthreads();

    // -- histogram of [0, v)
    int* h = hist[warp];
    int head = (int)((16 - ((uintptr_t)src & 15)) & 15);
    if (head > v) head = v;
    for (int i = tid; i < head; i += LEN_THREADS) atomicAdd(&h[src[i]], 1);
    const int nvec = (v - head) >> 4;
    const uint4* vsrc = reinterpret_cast<const uint4*>(src + head);
    for (int i = tid; i < nvec; i += LEN_THREADS) {
        const uint4 x = vsrc[i];
        const uint32_t w4[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int b = 0; b < 4; ++b) atomicAdd(&h[(w4[k] >> (8 * b)) & 255], 1);
    }
    for (int i = head + 16 * nvec + tid; i < v; i += LEN_THREADS) atomicAdd(&h[src[i]], 1);
    __syncthreads();

    // -- seed: u = clip(2^floor_log2(q), 1, 1024), q = clip(ceil(c * 2048 / v), 1, 2048)
    int c = 0;
#pragma unroll
    for (int w = 0; w < LEN_WARPS; ++w) c += hist[w][tid];
    hist[0][tid] = c;  // counts, read back by warp 0 below
    {
        const i64 vv = v > 1 ? v : 1;
        i64 q = ((i64)c * TSIZE + vv - 1) / vv;
        q = q < 1 ? 1 : (q > TSIZE ? TSIZE : q);
        int u = 1 << floor_log2((int)q);
        u = u > 1024 ? 1024 : u;
        u_s[tid] = c > 0 ? u : 0;
    }
    __syncthreads();

    // -- Kraft repair (warp 0; lane holds symbols 8 * lane .. 8 * lane + 7)
    if (warp == 0) {
        int uu[8], cc[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            uu[k] = u_s[8 * lane + k];
            cc[k] = hist[0][8 * lane + k];
        }
        auto usum = [&]() {
            int s = 0;
#pragma unroll
            for (int k = 0; k < 8; ++k) s += uu[k];
            return warp_sum(s);
        };
        int sum = usum();
        while (sum > TSIZE) {  // halve the smallest count among present u >= 2
            unsigned best = FULL;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                const unsigned key = (unsigned)cc[k] * 256u + (unsigned)(8 * lane + k);
                if (cc[k] > 0 && uu[k] >= 2 && key < best) best = key;
            }
            best = __reduce_min_sync(FULL, best);
            if (best == FULL) break;
            const int s = (int)(best & 255u);
#pragma unroll
            for (int k = 0; k < 8; ++k)
                if (8 * lane + k == s) uu[k] >>= 1;
            sum = usum();
        }
        while (sum < TSIZE) {  // double the largest present u <= deficit, u < 1024
            const int d = TSIZE - sum;
            int best = -1;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                const int key = uu[k] * 256 + (255 - (8 * lane + k));
                if (cc[k] > 0 && uu[k] <= d && uu[k] < 1024 && key > best) best = key;
            }
            best = __reduce_max_sync(FULL, best);
            if (best < 0) break;
            const int s = 255 - (best & 255);
#pragma unroll
            for (int k = 0; k < 8; ++k)
                if (8 * lane + k == s) uu[k] <<= 1;
            sum = usum();
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) u_s[8 * lane + k] = uu[k];
    }
    __syncthreads();

    // -- lengths and canonical codes (thread = symbol)
    const int nb = c > 0 ? TABLELOG - floor_log2(u_s[tid] > 1 ? u_s[tid] : 1) : 0;
    nb_s[tid] = nb;
    if (nb > 0) atomicAdd(&rc[nb], 1);
    __syncthreads();
    int code = 0;
    if (nb > 0) {
        int base = 0;  // slots of every longer code: the b-bit region starts there
        for (int j = nb + 1; j <= TABLELOG; ++j) base += rc[j] << (TABLELOG - j);
        int rank = 0;
        for (int s = 0; s < tid; ++s) rank += nb_s[s] == nb;
        code = (base >> (TABLELOG - nb)) + rank;
    }
    nbits_out[row * 256 + tid] = (uint8_t)nb;
    codes_out[row * 256 + tid] = code;
}

__global__ void __launch_bounds__(EMIT_THREADS)
zstd_emit_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ valid,
                 const uint8_t* __restrict__ nbits, const int32_t* __restrict__ codes,
                 uint8_t* __restrict__ streams_out, int32_t* __restrict__ bits_out,
                 i64 stride, i64 offset, int n) {
    __shared__ uint32_t img[MAX_STREAM_WORDS];
    __shared__ uint8_t sym_s[MAX_STREAM_SYMS];
    __shared__ uint8_t nb_t[256];
    __shared__ uint32_t code_t[256];
    __shared__ int scan_sh[32];
    __shared__ int total_s;
    const int tid = threadIdx.x;
    const i64 row = blockIdx.x >> 2;
    const int st = blockIdx.x & 3;
    const int sb = stream_bytes(n), words = (sb + 3) / 4;
    int v = valid[row];
    v = v < 0 ? 0 : (v > n ? n : v);
    const int m4 = (v + 3) / 4;
    const int start = st * m4;
    const int slen = st < 3 ? m4 : (v - 3 * m4 > 0 ? v - 3 * m4 : 0);
    const uint8_t* src = data + row * stride + offset;

    for (int i = tid; i < 256; i += EMIT_THREADS) {
        const int nb = nbits[row * 256 + i];
        nb_t[i] = (uint8_t)nb;
        code_t[i] = (uint32_t)codes[row * 256 + i] & ((1u << nb) - 1u);
    }
    for (int i = tid; i < words; i += EMIT_THREADS) img[i] = 0;
    for (int i = tid; i < slen; i += EMIT_THREADS) {
        const int p = start + i;
        sym_s[i] = src[p < n ? p : n - 1];
    }
    __syncthreads();

    const int per = (slen + EMIT_THREADS - 1) / EMIT_THREADS;
    const int i0 = tid * per;
    const int i1 = i0 + per < slen ? i0 + per : slen;
    int local = 0;
    for (int i = i0; i < i1; ++i) local += nb_t[sym_s[i]];
    int c = block_scan_excl_sum(local, scan_sh, &total_s);
    __syncthreads();
    const int tb = total_s;
    // symbol i occupies bits [tb - csum[i], tb - csum[i] + nb[i]), csum inclusive
    for (int i = i0; i < i1; ++i) {
        const int s = sym_s[i];
        const int nb = nb_t[s];
        c += nb;
        if (nb) {
            const int bp = tb - c;
            const uint32_t code = code_t[s];
            const int w = bp >> 5, off = bp & 31;
            atomicOr(&img[w], code << off);
            if (off + nb > 32) atomicOr(&img[w + 1], code >> (32 - off));
        }
    }
    __syncthreads();
    if (tid == 0) img[tb >> 5] |= 1u << (tb & 31);  // end marker
    __syncthreads();
    uint8_t* dst = streams_out + (row * 4 + st) * (i64)sb;
    const uint8_t* ib = reinterpret_cast<const uint8_t*>(img);
    for (int i = tid; i < sb; i += EMIT_THREADS) dst[i] = ib[i];
    if (tid == 0) bits_out[row * 4 + st] = tb;
}

__device__ __forceinline__ uint32_t stream_word(const uint32_t* w, int j, int nw) {
    return j >= 0 && j < nw ? __ldg(w + j) : 0u;
}

// global -> shared copy of 8 bytes that completes in the background
__device__ __forceinline__ void copy8_async(unsigned dst, const uint32_t* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ uint32_t lds_u8(unsigned addr) {
    uint32_t v;
    asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
    return v;
}

__device__ __forceinline__ uint32_t lds_u32(unsigned addr) {
    uint32_t v;
    asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
    return v;
}

// One huff0 stream's walk: window hi:lo over words k + 1 : k and the next
// two words below it in registers; bits [u, u + 11) of hi:lo are the 11
// bits just below the position p = 32 k + u + 11. The words below wait in
// a ring of DEC_RING words in shared memory, filled down to word
// k - DEC_AHEAD by background copies of 8-byte chunks (`fill` = the next
// chunk, counting down; chunks below word 0 are written as zeros).
struct Walk {
    const uint32_t* w;
    unsigned ring;  // shared address of the ring
    int k, u, fill;
    uint32_t lo, hi, n1, n2, x;
};

__device__ __forceinline__ void top_up(Walk& a) {
    // chunk c holds words 2c, 2c + 1; its ring slots last held words
    // 2c + DEC_RING.., at or above k - 1: read at an earlier step, and
    // consumed there, so the read has completed
    while (2 * a.fill >= a.k - DEC_AHEAD) {
        const unsigned slot = a.ring + 4 * ((2 * a.fill) & (DEC_RING - 1));
        if (a.fill >= 0) {
            copy8_async(slot, a.w + 2 * a.fill);
        } else {
            asm volatile("st.shared.v2.u32 [%0], {%1, %1};" ::"r"(slot), "r"(0) : "memory");
        }
        --a.fill;
    }
}

// One symbol: the table entry at the window, then the window moves down by
// nb bits. m = -1 when it steps down a word (u - nb < 0), else 0; every
// choice is a bitwise select on m, so the step has no branch and no
// predicate, and the word that may enter the registers (k - 3) is read
// from the ring before it is known to be needed.
__device__ __forceinline__ uint32_t step(Walk& a, unsigned tab) {
    const unsigned at = (a.x & (TSIZE - 1)) | tab;
    const int nb = (int)lds_u8(at);
    const uint32_t sym = lds_u8(at + TSIZE);
    const uint32_t next = lds_u32(a.ring + 4 * ((a.k - 3) & (DEC_RING - 1)));
    const int un = a.u - nb;  // in [-11, 31]
    const uint32_t m = (uint32_t)(un >> 31);
    const uint32_t xa = __funnelshift_r(a.lo, a.hi, un);
    const uint32_t xb = __funnelshift_r(a.n1, a.lo, un);  // shift = un + 32
    a.x = (xb & m) | (xa & ~m);
    a.hi = (a.lo & m) | (a.hi & ~m);
    a.lo = (a.n1 & m) | (a.lo & ~m);
    a.n1 = (a.n2 & m) | (a.n1 & ~m);
    a.n2 = (next & m) | (a.n2 & ~m);
    a.k += (int)m;
    a.u = un & 31;
    return sym;
}

__global__ void __launch_bounds__(DEC_THREADS)
zstd_decode_kernel(const uint8_t* __restrict__ bufs, const int32_t* __restrict__ tbits,
                   const int32_t* __restrict__ regen, const uint8_t* __restrict__ tsym,
                   const int32_t* __restrict__ tnb, const int32_t* __restrict__ groups,
                   uint8_t* __restrict__ out, int32_t* __restrict__ end_out, int g_n,
                   int sbytes, int rmax) {
    // DEC_TAB_ALIGN slack, [DEC_GROUPS][nb TSIZE | sym TSIZE] tables (the
    // first 2048-byte aligned in the shared window, so an entry's address
    // is a bitwise or), then one ring of DEC_RING words per thread
    extern __shared__ __align__(16) uint8_t smem_raw[];
    const unsigned raw = (unsigned)__cvta_generic_to_shared(smem_raw);
    const unsigned pad = ((raw + DEC_TAB_ALIGN - 1) & ~(unsigned)(DEC_TAB_ALIGN - 1)) - raw;
    uint8_t* tabs = smem_raw + pad;
    const int tid = threadIdx.x;
    const int g0 = blockIdx.x * DEC_GROUPS;
    const int ng = g_n - g0 < DEC_GROUPS ? g_n - g0 : DEC_GROUPS;
    // -- the block's tables, 4 entries per thread step (tnb rows are 16-byte aligned)
    for (int i = tid; i < ng * (TSIZE / 4); i += DEC_THREADS) {
        const int gl = i / (TSIZE / 4), e4 = i % (TSIZE / 4);
        const i64 t = groups[(i64)(g0 + gl) * (1 + DEC_SLOTS)];
        const int4 nb4 = __ldg(reinterpret_cast<const int4*>(tnb + t * TSIZE) + e4);
        const uint32_t s4 = __ldg(reinterpret_cast<const uint32_t*>(tsym + t * TSIZE) + e4);
        uint32_t* tab = reinterpret_cast<uint32_t*>(tabs + gl * DEC_TAB);
        tab[e4] = (uint32_t)nb4.x | (uint32_t)nb4.y << 8 | (uint32_t)nb4.z << 16 | (uint32_t)nb4.w << 24;
        tab[TSIZE / 4 + e4] = s4;
    }
    __syncthreads();
    const int gl = tid / DEC_SLOTS;
    if (gl >= ng) return;
    const int s = groups[(i64)(g0 + gl) * (1 + DEC_SLOTS) + 1 + tid % DEC_SLOTS];
    if (s < 0) return;  // an empty slot of its group
    const unsigned tab = raw + pad + gl * DEC_TAB;

    Walk a;
    const int nw = sbytes / 4;
    a.w = reinterpret_cast<const uint32_t*>(bufs + (i64)s * sbytes);
    a.ring = raw + pad + DEC_GROUPS * DEC_TAB + tid * DEC_RING * 4;
    const int rg = regen[s];
    const int K = rg < 0 ? 0 : (rg > rmax ? rmax : rg);
    const int steps = K > 1 ? K : 1;  // end = the position after max(K, 1) steps
    const int q = tbits[s] - TABLELOG;
    a.k = q >> 5;  // floor: -1 below bit 11
    a.u = q & 31;
    a.lo = stream_word(a.w, a.k, nw);
    a.hi = stream_word(a.w, a.k + 1, nw);
    a.n1 = stream_word(a.w, a.k - 1, nw);
    a.n2 = stream_word(a.w, a.k - 2, nw);
    a.x = __funnelshift_r(a.lo, a.hi, a.u);
    a.fill = (a.k - 3) >> 1;
    top_up(a);
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 0;" ::: "memory");  // the first 31 words below the window
    uint32_t* o = reinterpret_cast<uint32_t*>(out + (i64)s * rmax);

    const int full = steps >> 3;
    for (int j = 0; j < full; ++j) {
        // every ring word read in these 8 steps was requested at least
        // DEC_WAIT_GROUPS + 1 groups ago (8 steps use <= 3 words)
        asm volatile("cp.async.wait_group %0;" ::"n"(DEC_WAIT_GROUPS) : "memory");
        uint32_t lo4 = 0, hi4 = 0;
        lo4 = __byte_perm(lo4, step(a, tab), 0x3214);
        lo4 = __byte_perm(lo4, step(a, tab), 0x3240);
        lo4 = __byte_perm(lo4, step(a, tab), 0x3410);
        lo4 = __byte_perm(lo4, step(a, tab), 0x4210);
        hi4 = __byte_perm(hi4, step(a, tab), 0x3214);
        hi4 = __byte_perm(hi4, step(a, tab), 0x3240);
        hi4 = __byte_perm(hi4, step(a, tab), 0x3410);
        hi4 = __byte_perm(hi4, step(a, tab), 0x4210);
        reinterpret_cast<uint2*>(o)[j] = make_uint2(lo4, hi4);
        top_up(a);
        asm volatile("cp.async.commit_group;" ::: "memory");
    }
    const int tail = steps & 7;
    if (tail) {
        asm volatile("cp.async.wait_group 0;" ::: "memory");
        uint64_t acc = 0;
        for (int i = 0; i < tail; ++i) acc |= (uint64_t)step(a, tab) << (8 * i);
        reinterpret_cast<uint64_t*>(o)[full] = K ? acc : 0;  // regen <= 0 writes no symbol
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    for (int j = full + (tail ? 1 : 0); j < rmax / 8; ++j) reinterpret_cast<uint2*>(o)[j] = make_uint2(0, 0);
    const int p = 32 * a.k + a.u + TABLELOG;
    end_out[s] = p > 0 ? p : 0;
}

extern "C" {

const char* rp_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// codes: B*256 int32 scratch, read by rp_zstd_emit
int rp_zstd_lengths(const uint8_t* data, const int32_t* valid, uint8_t* nbits, int32_t* codes,
                    i64 b_n, i64 stride, i64 offset, i64 n, void* stream) {
    if (b_n <= 0) return 0;
    if (n < 4 || n > MAX_N || (n & (n - 1))) return (int)cudaErrorInvalidValue;
    zstd_lengths_kernel<<<(unsigned)b_n, LEN_THREADS, 0, (cudaStream_t)stream>>>(
        data, valid, nbits, codes, stride, offset, (int)n);
    return (int)cudaGetLastError();
}

int rp_zstd_emit(const uint8_t* data, const int32_t* valid, const uint8_t* nbits,
                 const int32_t* codes, uint8_t* streams, int32_t* bits, i64 b_n, i64 stride,
                 i64 offset, i64 n, void* stream) {
    if (b_n <= 0) return 0;
    if (n < 4 || n > MAX_N || (n & (n - 1))) return (int)cudaErrorInvalidValue;
    zstd_emit_kernel<<<(unsigned)(4 * b_n), EMIT_THREADS, 0, (cudaStream_t)stream>>>(
        data, valid, nbits, codes, streams, bits, stride, offset, (int)n);
    return (int)cudaGetLastError();
}

// bufs: S rows of sbytes (a multiple of 8, rows 8-byte aligned); out: S
// rows of rmax (a multiple of 8); tsym / tnb: T tables (tnb entries in
// [0, 11]); groups: G rows of (table, stream, stream, stream, stream), -1
// for an empty slot, every stream in exactly one group
int rp_zstd_decode(const uint8_t* bufs, const int32_t* tbits, const int32_t* regen,
                   const uint8_t* tsym, const int32_t* tnb, const int32_t* groups, uint8_t* out,
                   int32_t* end, i64 g_n, i64 sbytes, i64 rmax, void* stream) {
    if (g_n <= 0) return 0;
    if (sbytes < 8 || sbytes % 8 || rmax < 8 || rmax % 8) return (int)cudaErrorInvalidValue;
    const int smem = DEC_SMEM;
    cudaError_t e = cudaFuncSetAttribute(zstd_decode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const unsigned grid = (unsigned)((g_n + DEC_GROUPS - 1) / DEC_GROUPS);
    zstd_decode_kernel<<<grid, DEC_THREADS, smem, (cudaStream_t)stream>>>(
        bufs, tbits, regen, tsym, tnb, groups, out, end, (int)g_n, (int)sbytes, (int)rmax);
    return (int)cudaGetLastError();
}

}  // extern "C"
