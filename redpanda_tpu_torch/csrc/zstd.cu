// Device zstd entropy stage: huff0 literals encode and decode.
//
// Replaces, from the JAX package:
//   rp_zstd_encode   redpanda_tpu/ops/zstd.py:190 _encode_chunks (histogram,
//                    _kraft_nbits :72, _huff_codes :124, the four reversed
//                    bitstreams of _encode_one :147)
//   rp_zstd_decode   redpanda_tpu/ops/zstd.py:274 _decode_streams (_decode_one
//                    :244)
//   rp_fused_zstd    redpanda_tpu/ops/fused.py:89 _fused_zstd (the Kafka batch
//                    CRC over prefix || body, then _encode_chunks of the body):
//                    the encode kernel with its CRC stage (kCrc), one launch
//
// Encode rows hold their chunk at columns [offset, offset + n) of a
// [B, stride] uint8 matrix, zero past the valid length v <= n <= 65536; the
// fused path passes the uploaded [40-byte CRC prefix | body] rows with
// offset 40, so the body is read in place.
//
// zstd_encode — one launch, one cluster of four CTAs a row (grid 4B). Bound
// by bytes at many rows (each valid byte read once, every stream byte
// written once) and by its chain of dependent phases at one row, where the
// launch floor is half the time. CTA q owns stream q, the symbols
// [q m4, q m4 + slen_q) with m4 = ceil(v / 4): the four ranges partition
// [0, v) (the first three run a few bytes past v when v < 9), so the row is
// read once, by 16-byte cp.async copies into shared memory at the source's
// alignment (fused rows sit at column 40: 8- but not 16-byte aligned; the
// quarters start at any byte), scalar head and tail. Then:
//   * the histogram: one per warp over the warp's run of units (16 bytes
//     a lane a step), plain shared atomicAdds; warp-aggregated adds
//     (__match_any_sync) and four histograms a warp were both slower on
//     the skewed rows (PERF.md). A CTA's counts (<= 16,384 a symbol;
//     a row's reach 65,536, so they are summed in 32 bits) are pushed into
//     every CTA of the cluster over distributed shared memory (once every
//     CTA has arrived at a start barrier: a CTA's shared memory may be
//     written only once it runs) before the one full cluster barrier;
//     after it no CTA touches another's memory, so none waits for the
//     others to exit;
//   * the Kraft lengths, in every CTA alike, exact to _kraft_nbits: the
//     down loop (only when the seed overshoots, which no main-path row
//     does) in closed form by each candidate's weighted rank; the up loop in
//     one warp, one max a climb (kraft_up), no sum inside; then warp 0
//     builds the canonical codes, ranked by packed per-lane counts scanned
//     over the warp (no loop over the lower symbols), while the other warps
//     count their bits;
//   * the stream: each warp's bits are its histogram against the lengths,
//     so the warps' bases need no pass over the symbols; a lane packs each
//     4-byte word of its unit into one code of <= 44 bits, a warp scan of
//     the units' lengths places them, carried across the warp's steps, and
//     each is OR-ed (<= 3 words) into a shared image of the stream kept at
//     the stream row's alignment (the pitch SB is not a multiple of 16), so
//     all SB bytes, zeros past the marker included, leave in 16-byte stores
//     with scalar head and tail.
// The histograms, the inbox and the down loop's pairs live where the image
// will be, so a 64 KiB row's CTA holds 41 KB of shared memory and five fit
// an SM. The launch shape goes by row count: up to ENC_FEW_ROWS rows (a
// cluster's CTAs on SMs of their own; time is the row's chain) 512
// threads, so a one-call row's quarter takes one step of 16 bytes a lane;
// above, 256 threads (48 registers), five CTAs an SM. A refused launch
// returns its error.
//
// fused_zstd — the same kernel with kCrc set: the CRC rides on the encode's
// staging, so each row is read from device memory once and one launch floor
// is paid, where the sequence read it twice (csrc/crc32c.cu, then the
// encode). CRC-32C is linear over GF(2): appending L zero bytes to a
// register is a linear map Z^L (csrc/crc_ops.cuh). CTA q folds the raw CRC
// (register 0) of the bytes it counts, [start, start + hv), from its staged
// copy; CTA 0 also stages and folds the offset-byte prefix before its
// quarter, the CRC's initial 0xFFFFFFFF xored into the message's first 4
// bytes (the message is >= offset >= 4 bytes). The range is cut into
// 16-byte units counted from its end, thread t of the folding warps taking
// units [t K, t K + K) slice-by-4 from register 0, earliest first, so the
// bytes before the range (masked) fold into a zero register and count for
// nothing; K is fixed by (offset, n, THREADS) (crc_units, which the host
// reads through rp_fused_zstd_units), and the lanes and the warps are
// joined in trees of operators the host builds for that K
// (ops/fused.zstd_crc_consts), only the lanes whose result a later level
// reads computing each level. The CTA's part then moves to the message's
// end by Z^(v - start - hv), a length that depends on the row, built from
// its bits with the host's Z^(2^j) (j < 17), each held as its 32 columns
// and applied by one warp as a xor-reduction of the columns the register's
// bits select. Where it runs: after the one cluster barrier, the fold by
// every warp but warp 0 while warp 0 runs the Kraft loop, the join across
// warps and the shift by the last warp while warp 0 builds the codes (the
// encode's other warps wait at both); its constants (10.9 KB) arrive in a
// second cp.async group waited on only after the barrier, and at 256
// threads the registers are held to the standalone encode's 48 (five CTAs
// an SM). Folded before the barrier (pushed beside the histogram counts),
// the stage sat on the row's chain and on the histogram phase's
// shared-memory traffic (PERF.md). The three peers send their 4
// bytes to CTA 0 by st.async, counted off an mbarrier CTA 0 arms before
// the start arrival (the one wait on it is CTA 0's, at its end; no cluster
// barrier is added), and CTA 0 xors the four and stores the CRC.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "crc_ops.cuh"

typedef long long i64;

#define TABLELOG 11
#define TSIZE 2048
#define MAX_N 65536
#define ENC_CLUSTER 4                              // CTAs a row, one per stream
#define ENC_FEW_ROWS 33                            // up to here a launch is latency-bound: wide CTAs
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

namespace cg = cooperative_groups;

__host__ __device__ constexpr int stream_cap(int n) { return n / 4 + 1; }
__host__ __device__ constexpr int stream_bytes(int n) { return (TABLELOG * stream_cap(n)) / 8 + 2; }
__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// One encode CTA: THREADS threads (the Kraft and code phases take thread =
// symbol), a lane taking 16 bytes of symbols a step. Dynamic shared memory,
// in order: the image region, the staged quarter, then EncShared. The
// region holds, until the codes are built, the warps' histograms, the
// inbox of the four quarters' histograms (pushed by the cluster) and the
// down loop's (key, weight) pairs; then the stream image.
#define ENC_UNIT 16
#define ENC_INBOX (ENC_CLUSTER * 256 * 4)
#define ENC_PAIRS 2048
__host__ __device__ constexpr int enc_hist_bytes(int threads) { return threads / 32 * 1024; }

__host__ __device__ constexpr int enc_img_bytes(int threads, int n) {
    return round16(stream_bytes(n) + 15) > enc_hist_bytes(threads) + ENC_INBOX + ENC_PAIRS
               ? round16(stream_bytes(n) + 15)
               : enc_hist_bytes(threads) + ENC_INBOX + ENC_PAIRS;
}
__host__ __device__ constexpr int enc_sym_bytes(int n) { return round16(n / 4 + 16); }

struct EncShared {
    int u[256];               // slot counts
    uint32_t tab[256];        // code | nb << 16
    int wtot[32];             // bits of each warp's symbols
    int first[TABLELOG + 1];  // first code of each length
    int sum, down;            // the seed's sum; whether it overshoots
};

// The CRC stage (kCrc): its constants (ops/fused.zstd_crc_consts, staged
// after EncShared in this order) and its words. CTA 0's staged quarter has
// the prefix before it, so its symbol region grows by round16(offset).
#define CRC_SLICE_WORDS (4 * 256)  // slice-by-4 tables T0..T3
#define CRC_LANE_OPS 5             // Z^(16 K 2^j), j < 5: across a warp's lanes
#define CRC_WARP_OPS 4             // Z^(16 K 32 2^j), j < log2(folding warps) <= 4: across warps
#define CRC_POW2 17                // Z^(2^j), j < 17, as 32 columns: shifts below 2^17 (a row <= 65,536)
#define CRC_CONST_WORDS (CRC_SLICE_WORDS + (CRC_LANE_OPS + CRC_WARP_OPS) * OP_WORDS + CRC_POW2 * 32)
#define CRC_MAX_PREFIX 64          // the prefix a fused launch may stage before CTA 0's quarter

struct CrcShared {
    unsigned long long bar;        // (CTA 0) owed the three peers' parts
    uint32_t part[32];             // each folding warp's joined part
    uint32_t in[ENC_CLUSTER];      // (CTA 0) each CTA's part, shifted to the message's end
};

// the symbol region (with kCrc, room for CTA 0's prefix), then EncShared
__host__ __device__ constexpr int enc_sym_region(int n, bool crc, int offset) {
    return enc_sym_bytes(n) + (crc ? round16(offset) : 0);
}

// where the CRC's constants start (16-byte aligned, after EncShared)
__host__ __device__ constexpr int crc_consts_at(int threads, int n, int offset) {
    return round16(enc_img_bytes(threads, n) + enc_sym_region(n, true, offset) + (int)sizeof(EncShared));
}

__host__ __device__ constexpr int enc_smem_bytes(int threads, int n, bool crc = false, int offset = 0) {
    return crc ? crc_consts_at(threads, n, offset) + CRC_CONST_WORDS * 4 + (int)sizeof(CrcShared)
               : enc_img_bytes(threads, n) + enc_sym_bytes(n) + (int)sizeof(EncShared);
}

// the threads of a CTA that fold its CRC piece: warps 1 .. (warp 0 runs
// the Kraft loop meanwhile)
__host__ __device__ constexpr int crc_fold_threads(int threads) { return threads - 32; }

// K, the CRC's 16-byte units a folding thread: crc_fold_threads K units
// cover the longest range a CTA folds, CTA 0's offset + n / 4 bytes
__host__ __device__ constexpr int crc_units(int offset, int n, int threads) {
    return ((offset + n / 4 + 15) / 16 + crc_fold_threads(threads) - 1) / crc_fold_threads(threads);
}

__device__ __forceinline__ int floor_log2(int x) { return 31 - __clz(x); }

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// arrival that orders nothing: the CTA has started
__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

// register c folded over the 4 bytes w, slice-by-4 (entry i of table k at
// tab[256 k + i])
__device__ __forceinline__ uint32_t slice4(const uint32_t* tab, uint32_t c, uint32_t w) {
    c ^= w;
    return tab[768 + (c & 255u)] ^ tab[512 + ((c >> 8) & 255u)] ^ tab[256 + ((c >> 16) & 255u)] ^ tab[c >> 24];
}

// the four bytes at byte o of the dynamic shared memory: a funnel shift of
// the two aligned words that hold them
__device__ __forceinline__ uint32_t smem_word(const uint32_t* s32, int o) {
    return __funnelshift_r(s32[o >> 2], s32[(o >> 2) + 1], (o & 3) * 8);
}

// One CTA's CRC piece: the raw CRC (register 0) of shared bytes [lo, e),
// in 16-byte units counted from e, thread t folding units [t K, t K + K),
// earliest first; bytes before lo read as zero, so they fold into a zero
// register. With `init`, the CRC's initial 0xFFFFFFFF is xored into bytes
// lo .. lo + 3. Each warp's lanes are joined by Z^(16 K 2^j) in a tree
// whose level j only lanes that are multiples of 2^(j + 1) compute (the
// others' table reads would only add bank conflicts; warps without units
// skip it); lane 0 holds the warp's part.
__device__ __forceinline__ uint32_t crc_lanes(const uint32_t* s32, const uint32_t* tab, const uint32_t* lane_ops,
                                              int lo, int e, bool init, int k_units, int tid, int lane, int warp) {
    const int nu = (e - lo + 15) >> 4;
    uint32_t f = 0;
    for (int u = k_units - 1; u >= 0; --u) {
        const int un = tid * k_units + u;
        if (un >= nu) continue;
        const int x0 = e - 16 * (un + 1);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
            const int rel = x0 + 4 * w - lo;  // the word's first byte in the range
            if (rel <= -4) continue;           // wholly before it: the register is still zero
            uint32_t wd = smem_word(s32, x0 + 4 * w);
            if (rel < 0) wd &= ~0u << (-8 * rel);
            if (init && rel < 4) wd ^= rel >= 0 ? ~0u >> (8 * rel) : ~0u << (-8 * rel);
            f = slice4(tab, f, wd);
        }
    }
    if (32 * k_units * warp < nu)
#pragma unroll
        for (int j = 0; j < CRC_LANE_OPS; ++j) {
            const uint32_t up = __shfl_down_sync(FULL, f, 1 << j);
            if ((lane & ((2 << j) - 1)) == 0) f ^= apply_op(lane_ops + j * OP_WORDS, up);
        }
    return f;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// the same shared memory location in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
    return r;
}

// 4 bytes into a peer's shared memory, counted off the peer's mbarrier
__device__ __forceinline__ void st_async(uint32_t peer, uint32_t v, uint32_t peer_bar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, [%2];"
                 ::"r"(peer), "r"(v), "r"(peer_bar) : "memory");
}

// an mbarrier of one arrival, made by it owed `bytes`, visible to the
// cluster's async stores
__device__ __forceinline__ void bar_owe(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
        "@!p bra WAIT;\n"
        "}\n" ::"r"(bar) : "memory");
}

// Z^s(r) by one warp (r the same in every lane): for each set bit j of s,
// r becomes the xor of Z^(2^j)'s columns that r's bits select
__device__ __forceinline__ uint32_t crc_shift(const uint32_t* pow2_cols, uint32_t r, int s, int lane) {
#pragma unroll 1
    for (int j = 0; j < CRC_POW2; ++j)
        if (s >> j & 1) r = __reduce_xor_sync(FULL, (r >> lane & 1u) ? pow2_cols[32 * j + lane] : 0u);
    return r;
}

// The up loop, one warp (lane l holds symbols 8l .. 8l + 7): while the sum
// is under 2048, double the largest present u <= deficit with u < 1024, the
// first symbol on ties. A doubled symbol is the only candidate of its new
// level that can fit (any other would have been taken first), so it is
// taken again while it fits: one step takes the whole climb, k doublings
// from 2^l with 2^l (2^k - 1) <= deficit, up to 1024. A key (log2 u,
// 255 - symbol) per symbol finds the climber in one max (u <= deficit is
// log2 u <= floor_log2(deficit)); the deficit is carried, never re-summed.
// With `first`, an overshooting seed is flagged for the down loop instead.
__device__ void kraft_up(EncShared& sh, int lane, bool first) {
    const int4* u4 = reinterpret_cast<const int4*>(sh.u + 8 * lane);
    const int4 ua = u4[0], ub = u4[1];
    const int uu[8] = {ua.x, ua.y, ua.z, ua.w, ub.x, ub.y, ub.z, ub.w};
    int key[8], s8 = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        s8 += uu[k];
        // present and below 1024: a candidate; u is 0 exactly when absent
        key[k] = uu[k] > 0 && uu[k] < 1024 ? floor_log2(uu[k]) << 8 | (255 - (8 * lane + k)) : -1;
    }
    const int total = (int)__reduce_add_sync(FULL, (unsigned)s8);
    if (first) {
        if (lane == 0) {
            sh.sum = total;
            sh.down = total > TSIZE;
        }
        if (total > TSIZE) return;
    }
    int d = TSIZE - total;
    bool moved = false;
    while (d > 0) {
        const int lim = (floor_log2(d) + 1) << 8;  // keys of u <= d
        int best = -1;
#pragma unroll
        for (int k = 0; k < 8; ++k) best = max(best, key[k] < lim ? key[k] : -1);
        best = __reduce_max_sync(FULL, best);
        if (best < 0) break;
        const int lev = best >> 8;
        int k = floor_log2((d >> lev) + 1);
        k = lev + k > 10 ? 10 - lev : k;
        d -= ((1 << k) - 1) << lev;
#pragma unroll
        for (int j = 0; j < 8; ++j)
            if (key[j] == best) key[j] = lev + k < 10 ? best + (k << 8) : 0x7FFFFFFF;  // 1024: done
        moved = true;
    }
    if (moved) {
        int w[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) w[j] = key[j] == 0x7FFFFFFF ? 1024 : (key[j] < 0 ? uu[j] : 1 << (key[j] >> 8));
        int4* w4 = reinterpret_cast<int4*>(sh.u + 8 * lane);
        w4[0] = make_int4(w[0], w[1], w[2], w[3]);
        w4[1] = make_int4(w[4], w[5], w[6], w[7]);
    }
}

__device__ __forceinline__ int length_of(int u) { return u > 0 ? TABLELOG - floor_log2(u) : 0; }

// The canonical codes, one warp (lane l holds symbols 8l .. 8l + 7): each
// lane's counts of each length, packed 8 bits a length in three words (a
// lane's exclusive prefix is <= 248, so no field overflows), scanned over
// the warp; a symbol's code is the first code of its length (past the slots
// of every longer code) plus the lower symbols of its length.
__device__ void make_codes(EncShared& sh, int lane, uint8_t* nbits_row, int32_t* codes_row) {
    const int4* u4 = reinterpret_cast<const int4*>(sh.u + 8 * lane);
    const int4 ua = u4[0], ub = u4[1];
    const int nb[8] = {length_of(ua.x), length_of(ua.y), length_of(ua.z), length_of(ua.w),
                       length_of(ub.x), length_of(ub.y), length_of(ub.z), length_of(ub.w)};
    unsigned own[3] = {0, 0, 0}, ex[3];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const unsigned inc = 1u << (8 * (nb[k] & 3));
        own[0] += nb[k] >> 2 == 0 ? inc : 0u;
        own[1] += nb[k] >> 2 == 1 ? inc : 0u;
        own[2] += nb[k] >> 2 == 2 ? inc : 0u;
    }
#pragma unroll
    for (int w = 0; w < 3; ++w) ex[w] = own[w];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)
#pragma unroll
        for (int w = 0; w < 3; ++w) {
            const unsigned y = __shfl_up_sync(FULL, ex[w], o);
            if (lane >= o) ex[w] += y;
        }
#pragma unroll
    for (int w = 0; w < 3; ++w) ex[w] -= own[w];
    auto field = [](const unsigned* x, int b) { return (int)((x[b >> 2] >> (8 * (b & 3))) & 255u); };
    if (lane == 31) {
        // the totals (<= 256) summed unpacked; first[b] = the slots of every
        // longer code, in b-bit units
        int slots = 0;
#pragma unroll
        for (int b = TABLELOG; b >= 1; --b) {
            sh.first[b] = slots >> (TABLELOG - b);
            slots += (field(ex, b) + field(own, b)) << (TABLELOG - b);
        }
    }
    __syncwarp();
    uint32_t tab[8];
    int code[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        int r = 0;
#pragma unroll
        for (int j = 0; j < k; ++j) r += nb[j] == nb[k];
        code[k] = nb[k] > 0 ? sh.first[nb[k]] + field(ex, nb[k]) + r : 0;
        tab[k] = ((uint32_t)code[k] & ((1u << nb[k]) - 1u)) | (uint32_t)nb[k] << 16;
    }
    uint4* t4 = reinterpret_cast<uint4*>(sh.tab + 8 * lane);
    t4[0] = make_uint4(tab[0], tab[1], tab[2], tab[3]);
    t4[1] = make_uint4(tab[4], tab[5], tab[6], tab[7]);
    if (nbits_row != nullptr) {
        reinterpret_cast<uint2*>(nbits_row)[lane] = make_uint2(
            (uint32_t)nb[0] | (uint32_t)nb[1] << 8 | (uint32_t)nb[2] << 16 | (uint32_t)nb[3] << 24,
            (uint32_t)nb[4] | (uint32_t)nb[5] << 8 | (uint32_t)nb[6] << 16 | (uint32_t)nb[7] << 24);
        int4* c4 = reinterpret_cast<int4*>(codes_row) + 2 * lane;
        c4[0] = make_int4(code[0], code[1], code[2], code[3]);
        c4[1] = make_int4(code[4], code[5], code[6], code[7]);
    }
}

// val (len <= 44 bits) at image bit p: up to three words, each OR-ed in
// (the neighbouring codes may share the first and the last)
__device__ __forceinline__ void place(uint32_t* img, uint64_t val, int len, int p) {
    const int wd = p >> 5, off = p & 31;
    const uint64_t lo = val << off;
    if ((uint32_t)lo) atomicOr(&img[wd], (uint32_t)lo);
    if ((uint32_t)(lo >> 32)) atomicOr(&img[wd + 1], (uint32_t)(lo >> 32));
    if (off + len > 64) {
        const uint32_t hi = (uint32_t)(val >> (64 - off));
        if (hi) atomicOr(&img[wd + 2], hi);
    }
}

// bits k of the mask: symbol i0 + k of a unit lies in [0, lim)
__device__ __forceinline__ unsigned unit_mask(int i0, int lim) {
    const int lo = i0 < 0 ? -i0 : 0;
    const int hi = lim - i0 < ENC_UNIT ? lim - i0 : ENC_UNIT;
    return hi <= lo ? 0u : ((1u << hi) - 1u) & ~((1u << lo) - 1u);
}

// The whole _encode_chunks of one row in one cluster of four CTAs; CTA q
// owns stream q, the symbols [q m4, q m4 + slen_q) (m4 = ceil(v / 4)), and
// reads them from device memory once. With kCrc also the CRC of columns
// [0, offset + v) (the head of this file; crc_consts, crc_out, k_units).
// The body of both kernels below, which differ only in their launch bounds.
template <int THREADS, bool kCrc>
__device__ __forceinline__ void
encode_row(const uint8_t* __restrict__ data, const int32_t* __restrict__ valid,
           uint8_t* __restrict__ nbits_out, int32_t* __restrict__ codes_out,
           uint8_t* __restrict__ streams_out, int32_t* __restrict__ bits_out, i64 stride,
           i64 offset, int n, const uint32_t* __restrict__ crc_consts, i64* __restrict__ crc_out,
           int k_units) {
    constexpr int WARPS = THREADS / 32, UNIT = ENC_UNIT, HIST = enc_hist_bytes(THREADS);
    extern __shared__ __align__(16) uint8_t smem[];
    uint32_t* img = reinterpret_cast<uint32_t*>(smem);  // the stream image, once the codes are built
    uint32_t* sub = img;                                // before: [WARPS][256] histograms,
    uint32_t* inbox = img + HIST / 4;                   // [ENC_CLUSTER][256] quarters' histograms,
    int2* pair = reinterpret_cast<int2*>(smem + HIST + ENC_INBOX);  // and the down loop's pairs
    const int sym_at = enc_img_bytes(THREADS, n);
    uint8_t* sym = smem + sym_at;
    EncShared& sh = *reinterpret_cast<EncShared*>(sym + enc_sym_region(n, kCrc, (int)offset));
    uint32_t* crc_s = reinterpret_cast<uint32_t*>(smem + crc_consts_at(THREADS, n, (int)offset));
    CrcShared& cs = *reinterpret_cast<CrcShared*>(crc_s + CRC_CONST_WORDS);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    cg::cluster_group cluster = cg::this_cluster();
    const int q = (int)cluster.block_rank();  // the stream
    if (kCrc && q == 0 && tid == 0) bar_owe(smem_addr(&cs.bar), (ENC_CLUSTER - 1) * 4);  // the peers' CRC parts
    cluster_arrive_relaxed();  // peers may write this CTA's inbox once every CTA has started
    const i64 row = blockIdx.x / ENC_CLUSTER;
    const int sb = stream_bytes(n);
    const uint8_t* src_row = data + row * stride + offset;
    int v = valid[row];
    // the histograms are zeroed while `valid` is on its way
    for (int i = tid; i < HIST / 16; i += THREADS) reinterpret_cast<uint4*>(sub)[i] = make_uint4(0, 0, 0, 0);
    v = v < 0 ? 0 : (v > n ? n : v);
    const int m4 = (v + 3) >> 2;
    const int start = q * m4;
    const int slen = q < 3 ? m4 : (v - 3 * m4 > 0 ? v - 3 * m4 : 0);  // start + slen <= n
    const int hv = v - start < 0 ? 0 : (v - start < slen ? v - start : slen);  // counted: [0, hv)
    const int pre = kCrc && q == 0 ? (int)offset : 0;  // CTA 0 of a fused launch stages the prefix too
    const uint8_t* src = src_row + start - pre;
    const int as = (int)((uintptr_t)src & 15);  // staged byte i at sym[as + i]
    const int a = as + pre;                     // symbol i at sym[a + i]

    // -- stage the quarter: 16-byte copies in the aligned middle, scalar head
    // and tail (with kCrc, the CRC's constants in a second group, first
    // waited on after the cluster barrier)
    {
        const int len = slen + pre;
        const int head = ((16 - as) & 15) < len ? (16 - as) & 15 : len;
        const int nvec = (len - head) >> 4;
        const unsigned s16 = (unsigned)__cvta_generic_to_shared(sym + as + head);
        for (int i = tid; i < nvec; i += THREADS) cp_async16(s16 + 16 * i, src + head + 16 * i);
        asm volatile("cp.async.commit_group;" ::: "memory");
        if (kCrc) {
            const unsigned c16 = smem_addr(crc_s);
            for (int i = tid; i < CRC_CONST_WORDS / 4; i += THREADS) cp_async16(c16 + 16 * i, crc_consts + 4 * i);
            asm volatile("cp.async.commit_group;" ::: "memory");
        }
        for (int i = tid; i < head; i += THREADS) sym[as + i] = src[i];
        for (int i = head + 16 * nvec + tid; i < len; i += THREADS) sym[as + i] = src[i];
        if (kCrc) {
            asm volatile("cp.async.wait_group 1;" ::: "memory");
        } else {
            asm volatile("cp.async.wait_group 0;" ::: "memory");
        }
    }
    __syncthreads();

    // -- each warp's run of 16-byte units (a unit a lane a step; a multiple
    // of 32 units, so a warp's steps are whole) and its histogram
    const uint4* sym16 = reinterpret_cast<const uint4*>(sym);
    const int nun = (a + slen + UNIT - 1) / UNIT;
    const int cw = (nun + 32 * WARPS - 1) / (32 * WARPS) * 32;
    const int c0 = warp * cw, c1 = c0 + cw < nun ? c0 + cw : nun;
    {
        uint32_t* h = sub + warp * 256;
        for (int un = c0 + lane; un < c1; un += 32) {
            const uint4 x = sym16[un];
            const uint32_t w[4] = {x.x, x.y, x.z, x.w};
            const unsigned m = unit_mask(UNIT * un - a, hv);
#pragma unroll
            for (int k = 0; k < UNIT; ++k)
                if (m >> k & 1u) atomicAdd(&h[(w[k >> 2] >> (8 * (k & 3))) & 255], 1u);
        }
    }
    __syncthreads();
    // -- push this quarter's histogram into every CTA of the cluster; after
    // the barrier no CTA touches another's memory, so none waits to exit,
    // except that with kCrc CTAs 1-3 later st.async their CRC parts into
    // CTA 0's cs.in: CTA 0 must not exit before its bar_wait on cs.bar
    cluster_wait();  // every CTA has started
    if (tid < 256) {
        uint32_t c = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) c += sub[w * 256 + tid];
#pragma unroll
        for (int r = 0; r < ENC_CLUSTER; ++r) cluster.map_shared_rank(inbox + q * 256, r)[tid] = c;
    }
    cluster_arrive();
    cluster_wait();
    if (kCrc) asm volatile("cp.async.wait_group 0;" ::: "memory");  // the CRC's constants, published below

    // -- the row's counts; the Kraft seed u = clip(2^floor_log2(q), 1, 1024),
    // q = clip(ceil(c * 2048 / v), 1, 2048) (c * 2048 < 2^28: 32-bit division)
    int c = 0, u = 0;
    if (tid < 256) {
#pragma unroll
        for (int r = 0; r < ENC_CLUSTER; ++r) c += (int)inbox[r * 256 + tid];
        const unsigned vv = v > 1 ? (unsigned)v : 1u;
        unsigned qq = ((unsigned)c * TSIZE + vv - 1) / vv;
        qq = qq < 1 ? 1 : (qq > TSIZE ? TSIZE : qq);
        u = 1 << floor_log2((int)qq);
        u = c > 0 ? (u > 1024 ? 1024 : u) : 0;
        sh.u[tid] = u;
        pair[tid] = make_int2(c > 0 ? c * 256 + tid : 0x7FFFFFFF, c > 0 ? u - 1 : 0);
    }
    __syncthreads();
    constexpr int FOLD_WARPS = crc_fold_threads(THREADS) / 32;
    if (warp == 0) {
        kraft_up(sh, lane, true);
    } else if (kCrc && warp <= FOLD_WARPS) {
        // -- this CTA's CRC piece, [a - pre, a + hv) of the staged copy, while
        // warp 0 runs the Kraft loop: each folding warp's lanes folded and joined
        const uint32_t f = crc_lanes(reinterpret_cast<const uint32_t*>(smem), crc_s, crc_s + CRC_SLICE_WORDS,
                                     sym_at + a - pre, sym_at + a + hv, pre > 0, k_units, tid - 32, lane, warp - 1);
        if (lane == 0) cs.part[warp - 1] = f;
    }
    __syncthreads();
    if (sh.down) {
        // The down loop halves the smallest (count, symbol) among present u >= 2
        // until the sum is <= 2048; halving keeps the count, so it walks the
        // candidates in key order and takes each down to 1 in turn. In closed
        // form: with E the excess and P the weight (u - 1) of the smaller keys,
        // r = E - P; r > 0 leaves pow2floor(u - r), or 1 where u - r < 1.
        if (c > 0 && u >= 2) {
            const int key = c * 256 + tid;
            int p = 0;
            const int4* p4 = reinterpret_cast<const int4*>(pair);
#pragma unroll 8
            for (int t = 0; t < 128; ++t) {
                const int4 x = p4[t];
                p += (x.x < key ? x.y : 0) + (x.z < key ? x.w : 0);
            }
            const int r = sh.sum - TSIZE - p;
            if (r > 0) sh.u[tid] = u - r < 1 ? 1 : 1 << floor_log2(u - r);
        }
        __syncthreads();
        if (warp == 0) kraft_up(sh, lane, false);
        __syncthreads();
    }

    // -- warp 0 builds the codes while each other warp counts its bits: its
    // histogram against the lengths, plus the few symbols past v that a
    // short row's first three streams carry (uncounted); warp 0 counts after
    if (warp == 0) make_codes(sh, lane, q == 0 ? nbits_out + row * 256 : nullptr, codes_out + row * 256);
    {
        int t = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) t += (int)sub[warp * 256 + lane + 32 * i] * length_of(sh.u[lane + 32 * i]);
        if (lane == 0) {
            const int lo = UNIT * c0 - a > hv ? UNIT * c0 - a : hv;
            const int hi = UNIT * c1 - a < slen ? UNIT * c1 - a : slen;
            for (int i = lo; i < hi; ++i) t += length_of(sh.u[sym[a + i]]);
        }
        t = (int)__reduce_add_sync(FULL, (unsigned)t);
        if (lane == 0) sh.wtot[warp] = t;
    }
    if (kCrc && warp == WARPS - 1) {
        // -- (while warp 0 builds the codes) the folding warps joined by Z^(16
        // K 32 2^j), the CTA's part moved to the message's end by Z^(v - start
        // - hv) and sent to CTA 0
        const uint32_t* warp_ops = crc_s + CRC_SLICE_WORDS + CRC_LANE_OPS * OP_WORDS;
        uint32_t f = lane < FOLD_WARPS ? cs.part[lane] : 0u;
#pragma unroll
        for (int j = 0; (1 << j) < FOLD_WARPS; ++j) {
            const uint32_t up = __shfl_down_sync(FULL, f, 1 << j);
            if ((lane & ((2 << j) - 1)) == 0) f ^= apply_op(warp_ops + j * OP_WORDS, up);
        }
        const int s = v - start - hv;  // < 0 only for an empty piece (hv = 0), whose part is 0
        f = crc_shift(warp_ops + CRC_WARP_OPS * OP_WORDS, __shfl_sync(FULL, f, 0), s > 0 ? s : 0, lane);
        if (lane == 0) {
            if (q == 0) {
                cs.in[0] = f;
            } else {
                st_async(peer_addr(smem_addr(cs.in + q), 0), f, peer_addr(smem_addr(&cs.bar), 0));
            }
        }
    }
    __syncthreads();
    // the image holds stream byte k at byte ad + k, so its 16-byte words are
    // the stream row's (the row pitch SB is not a multiple of 16)
    uint8_t* dst = streams_out + (row * ENC_CLUSTER + q) * (i64)sb;
    const int ad = (int)((uintptr_t)dst & 15);
    for (int i = tid; i < (ad + sb + 15) >> 4; i += THREADS) reinterpret_cast<uint4*>(img)[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();

    // -- the stream, written in reverse: symbol i takes bits [tb - csum_i,
    // tb - csum_i + nb_i) (csum inclusive), the end marker bit tb. A lane packs
    // each word of its unit into one code of <= 44 bits; a warp scan of the
    // units' lengths places them, carried across the warp's steps.
    int carry = 0, tb = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        const int x = sh.wtot[w];
        carry += w < warp ? x : 0;
        tb += x;
    }
    const int top = tb + 8 * ad;
    if (tid == 0) atomicOr(&img[top >> 5], 1u << (top & 31));
    for (int b0 = c0; b0 < c1; b0 += 32) {
        const int un = b0 + lane;
        uint64_t val[4];
        int len[4];
        uint32_t w[4] = {0, 0, 0, 0};
        unsigned m = 0;
        if (un < c1) {
            const uint4 x = sym16[un];
            w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
            m = unit_mask(UNIT * un - a, slen);
        }
        int bits = 0;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
            val[g] = 0;
            len[g] = 0;
#pragma unroll
            for (int k = 4 * g; k < 4 * g + 4; ++k) {
                const uint32_t e = m >> k & 1u ? sh.tab[(w[g] >> (8 * (k & 3))) & 255] : 0u;
                val[g] = val[g] << (e >> 16) | (e & 0xFFFFu);
                len[g] += (int)(e >> 16);
            }
            bits += len[g];
        }
        int incl = bits;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(FULL, incl, o);
            if (lane >= o) incl += y;
        }
        int below = top - carry - (incl - bits);  // just above this unit's codes
#pragma unroll
        for (int g = 0; g < 4; ++g) {
            below -= len[g];
            place(img, val[g], len[g], below);
        }
        carry += __shfl_sync(FULL, incl, 31);
    }
    __syncthreads();

    // -- all SB bytes out: 16-byte stores in the aligned middle, scalar head and tail
    const uint8_t* ib = reinterpret_cast<const uint8_t*>(img) + ad;
    const int head = ((16 - ad) & 15) < sb ? (16 - ad) & 15 : sb;
    const int nv = (sb - head) >> 4;
    for (int i = tid; i < nv; i += THREADS)
        reinterpret_cast<uint4*>(dst + head)[i] = reinterpret_cast<const uint4*>(ib + head)[i];
    for (int i = tid; i < head; i += THREADS) dst[i] = ib[i];
    for (int i = head + 16 * nv + tid; i < sb; i += THREADS) dst[i] = ib[i];
    if (tid == 0) bits_out[row * ENC_CLUSTER + q] = tb;
    if (kCrc && q == 0 && tid == THREADS - 1) {
        // the message's CRC: the four parts (the peers' once they are here), inverted
        bar_wait(smem_addr(&cs.bar));
        crc_out[row] = (i64)(cs.in[0] ^ cs.in[1] ^ cs.in[2] ^ cs.in[3] ^ 0xFFFFFFFFu);
    }
}

template <int THREADS>
__global__ void __cluster_dims__(ENC_CLUSTER, 1, 1) __launch_bounds__(THREADS)
zstd_encode_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ valid,
                   uint8_t* __restrict__ nbits_out, int32_t* __restrict__ codes_out,
                   uint8_t* __restrict__ streams_out, int32_t* __restrict__ bits_out, i64 stride,
                   i64 offset, int n) {
    encode_row<THREADS, false>(data, valid, nbits_out, codes_out, streams_out, bits_out, stride, offset, n,
                               nullptr, nullptr, 0);
}

// the encode with its CRC stage, one kernel a launch shape: at 256 threads
// the bounds hold its registers to the standalone encode's 48, so five
// CTAs an SM still fit (a minimum of one block would lift them: 79)
#define RP_FUSED_ZSTD(NAME, THREADS, BOUNDS)                                                                   \
    __global__ void __cluster_dims__(ENC_CLUSTER, 1, 1) BOUNDS NAME(                                           \
        const uint8_t* __restrict__ data, const int32_t* __restrict__ valid, uint8_t* __restrict__ nbits_out, \
        int32_t* __restrict__ codes_out, uint8_t* __restrict__ streams_out, int32_t* __restrict__ bits_out,   \
        i64 stride, i64 offset, int n, const uint32_t* __restrict__ crc_consts, i64* __restrict__ crc_out,    \
        int k_units) {                                                                                         \
        encode_row<THREADS, true>(data, valid, nbits_out, codes_out, streams_out, bits_out, stride, offset, n, \
                                  crc_consts, crc_out, k_units);                                               \
    }
RP_FUSED_ZSTD(fused_zstd_kernel_256, 256, __launch_bounds__(256, 5))
RP_FUSED_ZSTD(fused_zstd_kernel_512, 512, __launch_bounds__(512))
#undef RP_FUSED_ZSTD

// the encode's launch shape and shared memory, no work: the launch floor
template <int THREADS>
__global__ void __cluster_dims__(ENC_CLUSTER, 1, 1) __launch_bounds__(THREADS) zstd_encode_empty_kernel() {}


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

// one encode launch's buffers (the CRC's with kCrc)
struct EncArgs {
    const uint8_t* data;
    const int32_t* valid;
    uint8_t* nbits;
    int32_t* codes;
    uint8_t* streams;
    int32_t* bits;
    const uint32_t* crc_consts;
    i64* crc;
    i64 stride, offset;
    int n;
};

template <int THREADS, bool kCrc>
static int encode_launch(const EncArgs& x, i64 b_n, bool empty, cudaStream_t stream) {
    const int smem = enc_smem_bytes(THREADS, x.n, kCrc, (int)x.offset);
    const unsigned grid = (unsigned)(ENC_CLUSTER * b_n);
    if (empty) {
        cudaError_t e = cudaFuncSetAttribute(zstd_encode_empty_kernel<THREADS>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        zstd_encode_empty_kernel<THREADS><<<grid, THREADS, smem, stream>>>();
        return (int)cudaGetLastError();
    }
    if (kCrc) {
        const auto kernel = THREADS == 256 ? fused_zstd_kernel_256 : fused_zstd_kernel_512;
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        kernel<<<grid, THREADS, smem, stream>>>(
            x.data, x.valid, x.nbits, x.codes, x.streams, x.bits, x.stride, x.offset, x.n, x.crc_consts, x.crc,
            crc_units((int)x.offset, x.n, THREADS));
        return (int)cudaGetLastError();
    }
    cudaError_t e = cudaFuncSetAttribute(zstd_encode_kernel<THREADS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    zstd_encode_kernel<THREADS><<<grid, THREADS, smem, stream>>>(x.data, x.valid, x.nbits, x.codes, x.streams,
                                                                   x.bits, x.stride, x.offset, x.n);
    return (int)cudaGetLastError();
}

// the launch shape by row count (see the head of this file): threads a CTA
static int encode_threads(i64 b_n) { return b_n <= ENC_FEW_ROWS ? 512 : 256; }

template <bool kCrc>
static int encode_shape(const EncArgs& x, i64 b_n, bool empty, void* stream) {
    if (b_n <= 0) return 0;
    if (x.n < 4 || x.n > MAX_N || (x.n & (x.n - 1)) || b_n > (1LL << 29)) return (int)cudaErrorInvalidValue;
    if (kCrc && (x.offset < 4 || x.offset > CRC_MAX_PREFIX)) return (int)cudaErrorInvalidValue;
    return encode_threads(b_n) == 512
               ? encode_launch<512, kCrc>(x, b_n, empty, (cudaStream_t)stream)
               : encode_launch<256, kCrc>(x, b_n, empty, (cudaStream_t)stream);
}

extern "C" {

const char* rp_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}


// nbits: B*256 uint8; codes: B*256 int32; streams: B*4 rows of
// stream_bytes(n); bits: B*4 int32. A refused launch (the cluster's
// shared memory) returns its error.
int rp_zstd_encode(const uint8_t* data, const int32_t* valid, uint8_t* nbits, int32_t* codes,
                   uint8_t* streams, int32_t* bits, i64 b_n, i64 stride, i64 offset, i64 n,
                   void* stream) {
    const EncArgs x{data, valid, nbits, codes, streams, bits, nullptr, nullptr, stride, offset, (int)n};
    return encode_shape<false>(x, b_n, false, stream);
}

// an empty kernel at the encode's launch shape and shared memory for b_n rows of n
int rp_zstd_encode_empty(i64 b_n, i64 n, void* stream) {
    const EncArgs x{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, (int)n};
    return encode_shape<false>(x, b_n, true, stream);
}

// The encode with the CRC of columns [0, offset + v) of each row (the
// prefix before the chunk, then its v valid bytes): crc int64 [B], the
// other outputs as rp_zstd_encode's. consts: ops/fused.zstd_crc_consts for
// the K that rp_fused_zstd_units gives for the same (b_n, offset, n).
// 4 <= offset <= CRC_MAX_PREFIX.
int rp_fused_zstd(const uint8_t* data, const int32_t* valid, const uint32_t* consts, i64* crc, uint8_t* nbits,
                  int32_t* codes, uint8_t* streams, int32_t* bits, i64 b_n, i64 stride, i64 offset, i64 n,
                  void* stream) {
    const EncArgs x{data, valid, nbits, codes, streams, bits, consts, crc, stride, offset, (int)n};
    return encode_shape<true>(x, b_n, false, stream);
}

// K, the CRC's 16-byte units a folding thread, of an rp_fused_zstd launch
// of b_n rows of bucket n at column offset `offset`: the launch shape and
// its K are chosen here alone, and the host builds its constants for it
int rp_fused_zstd_units(i64 b_n, i64 offset, i64 n) {
    return crc_units((int)offset, (int)n, encode_threads(b_n));
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
