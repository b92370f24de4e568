// Fused CRC-32C + LZ4 or snappy over one upload: one launch, one
// thread-block cluster of C CTAs a row.
//
// Replaces redpanda_tpu/ops/fused.py:42 _fused (the Kafka batch CRC over
// prefix || body, cellparse.py:30 cell_parse and lz4.py:59 _compress_chunks
// of the body, in one program) and fused.py:69 _fused_snappy (the same
// with snappy.py:52 _compress_chunks). The rows are ops/fused.py's
// [B, 40 + n + 16] uploads, [crc prefix | body | guard], zero past the body's
// valid length v <= n <= 65536; the body is read in place at column
// `offset`. Outputs: the CRC (int64 [B]), the block (uint8 [B, m], m = the
// codec's out_bound(n), bytes past out_len unwritten: LZ4's block, or
// snappy's elements without the length preamble) and out_len (int32 [B]),
// equal to the three-launch sequence's (crc32c_rows, rp_cell_parse,
// rp_lz4_emit / rp_snappy_emit); the parse vectors stay in shared memory.
//
// What bounds it: latency. At one call's row (n = 32,768, v ~ 16.6 K) the
// bytes are ~33 KB in and out, 0.01 us at 3.35 TB/s; the sequence spent 75 us
// of its 86 on the parse because one block of 1,024 threads did the sort, the
// candidate scatter, the verification and the scans on one SM while 131
// idled. Here the row's work is spread over the C SMs of a cluster, which
// share it through distributed shared memory (DSMEM). A cluster barrier
// costs ~0.7 us on an H100 (its arrive compiles to MEMBAR.ALL.GPU, its wait
// to an L1 invalidate), so five of the eight exchanges go without one: the
// producer stores each word into the consumer with st.async, which counts
// its bytes off the consumer's mbarrier, and the consumer waits on its own
// mbarrier for the bytes it is owed, then syncs its threads (exchange_wait).
// Three cluster barriers remain: the start (every CTA running, its
// mbarriers armed), the end of sort pass 1 (the entries' region takes the
// candidates next) and the candidate scatter (16-bit stores, which st.async
// has not). The phases:
//   * every CTA stages the whole row (16-byte cp.async copies of the
//     aligned middle, scalar head and tail; the body starts 8 bytes past a
//     16-byte boundary): the verification compares a position with
//     candidates anywhere earlier in the row, and the emission copies
//     literals from anywhere;
//   * the CRC: prefix || body is cut into 16-byte units counted from the
//     row's end, CTA k taking the P units [k P, (k + 1) P) and its thread t
//     the K units [k P + t K, ... + K) (P = ceil(units of a full row / C),
//     K about 4, so W = ceil(P / 32 K) warps hold them: fixed by the shape),
//     folded slice-by-4 from register 0, the CRC's initial 0xFFFFFFFF xored
//     into the row's first 4 bytes as they are read and the zeros before
//     the row's start folding into a zero register; the parts are joined by
//     operators the host builds for the shape (Z^n appends n zero bytes):
//     Z^(16 K 2^j) across lanes (warps without units skip it), Z^(16 K 32
//     2^j), j < log2 W, across warps, Z^(16 P k) for the CTA, and CTA 0
//     xors the C parts (rows under 4 bytes take csrc/crc32c.cu's final
//     term). The lanes' part runs while pass 0's counts are exchanged, the
//     warps' while pass 1's are;
//   * candidates from a cluster-wide stable LSD radix sort of the keys
//     (hash << 16 | pos) of [0, walk_end), walk_end = min(v + 1, n): CTA k
//     owns the ranks [k run, (k + 1) run), run = ceil(walk_end / C), and
//     its warps contiguous runs of them, each lane up to max_kpt(C) keys in
//     registers. A pass (8-bit digits, the hash's low then high byte):
//     count (one shared atomic a key), push the CTA's 256 counts into every
//     CTA (an inbox a pass), offsets over (digit, CTA, warp) digit-major,
//     the stable scatter of csrc/codec.cu's parse (lane masks beside
//     running offsets, 32 keys a step), each key stored into its rank's
//     owner over DSMEM. Keys are held in registers from before a CTA sends
//     its counts, so one buffer serves both passes. LSD is balanced for any skew (a row of one
//     repeated byte has one hash). Then cand[sp[i]] = sp[i - 1] where the
//     hashes agree (the first rank of a CTA reads its neighbour's last),
//     stored into the CTA that owns the position;
//   * the cells [0, ceil(walk_end / 16)) are dealt to the CTAs in runs of
//     cpc; each verifies its cells as the parse does (a thread a position,
//     a cell a half-warp, the chain g1, g2, g3, the tail guard cstart + 16
//     <= v - 12, the half-warp ballot for the first good position), the
//     chain's later candidates read from their owner's shared memory and
//     each requested before the candidate ahead of it is compared; a warp
//     takes two cell pairs a step, their chains interleaved;
//   * absorption, run ends and literal starts are the parse's scans over
//     the cells, done per CTA and joined by two exchanges of a summary a
//     CTA (its first and last cells; its boundaries; its sequences' size
//     sum, with the first sequence's literal length fixed up once the
//     previous CTAs' last run end is known);
//   * CTA k emits the sequences whose match starts in its cells (the last
//     CTA the final literal run too) into a shared image of its output
//     range at the block's alignment in device memory: the heads by
//     Codec::put_head, long parts deferred to the CTA, the literals from its
//     own copy of the row; the ranges of the CTAs tile [0, out_len), so each
//     writes its range with 16-byte stores and its two edges byte by byte.
// Shared memory (Layout): the row; the sort keys, later the sequences; the
// digit entries, then the candidates, then the output image; per cell has,
// j, offs; the inboxes and the CRC tables: with LZ4 224,416 B at n =
// 65,536 and C = 4, 150,896 B at n = 32,768 and C = 16; snappy's image is
// smaller (its range_bound), 222,112 B at n = 65,536 and C = 4. n = 65,536
// needs C >= 4 (the keys a CTA sorts); a shape whose shared memory does
// not fit reports no resident cluster (rp_fused_shape), and a launch whose
// cluster cannot be resident is refused and returns its error. At one
// call's row (n = 32,768, v ~ 16.6 K) on an H100 80GB HBM3 at 700 W the LZ4
// launch takes 28.7 us at C = 16 (31.6 at C = 8; the sequence 87.3). The
// kernel is a template over the codec (csrc/lz77.cuh's Lz4 and Snappy: the
// sizes, the final run, the heads and deferred parts, and Layout's
// range_bound); this file instantiates both.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <tuple>

#include "crc_ops.cuh"
#include "lz77.cuh"

namespace cg = cooperative_groups;

#define FUSED_THREADS 1024
#define FUSED_WARPS (FUSED_THREADS / 32)
// sort keys a lane holds: 16 up to C = 4, 64 / C past it, so a CTA sorts
// <= 16,384 keys (n <= 32,768 at C = 2, any n from C = 4) with no more
// registers than its share of a 65,536-byte row needs
__host__ __device__ constexpr int max_kpt(int c) { return c >= 4 ? 64 / c : 16; }
#define CELL_ITEMS 2               // cells a thread takes in the scans: a CTA owns <= 2,048 cells
#define ENT_STRIDE 257             // a warp's digit entries (mask, offset), padded across banks
#define ENT_BYTES (FUSED_WARPS * ENT_STRIDE * 8)
#define SLICE_WORDS (4 * 256)      // slice-by-4 tables T0..T3
#define TREE_OPS 10                // Z^(16 K 2^j) then Z^(16 K 32 2^j), j < 5
#define CTA_OPS 15                 // Z^(16 P r), r = 1..15
#define MAX_CLUSTER 16
#define NO_BND 0x7FFFFFFF          // no boundary (the scans' identity)
#define MAX_DEVICES 64

static_assert(CELL_ITEMS * FUSED_THREADS * 2 >= MAX_CELLS, "C >= 2 leaves <= 2,048 cells a CTA");

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// What a CTA tells the others after verifying its cells (exchange 1) and
// after its scans (exchange 2).
struct Summ1 {
    int ncell, first_has, first_j, first_offs, last_has, last_offs;
    int min_rest;  // the least boundary among its cells after the first
    uint32_t crc;  // its CRC part, shifted to the row's end
};
struct Summ2 {
    int max_contrib;  // the end of its last run (cells * 16), 0 without one
    int size_sum;     // its sequences' bytes, the first one's literals from 0
    int heads, first_mstart, first_mlen;
    int pad[3];
};

// The dynamic shared memory of a CTA for bucket n, prefix `offset` and
// cluster size C (byte offsets of its regions).
template <class Codec>
struct Layout {
    int cpc, run, keys, x, cells, inbox, crc, bytes;
    __host__ __device__ constexpr Layout(int n, int offset, int c)
        : cpc(cdiv(n / CELL, c)), run(cdiv(n, c)),
          keys(round16(32 + offset + n + CELL + 16)),
          x(keys + round16(imax(4 * cdiv(n, c), 14 * cdiv(n / CELL, c)))),
          cells(x + round16(imax(ENT_BYTES, imax(2 * CELL * cdiv(n / CELL, c),
                                                 Codec::range_bound(n, cdiv(n / CELL, c)) + 32)))),
          inbox(cells + round16(4 * cdiv(n / CELL, c))),
          crc(inbox + round16(c * (2 * 256 * 4 + (int)sizeof(Summ1) + (int)sizeof(Summ2)))),
          bytes(crc + 4 * (SLICE_WORDS + (TREE_OPS + 1) * OP_WORDS)) {}
};

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
    cluster_arrive();
    cluster_wait();
}

// The exchanges that need no cluster barrier: a producer stores each word
// into the consumer's shared memory with st.async, which counts its bytes
// off the consumer's mbarrier, and the consumer, knowing how many bytes it
// is owed, waits on its own mbarrier. No fence, no wait for the slowest CTA.
__device__ __forceinline__ uint32_t smem_addr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// the same shared memory location in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
    return r;
}

__device__ __forceinline__ void st_async(uint32_t peer, uint32_t v, uint32_t peer_bar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, [%2];"
                 ::"r"(peer), "r"(v), "r"(peer_bar) : "memory");
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

// the one arrival of the barrier's only phase, owed `bytes`
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
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

// the exchange's bytes are here and, unlike after a cluster barrier, every
// thread of this CTA is past the phase before it (which may still be
// reading what the next phase overwrites)
__device__ __forceinline__ void exchange_wait(uint32_t bar) {
    bar_wait(bar);
    __syncthreads();
}

enum { BAR_CNT0, BAR_KEYS0, BAR_CNT1, BAR_SUMM1, BAR_SUMM2, N_BARS };

// register c folded over the 4 bytes w, slice-by-4 (entry i of table k at
// tab[256 k + i])
__device__ __forceinline__ uint32_t slice4(const uint32_t* tab, uint32_t c, uint32_t w) {
    c ^= w;
    return tab[768 + (c & 255u)] ^ tab[512 + ((c >> 8) & 255u)] ^ tab[256 + ((c >> 16) & 255u)] ^ tab[c >> 24];
}

// The four bytes at byte o of the dynamic shared memory, one funnel shift
// of the two aligned words that hold them. Indexing the shared array
// itself keeps the loads in the shared space (csrc/lz77.cuh row_word's
// pointer casts compile to generic loads).
__device__ __forceinline__ uint32_t smem_word(const uint32_t* s32, int o) {
    return __funnelshift_r(s32[o >> 2], s32[(o >> 2) + 1], (o & 3) * 8);
}

// the sort key of body position i (the body at byte db): its 4-gram's
// 16-bit hash, then i
__device__ __forceinline__ uint32_t hash_key(const uint32_t* s32, int db, int i) {
    return ((smem_word(s32, db + i) * 2654435761u) >> 16) << 16 | (uint32_t)i;
}

// body[p, e) == body[q, q + e - p) for a cell end e (<= v - 12), four
// bytes at a time from the end; the bytes below q on the last word are
// masked
__device__ __forceinline__ bool verify(const uint32_t* s32, int db, int p, int q, int e) {
    if (q < 0) return false;
    const int back = e - p;  // bytes to compare, 4..16
    for (int k = 4; k < back + 4; k += 4) {
        uint32_t x = smem_word(s32, db + e - k) ^ smem_word(s32, db + q + back - k);
        if (k > back) x &= ~0u << (8 * (k - back));
        if (x) return false;
    }
    return true;
}

template <class Op>
__device__ int block_reduce(int x, Op op, int* sh) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = op(x, __shfl_xor_sync(FULL, x, o));
    if (lane == 0) sh[warp] = x;
    __syncthreads();
    x = sh[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = op(x, __shfl_xor_sync(FULL, x, o));
    __syncthreads();  // sh is reused next
    return x;
}

struct FusedArgs {
    const uint8_t* data;
    const int32_t* valid;
    const uint32_t* consts;  // the slice-by-4 tables, then the shape's TREE_OPS + CTA_OPS operators
    i64* crc_out;
    uint8_t* out;
    int32_t* out_len;
    i64 stride;
    int offset, n, m;
    int piece, k_units;  // the CRC's units a CTA (P) and a thread (K)
};

template <class Codec, int C>
__global__ void __launch_bounds__(FUSED_THREADS, 1) fused_kernel(FusedArgs a) {
    static_assert(C >= 2 && C <= MAX_CLUSTER, "cluster size");
    extern __shared__ __align__(16) uint8_t smem[];
    __shared__ int scan_sh[32];       // block_reduce's
    __shared__ int scan_x[4][32];     // the scans': each its own, so none waits to reuse one
    __shared__ uint32_t crc_sh[32];
    __shared__ int4 def_s[DEFER_CAP];
    __shared__ int bc[12];  // values thread 0 or the last thread hands the CTA
    __shared__ int n_def;
    __shared__ __align__(8) uint64_t xbar[N_BARS];  // the exchanges' mbarriers, one phase each
    cg::cluster_group cluster = cg::this_cluster();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int k = (int)cluster.block_rank();
    const i64 row = blockIdx.x / C;
    const int n = a.n, offset = a.offset;
    int v = a.valid[row];
    v = v < 0 ? 0 : (v > n ? n : v);
    const int walk_end = v + 1 < n ? v + 1 : n;
    const int run = cdiv(walk_end, C);  // the sort's ranks a CTA: this one's are [r0, r1)
    const int r0 = min(k * run, walk_end), r1 = min(r0 + run, walk_end);
    const uint32_t bar0 = smem_addr(xbar);  // the BAR_* mbarrier is at bar0 + 8 BAR_*
    if (tid == 0) {  // each exchange's mbarrier, owed its bytes before any peer can store
        for (int b = 0; b < N_BARS; ++b) bar_init(bar0 + 8 * b);
        bar_expect(bar0 + 8 * BAR_CNT0, C * 256 * 4);
        bar_expect(bar0 + 8 * BAR_KEYS0, (r1 - r0) * 4);
        bar_expect(bar0 + 8 * BAR_CNT1, C * 256 * 4);
        bar_expect(bar0 + 8 * BAR_SUMM1, C * (int)sizeof(Summ1));
        bar_expect(bar0 + 8 * BAR_SUMM2, C * (int)sizeof(Summ2));
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cluster_arrive();  // peers may write this CTA's memory once every CTA has started
    const Layout<Codec> lay(n, offset, C);
    uint32_t* keys = reinterpret_cast<uint32_t*>(smem + lay.keys);  // ranks [r0, r1)
    uint32_t* ent = reinterpret_cast<uint32_t*>(smem + lay.x);      // digit entries, in the sort
    uint16_t* cand = reinterpret_cast<uint16_t*>(smem + lay.x);     // then cand of this CTA's positions
    uint8_t* img = smem + lay.x;                                    // then the output image
    uint8_t* has_s = smem + lay.cells;
    uint8_t* j_s = has_s + lay.cpc;
    uint16_t* offs_s = reinterpret_cast<uint16_t*>(j_s + lay.cpc);
    uint32_t* cnt_in = reinterpret_cast<uint32_t*>(smem + lay.inbox);  // [2][C][256] each pass's digit counts
    Summ1* s1 = reinterpret_cast<Summ1*>(cnt_in + 2 * C * 256);
    Summ2* s2 = reinterpret_cast<Summ2*>(s1 + C);
    uint32_t* tab = reinterpret_cast<uint32_t*>(smem + lay.crc);
    uint32_t* ops = tab + SLICE_WORDS;  // the tree's operators, then this CTA's

    const uint8_t* src = a.data + row * a.stride;
    const int rb = 16 + (int)((uintptr_t)src & 15);  // the row at smem + rb: 16-aligned where src is
    const int db = rb + offset;                       // the body
    uint8_t* row_s = smem + rb;
    const uint32_t* s32 = reinterpret_cast<const uint32_t*>(smem);
    const int len = offset + v;  // the CRC's bytes: prefix || body
    if (tid == 0) n_def = 0;

    // -- stage the row (and the guard the hashes read past v) and the CRC's
    //    tables and operators
    {
        const int sb = len + CELL;
        const int head = min((int)((16 - ((uintptr_t)src & 15)) & 15), sb);
        const int nvec = (sb - head) >> 4;
        const int tail = head + 16 * nvec;
        for (int i = tid; i < nvec; i += FUSED_THREADS) cp_async16(row_s + head + 16 * i, src + head + 16 * i);
        for (int i = tid; i < SLICE_WORDS / 4; i += FUSED_THREADS) cp_async16(tab + 4 * i, a.consts + 4 * i);
        const uint32_t* op_src = a.consts + SLICE_WORDS;
        for (int i = tid; i < TREE_OPS * OP_WORDS / 4; i += FUSED_THREADS) cp_async16(ops + 4 * i, op_src + 4 * i);
        if (k > 0 && tid < OP_WORDS / 4)
            cp_async16(ops + TREE_OPS * OP_WORDS + 4 * tid, op_src + (TREE_OPS + k - 1) * OP_WORDS + 4 * tid);
        asm volatile("cp.async.commit_group;" ::: "memory");
        if (tid < head) row_s[tid] = src[tid];
        if (tid < sb - tail) row_s[tail + tid] = src[tail + tid];
        asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();

    // -- partition: ranks [r0, r1) sorted here (warp w: [wr0, wr1), kpt
    //    steps of 32 keys), cells [c_lo, c_hi) verified and emitted here
    const int wrun = cdiv(cdiv(run, FUSED_WARPS), 32) * 32;
    const int kpt = wrun / 32;
    const int wr0 = min(r0 + warp * wrun, r1), wr1 = min(wr0 + wrun, r1);
    const int ncw = cdiv(walk_end, CELL);
    const int cpc = cdiv(ncw, C);
    const int c_lo = min(k * cpc, ncw), c_hi = min(c_lo + cpc, ncw);
    const int ncv = cdiv(v, CELL);

    // -- this CTA's CRC part: each warp's lanes folded and joined while
    //    pass 0's count barrier settles (crc_lanes), the warps joined and
    //    shifted to the row's end (thread 0) while pass 1's does (crc_join)
    uint32_t crc_part = 0;
    auto crc_lanes = [&]() {
        const int p0 = k * a.piece, p1 = min(p0 + a.piece, cdiv(len, 16));  // this CTA's units
        uint32_t f = 0;
        for (int u = a.k_units - 1; u >= 0; --u) {
            const int e = p0 + tid * a.k_units + u;
            if (e >= p1 || tid * a.k_units + u >= a.piece) continue;  // no unit, or wholly before the row
            const int x0 = len - 16 * (e + 1);
#pragma unroll
            for (int w = 0; w < 4; ++w) {
                const int x = x0 + 4 * w;
                uint32_t wd = 0;
                if (x > -4) {
                    wd = smem_word(s32, rb + x);  // x in [-3, 0): bytes before the row, masked
                    if (x < 0) wd &= ~0u << (-8 * x);
                    if (x < 4) wd ^= x >= 0 ? ~0u >> (8 * x) : ~0u << (-8 * x);  // the initial 0xFFFFFFFF
                }
                f = slice4(tab, f, wd);
            }
        }
        if (p0 + 32 * warp * a.k_units < p1)  // a warp with units: join its lanes
#pragma unroll
            for (int j = 0; j < 5; ++j) f ^= apply_op(ops + j * OP_WORDS, __shfl_down_sync(FULL, f, 1 << j));
        if (lane == 0) crc_sh[warp] = f;  // read after pass 0's offset scan
    };
    auto crc_join = [&]() {
        if (warp == 0) {
            const int w_n = cdiv(a.piece, 32 * a.k_units);  // the warps that hold units
            uint32_t f = lane < w_n ? crc_sh[lane] : 0u;
            for (int j = 0; (1 << j) < w_n; ++j) f ^= apply_op(ops + (5 + j) * OP_WORDS, __shfl_down_sync(FULL, f, 1 << j));
            if (k > 0) f = apply_op(ops + TREE_OPS * OP_WORDS, f);
            crc_part = f;
        }
    };

    // -- the cluster's stable radix sort of [0, walk_end) by hash
    {
        uint32_t* ent_w = ent + warp * ENT_STRIDE * 2;
        const unsigned lower = (1u << lane) - 1u;
        constexpr int KPT = max_kpt(C);
        uint32_t key[KPT];
#pragma unroll 1
        for (int pass = 0; pass < 2; ++pass) {
            const int shift = pass ? 24 : 16;
#pragma unroll
            for (int t = 0; t < KPT; ++t) {
                const int i = wr0 + 32 * t + lane;
                key[t] = 0u;
                if (t < kpt && i < wr1) key[t] = pass ? keys[i - r0] : hash_key(s32, db, i);
            }
            for (int i = tid; i < ENT_BYTES / 16; i += FUSED_THREADS) reinterpret_cast<uint4*>(ent)[i] = make_uint4(0, 0, 0, 0);
            __syncthreads();
#pragma unroll
            for (int t = 0; t < KPT; ++t)
                if (t < kpt && wr0 + 32 * t + lane < wr1) atomicAdd(&ent_w[2 * ((key[t] >> shift) & 255u) + 1], 1u);
            __syncthreads();
            if (pass == 0) cluster_wait();  // every CTA has started
            uint32_t* cnt = cnt_in + pass * C * 256;  // this pass's inbox
            const uint32_t cnt_bar = bar0 + 8 * (pass ? BAR_CNT1 : BAR_CNT0);
            if (tid < 256) {  // this CTA's count of each digit, into every CTA
                uint32_t c = 0;
#pragma unroll 8
                for (int w = 0; w < FUSED_WARPS; ++w) c += ent[(w * ENT_STRIDE + tid) * 2 + 1];
                const uint32_t at = smem_addr(cnt + k * 256 + tid);
#pragma unroll
                for (int r = 0; r < C; ++r) st_async(peer_addr(at, r), c, peer_addr(cnt_bar, r));
            }
            if (pass == 0) {
                crc_lanes();
            } else {
                crc_join();
            }
            exchange_wait(cnt_bar);
            {  // offsets over (digit, CTA, warp), digit-major; thread (dig, q4) owns warps 8 q4 .. 8 q4 + 7
                const int dig = tid >> 2, q4 = tid & 3;
                uint32_t c[8], x = 0, tot = 0, bef = 0;
#pragma unroll
                for (int w = 0; w < 8; ++w) x += c[w] = ent[((8 * q4 + w) * ENT_STRIDE + dig) * 2 + 1];
#pragma unroll
                for (int r = 0; r < C; ++r) {
                    const uint32_t y = cnt[r * 256 + dig];
                    tot += y;
                    bef += r < k ? y : 0u;
                }
                const int g = block_scan_excl<false, OpAdd, false>(q4 == 0 ? (int)tot : 0, OpAdd(), 0, scan_x[0]);
                const int g0 = lane & ~3;
                const uint32_t x0 = __shfl_sync(FULL, x, g0), x1 = __shfl_sync(FULL, x, g0 + 1),
                               x2 = __shfl_sync(FULL, x, g0 + 2);
                uint32_t o = (uint32_t)__shfl_sync(FULL, g, g0) + bef + (q4 > 0 ? x0 : 0u) + (q4 > 1 ? x1 : 0u) +
                             (q4 > 2 ? x2 : 0u);
#pragma unroll
                for (int w = 0; w < 8; ++w) {
                    ent[((8 * q4 + w) * ENT_STRIDE + dig) * 2 + 1] = o;
                    o += c[w];
                }
            }
            __syncthreads();
            // the stable scatter, 32 keys a step, each to its rank's owner
#pragma unroll
            for (int t = 0; t < KPT; ++t) {
                if (t < kpt) {
                    const bool act = wr0 + 32 * t + lane < wr1;
                    uint32_t* e = ent_w + 2 * ((key[t] >> shift) & 255u);
                    if (act) atomicOr(e, 1u << lane);
                    __syncwarp();
                    const uint2 pe = act ? *reinterpret_cast<const uint2*>(e) : make_uint2(0u, 0u);
                    if (act) {
                        const int rank = (int)(pe.y + __popc(pe.x & lower));
                        const int owner = rank / run;
                        if (pass == 0)  // counted off the owner's mbarrier
                            st_async(peer_addr(smem_addr(keys + (rank - owner * run)), owner), key[t],
                                     peer_addr(bar0 + 8 * BAR_KEYS0, owner));
                        else  // pass 1 ends in a cluster barrier (the entries' region takes the candidates next)
                            cluster.map_shared_rank(keys, owner)[rank - owner * run] = key[t];
                    }
                    __syncwarp();
                    if (act && (pe.x & lower) == 0u) *reinterpret_cast<uint2*>(e) = make_uint2(0u, pe.y + __popc(pe.x));
                    __syncwarp();
                }
            }
            if (pass == 0) {
                exchange_wait(bar0 + 8 * BAR_KEYS0);
            } else {
                cluster_sync();
            }
        }
    }

    // -- candidates: each rank's predecessor where the hashes agree, stored
    //    with the position's owner
    for (int i = r0 + tid; i < r1; i += FUSED_THREADS) {
        const uint32_t key = keys[i - r0];
        uint32_t c = NO_CAND;
        if (i > 0) {
            const uint32_t prev = i > r0 ? keys[i - 1 - r0] : *cluster.map_shared_rank(keys + (run - 1), k - 1);
            if ((prev >> 16) == (key >> 16)) c = prev & 0xFFFFu;
        }
        const int pos = (int)(key & 0xFFFFu);
        const int owner = (pos >> 4) / cpc;
        cluster.map_shared_rank(cand, owner)[pos - owner * cpc * CELL] = (uint16_t)c;
    }
    cluster_sync();

    // -- verification: a thread a position (a cell's 16 positions are 16
    //    lanes of one warp), the chain's candidates from their owners
    auto cand_at = [&](int p) -> int {
        if (p < 0) return -1;
        if (p >= walk_end) return p - 1;  // zeros past v: the previous position
        const int owner = (p >> 4) / cpc;
        const uint16_t* cp = owner == k ? cand : cluster.map_shared_rank(cand, owner);
        const uint32_t c = cp[p - owner * cpc * CELL];
        return c == NO_CAND ? -1 : (int)c;
    };
    // warp w takes the cell pairs w, w + 32, ... (lane l: cell 2 pair + l / 16,
    // position l % 16), two pairs a step with their chains interleaved
    const int ncell = c_hi - c_lo;
    const int npair = cdiv(ncell, 2);
    for (int pp = warp; pp < npair; pp += 2 * FUSED_WARPS) {
        int pos[2], cend[2], sel[2], c1[2], c2[2], c3[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int cell = 2 * (pp + u * FUSED_WARPS) + (lane >> 4), jj = lane & (CELL - 1);
            pos[u] = (c_lo + cell) * CELL + jj;
            cend[u] = (c_lo + cell + 1) * CELL;
            sel[u] = -1;
            c1[u] = cell < ncell && jj <= CELL - 4 && cend[u] <= v - TAIL_GUARD ? cand_at(pos[u]) : -1;
        }
        // each next candidate is requested before the current one is
        // verified, so a read from a peer's memory overlaps the compares
#pragma unroll
        for (int u = 0; u < 2; ++u) c2[u] = c1[u] >= 0 ? cand_at(c1[u]) : -1;
#pragma unroll
        for (int u = 0; u < 2; ++u)
            if (verify(s32, db, pos[u], c1[u], cend[u])) sel[u] = c1[u];
#pragma unroll
        for (int u = 0; u < 2; ++u) c3[u] = sel[u] < 0 && c2[u] >= 0 ? cand_at(c2[u]) : -1;
#pragma unroll
        for (int u = 0; u < 2; ++u)
            if (sel[u] < 0 && verify(s32, db, pos[u], c2[u], cend[u])) sel[u] = c2[u];
#pragma unroll
        for (int u = 0; u < 2; ++u)
            if (sel[u] < 0 && verify(s32, db, pos[u], c3[u], cend[u])) sel[u] = c3[u];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const unsigned good = (__ballot_sync(FULL, sel[u] >= 0) >> (lane & 16)) & 0xFFFFu;
            const int j = good ? __ffs(good) - 1 : 0;
            const int sel_j = __shfl_sync(FULL, sel[u], (lane & 16) + j);
            const int c = (pos[u] >> 4) - c_lo;
            if (c < ncell && (lane & (CELL - 1)) == 0) {
                has_s[c] = good != 0;
                j_s[c] = (uint8_t)j;
                offs_s[c] = good ? (uint16_t)(pos[u] + j - sel_j) : (uint16_t)0;
            }
        }
    }
    __syncthreads();

    // -- absorption inside the CTA (its first cell waits for exchange 1)
    int hd[CELL_ITEMS], jv[CELL_ITEMS], of[CELL_ITEMS], bnd[CELL_ITEMS];
    int min_rest = NO_BND;
#pragma unroll
    for (int i = 0; i < CELL_ITEMS; ++i) {
        const int c = CELL_ITEMS * tid + i;  // relative to c_lo
        hd[i] = jv[i] = of[i] = 0;
        bnd[i] = NO_BND;
        if (c < ncell) {
            hd[i] = has_s[c];
            jv[i] = j_s[c];
            of[i] = offs_s[c];
            const bool ab = c > 0 && hd[i] && has_s[c - 1] && jv[i] == 0 && of[i] == offs_s[c - 1];
            if (ab) hd[i] = 0;
            bnd[i] = ab ? NO_BND : c_lo + c;
            if (c > 0) min_rest = min(min_rest, bnd[i]);
        }
    }
    min_rest = block_reduce(min_rest, OpMin(), scan_sh);
    if (tid == 0) {
        Summ1& s = *reinterpret_cast<Summ1*>(bc);
        s.ncell = ncell;
        s.first_has = ncell > 0 ? has_s[0] : 0;
        s.first_j = ncell > 0 ? j_s[0] : 0;
        s.first_offs = ncell > 0 ? offs_s[0] : 0;
        s.last_has = ncell > 0 ? has_s[ncell - 1] : 0;
        s.last_offs = ncell > 0 ? offs_s[ncell - 1] : 0;
        s.min_rest = min_rest;
        s.crc = crc_part;
    }
    __syncthreads();
    if (tid < C * 8) {  // word w of the summary into CTA r
        const int r = tid >> 3, w = tid & 7;
        st_async(peer_addr(smem_addr(reinterpret_cast<uint32_t*>(s1 + k) + w), r), (uint32_t)bc[w],
                 peer_addr(bar0 + 8 * BAR_SUMM1, r));
    }
    exchange_wait(bar0 + 8 * BAR_SUMM1);

    // -- exchange 1 read: whether each CTA's first cell is absorbed, the
    //    least boundary after this CTA, and (CTA 0) the row's CRC
    auto first_absorbed = [&](int r) {
        return r > 0 && s1[r].ncell > 0 && s1[r].first_has && s1[r - 1].last_has && s1[r].first_j == 0 &&
               s1[r].first_offs == s1[r - 1].last_offs;
    };
    if (warp == 0) {  // lane r reads CTA r's summary
        const bool in = lane < C;
        const int least = in && s1[lane].ncell > 0 ? min(first_absorbed(lane) ? NO_BND : lane * cpc, s1[lane].min_rest)
                                                   : NO_BND;
        const int after = __reduce_min_sync(FULL, lane > k ? least : NO_BND);
        uint32_t crc = __reduce_xor_sync(FULL, in ? s1[lane].crc : 0u);
        if (lane == 0) {
            bc[0] = after;
            bc[1] = first_absorbed(k);
            if (k == 0) {
                if (len < 4) crc ^= 0xFFFFFFFFu >> (8 * len);
                a.crc_out[row] = (i64)(crc ^ 0xFFFFFFFFu);
            }
        }
    }
    __syncthreads();
    const int after = bc[0];
    if (tid == 0 && ncell > 0 && bc[1]) {
        hd[0] = 0;
        bnd[0] = NO_BND;
    }

    // -- run ends (reverse exclusive min of the boundaries), literal starts
    //    from this CTA's runs (exclusive max), sizes and their scan
    int agg = NO_BND;
#pragma unroll
    for (int i = 0; i < CELL_ITEMS; ++i) agg = min(agg, bnd[i]);
    int nb[CELL_ITEMS], pe[CELL_ITEMS];
    {
        int r = min(block_scan_excl<true, OpMin, false>(agg, OpMin(), NO_BND, scan_x[1]), after);  // then the later CTAs'
#pragma unroll
        for (int i = CELL_ITEMS - 1; i >= 0; --i) {
            nb[i] = r;
            r = min(r, bnd[i]);
        }
    }
    int cmax = 0;
#pragma unroll
    for (int i = 0; i < CELL_ITEMS; ++i) cmax = max(cmax, hd[i] ? nb[i] * CELL : 0);
    uint32_t pk[CELL_ITEMS], psum = 0;
    int run_end = 0;  // the end of this thread's last run, or the earlier threads' (the last thread: the CTA's)
    {
        int r = block_scan_excl<false, OpMax, false>(cmax, OpMax(), 0, scan_x[2]);
#pragma unroll
        for (int i = 0; i < CELL_ITEMS; ++i) {
            pe[i] = r;
            pk[i] = 0;
            if (hd[i]) {
                const int c = c_lo + CELL_ITEMS * tid + i;
                const int mstart = c * CELL + jv[i], mlen = (nb[i] - c) * CELL - jv[i];
                pk[i] = (1u << 18) | (uint32_t)Codec::size(true, mstart - r, mlen);
                if (r == 0) {  // the CTA's first sequence: its literals start in an earlier CTA's cells
                    bc[2] = mstart;
                    bc[3] = mlen;
                }
                r = nb[i] * CELL;
            }
            psum += pk[i];
        }
        run_end = r;
    }
    const uint32_t pex = (uint32_t)block_scan_excl<false, OpAdd, false>((int)psum, OpAdd(), 0, scan_x[3]);
    if (tid == FUSED_THREADS - 1) {
        Summ2& s = *reinterpret_cast<Summ2*>(bc + 4);
        s.max_contrib = run_end;
        s.size_sum = (int)((pex + psum) & 0x3FFFFu);
        s.heads = (int)((pex + psum) >> 18);
        s.first_mstart = s.heads ? bc[2] : 0;
        s.first_mlen = s.heads ? bc[3] : 0;
    }
    __syncthreads();
    if (tid < C * 8) {
        const int r = tid >> 3, w = tid & 7;
        st_async(peer_addr(smem_addr(reinterpret_cast<uint32_t*>(s2 + k) + w), r), (uint32_t)bc[4 + w],
                 peer_addr(bar0 + 8 * BAR_SUMM2, r));
    }
    // every CTA's summary here means every CTA is past its last read of a
    // peer's memory (those come before its first summary): none touches
    // another's memory after this
    exchange_wait(bar0 + 8 * BAR_SUMM2);

    // -- exchange 2 read: this CTA's output range, its first literal start,
    //    the block's length and the final run's start
    if (warp == 0) {  // lane r: CTA r's literal start (the earlier runs' end), bytes and base
        const bool in = lane < C;
        int run_max = in ? s2[lane].max_contrib : 0, t = in ? s2[lane].size_sum : 0, fix = 0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(FULL, run_max, o);
            if (lane >= o) run_max = max(run_max, y);
        }
        int incoming = __shfl_up_sync(FULL, run_max, 1);
        if (lane == 0) incoming = 0;
        if (in && s2[lane].heads) {
            fix = Codec::size(true, s2[lane].first_mstart - incoming, s2[lane].first_mlen) -
                  Codec::size(true, s2[lane].first_mstart, s2[lane].first_mlen);
            t += fix;
        }
        int sum = t;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(FULL, sum, o);
            if (lane >= o) sum += y;
        }
        if (lane == k) {
            bc[0] = sum - t;
            bc[1] = incoming;
            bc[2] = fix;
            bc[3] = sum;
        }
        if (lane == 31) {
            bc[4] = sum;      // every sequence's bytes
            bc[5] = run_max;  // the final run's start
        }
    }
    __syncthreads();
    const int my_base = bc[0], my_in = bc[1], my_fix = bc[2], total = bc[4], f_start = bc[5];
    const bool last = k == C - 1;
    const int f_lit = v - f_start > 0 ? v - f_start : 0;
    const int end = last ? total + Codec::final_size(f_lit) : bc[3];
    if (last && tid == 0) a.out_len[row] = end;

    // -- the sequences (region of the keys) and each cell's count of
    //    sequences before it
    uint2* seq_s = reinterpret_cast<uint2*>(keys);  // (ls | lit << 16, mlen | offs << 16)
    int* start_s = reinterpret_cast<int*>(seq_s + lay.cpc);
    uint16_t* cell_q = reinterpret_cast<uint16_t*>(start_s + lay.cpc);
    uint32_t before = pex;
#pragma unroll
    for (int i = 0; i < CELL_ITEMS; before += pk[i], ++i) {
        const int c = CELL_ITEMS * tid + i;
        const int q = (int)(before >> 18);
        if (c < ncell) cell_q[c] = (uint16_t)q;
        if (hd[i]) {
            const int mstart = (c_lo + c) * CELL + jv[i], mlen = (nb[i] - c_lo - c) * CELL - jv[i];
            const int ls = q == 0 ? my_in : pe[i];
            seq_s[q] = make_uint2((uint32_t)ls | (uint32_t)(mstart - ls) << 16, (uint32_t)mlen | (uint32_t)of[i] << 16);
            start_s[q] = my_base + (int)(before & 0x3FFFFu) + (q > 0 ? my_fix : 0);
        }
    }
    __syncthreads();
    const int nseq = s2[k].heads;

    // -- the heads, a thread a sequence (the final run last, in the last
    //    CTA), into the image of [my_base, end) at the block's alignment
    uint8_t* dst = a.out + row * (i64)a.m;
    const int h = (int)((uintptr_t)(dst + my_base) & 15);
    uint8_t* out_h = img + h;  // out_h[o - my_base] is output byte o
    const int mrel = a.m - my_base;
    auto defer = [&](int p, int dl, int x, int y) {
        const int e = atomicAdd(&n_def, 1);
        if (e < DEFER_CAP) def_s[e] = make_int4(p, dl, x, y);
    };
    for (int q = tid; q < nseq + (last ? 1 : 0); q += FUSED_THREADS) {
        int st = total, lit = f_lit, mlen = -1, offs = 0;
        if (q < nseq) {
            const uint2 f = seq_s[q];
            st = start_s[q];
            lit = (int)(f.x >> 16);
            mlen = (int)(f.y & 0xFFFFu);
            offs = (int)(f.y >> 16);
        }
        Codec::put_head(out_h, st - my_base, lit, mlen, offs, mrel, defer);
    }

    // -- the literals: cells [lc_lo, lc_hi), from this CTA's first
    //    sequence's literal start to its last match (the last CTA: to v);
    //    a cell's literals belong to the first sequence at or after it
    int lc_lo = 0, lc_hi = 0;
    if (nseq > 0) {
        lc_lo = (int)(seq_s[0].x & 0xFFFFu) / CELL;
        const uint2 fl = seq_s[nseq - 1];
        lc_hi = (int)((fl.x & 0xFFFFu) + (fl.x >> 16)) / CELL + 1;
    } else if (last) {
        lc_lo = f_start / CELL;
    }
    if (last) lc_hi = ncv;
    const int fl0 = total + Codec::lit_head(f_lit);
    const bool row_aligned = (db & 3) == 0;
    for (int g = lc_lo + 32 * warp; g < lc_hi; g += FUSED_THREADS) {
        const int c = g + lane;
        int lo = CELL, hi = CELL, delta = 0;
        if (c < lc_hi) {
            const int q = c < c_lo ? 0 : (c < c_hi ? (int)cell_q[c - c_lo] : nseq);
            if (q < nseq || last) {
                int ls = f_start, lend = v, l0 = fl0;
                if (q < nseq) {
                    const uint32_t fx = seq_s[q].x;
                    ls = (int)(fx & 0xFFFFu);
                    lend = ls + (int)(fx >> 16);
                    l0 = start_s[q] + Codec::lit_head((int)(fx >> 16));
                }
                lo = min(max(ls - CELL * c, 0), CELL);
                hi = min(max(lend - CELL * c, lo), CELL);
                delta = l0 - ls - my_base;
            }
        }
        if (!__any_sync(FULL, lo < hi)) continue;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int wi = 32 * u + lane;  // the group's word: cell wi / 4, bytes 4 (wi % 4) on
            const int wlo = __shfl_sync(FULL, lo, wi >> 2), whi = __shfl_sync(FULL, hi, wi >> 2);
            const int o = CELL * g + 4 * wi + __shfl_sync(FULL, delta, wi >> 2);
            const int x = CELL * g + 4 * wi, j0 = 4 * (wi & 3);
            if (whi > j0 && wlo < j0 + 4) {
                const uint32_t w = row_aligned ? s32[(db + x) >> 2] : smem_word(s32, db + x);
#pragma unroll
                for (int b = 0; b < 4; ++b)
                    if (j0 + b >= wlo && j0 + b < whi && o + b < mrel) out_h[o + b] = (uint8_t)(w >> (8 * b));
            }
        }
    }
    __syncthreads();

    // -- the deferred parts, each by the whole CTA
    const int nd = min(n_def, DEFER_CAP);
    if (nd > 0) {
        for (int e = 0; e < nd; ++e) {
            const int4 dp = def_s[e];
            for (int i = tid; i < dp.y; i += FUSED_THREADS) put(out_h, dp.x + i, Codec::part_byte(dp.z, dp.w, i), mrel);
        }
        __syncthreads();
    }

    // -- [my_base, end) to device memory: 16-byte stores, the two edges
    //    byte by byte (a neighbouring CTA writes the rest of those words)
    const int rlen = min(end, a.m) - my_base;
    for (int j = tid; 16 * j < h + rlen; j += FUSED_THREADS) {
        const int o0 = 16 * j - h;
        if (o0 >= 0 && o0 + 16 <= rlen) {
            *reinterpret_cast<uint4*>(dst + my_base + o0) = *reinterpret_cast<const uint4*>(img + 16 * j);
        } else {
            for (int o = o0 > 0 ? o0 : 0; o < o0 + 16 && o < rlen; ++o) dst[my_base + o] = out_h[o];
        }
    }
}

// no work: a launch of it at the fused kernel's grid, cluster and shared
// memory is the least time a launch of that kernel can take
__global__ void fused_empty_kernel() {}

// Per device and instantiation, once: the dynamic shared memory the
// kernel may opt in to (returned in *limit) and (C = 16) the
// non-portable cluster size.
template <class Codec, int C>
static cudaError_t fused_setup(int dev, int* limit) {
    static std::mutex mu;
    static int limits[MAX_DEVICES];  // 0: not yet set up
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(mu);
    *limit = limits[dev];
    if (*limit > 0) return cudaSuccess;
    int optin = 0;
    cudaFuncAttributes fa;
    cudaError_t e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, fused_kernel<Codec, C>);
    for (const void* f : {(const void*)fused_kernel<Codec, C>, (const void*)fused_empty_kernel}) {
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, optin - (int)fa.sharedSizeBytes);
        if (e == cudaSuccess && C > 8) e = cudaFuncSetAttribute(f, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (e == cudaSuccess) *limit = limits[dev] = optin - (int)fa.sharedSizeBytes;
    return e;
}

template <int C>
static cudaLaunchConfig_t cluster_config(i64 b_n, int smem, cudaStream_t s, cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(b_n * C));
    cfg.blockDim = dim3(FUSED_THREADS);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// How many clusters of the kernel can be resident at once (0: none fits,
// also where a CTA's shared memory exceeds the card's).
template <class Codec, int C>
static cudaError_t fused_clusters(int n, int offset, int* count) {
    int dev = 0, limit = 0;
    *count = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = fused_setup<Codec, C>(dev, &limit);
    const int bytes = Layout<Codec>(n, offset, C).bytes;
    if (e != cudaSuccess || bytes > limit) return e;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = cluster_config<C>(1, bytes, 0, attr);
    return cudaOccupancyMaxActiveClusters(count, fused_kernel<Codec, C>, &cfg);
}

// The checks of a launch: the bucket, the keys a CTA sorts, the cluster's
// residency (checked once per shape, then remembered).
template <class Codec, int C>
static cudaError_t fused_check(int n, int offset) {
    if (n % CELL || n < CELL || n > MAX_N || offset < 0 || cdiv(n, C) > max_kpt(C) * FUSED_THREADS)
        return cudaErrorInvalidValue;
    static std::mutex mu;
    static std::set<std::tuple<int, int, int>> seen;  // (device, n, offset) found resident
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    std::lock_guard<std::mutex> lock(mu);
    if (seen.count({dev, n, offset})) return cudaSuccess;
    int count = 0;
    e = fused_clusters<Codec, C>(n, offset, &count);
    if (e != cudaSuccess) return e;
    if (count < 1) return cudaErrorInvalidConfiguration;
    seen.insert({dev, n, offset});
    return cudaSuccess;
}

template <class Codec, int C>
static cudaError_t launch_fused(const FusedArgs& a, i64 b_n, cudaStream_t s) {
    cudaError_t e = fused_check<Codec, C>(a.n, a.offset);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = cluster_config<C>(b_n, Layout<Codec>(a.n, a.offset, C).bytes, s, attr);
    e = cudaLaunchKernelEx(&cfg, fused_kernel<Codec, C>, a);
    return e != cudaSuccess ? e : cudaGetLastError();
}

template <class Codec, int C>
static cudaError_t launch_empty(i64 b_n, int n, int offset, cudaStream_t s) {
    cudaError_t e = fused_check<Codec, C>(n, offset);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = cluster_config<C>(b_n, Layout<Codec>(n, offset, C).bytes, s, attr);
    e = cudaLaunchKernelEx(&cfg, fused_empty_kernel);
    return e != cudaSuccess ? e : cudaGetLastError();
}

#define BY_CLUSTER(C, CALL)                   \
    switch (C) {                              \
        case 2: return (int)CALL(2);          \
        case 4: return (int)CALL(4);          \
        case 8: return (int)CALL(8);          \
        case 16: return (int)CALL(16);        \
        default: return (int)cudaErrorInvalidValue; \
    }

// the entries' codec argument
enum { CODEC_LZ4, CODEC_SNAPPY };

template <class Codec>
static int fused_entry(const uint8_t* data, const int32_t* valid, const uint32_t* consts, i64* crc, uint8_t* out,
                       int32_t* out_len, i64 b_n, i64 stride, i64 offset, i64 n, i64 m, i64 piece, i64 k_units,
                       i64 c, void* stream) {
    if (b_n <= 0) return 0;
    if (m < 1 || m > MAX_OUT || k_units < 1 || piece < 1 || piece > k_units * FUSED_THREADS ||
        piece * c < (offset + n + 15) / 16 || stride < offset + n + CELL || b_n * c > 0x7FFFFFFF)
        return (int)cudaErrorInvalidValue;
    const FusedArgs a{data, valid, consts, crc, out, out_len, stride, (int)offset, (int)n, (int)m, (int)piece,
                      (int)k_units};
#define FUSED_CALL(C) launch_fused<Codec, C>(a, b_n, (cudaStream_t)stream)
    BY_CLUSTER((int)c, FUSED_CALL)
#undef FUSED_CALL
}

template <class Codec>
static int empty_entry(i64 b_n, i64 offset, i64 n, i64 c, void* stream) {
#define EMPTY_CALL(C) launch_empty<Codec, C>(b_n, (int)n, (int)offset, (cudaStream_t)stream)
    BY_CLUSTER((int)c, EMPTY_CALL)
#undef EMPTY_CALL
}

template <class Codec>
static int shape_entry(i64 offset, i64 n, i64 c, int32_t* smem_clusters) {
    smem_clusters[0] = 0;
    smem_clusters[1] = 0;
#define SHAPE_CALL(C) \
    (smem_clusters[0] = Layout<Codec>((int)n, (int)offset, C).bytes, \
     fused_clusters<Codec, C>((int)n, (int)offset, smem_clusters + 1))
    BY_CLUSTER((int)c, SHAPE_CALL)
#undef SHAPE_CALL
}

extern "C" {

const char* rp_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// consts (ops/fused.py crc_consts): the slice-by-4 tables, then the
// operators for the CRC's `piece` units a CTA and k_units a thread (a
// row of offset + n bytes needs piece * c units). The CRC covers [0, offset + v)
// of each row, the body is read at [offset, offset + n + CELL); out: B*m
// bytes, m = the codec's out_bound(n).
int rp_fused_lz4(const uint8_t* data, const int32_t* valid, const uint32_t* consts, i64* crc, uint8_t* out,
                 int32_t* out_len, i64 b_n, i64 stride, i64 offset, i64 n, i64 m, i64 piece, i64 k_units,
                 i64 c, void* stream) {
    return fused_entry<Lz4>(data, valid, consts, crc, out, out_len, b_n, stride, offset, n, m, piece, k_units, c,
                            stream);
}

// the same with snappy's elements for the block
int rp_fused_snappy(const uint8_t* data, const int32_t* valid, const uint32_t* consts, i64* crc, uint8_t* out,
                    int32_t* out_len, i64 b_n, i64 stride, i64 offset, i64 n, i64 m, i64 piece, i64 k_units,
                    i64 c, void* stream) {
    return fused_entry<Snappy>(data, valid, consts, crc, out, out_len, b_n, stride, offset, n, m, piece, k_units,
                               c, stream);
}

// an empty kernel at the codec's (CODEC_*) fused grid, cluster and shared memory
int rp_fused_empty(i64 b_n, i64 offset, i64 n, i64 c, i64 codec, void* stream) {
    if (codec == CODEC_SNAPPY) return empty_entry<Snappy>(b_n, offset, n, c, stream);
    return codec == CODEC_LZ4 ? empty_entry<Lz4>(b_n, offset, n, c, stream) : (int)cudaErrorInvalidValue;
}

// the codec's kernel's dynamic shared memory and resident clusters at a
// shape (0 clusters where its shared memory does not fit)
int rp_fused_shape(i64 offset, i64 n, i64 c, i64 codec, int32_t* smem_clusters) {
    if (codec == CODEC_SNAPPY) return shape_entry<Snappy>(offset, n, c, smem_clusters);
    return codec == CODEC_LZ4 ? shape_entry<Lz4>(offset, n, c, smem_clusters) : (int)cudaErrorInvalidValue;
}

}  // extern "C"
