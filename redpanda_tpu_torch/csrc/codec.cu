// Device LZ4 / snappy compression: the cell-grid LZ77 parse and the two
// codecs' block emission.
//
// Replaces, from the JAX package:
//   rp_cell_parse   redpanda_tpu/ops/cellparse.py:30 cell_parse
//   rp_lz4_emit     redpanda_tpu/ops/lz4.py:59 _compress_chunks (emission)
//   rp_snappy_emit  redpanda_tpu/ops/snappy.py:52 _compress_chunks (emission)
// and with csrc/crc32c.cu the fused programs of ops/fused.py:42 and :69.
//
// Every row holds its input at columns [offset, offset + n + CELL) of a
// [B, stride] uint8 matrix, zero past its valid length v <= n <= 65536.
// The fused path passes the uploaded [40-byte CRC prefix | body] rows
// with offset 40, so the body is read in place.
//
// cell_parse — one block of 1024 threads per row. Each position's candidate
// is the largest earlier position with the same 16-bit 4-gram hash; the
// JAX program gets it from a sort of (hash << 17 | pos) keys and each
// key's predecessor in sorted order. The kernel does that sort with the
// whole block: a stable LSD radix sort of the positions [0, walk_end) by
// hash, two passes of 8-bit digits, each of the 32 warps owning a
// contiguous run of the pass's input, all warps at once:
//   * count: one shared atomicAdd per key into its warp's digit count (the
//     order within a warp does not matter for a count);
//   * a block scan over (digit, warp), digit-major, turns the counts into
//     offsets;
//   * scatter, 32 keys a tile, in order: each key ORs its lane bit into its
//     digit's lane mask, which sits beside the digit's running offset, so
//     one 8-byte shared read gives a key's peers and their offset; it lands
//     at the offset plus the popcount of its lower peers, and the lowest
//     peer clears the mask and advances the offset;
//   * the keys, (hash << 16 | pos), go through a global scratch row (two
//     [n] uint32 buffers per row, L2-resident at one row), the next tile's
//     keys loaded while a tile works.
// Positions go in in order, so the sort is stable and ties fall as in the
// JAX sort; then cand[sp[i]] = sp[i-1] where the hashes agree. No step is
// sequential over the row. __match_any_sync, which the first version of
// this sort used for the peers, costs more the more distinct digits a tile
// holds (a row whose 4-grams are all distinct took three times the
// one-byte row); the atomics cost the same for any digits. Only positions
// <= v are sorted: past v the row is zeros, so cand[p] = p - 1 there,
// which is what the full sort gives.
// The verification runs one thread per position (a cell's 16 positions
// are 16 lanes of one warp, so the row's bytes and the candidates are read
// without bank conflicts): the three candidates in the order g1, g2, g3,
// each looked up only if the one before it fails, each compared four
// bytes at a time from the cell end (the cell's words aligned, the
// candidate's funnel-shifted); a half-warp ballot then picks the cell's
// first good position. A thread per cell, walking its positions with an
// early exit, let a warp wait for its slowest cell and hit each shared
// bank from four to eight lanes at once. Absorption and literal
// attribution run as block scans (reverse exclusive min, exclusive max)
// over the cells, written by hand with warp shuffles.
// What bounds it now: per-tile latency in the scatter sweeps and the
// verification's shared-memory reads; at one row the block works alone on
// one SM. Shared memory: the candidates or the digit entries max(2n,
// 64.3 KiB), the row n + 16, the cell arrays 6 n / 16: 216 KiB at
// n = 65536, 110 KiB at n = 32768.
//
// lz4_emit / snappy_emit — one block of 512 threads per row. They are
// bound by bytes: every parse field read once, the literal bytes read
// once and the block written once. The block scans the per-cell sequence
// sizes into start offsets in shared memory (hand-written warp-shuffle
// scan), then each thread produces 16 consecutive output bytes per
// round: a binary search finds the sequence holding its first byte and
// it walks forward from there. This is the JAX program's "every output
// byte finds its (sequence, role) by searchsorted" with one search per 16
// bytes instead of one per byte; the bytes on [0, out_len) are the same.
// Bytes of a row past out_len are not written.

#include <cuda_runtime.h>
#include <stdint.h>

typedef long long i64;

#define CELL 16
#define TAIL_GUARD 12
#define NO_CAND 0xFFFFu
#define MAX_N 65536
#define MAX_CELLS (MAX_N / CELL)
#define PARSE_THREADS 1024
#define PARSE_ITEMS (MAX_CELLS / PARSE_THREADS)
#define SORT_WARPS (PARSE_THREADS / 32)
#define CNT_STRIDE 257  // per-warp digit entries, padded so warps fall in other banks
// an entry is two words: the lanes of the current tile with this digit
// (a mask), and the digit's count, then its running offset
#define CNT_BYTES (SORT_WARPS * CNT_STRIDE * 8)
#define EMIT_THREADS 512
#define EMIT_ITEMS (MAX_CELLS / EMIT_THREADS)
#define EMIT_BYTES 16
#define FULL 0xFFFFFFFFu

struct OpMin { __device__ int operator()(int a, int b) const { return a < b ? a : b; } };
struct OpMax { __device__ int operator()(int a, int b) const { return a > b ? a : b; } };
struct OpAdd { __device__ int operator()(int a, int b) const { return a + b; } };

// Exclusive scan of one value per thread over the block, in thread order
// (prefix) or in reverse thread order (suffix). `sh` holds 32 ints.
template <bool SUFFIX, class Op>
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
    __syncthreads();  // sh is reused by the next scan
    return op(warp_excl, te);
}

static_assert(PARSE_THREADS == 4 * 256, "the offset scan gives each thread 8 entries of one digit");
static_assert(CNT_BYTES % 16 == 0, "the row after the counters stays 16-byte aligned");

// bytes of the candidate region: cand[n] uint16, or the digit entries while sorting
__host__ __device__ constexpr int cand_bytes(int n) { return 2 * n > CNT_BYTES ? 2 * n : CNT_BYTES; }

__host__ __device__ constexpr int parse_smem_bytes(int n) {
    // candidates / counters, row bytes, offs, has, j
    return cand_bytes(n) + (n + CELL) + (n / CELL) * (4 + 1 + 1);
}

// pass 0 reads (hash << 16 | pos) keys from the row, pass 1 the scratch row
template <bool FROM_ROW>
__device__ __forceinline__ uint32_t sort_key(const uint8_t* d, const uint32_t* in, int i) {
    if (!FROM_ROW) return in[i];
    const uint32_t gram = (uint32_t)d[i] | ((uint32_t)d[i + 1] << 8) |
                          ((uint32_t)d[i + 2] << 16) | ((uint32_t)d[i + 3] << 24);
    return ((gram * 2654435761u) >> 16) << 16 | (uint32_t)i;
}

// One stable counting pass of the block's radix sort: the keys of
// [0, walk_end) (this warp owns [r0, r1)) go to `out` ordered by the 8-bit
// digit at `shift`, ties in input order.
template <bool FROM_ROW>
__device__ void radix_pass(const uint8_t* d, const uint32_t* in, uint32_t* out, uint32_t* ent,
                           int shift, int r0, int r1, int* scan_sh) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned lower = (1u << lane) - 1u;
    uint32_t* we = ent + warp * CNT_STRIDE * 2;  // this warp's entries: (mask, count / offset)
    for (int i = tid; i < SORT_WARPS * CNT_STRIDE * 2; i += PARSE_THREADS) ent[i] = 0;
    __syncthreads();
    // count: the order within a warp does not matter here, so one shared
    // atomic per key (keys of the next tile loaded while this one counts)
    uint32_t nk = r0 + lane < r1 ? sort_key<FROM_ROW>(d, in, r0 + lane) : 0u;
    for (int base = r0; base < r1; base += 32) {
        const int i = base + lane;
        const uint32_t key = nk;
        if (i + 32 < r1) nk = sort_key<FROM_ROW>(d, in, i + 32);
        if (i < r1) atomicAdd(&we[2 * ((key >> shift) & 255u) + 1], 1u);
    }
    __syncthreads();
    {  // exclusive offsets over (digit, warp), digit-major
        const int dig = tid >> 2, w0 = (tid & 3) * (SORT_WARPS / 4);
        uint32_t c[SORT_WARPS / 4];
        int sum = 0;
#pragma unroll
        for (int k = 0; k < SORT_WARPS / 4; ++k) sum += c[k] = ent[((w0 + k) * CNT_STRIDE + dig) * 2 + 1];
        int run = block_scan_excl<false>(sum, OpAdd(), 0, scan_sh);
#pragma unroll
        for (int k = 0; k < SORT_WARPS / 4; ++k) {
            ent[((w0 + k) * CNT_STRIDE + dig) * 2 + 1] = run;
            run += c[k];
        }
    }
    __syncthreads();
    // scatter, stable: each key ORs its lane bit into its digit's mask, so
    // one 8-byte read gives the peers with its digit and their offset; the
    // lowest of them clears the mask and advances the offset
    nk = r0 + lane < r1 ? sort_key<FROM_ROW>(d, in, r0 + lane) : 0u;
    for (int base = r0; base < r1; base += 32) {
        const int i = base + lane;
        const bool act = i < r1;
        const uint32_t key = nk;
        if (i + 32 < r1) nk = sort_key<FROM_ROW>(d, in, i + 32);
        uint32_t* e = we + 2 * ((key >> shift) & 255u);
        if (act) atomicOr(e, 1u << lane);
        __syncwarp();
        const uint2 pe = act ? *reinterpret_cast<const uint2*>(e) : make_uint2(0u, 0u);
        if (act) out[pe.y + __popc(pe.x & lower)] = key;
        __syncwarp();
        if (act && (pe.x & lower) == 0u) *reinterpret_cast<uint2*>(e) = make_uint2(0u, pe.y + __popc(pe.x));
        __syncwarp();
    }
    __syncthreads();  // the scratch row and the entries are read next
}

__global__ void __launch_bounds__(PARSE_THREADS, 1)
cell_parse_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ valid,
                  uint8_t* __restrict__ has_out, int32_t* __restrict__ mstart_out,
                  int32_t* __restrict__ offs_out, int32_t* __restrict__ mlen_out,
                  int32_t* __restrict__ lit_start_out, int32_t* __restrict__ lit_len_out,
                  int32_t* __restrict__ last_end_out, uint32_t* __restrict__ keys_g,
                  i64 stride, i64 offset, int n) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int scan_sh[32];
    uint16_t* cand_w = (uint16_t*)smem;  // cand[], after the sort
    uint32_t* ent = (uint32_t*)smem;     // digit entries, during the sort
    uint8_t* d = smem + cand_bytes(n);
    const int nc = n / CELL;
    int32_t* offs_s = (int32_t*)(d + n + CELL);  // n + CELL is a multiple of 16
    uint8_t* has_s = (uint8_t*)(offs_s + nc);
    uint8_t* j_s = has_s + nc;

    const int tid = threadIdx.x;
    const i64 row = blockIdx.x;
    const uint8_t* src = data + row * stride + offset;
    int v = valid[row];
    v = v < 0 ? 0 : (v > n ? n : v);
    const int walk_end = v + 1 < n ? v + 1 : n;

    for (int i = tid; i < n + CELL; i += PARSE_THREADS) d[i] = src[i];
    __syncthreads();

    // -- stable radix sort of [0, walk_end) by hash, then sorted predecessors
    uint32_t* ka = keys_g + row * 2 * n;
    uint32_t* kb = ka + n;
    const int run = (walk_end + SORT_WARPS * 32 - 1) / (SORT_WARPS * 32) * 32;
    const int w = tid >> 5;
    const int r0 = w * run < walk_end ? w * run : walk_end;
    const int r1 = r0 + run < walk_end ? r0 + run : walk_end;
    radix_pass<true>(d, nullptr, ka, ent, 16, r0, r1, scan_sh);
    radix_pass<false>(d, ka, kb, ent, 24, r0, r1, scan_sh);
    for (int i = tid; i < walk_end; i += PARSE_THREADS) {
        const uint32_t key = kb[i];
        uint32_t c = NO_CAND;
        if (i > 0) {
            const uint32_t prev = kb[i - 1];
            if ((prev >> 16) == (key >> 16)) c = prev & 0xFFFFu;
        }
        cand_w[key & 0xFFFFu] = (uint16_t)c;
    }
    __syncthreads();
    const uint16_t* cand_s = cand_w;
    auto cand_at = [&](int p) -> int {
        if (p < 0) return -1;
        if (p >= walk_end) return p - 1;  // zeros past v: the previous position
        const uint32_t c = cand_s[p];
        return c == NO_CAND ? -1 : (int)c;
    };
    const uint32_t* d32 = reinterpret_cast<const uint32_t*>(d);
    // d[p, e) == d[q, q + e - p) for a cell end e (16-aligned, <= v - 12,
    // so every word read lies inside the row), four bytes at a time from
    // the end: the cell's words are aligned, the candidate's funnel-shifted
    auto verify = [&](int p, int q, int e) -> bool {
        if (q < 0) return false;
        const int back = e - p;  // bytes to compare, 4..16
        for (int k = 4; k < back + 4; k += 4) {
            const int at = q + back - k;  // below q (even below 0) on the last word: masked
            const uint32_t qw = at >= 0 ? __funnelshift_r(d32[at >> 2], d32[(at >> 2) + 1], (at & 3) * 8)
                                        : d32[0] << (-8 * at);
            uint32_t x = d32[(e - k) >> 2] ^ qw;
            if (k > back) x &= ~0u << (8 * (k - back));
            if (x) return false;
        }
        return true;
    };

    // -- per cell: the first position whose match runs to the cell end. One
    //    thread per position (a cell's 16 positions are 16 lanes of one
    //    warp): its candidates in the order g1, g2, g3, each looked up only
    //    if the one before it fails; then a ballot picks the cell's first
    //    good position
    const int lane = tid & 31;
    for (int base = 0; base < n; base += PARSE_THREADS) {
        const int p = base + tid;
        const int jj = p & (CELL - 1), cstart = p - jj;
        int sel = -1;
        if (p < n && jj <= CELL - 4 && cstart + CELL <= v - TAIL_GUARD) {
            const int c1 = cand_at(p);
            if (verify(p, c1, cstart + CELL)) {
                sel = c1;
            } else if (c1 >= 0) {
                const int c2 = cand_at(c1);
                if (verify(p, c2, cstart + CELL)) {
                    sel = c2;
                } else if (c2 >= 0) {
                    const int c3 = cand_at(c2);
                    if (verify(p, c3, cstart + CELL)) sel = c3;
                }
            }
        }
        const unsigned good = (__ballot_sync(FULL, sel >= 0) >> (lane & 16)) & 0xFFFFu;
        const int j = good ? __ffs(good) - 1 : 0;
        const int sel_j = __shfl_sync(FULL, sel, (lane & 16) + j);
        if (p < n && jj == 0) {
            const int c = p / CELL;
            has_s[c] = good != 0;
            j_s[c] = (uint8_t)j;
            if (good) {
                offs_s[c] = cstart + j - sel_j;
            } else {  // the JAX program's offs for a cell without a match
                const int c1 = cand_at(cstart);
                const int c2 = c1 >= 0 ? cand_at(c1) : -1;
                offs_s[c] = cstart - (c2 >= 0 ? cand_at(c2) : -1);
            }
        }
    }
    __syncthreads();

    // -- absorption, run ends, literal attribution (block scans)
    const int c0 = tid * PARSE_ITEMS;
    bool head[PARSE_ITEMS];
    int bnd[PARSE_ITEMS], jv[PARSE_ITEMS];
    int agg_min = nc;
#pragma unroll
    for (int i = 0; i < PARSE_ITEMS; ++i) {
        const int c = c0 + i;
        bool h = false, ab = false;
        jv[i] = 0;
        if (c < nc) {
            h = has_s[c];
            jv[i] = j_s[c];
            ab = c > 0 && h && has_s[c - 1] && jv[i] == 0 && offs_s[c] == offs_s[c - 1];
        }
        head[i] = h && !ab;
        bnd[i] = (c < nc && !ab) ? c : nc;
        agg_min = bnd[i] < agg_min ? bnd[i] : agg_min;
    }
    const int after = block_scan_excl<true>(agg_min, OpMin(), nc, scan_sh);
    int nb[PARSE_ITEMS], contrib[PARSE_ITEMS];
    int agg_max = 0;
    {
        int run = after;
#pragma unroll
        for (int i = PARSE_ITEMS - 1; i >= 0; --i) {
            nb[i] = run;
            run = bnd[i] < run ? bnd[i] : run;
        }
    }
#pragma unroll
    for (int i = 0; i < PARSE_ITEMS; ++i) {
        contrib[i] = head[i] ? nb[i] * CELL : 0;
        agg_max = contrib[i] > agg_max ? contrib[i] : agg_max;
    }
    int prev_end = block_scan_excl<false>(agg_max, OpMax(), 0, scan_sh);
    const i64 ob = row * nc;
#pragma unroll
    for (int i = 0; i < PARSE_ITEMS; ++i) {
        const int c = c0 + i;
        if (c >= nc) break;
        const int mstart = c * CELL + jv[i];
        has_out[ob + c] = head[i];
        mstart_out[ob + c] = mstart;
        offs_out[ob + c] = offs_s[c];
        mlen_out[ob + c] = head[i] ? (nb[i] - c) * CELL - jv[i] : 0;
        lit_start_out[ob + c] = prev_end;
        lit_len_out[ob + c] = head[i] ? mstart - prev_end : 0;
        prev_end = contrib[i] > prev_end ? contrib[i] : prev_end;
        if (c == nc - 1) last_end_out[row] = prev_end;
    }
}

// ------------------------------------------------------------ emission
struct Lz4 {
    static __device__ int n_extra(int len) { return len >= 15 ? (len - 15) / 255 + 1 : 0; }
    static __device__ int extra_byte(int len, int i) {
        int x = len - 15 - 255 * i;
        return x < 0 ? 0 : (x > 255 ? 255 : x);
    }
    static __device__ int size(bool has, int lit, int mlen) {
        return has ? 1 + n_extra(lit) + lit + 2 + n_extra(mlen - 4) : 0;
    }
    static __device__ int final_size(int f_lit) { return 1 + n_extra(f_lit) + f_lit; }
    // byte r of a sequence; lit_at(i) is the i-th literal of its run
    template <class Lit>
    static __device__ int seq_byte(int r, int lit, int mlen, int offs, Lit lit_at) {
        const int a1 = 1 + n_extra(lit), a2 = a1 + lit;
        if (r == 0) {
            const int ml = mlen - 4 < 0 ? 0 : (mlen - 4 > 15 ? 15 : mlen - 4);
            return ((lit < 15 ? lit : 15) << 4) | ml;
        }
        if (r < a1) return extra_byte(lit, r - 1);
        if (r < a2) return lit_at(r - a1);
        if (r == a2) return offs & 255;
        if (r == a2 + 1) return (offs >> 8) & 255;
        return extra_byte(mlen - 4, r - (a2 + 2));
    }
    template <class Lit>
    static __device__ int final_byte(int fo, int f_lit, Lit lit_at) {
        const int a1 = 1 + n_extra(f_lit);
        if (fo == 0) return (f_lit < 15 ? f_lit : 15) << 4;
        if (fo < a1) return extra_byte(f_lit, fo - 1);
        return lit_at(fo - a1);
    }
};

struct Snappy {
    static __device__ int lit_extra(int len) { return len <= 60 ? 0 : (len <= 256 ? 1 : 2); }
    static __device__ int lit_size(int lit) { return lit > 0 ? 1 + lit_extra(lit) + lit : 0; }
    static __device__ int size(bool has, int lit, int mlen) {
        return has ? lit_size(lit) + 3 * ((mlen + 63) / 64) : 0;
    }
    static __device__ int final_size(int f_lit) { return lit_size(f_lit); }
    template <class Lit>
    static __device__ int lit_byte(int r, int len, Lit lit_at) {
        const int ex = lit_extra(len);
        if (r == 0) return ex == 0 ? (len - 1) << 2 : (ex == 1 ? 60 << 2 : 61 << 2);
        if (r - 1 < ex) return ((len - 1) >> (8 * (r - 1))) & 255;
        return lit_at(r - 1 - ex);
    }
    template <class Lit>
    static __device__ int seq_byte(int r, int lit, int mlen, int offs, Lit lit_at) {
        const int ls = lit_size(lit);
        if (r < ls) return lit_byte(r, lit, lit_at);
        const int c = r - ls, ci = c / 3, role = c - 3 * ci;
        int clen = mlen - 64 * ci;
        clen = clen < 1 ? 1 : (clen > 64 ? 64 : clen);
        if (role == 0) return 2 | ((clen - 1) << 2);
        return role == 1 ? offs & 255 : (offs >> 8) & 255;
    }
    template <class Lit>
    static __device__ int final_byte(int fo, int f_lit, Lit lit_at) {
        return lit_byte(fo, f_lit, lit_at);
    }
};

template <class Codec>
__global__ void __launch_bounds__(EMIT_THREADS)
emit_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ valid,
            const uint8_t* __restrict__ has_in, const int32_t* __restrict__ offs_in,
            const int32_t* __restrict__ mlen_in, const int32_t* __restrict__ lit_start_in,
            const int32_t* __restrict__ lit_len_in, const int32_t* __restrict__ last_end_in,
            uint8_t* __restrict__ out, int32_t* __restrict__ out_len_out,
            i64 stride, i64 offset, int n, int m) {
    __shared__ int starts[MAX_CELLS];
    __shared__ int scan_sh[32];
    __shared__ int total_sh;
    const int tid = threadIdx.x;
    const i64 row = blockIdx.x;
    const int nc = n / CELL;
    const i64 cb = row * nc;
    const uint8_t* src = data + row * stride + offset;
    int v = valid[row];
    v = v < 0 ? 0 : (v > n ? n : v);

    // sequence sizes -> start offsets
    const int c0 = tid * EMIT_ITEMS;
    int sz[EMIT_ITEMS];
    int agg = 0;
#pragma unroll
    for (int i = 0; i < EMIT_ITEMS; ++i) {
        const int c = c0 + i;
        sz[i] = c < nc ? Codec::size(has_in[cb + c], lit_len_in[cb + c], mlen_in[cb + c]) : 0;
        agg += sz[i];
    }
    int run = block_scan_excl<false>(agg, OpAdd(), 0, scan_sh);
#pragma unroll
    for (int i = 0; i < EMIT_ITEMS; ++i) {
        const int c = c0 + i;
        if (c < nc) starts[c] = run;
        run += sz[i];
        if (c == nc - 1) total_sh = run;
    }
    __syncthreads();
    const int total = total_sh;
    const int f_start = last_end_in[row];
    const int f_lit = v - f_start > 0 ? v - f_start : 0;
    const int out_len = total + Codec::final_size(f_lit);
    if (tid == 0) out_len_out[row] = out_len;
    uint8_t* dst = out + row * (i64)m;
    const int end = out_len < m ? out_len : m;

    for (int o0 = tid * EMIT_BYTES; o0 < end; o0 += EMIT_THREADS * EMIT_BYTES) {
        int s = -1, lit = 0, mlen = 0, offs = 0, ls = 0, st = 0;
        if (o0 < total) {  // upper bound of o0 in starts, minus one
            int lo = 0, hi = nc;
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (starts[mid] <= o0) lo = mid + 1; else hi = mid;
            }
            s = lo - 1;
        }
        for (int k = 0; k < EMIT_BYTES; ++k) {
            const int o = o0 + k;
            if (o >= end) break;
            int val;
            if (o < total) {
                bool moved = k == 0;
                while (s + 1 < nc && starts[s + 1] <= o) ++s, moved = true;
                if (moved) {
                    st = starts[s];
                    lit = lit_len_in[cb + s];
                    mlen = mlen_in[cb + s];
                    offs = offs_in[cb + s];
                    ls = lit_start_in[cb + s];
                }
                const int base = ls;
                val = Codec::seq_byte(o - st, lit, mlen, offs, [&](int i) {
                    int x = base + i;
                    x = x < 0 ? 0 : (x > n - 1 ? n - 1 : x);
                    return (int)src[x];
                });
            } else {
                val = Codec::final_byte(o - total, f_lit, [&](int i) {
                    int x = f_start + i;
                    x = x < 0 ? 0 : (x > n - 1 ? n - 1 : x);
                    return (int)src[x];
                });
            }
            dst[o] = (uint8_t)val;
        }
    }
}

template <class Codec>
static int launch_emit(const uint8_t* data, const int32_t* valid, const uint8_t* has,
                       const int32_t* offs, const int32_t* mlen, const int32_t* lit_start,
                       const int32_t* lit_len, const int32_t* last_end, uint8_t* out,
                       int32_t* out_len, i64 b_n, i64 stride, i64 offset, i64 n, i64 m,
                       void* stream) {
    if (b_n <= 0) return 0;
    if (n % CELL || n < CELL || n > MAX_N) return (int)cudaErrorInvalidValue;
    emit_kernel<Codec><<<(unsigned)b_n, EMIT_THREADS, 0, (cudaStream_t)stream>>>(
        data, valid, has, offs, mlen, lit_start, lit_len, last_end, out, out_len, stride,
        offset, (int)n, (int)m);
    return (int)cudaGetLastError();
}

extern "C" {

const char* rp_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// has: B*nc bytes (torch.bool); keys: B*2*n uint32 scratch
int rp_cell_parse(const uint8_t* data, const int32_t* valid, uint8_t* has, int32_t* mstart,
                  int32_t* offs, int32_t* mlen, int32_t* lit_start, int32_t* lit_len,
                  int32_t* last_end, uint32_t* keys, i64 b_n, i64 stride, i64 offset, i64 n,
                  void* stream) {
    if (b_n <= 0) return 0;
    if (n % CELL || n < CELL || n > MAX_N) return (int)cudaErrorInvalidValue;
    const int smem = parse_smem_bytes((int)n);
    cudaError_t e = cudaFuncSetAttribute(cell_parse_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    cell_parse_kernel<<<(unsigned)b_n, PARSE_THREADS, smem, (cudaStream_t)stream>>>(data, valid, has, mstart, offs, mlen, lit_start,
                                                lit_len, last_end, keys, stride, offset, (int)n);
    return (int)cudaGetLastError();
}

int rp_lz4_emit(const uint8_t* data, const int32_t* valid, const uint8_t* has,
                const int32_t* mstart, const int32_t* offs, const int32_t* mlen,
                const int32_t* lit_start, const int32_t* lit_len, const int32_t* last_end,
                uint8_t* out, int32_t* out_len, i64 b_n, i64 stride, i64 offset, i64 n, i64 m,
                void* stream) {
    (void)mstart;
    return launch_emit<Lz4>(data, valid, has, offs, mlen, lit_start, lit_len, last_end, out,
                            out_len, b_n, stride, offset, n, m, stream);
}

int rp_snappy_emit(const uint8_t* data, const int32_t* valid, const uint8_t* has,
                   const int32_t* mstart, const int32_t* offs, const int32_t* mlen,
                   const int32_t* lit_start, const int32_t* lit_len, const int32_t* last_end,
                   uint8_t* out, int32_t* out_len, i64 b_n, i64 stride, i64 offset, i64 n,
                   i64 m, void* stream) {
    (void)mstart;
    return launch_emit<Snappy>(data, valid, has, offs, mlen, lit_start, lit_len, last_end,
                               out, out_len, b_n, stride, offset, n, m, stream);
}

}  // extern "C"
