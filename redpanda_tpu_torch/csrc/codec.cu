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
// cell_parse — one block of 1024 threads per row. What bounds it: the
// latest-occurrence walk. Each position's candidate is the largest
// earlier position with the same 16-bit 4-gram hash; the JAX program gets
// it from a sort of (hash << 17 | pos) keys, which is exactly a
// latest-occurrence table. The block keeps that table (2^16 uint16, 128
// KiB) and the row (<= 64 KiB + 16) in shared memory, and one warp walks
// the row in 32-position tiles: __match_any_sync finds same-hash lanes
// inside a tile, the rest read the table, and each hash's last lane
// writes it. That walk is sequential, v / 32 dependent steps, so the
// parse is latency-bound, one row per SM (the shared memory allows no
// second block). Only positions <= v are walked: past v the row is
// zeros, so cand[p] = p - 1 there, which is what the sort gives. The
// candidates go to a global scratch row and come back into the table's
// space; then every thread verifies cells (first good position of the 13
// eligible ones, chain of 3 candidates in the order g1, g2, g3), and the
// absorption and literal attribution run as block scans (reverse
// exclusive min, exclusive max) over the cells, written by hand with warp
// shuffles.
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
#define TABLE_SIZE 65536
#define NO_CAND 0xFFFFu
#define MAX_N 65536
#define MAX_CELLS (MAX_N / CELL)
#define PARSE_THREADS 1024
#define PARSE_ITEMS (MAX_CELLS / PARSE_THREADS)
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

__host__ __device__ constexpr int parse_smem_bytes(int n) {
    // table / candidates, row bytes, offs, has, j
    return TABLE_SIZE * 2 + (n + CELL) + (n / CELL) * (4 + 1 + 1);
}

__global__ void __launch_bounds__(PARSE_THREADS, 1)
cell_parse_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ valid,
                  uint8_t* __restrict__ has_out, int32_t* __restrict__ mstart_out,
                  int32_t* __restrict__ offs_out, int32_t* __restrict__ mlen_out,
                  int32_t* __restrict__ lit_start_out, int32_t* __restrict__ lit_len_out,
                  int32_t* __restrict__ last_end_out, uint16_t* __restrict__ cand_g,
                  i64 stride, i64 offset, int n) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int scan_sh[32];
    uint16_t* table = (uint16_t*)smem;  // last-seen table, then cand[]
    uint8_t* d = smem + TABLE_SIZE * 2;
    const int nc = n / CELL;
    int32_t* offs_s = (int32_t*)(d + n + CELL);  // n + CELL is a multiple of 16
    uint8_t* has_s = (uint8_t*)(offs_s + nc);
    uint8_t* j_s = has_s + nc;

    const int tid = threadIdx.x, lane = tid & 31;
    const i64 row = blockIdx.x;
    const uint8_t* src = data + row * stride + offset;
    int v = valid[row];
    v = v < 0 ? 0 : (v > n ? n : v);
    const int walk_end = v + 1 < n ? v + 1 : n;
    uint16_t* cand_row = cand_g + row * n;

    uint32_t* t32 = (uint32_t*)table;
    for (int i = tid; i < TABLE_SIZE / 2; i += PARSE_THREADS) t32[i] = FULL;
    for (int i = tid; i < n + CELL; i += PARSE_THREADS) d[i] = src[i];
    __syncthreads();

    // -- latest-occurrence walk (warp 0): cand[p] for p < walk_end
    if (tid < 32) {
        for (int base = 0; base < walk_end; base += 32) {
            const int p = base + lane;
            const bool act = p < walk_end;
            uint32_t key = 0x10000u + lane;  // unique for idle lanes
            if (act) {
                const uint32_t gram = (uint32_t)d[p] | ((uint32_t)d[p + 1] << 8) |
                                      ((uint32_t)d[p + 2] << 16) | ((uint32_t)d[p + 3] << 24);
                key = (gram * 2654435761u) >> 16;
            }
            const unsigned peers = __match_any_sync(FULL, key);
            const unsigned below = peers & ((1u << lane) - 1u);
            uint32_t cand = NO_CAND;
            if (act) cand = below ? (uint32_t)(base + 31 - __clz(below)) : table[key];
            __syncwarp();
            const unsigned above = peers & ~((2u << lane) - 1u);
            if (act) {
                if (above == 0u) table[key] = (uint16_t)p;
                cand_row[p] = (uint16_t)cand;
            }
            __syncwarp();
        }
    }
    __syncthreads();
    for (int p = tid; p < walk_end; p += PARSE_THREADS) table[p] = cand_row[p];
    __syncthreads();
    const uint16_t* cand_s = table;
    auto cand_at = [&](int p) -> int {
        if (p < 0) return -1;
        if (p >= walk_end) return p - 1;  // zeros past v: the previous position
        const uint32_t c = cand_s[p];
        return c == NO_CAND ? -1 : (int)c;
    };
    auto verify = [&](int p, int q, int cap) -> bool {
        if (q < 0) return false;
        for (int k = 0; k < cap; ++k)
            if (d[p + k] != d[q + k]) return false;
        return true;
    };

    // -- per cell: first position whose match runs to the cell end
    for (int c = tid; c < nc; c += PARSE_THREADS) {
        const int cstart = c * CELL, cell_end = cstart + CELL;
        int j = 0, sel = -1;
        bool found = false;
        if (cell_end <= v - TAIL_GUARD) {
            for (int jj = 0; jj <= CELL - 4 && !found; ++jj) {
                const int p = cstart + jj, cap = CELL - jj;
                const int c1 = cand_at(p);
                const int c2 = c1 >= 0 ? cand_at(c1) : -1;
                const int c3 = c2 >= 0 ? cand_at(c2) : -1;
                if (verify(p, c1, cap)) sel = c1, found = true;
                else if (verify(p, c2, cap)) sel = c2, found = true;
                else if (verify(p, c3, cap)) sel = c3, found = true;
                if (found) j = jj;
            }
        }
        if (!found) {  // the JAX program's offs for a cell without a match
            const int c1 = cand_at(cstart);
            const int c2 = c1 >= 0 ? cand_at(c1) : -1;
            sel = c2 >= 0 ? cand_at(c2) : -1;
        }
        has_s[c] = found;
        j_s[c] = (uint8_t)j;
        offs_s[c] = cstart + j - sel;
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

// has: B*nc bytes (torch.bool); cand: B*n uint16 scratch
int rp_cell_parse(const uint8_t* data, const int32_t* valid, uint8_t* has, int32_t* mstart,
                  int32_t* offs, int32_t* mlen, int32_t* lit_start, int32_t* lit_len,
                  int32_t* last_end, uint16_t* cand, i64 b_n, i64 stride, i64 offset, i64 n,
                  void* stream) {
    if (b_n <= 0) return 0;
    if (n % CELL || n < CELL || n > MAX_N) return (int)cudaErrorInvalidValue;
    const int smem = parse_smem_bytes((int)n);
    cudaError_t e = cudaFuncSetAttribute(cell_parse_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    cell_parse_kernel<<<(unsigned)b_n, PARSE_THREADS, smem, (cudaStream_t)stream>>>(data, valid, has, mstart, offs, mlen, lit_start,
                                                lit_len, last_end, cand, stride, offset, (int)n);
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
