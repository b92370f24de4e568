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
// lz4_emit / snappy_emit — one block per row (1,024 threads when the rows
// fit one block an SM, else 512 so that two blocks share an SM), the row's
// whole block built in shared memory and written out once. A JSON row's
// sequences average ~13 output bytes, so a mapping that walks output bytes
// crosses sequences all the time and pays for the role branches and the
// search on every byte. This kernel writes each byte from the side that
// knows it:
//   * the row's valid bytes are staged with 16-byte cp.async copies, issued
//     first (the unaligned head and tail by scalars: fused rows start 8
//     bytes past a 16-byte boundary);
//   * the size pass reads four cells of each field a lane with 16-byte
//     loads, 128 consecutive cells a warp load, only the cells below v; one
//     scan of (1 << 18 | size) gives every sequence its index and start;
//   * a thread per sequence writes its head bytes straight-line (token,
//     offset, length bytes; snappy's tags and copies: Lz4 / Snappy
//     put_head, the one place the byte rules live); a long regular part (an
//     LZ4 255-run, a run of snappy copies) goes to the whole block: a row
//     of one repeated byte has a single sequence;
//   * a thread per row word copies the literals: the parse's literal runs
//     and matches tile the row in order, so a cell's literals belong to the
//     run of the first sequence at or after it and move by one shift; a row
//     without sequences is one final literal run, copied by every thread;
//   * the block leaves shared memory in 16-byte stores, neighbouring
//     threads on neighbouring addresses; out's row pitch is not a multiple
//     of 16, so the block is built at the row's alignment in device memory
//     and its first and last 16 bytes go byte by byte.
// What bounds it: latency, not bytes. At one row (n = 32,768) on an H100
// 80GB HBM3 at 700 W a launch is ~5.0 us of launch floor and ~5 us of
// dependent phases on one SM: the size pass's loads and scan ~2, heads
// and literal copy ~2 (the copy issues four shared-memory operations a
// word), the flush ~0.5. Shared memory: the row n + 32, the block
// out_bound(n) + 32, 14 bytes a cell dynamic, and 4.2 KB static (the
// deferred parts): 217,616 B dynamic at n = 65,536 (snappy), 111,120 B at
// 32,768.
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "lz77.cuh"

#define PARSE_THREADS 1024
#define PARSE_ITEMS (MAX_CELLS / PARSE_THREADS)
#define SORT_WARPS (PARSE_THREADS / 32)
#define CNT_STRIDE 257  // per-warp digit entries, padded so warps fall in other banks
// an entry is two words: the lanes of the current tile with this digit
// (a mask), and the digit's count, then its running offset
#define CNT_BYTES (SORT_WARPS * CNT_STRIDE * 8)
// emission blocks: 1024 threads when the rows fit one block an SM, else 512
// (two blocks an SM, so 256 rows of 32 KiB run in one wave)
#define EMIT_WIDE 1024
#define EMIT_NARROW 512

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

// shared memory of one emission block: the staged row (shifted so that a
// 16-byte aligned source chunk lands on a 16-byte aligned address), the
// block it becomes (shifted as the output row is in device memory), per
// sequence its packed fields and its start, and per cell the number of
// sequences before it
__host__ __device__ constexpr int emit_row_bytes(int n) { return n + CELL + 16; }
__host__ __device__ constexpr int emit_out_bytes(int m) { return (m + 16 + 15) / 16 * 16; }
__host__ __device__ constexpr int emit_smem_bytes(int n, int m) {
    return emit_row_bytes(n) + emit_out_bytes(m) + (n / CELL) * (8 + 4 + 2);
}

template <class Codec, int EMIT_THREADS>
__global__ void __launch_bounds__(EMIT_THREADS, EMIT_THREADS == EMIT_NARROW ? 2 : 1)
emit_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ valid,
            const uint8_t* __restrict__ has_in, const int32_t* __restrict__ offs_in,
            const int32_t* __restrict__ mlen_in, const int32_t* __restrict__ lit_start_in,
            const int32_t* __restrict__ lit_len_in, const int32_t* __restrict__ last_end_in,
            uint8_t* __restrict__ out, int32_t* __restrict__ out_len_out,
            i64 stride, i64 offset, int n, int m, bool vec) {
    constexpr int SCAN_ITEMS = MAX_CELLS / (EMIT_THREADS * 4);  // 16-byte loads a lane makes of each field
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int scan_sh[32];
    __shared__ int total_sh, n_def;
    __shared__ int4 def_s[DEFER_CAP];  // deferred head parts (position, length, a, b)
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const i64 row = blockIdx.x;
    const int nc = n / CELL;
    const i64 cb = row * nc;
    const uint8_t* src = data + row * stride + offset;
    uint8_t* dst = out + row * (i64)m;
    const int h = (int)((uintptr_t)dst & 15);
    uint8_t* row_s = smem + ((uintptr_t)src & 15);  // row_s + i is 16-aligned where src + i is
    uint8_t* out_s = smem + emit_row_bytes(n);
    uint8_t* out_h = out_s + h;                     // out_h + o is 16-aligned where dst + o is
    uint2* seq_s = reinterpret_cast<uint2*>(out_s + emit_out_bytes(m));  // (ls | lit << 16, mlen | offs << 16)
    int* start_s = reinterpret_cast<int*>(seq_s + nc);
    uint16_t* cell_q = reinterpret_cast<uint16_t*>(start_s + nc);
    int v = valid[row];
    v = v < 0 ? 0 : (v > n ? n : v);
    const int f_start = last_end_in[row];  // loaded now, read after the size pass
    if (tid == 0) n_def = 0;

    // -- stage the row's valid bytes: 16-byte cp.async copies of the
    //    aligned middle, issued first so they overlap the size pass; the
    //    unaligned head and the tail by scalars
    const int head = min((int)((16 - ((uintptr_t)src & 15)) & 15), v);
    const int nvec = (v - head) >> 4;
    const int tail = head + 16 * nvec;
    for (int k = tid; k < nvec; k += EMIT_THREADS) cp_async16(row_s + head + 16 * k, src + head + 16 * k);
    asm volatile("cp.async.commit_group;" ::: "memory");
    if (tid < head) row_s[tid] = src[tid];
    if (tid < v - tail) row_s[tail + tid] = src[tail + tid];

    // -- sizes and starts. Only the cells below v are read: no cell at or
    //    past v holds a match (the parse's tail guard). Warp w owns the
    //    cells [w * per_warp, (w + 1) * per_warp); lane l reads four
    //    neighbouring cells of each field with one 16-byte load, so a warp
    //    reads 128 consecutive cells a load. A sequence is a cell with a
    //    match and carries (1 << 18 | size): one scan gives its index among
    //    the sequences and its start (sizes sum below 2^17, and there are at
    //    most 4,096 sequences, for n <= 65,536). A has cell's fields all fit
    //    16 bits, so they travel packed two to a word. The host clears
    //    `vec` where those loads would not be aligned (a row of cells not a
    //    multiple of four, or fields that start off a 16-byte boundary), and
    //    each lane then reads its four cells one by one.
    const int ncv = min(nc, (v + CELL - 1) / CELL);
    const int per_warp = (ncv + EMIT_THREADS * 4 - 1) / (EMIT_THREADS * 4) * 128;
    const int wc0 = warp * per_warp;
    uint32_t flo[SCAN_ITEMS][4], fhi[SCAN_ITEMS][4], pk[SCAN_ITEMS];
    unsigned hm = 0;
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i) {
        const int c = wc0 + 128 * i + 4 * lane;
        int4 a = make_int4(0, 0, 0, 0), b = a, ml = a, of = a;
        uint32_t hb = 0;
        if (128 * i < per_warp && c < ncv) {
            if (vec) {
                a = *reinterpret_cast<const int4*>(lit_start_in + cb + c);
                b = *reinterpret_cast<const int4*>(lit_len_in + cb + c);
                ml = *reinterpret_cast<const int4*>(mlen_in + cb + c);
                of = *reinterpret_cast<const int4*>(offs_in + cb + c);
                hb = *reinterpret_cast<const uint32_t*>(has_in + cb + c);
            } else {
                int *pa = &a.x, *pb = &b.x, *pm = &ml.x, *po = &of.x;
                for (int k = 0; k < 4 && c + k < nc; ++k) {
                    pa[k] = lit_start_in[cb + c + k];
                    pb[k] = lit_len_in[cb + c + k];
                    pm[k] = mlen_in[cb + c + k];
                    po[k] = offs_in[cb + c + k];
                    hb |= (uint32_t)has_in[cb + c + k] << (8 * k);
                }
            }
            if (c + 4 > ncv) hb &= 0xFFFFFFFFu >> (8 * (c + 4 - ncv));
        }
        flo[i][0] = (uint32_t)a.x | ((uint32_t)b.x << 16);
        flo[i][1] = (uint32_t)a.y | ((uint32_t)b.y << 16);
        flo[i][2] = (uint32_t)a.z | ((uint32_t)b.z << 16);
        flo[i][3] = (uint32_t)a.w | ((uint32_t)b.w << 16);
        fhi[i][0] = (uint32_t)ml.x | ((uint32_t)of.x << 16);
        fhi[i][1] = (uint32_t)ml.y | ((uint32_t)of.y << 16);
        fhi[i][2] = (uint32_t)ml.z | ((uint32_t)of.z << 16);
        fhi[i][3] = (uint32_t)ml.w | ((uint32_t)of.w << 16);
#pragma unroll
        for (int k = 0; k < 4; ++k) hm |= ((hb >> (8 * k)) & 0xFFu ? 1u : 0u) << (4 * i + k);
    }
    auto seq_pack = [&](int i, int k) -> uint32_t {
        return (hm >> (4 * i + k) & 1u)
                   ? (1u << 18) | (uint32_t)Codec::size(true, flo[i][k] >> 16, fhi[i][k] & 0xFFFFu)
                   : 0u;
    };
    uint32_t wrun = 0;
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i) {
        const uint32_t x = seq_pack(i, 0) + seq_pack(i, 1) + seq_pack(i, 2) + seq_pack(i, 3);
        uint32_t inc = x;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const uint32_t y = __shfl_up_sync(FULL, inc, o);
            if (lane >= o) inc += y;
        }
        pk[i] = wrun + inc - x;
        wrun += __shfl_sync(FULL, inc, 31);
    }
    const uint32_t base = (uint32_t)block_scan_excl<false>(lane == 31 ? (int)wrun : 0, OpAdd(), 0, scan_sh);
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i) pk[i] += base;

#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i) {
        uint32_t at = pk[i];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int c = wc0 + 128 * i + 4 * lane + k;
            if (128 * i < per_warp && c < ncv) cell_q[c] = (uint16_t)(at >> 18);
            if (hm >> (4 * i + k) & 1u) {
                start_s[at >> 18] = (int)(at & 0x3FFFFu);
                seq_s[at >> 18] = make_uint2(flo[i][k], fhi[i][k]);
                at += seq_pack(i, k);
            }
        }
    }
    if (tid == EMIT_THREADS - 1) total_sh = (int)(base + wrun);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    const int ns = total_sh >> 18, total = total_sh & 0x3FFFF;
    const int f_lit = v - f_start > 0 ? v - f_start : 0;
    const int fl0 = total + Codec::lit_head(f_lit);  // the final run's literals land at fl0
    const int out_len = total + Codec::final_size(f_lit);
    if (tid == 0) out_len_out[row] = out_len;

    // -- a thread a sequence, the final run last: its head bytes (token,
    //    length bytes, offset; snappy's tags and copies). A long regular
    //    part is deferred to the block.
    auto defer = [&](int p, int len, int a, int b) {
        const int e = atomicAdd(&n_def, 1);
        if (e < DEFER_CAP) def_s[e] = make_int4(p, len, a, b);
    };
    for (int q = tid; q <= ns; q += EMIT_THREADS) {
        int st = total, lit = f_lit, mlen = -1, offs = 0;
        if (q < ns) {
            const uint2 f = seq_s[q];
            st = start_s[q];
            lit = (int)(f.x >> 16);
            mlen = (int)(f.y & 0xFFFFu);
            offs = (int)(f.y >> 16);
        }
        Codec::put_head(out_h, st, lit, mlen, offs, m, defer);
    }

    // -- the literals. A warp takes 32 cells at a time, a lane each: its
    //    literal bytes [lo, hi) and their shift from the row to the block.
    //    The parse's literal runs and matches tile [0, v) in order, so a
    //    cell's literals belong to the run of the first sequence at or after
    //    it (the final run past the last), and the sequences before it are
    //    its scan count. A group without literals is skipped whole, else
    //    lane l copies the group's row words l, l + 32, l + 64 and l + 96
    //    (a word's cell comes by shuffle): neighbouring lanes read
    //    neighbouring words of the staged row and write neighbouring bytes
    //    of the block.
    const bool row_aligned = ((uintptr_t)row_s & 3) == 0;
    for (int g = 32 * warp; g < ncv; g += EMIT_THREADS) {
        const int c = g + lane;
        int lo = CELL, hi = CELL, delta = 0;
        if (c < ncv) {
            const int q = cell_q[c];
            int ls = f_start, lend = v, l0 = fl0;
            if (q < ns) {
                const uint32_t fx = seq_s[q].x;
                ls = (int)(fx & 0xFFFFu);
                lend = ls + (int)(fx >> 16);
                l0 = start_s[q] + Codec::lit_head((int)(fx >> 16));
            }
            lo = min(max(ls - CELL * c, 0), CELL);
            hi = min(max(lend - CELL * c, lo), CELL);
            delta = l0 - ls;
        }
        if (!__any_sync(FULL, lo < hi)) continue;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int wi = 32 * u + lane;  // the group's word: cell wi / 4, bytes 4 (wi % 4) on
            const int wlo = __shfl_sync(FULL, lo, wi >> 2), whi = __shfl_sync(FULL, hi, wi >> 2);
            const int o = CELL * g + 4 * wi + __shfl_sync(FULL, delta, wi >> 2);
            const int x = CELL * g + 4 * wi, j0 = 4 * (wi & 3);
            if (whi > j0 && wlo < j0 + 4) {
                const uint32_t w = row_aligned ? *reinterpret_cast<const uint32_t*>(row_s + x) : row_word(row_s, x);
#pragma unroll
                for (int b = 0; b < 4; ++b)
                    if (j0 + b >= wlo && j0 + b < whi && o + b < m) out_h[o + b] = (uint8_t)(w >> (8 * b));
            }
        }
    }
    __syncthreads();

    // -- the deferred parts, each by all threads: a JSON row defers none
    //    or a handful, a row of one repeated byte one part of 3,072 snappy
    //    copy bytes (a warp wrote it 3 us slower on an H100)
    const int nd = min(n_def, DEFER_CAP);
    if (nd > 0) {
        for (int e = 0; e < nd; ++e) {
            const int4 d = def_s[e];
            for (int i = tid; i < d.y; i += EMIT_THREADS) put(out_h, d.x + i, Codec::part_byte(d.z, d.w, i), m);
        }
        __syncthreads();
    }

    // -- the block to device memory: one 16-byte store a thread,
    //    neighbouring threads on neighbouring addresses; the row's first
    //    and last 16 bytes byte by byte (out's row pitch m is not a
    //    multiple of 16)
    const int end = out_len < m ? out_len : m;
    for (int j = tid; 16 * j < h + end; j += EMIT_THREADS) {
        const int o0 = 16 * j - h;
        if (o0 >= 0 && o0 + 16 <= end) {
            *reinterpret_cast<uint4*>(dst + o0) = *reinterpret_cast<const uint4*>(out_s + 16 * j);
        } else {
            for (int o = o0 > 0 ? o0 : 0; o < o0 + 16 && o < end; ++o) dst[o] = out_h[o];
        }
    }
}

// Per device, once for each codec: its SM count, and for both widths of the
// kernel the most dynamic shared memory a block of that device may opt in to.
// A launch that needs more fails and reports it.
#define MAX_DEVICES 64
template <class Codec, int THREADS>
static cudaError_t allow_smem(int optin) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, emit_kernel<Codec, THREADS>);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(emit_kernel<Codec, THREADS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                optin - (int)a.sharedSizeBytes);
}

template <class Codec>
static cudaError_t emit_device(int dev, int* sms) {
    static std::mutex mu;
    static int dev_sms[MAX_DEVICES];  // 0 until the device is set up
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(mu);
    if (dev_sms[dev] == 0) {
        int count = 0, optin = 0;
        cudaError_t e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (e == cudaSuccess) e = allow_smem<Codec, EMIT_WIDE>(optin);
        if (e == cudaSuccess) e = allow_smem<Codec, EMIT_NARROW>(optin);
        if (e != cudaSuccess) return e;
        dev_sms[dev] = count;
    }
    *sms = dev_sms[dev];
    return cudaSuccess;
}

static bool aligned(const void* p, uintptr_t to) { return ((uintptr_t)p & (to - 1)) == 0; }

template <class Codec>
static int launch_emit(const uint8_t* data, const int32_t* valid, const uint8_t* has,
                       const int32_t* offs, const int32_t* mlen, const int32_t* lit_start,
                       const int32_t* lit_len, const int32_t* last_end, uint8_t* out,
                       int32_t* out_len, i64 b_n, i64 stride, i64 offset, i64 n, i64 m,
                       void* stream) {
    if (b_n <= 0) return 0;
    if (n % CELL || n < CELL || n > MAX_N || m < 1 || m > MAX_OUT) return (int)cudaErrorInvalidValue;
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = emit_device<Codec>(dev, &sms);
    if (e != cudaSuccess) return (int)e;
    // the size pass's 16-byte loads of four cells: every row's fields start
    // on a 16-byte boundary (has: 4 bytes) when the cells are a multiple of
    // four and the vectors are
    const bool vec = (n / CELL) % 4 == 0 && aligned(has, 4) && aligned(offs, 16) &&
                     aligned(mlen, 16) && aligned(lit_start, 16) && aligned(lit_len, 16);
    const int smem = emit_smem_bytes((int)n, (int)m);
    const unsigned grid = (unsigned)b_n;
    cudaStream_t s = (cudaStream_t)stream;
    if (b_n <= sms) {
        emit_kernel<Codec, EMIT_WIDE><<<grid, EMIT_WIDE, smem, s>>>(
            data, valid, has, offs, mlen, lit_start, lit_len, last_end, out, out_len, stride, offset,
            (int)n, (int)m, vec);
    } else {
        emit_kernel<Codec, EMIT_NARROW><<<grid, EMIT_NARROW, smem, s>>>(
            data, valid, has, offs, mlen, lit_start, lit_len, last_end, out, out_len, stride, offset,
            (int)n, (int)m, vec);
    }
    return (int)cudaGetLastError();
}

// no work: one launch of it is the least time a launch of the kernels above
// can take on the device clock (the per-launch floor beside their times)
__global__ void empty_kernel() {}

extern "C" {

const char* rp_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// one block as wide as an emission block at one row
int rp_empty(void* stream) {
    empty_kernel<<<1, EMIT_WIDE, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
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
