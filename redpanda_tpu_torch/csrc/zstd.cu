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
// zstd_decode — one thread per stream, DECODE_STREAMS streams per block.
// Latency-bound: a huff0 stream is one dependent chain (each symbol's
// position depends on every earlier length). The block first loads its
// streams' 2048-entry tables into shared memory as (nb << 8 | sym) uint16,
// then each thread walks its stream backward from tbits with a 128-bit
// window of two aligned 64-bit words (one load per 64 bits consumed),
// emitting 8 output bytes per store, and zero-fills its row to rmax. The
// JAX program's pointer jumping (an int32 transition table over every bit
// position, squared log2(rmax) times) would need ~8.6 GB per table at one
// 128 MiB segment; the walk needs none. Semantics kept exactly: bits below
// 0 read as zero, a stream that runs out sticks at bit 0 and keeps emitting
// sym[peek(0)], end = the position after min(regen, rmax) symbols, or
// f(tbits) when regen <= 0.

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
#define DECODE_STREAMS 16
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

__global__ void __launch_bounds__(DECODE_STREAMS)
zstd_decode_kernel(const uint8_t* __restrict__ bufs, const int32_t* __restrict__ tbits,
                   const int32_t* __restrict__ regen, const uint8_t* __restrict__ tsym,
                   const int32_t* __restrict__ tnb, uint8_t* __restrict__ out,
                   int32_t* __restrict__ end_out, i64 s_n, int sbytes, int rmax) {
    extern __shared__ uint16_t tab[];  // [DECODE_STREAMS][TSIZE]
    const i64 s0 = (i64)blockIdx.x * DECODE_STREAMS;
    for (int i = threadIdx.x; i < DECODE_STREAMS * TSIZE; i += DECODE_STREAMS) {
        const i64 s = s0 + i / TSIZE;
        if (s < s_n) {
            const i64 e = s * TSIZE + (i % TSIZE);
            tab[i] = (uint16_t)(tsym[e] | (tnb[e] << 8));
        }
    }
    __syncthreads();
    const i64 s = s0 + threadIdx.x;
    if (s >= s_n) return;
    const uint16_t* t = tab + threadIdx.x * TSIZE;
    const uint64_t* w = reinterpret_cast<const uint64_t*>(bufs + s * sbytes);
    const int nwords = sbytes / 8;
    const uint64_t w0 = w[0];
    int wk = -2;  // word index held in lo (hi = the next word)
    uint64_t lo = 0, hi = 0;
    // the 11 bits just below bit p, MSB = bit p - 1; bits below 0 read as zero
    auto peek = [&](int p) -> int {
        if (p < TABLELOG) return (int)((w0 << (TABLELOG - p)) & (TSIZE - 1));
        const int k = (p - TABLELOG) >> 6;
        if (k != wk) {
            if (k == wk - 1) {
                hi = lo;
            } else {
                hi = k + 1 < nwords ? w[k + 1] : 0;
            }
            lo = w[k];
            wk = k;
        }
        const int off = p - TABLELOG - 64 * k;
        uint64_t x = lo >> off;
        if (off > 64 - TABLELOG) x |= hi << (64 - off);
        return (int)(x & (TSIZE - 1));
    };
    const int tb = tbits[s];
    const int rg = regen[s];
    const int K = rg < 0 ? 0 : (rg > rmax ? rmax : rg);
    uint64_t* o = reinterpret_cast<uint64_t*>(out + s * (i64)rmax);
    int p = tb;
    uint64_t acc = 0;
    for (int k = 0; k < K; ++k) {
        const uint32_t e = t[peek(p)];
        acc |= (uint64_t)(e & 255u) << (8 * (k & 7));
        if ((k & 7) == 7) {
            o[k >> 3] = acc;
            acc = 0;
        }
        p -= (int)(e >> 8);
        p = p > 0 ? p : 0;
    }
    int kw = K >> 3;
    if (K & 7) o[kw++] = acc;
    for (int j = kw; j < rmax / 8; ++j) o[j] = 0;
    if (K == 0) {
        p = tb - (int)(t[peek(tb)] >> 8);
        p = p > 0 ? p : 0;
    }
    end_out[s] = p;
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

// bufs: S rows of sbytes (a multiple of 8, rows 8-byte aligned); out: S rows
// of rmax (a multiple of 8); tnb entries in [0, 11]
int rp_zstd_decode(const uint8_t* bufs, const int32_t* tbits, const int32_t* regen,
                   const uint8_t* tsym, const int32_t* tnb, uint8_t* out, int32_t* end,
                   i64 s_n, i64 sbytes, i64 rmax, void* stream) {
    if (s_n <= 0) return 0;
    if (sbytes < 8 || sbytes % 8 || rmax < 8 || rmax % 8) return (int)cudaErrorInvalidValue;
    const int smem = DECODE_STREAMS * TSIZE * (int)sizeof(uint16_t);
    cudaError_t e = cudaFuncSetAttribute(zstd_decode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const unsigned grid = (unsigned)((s_n + DECODE_STREAMS - 1) / DECODE_STREAMS);
    zstd_decode_kernel<<<grid, DECODE_STREAMS, smem, (cudaStream_t)stream>>>(
        bufs, tbits, regen, tsym, tnb, out, end, s_n, (int)sbytes, (int)rmax);
    return (int)cudaGetLastError();
}

}  // extern "C"
