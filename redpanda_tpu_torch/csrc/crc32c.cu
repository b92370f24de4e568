// Batched CRC-32C (Castagnoli, reflected) over zero-padded rows.
//
// Replaces redpanda_tpu/ops/crc32c.py:226 crc32c_device: the finalized
// CRC-32C of the first lens[i] bytes of each row of a [B, S] uint8
// matrix (init and final xor 0xFFFFFFFF; len 0 gives 0).
//
// What bounds it on an H100: bytes. Every byte is read once, so 1,024
// rows of ~16.4 KiB are ~16.8 MB, ~5 us at 3.35 TB/s. The TPU design
// (a GF(2) bit-matrix product per 512-byte chunk on the MXU, then an
// un-extend of the padding) existed because the TPU's vector unit is
// poor at table gathers; an SM does table lookups from shared memory
// at full rate, so the classic slice-by-8 fits here instead.
//
// Design:
//   * One block per row (grid-strided over rows, so each block loads the
//     8 KiB of slice-by-8 tables and the 31 shift matrices into shared
//     memory once for many rows).
//   * Each of the block's 256 threads folds one contiguous segment of
//     the row (whole 8-byte words except at the row's end) with
//     slice-by-8, starting from register 0 (thread 0 from 0xFFFFFFFF).
//   * CRC is GF(2)-linear, so the row's register is the xor over
//     segments of Z^k(segment register), where Z appends one zero byte
//     and k is the number of row bytes after the segment. Z^k is applied
//     by the binary powers Z^(2^j), 32x32 bit matrices built on the host
//     (ops/crc32c.py) and uploaded once. An xor reduction over the block
//     (warp shuffles, then shared memory) gives the register.
//   * The kernel reads lens per row and never touches bytes past them,
//     so the zero padding needs no un-extend step.

#include <cuda_runtime.h>
#include <stdint.h>

typedef long long i64;

#define THREADS 256
#define TABLE_WORDS (8 * 256)
#define POW_MATS 31  // Z^(2^j) for j < 31: shifts up to 2^31 - 1 bytes
#define POW_WORDS (POW_MATS * 32)

// apply a 32x32 GF(2) matrix, given as its 32 columns, to v
__device__ __forceinline__ uint32_t gf2_apply(const uint32_t* cols, uint32_t v) {
    uint32_t out = 0u;
#pragma unroll
    for (int k = 0; k < 32; ++k) out ^= (0u - ((v >> k) & 1u)) & cols[k];
    return out;
}

// v followed by k zero bytes
__device__ __forceinline__ uint32_t shift_zeros(const uint32_t* pows, uint32_t v,
                                                i64 k) {
    for (int j = 0; k != 0 && v != 0u; ++j, k >>= 1)
        if (k & 1) v = gf2_apply(pows + 32 * j, v);
    return v;
}

__global__ void __launch_bounds__(THREADS)
crc32c_kernel(const uint8_t* __restrict__ data, const i64* __restrict__ lens,
              const uint32_t* __restrict__ consts, i64* __restrict__ out,
              i64 b_n, i64 stride) {
    __shared__ uint32_t tab[TABLE_WORDS];
    __shared__ uint32_t pows[POW_WORDS];
    __shared__ uint32_t warp_acc[THREADS / 32];
    for (int i = threadIdx.x; i < TABLE_WORDS; i += blockDim.x) tab[i] = consts[i];
    for (int i = threadIdx.x; i < POW_WORDS; i += blockDim.x)
        pows[i] = consts[TABLE_WORDS + i];
    __syncthreads();

    const uint32_t* t0 = tab;
    for (i64 row = blockIdx.x; row < b_n; row += gridDim.x) {
        i64 len = lens[row];
        len = len < 0 ? 0 : (len > stride ? stride : len);
        // segment length: ceil(len / THREADS) rounded up to whole words
        const i64 seg = ((len + THREADS - 1) / THREADS + 7) & ~(i64)7;
        const i64 lo0 = (i64)threadIdx.x * seg;
        const i64 lo = lo0 < len ? lo0 : len;
        const i64 hi = lo + seg < len ? lo + seg : len;
        const uint8_t* p = data + row * stride;

        uint32_t crc = threadIdx.x == 0 ? 0xFFFFFFFFu : 0u;
        i64 i = lo;
        for (; i + 8 <= hi; i += 8) {
            crc ^= (uint32_t)p[i] | ((uint32_t)p[i + 1] << 8) |
                   ((uint32_t)p[i + 2] << 16) | ((uint32_t)p[i + 3] << 24);
            crc = tab[7 * 256 + (crc & 0xFFu)] ^ tab[6 * 256 + ((crc >> 8) & 0xFFu)] ^
                  tab[5 * 256 + ((crc >> 16) & 0xFFu)] ^ tab[4 * 256 + (crc >> 24)] ^
                  tab[3 * 256 + p[i + 4]] ^ tab[2 * 256 + p[i + 5]] ^
                  tab[1 * 256 + p[i + 6]] ^ t0[p[i + 7]];
        }
        for (; i < hi; ++i) crc = t0[(crc ^ p[i]) & 0xFFu] ^ (crc >> 8);
        crc = shift_zeros(pows, crc, len - hi);

#pragma unroll
        for (int o = 16; o > 0; o >>= 1) crc ^= __shfl_xor_sync(0xFFFFFFFFu, crc, o);
        if ((threadIdx.x & 31) == 0) warp_acc[threadIdx.x >> 5] = crc;
        __syncthreads();
        if (threadIdx.x == 0) {
            uint32_t acc = 0u;
#pragma unroll
            for (int w = 0; w < THREADS / 32; ++w) acc ^= warp_acc[w];
            out[row] = (i64)(acc ^ 0xFFFFFFFFu);
        }
        __syncthreads();  // warp_acc is reused by the next row
    }
}

extern "C" {

const char* rp_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// consts: TABLE_WORDS slice-by-8 table words, then POW_WORDS matrix columns
int rp_crc32c(const uint8_t* data, const i64* lens, const uint32_t* consts,
              i64* out, i64 b_n, i64 stride, i64 grid, void* stream) {
    if (b_n <= 0) return 0;
    const unsigned blocks = (unsigned)(grid < b_n ? grid : b_n);
    crc32c_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        data, lens, consts, out, b_n, stride);
    return (int)cudaGetLastError();
}

}  // extern "C"
