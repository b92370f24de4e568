// Per-chip-block totals for kernels over D chip blocks on one card.
//
// The JAX package shards the group axis over D devices, each holding an
// equal contiguous block of rows, and folds fleet totals across devices
// with one psum (a cross-chip all-reduce). On one card the same blocks
// are row ranges: a kernel launches with gridDim.y = D (blockIdx.y is the
// chip block), each CUDA block reduces its K counters in shared memory
// and adds (or maxes) them into partials[d * K + k], and fold_blocks sums
// the [D, K] partials into [K] totals: the frame's one cross-chip fold.
// Every counter is an exact int64, so the result does not depend on the
// order of the atomics.

#pragma once

#include <cuda_runtime.h>

typedef long long i64;

// Reduce each thread's K counters over the CUDA block (blockDim.x a
// multiple of 32, at most 1024) and fold the block's result into
// partials[blockIdx.y * K + k]: a max for the counters whose bit is set
// in max_mask (all values >= 0), a sum for the rest. Every thread of the
// block must call it.
template <int K>
__device__ __forceinline__ void block_partials(i64 (&v)[K], unsigned max_mask,
                                               i64* __restrict__ partials) {
    __shared__ i64 s[K][32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const bool mx = (max_mask >> k) & 1u;
        i64 x = v[k];
        for (int off = 16; off > 0; off >>= 1) {
            const i64 y = __shfl_down_sync(0xffffffffu, x, off);
            x = mx ? (x > y ? x : y) : x + y;
        }
        if (lane == 0) s[k][warp] = x;
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const bool mx = (max_mask >> k) & 1u;
            i64 x = lane < warps ? s[k][lane] : 0;
            for (int off = 16; off > 0; off >>= 1) {
                const i64 y = __shfl_down_sync(0xffffffffu, x, off);
                x = mx ? (x > y ? x : y) : x + y;
            }
            if (lane == 0 && x != 0) {
                i64* p = &partials[(i64)blockIdx.y * K + k];
                if (mx)
                    atomicMax(p, x);
                else
                    atomicAdd((unsigned long long*)p, (unsigned long long)x);
            }
        }
    }
}

// totals[k] = sum (or max, per max_mask) over d of partials[d * K + k];
// one warp, launched right after the kernel on the same stream.
__global__ void fold_blocks(const i64* __restrict__ partials,
                            i64* __restrict__ totals, int n_blocks, int k_n,
                            unsigned max_mask) {
    const int k = threadIdx.x;
    if (k >= k_n) return;
    const bool mx = (max_mask >> k) & 1u;
    i64 acc = 0;
    for (int d = 0; d < n_blocks; ++d) {
        const i64 x = partials[(i64)d * k_n + k];
        acc = mx ? (acc > x ? acc : x) : acc + x;
    }
    totals[k] = acc;
}
