// Per-chip-block totals for kernels over D chip blocks on one card.
//
// The JAX package shards the group axis over D devices, each holding an
// equal contiguous block of rows, and folds fleet totals across devices
// with one psum (a cross-chip all-reduce). On one card the same blocks
// are row ranges: a kernel launches with gridDim.y = D (blockIdx.y is the
// chip block), each CUDA block reduces its K counters in shared memory
// and adds (or maxes) them into partials[d * K + k], and fold_blocks sums
// the [D, K] partials into [K] totals: the frame's one cross-chip fold.
// A kernel whose totals need no per-block partials folds them in its own
// launch instead (grid_totals: atomics, then a last-block ticket).
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

// grid_totals' accumulators: TOTALS_SETS sets of K <= TOTALS_STRIDE
// counters, one 128-byte line a set, then the ticket
#define TOTALS_SETS 32
#define TOTALS_STRIDE 16
#define TOTALS_SCRATCH (TOTALS_SETS * TOTALS_STRIDE + 1)

// block_partials into accumulator set blockIdx.x % TOTALS_SETS of acc (a
// grid of one row of blocks; the sets spread the blocks' atomics over
// lines), then the last block of the grid to finish folds the sets into
// out[K] and zeroes them and the ticket: the fold over the blocks without
// a second launch or a grid barrier, and the next launch finds them zero.
// acc and the ticket serve one stream (two launches running at once
// would share the ticket). Every thread of every block must call it.
template <int K>
__device__ __forceinline__ void grid_totals(i64 (&v)[K], unsigned max_mask, i64* acc,
                                            unsigned long long* ticket, i64* out) {
    static_assert(K <= TOTALS_STRIDE, "a set holds at most TOTALS_STRIDE counters");
    block_partials<K>(v, max_mask, acc + (blockIdx.x % TOTALS_SETS) * TOTALS_STRIDE);
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    bool last = false;
    if (lane == 0) {  // the thread that made the block's atomics
        __threadfence();
        last = atomicAdd(ticket, 1ull) == (unsigned long long)gridDim.x - 1;
    }
    if (!__shfl_sync(0xffffffffu, last, 0)) return;
    __threadfence();
#pragma unroll
    for (int k = 0; k < K; ++k) {  // lane s takes set s
        const bool mx = (max_mask >> k) & 1u;
        i64 x = lane < TOTALS_SETS
                    ? (i64)atomicExch((unsigned long long*)&acc[lane * TOTALS_STRIDE + k], 0ull)
                    : 0;
        for (int off = 16; off > 0; off >>= 1) {
            const i64 y = __shfl_down_sync(0xffffffffu, x, off);
            x = mx ? (x > y ? x : y) : x + y;
        }
        if (lane == 0) out[k] = x;
    }
    if (lane == 0) atomicExch(ticket, 0ull);
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
