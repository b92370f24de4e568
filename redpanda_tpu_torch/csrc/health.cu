// Per-row partition-health reduction over the quorum lanes, alone and
// fused with the mesh frame's fleet totals.
//
// Replaces redpanda_tpu/ops/health.py:39 health_reduce, and, as
// health_totals, the health stage and the fleet totals of
// redpanda_tpu/parallel/mesh_frame.py:103 mesh_health. (The health stages
// of tick_frame_health, health.py:90, and of the mesh frame,
// mesh_frame.py:63, run inside their sweeps in quorum.cu, from the
// sweep's registers.)
// Per row: tracked = voter | old voter; lag = max(self_dirty - match, 0)
// over tracked slots; max_lag on active leaders; under_replicated when
// a tracked slot's match trails commit_index; leaderless when an active
// row neither leads nor knows a leader.
//
// What bounds it on an H100: bytes. At G = 50,000, R = 8 it reads one
// i64 and two bool [G, R] lanes and four [G] lanes and writes three [G]
// lanes, ~5 MB, ~1.5 us at 3.35 TB/s; the arithmetic is a handful of
// compares per slot.
//
// health_totals at the mesh frame's 1M rows over D = 8 chip blocks reads
// the same lanes plus the pre-commit snapshot, ~109 MB, ~33 us; the
// totals add one int64 atomic per CUDA block and counter.
//
// Design: one thread per row. health_reduce loads a row as the commit
// sweep does (quorum_rows.cuh: match as 16-byte vectors and each voter
// mask as one 8-byte word a group of 8 slots, with the streaming hint,
// for R <= 32 a multiple of 8 at aligned addresses; 128-thread blocks)
// and applies row_health from registers; other rows load slot by slot in
// a plain loop. Lag subtraction wraps like the reference's int64 math
// instead of invoking signed-overflow undefined behaviour. health_totals
// runs the slot-by-slot row with gridDim.y = D, reduces the five counters
// per CUDA block and folds them per chip block (chip_blocks.cuh);
// fold_blocks then sums the [D, 5] partials.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chip_blocks.cuh"
#include "quorum_rows.cuh"

#define THREADS 256
#define ROW_THREADS 128

// One row of the reduction, slot by slot: writes max_lag / under /
// leaderless of row g and returns them.
__device__ __forceinline__ HealthRow health_row(
    const i64* __restrict__ match, const i64* __restrict__ commit,
    const u8* __restrict__ voter, const u8* __restrict__ voter_old,
    const u8* __restrict__ is_leader, const u8* __restrict__ leader_known,
    const u8* __restrict__ active, i64* __restrict__ max_lag,
    u8* __restrict__ under, u8* __restrict__ leaderless, i64 g, i64 r_n) {
    const i64 base = g * r_n;
    const bool leads = is_leader[g] != 0, act = active[g] != 0;
    const i64 self_dirty = match[base];  // SELF_SLOT
    const i64 c = commit[g];
    i64 worst = 0;
    bool trails = false;
    for (i64 r = 0; r < r_n; ++r) {
        if (!(voter[base + r] | voter_old[base + r])) continue;
        const i64 mv = match[base + r];
        const i64 lag = wrap_sub(self_dirty, mv);
        worst = lag > worst ? lag : worst;
        trails |= mv < c;
    }
    const bool lead = leads && act;
    const HealthRow out = {lead ? worst : 0, lead && trails,
                           act && !leads && leader_known[g] == 0};
    max_lag[g] = out.max_lag;
    under[g] = out.under;
    leaderless[g] = out.leaderless;
    return out;
}

__global__ void health_kernel(const i64* __restrict__ match,
                              const i64* __restrict__ commit,
                              const u8* __restrict__ voter,
                              const u8* __restrict__ voter_old,
                              const u8* __restrict__ is_leader,
                              const u8* __restrict__ leader_known,
                              const u8* __restrict__ active,
                              i64* __restrict__ max_lag, u8* __restrict__ under,
                              u8* __restrict__ leaderless, i64 g_n, i64 r_n) {
    const i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= g_n) return;
    health_row(match, commit, voter, voter_old, is_leader, leader_known, active,
               max_lag, under, leaderless, g, r_n);
}

// A row of R <= N slots (R a multiple of 8, aligned lanes) in registers.
template <int N>
__global__ void __launch_bounds__(ROW_THREADS)
health_rows_kernel(const i64* __restrict__ match, const i64* __restrict__ commit,
                   const u8* __restrict__ voter, const u8* __restrict__ voter_old,
                   const u8* __restrict__ is_leader, const u8* __restrict__ leader_known,
                   const u8* __restrict__ active, i64* __restrict__ max_lag,
                   u8* __restrict__ under, u8* __restrict__ leaderless, i64 g_n, int r_n) {
    const i64 g = (i64)blockIdx.x * ROW_THREADS + threadIdx.x;
    if (g >= g_n) return;
    const i64 base = g * r_n;
    i64 m[N];
    load_row<N, true>(match, base, r_n, m);
    const unsigned tracked =
        load_mask<N, true>(voter, base, r_n) | load_mask<N, true>(voter_old, base, r_n);
    const HealthRow x = row_health<N>(m, tracked, commit[g], is_leader[g] != 0,
                                      active[g] != 0, leader_known[g] != 0);
    max_lag[g] = x.max_lag;
    under[g] = x.under;
    leaderless[g] = x.leaderless;
}

// Rows [d * block_rows, (d + 1) * block_rows) form chip block d =
// blockIdx.y. `before` (the commit lane before the frame's commit launch)
// may be null: the advanced counter then stays 0.
__global__ void __launch_bounds__(THREADS)
health_totals_kernel(const i64* __restrict__ match,
                     const i64* __restrict__ commit,
                     const u8* __restrict__ voter,
                     const u8* __restrict__ voter_old,
                     const u8* __restrict__ is_leader,
                     const u8* __restrict__ leader_known,
                     const u8* __restrict__ active,
                     const i64* __restrict__ before, i64* __restrict__ max_lag,
                     u8* __restrict__ under, u8* __restrict__ leaderless,
                     i64* __restrict__ partials, i64 block_rows, i64 r_n) {
    const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    i64 v[T_N] = {0, 0, 0, 0, 0};
    if (i < block_rows) {
        const i64 g = (i64)blockIdx.y * block_rows + i;
        const HealthRow h = health_row(match, commit, voter, voter_old,
                                       is_leader, leader_known, active, max_lag,
                                       under, leaderless, g, r_n);
        count_row(v, h, before != nullptr && commit[g] > before[g], active[g] != 0);
    }
    block_partials<T_N>(v, 1u << T_MAX_LAG, partials);
}

extern "C" {

const char* rp_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

int rp_health_reduce(const i64* match, const i64* commit, const u8* voter,
                     const u8* voter_old, const u8* is_leader,
                     const u8* leader_known, const u8* active, i64* max_lag,
                     u8* under, u8* leaderless, i64 g_n, i64 r_n, void* stream) {
    if (g_n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const bool vectors = r_n <= 32 && r_n % 8 == 0 && (uintptr_t)match % 16 == 0 &&
                         (uintptr_t)voter % 8 == 0 && (uintptr_t)voter_old % 8 == 0;
    if (!vectors) {
        const unsigned blocks = (unsigned)((g_n + THREADS - 1) / THREADS);
        health_kernel<<<blocks, THREADS, 0, s>>>(match, commit, voter, voter_old,
                                                 is_leader, leader_known, active,
                                                 max_lag, under, leaderless, g_n, r_n);
        return (int)cudaGetLastError();
    }
    const unsigned blocks = (unsigned)((g_n + ROW_THREADS - 1) / ROW_THREADS);
#define RP_ROWS_LAUNCH(NS)                                                      \
    health_rows_kernel<NS><<<blocks, ROW_THREADS, 0, s>>>(                      \
        match, commit, voter, voter_old, is_leader, leader_known, active,       \
        max_lag, under, leaderless, g_n, (int)r_n)
    if (r_n <= 8) RP_ROWS_LAUNCH(8);
    else if (r_n <= 16) RP_ROWS_LAUNCH(16);
    else RP_ROWS_LAUNCH(32);
#undef RP_ROWS_LAUNCH
    return (int)cudaGetLastError();
}

int rp_health_totals(const i64* match, const i64* commit, const u8* voter,
                     const u8* voter_old, const u8* is_leader,
                     const u8* leader_known, const u8* active, const i64* before,
                     i64* max_lag, u8* under, u8* leaderless, i64* partials,
                     i64* totals, i64 n_blocks, i64 block_rows, i64 r_n,
                     void* stream) {
    if (n_blocks <= 0 || block_rows <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const dim3 grid((unsigned)((block_rows + THREADS - 1) / THREADS),
                    (unsigned)n_blocks);
    health_totals_kernel<<<grid, THREADS, 0, s>>>(
        match, commit, voter, voter_old, is_leader, leader_known, active,
        before, max_lag, under, leaderless, partials, block_rows, r_n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    fold_blocks<<<1, 32, 0, s>>>(partials, totals, (int)n_blocks, T_N,
                                 1u << T_MAX_LAG);
    return (int)cudaGetLastError();
}

}  // extern "C"
