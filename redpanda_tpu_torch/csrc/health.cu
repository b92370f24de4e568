// Per-row partition-health reduction over the quorum lanes.
//
// Replaces redpanda_tpu/ops/health.py:39 health_reduce (and, as the last
// launch of a sequence, the health stage of tick_frame_health at :90).
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
// Design: one thread per row, a plain loop over the row's R slots (no
// per-slot state is kept, so nothing needs registers beyond the running
// max and flag). Lag subtraction wraps like the reference's int64 math
// instead of invoking signed-overflow undefined behaviour. Fusing this
// into the commit sweep, which already holds the row in registers, is
// left for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

typedef long long i64;
typedef unsigned char u8;

#define THREADS 256

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
    const i64 base = g * r_n;
    const bool leads = is_leader[g] != 0, act = active[g] != 0;
    const i64 self_dirty = match[base];  // SELF_SLOT
    const i64 c = commit[g];
    i64 worst = 0;
    bool trails = false;
    for (i64 r = 0; r < r_n; ++r) {
        if (!(voter[base + r] | voter_old[base + r])) continue;
        const i64 mv = match[base + r];
        const i64 lag = (i64)((unsigned long long)self_dirty - (unsigned long long)mv);
        worst = lag > worst ? lag : worst;
        trails |= mv < c;
    }
    const bool lead = leads && act;
    max_lag[g] = lead ? worst : 0;
    under[g] = lead && trails;
    leaderless[g] = act && !leads && leader_known[g] == 0;
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
    const unsigned blocks = (unsigned)((g_n + THREADS - 1) / THREADS);
    health_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        match, commit, voter, voter_old, is_leader, leader_known, active,
        max_lag, under, leaderless, g_n, r_n);
    return (int)cudaGetLastError();
}

}  // extern "C"
