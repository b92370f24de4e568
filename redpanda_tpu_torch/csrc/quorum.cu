// Batched quorum kernels for the replication tick: the reply fold, the
// commit sweep and the heartbeat gather; and the two follower-side rules.
//
// Replaces (redpanda_tpu/ops/quorum.py):
//   fold_replies          :172  scatter-max of M replies into [G, R] lanes
//   quorum_commit_step    :110  masked majority order statistic per group
//   build_heartbeats      :196  gather of the heartbeat payload fields
//   follower_commit_step  :154  commit = min(leader_commit, flushed[0])
//   local_append_update   :211  scatter-max of M appends into slot 0
//
// What bounds them on an H100: bytes. At G = 50,000, R = 8 the commit
// sweep reads four [G, R] lanes (two i64, two bool) plus five [G] lanes
// and writes two [G] lanes, ~9.3 MB, ~2.8 us at 3.35 TB/s; the work per
// group (four 8-lane sorting networks) is a few hundred integer
// operations, far below the card's integer rate. The fold touches M
// random 8-byte cells of three lanes; the gather reads H random rows.
//
// Design:
//   * fold_replies is TWO launches. The first evaluates every reply's
//     seq guard against the PRE-batch last_seq and writes a fresh flag
//     to scratch; the second applies atomicMax to match / flushed /
//     last_seq for fresh replies only. Fusing them would let one reply
//     raise last_seq before a duplicate (g, r) reply in the same batch
//     reads it, dropping a reply the reference keeps. Max commutes, so
//     the result does not depend on the atomics' order.
//   * quorum_commit_step runs one thread per group with the row's R
//     values in registers (R <= 32, padded to 8, 16 or 32 slots with
//     i64 min, which sorts below every real offset exactly as the
//     reference's masked fill does). A bitonic network sorts each
//     masked lane set; the order statistic is picked with an unrolled
//     select so nothing spills to local memory.
//   * build_heartbeats is a separate gather launched after the commit
//     sweep: hb_idx rows are arbitrary, so it must read the
//     post-advance lanes of rows other threads wrote.
//   * follower_commit_step is one thread per group (four [G] lanes read,
//     two written: bytes); local_append_update one thread per append,
//     atomicMax into slot 0 because one batch may name a row twice. Both
//     rules live in quorum_rules.cuh, where the ring cluster step
//     (cluster.cu) applies them to its mirrors and its self slot.
// All of them update or read the lanes in place; the JAX program donates
// its state buffers the same way (donate_argnums=0).

#include <cuda_runtime.h>
#include <stdint.h>

#include "quorum_rules.cuh"

typedef unsigned char u8;

#define THREADS 256

static inline unsigned blocks_for(i64 n) {
    return (unsigned)((n + THREADS - 1) / THREADS);
}

// ---------------------------------------------------------------- fold
__global__ void fold_guard_kernel(const i64* __restrict__ last_seq,
                                  const i64* __restrict__ group_idx,
                                  const i64* __restrict__ slot,
                                  const i64* __restrict__ seq,
                                  u8* __restrict__ fresh, i64 m, i64 g_n,
                                  i64 r_n) {
    const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    const i64 g = group_idx[i], r = slot[i];
    const bool in_range = g >= 0 && g < g_n && r >= 0 && r < r_n;
    fresh[i] = in_range && seq[i] > last_seq[g * r_n + r];
}

__global__ void fold_apply_kernel(i64* __restrict__ match,
                                  i64* __restrict__ flushed,
                                  i64* __restrict__ last_seq,
                                  const i64* __restrict__ group_idx,
                                  const i64* __restrict__ slot,
                                  const i64* __restrict__ dirty,
                                  const i64* __restrict__ flushed_in,
                                  const i64* __restrict__ seq,
                                  const u8* __restrict__ fresh, i64 m,
                                  i64 r_n) {
    const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m || !fresh[i]) return;
    const i64 k = group_idx[i] * r_n + slot[i];
    atomicMax(&match[k], dirty[i]);
    atomicMax(&flushed[k], flushed_in[i]);
    atomicMax(&last_seq[k], seq[i]);
}

// --------------------------------------------------------------- commit
template <int N>
__global__ void __launch_bounds__(THREADS)
commit_step_kernel(const i64* __restrict__ term_start,
                   const u8* __restrict__ is_leader, i64* __restrict__ commit,
                   i64* __restrict__ last_visible,
                   const i64* __restrict__ match,
                   const i64* __restrict__ flushed,
                   const u8* __restrict__ voter, const u8* __restrict__ voter_old,
                   i64 g_n, int r_n) {
    const i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= g_n) return;
    const i64 base = g * r_n;
    i64 m[N], c[N];
    unsigned vm = 0u, om = 0u;
#pragma unroll
    for (int r = 0; r < N; ++r) {
        if (r < r_n) {
            const i64 mv = match[base + r], fv = flushed[base + r];
            m[r] = mv;
            c[r] = fv < mv ? fv : mv;  // match_committed_index
            vm |= (unsigned)(voter[base + r] != 0) << r;
            om |= (unsigned)(voter_old[base + r] != 0) << r;
        } else {
            m[r] = RP_I64_MIN;
            c[r] = RP_I64_MIN;
        }
    }
    const i64 lv = last_visible[g];
    i64 nv = lv;
    commit[g] = commit_row(m, c, vm, om, flushed[base], is_leader[g] != 0,
                           term_start[g], commit[g], &nv);
    if (nv != lv) last_visible[g] = nv;
}

// ----------------------------------------------------------- heartbeats
__global__ void heartbeats_kernel(const i64* __restrict__ hb_idx,
                                  const i64* __restrict__ term,
                                  const i64* __restrict__ commit,
                                  const i64* __restrict__ match,
                                  const i64* __restrict__ last_visible,
                                  i64* __restrict__ o_term,
                                  i64* __restrict__ o_commit,
                                  i64* __restrict__ o_dirty,
                                  i64* __restrict__ o_visible, i64 h, i64 g_n,
                                  i64 r_n) {
    const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= h) return;
    i64 g = hb_idx[i];
    // rows are in range by contract; clamp only to keep reads in bounds
    g = g < 0 ? 0 : (g >= g_n ? g_n - 1 : g);
    o_term[i] = term[g];
    o_commit[i] = commit[g];
    o_dirty[i] = match[g * r_n];  // SELF_SLOT
    o_visible[i] = last_visible[g];
}

// ------------------------------------------------------ follower rules
__global__ void follower_commit_kernel(i64* __restrict__ commit,
                                       i64* __restrict__ last_visible,
                                       const i64* __restrict__ flushed,
                                       const i64* __restrict__ leader_commit,
                                       i64 g_n, i64 r_n) {
    const i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= g_n) return;
    const i64 c = follower_commit(commit[g], leader_commit[g], flushed[g * r_n]);
    commit[g] = c;
    last_visible[g] = imax(last_visible[g], c);
}

__global__ void local_append_kernel(i64* __restrict__ match,
                                    i64* __restrict__ flushed,
                                    const i64* __restrict__ group_idx,
                                    const i64* __restrict__ dirty,
                                    const i64* __restrict__ flushed_in, i64 m,
                                    i64 g_n, i64 r_n) {
    const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    const i64 g = group_idx[i];
    if (g < 0 || g >= g_n) return;  // rows in range by contract
    local_append<true>(&match[g * r_n], &flushed[g * r_n], dirty[i], flushed_in[i]);
}

// ------------------------------------------------------------ C entries
extern "C" {

const char* rp_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

int rp_fold_replies(i64* match, i64* flushed, i64* last_seq,
                    const i64* group_idx, const i64* slot, const i64* dirty,
                    const i64* flushed_in, const i64* seq, u8* fresh, i64 m,
                    i64 g_n, i64 r_n, void* stream) {
    if (m <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    fold_guard_kernel<<<blocks_for(m), THREADS, 0, s>>>(
        last_seq, group_idx, slot, seq, fresh, m, g_n, r_n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    fold_apply_kernel<<<blocks_for(m), THREADS, 0, s>>>(
        match, flushed, last_seq, group_idx, slot, dirty, flushed_in, seq,
        fresh, m, r_n);
    return (int)cudaGetLastError();
}

int rp_commit_step(const i64* term_start, const u8* is_leader, i64* commit,
                   i64* last_visible, const i64* match, const i64* flushed,
                   const u8* voter, const u8* voter_old, i64 g_n, i64 r_n,
                   void* stream) {
    if (g_n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const int r = (int)r_n;
    if (r <= 8)
        commit_step_kernel<8><<<blocks_for(g_n), THREADS, 0, s>>>(
            term_start, is_leader, commit, last_visible, match, flushed, voter,
            voter_old, g_n, r);
    else if (r <= 16)
        commit_step_kernel<16><<<blocks_for(g_n), THREADS, 0, s>>>(
            term_start, is_leader, commit, last_visible, match, flushed, voter,
            voter_old, g_n, r);
    else
        commit_step_kernel<32><<<blocks_for(g_n), THREADS, 0, s>>>(
            term_start, is_leader, commit, last_visible, match, flushed, voter,
            voter_old, g_n, r);
    return (int)cudaGetLastError();
}

int rp_follower_commit(i64* commit, i64* last_visible, const i64* flushed,
                       const i64* leader_commit, i64 g_n, i64 r_n,
                       void* stream) {
    if (g_n <= 0) return 0;
    follower_commit_kernel<<<blocks_for(g_n), THREADS, 0, (cudaStream_t)stream>>>(
        commit, last_visible, flushed, leader_commit, g_n, r_n);
    return (int)cudaGetLastError();
}

int rp_local_append(i64* match, i64* flushed, const i64* group_idx,
                    const i64* dirty, const i64* flushed_in, i64 m, i64 g_n,
                    i64 r_n, void* stream) {
    if (m <= 0 || g_n <= 0) return 0;
    local_append_kernel<<<blocks_for(m), THREADS, 0, (cudaStream_t)stream>>>(
        match, flushed, group_idx, dirty, flushed_in, m, g_n, r_n);
    return (int)cudaGetLastError();
}

int rp_build_heartbeats(const i64* hb_idx, const i64* term, const i64* commit,
                        const i64* match, const i64* last_visible, i64* o_term,
                        i64* o_commit, i64* o_dirty, i64* o_visible, i64 h,
                        i64 g_n, i64 r_n, void* stream) {
    if (h <= 0 || g_n <= 0) return 0;
    heartbeats_kernel<<<blocks_for(h), THREADS, 0, (cudaStream_t)stream>>>(
        hb_idx, term, commit, match, last_visible, o_term, o_commit, o_dirty,
        o_visible, h, g_n, r_n);
    return (int)cudaGetLastError();
}

}  // extern "C"
