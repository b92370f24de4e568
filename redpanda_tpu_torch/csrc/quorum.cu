// Batched quorum kernels for the replication tick: the reply fold, the
// commit sweep and the heartbeat gather.
//
// Replaces (redpanda_tpu/ops/quorum.py):
//   fold_replies        :172  scatter-max of M replies into [G, R] lanes
//   quorum_commit_step  :110  masked majority order statistic per group
//   build_heartbeats    :196  gather of the heartbeat payload fields
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
// All three update or read the lanes in place; the JAX program donates
// its state buffers the same way (donate_argnums=0).

#include <cuda_runtime.h>
#include <stdint.h>

typedef long long i64;
typedef unsigned char u8;

#define I64_MIN ((i64)(-0x7fffffffffffffffLL - 1))
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
__device__ __forceinline__ void bitonic_sort(i64 (&v)[N]) {
#pragma unroll
    for (int k = 2; k <= N; k <<= 1) {
#pragma unroll
        for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
            for (int i = 0; i < N; ++i) {
                const int l = i ^ j;
                if (l > i) {
                    const i64 a = v[i], b = v[l];
                    const i64 lo = a < b ? a : b, hi = a < b ? b : a;
                    const bool up = (i & k) == 0;
                    v[i] = up ? lo : hi;
                    v[l] = up ? hi : lo;
                }
            }
        }
    }
}

// Majority order statistic over the slots set in `mask` (n of them):
// the reference fills masked-out slots with i64 min, sorts ascending and
// takes index clip(R - n + (n - 1) // 2, 0, R - 1); n == 0 gives i64 min.
template <int N>
__device__ __forceinline__ i64 masked_quorum(const i64 (&vals)[N],
                                             unsigned mask, int n) {
    if (n == 0) return I64_MIN;
    i64 v[N];
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = ((mask >> i) & 1u) ? vals[i] : I64_MIN;
    bitonic_sort(v);
    // n >= 1 here, so C's truncating (n - 1) / 2 equals Python's floor
    // division, and N - n + (n - 1) / 2 already lies in [0, N - 1]
    const int idx = N - n + (n - 1) / 2;
    i64 out = v[0];
#pragma unroll
    for (int i = 0; i < N; ++i)
        if (i == idx) out = v[i];
    return out;
}

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
            m[r] = I64_MIN;
            c[r] = I64_MIN;
        }
    }
    const int n_cur = __popc(vm), n_old = __popc(om);
    i64 majority = masked_quorum(c, vm, n_cur);
    i64 majority_dirty = masked_quorum(m, vm, n_cur);
    if (n_old > 0) {  // joint consensus: min over both quorums
        const i64 m_old = masked_quorum(c, om, n_old);
        const i64 d_old = masked_quorum(m, om, n_old);
        majority = majority < m_old ? majority : m_old;
        majority_dirty = majority_dirty < d_old ? majority_dirty : d_old;
    }
    const i64 self_flushed = flushed[base], self_dirty = match[base];
    majority = majority < self_flushed ? majority : self_flushed;
    majority_dirty = majority_dirty < self_dirty ? majority_dirty : self_dirty;

    const bool leader = is_leader[g] != 0;
    const i64 old_commit = commit[g];
    const bool advance = leader && n_cur > 0 && majority > old_commit &&
                         majority >= term_start[g];
    const i64 new_commit = advance ? majority : old_commit;
    commit[g] = new_commit;
    if (leader && n_cur > 0) {
        const i64 lv = last_visible[g];
        const i64 cand = new_commit > majority_dirty ? new_commit : majority_dirty;
        last_visible[g] = lv > cand ? lv : cand;
    }
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
