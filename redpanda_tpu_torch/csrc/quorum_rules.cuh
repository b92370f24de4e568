// The raft per-row rules shared by the quorum kernels (quorum.cu) and the
// ring cluster step (cluster.cu), each written once:
//
//   commit_row       the leader commit rule        ops/quorum.py:110
//   follower_commit  the follower commit rule      ops/quorum.py:154
//   local_append     the leader's own-slot update  ops/quorum.py:211
//
// Every function works on one row the caller owns or, for local_append
// with kShared, on cells other threads may hit in the same launch.

#pragma once

#include <cuda_runtime.h>

typedef long long i64;

#define RP_I64_MIN ((i64)(-0x7fffffffffffffffLL - 1))

__device__ __forceinline__ i64 imax(i64 a, i64 b) { return a > b ? a : b; }
__device__ __forceinline__ i64 imin(i64 a, i64 b) { return a < b ? a : b; }

// a + b with the reference's wrapping int64 arithmetic (no signed-overflow UB)
__device__ __forceinline__ i64 wrap_add(i64 a, i64 b) {
    return (i64)((unsigned long long)a + (unsigned long long)b);
}

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
    if (n == 0) return RP_I64_MIN;
    i64 v[N];
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = ((mask >> i) & 1u) ? vals[i] : RP_I64_MIN;
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

// The leader commit rule for one row held in registers: m = match, c =
// min(flushed, match) per slot (i64 min past the row's R slots, which
// sorts below every real offset exactly as the reference's masked fill),
// vm / om = current and old voter bitmasks, self_flushed = flushed[0].
// Returns the new commit and writes the new last_visible to *visible.
template <int N>
__device__ __forceinline__ i64 commit_row(const i64 (&m)[N], const i64 (&c)[N],
                                          unsigned vm, unsigned om,
                                          i64 self_flushed, bool leader,
                                          i64 term_start, i64 commit,
                                          i64* visible) {
    const int n_cur = __popc(vm), n_old = __popc(om);
    i64 majority = masked_quorum(c, vm, n_cur);
    i64 majority_dirty = masked_quorum(m, vm, n_cur);
    if (n_old > 0) {  // joint consensus: min over both quorums
        majority = imin(majority, masked_quorum(c, om, n_old));
        majority_dirty = imin(majority_dirty, masked_quorum(m, om, n_old));
    }
    // clamp to the leader's own flushed / dirty offset (slot 0)
    majority = imin(majority, self_flushed);
    majority_dirty = imin(majority_dirty, m[0]);
    const bool advance =
        leader && n_cur > 0 && majority > commit && majority >= term_start;
    const i64 new_commit = advance ? majority : commit;
    if (leader && n_cur > 0)
        *visible = imax(*visible, imax(new_commit, majority_dirty));
    return new_commit;
}

// Follower commit: commit = min(leader_commit, flushed) when that moves it
// forward (consensus.cc:2760-2777).
__device__ __forceinline__ i64 follower_commit(i64 commit, i64 leader_commit,
                                               i64 flushed) {
    const i64 proposed = imin(leader_commit, flushed);
    return (leader_commit > commit && proposed > commit) ? proposed : commit;
}

// Local append: the leader's own slot takes the max of itself and the
// appended / flushed offsets. kShared: other threads of the launch may
// update the same row (duplicate rows in one batch), so use atomics.
template <bool kShared>
__device__ __forceinline__ void local_append(i64* match0, i64* flushed0,
                                             i64 dirty, i64 flushed) {
    if (kShared) {
        atomicMax(match0, dirty);
        atomicMax(flushed0, flushed);
    } else {
        *match0 = imax(*match0, dirty);
        *flushed0 = imax(*flushed0, flushed);
    }
}
