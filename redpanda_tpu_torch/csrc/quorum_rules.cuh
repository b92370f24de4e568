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

// Rank masks of one row: bit t of before[s] is set when slot t sorts
// before slot s, that is v[t] < v[s], or v[t] == v[s] and t < s. One
// compare a pair of slots (N (N - 1) / 2 of them) serves every subset of
// the row, so the current and the old voter sets share it.
template <int N>
__device__ __forceinline__ void rank_masks(const i64 (&v)[N], unsigned (&before)[N]) {
#pragma unroll
    for (int s = 0; s < N; ++s) before[s] = 0u;
#pragma unroll
    for (int a = 0; a < N; ++a)
#pragma unroll
        for (int b = a + 1; b < N; ++b) {
            const bool a_first = v[a] <= v[b];
            before[b] |= (unsigned)a_first << a;
            before[a] |= (unsigned)!a_first << b;
        }
}

// Majority order statistic over the slots set in `mask` (n of them): the
// reference fills masked-out slots with i64 min, sorts ascending and takes
// index clip(R - n + (n - 1) // 2, 0, R - 1); n == 0 gives i64 min. The
// fill sorts below (or ties with) every masked value, so that index holds
// the masked values' ((n - 1) / 2)-th smallest: the one masked slot that
// exactly (n - 1) / 2 masked slots sort before. No sort, and the padding
// past R never matters.
template <int N>
__device__ __forceinline__ i64 masked_quorum(const i64 (&v)[N],
                                             const unsigned (&before)[N],
                                             unsigned mask) {
    const int k = (__popc(mask) - 1) >> 1;  // -1 when mask is empty: no slot
    i64 out = RP_I64_MIN;
#pragma unroll
    for (int s = 0; s < N; ++s)
        if (((mask >> s) & 1u) && __popc(before[s] & mask) == k) out = v[s];
    return out;
}

// One lane's majority over a row (c = min(flushed, match) for the commit,
// match for the visible offset): the masked order statistic over the
// current voters, and the min of it and the old voters' under joint
// consensus (om != 0).
template <int N>
__device__ __forceinline__ i64 lane_majority(const i64 (&v)[N], unsigned vm,
                                             unsigned om) {
    unsigned before[N];
    rank_masks(v, before);
    const i64 cur = masked_quorum(v, before, vm);
    return om != 0u ? imin(cur, masked_quorum(v, before, om)) : cur;
}

// The leader commit rule for one row held in registers: m = match, c =
// min(flushed, match) per slot (anything past the row's R slots, which
// no mask selects), vm / om = current and old voter bitmasks (no bit at
// or past R), self_flushed = flushed[0]. Returns the new commit and
// writes the new last_visible to *visible.
template <int N>
__device__ __forceinline__ i64 commit_row(const i64 (&m)[N], const i64 (&c)[N],
                                          unsigned vm, unsigned om,
                                          i64 self_flushed, bool leader,
                                          i64 term_start, i64 commit,
                                          i64* visible) {
    // clamp to the leader's own flushed / dirty offset (slot 0)
    const i64 majority = imin(lane_majority(c, vm, om), self_flushed);
    const i64 majority_dirty = imin(lane_majority(m, vm, om), m[0]);
    const bool lead = leader && vm != 0u;
    const bool advance = lead && majority > commit && majority >= term_start;
    const i64 new_commit = advance ? majority : commit;
    if (lead) *visible = imax(*visible, imax(new_commit, majority_dirty));
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
