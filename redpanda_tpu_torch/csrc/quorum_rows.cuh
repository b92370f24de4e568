// Row loads and the per-row health rule, shared by the commit sweep and
// the tick frame (quorum.cu) and the health reduction (health.cu).
//
//   load_row / load_mask  one row of an i64 lane / a bool lane, as 16-byte
//                         vectors and one 8-byte word a group of 8 slots
//                         (R a multiple of 8 at aligned addresses) with the
//                         streaming hint, else slot by slot
//   row_health            ops/health.py:39 for one row held in registers
//   count_row             a row's part of the mesh frame's fleet totals
//                         (redpanda_tpu/parallel/mesh_frame.py:63)

#pragma once

#include "quorum_rules.cuh"

typedef unsigned char u8;

// a row's R slots of an i64 lane, past R i64 min (never selected);
// kAligned: R a multiple of 8 and 16-byte aligned lanes, 16-byte loads
// with the streaming hint (each byte is read once)
template <int N, bool kAligned>
__device__ __forceinline__ void load_row(const i64* lane, i64 base, int r_n, i64 (&v)[N]) {
    if (kAligned) {
        const longlong2* p = reinterpret_cast<const longlong2*>(lane + base);
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
            longlong2 x = make_longlong2(RP_I64_MIN, RP_I64_MIN);
            if (2 * i < r_n) x = __ldcs(p + i);
            v[2 * i] = x.x;
            v[2 * i + 1] = x.y;
        }
    } else {
#pragma unroll
        for (int r = 0; r < N; ++r) v[r] = r < r_n ? lane[base + r] : RP_I64_MIN;
    }
}

// bit k set when byte k of w is nonzero
__device__ __forceinline__ unsigned nonzero_bytes(unsigned long long w) {
    w |= w >> 4;
    w |= w >> 2;
    w |= w >> 1;
    return (unsigned)(((w & 0x0101010101010101ull) * 0x0102040810204080ull) >> 56);
}

// a row's bool lane as a bitmask of its R slots; kAligned: one 8-byte
// word a group of 8 slots
template <int N, bool kAligned>
__device__ __forceinline__ unsigned load_mask(const u8* lane, i64 base, int r_n) {
    unsigned mask = 0u;
    if (kAligned) {
        const unsigned long long* p =
            reinterpret_cast<const unsigned long long*>(lane + base);
#pragma unroll
        for (int i = 0; i < N / 8; ++i)
            if (8 * i < r_n) mask |= nonzero_bytes(__ldcs(p + i)) << (8 * i);
    } else {
#pragma unroll
        for (int r = 0; r < N; ++r)
            if (r < r_n) mask |= (unsigned)(lane[base + r] != 0) << r;
    }
    return mask;
}

// self_dirty - match with the reference's wrapping int64 arithmetic
__device__ __forceinline__ i64 wrap_sub(i64 a, i64 b) {
    return (i64)((unsigned long long)a - (unsigned long long)b);
}

struct HealthRow {
    i64 max_lag;
    bool under, leaderless;
};

// The health of one row: m = its match lane (slot 0 = self), tracked =
// voter | old voter as a bitmask (no bit at or past R), commit = its
// commit index. lag = max(self_dirty - match, 0) over tracked slots;
// max_lag on active leaders; under_replicated when a tracked slot's
// match trails commit; leaderless when an active row neither leads nor
// knows a leader.
template <int N>
__device__ __forceinline__ HealthRow row_health(const i64 (&m)[N], unsigned tracked,
                                                i64 commit, bool leader, bool active,
                                                bool known) {
    i64 worst = 0;
    bool trails = false;
#pragma unroll
    for (int s = 0; s < N; ++s) {
        if (!((tracked >> s) & 1u)) continue;
        worst = imax(worst, wrap_sub(m[0], m[s]));
        trails |= m[s] < commit;
    }
    const bool lead = leader && active;
    return HealthRow{lead ? worst : 0, lead && trails, active && !leader && !known};
}

// The fleet totals' counters, in the order of ops/health.py TOTALS.
enum { T_ADVANCED, T_MAX_LAG, T_UNDER, T_LEADERLESS, T_ACTIVE, T_N };

// Add one row to a thread's totals: `advanced` when its commit moved in
// the frame; max_lag by max (never negative, so 0 is the initial value),
// the rest by sum.
__device__ __forceinline__ void count_row(i64 (&t)[T_N], const HealthRow& x, bool advanced,
                                          bool active) {
    t[T_ADVANCED] += advanced;
    t[T_MAX_LAG] = imax(t[T_MAX_LAG], x.max_lag);
    t[T_UNDER] += x.under;
    t[T_LEADERLESS] += x.leaderless;
    t[T_ACTIVE] += active;
}
