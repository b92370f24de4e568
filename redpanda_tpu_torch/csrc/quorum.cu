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
// and writes two [G] lanes, ~9.3 MB, ~2.8 us at 3.35 TB/s; at the mesh
// frame's 1M rows ~185 MB, ~55 us. The fold touches M random 8-byte cells
// of three lanes; the gather reads H random rows. At the tick's sizes one
// launch costs about as much as the work, so the launch count matters.
//
// Design:
//   * fold_replies is ONE cooperative launch. Every reply's seq guard must
//     read the PRE-batch last_seq: two replies for one (g, r) pair both
//     pass it, and a reply that raised last_seq before its duplicate read
//     it would drop a reply the reference keeps. So the grid is sized to
//     be co-resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor; the
//     cooperative launch fails rather than run otherwise), block b takes
//     `its` runs of consecutive replies, one a thread, and keeps their
//     guards in registers (its == 1, every batch of the tick) or as ballot
//     words in shared memory. Fresh replies raise match and flushed at
//     once (the guard never reads them); one grid barrier; then the fresh
//     replies raise last_seq. Max commutes, so the result does not depend
//     on the atomics' order. The barrier costs more with more blocks, and
//     a few big blocks leave SMs idle: 256-thread blocks while the batch
//     fits one a SM, else 1,024-thread blocks.
//   * quorum_commit_step runs one thread per group. A row's match and
//     flushed come in as 16-byte vectors and each voter mask as one 8-byte
//     word a group of 8 slots, all with the streaming hint (rows of a
//     multiple of 8 slots at aligned addresses; other rows load slot by
//     slot). No row is sorted: one compare per pair of slots builds rank
//     masks (quorum_rules.cuh) that the current and the old voter set
//     share, and the order statistic is the masked slot with the right
//     masked rank. R <= 32, padded to 8, 16 or 32 slots in registers.
//     128-thread blocks spread the tick's 50k rows over more SMs than 256.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quorum_rules.cuh"

typedef unsigned char u8;

#define THREADS 256
// the fold's launch shape by batch size: 256-thread blocks while that
// spreads the batch over at most one block an SM, else 1,024-thread
// blocks (the grid barrier's cost grows with the block count)
#define FOLD_FEW_THREADS 256
#define FOLD_THREADS 1024
// the ballot words of a block's runs live in at most 48 KB
#define FOLD_MAX_SMEM (48 * 1024)
#define COMMIT_THREADS 128

static inline unsigned blocks_for(i64 n) {
    return (unsigned)((n + THREADS - 1) / THREADS);
}

// ---------------------------------------------------------------- fold
// kOneRun: one reply a thread (its == 1), held in registers across the
// barrier; else `its` runs of kThreads replies a block, the guards kept
// as ballot words in shared memory and the fresh replies read again
// after the barrier.
template <int kThreads, bool kOneRun>
__global__ void __launch_bounds__(kThreads)
fold_kernel(i64* __restrict__ match, i64* __restrict__ flushed,
            i64* last_seq,  // read before the barrier, raised after it
            const i64* __restrict__ group_idx, const i64* __restrict__ slot,
            const i64* __restrict__ dirty, const i64* __restrict__ flushed_in,
            const i64* __restrict__ seq, i64 m, i64 g_n, i64 r_n, int its) {
    constexpr int kWarps = kThreads / 32;
    extern __shared__ unsigned fresh_words[];  // its * kWarps ballots
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const i64 first = (i64)blockIdx.x * its * kThreads + threadIdx.x;
    if (kOneRun) {
        bool fresh = false;
        i64 k = 0, sq = 0, d = 0, fl = 0;
        if (first < m) {
            const i64 g = group_idx[first], r = slot[first];
            sq = seq[first];
            d = dirty[first];  // loaded beside the guard's inputs, not after it
            fl = flushed_in[first];
            if (g >= 0 && g < g_n && r >= 0 && r < r_n) {  // else skipped
                k = g * r_n + r;
                fresh = sq > last_seq[k];
            }
        }
        // match and flushed never feed a guard: raise them before the barrier
        if (fresh) {
            atomicMax(&match[k], d);
            atomicMax(&flushed[k], fl);
        }
        // no last_seq cell moves before every guard of the batch has read it
        cooperative_groups::this_grid().sync();
        if (fresh) atomicMax(&last_seq[k], sq);
        return;
    }
    for (int s = 0; s < its; ++s) {
        const i64 i = first + (i64)s * kThreads;
        bool fresh = false;
        if (i < m) {
            const i64 g = group_idx[i], r = slot[i];
            if (g >= 0 && g < g_n && r >= 0 && r < r_n) {
                const i64 k = g * r_n + r;
                fresh = seq[i] > last_seq[k];
                if (fresh) {
                    atomicMax(&match[k], dirty[i]);
                    atomicMax(&flushed[k], flushed_in[i]);
                }
            }
        }
        const unsigned w = __ballot_sync(0xffffffffu, fresh);
        if (lane == 0) fresh_words[s * kWarps + warp] = w;
    }
    cooperative_groups::this_grid().sync();
    for (int s = 0; s < its; ++s) {
        if ((fresh_words[s * kWarps + warp] >> lane) & 1u) {
            const i64 i = first + (i64)s * kThreads;
            atomicMax(&last_seq[group_idx[i] * r_n + slot[i]], seq[i]);
        }
    }
}

static const void* fold_instance(int threads, bool one_run) {
    if (threads == FOLD_FEW_THREADS)
        return one_run ? (const void*)fold_kernel<FOLD_FEW_THREADS, true>
                       : (const void*)fold_kernel<FOLD_FEW_THREADS, false>;
    return one_run ? (const void*)fold_kernel<FOLD_THREADS, true>
                   : (const void*)fold_kernel<FOLD_THREADS, false>;
}

// The fold's co-resident grid for m replies: blocks of `threads`, each
// taking `its` runs of `threads` replies, with as few runs a block as the
// occupancy at that run count's shared memory allows.
struct FoldGrid {
    int blocks, threads, its;
    size_t smem;
};

static cudaError_t fold_grid(i64 m, FoldGrid* out) {
    static int sms_of[64];  // per device; 0 = not yet asked
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= 64) return cudaErrorInvalidDevice;
    if (sms_of[dev] == 0) {
        int sms = 0;
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return e;
        sms_of[dev] = sms;
    }
    const i64 sms = sms_of[dev];
    const int threads = m <= (i64)FOLD_FEW_THREADS * sms ? FOLD_FEW_THREADS : FOLD_THREADS;
    const size_t words = (size_t)(threads / 32) * sizeof(unsigned);  // a run's ballots
    i64 its = 1;
    for (int tries = 0; tries < 16; ++tries) {
        const size_t smem = (size_t)its * words;
        if (smem > FOLD_MAX_SMEM) break;
        int occ = 0;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fold_instance(threads, its == 1),
                                                          threads, smem);
        if (e != cudaSuccess) return e;
        const i64 co_resident = (i64)occ * sms;
        if (co_resident <= 0) break;
        const i64 blocks = (m + its * threads - 1) / (its * threads);
        if (blocks <= co_resident) {
            *out = FoldGrid{(int)blocks, threads, (int)its, smem};
            return cudaSuccess;
        }
        its = (m + co_resident * threads - 1) / (co_resident * threads);
    }
    return cudaErrorCooperativeLaunchTooLarge;
}

// --------------------------------------------------------------- commit
// a row's R slots of an i64 lane, past R i64 min (never selected);
// kAligned: R a multiple of 8 and 16-byte aligned lanes, 16-byte loads
// with the streaming hint (each byte is read once)
template <int N, bool kAligned>
__device__ __forceinline__ void load_row(const i64* __restrict__ lane, i64 base,
                                         int r_n, i64 (&v)[N]) {
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
__device__ __forceinline__ unsigned load_mask(const u8* __restrict__ lane, i64 base,
                                              int r_n) {
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

template <int N, bool kAligned>
__global__ void __launch_bounds__(COMMIT_THREADS)
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
    load_row<N, kAligned>(match, base, r_n, m);
    load_row<N, kAligned>(flushed, base, r_n, c);
    const unsigned vm = load_mask<N, kAligned>(voter, base, r_n);
    const unsigned om = load_mask<N, kAligned>(voter_old, base, r_n);
    const bool leader = is_leader[g] != 0;
    const i64 ts = term_start[g], old_commit = commit[g], lv = last_visible[g];
    const i64 self_flushed = c[0];
#pragma unroll
    for (int r = 0; r < N; ++r) c[r] = imin(c[r], m[r]);  // match_committed_index
    i64 nv = lv;
    commit[g] = commit_row(m, c, vm, om, self_flushed, leader, ts, old_commit, &nv);
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

int rp_fold_grid(i64 m, i64* out) {
    FoldGrid grid;
    const cudaError_t e = fold_grid(m, &grid);
    if (e == cudaSuccess) {
        out[0] = grid.blocks;
        out[1] = grid.threads;
        out[2] = grid.its;
    }
    return (int)e;
}

int rp_fold_replies(i64* match, i64* flushed, i64* last_seq,
                    const i64* group_idx, const i64* slot, const i64* dirty,
                    const i64* flushed_in, const i64* seq, i64 m, i64 g_n,
                    i64 r_n, void* stream) {
    if (m <= 0) return 0;
    FoldGrid grid;
    cudaError_t e = fold_grid(m, &grid);
    if (e != cudaSuccess) return (int)e;
    int its = grid.its;
    void* args[] = {&match, &flushed, &last_seq, &group_idx, &slot, &dirty,
                    &flushed_in, &seq, &m, &g_n, &r_n, &its};
    e = cudaLaunchCooperativeKernel(fold_instance(grid.threads, its == 1),
                                    dim3(grid.blocks), dim3(grid.threads), args,
                                    grid.smem, (cudaStream_t)stream);
    const cudaError_t last = cudaGetLastError();  // clears a refused launch
    return (int)(e != cudaSuccess ? e : last);
}

int rp_commit_step(const i64* term_start, const u8* is_leader, i64* commit,
                   i64* last_visible, const i64* match, const i64* flushed,
                   const u8* voter, const u8* voter_old, i64 g_n, i64 r_n,
                   void* stream) {
    if (g_n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned blocks = (unsigned)((g_n + COMMIT_THREADS - 1) / COMMIT_THREADS);
    const bool aligned = r_n % 8 == 0 && (uintptr_t)match % 16 == 0 &&
                         (uintptr_t)flushed % 16 == 0 && (uintptr_t)voter % 8 == 0 &&
                         (uintptr_t)voter_old % 8 == 0;
#define RP_COMMIT_LAUNCH(NS, AL)                                               \
    commit_step_kernel<NS, AL><<<blocks, COMMIT_THREADS, 0, s>>>(              \
        term_start, is_leader, commit, last_visible, match, flushed, voter,    \
        voter_old, g_n, (int)r_n)
    if (r_n <= 8) {
        if (aligned) RP_COMMIT_LAUNCH(8, true);
        else RP_COMMIT_LAUNCH(8, false);
    } else if (r_n <= 16) {
        if (aligned) RP_COMMIT_LAUNCH(16, true);
        else RP_COMMIT_LAUNCH(16, false);
    } else {
        if (aligned) RP_COMMIT_LAUNCH(32, true);
        else RP_COMMIT_LAUNCH(32, false);
    }
#undef RP_COMMIT_LAUNCH
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
