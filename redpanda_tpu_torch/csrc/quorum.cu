// Batched quorum kernels for the replication tick: the reply fold, the
// commit sweep, the heartbeat gather and the whole tick frame in one
// launch; the mesh frame's sweep with its health and fleet totals; and
// the two follower-side rules.
//
// Replaces (redpanda_tpu/ops/quorum.py, and ops/health.py for the frame):
//   fold_replies          :172  scatter-max of M replies into [G, R] lanes
//   quorum_commit_step    :110  masked majority order statistic per group
//   build_heartbeats      :196  gather of the heartbeat payload fields
//   tick_frame            :283  fold, sweep, gather (health.py:90
//                               tick_frame_health: and the row health)
//   follower_commit_step  :154  commit = min(leader_commit, flushed[0])
//   local_append_update   :211  scatter-max of M appends into slot 0
// and redpanda_tpu/parallel/mesh_frame.py:63 mesh_tick_frame (fold, sweep,
// row health, fleet totals) as the fold kernel and mesh_sweep_kernel.
//
// What bounds them on an H100: bytes. At G = 50,000, R = 8 the commit
// sweep reads four [G, R] lanes (two i64, two bool) plus five [G] lanes
// and writes two [G] lanes, ~9.3 MB, ~2.8 us at 3.35 TB/s; at the mesh
// frame's 1M rows ~185 MB, ~55 us. The fold touches M random 8-byte cells
// of three lanes; the gather reads H random rows. At the tick's sizes one
// launch costs about as much as the work, so the launch count matters.
//
// Indices follow JAX's rule: a row in [-G, 0) or a slot in [-R, 0) counts
// from the end, once; the scatters (fold, local append) then drop what is
// still out of range and the gather clamps it to [0, G - 1].
//
// Design:
//   * fold_replies is ONE cooperative launch. Every reply's seq guard must
//     read the PRE-batch last_seq: two replies for one (g, r) pair both
//     pass it, and a reply that raised last_seq before its duplicate read
//     it would drop a reply the reference keeps. So the grid is sized to
//     be co-resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor; the
//     cooperative launch fails rather than run otherwise), block b takes
//     `its` runs of consecutive replies, one a thread, and keeps their
//     guards in registers (its == 1) or as ballot words in shared memory.
//     Fresh replies raise match and flushed at once (the guard never
//     reads them); one grid barrier; then the fresh replies raise
//     last_seq. Max commutes, so the result does not depend on the
//     atomics' order. The barrier costs more with more blocks, and a few
//     big blocks leave SMs idle: 256-thread blocks while the batch fits
//     one a SM, else 1,024-thread blocks.
//   * quorum_commit_step runs one thread per group. A row's match and
//     flushed come in as 16-byte vectors and each voter mask as one 8-byte
//     word a group of 8 slots (quorum_rows.cuh). No row is sorted: one
//     compare per pair of slots builds rank masks (quorum_rules.cuh) that
//     the current and the old voter set share, and the order statistic is
//     the masked slot with the right masked rank. R <= 32, padded to 8, 16
//     or 32 slots in registers. 128-thread blocks spread the tick's 50k
//     rows over more SMs than 256.
//   * tick_frame (and tick_frame_health: the health lanes are nullable)
//     is ONE cooperative launch of three phases. A: the fold above, with
//     its barrier; up to two replies a thread stay in registers (the
//     tick's 131,072-reply bucket is two at 256-thread blocks). B: the
//     sweep over rows and from the same registers the row's health (two
//     [G] flags read, three [G] lanes written: the standalone
//     health_reduce re-reads the [G, R] lanes). A second grid barrier,
//     because the heartbeat rows are arbitrary and were swept by other
//     threads; then C: the gather. Each launch boundary it removes cost
//     ~4-4.5 us inside the frame's launch sequence, a grid barrier ~1.3
//     us. What the sweep and the gather read that no phase writes is
//     loaded at the start, beside the fold's loads. Rows and heartbeat rows go to blocks in warp-sized chunks
//     round-robin, so the SMs share them evenly. The grid is sized for
//     the fold (`its` runs a block, as the fold's) and spread over the
//     rows up to co-residency (frame_grid).
//   * the mesh frame is the fold kernel, then mesh_sweep_kernel, which
//     reads every row once: the sweep, the row's health against the new
//     commit from the same registers, and the row counted into the five
//     fleet totals (`advanced` from the commit it loaded and the one it
//     wrote, so no copy of the lane is taken). A block takes MESH_ROWS x
//     128 consecutive rows, reduces its counters in the warp and then the
//     block, and adds them into one of TOTALS_SETS accumulator sets, a
//     128-byte line each (one line for every block's atomics cost ~6 us
//     at 1M rows); the last block to draw the ticket folds the sets
//     (chip_blocks.cuh grid_totals), so no zero fill and no fold launch
//     runs. Four rows a thread: ~1,954 blocks at 1M rows, each block's
//     reduction and ticket paid a quarter as often as at one row a
//     thread (-2.6 us; two, three, six and eight rows were slower). The
//     one-launch design (the tick frame kernel's fold and sweep with the
//     totals, measured from chip_quorum.py) lost by ~1.8 us: its
//     co-resident grid (two 256-thread blocks an SM at ~105 registers)
//     sweeps rows ~5 us slower than an ordinary launch, more than the
//     fold launch it saves.
//   * build_heartbeats alone is a one-row-a-thread gather.
//   * follower_commit_step: FOLLOW_ROWS consecutive rows a thread. Its
//     bytes are the three [G] lanes (commit, leader_commit, last_visible:
//     16-byte vectors with the streaming hint where the lanes are 16-byte
//     aligned, else one row at a time) and slot 0's column of flushed, R
//     slots apart, so each value read costs a 32-byte sector; the rule
//     reads it only where leader_commit > commit, so only those rows load
//     it, all of a thread's loads issued before the first compare. Every
//     row's visible becomes max(visible, new commit) (a row with no update
//     still raises a lagging visible to its commit); a vector that no row
//     changed is not written back. local_append_update raises slot 0 by atomicMax
//     (one batch may name a row twice): a small batch one append a thread
//     (local_append_kernel), a large one in 2 * parts passes of one
//     launch, a lane and a part of the rows each
//     (local_append_parts_kernel; the caller picks parts): each atomic
//     lands on a random 32-byte sector, and the fewer lines the blocks in
//     flight touch, the more of them L2 still holds when the next append
//     to the row arrives. Both rules live in quorum_rules.cuh (the passes
//     take local_append's max lane by lane), where the ring cluster step
//     (cluster.cu) applies them to its mirrors and its self slot.
// All of them update or read the lanes in place; the JAX program donates
// its state buffers the same way (donate_argnums=0).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chip_blocks.cuh"
#include "quorum_rows.cuh"

#define THREADS 256
// the fold's launch shape by batch size: 256-thread blocks while that
// spreads the batch over at most one block an SM, else 1,024-thread
// blocks (the grid barrier's cost grows with the block count)
#define FOLD_FEW_THREADS 256
#define FOLD_THREADS 1024
// the ballot words of a block's runs live in at most 48 KB
#define FOLD_MAX_SMEM (48 * 1024)
#define COMMIT_THREADS 128
// rows a thread of the mesh frame's sweep kernel
#define MESH_ROWS 4
// rows a thread of the follower rule (a multiple of 2: 16-byte vectors)
#define FOLLOW_ROWS 4
// the frame's block: the sweep holds a row in registers (72 at R <= 8,
// 140 at R <= 16, 255 at R <= 32), so a block of 256 threads keeps
// every instance within the register file
#define FRAME_THREADS 256

static inline unsigned blocks_for(i64 n) {
    return (unsigned)((n + THREADS - 1) / THREADS);
}

// ------------------------------------------------------------- indices
// JAX's rule for an index into an axis of n: one in [-n, 0) counts from
// the end, once
__device__ __forceinline__ i64 wrap_index(i64 i, i64 n) { return i < 0 ? i + n : i; }

// the scatter's cell of (g, r), or -1 where it is still out of range
// (dropped)
__device__ __forceinline__ i64 scatter_cell(i64 g, i64 r, i64 g_n, i64 r_n) {
    g = wrap_index(g, g_n);
    r = wrap_index(r, r_n);
    return (g >= 0 && g < g_n && r >= 0 && r < r_n) ? g * r_n + r : -1;
}

// the gather's row: wrapped, then clamped to [0, g_n - 1]
__device__ __forceinline__ i64 gather_row(i64 g, i64 g_n) {
    g = wrap_index(g, g_n);
    return g < 0 ? 0 : (g >= g_n ? g_n - 1 : g);
}

static cudaError_t sm_count(int* out) {
    static int sms_of[64];  // per device; 0 = not yet asked
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= 64) return cudaErrorInvalidDevice;
    if (sms_of[dev] == 0) {
        e = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return e;
    }
    *out = sms_of[dev];
    return cudaSuccess;
}

// ---------------------------------------------------------------- fold
// The fold of a co-resident grid's replies, grid barrier included. Block
// b takes replies [b * its * kThreads, (b + 1) * its * kThreads), a thread
// every kThreads-th. kRegRuns > 0: its == kRegRuns, each thread's replies
// loaded at once and held in registers across the barrier; 0: `its` runs,
// the guards kept as ballot words in shared memory and the fresh replies
// read again after the barrier. match, flushed and last_seq are not
// __restrict__: the frame reads match and flushed again after the barrier.
template <int kThreads, int kRegRuns>
__device__ __forceinline__ void fold_phase(
    i64* match, i64* flushed, i64* last_seq, const i64* __restrict__ group_idx,
    const i64* __restrict__ slot, const i64* __restrict__ dirty,
    const i64* __restrict__ flushed_in, const i64* __restrict__ seq, i64 m, i64 g_n,
    i64 r_n, int its, unsigned* fresh_words) {
    constexpr int kWarps = kThreads / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const i64 first = (i64)blockIdx.x * its * kThreads + threadIdx.x;
    if (kRegRuns > 0) {
        constexpr int kRuns = kRegRuns > 0 ? kRegRuns : 1;
        i64 k[kRuns], sq[kRuns], d[kRuns], fl[kRuns];
        bool fresh[kRuns];
#pragma unroll
        for (int s = 0; s < kRuns; ++s) {
            const i64 i = first + (i64)s * kThreads;
            k[s] = -1;
            sq[s] = d[s] = fl[s] = 0;
            if (i < m) {
                k[s] = scatter_cell(group_idx[i], slot[i], g_n, r_n);
                sq[s] = seq[i];
                d[s] = dirty[i];  // loaded beside the guard's inputs, not after it
                fl[s] = flushed_in[i];
            }
        }
#pragma unroll
        for (int s = 0; s < kRuns; ++s) fresh[s] = k[s] >= 0 && sq[s] > last_seq[k[s]];
        // match and flushed never feed a guard: raise them before the barrier
#pragma unroll
        for (int s = 0; s < kRuns; ++s)
            if (fresh[s]) {
                atomicMax(&match[k[s]], d[s]);
                atomicMax(&flushed[k[s]], fl[s]);
            }
        // no last_seq cell moves before every guard of the batch has read it
        cooperative_groups::this_grid().sync();
#pragma unroll
        for (int s = 0; s < kRuns; ++s)
            if (fresh[s]) atomicMax(&last_seq[k[s]], sq[s]);
        return;
    }
    for (int s = 0; s < its; ++s) {
        const i64 i = first + (i64)s * kThreads;
        bool fresh = false;
        if (i < m) {
            const i64 k = scatter_cell(group_idx[i], slot[i], g_n, r_n);
            fresh = k >= 0 && seq[i] > last_seq[k];
            if (fresh) {
                atomicMax(&match[k], dirty[i]);
                atomicMax(&flushed[k], flushed_in[i]);
            }
        }
        const unsigned w = __ballot_sync(0xffffffffu, fresh);
        if (lane == 0) fresh_words[s * kWarps + warp] = w;
    }
    cooperative_groups::this_grid().sync();
    for (int s = 0; s < its; ++s) {
        if ((fresh_words[s * kWarps + warp] >> lane) & 1u) {
            const i64 i = first + (i64)s * kThreads;
            atomicMax(&last_seq[scatter_cell(group_idx[i], slot[i], g_n, r_n)], seq[i]);
        }
    }
}

template <int kThreads, bool kOneRun>
__global__ void __launch_bounds__(kThreads)
fold_kernel(i64* __restrict__ match, i64* __restrict__ flushed,
            i64* last_seq,  // read before the barrier, raised after it
            const i64* __restrict__ group_idx, const i64* __restrict__ slot,
            const i64* __restrict__ dirty, const i64* __restrict__ flushed_in,
            const i64* __restrict__ seq, i64 m, i64 g_n, i64 r_n, int its) {
    extern __shared__ unsigned fresh_words[];  // its * kWarps ballots
    fold_phase<kThreads, kOneRun ? 1 : 0>(match, flushed, last_seq, group_idx, slot, dirty,
                                          flushed_in, seq, m, g_n, r_n, its, fresh_words);
}

static const void* fold_instance(int threads, bool one_run) {
    if (threads == FOLD_FEW_THREADS)
        return one_run ? (const void*)fold_kernel<FOLD_FEW_THREADS, true>
                       : (const void*)fold_kernel<FOLD_FEW_THREADS, false>;
    return one_run ? (const void*)fold_kernel<FOLD_THREADS, true>
                   : (const void*)fold_kernel<FOLD_THREADS, false>;
}

// A co-resident grid of `threads`-thread blocks for m replies, each block
// taking `its` runs of `threads` replies, with as few runs a block as the
// occupancy at that run count's shared memory allows, and at least
// `spread` blocks where the occupancy allows them.
struct CoopGrid {
    int blocks, threads, its;
    size_t smem;
};

template <typename Instance>
static cudaError_t coop_grid(i64 m, int threads, i64 spread, Instance instance,
                             CoopGrid* out) {
    int sms = 0;
    cudaError_t e = sm_count(&sms);
    if (e != cudaSuccess) return e;
    const size_t words = (size_t)(threads / 32) * sizeof(unsigned);  // a run's ballots
    i64 its = 1;
    for (int tries = 0; tries < 16; ++tries) {
        const size_t smem = (size_t)its * words;
        if (smem > FOLD_MAX_SMEM) break;
        int occ = 0;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, instance(its == 1), threads,
                                                          smem);
        if (e != cudaSuccess) return e;
        const i64 co_resident = (i64)occ * sms;
        if (co_resident <= 0) break;
        const i64 blocks = (m + its * threads - 1) / (its * threads);
        if (blocks <= co_resident) {
            const i64 wide = spread < co_resident ? spread : co_resident;
            const i64 n = blocks > wide ? blocks : (wide > 0 ? wide : 1);
            *out = CoopGrid{(int)n, threads, (int)its, smem};
            return cudaSuccess;
        }
        its = (m + co_resident * threads - 1) / (co_resident * threads);
    }
    return cudaErrorCooperativeLaunchTooLarge;
}

// the fold alone: 256-thread blocks while the batch fits one a SM
static cudaError_t fold_grid(i64 m, CoopGrid* out) {
    int sms = 0;
    cudaError_t e = sm_count(&sms);
    if (e != cudaSuccess) return e;
    const int threads = m <= (i64)FOLD_FEW_THREADS * sms ? FOLD_FEW_THREADS : FOLD_THREADS;
    return coop_grid(m, threads, 0, [threads](bool one_run) {
        return fold_instance(threads, one_run);
    }, out);
}

// --------------------------------------------------------------- commit
// The per-row inputs of the commit rule other than match and flushed:
// the voter bitmasks and four [G] lanes.
struct RowFlags {
    unsigned vm, om;
    bool leader;
    i64 term_start, commit, visible;
};

template <int N, bool kAligned>
__device__ __forceinline__ RowFlags load_flags(const i64* term_start, const u8* is_leader,
                                               const i64* commit, const i64* last_visible,
                                               const u8* voter, const u8* voter_old, i64 g,
                                               int r_n) {
    const i64 base = g * r_n;
    return RowFlags{load_mask<N, kAligned>(voter, base, r_n),
                    load_mask<N, kAligned>(voter_old, base, r_n), is_leader[g] != 0,
                    term_start[g], commit[g], last_visible[g]};
}

// The commit rule of row g: loads its match (m, past R i64 min) and
// flushed, writes commit and, where it moved, last_visible; returns the
// new commit.
template <int N, bool kAligned>
__device__ __forceinline__ i64 sweep_row(const RowFlags& f, i64* commit, i64* last_visible,
                                         const i64* match, const i64* flushed, i64 g,
                                         int r_n, i64 (&m)[N]) {
    const i64 base = g * r_n;
    i64 c[N];
    load_row<N, kAligned>(match, base, r_n, m);
    load_row<N, kAligned>(flushed, base, r_n, c);
    const i64 self_flushed = c[0];
#pragma unroll
    for (int r = 0; r < N; ++r) c[r] = imin(c[r], m[r]);  // match_committed_index
    i64 nv = f.visible;
    const i64 nc = commit_row(m, c, f.vm, f.om, self_flushed, f.leader, f.term_start,
                              f.commit, &nv);
    commit[g] = nc;
    if (nv != f.visible) last_visible[g] = nv;
    return nc;
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
    i64 m[N];
    const RowFlags f = load_flags<N, kAligned>(term_start, is_leader, commit, last_visible,
                                               voter, voter_old, g, r_n);
    sweep_row<N, kAligned>(f, commit, last_visible, match, flushed, g, r_n, m);
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
    const i64 g = gather_row(hb_idx[i], g_n);
    o_term[i] = term[g];
    o_commit[i] = commit[g];
    o_dirty[i] = match[g * r_n];  // SELF_SLOT
    o_visible[i] = last_visible[g];
}

// ---------------------------------------------------------- tick frame
struct FrameLanes {
    const i64* term;
    const u8* is_leader;
    i64* commit;
    const i64* term_start;
    i64* last_visible;
    i64* match;
    i64* flushed;
    i64* last_seq;
    const u8* voter;
    const u8* voter_old;
};

struct FrameReplies {
    const i64 *group_idx, *slot, *dirty, *flushed, *seq;
};

struct FrameBeats {
    const i64* idx;
    i64 *term, *commit, *dirty, *visible;
};

// max_lag == nullptr: no health
struct FrameHealth {
    const u8 *leader_known, *active;
    i64* max_lag;
    u8 *under, *leaderless;
};

// The fleet totals: the accumulators and the ticket (grid_totals), and
// the [5] output.
struct FrameTotals {
    i64* acc;
    unsigned long long* ticket;
    i64* out;
};

// Row g of the sweep, then, with health, the row's health from the same
// registers, written to the health lanes. Returns the health (zero without)
// and the new commit in *c.
template <int N, bool kAligned>
__device__ __forceinline__ HealthRow frame_row(const FrameLanes& s, const FrameHealth& hh,
                                               const RowFlags& f, bool known, bool active,
                                               bool health, i64 g, int r_n, i64* c) {
    i64 row[N];
    *c = sweep_row<N, kAligned>(f, s.commit, s.last_visible, s.match, s.flushed, g, r_n, row);
    HealthRow x = {0, false, false};
    if (health) {
        x = row_health<N>(row, f.vm | f.om, *c, f.leader, active, known);
        hh.max_lag[g] = x.max_lag;
        hh.under[g] = x.under;
        hh.leaderless[g] = x.leaderless;
    }
    return x;
}

// Phase order: no last_seq write before barrier 1 (fold_phase), no read
// of match or flushed before it; no read of commit or last_visible by the
// gather before barrier 2. What a later phase reads that no earlier phase
// writes (the thread's first row's voter masks and [G] lanes, its first
// heartbeat row's index and term) is loaded at the start, beside the
// fold's loads, and waits out the barriers in registers. m == 0 skips the
// fold and its barrier, h == 0 the gather and its barrier (uniform over
// the grid). Rows and heartbeat rows are dealt in warp-sized chunks
// round-robin over the blocks, so every SM sweeps about as many rows
// whatever the grid.
template <int N, bool kAligned>
__global__ void __launch_bounds__(FRAME_THREADS)
tick_frame_kernel(FrameLanes s, FrameReplies rp, FrameBeats hb, FrameHealth hh, i64 m,
                  i64 h, i64 g_n, int r_n, int its) {
    extern __shared__ unsigned fresh_words[];  // its * warps ballots (its > 2)
    const i64 warps = (i64)gridDim.x * (FRAME_THREADS / 32);
    const i64 first = ((i64)(threadIdx.x >> 5) * gridDim.x + blockIdx.x) * 32 + (threadIdx.x & 31);
    const i64 stride = warps * 32;
    const bool health = hh.max_lag != nullptr;
    RowFlags f0 = {};
    bool known0 = false, active0 = false;
    if (first < g_n) {
        f0 = load_flags<N, kAligned>(s.term_start, s.is_leader, s.commit, s.last_visible,
                                     s.voter, s.voter_old, first, r_n);
        if (health) {
            known0 = hh.leader_known[first] != 0;
            active0 = hh.active[first] != 0;
        }
    }
    i64 g0 = 0, term0 = 0;
    if (first < h) {
        g0 = gather_row(hb.idx[first], g_n);
        term0 = s.term[g0];
    }
    // A. the fold, barrier 1 inside
    if (m > 0) {
#define RP_FOLD(RUNS)                                                                  \
    fold_phase<FRAME_THREADS, RUNS>(s.match, s.flushed, s.last_seq, rp.group_idx, rp.slot, \
                                    rp.dirty, rp.flushed, rp.seq, m, g_n, r_n, its,       \
                                    fresh_words)
        if (its == 1) RP_FOLD(1);
        else if (its == 2) RP_FOLD(2);
        else RP_FOLD(0);
#undef RP_FOLD
    }
    // B. the sweep, and each row's health from the registers it loaded
    for (i64 g = first; g < g_n; g += stride) {
        RowFlags f = f0;
        bool known = known0, active = active0;
        if (g != first) {
            f = load_flags<N, kAligned>(s.term_start, s.is_leader, s.commit, s.last_visible,
                                        s.voter, s.voter_old, g, r_n);
            if (health) {
                known = hh.leader_known[g] != 0;
                active = hh.active[g] != 0;
            }
        }
        i64 c;
        frame_row<N, kAligned>(s, hh, f, known, active, health, g, r_n, &c);
    }
    // C. the gather reads rows other threads swept
    if (h > 0) {
        cooperative_groups::this_grid().sync();
        for (i64 i = first; i < h; i += stride) {
            const i64 g = i == first ? g0 : gather_row(hb.idx[i], g_n);
            hb.term[i] = i == first ? term0 : s.term[g];
            // through L2: other SMs wrote these lanes before the barrier
            hb.commit[i] = __ldcg(s.commit + g);
            hb.dirty[i] = __ldcg(s.match + g * r_n);  // SELF_SLOT
            hb.visible[i] = __ldcg(s.last_visible + g);
        }
    }
}

// The mesh frame's sweep, an ordinary launch after the fold kernel: the
// block takes MESH_ROWS * COMMIT_THREADS consecutive rows, a thread every
// COMMIT_THREADS-th, each swept with its health and counted into the
// fleet totals, which the blocks fold at the end (grid_totals).
template <int N, bool kAligned>
__global__ void __launch_bounds__(COMMIT_THREADS)
mesh_sweep_kernel(FrameLanes s, FrameHealth hh, FrameTotals tt, i64 g_n, int r_n) {
    const i64 first = (i64)blockIdx.x * COMMIT_THREADS * MESH_ROWS + threadIdx.x;
    i64 t[T_N] = {0, 0, 0, 0, 0};
#pragma unroll 1
    for (int j = 0; j < MESH_ROWS; ++j) {
        const i64 g = first + (i64)j * COMMIT_THREADS;
        if (g < g_n) {
            const RowFlags f = load_flags<N, kAligned>(s.term_start, s.is_leader, s.commit,
                                                       s.last_visible, s.voter, s.voter_old, g,
                                                       r_n);
            const bool active = hh.active[g] != 0;
            i64 c;
            const HealthRow x = frame_row<N, kAligned>(s, hh, f, hh.leader_known[g] != 0, active,
                                                       true, g, r_n, &c);
            count_row(t, x, c > f.commit, active);
        }
    }
    grid_totals<T_N>(t, 1u << T_MAX_LAG, tt.acc, tt.ticket, tt.out);
}

// the instance for R slots (padded to 8, 16 or 32) and the lanes' alignment
static const void* frame_instance(i64 r_n, bool aligned) {
    if (r_n <= 8)
        return aligned ? (const void*)tick_frame_kernel<8, true>
                       : (const void*)tick_frame_kernel<8, false>;
    if (r_n <= 16)
        return aligned ? (const void*)tick_frame_kernel<16, true>
                       : (const void*)tick_frame_kernel<16, false>;
    return aligned ? (const void*)tick_frame_kernel<32, true>
                   : (const void*)tick_frame_kernel<32, false>;
}

// the frame's grid: the fold's runs for m replies, spread over the
// max(G, H) rows up to co-residency
static cudaError_t frame_grid(i64 m, i64 rows, const void* kernel, CoopGrid* out) {
    return coop_grid(m, FRAME_THREADS, (rows + FRAME_THREADS - 1) / FRAME_THREADS,
                     [kernel](bool) { return kernel; }, out);
}

static bool aligned_rows(i64 r_n, const i64* match, const i64* flushed, const u8* voter,
                         const u8* voter_old) {
    return r_n % 8 == 0 && (uintptr_t)match % 16 == 0 && (uintptr_t)flushed % 16 == 0 &&
           (uintptr_t)voter % 8 == 0 && (uintptr_t)voter_old % 8 == 0;
}

// ------------------------------------------------------ follower rules
// FOLLOW_ROWS consecutive rows a thread. kAligned: the three [G] lanes are
// 16-byte aligned, so a thread whose rows all exist moves them as vectors;
// otherwise (and for the grid's last rows) one row at a time.
template <bool kAligned>
__global__ void __launch_bounds__(THREADS)
follower_commit_kernel(i64* __restrict__ commit, i64* __restrict__ last_visible,
                       const i64* __restrict__ flushed, const i64* __restrict__ leader_commit,
                       i64 g_n, i64 r_n) {
    constexpr int K = FOLLOW_ROWS;
    const i64 g0 = ((i64)blockIdx.x * THREADS + threadIdx.x) * K;
    if (g0 >= g_n) return;
    const bool vec = kAligned && g0 + K <= g_n;
    i64 c[K], lc[K], vis[K], fl[K];
    if (vec) {
#pragma unroll
        for (int k = 0; k < K; k += 2) {
            const longlong2 x = __ldcs(reinterpret_cast<const longlong2*>(commit + g0 + k));
            const longlong2 y = __ldcs(reinterpret_cast<const longlong2*>(leader_commit + g0 + k));
            const longlong2 z = __ldcs(reinterpret_cast<const longlong2*>(last_visible + g0 + k));
            c[k] = x.x; c[k + 1] = x.y; lc[k] = y.x; lc[k + 1] = y.y; vis[k] = z.x; vis[k + 1] = z.y;
        }
    } else {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const bool in = g0 + k < g_n;
            c[k] = in ? __ldcs(commit + g0 + k) : 0;
            lc[k] = in ? __ldcs(leader_commit + g0 + k) : 0;  // 0 = commit: no update
            vis[k] = in ? __ldcs(last_visible + g0 + k) : 0;
        }
    }
    // slot 0's flushed only where the rule reads it, every load before a compare
#pragma unroll
    for (int k = 0; k < K; ++k) fl[k] = lc[k] > c[k] ? __ldcs(flushed + (g0 + k) * r_n) : 0;
    i64 nc[K], nv[K];
    bool moved = false, raised = false;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        nc[k] = follower_commit(c[k], lc[k], fl[k]);
        nv[k] = imax(vis[k], nc[k]);
        moved |= nc[k] != c[k];
        raised |= nv[k] != vis[k];
    }
    if (vec) {
#pragma unroll
        for (int k = 0; k < K; k += 2) {
            if (moved) __stcs(reinterpret_cast<longlong2*>(commit + g0 + k), make_longlong2(nc[k], nc[k + 1]));
            if (raised) __stcs(reinterpret_cast<longlong2*>(last_visible + g0 + k), make_longlong2(nv[k], nv[k + 1]));
        }
    } else {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            if (g0 + k >= g_n) break;
            if (nc[k] != c[k]) commit[g0 + k] = nc[k];
            if (nv[k] != vis[k]) last_visible[g0 + k] = nv[k];
        }
    }
}

// One append a thread, both lanes raised by the shared rule (atomicMax:
// a batch may name a row twice): the launch for small batches.
__global__ void local_append_kernel(i64* __restrict__ match,
                                    i64* __restrict__ flushed,
                                    const i64* __restrict__ group_idx,
                                    const i64* __restrict__ dirty,
                                    const i64* __restrict__ flushed_in, i64 m,
                                    i64 g_n, i64 r_n) {
    const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    const i64 k = scatter_cell(group_idx[i], 0, g_n, r_n);  // SELF_SLOT
    if (k < 0) return;  // the scatter drops it
    local_append<true>(&match[k], &flushed[k], dirty[i], flushed_in[i]);
}

// The local append in 2 * parts passes of one launch, pass q = blockIdx.y:
// it raises lane q / parts (match, then flushed) for the cells in part
// q % parts, [span * part, span * (part + 1)) with span = ceil(G / parts)
// rows of r_n cells, each thread reading one append's row and, where the
// row is in the part, the lane's value. Each atomic lands on a random
// 32-byte sector; at M = G = 1M the memory system sets the time, and the
// fewer lines the blocks in flight touch, the more of a row's appends
// find its line in L2 (PERF.md).
__global__ void local_append_parts_kernel(i64* __restrict__ match,
                                          i64* __restrict__ flushed,
                                          const i64* __restrict__ group_idx,
                                          const i64* __restrict__ dirty,
                                          const i64* __restrict__ flushed_in,
                                          i64 m, i64 g_n, i64 r_n, unsigned parts,
                                          i64 span) {
    const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    const i64 k = scatter_cell(group_idx[i], 0, g_n, r_n);  // SELF_SLOT
    const i64 lo = (i64)(blockIdx.y % parts) * span;
    if (k < lo || k >= lo + span) return;  // another part's, or dropped (k < 0)
    if (blockIdx.y < parts) {
        atomicMax(match + k, dirty[i]);
    } else {
        atomicMax(flushed + k, flushed_in[i]);
    }
}

// parts == 0: one append a thread; else 2 * parts passes
static cudaError_t launch_local_append(i64* match, i64* flushed, const i64* group_idx, const i64* dirty,
                                       const i64* flushed_in, i64 m, i64 g_n, i64 r_n, i64 parts,
                                       unsigned threads, cudaStream_t s) {
    const i64 blocks = (m + threads - 1) / threads;
    if (parts < 0 || 2 * parts > 65535 || blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
    if (parts == 0) {
        local_append_kernel<<<(unsigned)blocks, threads, 0, s>>>(match, flushed, group_idx, dirty, flushed_in, m,
                                                                 g_n, r_n);
    } else {
        local_append_parts_kernel<<<dim3((unsigned)blocks, (unsigned)(2 * parts)), threads, 0, s>>>(
            match, flushed, group_idx, dirty, flushed_in, m, g_n, r_n, (unsigned)parts,
            (g_n + parts - 1) / parts * r_n);
    }
    return cudaGetLastError();
}

// ------------------------------------------------------------ C entries
extern "C" {

const char* rp_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

int rp_fold_grid(i64 m, i64* out) {
    CoopGrid grid;
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
    CoopGrid grid;
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
    const bool aligned = aligned_rows(r_n, match, flushed, voter, voter_old);
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

// out: blocks, threads, runs of replies a thread
int rp_frame_grid(i64 m, i64 g_n, i64 r_n, i64 h, i64 aligned, i64* out) {
    CoopGrid grid;
    const cudaError_t e =
        frame_grid(m, g_n > h ? g_n : h, frame_instance(r_n, aligned != 0), &grid);
    if (e == cudaSuccess) {
        out[0] = grid.blocks;
        out[1] = grid.threads;
        out[2] = grid.its;
    }
    return (int)e;
}

// The whole tick frame in one cooperative launch: fold m replies, sweep
// every row, gather h heartbeat rows; the health lanes (leader_known
// through leaderless) may all be null, which skips health.
int rp_tick_frame(const i64* term, const u8* is_leader, i64* commit, const i64* term_start,
                  i64* last_visible, i64* match, i64* flushed, i64* last_seq,
                  const u8* voter, const u8* voter_old, const i64* group_idx,
                  const i64* slot, const i64* dirty, const i64* flushed_in, const i64* seq,
                  const i64* hb_idx, i64* o_term, i64* o_commit, i64* o_dirty,
                  i64* o_visible, const u8* leader_known, const u8* active, i64* max_lag,
                  u8* under, u8* leaderless, i64 m, i64 h, i64 g_n, i64 r_n,
                  void* stream) {
    if (g_n <= 0) return 0;
    const void* kernel =
        frame_instance(r_n, aligned_rows(r_n, match, flushed, voter, voter_old));
    CoopGrid grid;
    cudaError_t e = frame_grid(m, g_n > h ? g_n : h, kernel, &grid);
    if (e != cudaSuccess) return (int)e;
    FrameLanes s = {term, is_leader, commit, term_start, last_visible,
                    match, flushed, last_seq, voter, voter_old};
    FrameReplies rp = {group_idx, slot, dirty, flushed_in, seq};
    FrameBeats hb = {hb_idx, o_term, o_commit, o_dirty, o_visible};
    FrameHealth hh = {leader_known, active, max_lag, under, leaderless};
    int rn = (int)r_n, its = grid.its;
    void* args[] = {&s, &rp, &hb, &hh, &m, &h, &g_n, &rn, &its};
    e = cudaLaunchCooperativeKernel(kernel, dim3(grid.blocks), dim3(grid.threads), args,
                                    grid.smem, (cudaStream_t)stream);
    const cudaError_t last = cudaGetLastError();  // clears a refused launch
    return (int)(e != cudaSuccess ? e : last);
}

// The mesh frame's sweep, after rp_fold_replies on the same stream: every
// row with its health and the fleet totals into totals[5]. scratch:
// TOTALS_SCRATCH i64 that only this stream's launches use, zero before the
// first (each launch leaves them zero).
int rp_mesh_sweep(const i64* term, const u8* is_leader, i64* commit, const i64* term_start,
                  i64* last_visible, i64* match, i64* flushed, i64* last_seq,
                  const u8* voter, const u8* voter_old, const u8* leader_known,
                  const u8* active, i64* max_lag, u8* under, u8* leaderless, i64* scratch,
                  i64* totals, i64 g_n, i64 r_n, void* stream) {
    if (g_n <= 0) return 0;
    FrameLanes s = {term, is_leader, commit, term_start, last_visible,
                    match, flushed, last_seq, voter, voter_old};
    FrameHealth hh = {leader_known, active, max_lag, under, leaderless};
    FrameTotals tt = {scratch, (unsigned long long*)(scratch + TOTALS_SCRATCH - 1), totals};
    const i64 span = (i64)COMMIT_THREADS * MESH_ROWS;
    const unsigned blocks = (unsigned)((g_n + span - 1) / span);
    const bool aligned = aligned_rows(r_n, match, flushed, voter, voter_old);
    cudaStream_t st = (cudaStream_t)stream;
    const int rn = (int)r_n;
#define RP_MESH_SWEEP(NS, AL) \
    mesh_sweep_kernel<NS, AL><<<blocks, COMMIT_THREADS, 0, st>>>(s, hh, tt, g_n, rn)
    if (r_n <= 8) {
        if (aligned) RP_MESH_SWEEP(8, true);
        else RP_MESH_SWEEP(8, false);
    } else if (r_n <= 16) {
        if (aligned) RP_MESH_SWEEP(16, true);
        else RP_MESH_SWEEP(16, false);
    } else {
        if (aligned) RP_MESH_SWEEP(32, true);
        else RP_MESH_SWEEP(32, false);
    }
#undef RP_MESH_SWEEP
    return (int)cudaGetLastError();
}

int rp_follower_commit(i64* commit, i64* last_visible, const i64* flushed,
                       const i64* leader_commit, i64 g_n, i64 r_n,
                       void* stream) {
    if (g_n <= 0) return 0;
    const unsigned blocks = blocks_for((g_n + FOLLOW_ROWS - 1) / FOLLOW_ROWS);
    const bool aligned = (uintptr_t)commit % 16 == 0 && (uintptr_t)last_visible % 16 == 0 &&
                         (uintptr_t)leader_commit % 16 == 0;
    if (aligned)
        follower_commit_kernel<true><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
            commit, last_visible, flushed, leader_commit, g_n, r_n);
    else
        follower_commit_kernel<false><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
            commit, last_visible, flushed, leader_commit, g_n, r_n);
    return (int)cudaGetLastError();
}

int rp_local_append(i64* match, i64* flushed, const i64* group_idx,
                    const i64* dirty, const i64* flushed_in, i64 m, i64 g_n,
                    i64 r_n, i64 parts, void* stream) {
    if (m <= 0 || g_n <= 0) return 0;
    return (int)launch_local_append(match, flushed, group_idx, dirty, flushed_in, m, g_n, r_n, parts, THREADS,
                                    (cudaStream_t)stream);
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
