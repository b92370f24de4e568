// The RF=3 ring cluster step over D chip blocks on one card: one heartbeat
// round and one RequestVote round for every group.
//
// Replaces (redpanda_tpu/parallel/cluster_step.py):
//   cluster_tick    :105  leaders append, heartbeat over ring hops 1 and 2,
//                         follower term gate / truncation / snapshot install
//                         / commit, replies folded into slots 1..2, quorum
//                         commit; totals of advanced groups and installs
//   election_round  :232  RequestVote from the mirror at candidate_hop for
//                         the masked groups: log_ok gate, one vote per term,
//                         elect on a majority, the home leader steps down
//
// Layout. The JAX program shards the group axis over D devices (block d
// holds rows [d * B, (d + 1) * B)) and moves payloads with ppermute:
// fwd = (i -> i + hop) means device d RECEIVES from d - hop, so the
// follower mirror of home block d's group i sits on block (d + hop) % D at
// the same local index i, column hop - 1 of the fol_* lanes. On one card
// the blocks are row ranges of one tensor, and the ring is a permutation
// of owners: the thread of home row (d, i) alone reads and writes the
// leader row (d, i) and the mirrors ((d + hop) % D, i, hop - 1) for
// hop = 1, 2. With D >= RF those three cells are distinct and no other
// thread touches them, so a whole round runs in registers, in place, with
// no grid-wide barrier: ppermute becomes an index, and psum the per-block
// partials of chip_blocks.cuh folded by fold_blocks.
//
// What bounds them on an H100: bytes. At G = 1M groups, R = 8 slots
// cluster_tick reads the leader row (match, flushed, two voter masks,
// five [G] lanes), the five mirror lanes, log_start and new_dirty (~273 B
// per group) and writes slots 0..2 of match / flushed, commit, visible and
// four mirror lanes (~128 B): ~401 MB, ~120 us at 3.35 TB/s. The work per
// group is the commit rule's rank masks, far below the integer rate.
// election_round reads ~66 B and writes ~42 B per group: ~32 us.
//
// The rules shared with ops/quorum.py (the leader commit, the follower
// commit, the local append) come from quorum_rules.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chip_blocks.cuh"
#include "quorum_rules.cuh"

typedef unsigned char u8;

#define THREADS 256
#define RF 3
#define MIRRORS (RF - 1)

enum { T_TOTAL, T_INSTALLS, T_N };

template <int N>
__global__ void __launch_bounds__(THREADS)
cluster_tick_kernel(const i64* __restrict__ term,
                    const u8* __restrict__ is_leader, i64* __restrict__ commit,
                    const i64* __restrict__ term_start,
                    i64* __restrict__ last_visible, i64* __restrict__ match,
                    i64* __restrict__ flushed, const u8* __restrict__ voter,
                    const u8* __restrict__ voter_old,
                    i64* __restrict__ fol_dirty, i64* __restrict__ fol_flushed,
                    i64* __restrict__ fol_commit, i64* __restrict__ fol_term,
                    const i64* __restrict__ voted_term,
                    const i64* __restrict__ log_start,
                    const i64* __restrict__ new_dirty,
                    i64* __restrict__ partials, i64 block_rows, int n_dev,
                    int r_n) {
    const int d = blockIdx.y;
    const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    i64 v[T_N] = {0, 0};
    if (i < block_rows) {
        const i64 g = (i64)d * block_rows + i;
        const i64 base = g * r_n;
        // 1. local append: the self slot tracks the leader log (flush
        // immediate in this modeled step)
        const i64 nd = new_dirty[g];
        local_append<false>(&match[base], &flushed[base], nd, nd);
        const i64 old_commit = commit[g];
        // the heartbeat payload; a deposed leader advertises term -1
        const i64 hb_term = is_leader[g] ? term[g] : -1;
        const i64 hb_dirty = match[base];
        const i64 hb_start = log_start[g];
#pragma unroll
        for (int hop = 1; hop < RF; ++hop) {
            const int j = hop - 1;
            const i64 k = (((d + hop) % n_dev) * block_rows + i) * MIRRORS + j;
            const i64 fd = fol_dirty[k], ff = fol_flushed[k];
            const i64 fc = fol_commit[k], ft = fol_term[k];
            // 2. term gate: the vote lane counts for acceptance, the
            // append lane alone for the new-term truncation trigger
            const bool accept = hb_term >= imax(ft, voted_term[k]);
            const bool new_term = hb_term > ft;
            // 3. new term: adopt the leader's log down to its dirty offset
            // (never below the mirror's commit); same term: advance only
            i64 nfd = new_term ? imax(hb_dirty, fc)
                               : (accept ? imax(fd, hb_dirty) : fd);
            // install_snapshot: the mirror fell below the retained log
            const bool stranded = accept && wrap_add(fd, 1) < hb_start;
            if (stranded) nfd = wrap_add(hb_start, -1);
            const i64 nff = (new_term || stranded) ? nfd : imax(ff, nfd);
            const i64 nfc = accept ? follower_commit(fc, old_commit, nff) : fc;
            v[T_INSTALLS] += stranded;
            fol_dirty[k] = nfd;
            fol_flushed[k] = nff;
            fol_commit[k] = nfc;
            fol_term[k] = imax(ft, hb_term);
            // 4. the reply folds positionally: ring hop -> replica slot
            match[base + hop] = imax(match[base + hop], nfd);
            flushed[base + hop] = imax(flushed[base + hop], nff);
        }
        i64 m[N], c[N];
        unsigned vm = 0u, om = 0u;
#pragma unroll
        for (int r = 0; r < N; ++r) {
            if (r < r_n) {
                const i64 mv = match[base + r], fv = flushed[base + r];
                m[r] = mv;
                c[r] = imin(fv, mv);
                vm |= (unsigned)(voter[base + r] != 0) << r;
                om |= (unsigned)(voter_old[base + r] != 0) << r;
            } else {
                m[r] = RP_I64_MIN;
                c[r] = RP_I64_MIN;
            }
        }
        i64 nv = last_visible[g];
        const i64 nc = commit_row(m, c, vm, om, flushed[base], is_leader[g] != 0,
                                  term_start[g], old_commit, &nv);
        commit[g] = nc;
        last_visible[g] = nv;
        v[T_TOTAL] = nc > old_commit;
    }
    block_partials<T_N>(v, 0u, partials);
}

__global__ void __launch_bounds__(THREADS)
election_kernel(i64* __restrict__ term, u8* __restrict__ is_leader,
                const i64* __restrict__ match, i64* __restrict__ fol_term,
                i64* __restrict__ voted_term, const i64* __restrict__ fol_dirty,
                const u8* __restrict__ mask, u8* __restrict__ elected,
                i64* __restrict__ out_term, i64 block_rows, int n_dev, int r_n,
                int cand_hop) {
    const int d = blockIdx.y;
    const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= block_rows) return;
    const i64 g = (i64)d * block_rows + i;
    // the campaigning mirror of home group (d, i)
    const i64 kc = (((d + cand_hop) % n_dev) * block_rows + i) * MIRRORS + cand_hop - 1;
    const bool is_cand = mask[g] != 0;
    const i64 cft = fol_term[kc], cvt = voted_term[kc];
    const i64 cand_term = wrap_add(imax(cft, cvt), 1);
    const i64 cand_dirty = fol_dirty[kc];
    i64 lt = term[g];
    bool il = is_leader[g] != 0;
    int grants = 1;  // self-vote
#pragma unroll
    for (int h = 0; h < RF; ++h) {
        if (h == cand_hop) continue;
        if (h == 0) {
            // the home block votes with its LEADER lane
            const bool grant = is_cand && cand_term > lt && cand_dirty >= match[g * r_n];
            lt = imax(lt, grant ? cand_term : 0);
            il = il && !grant;
            grants += grant;
        } else {
            const i64 k = (((d + h) % n_dev) * block_rows + i) * MIRRORS + h - 1;
            const i64 vt = voted_term[k];
            const bool grant = is_cand && cand_term > imax(fol_term[k], vt) &&
                               cand_dirty >= fol_dirty[k];
            // one vote per term: granting moves the VOTE lane only
            voted_term[k] = imax(vt, grant ? cand_term : -1);
            grants += grant;
        }
    }
    const bool won = is_cand && grants >= RF / 2 + 1;
    // the winner's mirror is the new leader log: its append term moves
    fol_term[kc] = imax(cft, won ? cand_term : -1);
    voted_term[kc] = imax(cvt, is_cand ? cand_term : -1);
    elected[g] = won;
    out_term[g] = won ? cand_term : -1;
    // the deposed home leader steps down and observes the new term
    is_leader[g] = il && !won;
    term[g] = imax(lt, won ? cand_term : 0);
}

extern "C" {

const char* rp_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

int rp_cluster_tick(const i64* term, const u8* is_leader, i64* commit,
                    const i64* term_start, i64* last_visible, i64* match,
                    i64* flushed, const u8* voter, const u8* voter_old,
                    i64* fol_dirty, i64* fol_flushed, i64* fol_commit,
                    i64* fol_term, const i64* voted_term, const i64* log_start,
                    const i64* new_dirty, i64* partials, i64* totals,
                    i64 n_dev, i64 block_rows, i64 r_n, void* stream) {
    if (n_dev <= 0 || block_rows <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const dim3 grid((unsigned)((block_rows + THREADS - 1) / THREADS), (unsigned)n_dev);
#define RP_CLUSTER_LAUNCH(NS)                                                  \
    cluster_tick_kernel<NS><<<grid, THREADS, 0, s>>>(                          \
        term, is_leader, commit, term_start, last_visible, match, flushed,    \
        voter, voter_old, fol_dirty, fol_flushed, fol_commit, fol_term,       \
        voted_term, log_start, new_dirty, partials, block_rows, (int)n_dev,   \
        (int)r_n)
    if (r_n <= 8)
        RP_CLUSTER_LAUNCH(8);
    else if (r_n <= 16)
        RP_CLUSTER_LAUNCH(16);
    else
        RP_CLUSTER_LAUNCH(32);
#undef RP_CLUSTER_LAUNCH
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    fold_blocks<<<1, 32, 0, s>>>(partials, totals, (int)n_dev, T_N, 0u);
    return (int)cudaGetLastError();
}

int rp_election_round(i64* term, u8* is_leader, const i64* match, i64* fol_term,
                      i64* voted_term, const i64* fol_dirty, const u8* mask,
                      u8* elected, i64* out_term, i64 n_dev, i64 block_rows,
                      i64 r_n, i64 cand_hop, void* stream) {
    if (n_dev <= 0 || block_rows <= 0) return 0;
    const dim3 grid((unsigned)((block_rows + THREADS - 1) / THREADS), (unsigned)n_dev);
    election_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        term, is_leader, match, fol_term, voted_term, fol_dirty, mask, elected,
        out_term, block_rows, (int)n_dev, (int)r_n, (int)cand_hop);
    return (int)cudaGetLastError();
}

}  // extern "C"
