"""Port vs reference: the quorum kernels' plain PyTorch versions.

The same seeded numpy inputs go through redpanda_tpu.ops.quorum (JAX on
the CPU) and redpanda_tpu_torch.ops.quorum on device="cpu", which runs
the plain versions beside the CUDA kernels. Every output is an integer
or bool, so the tolerance is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redpanda_tpu.models import consensus_state as jcs
from redpanda_tpu.ops import quorum as jq
from redpanda_tpu_torch.models import consensus_state as tcs
from redpanda_tpu_torch.ops import quorum as tq
from redpanda_tpu_torch.raft import quorum_scalar as qs

I64_MIN = -(2**63)
FIELDS = tuple(tcs.FIELD_DTYPES)


def random_fields(rng, g, r, joint_prob=0.25, zero_voter_prob=0.1):
    """Random lanes as in tests/test_ops.py random_state, plus rows
    with no voters at all (n == 0) and NO_OFFSET sentinels."""
    n_voters = rng.integers(1, r + 1, g)
    n_voters[rng.random(g) < zero_voter_prob] = 0
    voter = np.arange(r)[None, :] < n_voters[:, None]
    old = np.zeros((g, r), bool)
    for i in np.flatnonzero(rng.random(g) < joint_prob):
        old[i, rng.permutation(r)[: rng.integers(1, r + 1)]] = True
    match = rng.integers(-1, 1000, (g, r)).astype(np.int64)
    flushed = match - rng.integers(0, 50, (g, r)).astype(np.int64)
    commit = rng.integers(-1, 500, g).astype(np.int64)
    return {
        "term": rng.integers(0, 9, g).astype(np.int64),
        "is_leader": rng.random(g) < 0.8,
        "commit_index": commit,
        "term_start": rng.integers(0, 600, g).astype(np.int64),
        "last_visible": commit + rng.integers(0, 20, g),
        "match_index": match,
        "flushed_index": flushed,
        "is_voter": voter,
        "is_voter_old": old,
        "last_seq": rng.integers(0, 5, (g, r)).astype(np.int64),
    }


def random_replies(rng, g, r, m, pad=0):
    """Replies with duplicate (g, r) pairs (few rows, many replies),
    stale seqs, and `pad` shard_state-style padding entries (row 0,
    slot 0, seq i64 min)."""
    rows = rng.integers(0, max(1, g // 4), m).astype(np.int64)
    slots = rng.integers(0, r, m).astype(np.int64)
    dirty = rng.integers(-1, 1200, m).astype(np.int64)
    flushed = dirty - rng.integers(0, 30, m)
    seq = rng.integers(0, 8, m).astype(np.int64)
    out = [rows, slots, dirty, flushed, seq]
    if pad:
        fill = (0, 0, I64_MIN, I64_MIN, I64_MIN)
        out = [np.concatenate([a, np.full(pad, f, np.int64)]) for a, f in zip(out, fill)]
    return out


def jax_state(fields):
    return jcs.GroupState(**{k: jnp.asarray(fields[k]) for k in FIELDS})


def torch_state(fields):
    return tcs.group_state_from_numpy(fields, "cpu")


def assert_states_equal(jstate, tstate):
    got = tcs.group_state_to_numpy(tstate)
    for name in FIELDS:
        np.testing.assert_array_equal(
            got[name], np.asarray(getattr(jstate, name)), err_msg=name
        )


def tvec(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int64))


CASES = [(seed, r) for seed in range(3) for r in (8, 5, 3)]


@pytest.mark.parametrize("seed,r", CASES)
def test_commit_step_matches_jax(seed, r):
    rng = np.random.default_rng(seed)
    fields = random_fields(rng, 96, r)
    want = jq.quorum_commit_step(jax_state(fields))
    got = tq.quorum_commit_step(torch_state(fields))
    assert_states_equal(want, got)


def scalar_commits(f):
    """Expected commit per row from the port's scalar oracle."""
    out = []
    for i in range(len(f["term"])):
        if not f["is_leader"][i]:
            out.append(int(f["commit_index"][i]))
            continue
        replicas = [
            qs.ReplicaState(
                match_index=int(f["match_index"][i, j]),
                flushed_index=int(f["flushed_index"][i, j]),
                is_voter=bool(f["is_voter"][i, j]),
                is_voter_old=bool(f["is_voter_old"][i, j]),
            )
            for j in range(f["match_index"].shape[1])
        ]
        out.append(
            qs.leader_commit_index(
                replicas,
                leader_flushed=int(f["flushed_index"][i, 0]),
                commit_index=int(f["commit_index"][i]),
                term_start=int(f["term_start"][i]),
            )
        )
    return np.array(out, np.int64)


@pytest.mark.parametrize("seed", range(2))
def test_commit_step_matches_scalar_oracle(seed):
    rng = np.random.default_rng(50 + seed)
    fields = random_fields(rng, 64, 8, zero_voter_prob=0.0)
    got = tq.quorum_commit_step(torch_state(fields))
    np.testing.assert_array_equal(got.commit_index.numpy(), scalar_commits(fields))


@pytest.mark.parametrize("seed,r", CASES)
def test_fold_replies_matches_jax(seed, r):
    rng = np.random.default_rng(10 + seed)
    fields = random_fields(rng, 64, r)
    replies = random_replies(rng, 64, r, 200, pad=8)
    want = jq.fold_replies(jax_state(fields), *map(jnp.asarray, replies))
    got = tq.fold_replies(torch_state(fields), *map(tvec, replies))
    assert_states_equal(want, got)


def test_fold_duplicate_pairs_use_pre_batch_guard():
    # two replies to one cell: seq 3 then seq 2 (last_seq 1). Both are
    # fresh against the PRE-batch guard, so both fold by max; a fold
    # that raised last_seq first would drop the second reply's dirty=40
    fields = random_fields(np.random.default_rng(0), 2, 4)
    fields["last_seq"][:] = 1
    fields["match_index"][:] = -1
    replies = [np.array(v, np.int64) for v in ([0, 0], [1, 1], [30, 40], [30, 40], [3, 2])]
    got = tq.fold_replies(torch_state(fields), *map(tvec, replies))
    assert int(got.match_index[0, 1]) == 40
    assert int(got.last_seq[0, 1]) == 3
    want = jq.fold_replies(jax_state(fields), *map(jnp.asarray, replies))
    assert_states_equal(want, got)


def test_padding_entries_are_noops():
    fields = random_fields(np.random.default_rng(3), 16, 8)
    replies = random_replies(np.random.default_rng(4), 16, 8, 0, pad=16)
    got = tq.fold_replies(torch_state(fields), *map(tvec, replies))
    assert_states_equal(jax_state(fields), got)


@pytest.mark.parametrize("seed", range(2))
def test_build_heartbeats_matches_jax(seed):
    rng = np.random.default_rng(20 + seed)
    fields = random_fields(rng, 64, 8)
    hb_idx = rng.integers(0, 64, 40).astype(np.int64)
    want = jq.build_heartbeats(jax_state(fields), jnp.asarray(hb_idx))
    got = tq.build_heartbeats(torch_state(fields), tvec(hb_idx))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("seed,r", [(0, 8), (1, 5), (2, 3)])
def test_heartbeat_tick_and_tick_frame_match_jax(seed, r):
    rng = np.random.default_rng(30 + seed)
    fields = random_fields(rng, 128, r)
    replies = random_replies(rng, 128, r, 300, pad=20)
    hb_idx = rng.integers(0, 128, 64).astype(np.int64)

    want = jq.heartbeat_tick(jax_state(fields), *map(jnp.asarray, replies))
    got = tq.heartbeat_tick(torch_state(fields), *map(tvec, replies))
    assert_states_equal(want, got)

    want, want_hb = jq.tick_frame(
        jax_state(fields), *map(jnp.asarray, replies), jnp.asarray(hb_idx)
    )
    got, got_hb = tq.tick_frame(torch_state(fields), *map(tvec, replies), tvec(hb_idx))
    assert_states_equal(want, got)
    for k in want_hb:
        np.testing.assert_array_equal(got_hb[k].numpy(), np.asarray(want_hb[k]), err_msg=k)


def test_state_round_trip_and_fortran_lanes():
    """group_state_from_numpy takes Fortran-ordered lanes (as the host
    mirror keeps them) and yields row-major tensors with equal values."""
    fields = random_fields(np.random.default_rng(5), 32, 8)
    fortran = {k: np.asfortranarray(v) for k, v in fields.items()}
    state = tcs.group_state_from_numpy(fortran, "cpu")
    for name in FIELDS:
        assert getattr(state, name).is_contiguous()
    back = tcs.group_state_to_numpy(state)
    for name in FIELDS:
        np.testing.assert_array_equal(back[name], fields[name])
        assert back[name].dtype == tcs.FIELD_DTYPES[name]


def test_make_group_state_and_host_update_match_jax():
    want = jcs.host_update(jcs.make_group_state(6, 4), 2, term=7, commit_index=11)
    got = tcs.host_update(tcs.make_group_state(6, 4, device="cpu"), 2, term=7, commit_index=11)
    assert_states_equal(want, got)


def test_wrapper_rejects_bad_inputs():
    state = tcs.make_group_state(4, 8, device="cpu")
    with pytest.raises(ValueError):
        tq.fold_replies(state, *[torch.zeros(3, dtype=torch.int32)] * 5)
    wide = tcs.make_group_state(4, tq.MAX_REPLICA_SLOTS + 1, device="cpu")
    with pytest.raises(ValueError):
        tq.quorum_commit_step(wide)


# ------------------------------------------------------------------
# Replays of the CUDA kernels' schemes (csrc/quorum.cu, quorum_rules.cuh)
# step by step in numpy: a kernel cannot run here, so its arithmetic is
# held against the JAX program and the plain version through them.

FOLD_FEW_THREADS, FOLD_THREADS, FRAME_THREADS = 256, 1024, 256
FOLD_MAX_SMEM = 48 * 1024


def _coop_grid(m, threads, spread, sms, occupancy):
    """coop_grid: a co-resident grid (blocks, threads, its) of `threads`-
    thread blocks for m replies, each block taking `its` runs of `threads`
    replies with as few runs as `occupancy(threads, smem)` (blocks an SM
    at a run count's shared memory: one ballot word a warp and run)
    allows, and at least `spread` blocks where the occupancy allows."""
    words = threads // 32 * 4
    its = 1
    for _ in range(16):
        smem = its * words
        if smem > FOLD_MAX_SMEM:
            return None
        co_resident = occupancy(threads, smem) * sms
        if co_resident <= 0:
            return None
        blocks = -(-m // (its * threads))
        if blocks <= co_resident:
            return max(blocks, min(spread, co_resident), 1), threads, its
        its = -(-m // (co_resident * threads))
    return None


def _fold_grid(m, sms, occupancy):
    """fold_grid: 256-thread blocks while the batch fits one a SM, else
    1,024."""
    threads = FOLD_FEW_THREADS if m <= FOLD_FEW_THREADS * sms else FOLD_THREADS
    return _coop_grid(m, threads, 0, sms, occupancy)


def _frame_grid(m, g, h, sms, occupancy):
    """frame_grid: 256-thread blocks, the fold's runs for m replies,
    spread over max(G, H) rows up to co-residency."""
    return _coop_grid(m, FRAME_THREADS, -(-max(g, h) // FRAME_THREADS), sms, occupancy)


def _cell(g, r, g_n, r_n):
    """scatter_cell: (g, r) wrapped once from the end, its flat cell, or
    -1 where it is still out of range (dropped)."""
    g, r = int(g), int(r)
    g += g_n if g < 0 else 0
    r += r_n if r < 0 else 0
    return g * r_n + r if 0 <= g < g_n and 0 <= r < r_n else -1


def _gather_row(g, g_n):
    """gather_row: wrapped once from the end, then clamped to [0, G - 1]."""
    g = int(g) + (g_n if g < 0 else 0)
    return min(max(g, 0), g_n - 1)


def _replay_fold(fields, replies, sms=132, occupancy=lambda t, smem: 2048 // t, seed=0, barrier=True,
                 grid=None):
    """fold_kernel on numpy lanes: blocks in a seeded order; phase 1 reads
    every guard against last_seq (the cell of the index rule; a reply
    still out of range is dropped), raises match / flushed of fresh
    replies and keeps one ballot word a warp and run (the one-run kernel
    keeps the same bit in a register); then (barrier) phase 2 raises
    last_seq of the fresh replies. barrier=False lets each block run both
    phases before the next block starts. `grid` (blocks, threads, its)
    replaces fold_grid's, as the frame kernel's fold phase does."""
    out = {k: np.array(v, copy=True) for k, v in fields.items()}
    g_n, r_n = out["match_index"].shape
    match, flushed, last_seq = (out[k].reshape(-1) for k in ("match_index", "flushed_index", "last_seq"))
    rows, slots, dirty, fl, seq = replies
    m = len(rows)
    blocks, threads, its = grid or _fold_grid(m, sms, occupancy)
    warps = threads // 32
    rng = np.random.default_rng(seed)
    words = np.zeros((blocks, its * warps), np.uint32)

    def phase1(b):
        for s in range(its):
            for w in range(warps):
                bits = 0
                for lane in rng.permutation(32):
                    i = b * its * threads + s * threads + w * 32 + lane
                    if i >= m:
                        continue
                    k = _cell(rows[i], slots[i], g_n, r_n)
                    if k < 0:
                        continue
                    if seq[i] > last_seq[k]:
                        match[k] = max(match[k], dirty[i])
                        flushed[k] = max(flushed[k], fl[i])
                        bits |= 1 << int(lane)
                words[b, s * warps + w] = bits

    def phase2(b):
        for s in range(its):
            for w in range(warps):
                for lane in rng.permutation(32):
                    if (int(words[b, s * warps + w]) >> int(lane)) & 1:
                        i = b * its * threads + s * threads + w * 32 + lane
                        k = _cell(rows[i], slots[i], g_n, r_n)
                        last_seq[k] = max(last_seq[k], seq[i])

    order = rng.permutation(blocks)
    if barrier:
        for b in order:
            phase1(b)
        for b in rng.permutation(blocks):
            phase2(b)
    else:
        for b in order:
            phase1(b)
            phase2(b)
    return out, (blocks, threads, its)


def _dup_pair_replies(gap=1100):
    """Per (g, r) pair of rows 0-3: duplicates with the larger seq first
    and last, a stale reply beside a fresh one, in one warp and across
    runs or blocks (a copy of the pairs `gap` entries later, 5 further
    ahead)."""
    rows, slots, dirty, seq = [], [], [], []
    for g in range(4):
        for r in range(4):
            rows += [g, g]
            slots += [r, r]
            dirty += [30 + g, 40 + r]
            seq += [3, 2] if (g + r) % 2 else [2, 3]
    rows += [0, 0]
    slots += [5, 5]
    dirty += [90, 80]
    seq += [1, 4]  # last_seq 1: the first is stale
    n = len(rows)
    rows += [0] * (gap - n) + rows
    slots += [0] * (gap - n) + slots
    dirty += [I64_MIN] * (gap - n) + [d + 5 for d in dirty]
    seq += [I64_MIN] * (gap - n) + seq
    a = [np.array(x, np.int64) for x in (rows, slots, dirty)]
    return [a[0], a[1], a[2], a[2] - 1, np.array(seq, np.int64)]


@pytest.mark.parametrize("grid", ["one_run", "one_run_few", "runs", "runs_small_occupancy"])
def test_kernel_replay_fold_matches_jax(grid):
    """The one-launch fold, replayed: duplicate (g, r) pairs with both
    orders of their seqs, stale seqs and padding entries (row 0, slot 0,
    seq i64 min), at one reply a thread (1,024- and 256-thread blocks) and
    at several (a grid capped by occupancy), equal to the JAX program and
    the plain version."""
    sms, occ = {"one_run": (2, lambda t, s: 2048 // t), "one_run_few": (132, lambda t, s: 2048 // t),
                "runs": (1, lambda t, s: 1),
                "runs_small_occupancy": (1, lambda t, s: 2 if s <= 128 else 1)}[grid]
    rng = np.random.default_rng(71)
    fields = random_fields(rng, 16, 8)
    fields["last_seq"][:] = 1
    for extra in (_dup_pair_replies(), random_replies(rng, 16, 8, 2500, pad=37)):
        got, (blocks, threads, its) = _replay_fold(fields, extra, sms, occ, seed=len(extra[0]))
        assert (its > 1) == (len(extra[0]) > threads * sms * occ(threads, threads // 8))
        assert (threads == FOLD_FEW_THREADS) == (grid == "one_run_few")
        assert blocks * its * threads >= len(extra[0])
        want = jq.fold_replies(jax_state(fields), *map(jnp.asarray, extra))
        plain = tq.fold_replies(torch_state(fields), *map(tvec, extra))
        assert_states_equal(want, plain)
        assert_states_equal(want, torch_state(got))


def test_kernel_replay_fold_needs_its_barrier():
    """Without the grid barrier a block can raise last_seq before a
    duplicate in a later block reads it: the replay then drops a fresh
    reply, so the dup-pair batch does tell the two apart."""
    fields = random_fields(np.random.default_rng(72), 16, 8)
    fields["last_seq"][:] = 1
    fields["match_index"][:] = -1
    replies = _dup_pair_replies()
    want = tcs.group_state_to_numpy(tq.fold_replies(torch_state(fields), *map(tvec, replies)))
    differs = False
    for seed in range(8):
        got, _ = _replay_fold(fields, replies, sms=1, seed=seed, barrier=False)
        differs |= not np.array_equal(got["match_index"], want["match_index"])
    assert differs


def test_kernel_replay_fold_wraps_and_drops_out_of_range_pairs():
    """A row in [-G, 0) or slot in [-R, 0) counts from the end, and pairs
    still outside [0, G) x [0, R) are dropped, in the replay and the
    plain version alike: both equal the JAX fold of the same mixed
    batch, and the wrapped replies did land."""
    rng = np.random.default_rng(73)
    fields = random_fields(rng, 16, 5)
    fields["match_index"][[15, 3], [0, 4]] = -1
    good = random_replies(rng, 16, 5, 120, pad=8)
    bad = [np.array(x, np.int64) for x in ([-1, 16, 3, 3, 99, -5], [0, 1, -1, 5, 2, 7],
                                          [500] * 6, [499] * 6, [9] * 6)]
    mixed = [np.concatenate([a[:60], b, a[60:]]) for a, b in zip(good, bad)]
    want = jq.fold_replies(jax_state(fields), *map(jnp.asarray, mixed))
    assert_states_equal(want, tq.fold_replies(torch_state(fields), *map(tvec, mixed)))
    got, _ = _replay_fold(fields, mixed, sms=1, occupancy=lambda t, s: 1)
    assert_states_equal(want, torch_state(got))
    # (-1, 0) and (3, -1) land at (15, 0) and (3, 4); (16, 1), (99, 2) and (-5, 7) do not
    assert int(got["match_index"][15, 0]) == 500 and int(got["match_index"][3, 4]) == 500


def test_fold_grid_fits_co_residency():
    """The grid is co-resident at its run count's shared memory, takes
    256-thread blocks only while the batch fits one a SM, has the fewest
    runs a block that the occupancy allows, and refuses a batch whose
    ballot words outgrow the occupancy or 48 KB a block."""
    occ = lambda t, smem: (2048 // t if smem <= t // 8 else 1) if smem <= 8192 else 0  # noqa: E731
    for m in (1, 255, 256, 33_792, 33_793, 131_072, 270_336, 270_337, 10**6, 3 * 10**7):
        got = _fold_grid(m, 132, occ)
        if m > FOLD_THREADS * 132 * 8192 // (FOLD_THREADS // 8):
            assert got is None
            continue
        blocks, threads, its = got
        assert threads == (256 if m <= 256 * 132 else 1024)
        words = threads // 8
        assert blocks <= occ(threads, its * words) * 132
        assert (blocks - 1) * its * threads < m <= blocks * its * threads
        if its > 1:
            fewer = its - 1
            assert -(-m // (fewer * threads)) > occ(threads, fewer * words) * 132
    assert _fold_grid(10**8, 132, lambda t, s: 1) is None  # 740 runs: past 48 KB a block


def _nonzero_bytes(word):
    """nonzero_bytes: bit k set when byte k of the 64-bit word is nonzero."""
    w = int(word)
    w |= w >> 4
    w |= w >> 2
    w |= w >> 1
    return (((w & 0x0101010101010101) * 0x0102040810204080) & (2**64 - 1)) >> 56


def test_nonzero_bytes_matches_bytes():
    rng = np.random.default_rng(74)
    words = [0, 2**64 - 1, 0x0100000000000001, 0x8000000000000080, 0x00FF00FF00FF00FF]
    words += [int(x) for x in rng.integers(0, 2**63, 200, dtype=np.int64)]
    words += [int.from_bytes(bytes(int(b) for b in rng.choice([0, 0, 1, 2, 16, 128, 255], 8)), "little")
              for _ in range(200)]
    for w in words:
        want = sum(1 << k for k, b in enumerate(w.to_bytes(8, "little")) if b)
        assert _nonzero_bytes(w) == want, hex(w)


def _rank_masks(v):
    """rank_masks over numpy rows [G, N]: bit t of before[:, s] set when
    slot t sorts before s (smaller, or equal and t < s), one compare a pair."""
    g, n = v.shape
    before = np.zeros((g, n), np.int64)
    for a in range(n):
        for b in range(a + 1, n):
            a_first = v[:, a] <= v[:, b]
            before[:, b] |= a_first.astype(np.int64) << a
            before[:, a] |= (~a_first).astype(np.int64) << b
    return before


def _popc(x):
    return np.array([bin(int(v) & 0xFFFFFFFF).count("1") for v in x], np.int64)


def _masked_quorum(v, before, mask):
    """masked_quorum: the masked slot that (n - 1) >> 1 masked slots sort
    before (i64 min when n == 0)."""
    k = (_popc(mask) - 1) >> 1
    out = np.full(v.shape[0], I64_MIN, np.int64)
    for s in range(v.shape[1]):
        hit = ((mask >> s) & 1).astype(bool) & (_popc(before[:, s] & mask) == k)
        out = np.where(hit, v[:, s], out)
    return out


def _lane_majority(v, vm, om):
    """lane_majority: rank masks once, the current voters' quorum, and its
    min with the old voters' under joint consensus."""
    before = _rank_masks(v)
    cur = _masked_quorum(v, before, vm)
    return np.where(om != 0, np.minimum(cur, _masked_quorum(v, before, om)), cur)


def _row_registers(fields, words=True):
    """load_row / load_mask on numpy lanes: match and flushed padded to N
    = 8, 16 or 32 slots with i64 min, and each voter lane as a bitmask,
    from 8-byte words for R a multiple of 8 (`words`), else slot by slot.
    Returns (match, flushed, vm, om)."""
    r = fields["match_index"].shape[1]
    n = 8 if r <= 8 else (16 if r <= 16 else 32)
    g = len(fields["match_index"])
    m = np.full((g, n), I64_MIN, np.int64)
    c = np.full((g, n), I64_MIN, np.int64)
    m[:, :r] = fields["match_index"]
    c[:, :r] = fields["flushed_index"]

    def mask_of(lane):
        raw = np.ascontiguousarray(lane, np.bool_).view(np.uint8)
        if words and r % 8 == 0:
            w = raw.reshape(g, r // 8, 8).copy().view("<u8")[:, :, 0]
            return sum(np.array([_nonzero_bytes(x) for x in w[:, i]], np.int64) << (8 * i)
                       for i in range(r // 8))
        return sum((raw[:, s] != 0).astype(np.int64) << s for s in range(r))

    return m, c, mask_of(fields["is_voter"]), mask_of(fields["is_voter_old"])


def _replay_commit(fields):
    """commit_step_kernel + commit_row on numpy lanes: the row registers
    (_row_registers), lane_majority over min(flushed, match) and over
    match, and the rule."""
    m, c, vm, om = _row_registers(fields)
    self_flushed = c[:, 0].copy()
    c = np.minimum(c, m)
    majority = np.minimum(_lane_majority(c, vm, om), self_flushed)
    dirty = _lane_majority(m, vm, om)
    dirty = np.minimum(dirty, m[:, 0])
    lead = fields["is_leader"] & (vm != 0)
    commit = fields["commit_index"]
    advance = lead & (majority > commit) & (majority >= fields["term_start"])
    new_commit = np.where(advance, majority, commit)
    visible = np.where(lead, np.maximum(fields["last_visible"], np.maximum(new_commit, dirty)),
                       fields["last_visible"])
    return {**fields, "commit_index": new_commit, "last_visible": visible}


def edge_fields(rng, g, r):
    """random_fields plus ties (few distinct values), values at i64 min
    and max, rows with no voters, joint rows with an empty current set,
    and old sets that are empty or full."""
    f = random_fields(rng, g, r, joint_prob=0.4, zero_voter_prob=0.15)
    tied = rng.random(g) < 0.3
    f["match_index"][tied] = rng.integers(0, 3, (int(tied.sum()), r))
    f["flushed_index"][tied] = f["match_index"][tied] - rng.integers(0, 2, (int(tied.sum()), r))
    ext = rng.random((g, r)) < 0.08
    f["match_index"][ext] = np.where(rng.random(int(ext.sum())) < 0.5, I64_MIN, 2**63 - 1)
    f["flushed_index"][ext] = np.where(rng.random(int(ext.sum())) < 0.5, I64_MIN, f["match_index"][ext])
    f["commit_index"][rng.random(g) < 0.05] = I64_MIN
    f["term_start"][rng.random(g) < 0.05] = I64_MIN
    no_cur = rng.random(g) < 0.05
    f["is_voter"][no_cur] = False
    f["is_voter_old"][no_cur, : (r + 1) // 2] = True
    f["is_voter_old"][rng.random(g) < 0.05] = True
    return f


@pytest.mark.parametrize("r", [1, 3, 5, 8, 12, 16, 32])
def test_kernel_replay_commit_matches_jax(r):
    """The rank-mask selection and the 8-byte mask words, replayed for
    every padded slot count, equal to the JAX program and the plain
    version: joint rows, n = 0 and empty old sets, ties, i64 min / max."""
    rng = np.random.default_rng(80 + r)
    fields = edge_fields(rng, 160, r)
    want = jq.quorum_commit_step(jax_state(fields))
    assert_states_equal(want, tq.quorum_commit_step(torch_state(fields)))
    assert_states_equal(want, torch_state(_replay_commit(fields)))


def test_kernel_replay_commit_voter_bytes_beyond_one():
    """A voter byte other than 0 / 1 counts as set in the 8-byte words
    as in the reference's != 0 (bool lanes from a uint8 view)."""
    rng = np.random.default_rng(79)
    fields = edge_fields(rng, 64, 16)
    raw = fields["is_voter"].view(np.uint8)
    raw[raw != 0] = rng.choice([1, 2, 128, 255], int((raw != 0).sum())).astype(np.uint8)
    replay = _replay_commit(fields)
    fields["is_voter"] = raw != 0
    want = jq.quorum_commit_step(jax_state(fields))
    assert_states_equal(want, torch_state(replay))


# ------------------------------------------------------------------
# JAX's index rule (a row in [-G, 0) or slot in [-R, 0) counts from the
# end, once; scatters drop what is still out of range, gathers clamp it)
# on batches that mix such indices with in-range ones.

def mixed_index_replies(rng, g, r, m=160):
    """random_replies (duplicate pairs, stale seqs, padding) plus replies
    at rows -1, -G, -G-1, G and G+5 with in-range slots, at slots -1, -R,
    -R-1 and R with in-range rows, at both at once, and the in-range twin
    of every wrapped pair (a duplicate across the wrap), inserted at
    seeded places; their seqs are mostly fresh."""
    base = random_replies(rng, g, r, m, pad=8)
    bad_rows, bad_slots = [-1, -g, -g - 1, g, g + 5], [-1, -r, -r - 1, r]
    pairs = [(b, int(rng.integers(0, r))) for b in bad_rows]
    pairs += [(int(rng.integers(0, g)), s) for s in bad_slots]
    pairs += [(b, s) for b in bad_rows[:3] for s in bad_slots[:2]]
    pairs += [(b + g if b < 0 else b, s + r if s < 0 else s) for b, s in pairs
              if -g <= b < g and -r <= s < r]
    n = len(pairs)
    dirty = rng.integers(0, 3000, n).astype(np.int64)
    extra = [np.array([p[0] for p in pairs], np.int64), np.array([p[1] for p in pairs], np.int64),
             dirty, dirty - rng.integers(0, 30, n), rng.integers(3, 12, n).astype(np.int64)]
    at = np.sort(rng.integers(0, len(base[0]) + 1, n))
    return [np.insert(a, at, e) for a, e in zip(base, extra)]


def mixed_hb_rows(rng, g, h=48):
    """Heartbeat rows in random order with duplicates and rows -1, -G,
    -G-1, G, G+5."""
    rows = rng.integers(0, g, h).astype(np.int64)
    rows[: h // 4] = rows[h // 4: h // 2]
    bad = np.array([-1, -g, -g - 1, g, g + 5, -1, g], np.int64)
    return rng.permutation(np.concatenate([rows, bad]))


def _jax_vs_port(fn, fields, rng, g, r):
    """(JAX's result, the port's) of `fn` on one mixed batch, as
    {name: numpy array}."""
    from redpanda_tpu.ops import health as jh
    from redpanda_tpu_torch.ops import health as th

    replies = mixed_index_replies(rng, g, r)
    hb = mixed_hb_rows(rng, g)
    known, active = rng.random(g) < 0.5, rng.random(g) < 0.9
    js, ts = jax_state(fields), torch_state(fields)
    jr, tr = list(map(jnp.asarray, replies)), list(map(tvec, replies))

    def flat(state, *dicts):
        out = dict(zip(FIELDS, (np.asarray(x) for x in state))) if state is not None else {}
        for prefix, d in dicts:
            out.update({f"{prefix}.{k}": np.asarray(v) for k, v in d.items()})
        return out

    if fn == "fold_replies":
        return flat(jq.fold_replies(js, *jr)), flat(tq.fold_replies(ts, *tr))
    if fn == "local_append_update":
        rows, _, dirty, fl, _ = replies
        args = (rows, dirty, fl)
        return (flat(jq.local_append_update(js, *map(jnp.asarray, args))),
                flat(tq.local_append_update(ts, *map(tvec, args))))
    if fn == "build_heartbeats":
        return (flat(None, ("hb", jq.build_heartbeats(js, jnp.asarray(hb)))),
                flat(None, ("hb", tq.build_heartbeats(ts, tvec(hb)))))
    if fn == "heartbeat_tick":
        return flat(jq.heartbeat_tick(js, *jr)), flat(tq.heartbeat_tick(ts, *tr))
    if fn == "tick_frame":
        (a, ahb), (b, bhb) = jq.tick_frame(js, *jr, jnp.asarray(hb)), tq.tick_frame(ts, *tr, tvec(hb))
        return flat(a, ("hb", ahb)), flat(b, ("hb", bhb))
    a, ahb, ah = jh.tick_frame_health(js, *jr, jnp.asarray(hb), jnp.asarray(known), jnp.asarray(active))
    b, bhb, bh = th.tick_frame_health(ts, *tr, tvec(hb), torch.from_numpy(known), torch.from_numpy(active))
    return flat(a, ("hb", ahb), ("health", ah)), flat(b, ("hb", bhb), ("health", bh))


@pytest.mark.parametrize("fn", ["fold_replies", "local_append_update", "build_heartbeats",
                                "heartbeat_tick", "tick_frame", "tick_frame_health"])
@pytest.mark.parametrize("r", [3, 8])
def test_index_rule_matches_jax(fn, r):
    """The port's plain versions equal JAX exactly on one batch mixing
    rows -1, -G, -G-1, G, G+5 and slots -1, -R, -R-1, R (and their
    in-range twins) with in-range replies and duplicate pairs."""
    rng = np.random.default_rng(90 + r)
    g = 24
    fields = random_fields(rng, g, r)
    fields["match_index"][-1] = -1  # rows the wrapped replies raise start low
    want, got = _jax_vs_port(fn, fields, rng, g, r)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------------
# The tick frame in one cooperative launch (csrc/quorum.cu
# tick_frame_kernel), replayed phase by phase.

def _replay_health(m, tracked, commit, leader, active, known):
    """row_health on numpy registers: lag = self_dirty - match (wrapping)
    over tracked slots, its max from 0; under when a tracked slot trails
    the new commit."""
    worst = np.zeros(len(commit), np.int64)
    trails = np.zeros(len(commit), bool)
    for s in range(m.shape[1]):
        on = ((tracked >> s) & 1).astype(bool)
        lag = (m[:, 0].view(np.uint64) - m[:, s].view(np.uint64)).view(np.int64)
        worst = np.where(on, np.maximum(worst, lag), worst)
        trails |= on & (m[:, s] < commit)
    lead = leader & active
    return {"max_lag": np.where(lead, worst, 0).astype(np.int64), "under_replicated": lead & trails,
            "leaderless": active & ~leader & ~known}


TOTALS_MAX = 1  # the one counter of ops.health.TOTALS folded by max (max_follower_lag)


def _row_counts(old_commit, new_commit, health, active):
    """count_row for every row: [G, 5] in ops.health.TOTALS order."""
    return np.stack([new_commit > old_commit, health["max_lag"], health["under_replicated"],
                     health["leaderless"], active], axis=1).astype(np.int64)


def _block_partials(counts, row_block, blocks):
    """block_partials: each CUDA block's counters over its rows."""
    return np.stack([_fold(counts[row_block == b]) for b in range(blocks)])


TOTALS_SETS = 32  # csrc/chip_blocks.cuh: grid_totals' accumulator sets


def _fold(rows):
    """Sum each counter over the rows of `rows`, max for max_follower_lag
    (initial 0)."""
    out = rows.sum(axis=0)
    out[TOTALS_MAX] = rows[:, TOTALS_MAX].max(initial=0)
    return out


def _grid_totals(partials, seed):
    """grid_totals: block b's atomics into accumulator set b mod 32 (all
    zero at the launch) and its ticket, in a seeded finishing order; the
    block that draws the last ticket folds the 32 sets, one a lane, and
    leaves them and the ticket zero for the next launch."""
    acc, ticket, out = np.zeros((TOTALS_SETS, partials.shape[1]), np.int64), 0, None
    for b in np.random.default_rng(seed).permutation(len(partials)):
        acc[b % TOTALS_SETS] = _fold(np.stack([acc[b % TOTALS_SETS], partials[b]]))
        ticket += 1
        if ticket == len(partials):
            out, acc, ticket = _fold(acc), np.zeros_like(acc), 0
    assert out is not None and not acc.any() and ticket == 0
    return out


def _replay_frame(fields, replies, hb_idx, known=None, active=None, sms=132,
                  occupancy=lambda t, smem: 3, seed=0, barrier2=True, totals=False):
    """tick_frame_kernel on numpy lanes at frame_grid's grid, blocks in
    seeded orders. A: the fold phase with barrier 1 (_replay_fold at the
    frame's grid). B: block b sweeps its rows from the post-fold lanes
    and, given `known` / `active`, writes their health from the same
    registers. Barrier 2, then C: block b gathers its heartbeat rows from
    the lanes as they stand. Rows and heartbeat rows are dealt in 32-row
    chunks round-robin over the grid's warps (chunk c to warp c mod W,
    warp w to block w mod blocks). barrier2=False runs B then C block by
    block. `totals` (with health): the mesh frame's one-launch design (A,
    chip_quorum.py MESH_COOP, which runs this kernel's fold and sweep with
    no heartbeat rows), each block's rows counted and folded by
    grid_totals. Returns (lanes, heartbeat fields, health or None, totals
    or None, grid)."""
    g_n, r_n = fields["match_index"].shape
    m, h = len(replies[0]), len(hb_idx)
    grid = _frame_grid(m, g_n, h, sms, occupancy)
    blocks, threads, _ = grid
    out = {k: np.array(v, copy=True) for k, v in fields.items()}
    if m:
        out, _ = _replay_fold(fields, replies, seed=seed, grid=grid)
    swept = _replay_commit(out)  # each row's thread: row-local
    health = None
    if known is not None:
        mrow, _, vm, om = _row_registers(out)
        full = _replay_health(mrow, vm | om, swept["commit_index"], out["is_leader"], active, known)
        health = {k: np.zeros_like(v) for k, v in full.items()}
    warps = blocks * threads // 32
    row_block = (np.arange(g_n) // 32 % warps) % blocks
    beat_block = (np.arange(h) // 32 % warps) % blocks
    hb = {k: np.zeros(h, np.int64) for k in ("term", "commit_index", "last_dirty", "last_visible")}

    def sweep(b):
        rows = row_block == b
        for k in ("commit_index", "last_visible"):
            out[k][rows] = swept[k][rows]
        if health is not None:
            for k in health:
                health[k][rows] = full[k][rows]

    def gather(b):
        for i in np.flatnonzero(beat_block == b):
            g = _gather_row(hb_idx[i], g_n)
            hb["term"][i] = out["term"][g]
            hb["commit_index"][i] = out["commit_index"][g]
            hb["last_dirty"][i] = out["match_index"][g, 0]
            hb["last_visible"][i] = out["last_visible"][g]

    rng = np.random.default_rng(seed + 1)
    if barrier2:
        for b in rng.permutation(blocks):
            sweep(b)
        for b in rng.permutation(blocks):
            gather(b)
    else:
        for b in rng.permutation(blocks):
            sweep(b)
            gather(b)
    fleet = None
    if totals:
        counts = _row_counts(fields["commit_index"], out["commit_index"], health, active)
        fleet = _grid_totals(_block_partials(counts, row_block, blocks), seed + 2)
    return out, {"group": hb_idx, **hb}, health, fleet, grid


MESH_BLOCK_ROWS = 128 * 4  # mesh_sweep_kernel: COMMIT_THREADS threads, MESH_ROWS rows a thread


def _replay_mesh_sweep(fields, replies, known, active, seed=0):
    """The mesh frame as the fold kernel (_replay_fold at fold_grid's
    grid) and then mesh_sweep_kernel: 512 consecutive rows a block, each
    row swept and its health taken from the same registers, the blocks'
    counters folded by grid_totals. Returns (lanes, health, totals)."""
    out = {k: np.array(v, copy=True) for k, v in fields.items()}
    if len(replies[0]):
        out, _ = _replay_fold(fields, replies, seed=seed)
    swept = _replay_commit(out)
    mrow, _, vm, om = _row_registers(out)
    health = _replay_health(mrow, vm | om, swept["commit_index"], out["is_leader"], active, known)
    g_n = len(out["commit_index"])
    counts = _row_counts(out["commit_index"], swept["commit_index"], health, active)
    blocks = max(1, -(-g_n // MESH_BLOCK_ROWS))
    fleet = _grid_totals(_block_partials(counts, np.arange(g_n) // MESH_BLOCK_ROWS, blocks), seed + 2)
    return {**out, "commit_index": swept["commit_index"], "last_visible": swept["last_visible"]}, health, fleet


FRAME_GRIDS = {  # (SMs, occupancy): the rows and replies spread over blocks, or one block
    "spread": (132, lambda t, smem: 3),
    "one_block": (1, lambda t, smem: 1),
}


@pytest.mark.parametrize("design", ["fold_then_sweep", "one_launch"])
def test_kernel_replay_mesh_frame_many_blocks(design):
    """Both mesh frame designs, replayed at 40,000 rows (79 sweep blocks
    of 512 rows, the last one partial, or 157 co-resident blocks: more
    blocks than accumulator sets), equal to the plain chain exactly:
    every lane, the health lanes and the five totals."""
    from redpanda_tpu_torch.ops import health as th

    rng = np.random.default_rng(140)
    g, r = 40_000, 8
    fields = random_fields(rng, g, r)
    replies = random_replies(rng, g, r, 600, pad=24)
    known, active = rng.random(g) < 0.5, rng.random(g) < 0.9
    if design == "fold_then_sweep":
        lanes, health, totals = _replay_mesh_sweep(fields, replies, known, active, seed=3)
    else:
        lanes, _, health, totals, (blocks, _, _) = _replay_frame(
            fields, replies, np.zeros(0, np.int64), known, active, totals=True, seed=3)
        assert blocks > TOTALS_SETS
    state = torch_state(fields)
    before = state.commit_index.clone()
    state = tq.quorum_commit_step(tq.fold_replies(state, *map(tvec, replies)))
    want_h, want_t = th.health_totals(state.match_index, state.commit_index, state.is_voter,
                                      state.is_voter_old, state.is_leader, torch.from_numpy(known),
                                      torch.from_numpy(active), 1, before=before)
    assert_states_equal(state, torch_state(lanes))
    for k in want_h:
        np.testing.assert_array_equal(health[k], want_h[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(totals, want_t.numpy())
    assert totals[0] > 0 and totals[1] > 0


@pytest.mark.parametrize("grid", list(FRAME_GRIDS))
@pytest.mark.parametrize("health", [True, False])
@pytest.mark.parametrize("r", [3, 5, 8, 12, 32])
def test_kernel_replay_frame_matches_jax(r, health, grid):
    """The one-launch frame, replayed: equal to JAX's tick_frame_health
    (health) or tick_frame and to the plain chain, exactly, with
    heartbeat rows in random order, duplicated and out of range, replies
    with duplicate pairs, stale seqs, padding and out-of-range indices;
    rows spread over several blocks, or one block taking several rows and
    runs of replies a thread."""
    from redpanda_tpu.ops import health as jh
    from redpanda_tpu_torch.ops import health as th

    rng = np.random.default_rng(100 + r)
    g = 600
    fields = edge_fields(rng, g, r)
    replies = mixed_index_replies(rng, g, r, m=700)
    hb = mixed_hb_rows(rng, g, h=400)
    known, active = rng.random(g) < 0.5, rng.random(g) < 0.9
    sms, occ = FRAME_GRIDS[grid]
    got, got_hb, got_h, _, (blocks, threads, its) = _replay_frame(
        fields, replies, hb, known if health else None, active, sms, occ, seed=r)
    assert (blocks, its) == ((3, 1) if grid == "spread" else (1, 3))
    js, jr, jhb = jax_state(fields), list(map(jnp.asarray, replies)), jnp.asarray(hb)
    if health:
        want, want_hb, want_h = jh.tick_frame_health(js, *jr, jhb, jnp.asarray(known), jnp.asarray(active))
        plain = th.tick_frame_health(torch_state(fields), *map(tvec, replies), tvec(hb),
                                     torch.from_numpy(known), torch.from_numpy(active))
        for k in want_h:
            np.testing.assert_array_equal(got_h[k], np.asarray(want_h[k]), err_msg=k)
            np.testing.assert_array_equal(plain[2][k].numpy(), np.asarray(want_h[k]), err_msg=k)
    else:
        want, want_hb = jq.tick_frame(js, *jr, jhb)
        plain = tq.tick_frame(torch_state(fields), *map(tvec, replies), tvec(hb))
    assert_states_equal(want, torch_state(got))
    assert_states_equal(want, plain[0])
    for k in want_hb:
        np.testing.assert_array_equal(got_hb[k], np.asarray(want_hb[k]), err_msg=k)
        np.testing.assert_array_equal(plain[1][k].numpy(), np.asarray(want_hb[k]), err_msg=k)


def test_kernel_replay_frame_needs_its_second_barrier():
    """Without barrier 2 a block can gather a row another block has not
    swept yet: for some seed the replay then sends other commit or
    visible fields, so the second barrier is needed."""
    rng = np.random.default_rng(110)
    g = 600
    fields = random_fields(rng, g, 8)
    replies = random_replies(rng, g, 8, 500)
    hb = rng.permutation(g).astype(np.int64)
    want = _replay_frame(fields, replies, hb)[1]
    differs = False
    for seed in range(8):
        got = _replay_frame(fields, replies, hb, seed=seed, barrier2=False)[1]
        differs |= any(not np.array_equal(got[k], want[k]) for k in want)
    assert differs


@pytest.mark.parametrize("m", [0, 1, 256, 50_000, 101_376, 101_377, 131_072, 10**6, 3 * 10**7])
def test_frame_grid_fits_co_residency(m):
    """The frame's grid at the tick's rows (G = H = 50,000): co-resident
    at its run count's shared memory, as many runs a block as the fold
    needs and no more, spread over the rows up to co-residency, and
    refused where the ballot words outgrow the occupancy."""
    g = h = 50_000
    sms = 132
    occ = lambda t, smem: (3 if smem <= t // 8 else 2) if smem <= 8192 else 0  # noqa: E731
    got = _frame_grid(m, g, h, sms, occ)
    if m > (8192 // (FRAME_THREADS // 8)) * 2 * sms * FRAME_THREADS:
        assert got is None
        return
    blocks, threads, its = got
    words = threads // 8
    assert threads == FRAME_THREADS
    assert blocks <= occ(threads, its * words) * sms
    assert blocks * its * threads >= m
    assert blocks >= min(-(-max(g, h) // threads), occ(threads, its * words) * sms)
    assert (its == 1) == (m <= 3 * sms * threads)
    if its > 1:
        fewer = its - 1
        assert -(-m // (fewer * threads)) > occ(threads, fewer * words) * sms


@pytest.mark.parametrize("case", ["cpu_state", "known_without_active", "mesh_cpu_state"])
def test_launch_frame_refuses(case):
    """The frame kernels' wrappers take CUDA tensors only (no silent CPU
    fallback: tick_frame and mesh_tick_frame route CPU state to the plain
    chain themselves) and both health flags or neither."""
    fields = random_fields(np.random.default_rng(130), 16, 8)
    replies = list(map(tvec, random_replies(np.random.default_rng(131), 16, 8, 20)))
    known = torch.zeros(16, dtype=torch.bool)
    with pytest.raises(ValueError):
        if case == "cpu_state":
            tq.launch_frame(torch_state(fields), replies, tvec(np.arange(4)))
        elif case == "mesh_cpu_state":
            tq.launch_mesh_frame(torch_state(fields), replies, known, known)
        else:
            tq.launch_frame(torch_state(fields), replies, tvec(np.arange(4)), known, None)


# ------------------------------------------------------------------
# The local append (csrc/quorum.cu local_append_kernel), replayed.

def _replay_local_append(fields, rows, dirty, flushed, parts, threads=256, seed=0):
    """The local append on numpy lanes, as csrc/quorum.cu launches it for
    `parts` row parts: ceil(M / threads) blocks of `threads`, thread t of
    block b taking append b * threads + t and its cell by the index rule
    (dropped when still out of range). parts == 0 (local_append_kernel):
    one pass raising both lanes. Else (local_append_parts_kernel) 2 *
    parts passes, pass q raising lane q / parts (match, then flushed)
    where the cell is in [lo, lo + span), span = ceil(G / parts) * R
    cells, lo = span * (q % parts). The atomics land in a seeded order.
    Returns the lanes."""
    g, r = fields["match_index"].shape
    lanes = [fields["match_index"].copy().reshape(-1), fields["flushed_index"].copy().reshape(-1)]
    vals = (np.asarray(dirty, np.int64), np.asarray(flushed, np.int64))
    m = len(rows)
    blocks = -(-m // threads)
    span = -(-g // max(parts, 1)) * r
    work = []
    for q in range(max(2 * parts, 1)):
        lo = span * (q % parts) if parts else 0
        for blk in range(blocks):
            for t in range(threads):
                i = blk * threads + t
                c = _cell(rows[i], 0, g, r) if i < m else -1
                if c >= 0 and parts == 0:
                    work += [(0, i, c), (1, i, c)]
                elif parts and lo <= c < lo + span:
                    work.append((q // parts, i, c))
    cells = [(i, c) for i in range(m) for c in [_cell(rows[i], 0, g, r)] if c >= 0]
    assert sorted(work) == [(lane, i, c) for lane in (0, 1) for i, c in cells], "each kept append once a lane"
    for k in np.random.default_rng(seed).permutation(len(work)):
        lane, i, c = work[k]
        lanes[lane][c] = max(lanes[lane][c], vals[lane][i])
    return lanes[0].reshape(g, r), lanes[1].reshape(g, r)


def _append_batch(rng, g, m):
    """M appends to random rows with rows repeated at several distances
    (within a warp, across warps and blocks), rows -1, -G, -G - 1, G and
    G + 5 and the in-range twins of the wrapped ones, values around the
    slots' (some raise nothing) and the i64 extremes."""
    rows = rng.integers(0, g, m).astype(np.int64)
    for gap in (1, 32, m // 2):
        at = rng.integers(0, m - gap, 8)
        rows[at + gap] = rows[at]
    bad = np.array([-1, -g, -g - 1, g, g + 5, g - 1, 0, -1], np.int64)
    rows = np.insert(rows, np.sort(rng.integers(0, m, bad.size)), bad)
    dirty = rng.integers(-1, 1100, rows.size).astype(np.int64)
    dirty[:2] = (I64_MIN, 2**63 - 1)
    return rows, dirty, dirty - rng.integers(0, 60, rows.size)


@pytest.mark.parametrize("parts,threads", [(4, 256), (0, 256), (1, 32), (3, 32), (8, 64)])
def test_kernel_replay_local_append_matches_jax(parts, threads):
    """The local append's scheme (4 row parts, 8 passes, at 256-thread
    blocks as at the cluster shape; one pass as for small batches; and
    others; G = 24 is no multiple of 8 parts) on batches whose M is not
    a multiple of the block, with duplicate rows within and across warps
    and blocks and rows -1, -G, -G - 1, G, G + 5: the lanes equal the JAX
    program's and the plain version's in every seeded order of the
    atomics."""
    rng = np.random.default_rng(57)
    for g, r in ((24, 8), (1500, 3)):
        fields = random_fields(rng, g, r)
        rows, dirty, fl = _append_batch(rng, g, 3 * threads + 37)
        assert len(rows) % threads
        js = jq.local_append_update(jax_state(fields), *map(jnp.asarray, (rows, dirty, fl)))
        ts = tq.local_append_update(torch_state(fields), *map(tvec, (rows, dirty, fl)))
        for seed in range(3):
            got = _replay_local_append(fields, rows, dirty, fl, parts, threads, seed)
            for lane, want, plain in zip(got, (js.match_index, js.flushed_index),
                                         (ts.match_index, ts.flushed_index)):
                np.testing.assert_array_equal(lane, np.asarray(want), err_msg=f"seed {seed} vs JAX")
                np.testing.assert_array_equal(lane, plain.numpy(), err_msg=f"seed {seed} vs plain")


def test_local_append_parts_by_batch():
    """The row parts the entry passes to rp_local_append: 0 (one append a
    thread) up to APPEND_ONE_PASS_ROWS rows touched (min(M, G)); else
    APPEND_PARTS = 4 (8 passes), at the cluster shape (G = M = 1M), below
    it and past M = G."""
    one_pass, parts = tq.APPEND_ONE_PASS_ROWS, tq.APPEND_PARTS
    assert parts == 4
    assert tq.append_parts(1, 10**6) == 0 and tq.append_parts(one_pass, 10**6) == 0
    assert tq.append_parts(10**6, one_pass) == 0 and tq.append_parts(10**8, 24) == 0
    assert tq.append_parts(one_pass + 1, 10**6) == parts and tq.append_parts(10**6, 10**6) == parts
    assert tq.append_parts(2 * 10**6, 10**6) == parts and tq.append_parts(10**8, 10**6) == parts


# ------------------------------------------------------------------
# follower_commit_step: csrc/quorum.cu follower_commit_kernel

FOLLOW_ROWS = 4  # csrc/quorum.cu: consecutive rows a thread


def _replay_follower(fields, lc, aligned):
    """follower_commit_kernel on numpy lanes: thread i takes rows [4 i,
    4 i + 4); where the three [G] lanes are 16-byte aligned (`aligned`)
    and its rows all exist it moves them as two vectors, else row by row
    (the rows past G read as commit = leader_commit = 0: no update). Slot
    0's flushed (at g * R of the flattened lane) is read only for rows with
    leader_commit > commit. Returns the new lanes, the rows that read
    flushed, and the threads that took the vector path."""
    g, r = fields["match_index"].shape
    t = -(-g // FOLLOW_ROWS)
    pad = t * FOLLOW_ROWS - g

    def lane(x):
        return np.concatenate([x, np.zeros(pad, np.int64)]).reshape(t, FOLLOW_ROWS)

    c, l, vis = lane(fields["commit_index"]), lane(lc), lane(fields["last_visible"])
    rows = np.arange(t * FOLLOW_ROWS).reshape(t, FOLLOW_ROWS)
    flat = fields["flushed_index"].reshape(-1)
    reads = l > c
    assert not reads[rows >= g].any()  # the padded rows never load
    fl = np.where(reads, flat[np.where(reads, rows * r, 0)], 0)
    proposed = np.minimum(l, fl)
    nc = np.where((l > c) & (proposed > c), proposed, c)
    nv = np.maximum(vis, nc)
    vec = np.full(t, aligned) & ((rows[:, 0] + FOLLOW_ROWS) <= g)
    out_c, out_v = fields["commit_index"].copy(), fields["last_visible"].copy()
    for i in range(t):
        live = rows[i] < g
        if vec[i]:  # a vector is written back when any of its rows changed
            if (nc[i] != c[i]).any():
                out_c[rows[i]] = nc[i]
            if (nv[i] != vis[i]).any():
                out_v[rows[i]] = nv[i]
        else:  # row by row, where the row changed
            chg_c, chg_v = live & (nc[i] != c[i]), live & (nv[i] != vis[i])
            out_c[rows[i][chg_c]] = nc[i][chg_c]
            out_v[rows[i][chg_v]] = nv[i][chg_v]
    return {**fields, "commit_index": out_c, "last_visible": out_v}, rows[reads], vec


def follower_inputs(rng, g, r):
    """Random lanes and leader commits with rows that get no update
    (leader_commit = i64 min), leader_commit equal to commit, above
    flushed[0] and below commit, rows whose visible lags commit (with
    and without an update), and i64 extremes."""
    f = random_fields(rng, g, r)
    c = f["commit_index"]
    lc = c + rng.integers(-2, 6, g)
    kind = rng.integers(0, 6, g)
    lc[kind == 0] = I64_MIN
    lc[kind == 1] = c[kind == 1]
    lc[kind == 2] = f["flushed_index"][kind == 2, 0] + rng.integers(1, 9, int((kind == 2).sum()))
    lag = rng.random(g) < 0.3
    f["last_visible"][lag] = c[lag] - rng.integers(1, 9, int(lag.sum()))
    f["flushed_index"][rng.random(g) < 0.05, 0] = 2**63 - 1
    lc[rng.random(g) < 0.03] = 2**63 - 1
    return f, lc.astype(np.int64)


def _view_state(fields, lc, skip):
    """A CPU state (and leader commits) whose every lane is a view that
    starts `skip` rows into a tensor one row longer: skip = 1 leaves the
    [G] lanes 8 bytes past a 16-byte boundary."""
    def grow(x):  # one spare row, before the lane (skip = 1) or after it
        return np.concatenate([x[:skip], x, x[: 1 - skip]])

    full = tcs.group_state_from_numpy({k: grow(v) for k, v in fields.items()}, "cpu")
    state = tcs.GroupState(*(getattr(full, k)[skip : skip + len(lc)] for k in FIELDS))
    lanes = torch.from_numpy(grow(lc))[skip : skip + len(lc)]
    return state, lanes


def _aligned(state, lc):
    """rp_follower_commit's test: commit, last_visible and leader_commit
    all 16-byte aligned."""
    return all(t.data_ptr() % 16 == 0 for t in (state.commit_index, state.last_visible, lc))


@pytest.mark.parametrize("r", [3, 8, 16])
@pytest.mark.parametrize("g", [1, 6, 1023, 1025, 4 * 256 + 3])
@pytest.mark.parametrize("skip", [0, 1])
def test_kernel_replay_follower_matches_jax(skip, g, r):
    """The follower kernel's mapping (4 rows a thread, vectors where the
    [G] lanes are aligned and the thread's rows all exist, else row by
    row; flushed[0] read only where leader_commit > commit) on G not a
    multiple of 4 and on a view offset by one row (unaligned lanes),
    against the JAX program and the plain version on the same view: rows
    with no update, leader_commit equal to commit, above flushed, visible
    lagging commit."""
    rng = np.random.default_rng(100 * g + 10 * r + skip)
    fields, lc = follower_inputs(rng, g, r)
    want = jq.follower_commit_step(jax_state(fields), jnp.asarray(lc))
    state, lanes = _view_state(fields, lc, skip)
    aligned = _aligned(state, lanes)
    assert aligned == (skip == 0)
    assert_states_equal(want, tq.follower_commit_step(state, lanes))
    replay, reads, vec = _replay_follower(fields, lc, aligned)
    assert_states_equal(want, torch_state(replay))
    np.testing.assert_array_equal(np.sort(reads), np.flatnonzero(lc > fields["commit_index"]))
    assert vec.sum() == (g // FOLLOW_ROWS if aligned else 0)


# ------------------------------------------------------------------
# The heartbeat tick's pair (csrc/quorum.cu tick_fold_kernel, then
# tick_sweep_kernel launched with programmatic dependent launch),
# replayed: K1 guards against last_seq and writes no last_seq cell; K2
# sweeps the rows and raises last_seq with no guard.

TICK_THREADS, COMMIT_THREADS, TICK_RAISE = 256, 128, 4


def _tick_grid(g, m):
    """rp_heartbeat_tick's grids: K1's blocks (one reply a thread) and
    K2's (a row a thread, and at least m / TICK_RAISE threads)."""
    per_block = COMMIT_THREADS * TICK_RAISE
    return -(-m // TICK_THREADS), max(-(-g // COMMIT_THREADS), -(-m // per_block))


def _unguarded_raise(last_seq, replies):
    """last_seq raised to max(last_seq, seq) over every reply whose pair is
    in range after the wrap, with no seq guard."""
    out = np.array(last_seq, copy=True)
    g_n, r_n = out.shape
    flat = out.reshape(-1)
    rows, slots, _, _, seq = replies
    for g, r, sq in zip(rows, slots, seq):
        k = _cell(g, r, g_n, r_n)
        if k >= 0:
            flat[k] = max(flat[k], sq)
    return out


def _replay_tick(fields, replies, seed=0, raise_in_k1=False):
    """The pair on numpy lanes. K1: blocks in a seeded order, lanes in a
    seeded order within each warp; each reply's guard reads last_seq,
    which K1 never writes, and a fresh reply raises match and flushed.
    K2 (after K1, as its wait orders it): every thread first reads the
    last_seq cell of each of its replies (as early as the kernel can:
    the most stale reads), then sweeps its row (_replay_commit on the
    lanes K1 left) and raises the cells whose seq exceeds what it read,
    threads in a seeded order. raise_in_k1: each K1 block also raises
    last_seq for its own fresh replies at once, with no grid barrier
    (the design the pair rules out)."""
    out = {k: np.array(v, copy=True) for k, v in fields.items()}
    g_n, r_n = out["match_index"].shape
    match, flushed, last_seq = (out[k].reshape(-1) for k in ("match_index", "flushed_index", "last_seq"))
    rows, slots, dirty, fl, seq = replies
    m = len(rows)
    k1_blocks, k2_blocks = _tick_grid(g_n, m)
    rng = np.random.default_rng(seed)
    for b in rng.permutation(k1_blocks):
        fresh = []
        for w in range(TICK_THREADS // 32):
            for lane in rng.permutation(32):
                i = b * TICK_THREADS + w * 32 + lane
                if i >= m:
                    continue
                k = _cell(rows[i], slots[i], g_n, r_n)
                if k >= 0 and seq[i] > last_seq[k]:
                    match[k] = max(match[k], dirty[i])
                    flushed[k] = max(flushed[k], fl[i])
                    fresh.append((k, seq[i]))
        if raise_in_k1:
            for k, sq in fresh:
                last_seq[k] = max(last_seq[k], sq)
    threads = k2_blocks * COMMIT_THREADS
    assert threads >= g_n and threads * TICK_RAISE >= m
    mine = [[t + s * threads for s in range(TICK_RAISE) if t + s * threads < m] for t in range(threads)]
    cells = [[(_cell(rows[i], slots[i], g_n, r_n), seq[i]) for i in ii] for ii in mine]
    read = [[last_seq[k] if k >= 0 else sq for k, sq in cc] for cc in cells]
    swept = _replay_commit(out)
    for t in rng.permutation(threads):
        for (k, sq), cur in zip(cells[t], read[t]):
            if sq > cur:
                last_seq[k] = max(last_seq[k], sq)
    out["commit_index"], out["last_visible"] = swept["commit_index"], swept["last_visible"]
    return out


@pytest.mark.parametrize("r", [3, 5, 8])
@pytest.mark.parametrize("seed", range(3))
def test_unguarded_last_seq_raise_matches_jax_fold(seed, r):
    """The raise K2 does, max(last_seq, seq) over every in-range reply with
    no guard, equals the last_seq of JAX's guarded fold: duplicate pairs
    in both seq orders, equal seqs, stale seqs, padding entries (row 0,
    slot 0, seq i64 min) and rows and slots out of range."""
    rng = np.random.default_rng(200 + 10 * seed + r)
    g = 12
    fields = random_fields(rng, g, r)
    fields["last_seq"] = rng.integers(0, 6, (g, r)).astype(np.int64)
    replies = mixed_index_replies(rng, g, r, m=300)
    rows, slots, dirty, fl, seq = replies
    # duplicate pairs with both seq orders and an equal pair, and stale twins
    dup = rng.integers(0, len(rows), 40)
    extra = [a[dup] for a in replies]
    extra[4] = np.where(rng.random(40) < 0.5, extra[4] + rng.integers(-3, 4, 40), extra[4])
    replies = [np.concatenate([a, e, np.full(8, f, np.int64)])
               for a, e, f in zip(replies, extra, (0, 0, I64_MIN, I64_MIN, I64_MIN))]
    want = jq.fold_replies(jax_state(fields), *map(jnp.asarray, replies))
    np.testing.assert_array_equal(_unguarded_raise(fields["last_seq"], replies), np.asarray(want.last_seq))


def test_unguarded_last_seq_raise_property():
    """The same equality on batches hypothesis draws: any mix of rows in
    [-G - 2, G + 2), slots in [-R - 2, R + 2), seqs around last_seq and
    padding entries, at R = 3, 5 and 8."""
    from hypothesis import given, settings
    from hypothesis import strategies as st

    g, m = 5, 24

    @settings(max_examples=60, deadline=None, derandomize=True, database=None)
    @given(data=st.data())
    def check(data):
        r = data.draw(st.sampled_from([3, 5, 8]))
        reply = st.one_of(st.tuples(st.integers(-g - 2, g + 1), st.integers(-r - 2, r + 1), st.integers(-2, 8)),
                          st.just((0, 0, I64_MIN)))
        batch = data.draw(st.lists(reply, min_size=m, max_size=m))
        fields = random_fields(np.random.default_rng(r), g, r)
        fields["last_seq"] = np.array(data.draw(st.lists(st.integers(0, 6), min_size=g * r, max_size=g * r)),
                                      np.int64).reshape(g, r)
        rows, slots, seq = (np.array([b[j] for b in batch], np.int64) for j in range(3))
        dirty = np.arange(m, dtype=np.int64)
        replies = [rows, slots, dirty, dirty - 1, seq]
        want = jq.fold_replies(jax_state(fields), *map(jnp.asarray, replies))
        np.testing.assert_array_equal(_unguarded_raise(fields["last_seq"], replies),
                                      np.asarray(want.last_seq))

    check()


@pytest.mark.parametrize("batch", ["dup_pairs", "random", "mixed_index", "empty"])
@pytest.mark.parametrize("r", [3, 5, 8])
def test_kernel_replay_tick_matches_jax(batch, r):
    """K1 with no last_seq write, then K2's sweep and raise, replayed in
    seeded orders, equal to JAX's heartbeat_tick and the port's plain
    chain: duplicate pairs across K1's blocks, random batches with
    padding, JAX's index rule, and no replies at all."""
    rng = np.random.default_rng(300 + r)
    g = 300  # K2: 3 blocks of rows
    fields = edge_fields(rng, g, r)
    fields["last_seq"][:] = rng.integers(0, 3, (g, r))
    if batch == "dup_pairs":
        replies = _dup_pair_replies()
        replies[1] = replies[1] % r
    elif batch == "random":
        replies = random_replies(rng, g, r, 2500, pad=37)  # K2: 5 blocks for the replies
    elif batch == "mixed_index":
        replies = mixed_index_replies(rng, g, r, m=900)
    else:
        replies = [np.zeros(0, np.int64)] * 5
    want = jq.heartbeat_tick(jax_state(fields), *map(jnp.asarray, replies))
    assert_states_equal(want, tq.heartbeat_tick(torch_state(fields), *map(tvec, replies)))
    for seed in range(3):
        assert_states_equal(want, torch_state(_replay_tick(fields, replies, seed=seed)))


def test_kernel_replay_tick_raise_in_k1_drops_a_duplicate():
    """Raising last_seq inside K1, with no grid barrier, lets a block raise
    a cell before a duplicate in a later block reads its guard: the replay
    then drops a reply the reference keeps. So the raise lives in K2,
    after the launch boundary."""
    fields = random_fields(np.random.default_rng(301), 16, 8)
    fields["last_seq"][:] = 1
    fields["match_index"][:] = -1
    replies = _dup_pair_replies()
    want = jq.heartbeat_tick(jax_state(fields), *map(jnp.asarray, replies))
    differs = False
    for seed in range(8):
        got = _replay_tick(fields, replies, seed=seed, raise_in_k1=True)
        differs |= not np.array_equal(got["match_index"], np.asarray(want.match_index))
        assert_states_equal(want, torch_state(_replay_tick(fields, replies, seed=seed)))
    assert differs


@pytest.mark.parametrize("g,m", [(1, 0), (1024, 2048), (50_000, 131_072), (8192, 1024), (8, 131_072)])
def test_tick_grid_covers_rows_and_replies(g, m):
    """K1 has a thread for every reply; K2 a thread for every row and
    TICK_RAISE slots a thread for every reply."""
    k1, k2 = _tick_grid(g, m)
    assert k1 * TICK_THREADS >= m > (k1 - 1) * TICK_THREADS or m == k1 == 0
    assert k2 * COMMIT_THREADS >= g and k2 * COMMIT_THREADS * TICK_RAISE >= m
