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

FOLD_FEW_THREADS, FOLD_THREADS = 256, 1024
FOLD_MAX_SMEM = 48 * 1024


def _fold_grid(m, sms, occupancy):
    """fold_grid: the co-resident grid (blocks, threads, its) for m
    replies, 256-thread blocks while the batch fits one a SM, else 1,024;
    `occupancy(threads, smem)` blocks an SM at a run count's shared
    memory (one ballot word a warp and run)."""
    threads = FOLD_FEW_THREADS if m <= FOLD_FEW_THREADS * sms else FOLD_THREADS
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
            return blocks, threads, its
        its = -(-m // (co_resident * threads))
    return None


def _replay_fold(fields, replies, sms=132, occupancy=lambda t, smem: 2048 // t, seed=0, barrier=True):
    """fold_kernel on numpy lanes: blocks in a seeded order; phase 1 reads
    every guard against last_seq, raises match / flushed of fresh replies
    and keeps one ballot word a warp and run (the one-run kernel keeps
    the same bit in a register); then (barrier) phase 2 raises last_seq
    of the fresh replies. barrier=False lets each block run both phases
    before the next block starts."""
    out = {k: np.array(v, copy=True) for k, v in fields.items()}
    g_n, r_n = out["match_index"].shape
    match, flushed, last_seq = (out[k].reshape(-1) for k in ("match_index", "flushed_index", "last_seq"))
    rows, slots, dirty, fl, seq = replies
    m = len(rows)
    blocks, threads, its = _fold_grid(m, sms, occupancy)
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
                    g, r = rows[i], slots[i]
                    if not (0 <= g < g_n and 0 <= r < r_n):
                        continue
                    k = g * r_n + r
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
                        k = rows[i] * r_n + slots[i]
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


def test_kernel_replay_fold_skips_out_of_range_pairs():
    """Pairs outside [0, G) x [0, R) are skipped by the replay and the
    plain version alike: both equal the fold of the in-range replies."""
    rng = np.random.default_rng(73)
    fields = random_fields(rng, 16, 5)
    good = random_replies(rng, 16, 5, 120, pad=8)
    bad = [np.array(x, np.int64) for x in ([-1, 16, 3, 3, 99, -5], [0, 1, -1, 5, 2, 7],
                                          [500] * 6, [499] * 6, [9] * 6)]
    mixed = [np.concatenate([a[:60], b, a[60:]]) for a, b in zip(good, bad)]
    want = jq.fold_replies(jax_state(fields), *map(jnp.asarray, good))
    assert_states_equal(want, tq.fold_replies(torch_state(fields), *map(tvec, mixed)))
    got, _ = _replay_fold(fields, mixed, sms=1, occupancy=lambda t, s: 1)
    assert_states_equal(want, torch_state(got))


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


def _replay_commit(fields):
    """commit_step_kernel + commit_row on numpy lanes: rows padded to N =
    8, 16 or 32 slots, masks from 8-byte words for R a multiple of 8 (else
    slot by slot), lane_majority over min(flushed, match) and over match,
    and the rule."""
    r = fields["match_index"].shape[1]
    n = 8 if r <= 8 else (16 if r <= 16 else 32)
    g = len(fields["term"])
    m = np.full((g, n), I64_MIN, np.int64)
    c = np.full((g, n), I64_MIN, np.int64)
    m[:, :r] = fields["match_index"]
    c[:, :r] = fields["flushed_index"]
    self_flushed = c[:, 0].copy()
    c = np.minimum(c, m)

    def mask_of(lane):
        raw = np.ascontiguousarray(lane, np.bool_).view(np.uint8)
        if r % 8 == 0:
            words = raw.reshape(g, r // 8, 8).copy().view("<u8")[:, :, 0]
            return sum(np.array([_nonzero_bytes(w) for w in words[:, i]], np.int64) << (8 * i)
                       for i in range(r // 8))
        return sum((raw[:, s] != 0).astype(np.int64) << s for s in range(r))

    vm, om = mask_of(fields["is_voter"]), mask_of(fields["is_voter_old"])
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
