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
