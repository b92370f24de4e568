"""Port vs reference: the health reduction's plain PyTorch version.

Seeded numpy lanes go through redpanda_tpu.ops.health (JAX on the CPU),
redpanda_tpu_torch.ops.health on device="cpu" and the scalar oracle
raft/health_scalar.py. Outputs are int64 and bool: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redpanda_tpu.ops import health as jh
from redpanda_tpu_torch.ops import health as th
from redpanda_tpu_torch.raft import health_scalar as hs
from redpanda_tpu_torch.raft import quorum_scalar as qs

from test_torch_quorum import (
    assert_states_equal,
    jax_state,
    random_fields,
    random_replies,
    torch_state,
    tvec,
)

KEYS = ("max_lag", "under_replicated", "leaderless")


def health_inputs(rng, g, r):
    f = random_fields(rng, g, r)
    leader_known = rng.random(g) < 0.5
    active = rng.random(g) < 0.9
    return f, leader_known, active


def lane_args(f, leader_known, active):
    return (
        f["match_index"],
        f["commit_index"],
        f["is_voter"],
        f["is_voter_old"],
        f["is_leader"],
        leader_known,
        active,
    )


def scalar_health(f, leader_known, active):
    g, r = f["match_index"].shape
    rows = []
    for i in range(g):
        replicas = [
            qs.ReplicaState(
                match_index=int(f["match_index"][i, j]),
                is_voter=bool(f["is_voter"][i, j]),
                is_voter_old=bool(f["is_voter_old"][i, j]),
            )
            for j in range(r)
        ]
        rows.append(
            hs.group_health(
                replicas,
                int(f["commit_index"][i]),
                bool(f["is_leader"][i]),
                bool(leader_known[i]),
                bool(active[i]),
            )
        )
    return [np.array(col) for col in zip(*rows)]


@pytest.mark.parametrize("seed,r", [(s, r) for s in range(2) for r in (8, 5, 3)])
def test_health_reduce_matches_jax_numpy_and_scalar(seed, r):
    rng = np.random.default_rng(seed)
    f, known, active = health_inputs(rng, 128, r)
    args = lane_args(f, known, active)
    want = jh.health_reduce(*map(jnp.asarray, args))
    got = th.health_reduce(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args))
    mirror = th.health_reduce_np(*args)
    for k in KEYS:
        assert got[k].dtype == (torch.int64 if k == "max_lag" else torch.bool)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(mirror[k], np.asarray(want[k]), err_msg=k)
    for k, col in zip(KEYS, scalar_health(f, known, active)):
        np.testing.assert_array_equal(got[k].numpy(), col, err_msg=k)


@pytest.mark.parametrize("seed", range(2))
def test_tick_frame_health_matches_jax(seed):
    rng = np.random.default_rng(40 + seed)
    f, known, active = health_inputs(rng, 128, 8)
    replies = random_replies(rng, 128, 8, 256, pad=16)
    hb_idx = rng.integers(0, 128, 32).astype(np.int64)
    want, want_hb, want_h = jh.tick_frame_health(
        jax_state(f),
        *map(jnp.asarray, replies),
        jnp.asarray(hb_idx),
        jnp.asarray(known),
        jnp.asarray(active),
    )
    got, got_hb, got_h = th.tick_frame_health(
        torch_state(f),
        *map(tvec, replies),
        tvec(hb_idx),
        torch.from_numpy(known),
        torch.from_numpy(active),
    )
    assert_states_equal(want, got)
    for k in want_hb:
        np.testing.assert_array_equal(got_hb[k].numpy(), np.asarray(want_hb[k]), err_msg=k)
    for k in KEYS:
        np.testing.assert_array_equal(got_h[k].numpy(), np.asarray(want_h[k]), err_msg=k)


def test_health_reduce_rejects_mismatched_lanes():
    f, known, active = health_inputs(np.random.default_rng(9), 8, 4)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in lane_args(f, known, active)]
    args[1] = args[1].to(torch.int32)
    with pytest.raises(ValueError):
        th.health_reduce(*args)
