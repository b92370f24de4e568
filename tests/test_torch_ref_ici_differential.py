"""tests/test_ici_differential.py run on the port: the ring cluster
model (parallel/cluster_step.py over 8 chip blocks) against the
broker's raft, one scripted schedule through both.

The schedule (one raft group, 3 replicas): A. the leader appends 6
entries and replicates them; B. it appends 2 more that never replicate
and dies, and a follower holding only the committed prefix campaigns;
C. the new leader appends 2 entries and the deposed leader rejoins.
Both sides must report the same phase outcomes.

The model leg is the reference's `model_outcomes` translated to the
port (torch tensors on the CPU: the kernels' plain versions;
`x.at[i].set(v)` -> a clone with `x[i] = v`; `jax.device_put` ->
`shard_group_state` on `make_mesh(8, "cpu")`). The broker side is the
reference's own `real_outcomes` (three raft nodes over loopback), as
the port has no broker raft yet (ROADMAP queue 1 step 4): the
comparison holds the port's model to the protocol the broker runs.
Carried: `test_model_and_broker_raft_agree`. Left out: nothing.
"""

import torch

from redpanda_tpu_torch.parallel import (
    cluster_tick_sharded,
    election_round_sharded,
    make_cluster_state,
    make_mesh,
    shard_group_state,
)

from test_ici_differential import real_outcomes
from test_raft import run


def _set(x: torch.Tensor, index, value) -> torch.Tensor:
    out = x.clone()
    out[index] = value
    return out


# ---------------------------------------------------------------- model
def model_outcomes() -> list[tuple]:
    """Run the schedule through the port's ring cluster model on 8
    chip blocks; emit the phase outcome tuples."""
    mesh = make_mesh(8, "cpu")
    g = 8
    put = lambda s: shard_group_state(s, mesh)
    state = put(make_cluster_state(g, device="cpu"))
    tick = cluster_tick_sharded(mesh)
    none = torch.full((g,), -1, dtype=torch.int64)
    outcomes: list[tuple] = []
    term0 = int(state.leader.term[0])
    commit0 = int(state.leader.commit_index[0])

    # A: append entries up to offset 5 (6 entries), replicate + settle
    state, _, _ = tick(state, torch.full((g,), 5, dtype=torch.int64))
    state, _, _ = tick(state, none)
    term_a = int(state.leader.term[0])
    commit_a = int(state.leader.commit_index[0])
    outcomes.append(("A", term_a - term0, commit_a - commit0))

    # B: divergent suffix on the (about to die) leader, then election
    # by the hop-1 follower holding only the committed prefix
    state = state._replace(
        leader=state.leader._replace(
            match_index=_set(state.leader.match_index, (slice(None), 0), 7),
            flushed_index=_set(state.leader.flushed_index, (slice(None), 0), 7),
        )
    )
    elect = election_round_sharded(mesh, candidate_hop=1)
    state, elected, terms = elect(state, torch.ones(g, dtype=torch.bool))
    won = bool(elected.all())
    term_b = int(terms[0])
    # the new leader's log is its (hop-1) mirror: committed prefix only
    new_leader_dirty = int(state.fol_dirty[0, 0])
    outcomes.append(("B", won, term_b - term0, new_leader_dirty - commit0))

    # C: leadership handoff is host bookkeeping (the model's documented
    # seam): seat the winner's state into the home leader lane at the
    # new term. The rejoined old leader becomes the hop-2 mirror
    # carrying its divergent suffix (dirty 9 > the new leader's 5);
    # the new term's first heartbeat must truncate it.
    state = put(
        state._replace(
            leader=state.leader._replace(
                is_leader=torch.ones(g, dtype=torch.bool),
                term=torch.full((g,), term_b, dtype=torch.int64),
                match_index=_set(state.leader.match_index, (slice(None), 0), new_leader_dirty),
                flushed_index=_set(state.leader.flushed_index, (slice(None), 0), new_leader_dirty),
            ),
            fol_dirty=_set(state.fol_dirty, (slice(None), 1), 9),
            fol_flushed=_set(state.fol_flushed, (slice(None), 1), 9),
        )
    )
    # heartbeat at the new term truncates the divergent mirror...
    state, _, _ = tick(state, none)
    assert int(state.fol_dirty[0, 1]) == new_leader_dirty, (
        "divergent mirror not truncated on the new term"
    )
    # ...then the new leader appends 2 entries (offsets 6,7) and they
    # commit cluster-wide
    state, _, _ = tick(state, torch.full((g,), 7, dtype=torch.int64))
    state, _, _ = tick(state, none)
    commit_c = int(state.leader.commit_index[0])
    fd = state.fol_dirty[0].numpy()
    dirty_c = int(state.leader.match_index[0, 0])
    logs_equal = bool((fd == dirty_c).all())
    outcomes.append(("C", commit_c - commit0, logs_equal))
    return outcomes


def test_model_and_broker_raft_agree(tmp_path):
    model = model_outcomes()
    real = run(real_outcomes(tmp_path))
    assert model == real, f"\nmodel: {model}\nreal:  {real}"
    # and the outcomes themselves are the protocol's promises
    assert model[0] == ("A", 0, 6)
    assert model[1] == ("B", True, 1, 6)
    assert model[2] == ("C", 8, True)
