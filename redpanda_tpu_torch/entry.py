"""Entry points of the port, shaped like the JAX package's root
`__graft_entry__.py`.

entry(device=None)  — the fused heartbeat tick (fold a node-batch of
                      append_entries replies into [G, R] consensus
                      tensors, then advance every group's commit index)
                      at G = 1024, R = 8, RF = 3: returns the port's
                      `ops.quorum.heartbeat_tick` and its example
                      arguments, on the card unless `device` says
                      otherwise.
dryrun_multichip(n, device=None) — the replicated cluster step over n
                      chip blocks on one card (parallel/cluster_step.py:
                      leader append → heartbeats around the ring →
                      follower accept/commit → reply → quorum sweep),
                      then a failover election, a joint reconfiguration
                      that gates commit, and a snapshot install, with
                      the reference scenario's assertions.

`device="cpu"` runs the kernels' plain PyTorch versions (the tests).
"""

from __future__ import annotations

import numpy as np
import torch

G, R, RF = 1024, 8, 3


def entry(device=None):
    """(heartbeat_tick, example_args): every group leads with voters in
    slots 0..RF-1, self at offset 100, and one reply at offset 100 from
    each of its two followers."""
    from .models.consensus_state import make_group_state
    from .ops.quorum import heartbeat_tick

    state = make_group_state(G, R, device or "cuda")
    dev = state.term.device
    state.is_leader.fill_(True)
    state.is_voter[:, :RF] = True
    state.match_index[:, 0] = 100
    state.flushed_index[:, 0] = 100
    m = G * (RF - 1)
    i64 = dict(dtype=torch.int64, device=dev)
    group_idx = torch.arange(G, **i64).repeat_interleave(RF - 1)
    replica_slot = torch.arange(1, RF, **i64).repeat(G)
    last_dirty = torch.full((m,), 100, **i64)
    last_flushed = torch.full((m,), 100, **i64)
    seq = torch.ones(m, **i64)
    example_args = (state, group_idx, replica_slot, last_dirty, last_flushed, seq)
    return heartbeat_tick, example_args


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def dryrun_multichip(n_devices: int, device=None) -> str:
    """Run the reference's dry-run scenario over `n_devices` chip
    blocks (8 groups a block) on one card; raise AssertionError on any
    failed check and return the summary line it prints."""
    from .ops.quorum import quorum_commit_step
    from .parallel import (
        cluster_tick_sharded,
        election_round_sharded,
        make_cluster_state,
        make_mesh,
        shard_group_state,
    )

    mesh = make_mesh(n_devices, device or "cuda")
    dev = mesh.device
    g = 8 * n_devices
    state = shard_group_state(make_cluster_state(g, device=dev), mesh)
    tick = cluster_tick_sharded(mesh)

    def full(v, dtype=torch.int64):
        return torch.full((g,), v, dtype=dtype, device=dev)

    state, total, _inst = tick(state, full(7))
    total = int(total)
    assert total == g, f"expected all {g} groups to commit, got {total}"
    commit = _host(state.leader.commit_index)
    assert (commit == 7).all(), commit

    # leader failure -> election gated on log_ok -> divergent-suffix
    # truncation on the new term, committed data intact throughout
    none = full(-1)
    state, _, _ = tick(state, none)  # followers learn commit=7
    # dead leaders hold an unreplicated divergent suffix (dirty 11)
    match, flushed = state.leader.match_index.clone(), state.leader.flushed_index.clone()
    match[:, 0] = 11
    flushed[:, 0] = 11
    state = state._replace(leader=state.leader._replace(match_index=match, flushed_index=flushed))
    elect = election_round_sharded(mesh, candidate_hop=1)
    state, elected, _terms = elect(state, full(True, torch.bool))
    elected_n = int(_host(elected).sum())
    assert elected_n == g, f"failover election: {elected_n}/{g} won"
    assert (_host(state.fol_commit) >= 7).all(), "committed data lost in failover"

    # joint reconfiguration mid-failover: the new voter set {0, 1}
    # beside the old {0, 2}, whose slot 2 lags at 7; the commit rule
    # takes the min of both quorums, so commit stays gated at 7 until
    # the old set dissolves, then the new quorum (both at 9) commits
    leader = state.leader
    match, flushed = leader.match_index.clone(), leader.flushed_index.clone()
    match[:, 0], flushed[:, 0] = 9, 9
    match[:, 1], flushed[:, 1] = 9, 9
    match[:, 2], flushed[:, 2] = 7, 7
    is_voter = torch.zeros_like(leader.is_voter)
    is_voter[:, :2] = True
    is_voter_old = torch.zeros_like(leader.is_voter)
    is_voter_old[:, 0] = True
    is_voter_old[:, 2] = True
    leader = leader._replace(
        is_leader=full(True, torch.bool),
        term=leader.term + 1,
        term_start=full(0),
        is_voter=is_voter,
        is_voter_old=is_voter_old,
        match_index=match,
        flushed_index=flushed,
        commit_index=full(7),
    )
    state = state._replace(leader=leader)

    def step(s):
        # the commit step updates its state in place: step a copy, so
        # `state` keeps the lanes the reference's functional step keeps
        return quorum_commit_step(s._replace(commit_index=s.commit_index.clone(),
                                             last_visible=s.last_visible.clone()))

    gated = _host(step(state.leader).commit_index)
    assert (gated == 7).all(), f"joint quorum must gate on the OLD set's laggard: {gated[:4]}"
    done = _host(step(state.leader._replace(is_voter_old=torch.zeros_like(is_voter_old))).commit_index)
    assert (done == 9).all(), done[:4]

    # recovery: strand the hop-1 mirrors below the leaders' retained log,
    # then one tick installs the snapshot boundary on them
    fol_dirty, fol_flushed, fol_commit = (t.clone() for t in (state.fol_dirty, state.fol_flushed,
                                                              state.fol_commit))
    fol_dirty[:, 0] = fol_flushed[:, 0] = fol_commit[:, 0] = 1
    state = state._replace(
        leader=state.leader._replace(
            is_leader=full(True, torch.bool),
            is_voter_old=torch.zeros_like(is_voter_old),
        ),
        fol_dirty=fol_dirty,
        fol_flushed=fol_flushed,
        fol_commit=fol_commit,
        log_start=full(6),  # snapshot boundary 5 <= commit 7
    )
    state, _, installs = tick(state, none)
    installs = int(installs)
    assert installs == g, f"expected {g} snapshot installs, got {installs}"
    assert (_host(state.fol_dirty)[:, 0] >= 5).all(), "stranded mirrors not recovered"
    line = (
        f"dryrun_multichip OK: {n_devices} chip blocks, {g} raft groups, "
        f"{total} commits in one replicated tick; failover election won "
        f"for {elected_n} groups with committed data intact; joint "
        f"reconfiguration mid-failover gated commit on both quorums "
        f"(7 -> 9 on completion); {installs} stranded followers healed "
        f"by install_snapshot"
    )
    print(line)
    return line


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry OK:", int(out.commit_index[0]))
    dryrun_multichip(8)
