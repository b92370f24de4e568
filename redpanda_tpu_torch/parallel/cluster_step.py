"""Multi-device replicated cluster step — heartbeats and elections over a
ring of chip blocks.

Port of redpanda_tpu/parallel/cluster_step.py. It models an N-node
cluster as N chip blocks: block d leads the groups in its rows and
follows the groups of blocks d-1, d-2 (ring placement, replication
factor 3). One `cluster_tick` is the complete heartbeat round the
reference runs over TCP (heartbeat_manager.cc:373 → service.h:66 →
consensus append → reply → commit-index fold):

  1. leaders reflect their local appends (SELF_SLOT),
  2. heartbeat payloads (term/commit/last_dirty/log_start) go to the
     follower blocks on ring hops +1, +2,
  3. followers gate on term, truncate on a new term, install the
     snapshot boundary when stranded, advance their commit
     (follower_commit_step rule) and reply (last_dirty, last_flushed)
     over the reverse hops,
  4. leaders fold replies into slots positionally (slot r ↔ ring hop
     r) and run the quorum commit.

The totals of groups whose commit advanced and of installs are the
round's cross-block fold. `election_round` is the RequestVote exchange
for masked groups.

The JAX package runs each as one shard_map program over D devices with
ppermute between them. Here the D chip blocks are row ranges of tensors
on one card (parallel/mesh.py) and each round is one CUDA launch
(csrc/cluster.cu) plus, for the tick, its totals fold: the thread of
home row (d, i) owns the leader row and its two mirrors at
((d + hop) % D, i), so the ring needs no data movement at all. The
plain versions (`*_plain`) follow the JAX programs step by step, with
`ppermute` as a roll over the block axis and `psum` as a sum; they run
for CPU tensors. Both update the state's tensors in place and return
the same state object.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.consensus_state import GroupState, make_group_state
from ..observability import devplane
from ..ops import _build
from ..ops import quorum as q
from .mesh import Mesh

RF = 3  # replication factor modeled by the ring placement

LAUNCHES = devplane.count_launches({"cluster_tick": 0, "election_round": 0})

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("cluster")
        _build.bind(lib, "rp_cluster_tick", 18, 3)
        _build.bind(lib, "rp_election_round", 9, 4)
        _LIB = lib
    return _LIB


@dataclasses.dataclass(frozen=True)
class ClusterState:
    """Per-block leader state + follower-side mirrors.

    Every tensor's axis 0 is the global group axis, split into chip
    blocks. fol_* hold a block's *follower* role for the groups led by
    ring neighbors: fol_dirty[g, j] on block d is the mirrored dirty
    offset of the group at the same position of block d - (j + 1)."""

    leader: GroupState
    fol_dirty: torch.Tensor    # [G, RF-1] i64
    fol_flushed: torch.Tensor  # [G, RF-1] i64
    fol_commit: torch.Tensor   # [G, RF-1] i64
    fol_term: torch.Tensor     # [G, RF-1] i64 highest APPEND-path term seen
    # highest term this mirror VOTED in, kept apart from fol_term: a
    # granted vote adopts the term for elections but never truncates the
    # log; the new-term leader's first append does (reference :67-75)
    voted_term: torch.Tensor   # [G, RF-1] i64
    # leader-side first retained log offset (snapshot boundary + 1); a
    # mirror below it installs the snapshot instead of appending
    log_start: torch.Tensor    # [G] i64

    def _replace(self, **fields) -> "ClusterState":
        return dataclasses.replace(self, **fields)


def make_cluster_state(num_groups: int, replica_slots: int = 8, device="cuda") -> ClusterState:
    leader = make_group_state(num_groups, replica_slots, device)
    # every group: 3 voters in slots 0..2 (self + 2 ring followers)
    leader.is_leader.fill_(True)
    leader.is_voter[:, :RF] = True
    dev = leader.term.device
    shape = (num_groups, RF - 1)

    def full(v):
        return torch.full(shape, v, dtype=torch.int64, device=dev)

    return ClusterState(
        leader,
        full(-1),
        full(-1),
        full(-1),
        full(0),
        full(0),
        torch.zeros(num_groups, dtype=torch.int64, device=dev),
    )


def _ring_guard(n: int) -> None:
    """With fewer blocks than the replication factor the ring hops wrap
    onto the sender — a leader would count its own payload as a follower
    ack and commit unreplicated data."""
    if n < RF:
        raise ValueError(f"mesh has {n} devices; ring replication needs >= RF={RF}")


def _check_hop(candidate_hop: int) -> None:
    if not (1 <= candidate_hop < RF):
        raise ValueError(f"candidate_hop must be in [1, {RF}): {candidate_hop}")


def _check_cluster(state: ClusterState, n_devices: int) -> None:
    _ring_guard(n_devices)
    q.check_state(state.leader)
    g, r = state.leader.match_index.shape
    dev = state.leader.match_index.device
    if not RF <= r <= q.MAX_REPLICA_SLOTS:
        raise ValueError(f"replica_slots={r} outside [{RF}, {q.MAX_REPLICA_SLOTS}]")
    if g % n_devices:
        raise ValueError(f"{g} groups do not split into {n_devices} equal chip blocks")
    for name in ("fol_dirty", "fol_flushed", "fol_commit", "fol_term", "voted_term"):
        q.check_tensor(getattr(state, name), torch.int64, (g, RF - 1), dev, name)
    q.check_tensor(state.log_start, torch.int64, (g,), dev, "log_start")


def _ring(x: torch.Tensor, shift: int, n: int) -> torch.Tensor:
    """ppermute with pairs (i, (i + shift) % n) over n chip blocks:
    block d receives block d - shift's rows."""
    return torch.roll(x.reshape(n, -1, *x.shape[1:]), shifts=shift, dims=0).reshape(x.shape)


# ------------------------------------------------------------ the tick
def cluster_tick_plain(state: ClusterState, new_dirty: torch.Tensor, n_devices: int):
    """Plain PyTorch version of `cluster_tick`, step by step as the JAX
    program; writes the state in place."""
    n = n_devices
    leader = GroupState(*(t.clone() for t in state.leader))
    match, flushed = leader.match_index, leader.flushed_index
    # 1. local append
    match[:, 0] = torch.maximum(match[:, 0], new_dirty)
    flushed[:, 0] = torch.maximum(flushed[:, 0], new_dirty)
    old_commit = leader.commit_index.clone()
    # a deposed leader advertises term -1: followers reject the row
    hb_term = torch.where(leader.is_leader, leader.term, -1)
    payload = torch.stack([hb_term, leader.commit_index, match[:, 0], state.log_start], dim=-1)
    fol_dirty, fol_flushed = state.fol_dirty.clone(), state.fol_flushed.clone()
    fol_commit, fol_term = state.fol_commit.clone(), state.fol_term.clone()
    voted_term = state.voted_term
    installs = torch.zeros((), dtype=torch.int64, device=new_dirty.device)
    replies = []
    for hop in range(1, RF):
        # 2. the heartbeat reaches the follower block
        recv = _ring(payload, hop, n)
        j = hop - 1
        r_term, r_commit, r_dirty, r_start = recv.unbind(-1)
        # 3. term gate: the vote lane counts for acceptance; the append
        # lane alone triggers the new-term truncation
        cur_term = torch.maximum(fol_term[:, j], voted_term[:, j])
        accept = r_term >= cur_term
        new_term = r_term > fol_term[:, j]
        fol_term[:, j] = torch.maximum(fol_term[:, j], r_term)
        new_f_dirty = torch.where(
            new_term,
            torch.maximum(r_dirty, fol_commit[:, j]),
            torch.where(accept, torch.maximum(fol_dirty[:, j], r_dirty), fol_dirty[:, j]),
        )
        # install_snapshot: the mirror fell below the retained log
        stranded = accept & (fol_dirty[:, j] + 1 < r_start)
        new_f_dirty = torch.where(stranded, r_start - 1, new_f_dirty)
        new_f_flushed = torch.where(
            new_term | stranded, new_f_dirty, torch.maximum(fol_flushed[:, j], new_f_dirty)
        )
        proposed = torch.minimum(r_commit, new_f_flushed)
        new_f_commit = torch.where(
            accept & (proposed > fol_commit[:, j]), proposed, fol_commit[:, j]
        )
        installs = installs + stranded.sum()
        fol_dirty[:, j] = new_f_dirty
        fol_flushed[:, j] = new_f_flushed
        fol_commit[:, j] = new_f_commit
        # the reply returns over the reverse hop
        replies.append(_ring(torch.stack([new_f_dirty, new_f_flushed], dim=-1), -hop, n))
    # 4. fold replies: ring hop r maps positionally onto replica slot r
    for hop in range(1, RF):
        rep = replies[hop - 1]
        match[:, hop] = torch.maximum(match[:, hop], rep[:, 0])
        flushed[:, hop] = torch.maximum(flushed[:, hop], rep[:, 1])
    q.quorum_commit_step_plain(leader)
    total = (leader.commit_index > old_commit).sum()
    for dst, src in zip(state.leader, leader):
        dst.copy_(src)
    for name, src in (
        ("fol_dirty", fol_dirty),
        ("fol_flushed", fol_flushed),
        ("fol_commit", fol_commit),
        ("fol_term", fol_term),
    ):
        getattr(state, name).copy_(src)
    return state, total, installs


def cluster_tick(state: ClusterState, new_dirty: torch.Tensor, n_devices: int):
    """One heartbeat round over `n_devices` chip blocks, in place.
    new_dirty: [G] i64 — offsets appended to each leader's local log this
    tick. Returns (state, total_committed, total_installs): 0-d i64
    counts, over all blocks, of groups whose commit advanced and of
    stranded followers that installed the leader's snapshot boundary."""
    _check_cluster(state, n_devices)
    g, r = state.leader.match_index.shape
    dev = state.leader.match_index.device
    q.check_tensor(new_dirty, torch.int64, (g,), dev, "new_dirty")
    if not q._on_card(state.leader):
        return cluster_tick_plain(state, new_dirty, n_devices)
    partials = torch.zeros((n_devices, 2), dtype=torch.int64, device=dev)
    totals = torch.zeros(2, dtype=torch.int64, device=dev)
    if g:
        lead = state.leader
        lib = _lib()
        rc = lib.rp_cluster_tick(
            lead.term.data_ptr(),
            lead.is_leader.data_ptr(),
            lead.commit_index.data_ptr(),
            lead.term_start.data_ptr(),
            lead.last_visible.data_ptr(),
            lead.match_index.data_ptr(),
            lead.flushed_index.data_ptr(),
            lead.is_voter.data_ptr(),
            lead.is_voter_old.data_ptr(),
            state.fol_dirty.data_ptr(),
            state.fol_flushed.data_ptr(),
            state.fol_commit.data_ptr(),
            state.fol_term.data_ptr(),
            state.voted_term.data_ptr(),
            state.log_start.data_ptr(),
            new_dirty.data_ptr(),
            partials.data_ptr(),
            totals.data_ptr(),
            n_devices, g // n_devices, r,
            _build.stream_of(new_dirty),
        )
        _build.check(lib, rc, "cluster_tick")
        LAUNCHES["cluster_tick"] += 1
    return state, totals[0], totals[1]


# -------------------------------------------------------- the election
def election_round_plain(
    state: ClusterState, candidate_mask: torch.Tensor, candidate_hop: int, n_devices: int
):
    """Plain PyTorch version of `election_round`, step by step as the
    JAX program; writes the state in place."""
    n, j = n_devices, candidate_hop - 1
    term, is_leader = state.leader.term.clone(), state.leader.is_leader.clone()
    fol_term, voted_term = state.fol_term.clone(), state.voted_term.clone()
    # the home-aligned mask goes to the candidate block (home + hop)
    mask_at_cand = _ring(candidate_mask, candidate_hop, n)
    cand_term = torch.maximum(fol_term[:, j], voted_term[:, j]) + 1
    payload = torch.stack([mask_at_cand.long(), cand_term, state.fol_dirty[:, j]], dim=-1)
    grants = torch.ones_like(cand_term)  # self-vote
    for h in (h for h in range(RF) if h != candidate_hop):
        # candidate -> voter: the voter for hop h sits at home + h
        recv = _ring(payload, h - candidate_hop, n)
        is_cand, r_term, r_dirty = recv[:, 0] != 0, recv[:, 1], recv[:, 2]
        if h == 0:
            # the home block votes with its LEADER lane
            my_term, my_dirty = term, state.leader.match_index[:, 0]
        else:
            my_term = torch.maximum(fol_term[:, h - 1], voted_term[:, h - 1])
            my_dirty = state.fol_dirty[:, h - 1]
        grant = is_cand & (r_term > my_term) & (r_dirty >= my_dirty)
        # one vote per term: granting adopts the term in the VOTE lane
        if h == 0:
            term = torch.maximum(term, torch.where(grant, r_term, 0))
            is_leader = is_leader & ~grant
        else:
            voted_term[:, h - 1] = torch.maximum(voted_term[:, h - 1], torch.where(grant, r_term, -1))
        grants = grants + _ring(grant.long(), -(h - candidate_hop), n)
    elected_at_cand = mask_at_cand & (grants >= RF // 2 + 1)
    # the winner's mirror is the new leader log: its append term moves
    fol_term[:, j] = torch.maximum(fol_term[:, j], torch.where(elected_at_cand, cand_term, -1))
    voted_term[:, j] = torch.maximum(voted_term[:, j], torch.where(mask_at_cand, cand_term, -1))
    # results reported at the HOME block positions
    elected = _ring(elected_at_cand, -candidate_hop, n)
    observed = _ring(cand_term, -candidate_hop, n)
    # the deposed home leader steps down for elected groups
    state.leader.is_leader.copy_(is_leader & ~elected)
    state.leader.term.copy_(torch.maximum(term, torch.where(elected, observed, 0)))
    state.fol_term.copy_(fol_term)
    state.voted_term.copy_(voted_term)
    return state, elected, torch.where(elected, observed, -1)


def election_round(
    state: ClusterState, candidate_mask: torch.Tensor, candidate_hop: int, n_devices: int
):
    """A cross-block ELECTION for the masked groups, in place: the
    follower at ring hop `candidate_hop` campaigns to replace the
    (presumed dead) leader on the home block.

      1. the candidate bumps its follower-side term and asks every OTHER
         replica for a vote with (term, last_dirty),
      2. each voter grants iff the candidate's term beats anything it
         has seen AND the candidate's log is at least as long (the
         log_ok gate, consensus.cc handle_vote / vote_stm) — the safety
         property that makes cluster_tick's truncation lossless,
      3. candidate + grants >= quorum(RF) elects.

    candidate_mask: [G] bool at the HOME block positions. Returns
    (state, elected [G] bool at the home positions, the new term [G] i64
    where elected, else -1). The home leader lane observes the higher
    term and steps down for elected groups; seating the winner is host
    bookkeeping, as in the reference."""
    _check_hop(candidate_hop)
    _check_cluster(state, n_devices)
    g, r = state.leader.match_index.shape
    dev = state.leader.match_index.device
    q.check_tensor(candidate_mask, torch.bool, (g,), dev, "candidate_mask")
    if not q._on_card(state.leader):
        return election_round_plain(state, candidate_mask, candidate_hop, n_devices)
    elected = torch.zeros(g, dtype=torch.bool, device=dev)
    terms = torch.full((g,), -1, dtype=torch.int64, device=dev)
    if g:
        lib = _lib()
        rc = lib.rp_election_round(
            state.leader.term.data_ptr(),
            state.leader.is_leader.data_ptr(),
            state.leader.match_index.data_ptr(),
            state.fol_term.data_ptr(),
            state.voted_term.data_ptr(),
            state.fol_dirty.data_ptr(),
            candidate_mask.data_ptr(),
            elected.data_ptr(),
            terms.data_ptr(),
            n_devices, g // n_devices, r, candidate_hop,
            _build.stream_of(candidate_mask),
        )
        _build.check(lib, rc, "election_round")
        LAUNCHES["election_round"] += 1
    return state, elected, terms


# ------------------------------------------------- bound to one mesh
def _cluster_specs(mesh: Mesh) -> int:
    """The mesh's block count, guarding the ring size."""
    n = mesh.n_devices
    _ring_guard(n)
    return n


def cluster_tick_sharded(mesh: Mesh):
    """The cluster step bound to `mesh`: (state, new_dirty) ->
    (state, total_committed, total_installs), through its devplane
    probe "cluster.tick"."""
    n = _cluster_specs(mesh)

    def tick(state: ClusterState, new_dirty: torch.Tensor):
        return cluster_tick(state, new_dirty, n)

    return devplane.probe(tick, "cluster.tick")


def election_round_sharded(mesh: Mesh, candidate_hop: int = 1):
    """The election bound to `mesh` and `candidate_hop`: (state, mask)
    -> (state, elected, terms), through its devplane probe
    "cluster.election_round"."""
    _check_hop(candidate_hop)
    n = _cluster_specs(mesh)

    def elect(state: ClusterState, candidate_mask: torch.Tensor):
        return election_round(state, candidate_mask, candidate_hop, n)

    return devplane.probe(elect, "cluster.election_round")
