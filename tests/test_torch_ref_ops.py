"""tests/test_ops.py run on the port: the quorum kernels, the device
CRC and the ring cluster step, differential against the scalar
reference (raft/quorum_scalar) and the host fold.

The reference builds its inputs with jax.numpy; here the same values
are torch tensors on the CPU (the kernels' plain PyTorch versions; the
CUDA kernels are held against those by chip_smoke.py). The mapping:

* `make_group_state(g, r)` -> `make_group_state(g, r, device="cpu")`;
  `jnp.asarray(a)` -> `torch.as_tensor(a)`; `x.at[i].set(v)` -> a
  clone with `x[i] = v` (`_set`).
* `jax.device_put(x, sharding)` / `place_rows` -> `place_rows(x,
  mesh)` on the mesh's device; the mesh is `make_mesh(8, "cpu")`, 8
  chip blocks (the reference asserts conftest's 8 virtual JAX devices
  instead).
* The port's commit step, fold and tick update the state IN PLACE (the
  JAX programs donate their state buffers), so the scalar expectation
  is taken before the step where the reference takes it after.
* `crc32c_batch_device` and `ShardGroupArrays` take `device="cpu"`.

Carried: all 30 tests (34 cases with their parameters). Left out:
nothing.
"""

import numpy as np
import pytest
import torch

from redpanda_tpu_torch.models.consensus_state import (
    SELF_SLOT,
    GroupState,
    make_group_state,
)
from redpanda_tpu_torch.ops import crc32c as dev_crc
from redpanda_tpu_torch.ops import quorum as q
from redpanda_tpu_torch.raft import quorum_scalar as ref
from redpanda_tpu_torch.utils import crc as host_crc

I64_MIN = -(2**63)
CPU = "cpu"


def _t(a, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _i64(a) -> torch.Tensor:
    return _t(a, torch.int64)


def _set(x: torch.Tensor, index, value) -> torch.Tensor:
    """`x.at[index].set(value)`: a copy of x with the cells replaced."""
    out = x.clone()
    out[index] = value if not isinstance(value, np.ndarray) else torch.as_tensor(value)
    return out


def _state(g, r) -> GroupState:
    return make_group_state(g, r, device=CPU)


def random_state(rng, g=64, r=8, joint_prob=0.2):
    state = _state(g, r)
    n_voters = rng.integers(1, r + 1, g)
    voter = np.zeros((g, r), bool)
    for i in range(g):
        voter[i, : n_voters[i]] = True
    old = np.zeros((g, r), bool)
    for i in range(g):
        if rng.random() < joint_prob:
            k = rng.integers(1, r + 1)
            slots = rng.permutation(r)[:k]
            old[i, slots] = True
    match = rng.integers(-1, 1000, (g, r)).astype(np.int64)
    flushed = match - rng.integers(0, 50, (g, r)).astype(np.int64)
    commit = rng.integers(-1, 500, g).astype(np.int64)
    term_start = rng.integers(0, 600, g).astype(np.int64)
    return state._replace(
        is_leader=_t(rng.random(g) < 0.8),
        is_voter=_t(voter),
        is_voter_old=_t(old),
        match_index=_i64(match),
        flushed_index=_i64(flushed),
        commit_index=_i64(commit),
        term_start=_i64(term_start),
    )


def scalar_expected_commit(state: GroupState):
    match = state.match_index.numpy()
    flushed = state.flushed_index.numpy()
    voter = state.is_voter.numpy()
    voter_old = state.is_voter_old.numpy()
    is_leader = state.is_leader.numpy()
    commit = state.commit_index.numpy()
    term_start = state.term_start.numpy()
    g, r = match.shape
    out = []
    for i in range(g):
        if not is_leader[i]:
            out.append(int(commit[i]))
            continue
        replicas = [
            ref.ReplicaState(
                match_index=int(match[i, j]),
                flushed_index=int(flushed[i, j]),
                is_voter=bool(voter[i, j]),
                is_voter_old=bool(voter_old[i, j]),
            )
            for j in range(r)
        ]
        out.append(
            ref.leader_commit_index(
                replicas,
                leader_flushed=int(flushed[i, SELF_SLOT]),
                commit_index=int(commit[i]),
                term_start=int(term_start[i]),
            )
        )
    return np.array(out, dtype=np.int64)


class TestQuorumCommit:
    @pytest.mark.parametrize("seed", range(8))
    def test_differential_vs_scalar(self, seed):
        rng = np.random.default_rng(seed)
        state = random_state(rng)
        expected = scalar_expected_commit(state)  # before the in-place step
        new = q.quorum_commit_step(state)
        np.testing.assert_array_equal(new.commit_index.numpy(), expected)

    def test_simple_majority(self):
        # 3 voters: self flushed 10, followers at 8 and 5 → commit 8
        state = _state(1, 4)
        state = state._replace(
            is_leader=_t([True]),
            is_voter=_t([[True, True, True, False]]),
            match_index=_i64([[10, 8, 5, I64_MIN]]),
            flushed_index=_i64([[10, 8, 5, I64_MIN]]),
            term_start=_i64([0]),
        )
        new = q.quorum_commit_step(state)
        assert int(new.commit_index[0]) == 8

    def test_flush_clamp(self):
        # followers ahead of leader's own flush → clamp to leader flushed
        state = _state(1, 4)
        state = state._replace(
            is_leader=_t([True]),
            is_voter=_t([[True, True, True, False]]),
            match_index=_i64([[20, 20, 20, I64_MIN]]),
            flushed_index=_i64([[7, 20, 20, I64_MIN]]),
            term_start=_i64([0]),
        )
        new = q.quorum_commit_step(state)
        assert int(new.commit_index[0]) == 7

    def test_term_gate_blocks_old_term_entries(self):
        # majority at 8 but current term starts at 9 → no commit
        state = _state(1, 4)
        state = state._replace(
            is_leader=_t([True]),
            is_voter=_t([[True, True, True, False]]),
            match_index=_i64([[10, 8, 8, I64_MIN]]),
            flushed_index=_i64([[10, 8, 8, I64_MIN]]),
            term_start=_i64([9]),
            commit_index=_i64([3]),
        )
        new = q.quorum_commit_step(state)
        assert int(new.commit_index[0]) == 3

    def test_joint_config_takes_min(self):
        state = _state(1, 6)
        state = state._replace(
            is_leader=_t([True]),
            is_voter=_t([[True, True, True, False, False, False]]),
            is_voter_old=_t([[False, False, False, True, True, True]]),
            match_index=_i64([[10, 10, 10, 4, 4, 4]]),
            flushed_index=_i64([[10, 10, 10, 4, 4, 4]]),
            term_start=_i64([0]),
        )
        new = q.quorum_commit_step(state)
        assert int(new.commit_index[0]) == 4

    def test_non_leader_untouched(self):
        state = _state(4, 4)
        state = state._replace(
            is_voter=torch.ones((4, 4), dtype=torch.bool),
            match_index=torch.full((4, 4), 100, dtype=torch.int64),
            flushed_index=torch.full((4, 4), 100, dtype=torch.int64),
        )
        new = q.quorum_commit_step(state)
        assert np.all(new.commit_index.numpy() == -1)


class TestFollowerCommit:
    @pytest.mark.parametrize("seed", range(4))
    def test_differential(self, seed):
        rng = np.random.default_rng(100 + seed)
        g = 128
        state = _state(g, 4)
        flushed = rng.integers(-1, 100, g).astype(np.int64)
        commit = rng.integers(-1, 80, g).astype(np.int64)
        leader_commit = rng.integers(-1, 150, g).astype(np.int64)
        state = state._replace(
            flushed_index=_set(state.flushed_index, (slice(None), SELF_SLOT), _i64(flushed)),
            commit_index=_i64(commit),
        )
        new = q.follower_commit_step(state, _i64(leader_commit))
        got = new.commit_index.numpy()
        for i in range(g):
            exp = ref.follower_commit_index(int(commit[i]), int(flushed[i]), int(leader_commit[i]))
            assert int(got[i]) == exp


class TestFoldReplies:
    def test_seq_guard_drops_stale(self):
        state = _state(2, 4)
        state = state._replace(last_seq=_set(state.last_seq, (0, 1), 10))
        new = q.fold_replies(
            state,
            group_idx=_i64([0, 0]),
            replica_slot=_i64([1, 2]),
            last_dirty=_i64([50, 60]),
            last_flushed=_i64([50, 60]),
            seq=_i64([5, 1]),  # seq 5 <= 10 → stale for slot 1
        )
        assert int(new.match_index[0, 1]) == -1  # dropped
        assert int(new.match_index[0, 2]) == 60  # applied

    def test_monotone_and_duplicates(self):
        state = _state(1, 4)
        new = q.fold_replies(
            state,
            group_idx=_i64([0, 0]),
            replica_slot=_i64([1, 1]),
            last_dirty=_i64([30, 20]),
            last_flushed=_i64([25, 22]),
            seq=_i64([2, 3]),
        )
        # duplicates resolve via max
        assert int(new.match_index[0, 1]) == 30
        assert int(new.flushed_index[0, 1]) == 25
        assert int(new.last_seq[0, 1]) == 3

    def test_heartbeat_tick_end_to_end(self):
        state = _state(3, 4)
        voters = torch.zeros((3, 4), dtype=torch.bool)
        voters[:, :3] = True
        state = state._replace(
            is_leader=torch.ones(3, dtype=torch.bool),
            is_voter=voters,
            match_index=_set(state.match_index, (slice(None), 0), 100),
            flushed_index=_set(state.flushed_index, (slice(None), 0), 100),
            term_start=torch.zeros(3, dtype=torch.int64),
        )
        # replies from both followers of each group at offset 100
        gi = _i64([0, 0, 1, 1, 2, 2])
        slot = _i64([1, 2, 1, 2, 1, 2])
        off = torch.full((6,), 100, dtype=torch.int64)
        seq = torch.ones(6, dtype=torch.int64)
        new = q.heartbeat_tick(state, gi, slot, off, off.clone(), seq)
        assert np.all(new.commit_index.numpy() == 100)


class TestBuildHeartbeats:
    def test_gather(self):
        state = _state(8, 4)
        state = state._replace(
            term=torch.arange(8, dtype=torch.int64),
            commit_index=torch.arange(8, dtype=torch.int64) * 10,
            match_index=_set(
                state.match_index, (slice(None), 0), torch.arange(8, dtype=torch.int64) * 100
            ),
        )
        hb = q.build_heartbeats(state, _i64([2, 5]))
        assert hb["term"].tolist() == [2, 5]
        assert hb["commit_index"].tolist() == [20, 50]
        assert hb["last_dirty"].tolist() == [200, 500]


class TestDeviceCrc32c:
    @pytest.mark.parametrize("seed,stride", [(0, 64), (1, 256), (2, 1024)])
    def test_differential_vs_host(self, seed, stride):
        rng = np.random.default_rng(seed)
        n = 32
        lens = rng.integers(0, stride + 1, n).astype(np.int64)
        mat = np.zeros((n, stride), dtype=np.uint8)
        for i in range(n):
            mat[i, : lens[i]] = rng.integers(0, 256, lens[i], dtype=np.uint8)
        dev = dev_crc.crc32c_batch_device(mat, lens, device=CPU)
        host = host_crc.crc32c_batch(mat, lens.astype(np.uint64))
        np.testing.assert_array_equal(dev, host)

    def test_known_vector(self):
        data = np.zeros((1, 16), dtype=np.uint8)
        payload = b"123456789"
        data[0, :9] = np.frombuffer(payload, np.uint8)
        out = dev_crc.crc32c_batch_device(data, np.array([9]), device=CPU)
        assert int(out[0]) == 0xE3069283


def _full(g, v, dtype=torch.int64):
    return torch.full((g,), v, dtype=dtype)


class TestClusterStep:
    def test_multi_device_tick(self):
        from redpanda_tpu_torch.parallel import (
            cluster_tick_sharded,
            make_cluster_state,
            make_mesh,
            place_rows,
            shard_group_state,
        )

        mesh = make_mesh(8, CPU)
        assert mesh.n_devices == 8
        g = 64  # 8 groups per chip block
        state = shard_group_state(make_cluster_state(g, device=CPU), mesh)
        tick = cluster_tick_sharded(mesh)
        new_dirty = place_rows(np.full(g, 5, np.int64), mesh)
        state, total, _inst = tick(state, new_dirty)
        # after one round every leader has both follower acks at 5 and
        # its own flush at 5 → all 64 groups commit
        assert int(total) == g
        assert np.all(state.leader.commit_index.numpy() == 5)
        # commit index reaches followers on the NEXT heartbeat (real
        # raft propagation): after tick 1 mirrors still hold -1
        assert np.all(state.fol_commit.numpy() == -1)
        # second tick with no new appends: no further leader advancement,
        # but followers learn the commit index
        zero = place_rows(np.full(g, -1, np.int64), mesh)
        state, total2, _inst = tick(state, zero)
        assert int(total2) == 0
        assert np.all(state.fol_commit.numpy() == 5)

    def test_stranded_follower_installs_snapshot_over_ici(self):
        """A mirror whose next entry fell below the leader's retained
        log cannot be append-served: one tick installs the snapshot
        boundary (committed by construction), and the NEXT tick
        catches it up to the leader's head normally."""
        from redpanda_tpu_torch.parallel import (
            cluster_tick_sharded,
            make_cluster_state,
            make_mesh,
            shard_group_state,
        )

        mesh = make_mesh(8, CPU)
        g = 64
        state = shard_group_state(make_cluster_state(g, device=CPU), mesh)
        tick = cluster_tick_sharded(mesh)
        dirty9 = _full(g, 9)
        none = _full(g, -1)
        state, total, inst = tick(state, dirty9)
        assert int(total) == g and int(inst) == 0

        # strand hop-1 mirrors at 2; retention moves leaders' log
        # start to 8 (snapshot boundary 7 <= commit 9)
        state = shard_group_state(
            state._replace(
                fol_dirty=_set(state.fol_dirty, (slice(None), 0), 2),
                fol_flushed=_set(state.fol_flushed, (slice(None), 0), 2),
                fol_commit=_set(state.fol_commit, (slice(None), 0), 2),
                log_start=_full(g, 8),
            ),
            mesh,
        )
        state, _, inst = tick(state, none)
        assert int(inst) == g
        fd = state.fol_dirty.numpy()
        fc = state.fol_commit.numpy()
        # installed exactly to the boundary, commit jumped with it
        assert (fd[:, 0] == 7).all(), fd[:, 0]
        assert (fc[:, 0] >= 7).all(), fc[:, 0]
        # healthy hop-2 mirrors never install
        assert (fd[:, 1] == 9).all()
        # next tick: normal appends resume from the boundary
        state, _, inst2 = tick(state, none)
        assert int(inst2) == 0
        fd = state.fol_dirty.numpy()
        assert (fd[:, 0] == 9).all(), fd[:, 0]


class TestHostDeviceTickParity:
    """The numpy host fold (shard_state.host_tick) must be bit-identical
    to the device sweep (ops.quorum.heartbeat_tick) — the backend
    choice is a pure performance decision."""

    def test_differential_random(self, monkeypatch):
        from redpanda_tpu_torch.raft.shard_state import ShardGroupArrays

        rng = np.random.default_rng(7)
        for trial in range(5):
            g, r = 64, 8
            mk = lambda: ShardGroupArrays(capacity=g, replica_slots=r, device=CPU)
            a_host, a_dev = mk(), mk()
            # random-but-valid state, mirrored into both
            for arrs in (a_host, a_dev):
                arrs.is_leader[:] = rng.random(g) < 0.7
                nv = rng.integers(1, 4, g)
                for row in range(g):
                    arrs.is_voter[row, : 2 * nv[row] + 1] = True
                    if rng.random() < 0.2:
                        arrs.is_voter_old[row, : 2 * nv[row] - 1] = True
                arrs.match_index[:] = rng.integers(-1, 50, (g, r))
                arrs.flushed_index[:] = np.minimum(
                    arrs.match_index, rng.integers(-1, 50, (g, r))
                )
                arrs.commit_index[:] = rng.integers(-1, 10, g)
                arrs.term_start[:] = rng.integers(0, 5, g)
                arrs.last_visible[:] = arrs.commit_index
                arrs.last_seq[:] = rng.integers(0, 3, (g, r))
            # identical state in both (copy from host arrays)
            for name in ("is_leader", "is_voter", "is_voter_old",
                         "match_index", "flushed_index", "commit_index",
                         "term_start", "last_visible", "last_seq"):
                getattr(a_dev, name)[:] = getattr(a_host, name)

            m = 96
            rows = rng.integers(0, g, m).astype(np.int64)
            slots = rng.integers(1, r, m).astype(np.int64)
            dirty = rng.integers(-1, 60, m).astype(np.int64)
            flushed = np.minimum(dirty, rng.integers(-1, 60, m)).astype(np.int64)
            seqs = rng.integers(0, 6, m).astype(np.int64)

            adv_h = a_host.host_tick(rows, slots, dirty, flushed, seqs)
            monkeypatch.setenv("RP_QUORUM_BACKEND", "device")
            adv_d = a_dev.device_tick(rows, slots, dirty, flushed, seqs)
            monkeypatch.delenv("RP_QUORUM_BACKEND")

            assert np.array_equal(adv_h, adv_d), f"trial {trial}"
            for name in ("match_index", "flushed_index", "commit_index",
                         "last_visible", "last_seq"):
                assert np.array_equal(
                    getattr(a_host, name), getattr(a_dev, name)
                ), f"trial {trial}: {name} diverged"

    def test_incremental_sweep_flush_clamp_release(self):
        """The incremental sweep must not starve the flush-clamp
        release: followers fully ack, leader's local fsync lands only
        BETWEEN ticks (no remote change) — the next tick must still
        advance commit via the SELF-slot change detection."""
        from redpanda_tpu_torch.raft.shard_state import ShardGroupArrays

        a = ShardGroupArrays(capacity=8, replica_slots=8, device=CPU)
        row = 0
        a.is_leader[row] = True
        a.is_voter[row, :3] = True  # self + 2 peers
        a.term_start[row] = 0
        # self appended to 10, fsync lags at 5
        a.match_index[row, SELF_SLOT] = 10
        a.flushed_index[row, SELF_SLOT] = 5

        rows = np.array([row, row], np.int64)
        slots = np.array([1, 2], np.int64)
        ten = np.array([10, 10], np.int64)
        # tick 1: both followers ack dirty=flushed=10 → commit clamps
        # to the leader's own flushed offset (5)
        adv = a.host_tick(rows, slots, ten, ten, np.array([1, 1], np.int64))
        assert list(adv) == [row]
        assert a.commit_index[row] == 5
        # local fsync completes between ticks; no remote values change
        a.flushed_index[row, SELF_SLOT] = 10
        # tick 2: replies identical except the seq guard — the sweep
        # must detect the SELF-slot movement and release the clamp
        adv = a.host_tick(rows, slots, ten, ten, np.array([2, 2], np.int64))
        assert list(adv) == [row]
        assert a.commit_index[row] == 10
        # tick 3: true steady state — nothing changed, nothing advances
        adv = a.host_tick(rows, slots, ten, ten, np.array([3, 3], np.int64))
        assert len(adv) == 0
        assert a.commit_index[row] == 10
        # seq guard still folded on the skip path
        assert a.last_seq[row, 1] == 3 and a.last_seq[row, 2] == 3


class TestClusterElection:
    """Cross-block elections + divergence truncation around the ring
    (vote_stm's log_ok gate and do_append_entries' new-term
    truncation)."""

    def _sharded_state(self, g=64):
        from redpanda_tpu_torch.parallel import make_cluster_state, make_mesh, shard_group_state

        mesh = make_mesh(8, CPU)
        state = shard_group_state(make_cluster_state(g, device=CPU), mesh)
        return mesh, state, g

    def _settled(self):
        from redpanda_tpu_torch.parallel import cluster_tick_sharded

        mesh, state, g = self._sharded_state()
        tick = cluster_tick_sharded(mesh)
        state, _, _ = tick(state, _full(g, 5))
        state, _, _ = tick(state, _full(g, -1))  # commit=5 known everywhere
        return mesh, state, g, tick

    def test_failover_election_log_ok_gate(self):
        from redpanda_tpu_torch.parallel import election_round_sharded

        mesh, state, g, _tick = self._settled()
        # home leaders die after appending a divergent UNCOMMITTED
        # suffix (dirty 9) that never replicated
        state = state._replace(
            leader=state.leader._replace(
                match_index=_set(state.leader.match_index, (slice(None), 0), 9),
                flushed_index=_set(state.leader.flushed_index, (slice(None), 0), 9),
            )
        )
        # hop-1 followers (log dirty=5 == every voter's committed data)
        # campaign for ALL groups and must WIN: quorum = self + hop-2
        # voter (log_ok 5>=5), without the dead home's vote
        elect = election_round_sharded(mesh, candidate_hop=1)
        state, elected, term = elect(state, _full(g, True, torch.bool))
        assert bool(np.all(elected.numpy())), "log_ok quorum failed"
        assert np.all(term.numpy() == 1)
        # deposed home leaders stepped down and observed the new term
        assert not np.any(state.leader.is_leader.numpy())
        assert np.all(state.leader.term.numpy() == 1)

    def test_short_log_candidate_loses(self):
        from redpanda_tpu_torch.parallel import election_round_sharded

        mesh, state, g, _tick = self._settled()
        # hop-1 candidate artificially LOSES its tail (mirror dirty 3 <
        # committed 5): the hop-2 voter's log_ok must reject it — the
        # gate that makes truncation-on-new-term lossless
        state = state._replace(
            fol_dirty=_set(state.fol_dirty, (slice(None), 0), 3),
            fol_flushed=_set(state.fol_flushed, (slice(None), 0), 3),
            fol_commit=_set(state.fol_commit, (slice(None), 0), 3),
        )
        elect = election_round_sharded(mesh, candidate_hop=1)
        state, elected, _term = elect(state, _full(g, True, torch.bool))
        assert not np.any(elected.numpy()), (
            "a candidate missing committed entries won an election"
        )

    def test_non_uniform_mask_targets_home_blocks(self):
        """candidate_mask is HOME-block aligned: masking only block 0's
        groups must elect exactly those groups, nothing else."""
        from redpanda_tpu_torch.parallel import election_round_sharded

        mesh, state, g, _tick = self._settled()
        per_dev = g // 8
        mask = _full(g, False, torch.bool)
        mask[:per_dev] = True  # block 0 only
        elect = election_round_sharded(mesh, candidate_hop=1)
        state, elected, _t = elect(state, mask)
        e = elected.numpy()
        assert e[:per_dev].all(), "home block 0 not elected"
        assert not e[per_dev:].any(), "election leaked to other blocks"
        # only block 0's home leaders stepped down
        il = state.leader.is_leader.numpy()
        assert not il[:per_dev].any() and il[per_dev:].all()

    def test_one_vote_per_term(self):
        """Granting adopts the candidate's term (voted_for): a SECOND
        candidate at the same term (the other ring follower) must not
        also win — no two leaders for one group and term."""
        from redpanda_tpu_torch.parallel import election_round_sharded

        mesh, state, g, _tick = self._settled()
        mask = _full(g, True, torch.bool)
        state, won1, t1 = election_round_sharded(mesh, 1)(state, mask)
        assert np.all(won1.numpy())
        assert np.all(t1.numpy() == 1)
        # a STALE hop-2 candidate that never heard of the election
        # (both its append-path and vote records forced back to 0)
        # campaigns at the SAME term 1: every voter's voted_term
        # already adopted term 1 when granting, so it gets only its
        # self-vote and loses everywhere
        state = state._replace(
            fol_term=_set(state.fol_term, (slice(None), 1), 0),
            voted_term=_set(state.voted_term, (slice(None), 1), 0),
        )
        state, won2, _t2 = election_round_sharded(mesh, 2)(state, mask)
        assert not np.any(won2.numpy()), "two leaders at one term"
        # once it LEARNS term 1 through the APPEND path, its next
        # candidacy runs at term 2 and wins legitimately — elections
        # stay live. (Reset the vote lane too: the failed candidacy
        # self-recorded term 1 there.)
        state = state._replace(
            fol_term=_set(state.fol_term, (slice(None), 1), 1),
            voted_term=_set(state.voted_term, (slice(None), 1), 0),
        )
        state, won3, t3 = election_round_sharded(mesh, 2)(state, mask)
        assert np.all(won3.numpy())
        assert np.all(t3.numpy() == 2)

    def test_new_term_heartbeat_truncates_divergent_mirror(self):
        mesh, state, g, tick = self._settled()
        assert np.all(state.fol_commit.numpy() == 5)

        # followers mirrored a deposed leader's uncommitted suffix
        # (dirty 7 > committed 5); the NEW leader (term 1) has dirty 5
        state = state._replace(
            fol_dirty=torch.full_like(state.fol_dirty, 7),
            fol_flushed=torch.full_like(state.fol_flushed, 7),
            leader=state.leader._replace(
                term=state.leader.term + 1,  # new-term leadership
            ),
        )
        state, _, _ = tick(state, _full(g, -1))
        fd = state.fol_dirty.numpy()
        fc = state.fol_commit.numpy()
        # divergent suffix truncated to the new leader's log...
        assert np.all(fd == 5), fd[:4]
        # ...and NEVER below anything committed
        assert np.all(fc == 5) and np.all(fd >= fc)
