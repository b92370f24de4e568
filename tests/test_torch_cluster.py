"""Port vs reference: the RF=3 ring cluster step, elections and the two
follower-side quorum rules.

The same seeded numpy states go through the JAX package's shard_map
programs (`cluster_tick_sharded` / `election_round_sharded` on
tests/conftest.py's virtual CPU devices) and the port's chip-block
versions on device="cpu" (the plain versions beside the CUDA kernels of
csrc/cluster.cu). Every output is an integer or a bool, so the
tolerance is exact equality. The CUDA kernels' ownership scheme (one
thread per home row owning its leader row and its two mirrors at
((d + hop) % D, i)) is replayed in Python below and held against the
JAX programs too, so a sign or routing slip shows before the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from redpanda_tpu.models import consensus_state as jcs
from redpanda_tpu.ops import quorum as jq
from redpanda_tpu.parallel import cluster_step as jcl
from redpanda_tpu.parallel import mesh as jmesh
from redpanda_tpu_torch.models import consensus_state as tcs
from redpanda_tpu_torch.ops import quorum as tq
from redpanda_tpu_torch.parallel import cluster_step as tcl
from redpanda_tpu_torch.parallel import mesh as tmesh

RF = 3
MIRRORS = ("fol_dirty", "fol_flushed", "fol_commit", "fol_term", "voted_term")
LEADER = tuple(tcs.FIELD_DTYPES)
I64_MIN = -(2**63)


# ------------------------------------------------------------- states
def to_jax(f: dict, mesh):
    sharding = jmesh.group_sharding(mesh)
    put = lambda a: jax.device_put(jnp.asarray(a), sharding)  # noqa: E731
    leader = jcs.GroupState(**{k: put(f["leader"][k]) for k in LEADER})
    return jcl.ClusterState(leader, *(put(f[k]) for k in MIRRORS), put(f["log_start"]))


def from_jax(s) -> dict:
    out = {k: np.asarray(getattr(s, k)).copy() for k in MIRRORS + ("log_start",)}
    out["leader"] = {k: np.asarray(getattr(s.leader, k)).copy() for k in LEADER}
    return out


def to_torch(f: dict) -> tcl.ClusterState:
    leader = tcs.group_state_from_numpy(f["leader"], "cpu")
    return tcl.ClusterState(
        leader, *(torch.from_numpy(f[k].copy()) for k in MIRRORS), torch.from_numpy(f["log_start"].copy())
    )


def from_torch(s: tcl.ClusterState) -> dict:
    out = {k: getattr(s, k).numpy().copy() for k in MIRRORS + ("log_start",)}
    out["leader"] = tcs.group_state_to_numpy(s.leader)
    return out


def assert_same(a: dict, b: dict, what: str) -> None:
    for k in MIRRORS + ("log_start",):
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}: {k}")
    for k in LEADER:
        np.testing.assert_array_equal(a["leader"][k], b["leader"][k], err_msg=f"{what}: leader.{k}")


def perturb(rng, f: dict) -> None:
    """Retention moves some log starts to commit + 1 and some mirrors
    lose their tail (stranding them); a few winners are seated at a new
    term (the host handoff), so the next heartbeat truncates."""
    g = len(f["log_start"])
    lead = f["leader"]
    adv = rng.random(g) < 0.2
    f["log_start"][adv] = np.maximum(f["log_start"][adv], lead["commit_index"][adv] + 1)
    lose = rng.random((g, RF - 1)) < 0.1
    f["fol_dirty"][lose] = np.minimum(f["fol_dirty"][lose], rng.integers(-1, 5, int(lose.sum())))
    f["fol_flushed"] = np.minimum(f["fol_flushed"], f["fol_dirty"])
    f["fol_commit"] = np.minimum(f["fol_commit"], f["fol_flushed"])
    seat = rng.random(g) < 0.1
    lead["is_leader"][seat] = True
    lead["term"][seat] += 1
    lead["term_start"][seat] = lead["match_index"][seat, 0] + 1


# --------------------------------------------- the kernels, replayed
def replay_tick(f: dict, new_dirty: np.ndarray, n: int):
    """csrc/cluster.cu cluster_tick_kernel, one home row at a time in a
    shuffled order (threads run in no order), with the kernel's indexing:
    home (d, i) owns leader row d*B+i and the mirror cells
    (((d+hop)%n)*B + i, hop-1). Scalar code, in place on numpy."""
    lead = f["leader"]
    g, r = lead["match_index"].shape
    b = g // n
    total = installs = 0
    for home in np.random.default_rng(g + n).permutation(g):
        d, i = divmod(int(home), b)
        m, fl = lead["match_index"][home], lead["flushed_index"][home]
        m[0] = max(m[0], new_dirty[home])
        fl[0] = max(fl[0], new_dirty[home])
        old_commit = int(lead["commit_index"][home])
        hb_term = int(lead["term"][home]) if lead["is_leader"][home] else -1
        hb_dirty, hb_start = int(m[0]), int(f["log_start"][home])
        for hop in range(1, RF):
            k = ((d + hop) % n) * b + i
            j = hop - 1
            fd, ff = int(f["fol_dirty"][k, j]), int(f["fol_flushed"][k, j])
            fc, ft = int(f["fol_commit"][k, j]), int(f["fol_term"][k, j])
            accept = hb_term >= max(ft, int(f["voted_term"][k, j]))
            new_term = hb_term > ft
            nfd = max(hb_dirty, fc) if new_term else (max(fd, hb_dirty) if accept else fd)
            stranded = accept and fd + 1 < hb_start
            if stranded:
                nfd = hb_start - 1
            nff = nfd if (new_term or stranded) else max(ff, nfd)
            prop = min(old_commit, nff)
            nfc = prop if accept and old_commit > fc and prop > fc else fc
            installs += stranded
            f["fol_dirty"][k, j], f["fol_flushed"][k, j] = nfd, nff
            f["fol_commit"][k, j], f["fol_term"][k, j] = nfc, max(ft, hb_term)
            m[hop] = max(m[hop], nfd)
            fl[hop] = max(fl[hop], nff)
        row = {k: v[home : home + 1].copy() for k, v in lead.items()}
        st = tq.quorum_commit_step_plain(tcs.group_state_from_numpy(row, "cpu"))
        lead["commit_index"][home] = int(st.commit_index[0])
        lead["last_visible"][home] = int(st.last_visible[0])
        total += int(st.commit_index[0]) > old_commit
    return total, installs


def replay_election(f: dict, mask: np.ndarray, hop: int, n: int):
    """csrc/cluster.cu election_kernel, one home row at a time in a
    shuffled order, with the kernel's indexing."""
    lead = f["leader"]
    g = len(mask)
    b = g // n
    elected = np.zeros(g, bool)
    terms = np.full(g, -1, np.int64)
    for home in np.random.default_rng(3 * g + n).permutation(g):
        d, i = divmod(int(home), b)
        kc = ((d + hop) % n) * b + i
        jc = hop - 1
        is_cand = bool(mask[home])
        cft, cvt = int(f["fol_term"][kc, jc]), int(f["voted_term"][kc, jc])
        cand_term, cand_dirty = max(cft, cvt) + 1, int(f["fol_dirty"][kc, jc])
        lt, il, grants = int(lead["term"][home]), bool(lead["is_leader"][home]), 1
        for h in range(RF):
            if h == hop:
                continue
            if h == 0:
                grant = is_cand and cand_term > lt and cand_dirty >= lead["match_index"][home, 0]
                lt = max(lt, cand_term if grant else 0)
                il = il and not grant
            else:
                k = ((d + h) % n) * b + i
                vt = int(f["voted_term"][k, h - 1])
                grant = is_cand and cand_term > max(int(f["fol_term"][k, h - 1]), vt) and (
                    cand_dirty >= f["fol_dirty"][k, h - 1]
                )
                f["voted_term"][k, h - 1] = max(vt, cand_term if grant else -1)
            grants += grant
        won = is_cand and grants >= RF // 2 + 1
        f["fol_term"][kc, jc] = max(cft, cand_term if won else -1)
        f["voted_term"][kc, jc] = max(cvt, cand_term if is_cand else -1)
        elected[home], terms[home] = won, cand_term if won else -1
        lead["is_leader"][home] = il and not won
        lead["term"][home] = max(lt, cand_term if won else 0)
    return elected, terms


# ---------------------------------------------- port vs the reference
@pytest.mark.parametrize("n", (3, 4, 8))
def test_rounds_match_jax(n):
    """Ten seeded rounds at D = n: a tick every round (30 % of groups
    append nothing), an election on a third of the groups every other
    round with candidate_hop alternating 1 and 2, retention / lost tails
    / re-seated winners every third round. After every call the port's
    plain version, the Python replay of the kernels' scheme and the JAX
    shard_map program agree on every lane, `elected`, the terms and
    both totals."""
    rng = np.random.default_rng(100 + n)
    g = 16 * n
    mesh = jmesh.make_mesh(n)
    tmesh_ = tmesh.make_mesh(n, device="cpu")
    jtick, ttick = jcl.cluster_tick_sharded(mesh), tcl.cluster_tick_sharded(tmesh_)
    jelect = {h: jcl.election_round_sharded(mesh, h) for h in (1, 2)}
    telect = {h: tcl.election_round_sharded(tmesh_, h) for h in (1, 2)}
    f = chip_smoke.cluster_fields(rng, g)
    installs_seen = elected_seen = 0
    for rnd in range(10):
        base = f["leader"]["match_index"][:, 0]
        new_dirty = np.where(rng.random(g) < 0.3, -1, base + rng.integers(0, 4, g)).astype(np.int64)
        js, jt, ji = jtick(to_jax(f, mesh), jnp.asarray(new_dirty))
        ts, tt, ti = ttick(to_torch(f), torch.from_numpy(new_dirty))
        rf = {k: (v.copy() if k != "leader" else {a: b.copy() for a, b in v.items()}) for k, v in f.items()}
        rt, ri = replay_tick(rf, new_dirty, n)
        f = from_jax(js)
        assert_same(from_torch(ts), f, f"round {rnd} tick (port)")
        assert_same(rf, f, f"round {rnd} tick (replay)")
        assert int(tt) == int(jt) == rt and int(ti) == int(ji) == ri, (rnd, int(jt), int(ji))
        installs_seen += int(ji)
        if rnd % 2:
            hop = 1 + (rnd // 2) % 2
            mask = rng.random(g) < 0.35
            js, je, jterm = jelect[hop](to_jax(f, mesh), jax.device_put(jnp.asarray(mask), jmesh.group_sharding(mesh)))
            ts, te, tterm = telect[hop](to_torch(f), torch.from_numpy(mask))
            rf = {k: (v.copy() if k != "leader" else {a: b.copy() for a, b in v.items()}) for k, v in f.items()}
            re_, rterm = replay_election(rf, mask, hop, n)
            f = from_jax(js)
            assert_same(from_torch(ts), f, f"round {rnd} election (port)")
            assert_same(rf, f, f"round {rnd} election (replay)")
            np.testing.assert_array_equal(te.numpy(), np.asarray(je))
            np.testing.assert_array_equal(re_, np.asarray(je))
            np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))
            np.testing.assert_array_equal(rterm, np.asarray(jterm))
            elected_seen += int(np.asarray(je).sum())
        if rnd % 3 == 2:
            perturb(rng, f)
    # the schedule exercised the paths it is there for
    assert installs_seen > 0 and elected_seen > 0


@pytest.mark.parametrize("n", (1, 2))
def test_ring_guard_matches_jax(n):
    with pytest.raises(ValueError) as jerr:
        jcl.cluster_tick_sharded(jmesh.make_mesh(n))
    with pytest.raises(ValueError) as terr:
        tcl.cluster_tick_sharded(tmesh.make_mesh(n, device="cpu"))
    assert str(terr.value) == str(jerr.value)
    state = tcl.make_cluster_state(4 * n, device="cpu")
    with pytest.raises(ValueError, match="ring replication needs"):
        tcl.cluster_tick(state, torch.full((4 * n,), 5), n)
    with pytest.raises(ValueError, match="ring replication needs"):
        tcl.election_round(state, torch.ones(4 * n, dtype=torch.bool), 1, n)


@pytest.mark.parametrize("hop", (0, 3, -1))
def test_bad_candidate_hop_matches_jax(hop):
    with pytest.raises(ValueError) as jerr:
        jcl.election_round_sharded(jmesh.make_mesh(8), hop)
    with pytest.raises(ValueError) as terr:
        tcl.election_round_sharded(tmesh.make_mesh(8, device="cpu"), hop)
    assert str(terr.value) == str(jerr.value)
    state = tcl.make_cluster_state(24, device="cpu")
    with pytest.raises(ValueError, match="candidate_hop"):
        tcl.election_round(state, torch.ones(24, dtype=torch.bool), hop, 3)


def test_make_cluster_state_matches_jax():
    want = from_jax(jcl.make_cluster_state(40))
    got = from_torch(tcl.make_cluster_state(40, device="cpu"))
    assert_same(got, want, "make_cluster_state")
    # the mirror lanes are distinct tensors: the kernels update in place
    s = tcl.make_cluster_state(8, device="cpu")
    ptrs = {getattr(s, k).data_ptr() for k in MIRRORS}
    assert len(ptrs) == len(MIRRORS)


def test_shard_group_state_pads_and_places():
    mesh = tmesh.make_mesh(8, device="cpu")
    s = tmesh.shard_group_state(tcl.make_cluster_state(20, device="cpu"), mesh)
    assert s.leader.match_index.shape == (24, 8) and s.fol_dirty.shape == (24, 2)
    assert not s.leader.is_leader[20:].any() and s.leader.is_leader[:20].all()
    assert tmesh.group_sharding(mesh).rows_per_block(20) == 3


# ----------------------------------- tests/test_ops.py, on the port
def _settled(n=8, g=64):
    """make_cluster_state at g groups over n blocks, ticked to commit 5
    everywhere (the setup of the TestClusterElection cases)."""
    mesh = tmesh.make_mesh(n, device="cpu")
    state = tmesh.shard_group_state(tcl.make_cluster_state(g, device="cpu"), mesh)
    tick = tcl.cluster_tick_sharded(mesh)
    state, _, _ = tick(state, torch.full((g,), 5))
    state, _, _ = tick(state, torch.full((g,), -1))
    return mesh, state, tick, g


def test_multi_device_tick():
    mesh = tmesh.make_mesh(8, device="cpu")
    g = 64
    state = tmesh.shard_group_state(tcl.make_cluster_state(g, device="cpu"), mesh)
    tick = tcl.cluster_tick_sharded(mesh)
    state, total, _ = tick(state, tmesh.place_rows(torch.full((g,), 5), mesh))
    assert int(total) == g
    assert (state.leader.commit_index == 5).all()
    # commit reaches followers on the NEXT heartbeat
    assert (state.fol_commit == -1).all()
    state, total2, _ = tick(state, torch.full((g,), -1))
    assert int(total2) == 0
    assert (state.fol_commit == 5).all()


def test_stranded_follower_installs_snapshot():
    mesh = tmesh.make_mesh(8, device="cpu")
    g = 64
    state = tcl.make_cluster_state(g, device="cpu")
    tick = tcl.cluster_tick_sharded(mesh)
    state, total, inst = tick(state, torch.full((g,), 9))
    assert int(total) == g and int(inst) == 0
    # strand hop-1 mirrors at 2; retention moves log start to 8
    state.fol_dirty[:, 0] = 2
    state.fol_flushed[:, 0] = 2
    state.fol_commit[:, 0] = 2
    state.log_start.fill_(8)
    state, _, inst = tick(state, torch.full((g,), -1))
    assert int(inst) == g
    assert (state.fol_dirty[:, 0] == 7).all() and (state.fol_commit[:, 0] >= 7).all()
    assert (state.fol_dirty[:, 1] == 9).all()
    state, _, inst2 = tick(state, torch.full((g,), -1))
    assert int(inst2) == 0
    assert (state.fol_dirty[:, 0] == 9).all()


def test_failover_election_log_ok_gate():
    mesh, state, tick, g = _settled()
    # home leaders die after appending a divergent uncommitted suffix
    state.leader.match_index[:, 0] = 9
    state.leader.flushed_index[:, 0] = 9
    state, elected, term = tcl.election_round_sharded(mesh, 1)(state, torch.ones(g, dtype=torch.bool))
    assert elected.all() and (term == 1).all()
    assert not state.leader.is_leader.any() and (state.leader.term == 1).all()


def test_short_log_candidate_loses():
    mesh, state, tick, g = _settled()
    state.fol_dirty[:, 0] = 3
    state.fol_flushed[:, 0] = 3
    state.fol_commit[:, 0] = 3
    state, elected, _ = tcl.election_round_sharded(mesh, 1)(state, torch.ones(g, dtype=torch.bool))
    assert not elected.any()


def test_non_uniform_mask_targets_home_blocks():
    mesh, state, tick, g = _settled()
    per = g // 8
    mask = torch.zeros(g, dtype=torch.bool)
    mask[:per] = True
    state, elected, _ = tcl.election_round_sharded(mesh, 1)(state, mask)
    assert elected[:per].all() and not elected[per:].any()
    il = state.leader.is_leader
    assert not il[:per].any() and il[per:].all()


def test_one_vote_per_term():
    mesh, state, tick, g = _settled()
    mask = torch.ones(g, dtype=torch.bool)
    state, won1, t1 = tcl.election_round_sharded(mesh, 1)(state, mask)
    assert won1.all() and (t1 == 1).all()
    state.fol_term[:, 1] = 0
    state.voted_term[:, 1] = 0
    state, won2, _ = tcl.election_round_sharded(mesh, 2)(state, mask)
    assert not won2.any(), "two leaders at one term"
    state.fol_term[:, 1] = 1
    state.voted_term[:, 1] = 0
    state, won3, t3 = tcl.election_round_sharded(mesh, 2)(state, mask)
    assert won3.all() and (t3 == 2).all()


def test_new_term_heartbeat_truncates_divergent_mirror():
    mesh, state, tick, g = _settled()
    assert (state.fol_commit == 5).all()
    state.fol_dirty.fill_(7)
    state.fol_flushed.fill_(7)
    state.leader.term.add_(1)
    state, _, _ = tick(state, torch.full((g,), -1))
    assert (state.fol_dirty == 5).all()
    assert (state.fol_commit == 5).all() and (state.fol_dirty >= state.fol_commit).all()


def port_model_outcomes() -> list[tuple]:
    """tests/test_ici_differential.py model_outcomes, through the port."""
    mesh = tmesh.make_mesh(8, device="cpu")
    g = 8
    state = tmesh.shard_group_state(tcl.make_cluster_state(g, device="cpu"), mesh)
    tick = tcl.cluster_tick_sharded(mesh)
    none = torch.full((g,), -1)
    out = []
    term0, commit0 = int(state.leader.term[0]), int(state.leader.commit_index[0])
    state, _, _ = tick(state, torch.full((g,), 5))
    state, _, _ = tick(state, none)
    out.append(("A", int(state.leader.term[0]) - term0, int(state.leader.commit_index[0]) - commit0))
    state.leader.match_index[:, 0] = 7
    state.leader.flushed_index[:, 0] = 7
    state, elected, terms = tcl.election_round_sharded(mesh, 1)(state, torch.ones(g, dtype=torch.bool))
    term_b = int(terms[0])
    new_leader_dirty = int(state.fol_dirty[0, 0])
    out.append(("B", bool(elected.all()), term_b - term0, new_leader_dirty - commit0))
    state.leader.is_leader.fill_(True)
    state.leader.term.fill_(term_b)
    state.leader.match_index[:, 0] = new_leader_dirty
    state.leader.flushed_index[:, 0] = new_leader_dirty
    state.fol_dirty[:, 1] = 9
    state.fol_flushed[:, 1] = 9
    state, _, _ = tick(state, none)
    assert int(state.fol_dirty[0, 1]) == new_leader_dirty
    state, _, _ = tick(state, torch.full((g,), 7))
    state, _, _ = tick(state, none)
    dirty_c = int(state.leader.match_index[0, 0])
    out.append(("C", int(state.leader.commit_index[0]) - commit0, bool((state.fol_dirty[0] == dirty_c).all())))
    return out


def test_model_outcomes_match_jax():
    from test_ici_differential import model_outcomes

    port = port_model_outcomes()
    assert port == model_outcomes()
    assert port == [("A", 0, 6), ("B", True, 1, 6), ("C", 8, True)]


# -------------------------------------- the two follower-side rules
def _leader_fields(rng, g, r=8):
    match = rng.integers(-1, 60, (g, r)).astype(np.int64)
    commit = rng.integers(-1, 40, g).astype(np.int64)
    return {
        "term": np.zeros(g, np.int64),
        "is_leader": rng.random(g) < 0.5,
        "commit_index": commit,
        "term_start": np.zeros(g, np.int64),
        "last_visible": commit + rng.integers(0, 5, g),
        "match_index": match,
        "flushed_index": match - rng.integers(0, 6, (g, r)),
        "is_voter": rng.random((g, r)) < 0.5,
        "is_voter_old": np.zeros((g, r), bool),
        "last_seq": np.zeros((g, r), np.int64),
    }


def _equal(tstate, jstate):
    got = tcs.group_state_to_numpy(tstate)
    for k in LEADER:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jstate, k)), err_msg=k)


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_follower_commit_step_matches_jax(seed):
    rng = np.random.default_rng(seed)
    g = 512
    f = _leader_fields(rng, g)
    lc = rng.integers(-1, 70, g).astype(np.int64)
    lc[rng.random(g) < 0.2] = I64_MIN  # no update this tick
    want = jq.follower_commit_step(jcs.GroupState(**{k: jnp.asarray(v) for k, v in f.items()}), jnp.asarray(lc))
    got = tq.follower_commit_step(tcs.group_state_from_numpy(f, "cpu"), torch.from_numpy(lc))
    _equal(got, want)


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_local_append_update_matches_jax(seed):
    rng = np.random.default_rng(seed)
    g, m = 256, 700  # rows repeat: duplicates resolve by max
    f = _leader_fields(rng, g)
    rows = rng.integers(0, g, m).astype(np.int64)
    dirty = rng.integers(-1, 90, m).astype(np.int64)
    fl = dirty - rng.integers(0, 5, m)
    want = jq.local_append_update(
        jcs.GroupState(**{k: jnp.asarray(v) for k, v in f.items()}),
        jnp.asarray(rows), jnp.asarray(dirty), jnp.asarray(fl),
    )
    got = tq.local_append_update(
        tcs.group_state_from_numpy(f, "cpu"), torch.from_numpy(rows), torch.from_numpy(dirty), torch.from_numpy(fl)
    )
    _equal(got, want)


@pytest.mark.parametrize("n", (3, 8))
def test_chip_smoke_cluster_phase_on_cpu(n):
    """chip_smoke's phase 10 (the dryrun scenario, then seeded ticks with
    elections held against the plain versions; 1M groups on the card)
    here on the CPU at a small size."""
    dry = chip_smoke.dryrun_cluster(torch, 64 * n, n, "cpu")
    assert dry == {"committed": 64 * n, "elected": 64 * n, "installs": 64 * n}
    out = chip_smoke.run_cluster(torch, 4000 * n, n, 10, "cpu")
    assert out["totals"]["elections"] == 2 and out["totals"]["elected"] > 0
