"""tests/test_mesh_frame.py run on the port: the mesh frame over D
chip blocks vs the host numpy sweep vs the scalar oracle,
byte-identical, at D = 1, 2 and 8.

The reference file is copied with its imports pointed at
redpanda_tpu_torch. Its `ShardGroupArrays` is the port's on the CPU
(`device="cpu"`: the mesh frame runs the kernels' plain versions, the
chain chip_smoke.py holds the CUDA mesh frame against), and an autouse
fixture sets RP_QUORUM_BACKEND=host, the reference's default, which the
cases override where they select the mesh. Carried: every case. Left
out: nothing.
"""

import numpy as np
import pytest

from redpanda_tpu_torch.models.consensus_state import SELF_SLOT
from redpanda_tpu_torch.raft import quorum_scalar as qs
from redpanda_tpu_torch.raft.shard_state import NO_OFFSET
from redpanda_tpu_torch.raft.shard_state import ShardGroupArrays as _Arrays

G = 2048
ROUNDS = 5
PER_ROUND = 1024
DEVICE_COUNTS = (1, 2, 8)

# the ISSUE's floor: ≥10k randomized cases across the sweep
assert len(DEVICE_COUNTS) * G * ROUNDS >= 10_000
assert len(DEVICE_COUNTS) * PER_ROUND * ROUNDS >= 10_000


def ShardGroupArrays(capacity=64, **kw):
    """The port's arrays on the CPU: the device and mesh legs run the
    kernels' plain PyTorch versions."""
    return _Arrays(capacity=capacity, device="cpu", **kw)


@pytest.fixture(autouse=True)
def _host_default(monkeypatch):
    # the reference's default quorum backend is the host fold; the
    # port's is the card
    monkeypatch.setenv("RP_QUORUM_BACKEND", "host")


def _build(n: int, seed: int):
    """n allocated rows with randomized quorum lanes (SELF always a
    current voter, ~25% of rows in joint consensus) — the
    tick_frame_smoke build, here the shared fixture both backends
    replay from."""
    arrays = ShardGroupArrays(capacity=n)
    rows = np.array([arrays.alloc_row() for _ in range(n)], np.int64)
    rng = np.random.default_rng(seed)
    r = arrays.replica_slots
    match = rng.integers(-1, 400, (n, r)).astype(np.int64)
    flushed = np.maximum(match - rng.integers(0, 40, (n, r)), NO_OFFSET)
    sent = rng.random((n, r)) < 0.15
    match[sent] = NO_OFFSET
    flushed[sent] = NO_OFFSET
    voter = rng.random((n, r)) < 0.6
    voter[:, SELF_SLOT] = True
    old = np.zeros((n, r), bool)
    joint = rng.random(n) < 0.25
    old[joint] = rng.random((int(joint.sum()), r)) < 0.5
    arrays.match_index[rows] = match
    arrays.flushed_index[rows] = flushed
    arrays.is_voter[rows] = voter
    arrays.is_voter_old[rows] = old
    arrays.is_leader[rows] = True
    arrays.commit_index[rows] = rng.integers(-1, 200, n)
    arrays.term_start[rows] = rng.integers(0, 300, n)
    arrays.last_visible[rows] = arrays.commit_index[rows]
    arrays.voter_epoch += 1
    arrays.touch()
    arrays.quorum_dirty[:] = False
    empty = np.empty(0, np.int64)
    arrays.frame_tick(empty, empty, empty, empty, empty, force_rows=rows)
    return arrays, rows


def _schedule(n: int, rows: np.ndarray, seed: int):
    """ROUNDS deterministic reply frames: per round, PER_ROUND unique
    rows each get one reply on a random non-SELF slot. Round 3 replays
    round 2's seq (stale — the guard must drop it identically on both
    backends); the last round appends duplicate (row, slot) pairs with
    diverging dirty values (the within-window scatter-max shape)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(ROUNDS):
        pick = rng.choice(n, size=min(PER_ROUND, n), replace=False)
        rr = rows[pick]
        slots = rng.integers(1, 8, len(rr)).astype(np.int64)
        dirty = rng.integers(-1, 1000, len(rr)).astype(np.int64)
        flushed = np.maximum(dirty - rng.integers(0, 25, len(rr)), -1)
        seq = np.full(len(rr), (2 if k == 3 else k) + 1, np.int64)
        if k == ROUNDS - 1:
            d = 64  # duplicate pairs: same lane twice in one window
            rr = np.concatenate([rr, rr[:d]])
            slots = np.concatenate([slots, slots[:d]])
            dirty = np.concatenate([dirty, dirty[:d] + 40])
            flushed = np.concatenate([flushed, flushed[:d] + 40])
            seq = np.concatenate([seq, seq[:d]])
        out.append((rr, slots, dirty, flushed, seq))
    return out


def _replay(arrays, sched):
    """Run every frame; returns the per-frame advanced-row sets."""
    advanced = []
    for rr, slots, dirty, flushed, seq in sched:
        adv, _ = arrays.frame_tick(rr, slots, dirty, flushed, seq)
        advanced.append(np.sort(np.asarray(adv, np.int64)))
    return advanced


def _lanes(arrays, rows) -> dict[str, bytes]:
    return {
        "commit_index": arrays.commit_index[rows].tobytes(),
        "last_visible": arrays.last_visible[rows].tobytes(),
        "match_index": arrays.match_index[rows].tobytes(),
        "flushed_index": arrays.flushed_index[rows].tobytes(),
        "health_max_lag": arrays.health_max_lag[rows].tobytes(),
        "health_under": arrays.health_under[rows].tobytes(),
        "health_leaderless": arrays.health_leaderless[rows].tobytes(),
    }


def _oracle_check(arrays, rows, sample: int, seed: int) -> None:
    """Sampled differential vs the scalar oracle (the third leg)."""
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(rows), size=min(sample, len(rows)), replace=False)
    for row in rows[pick]:
        row = int(row)
        replicas = [
            qs.ReplicaState(
                match_index=int(arrays.match_index[row, s]),
                flushed_index=int(arrays.flushed_index[row, s]),
                is_voter=bool(arrays.is_voter[row, s]),
                is_voter_old=bool(arrays.is_voter_old[row, s]),
            )
            for s in range(arrays.replica_slots)
            if arrays.is_voter[row, s] or arrays.is_voter_old[row, s]
        ]
        want = qs.leader_commit_index(
            replicas,
            leader_flushed=int(arrays.flushed_index[row, SELF_SLOT]),
            commit_index=int(arrays.commit_index[row]),
            term_start=int(arrays.term_start[row]),
        )
        assert int(arrays.commit_index[row]) == want, (
            f"row {row}: batched commit != scalar oracle {want}"
        )


@pytest.mark.parametrize("devices", DEVICE_COUNTS)
def test_mesh_frame_differential(devices, monkeypatch):
    seed = 23 + devices

    monkeypatch.setenv("RP_QUORUM_BACKEND", "host")
    monkeypatch.delenv("RP_MESH_FULL", raising=False)
    host, rows = _build(G, seed)
    sched = _schedule(G, rows, seed + 1)
    host_adv = _replay(host, sched)

    monkeypatch.setenv("RP_QUORUM_BACKEND", "mesh")
    monkeypatch.setenv("RP_MESH_FULL", "1")
    monkeypatch.setenv("RP_MESH_DEVICES", str(devices))
    mesh, rows2 = _build(G, seed)
    assert np.array_equal(rows, rows2)
    assert mesh.chip_count() == devices
    mesh_adv = _replay(mesh, sched)

    # the one cross-chip fold ran and saw the whole fleet
    totals = mesh.mesh_totals()
    assert totals is not None and totals["active"] == G

    # byte-identical advanced-row (changed-commit) sets, every frame
    assert len(host_adv) == len(mesh_adv) == ROUNDS
    for k, (a, b) in enumerate(zip(host_adv, mesh_adv)):
        assert a.tobytes() == b.tobytes(), (
            f"frame {k}: advanced rows diverged at {devices} devices "
            f"(host {len(a)} vs mesh {len(b)})"
        )

    # byte-identical lane state: commit/visible/fold lanes + the
    # health lanes the chip-local reduction produced
    hl, ml = _lanes(host, rows), _lanes(mesh, rows)
    for lane in hl:
        assert hl[lane] == ml[lane], (
            f"{lane} diverged host vs mesh at {devices} devices"
        )

    # third leg: the scalar oracle agrees with both
    _oracle_check(mesh, rows, sample=256, seed=seed + 2)


def test_mesh_health_refresh_matches_host(monkeypatch):
    """health_refresh (the read path's all-rows recompute) through the
    mesh program vs the host reduction — same lanes, same totals."""
    seed = 77
    monkeypatch.setenv("RP_QUORUM_BACKEND", "host")
    monkeypatch.delenv("RP_MESH_FULL", raising=False)
    host, rows = _build(512, seed)
    host.health_refresh()
    want = _lanes(host, rows)
    want_totals = host.health_totals()

    monkeypatch.setenv("RP_QUORUM_BACKEND", "mesh")
    monkeypatch.setenv("RP_MESH_DEVICES", "8")
    mesh, _ = _build(512, seed)
    mesh.health_refresh()
    got = _lanes(mesh, rows)
    for lane in ("health_max_lag", "health_under", "health_leaderless"):
        assert want[lane] == got[lane], f"{lane} diverged on refresh"
    assert mesh.health_totals() == want_totals
