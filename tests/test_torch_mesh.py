"""Port vs reference: the mesh backend (RP_QUORUM_BACKEND=mesh).

The reference's MeshFrame runs its NamedSharding programs over
tests/conftest.py's virtual CPU devices; the port's MeshFrame lays the
same lanes out as D chip blocks on device="cpu" and runs the plain
versions of its kernels (the fold, the commit sweep and health_totals).
The same seeded schedule goes through both ShardGroupArrays with
RP_MESH_FULL=1 at D in {1, 2, 3, 8}: the advanced-row sets, every lane
and the fleet totals must be equal. The card's one-pass mesh frame
(ops.quorum.launch_mesh_frame: the fold kernel, then the mesh sweep
kernel) and its one-launch alternative (chip_quorum.py MESH_COOP) are
replayed in numpy (tests/test_torch_quorum.py) and held against the JAX
mesh_tick_frame on lanes sharded over D virtual devices. Every output
is an integer or a bool, so the tolerance is exact equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from redpanda_tpu.models import consensus_state as jcs
from redpanda_tpu.parallel import mesh as jmesh
from redpanda_tpu.parallel import mesh_frame as jmf
from redpanda_tpu.raft.shard_state import ShardGroupArrays as JaxArrays
from redpanda_tpu_torch.models import consensus_state as tcs
from redpanda_tpu_torch.ops import health as th
from redpanda_tpu_torch.parallel import mesh as tmesh
from redpanda_tpu_torch.parallel import mesh_frame as tmf
from redpanda_tpu_torch.raft.shard_state import ShardGroupArrays as TorchArrays
from test_torch_quorum import FRAME_GRIDS, _replay_frame, _replay_mesh_sweep, edge_fields, mixed_index_replies

G, ROUNDS, PER_ROUND = 1024, 5, 512
LANES = chip_smoke.LANES + chip_smoke.HEALTH_LANES


def _build(cls, n, seed, **kw):
    return chip_smoke.mesh_lanes(cls(capacity=n, **kw), n, seed)


def _schedule(rows, seed):
    """ROUNDS reply frames as tests/test_mesh_frame.py _schedule: unique
    rows per round, round 3 replays round 2's seq (stale), the last
    round appends duplicate (row, slot) pairs."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(ROUNDS):
        rr = rows[rng.choice(len(rows), size=min(PER_ROUND, len(rows)), replace=False)]
        slots = rng.integers(1, 8, len(rr)).astype(np.int64)
        dirty = rng.integers(-1, 1000, len(rr)).astype(np.int64)
        flushed = np.maximum(dirty - rng.integers(0, 25, len(rr)), -1)
        seq = np.full(len(rr), (2 if k == 3 else k) + 1, np.int64)
        if k == ROUNDS - 1:
            d = 64
            rr = np.concatenate([rr, rr[:d]])
            slots = np.concatenate([slots, slots[:d]])
            dirty = np.concatenate([dirty, dirty[:d] + 40])
            flushed = np.concatenate([flushed, flushed[:d] + 40])
            seq = np.concatenate([seq, seq[:d]])
        out.append((rr, slots, dirty, flushed, seq))
    return out


def _mesh_env(monkeypatch, devices):
    monkeypatch.setenv("RP_QUORUM_BACKEND", "mesh")
    monkeypatch.setenv("RP_MESH_FULL", "1")
    monkeypatch.setenv("RP_MESH_DEVICES", str(devices))


@pytest.mark.parametrize("devices", (1, 2, 3, 8))
def test_mesh_frame_differential(devices, monkeypatch):
    seed = 23 + devices
    _mesh_env(monkeypatch, devices)
    jarr, rows = _build(JaxArrays, G, seed)
    tarr, trows = _build(TorchArrays, G, seed, device="cpu")
    np.testing.assert_array_equal(rows, trows)
    assert jarr.chip_count() == tarr.chip_count() == devices
    assert tarr.mesh_totals() == jarr.mesh_totals()
    for k, (rr, slots, dirty, flushed, seq) in enumerate(_schedule(rows, seed + 1)):
        jadv, _ = jarr.frame_tick(rr, slots, dirty, flushed, seq)
        tadv, _ = tarr.frame_tick(rr, slots, dirty, flushed, seq)
        np.testing.assert_array_equal(np.sort(tadv), np.sort(jadv), err_msg=f"frame {k} advanced")
        for lane in LANES:
            np.testing.assert_array_equal(
                getattr(tarr, lane), getattr(jarr, lane), err_msg=f"frame {k} {lane}"
            )
        totals = tarr.mesh_totals()
        assert totals == jarr.mesh_totals(), f"frame {k} totals"
        assert totals["active"] == G and totals["advanced"] == len(tadv)
    assert tarr.lane_attribution()[-1]["groups"] == jarr.lane_attribution()[-1]["groups"]


def test_mesh_health_refresh_matches_jax(monkeypatch):
    _mesh_env(monkeypatch, 8)
    monkeypatch.delenv("RP_MESH_FULL")
    jarr, rows = _build(JaxArrays, 512, 77)
    tarr, _ = _build(TorchArrays, 512, 77, device="cpu")
    # rows that moved outside a frame: leadership changes, freed rows
    for a in (jarr, tarr):
        a.is_leader[rows[:40]] = False
        a.leader_id[rows[20:60]] = 3
        a.free_row(int(rows[100]))
        a.health_refresh()
    for lane in chip_smoke.HEALTH_LANES:
        np.testing.assert_array_equal(getattr(tarr, lane), getattr(jarr, lane), err_msg=lane)
    assert tarr.health_totals() == jarr.health_totals()
    assert tarr.mesh_totals() == jarr.mesh_totals()


def _random_lanes(rng, g, r=8):
    f = {
        "match_index": rng.integers(-1, 300, (g, r)).astype(np.int64),
        "commit_index": rng.integers(-1, 250, g).astype(np.int64),
        "is_voter": rng.random((g, r)) < 0.6,
        "is_voter_old": (rng.random((g, r)) < 0.4) & (rng.random(g) < 0.25)[:, None],
        "is_leader": rng.random(g) < 0.7,
    }
    f["flushed_index"] = np.maximum(f["match_index"] - rng.integers(0, 30, (g, r)), -1)
    return f, rng.random(g) < 0.5, rng.random(g) < 0.9


@pytest.mark.parametrize("devices,g", ((8, 1000), (3, 100), (5, 37), (1, 64)))
def test_health_totals_matches_jax(devices, g):
    """health_totals (plain) on padded lanes against the JAX mesh_health
    and mesh_tick_frame (its health and totals) on the unpadded lanes."""
    rng = np.random.default_rng(g)
    f, known, active = _random_lanes(rng, g)
    mesh = tmesh.make_mesh(devices, device="cpu")
    keys = ("match_index", "commit_index", "is_voter", "is_voter_old", "is_leader")
    place = lambda a: tmesh.place_rows(a, mesh)  # noqa: E731
    jh, jt = jmf.mesh_health(*(jnp.asarray(f[k]) for k in keys), jnp.asarray(known), jnp.asarray(active))
    th, tt = tmf.mesh_health(*(place(f[k]) for k in keys), place(known), place(active), devices)
    for k in jh:
        np.testing.assert_array_equal(th[k][:g].numpy(), np.asarray(jh[k]), err_msg=k)
    assert {k: int(v) for k, v in tt.items()} == {k: int(v) for k, v in jt.items()}

    # the tick frame: fold + commit + health + totals with `advanced`
    fields = {
        "term": np.zeros(g, np.int64),
        "term_start": rng.integers(0, 200, g).astype(np.int64),
        "last_visible": f["commit_index"].copy(),
        "last_seq": np.zeros((g, 8), np.int64),
        **f,
    }
    m = 3 * g
    rows = rng.integers(0, g, m).astype(np.int64)
    replies = [rows, rng.integers(1, 8, m), rng.integers(-1, 400, m), rng.integers(-1, 380, m),
               rng.integers(0, 3, m)]
    replies = [np.asarray(a, np.int64) for a in replies]
    js, jhealth, jtot = jmf.mesh_tick_frame(
        jcs.GroupState(**{k: jnp.asarray(v) for k, v in fields.items()}),
        *(jnp.asarray(a) for a in replies), jnp.asarray(known), jnp.asarray(active),
    )
    tstate = tmesh.shard_group_state(tcs.group_state_from_numpy(fields, "cpu"), mesh)
    ts, thealth, ttot = tmf.mesh_tick_frame(
        tstate, *(torch.from_numpy(a) for a in replies), place(known), place(active), devices
    )
    for k in tcs.FIELD_DTYPES:
        np.testing.assert_array_equal(getattr(ts, k)[:g].numpy(), np.asarray(getattr(js, k)), err_msg=k)
    for k in jhealth:
        np.testing.assert_array_equal(thealth[k][:g].numpy(), np.asarray(jhealth[k]), err_msg=k)
    assert {k: int(v) for k, v in ttot.items()} == {k: int(v) for k, v in jtot.items()}
    assert int(ttot["advanced"]) > 0


def test_health_totals_refuses_uneven_blocks():
    lanes = [torch.zeros((10, 8), dtype=torch.int64), torch.zeros(10, dtype=torch.int64),
             torch.zeros((10, 8), dtype=torch.bool), torch.zeros((10, 8), dtype=torch.bool)]
    flags = [torch.zeros(10, dtype=torch.bool)] * 3
    with pytest.raises(ValueError, match="equal chip blocks"):
        tmf.mesh_health(*lanes, *flags, 3)


def test_chip_addressing_matches_jax(monkeypatch):
    """chip_count / chip_block / chip_of_rows / alloc_row_on_chip give
    the reference's (chip, lane) addresses for the same RP_MESH_DEVICES,
    on a capacity the blocks do not divide."""
    monkeypatch.setenv("RP_QUORUM_BACKEND", "mesh")
    monkeypatch.setenv("RP_MESH_DEVICES", "8")
    jarr, tarr = JaxArrays(capacity=100), TorchArrays(capacity=100, device="cpu")
    assert tarr.chip_count() == jarr.chip_count() == 8
    assert tarr.chip_block() == jarr.chip_block() == 13
    rows = np.arange(100)
    np.testing.assert_array_equal(tarr.chip_of_rows(rows), jarr.chip_of_rows(rows))
    assert [tarr.chip_of(r) for r in (0, 12, 13, 99)] == [jarr.chip_of(r) for r in (0, 12, 13, 99)]
    for a in (jarr, tarr):
        for _ in range(10):
            a.alloc_row()
    for chip in (0, 3, 7, 2, 7, 0, 0):
        assert tarr.alloc_row_on_chip(chip) == jarr.alloc_row_on_chip(chip)
    for a in (jarr, tarr):  # block 0 = rows [0, 13) is now full
        with pytest.raises(RuntimeError, match="exhausted"):
            a.alloc_row_on_chip(0)
    with pytest.raises(ValueError, match="no such chip"):
        tarr.alloc_row_on_chip(8)


@pytest.mark.parametrize("devices,g", ((8, 4000), (3, 1001)))
def test_chip_smoke_mesh_phase_on_cpu(devices, g, monkeypatch):
    """chip_smoke's phase 9 (the mesh leg against the numpy host leg,
    at 1M rows on the card) here on the CPU at a small size."""
    out = chip_smoke.run_mesh_slice(g, devices, "cpu", window=64, big_window=512, windows=3, big_windows=1)
    assert out["frames"] == 5 and out["advanced_rows"] > 0


# (D, rows before padding): one block of 1,000 rows; 21- and 13-row chip
# blocks (fewer than 32 rows); 334- and 125-row blocks (not a multiple of
# 32, several CUDA blocks)
MESH_SHAPES = ((1, 1000), (3, 61), (3, 1000), (8, 100), (8, 1000))


def _pad_rows(a, d):
    """Pad the row axis to a multiple of d with neutral (zero) rows, as
    both MeshFrames place their lanes."""
    pad = (-len(a)) % d
    return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)]) if pad else a


@pytest.mark.parametrize("case", ("mixed", "no_replies", "no_advance"))
@pytest.mark.parametrize("r", (3, 8, 12, 32))
@pytest.mark.parametrize("devices,g0", MESH_SHAPES)
def test_mesh_frame_kernels_match_jax(devices, g0, r, case, monkeypatch):
    """The mesh frame's plain chain and both launch designs, replayed
    (the fold kernel, then the mesh sweep kernel; one cooperative launch
    with the fleet totals at a spread and a one-block grid), equal to
    the JAX mesh_tick_frame on lanes sharded over D devices,
    exactly: every lane, the health lanes and the five totals. Cases:
    replies with duplicate pairs, stale seqs, padding and out-of-range
    rows and slots; no replies (M = 0: no fold, no barrier); and a frame
    in which no row leads, so none advances and max_follower_lag keeps
    its initial 0."""
    rng = np.random.default_rng(1000 * devices + g0 + r)
    fields = edge_fields(rng, g0, r)
    if case == "no_advance":
        fields["is_leader"][:] = False
    known, active = rng.random(g0) < 0.5, rng.random(g0) < 0.9
    fields = {k: _pad_rows(v, devices) for k, v in fields.items()}
    known, active = _pad_rows(known, devices), _pad_rows(active, devices)
    g = len(known)
    replies = mixed_index_replies(rng, g, r, m=min(3 * g // 2, 700))
    if case == "no_replies":
        replies = [a[:0] for a in replies]

    mesh = jmesh.make_mesh(devices)
    jstate = jmesh.shard_group_state(jcs.GroupState(**{k: jnp.asarray(v) for k, v in fields.items()}), mesh)
    js, jhealth, jtot = jax.jit(jmf.mesh_tick_frame)(
        jstate, *map(jnp.asarray, replies), *(jmesh.place_rows(jnp.asarray(a), mesh) for a in (known, active)))
    want = {k: np.asarray(getattr(js, k)) for k in tcs.FIELD_DTYPES}
    want_h = {k: np.asarray(v) for k, v in jhealth.items()}
    want_t = [int(jtot[k]) for k in th.TOTALS]
    if case == "no_advance":
        assert want_t[:2] == [0, 0]
    elif case == "mixed":
        assert want_t[0] > 0

    ts, thealth, ttot = tmf.mesh_tick_frame(
        tcs.group_state_from_numpy(fields, "cpu"), *map(torch.from_numpy, replies),
        torch.from_numpy(known), torch.from_numpy(active), devices)
    got = [("plain", tcs.group_state_to_numpy(ts), {k: v.numpy() for k, v in thealth.items()},
            [int(ttot[k]) for k in th.TOTALS])]
    hb = np.zeros(0, np.int64)
    for name, (sms, occ) in FRAME_GRIDS.items():
        lanes, _, health, totals, _ = _replay_frame(fields, replies, hb, known, active, sms, occ, seed=r,
                                                    totals=True)
        got.append((f"one launch, {name}", lanes, health, list(totals)))
    lanes, health, totals = _replay_mesh_sweep(fields, replies, known, active, seed=r)
    got.append(("fold, then sweep", lanes, health, list(totals)))
    for label, lanes, health, totals in got:
        for k in tcs.FIELD_DTYPES:
            np.testing.assert_array_equal(lanes[k], want[k], err_msg=f"{label}: {k}")
        for k in want_h:
            np.testing.assert_array_equal(health[k], want_h[k], err_msg=f"{label}: {k}")
        assert totals == want_t, label
