"""The port's live Raft layer (storage, rpc, consensus, heartbeat and
group managers) held against the JAX package on the CPU.

Both packages get the same scripted scenario from a numpy seed
(chip_smoke.live_scenario, phase 12's scenario at a small size): three
GroupManagers over loopback, 64 groups of the three voters with node 0
forced leader, 8 rounds of 16 acks=-1 batches (16 records of 1 KiB),
one hand-driven heartbeat tick after each round, then health_report.
The reference runs it on its host leg and on RP_QUORUM_BACKEND=device
(its jitted programs on the CPU); the port on device="cpu" with the
default backend, every device_tick of node 0 held against the numpy
host leg as on the card. Exact: every ack's (base, last), each group's
commit_index, last_visible and term on every node, node 0's match_index
and flushed_index rows, health_report, and the records read back from
both followers' logs (also against those sent).

State carries across packages both ways: a data_dir that one package's
GroupManagers wrote (logs, kvstore) is restarted under the other's, and
beside it a copy restarted under the writer's own. Both restarts must
recover the same terms, batches and records (the writer's terms and the
records it was sent), and, once node 0 leads again, the same commit
indexes.
"""

import asyncio
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke as cs

GROUPS, ROUNDS, PER_ROUND, SEED = 64, 8, 16, 20_261_018


def ref_raft():
    from redpanda_tpu.models.record import RecordBatchBuilder, RecordBatchType
    from redpanda_tpu.raft.group_manager import GroupManager
    from redpanda_tpu.rpc.loopback import LoopbackNetwork, LoopbackTransport

    return SimpleNamespace(GroupManager=GroupManager, LoopbackNetwork=LoopbackNetwork,
                           LoopbackTransport=LoopbackTransport, RecordBatchBuilder=RecordBatchBuilder,
                           RecordBatchType=RecordBatchType)


# each package's GroupManager arguments: the port's on the CPU
LEGS = {"ref": (ref_raft, {}), "port": (cs.port_raft, {"device": "cpu"})}


def seeded_terms():
    return np.random.default_rng(SEED + 1).integers(1, 6, GROUPS)


def scenario(leg: str, data_dir, terms=0, hold: bool = False) -> dict:
    make, kw = LEGS[leg]
    held: list = []

    def hold_ticks(gm):
        held.append(cs.hold_device_ticks(gm.arrays))

    out = asyncio.run(cs.live_scenario(make(), str(data_dir), GROUPS, ROUNDS, PER_ROUND, SEED, steady=2,
                                       hold=hold_ticks if hold else None, terms=terms, **kw))
    if held:
        cs.check_held(held[0])
        out["held"] = held[0]["calls"]
    return out


@pytest.fixture
def port_default(monkeypatch):
    monkeypatch.delenv("RP_QUORUM_BACKEND", raising=False)


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The reference's scenario on its two legs."""
    runs = {}
    old = os.environ.get("RP_QUORUM_BACKEND")
    try:
        for backend in ("host", "device"):
            os.environ["RP_QUORUM_BACKEND"] = backend
            runs[backend] = scenario("ref", tmp_path_factory.mktemp(f"ref_{backend}"))
    finally:
        if old is None:
            os.environ.pop("RP_QUORUM_BACKEND", None)
        else:
            os.environ["RP_QUORUM_BACKEND"] = old
    return runs


@pytest.mark.parametrize("backend", ["host", "device"])
def test_live_layer_matches_reference(backend, reference_runs, port_default, tmp_path):
    port = scenario("port", tmp_path, hold=True)
    ref = reference_runs[backend]
    assert len(port["acks"]) == ROUNDS * PER_ROUND
    # every held device_tick was equal to the host leg (check_held);
    # replies reached the device leg through the frame
    assert sum(port["held"]) > 0
    assert port["flushes"] > 0
    assert port["health"]["active"] == GROUPS
    cs.same_live(port, ref, f"port vs reference ({backend} leg)")
    for nid in range(cs.LIVE_NODES):
        assert (port["state"][f"commit_index@{nid}"] >= 0).all()


def test_reference_legs_agree(reference_runs):
    cs.same_live(reference_runs["host"], reference_runs["device"], "reference host vs device leg")


async def restart(leg: str, data_dir) -> dict:
    """Restart three GroupManagers of `leg` on `data_dir`: the recovered
    terms, batches and records of every node, then node 0 forced leader
    again at the recovered terms and its followers caught up, the end
    state."""
    make, kw = LEGS[leg]
    live = cs.LiveRaft(make(), str(data_dir), GROUPS, **kw)
    await live.start()
    recovered = {f"term@{nid}": live.state()[f"term@{nid}"] for nid in range(cs.LIVE_NODES)}
    records = live.records(list(range(cs.LIVE_NODES)))
    await live.lead(None)
    state = live.state()
    await live.stop()
    return {"recovered": recovered, "records": records, "state": state}


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_state_carries_across_packages(writer, reader, port_default, tmp_path):
    terms = seeded_terms()
    wrote = scenario(writer, tmp_path / "a", terms=terms)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    other = asyncio.run(restart(reader, tmp_path / "a"))
    own = asyncio.run(restart(writer, tmp_path / "b"))
    for nid in range(cs.LIVE_NODES):
        np.testing.assert_array_equal(other["recovered"][f"term@{nid}"], wrote["state"][f"term@{nid}"])
        np.testing.assert_array_equal(other["recovered"][f"term@{nid}"], terms)
    cs.check_records(other["records"], wrote["sent"], range(cs.LIVE_NODES), GROUPS)
    assert other["records"] == own["records"]
    for k in own["recovered"]:
        np.testing.assert_array_equal(other["recovered"][k], own["recovered"][k], err_msg=k)
    for k in own["state"]:
        np.testing.assert_array_equal(other["state"][k], own["state"][k], err_msg=k)
    # leading again appends one configuration batch past the old commit
    assert (other["state"]["commit_index@0"] > wrote["state"]["commit_index@0"]).all()


def test_phase_12_runs_on_the_cpu(port_default):
    """chip_smoke phase 12's runs at a small size on the CPU: the
    device leg (plain versions) with every device_tick held, then the
    host leg, equal end states; no kernel launches off the card."""
    run = cs.run_live_raft("cpu", groups=32, rounds=4, per_round=8, steady=2)
    assert len(run["acks"]) == 32 and sum(run["held"]) > 0
    assert run["flushes"] > 0 and run["host"]["flushes"] > 0
    assert set(run["launches"]["path"]) == set(cs.LIVE_PATH) | {"tick_frame"}
    assert not any(run["launches"]["path"].values())
