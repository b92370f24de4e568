"""The port's broker on the mesh quorum backend against the JAX
package's, exact.

One broker of each package over LoopbackNetwork with its real Kafka TCP
listener (chip_smoke.py's KafkaCluster and mesh_scenario, given either
package's entry points and placement package), both under
RP_QUORUM_BACKEND=mesh, RP_MESH_FULL=1 (every tick a full mesh frame)
and RP_MESH_DEVICES=8 (the eight chip blocks of bench.py:478): the port's
broker on `device="cpu"` (the kernels' plain PyTorch versions), the JAX
package's on its 8 host devices (tests/conftest.py). Both get the same
seeded traffic on an uncompressed topic of 4 partitions: half the
batches, then the other half while the lane of partition 0 moves into
another chip block (PartitionMover.move_lane, set up as
tests/test_placement.py:341 sets it up), then one frame at rest.
Compared, exactly: the produce base offsets, the high watermarks, the
records fetched back, the commit_index and last_visible lanes, the moved
lane's (chip, row) and mesh_totals(). One node, as the reference's lane
move test runs: with three, the raft offsets in the lanes depend on which
replica wins each first election, which differs run to run in either
package. The port's run also holds every mesh frame and health refresh
against the numpy host leg (chip_smoke.hold_mesh); chip_smoke's phase 16
runs three nodes (tests/test_torch_seams_phase.py on the CPU).
"""

import asyncio

import numpy as np
import pytest

import chip_smoke as cs
from redpanda_tpu_torch.ops import default_device

SEED = 20_260_122
TOPICS = [("mesh-t", 4, {})]
BATCHES = 16


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


def ref_broker():
    """The JAX package's Kafka entry points and placement package, as
    KafkaCluster and move_lanes take them."""
    from types import SimpleNamespace

    from redpanda_tpu import placement
    from redpanda_tpu.app import Broker, BrokerConfig
    from redpanda_tpu.kafka.client import KafkaClient, KafkaClientError
    from redpanda_tpu.models.fundamental import kafka_ntp
    from redpanda_tpu.raft.consensus import NotLeaderError
    from redpanda_tpu.rpc.loopback import LoopbackNetwork

    return SimpleNamespace(Broker=Broker, BrokerConfig=BrokerConfig, KafkaClient=KafkaClient,
                           KafkaClientError=KafkaClientError, LoopbackNetwork=LoopbackNetwork,
                           kafka_ntp=kafka_ntp, NotLeaderError=NotLeaderError, placement=placement)


def test_mesh_brokers_match_jax_package(tmp_path):
    batches = cs.broker_batches(SEED, [(name, parts) for name, parts, _ in TOPICS], BATCHES)
    held: list = []
    with cs.environ({**cs.SEAMS_ENV_B, "RP_CODEC_BACKEND": None}):
        ref = asyncio.run(cs.mesh_scenario(ref_broker(), str(tmp_path / "ref"), TOPICS, batches, 1, nodes=1))
        port = asyncio.run(cs.mesh_scenario(cs.port_broker(), str(tmp_path / "port"), TOPICS, batches, 1, held,
                                            nodes=1, device="cpu"))
    assert port["bases"] == ref["bases"]
    assert port["hwm"] == ref["hwm"]
    assert port["records"] == ref["records"]
    assert port["chips"] == ref["chips"] == 8
    assert [m["to"] for m in port["moves"]] == [m["to"] for m in ref["moves"]]
    assert port["moves"][0]["to"][0] != port["moves"][0]["from"][0]
    (p,), (r,) = port["lanes"], ref["lanes"]
    for lane in ("commit_index", "last_visible"):
        np.testing.assert_array_equal(p[lane], r[lane], err_msg=lane)
    assert p["commit_index"][port["moves"][0]["to"][1]] >= 0
    assert port["mesh_totals"] == ref["mesh_totals"]
    assert port["mesh_totals"]["active"] == 1 + TOPICS[0][1]
    # the mesh frames and refreshes held exact against the host leg
    (h,) = held
    assert h["frames"] and h["health"] and not h["errors"]
