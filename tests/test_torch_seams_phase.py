"""chip_smoke.py's phase 16 on the CPU: `run_seams_zstd` (part A) and
`run_seams_mesh` (part B) with device="cpu" at small counts, as
test_torch_fault_phase runs phase 15. Part A: three Brokers under
RP_ZSTD_BACKEND=tpu, a zstd topic whose leaders recompress every
uncompressed batch, then an lz4 topic fed producer-compressed zstd
batches (decoded, then re-encoded by the fused CRC + LZ4 entry), every
zstd encode, zstd decode and fused call held against its plain version
and counted by stage, no punt to the host codec, every stored zstd batch
decoded through libzstd to the body sent. Part B: three Brokers under
RP_QUORUM_BACKEND=mesh over 8 chip blocks with a lane moved across
blocks mid-produce, every node's mesh frames and health refreshes held
against the numpy host leg, beside the host quorum backend. The
functions raise on any violated check; every comparison is exact. The
plain versions count no launch on the CPU. A wrong plain version, fed
to a hold, fails the phase."""

import numpy as np
import pytest

import chip_smoke as cs
from redpanda_tpu_torch.ops import default_device
from redpanda_tpu_torch.ops import zstd as zstd_ops


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


def test_phase_16_part_a_runs_on_the_cpu():
    r = cs.run_seams_zstd("cpu", partitions=4, count=8, mismatch=4)
    s = r["stages"]
    assert r["batches"] == (8, 4) and r["retries"] == (0, 0)
    assert s["a1"]["held"] == {"zstd_encode": 8, "zstd_decode": 0, "fused_lz4": 0}
    assert s["a2"]["held"] == {"zstd_encode": 0, "zstd_decode": 4, "fused_lz4": 4}
    # the consumer decodes each JSON-like batch of the zstd topic (the
    # random ones are stored as raw blocks: nothing to decode)
    assert s["fetch"]["held"] == {"zstd_encode": 0, "zstd_decode": 4, "fused_lz4": 0}
    assert r["stored_zstd"] == 8 and r["fetch_responses"] > 0
    assert not any(r["launches"].values())


def test_phase_16_part_b_runs_on_the_cpu():
    # the host LZ4 codec: the plain fused chain takes about a second a
    # batch on the CPU (part A holds the fused entry)
    r = cs.run_seams_mesh("cpu", partitions=4, count=8, moves=1, env={"RP_CODEC_BACKEND": None})
    assert r["batches"] == 8 and r["chips"] == cs.SEAMS_MESH_DEVICES
    (m,) = r["moves"]
    assert m["partition"] == 0 and m["to"][0] != m["from"][0]
    assert len(r["frames"]) == 3 and all(r["frames"]) and r["refreshes"] > 0
    assert r["records"] == r["host"]["records"] and r["bases"] == r["host"]["bases"]
    assert r["mesh_totals"]["advanced"] == 0 and r["mesh_totals"]["active"] == 5
    assert not any(r["launches"].values())


def _wrong(plain, field: int):
    """`plain` with one element of output `field` changed."""

    def wrong(*args, **kwargs):
        out = list(plain(*args, **kwargs))
        t = out[field].clone()
        t.view(-1)[0] += 1
        out[field] = t
        return tuple(out)

    return wrong


@pytest.mark.parametrize("kernel,plain,field", [
    ("zstd_encode", zstd_ops._encode_chunks_plain, 0),
    ("zstd_decode", cs.decode_plain, 0),
    ("fused_lz4", None, 0),
])
def test_a_wrong_plain_version_fails_the_phase(kernel, plain, field):
    import torch

    if plain is None:
        def plain(d, v, n):
            return cs.fused_plain(torch, d, v, n, host_crc=True)
    with pytest.raises(AssertionError, match=f"{kernel} call 0: "):
        cs.run_seams_zstd("cpu", partitions=1, count=2, mismatch=1, plains={kernel: _wrong(plain, field)})


def test_mesh_hold_catches_a_wrong_host_leg(monkeypatch):
    from redpanda_tpu_torch.raft.shard_state import ShardGroupArrays

    with cs.mesh_env(cs.SEAMS_MESH_DEVICES):
        arrays, rows = cs.mesh_lanes(ShardGroupArrays(capacity=64, device="cpu"), 40, 7)
        held = cs.hold_mesh(arrays)
        replies = cs.mesh_window(np.random.default_rng(8), rows, 16, 1, arrays.replica_slots)
        arrays.device_tick(*replies)
        arrays.health_refresh()
        assert len(held["frames"]) == 1 and len(held["health"]) == 1 and not held["errors"]
        host_tick = ShardGroupArrays.host_tick

        def wrong(self, *args, **kwargs):
            out = host_tick(self, *args, **kwargs)
            self.commit_index[rows[0]] += 1
            return out

        monkeypatch.setattr(ShardGroupArrays, "host_tick", wrong)
        with pytest.raises(AssertionError, match="mesh frame 1: commit_index"):
            arrays.device_tick(*cs.mesh_window(np.random.default_rng(9), rows, 16, 2, arrays.replica_slots))
    assert len(held["errors"]) == 1
