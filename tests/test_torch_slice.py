"""Port vs reference: the replication slice end to end, and the
record-batch CRC seam.

The JAX package's ShardGroupArrays (device leg: the jitted programs on
the CPU) and the port's ShardGroupArrays(device="cpu") (device leg: the
kernels' plain versions) each run under their own TickFrame, fed the
same seeded traffic from chip_smoke.Traffic, for 20 ticks at G=256.
Every lane, the advanced rows, the heartbeat fields and the health
totals must be equal. chip_smoke.run_slice (device leg vs the port's
numpy host leg, the check the card run makes at G=50,000) runs here on
the CPU at G=512.
"""

import functools

import numpy as np
import pytest

import chip_smoke
from redpanda_tpu.models import record as jrecord
from redpanda_tpu.raft.shard_state import ShardGroupArrays as JaxArrays
from redpanda_tpu.raft.tick_frame import TickFrame as JaxFrame
from redpanda_tpu_torch.models import record as trecord
from redpanda_tpu_torch.raft.shard_state import ShardGroupArrays as TorchArrays
from redpanda_tpu_torch.raft.tick_frame import TickFrame as TorchFrame

G, TICKS = 256, 20


def test_slice_matches_jax_device_leg(monkeypatch):
    monkeypatch.setenv("RP_QUORUM_BACKEND", "device")
    jarr = JaxArrays(capacity=G)
    tarr = TorchArrays(capacity=G, device="cpu")
    jrows, trows = chip_smoke.setup_leg(jarr, G), chip_smoke.setup_leg(tarr, G)
    np.testing.assert_array_equal(jrows, trows)
    jframe, tframe = JaxFrame(jarr), TorchFrame(tarr)
    traffic = chip_smoke.Traffic(G, seed=11)
    hb_ticks = 0
    for t in range(TICKS):
        event = traffic.tick()
        hb = (t + 1) % chip_smoke.HB_EVERY == 0
        adv_j, hb_j, _ = chip_smoke.drive_tick(jarr, jframe, jrows, event, hb)
        adv_t, hb_t, _ = chip_smoke.drive_tick(tarr, tframe, trows, event, hb)
        np.testing.assert_array_equal(adv_t, adv_j, err_msg=f"tick {t} advanced")
        for lane in chip_smoke.LANES + chip_smoke.HEALTH_LANES:
            np.testing.assert_array_equal(
                getattr(tarr, lane), getattr(jarr, lane), err_msg=f"tick {t} {lane}"
            )
        if hb:
            hb_ticks += 1
            assert set(hb_t) == set(hb_j)
            for k in hb_j:
                np.testing.assert_array_equal(hb_t[k], hb_j[k], err_msg=f"tick {t} hb {k}")
    assert hb_ticks == TICKS // chip_smoke.HB_EVERY
    assert tframe.health_totals() == jframe.health_totals()
    for lane in chip_smoke.HEALTH_LANES:
        np.testing.assert_array_equal(getattr(tarr, lane), getattr(jarr, lane))


def test_run_slice_device_leg_matches_host_leg():
    out = chip_smoke.run_slice(512, TICKS, "cpu", seed=3)
    assert out["advanced_rows"] > 0
    assert out["health_totals"]["active"] == 512
    assert len(out["tick_s"]) == TICKS


def _batches(mod, seed, n=24):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        b = mod.RecordBatchBuilder(base_offset=16 * i, timestamp_ms=1_700_000_000_000 + i)
        for _ in range(int(rng.integers(1, 17))):
            size = int(rng.integers(0, 1025))
            b.add(rng.integers(0, 256, size, dtype=np.uint8).tobytes(), key=b"k%d" % i)
        out.append(b.build())
    return out


@pytest.mark.parametrize("seed", range(2))
def test_batch_crcs_match_jax(monkeypatch, seed):
    # the port's default CRC leg is the card's; point it at the CPU
    from redpanda_tpu_torch.ops import crc32c as tcrc

    monkeypatch.setattr(
        tcrc, "crc32c_batch_device",
        functools.partial(tcrc.crc32c_batch_device, device="cpu"),
    )
    jb, tb = _batches(jrecord, seed), _batches(trecord, seed)
    for a, b in zip(jb, tb):
        assert a.header.crc_prefix() + a.body == b.header.crc_prefix() + b.body
    want = jrecord.batch_crcs(jb)
    got = trecord.batch_crcs(tb)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [b.header.crc & 0xFFFFFFFF for b in tb])
    monkeypatch.setenv("RP_CRC_BACKEND", "host")
    np.testing.assert_array_equal(trecord.batch_crcs(tb), want)


_ARMED = """\
import json, sys
sys.path.insert(0, {repo!r})
import chip_smoke
from redpanda_tpu_torch.ops import default_device
default_device.DEVICE = "cpu"
out = chip_smoke.armed_run("cpu", 256, 10, 2048, 8, 4)
print(json.dumps(out["kernels"]))
"""


@pytest.mark.parametrize("sample", ["16", "1"])
def test_armed_run_checks_pass_on_cpu(tmp_path, sample):
    """chip_smoke's armed phase at a small size on the CPU: every check
    (sampled counts per probe, one fold a frame, no tick breach, the
    mesh frames' transfer bytes, entry() against its plain chain, the
    snapshot round trip) passes through the plain versions."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "armed.py"
    script.write_text(_ARMED.format(repo=repo))
    env = dict(os.environ, RP_DEVPLANE="1", RP_DEVPLANE_SAMPLE=sample)
    run = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         env=env, cwd=repo, timeout=600)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-4000:]
    kernels = json.loads(run.stdout.strip().splitlines()[-1])
    assert set(chip_smoke.ARMED_PATH) <= set(kernels)
    if sample == "1":
        assert all(d["samples"] == d["calls"] for d in kernels.values())
