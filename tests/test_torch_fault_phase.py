"""chip_smoke.py's phase 15 on the CPU: `run_faults` with device="cpu"
at a shorter duration, as test_torch_entry_points runs phase 14. Part A:
three Brokers under crashes, partitions, leadership transfers and
test_nemesis.py's network nemesis, on an lz4 topic with every fetch
verified; part B: the tiered brokers under test_chaos.py's object-store
faults with zstd archives. run_faults raises on any violated check: I1-I3
in both parts, every acked record on each replica and L1-L4 over the live
fetch stream in A, every device_tick call of node 0 equal to the numpy
host leg on a copy of its lanes (advanced rows and the five lanes), the
tiered checks, the store trace's replay and the topic read again from
offset 0 after the trim in B. Every comparison is exact: each output is
an integer lane, an offset or a record."""

import pytest

import chip_smoke as cs
from redpanda_tpu_torch.ops import default_device

SECONDS_A, SECONDS_B = 4.0, 4.0


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


def test_phase_15_runs_on_the_cpu():
    r = cs.run_faults("cpu", SECONDS_A, SECONDS_B)
    a, b = r["a"], r["b"]
    assert a["held"] > 0
    assert a["linear"]["acked"] == a["stats"]["acked"] > 0
    assert sum(a["stats"]["nemesis"].values()) == a["stats"]["nemesis_trace_len"] > 0
    assert any(e[0] == "crash" for e in a["stats"]["events"] + b["stats"]["events"])
    assert b["stats"]["tiered_archived"] >= 1 and b["stats"]["tiered_trimmed"] >= 1
    assert b["hydrations"] > 0
    # the plain versions launch nothing, so count nothing
    assert not any(a["launches"].values()) and not any(b["launches"].values())


def test_replica_check_catches_a_wrong_or_missing_record():
    acked = [(0, 3, 7), (1, 0, 8)]
    rows = {0: {3: (b"seq-7", b"payload-7")}, 1: {0: (b"seq-8", b"payload-8")}}
    cs.check_acked(acked, rows.__getitem__, "replica")
    with pytest.raises(AssertionError, match="p1@0: acked seq 8"):
        cs.check_acked(acked, {0: rows[0], 1: {0: (b"seq-9", b"payload-9")}}.__getitem__, "replica")
    with pytest.raises(AssertionError, match="p0@3: acked seq 7"):
        cs.check_acked(acked, {0: {}, 1: rows[1]}.__getitem__, "replica")
