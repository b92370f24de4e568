"""tests/test_producer_expiry.py run on the port: all 3 cases, with
imports pointed at redpanda_tpu_torch. An autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu" (the
kernels' plain versions). Nothing is left out.

Idle idempotent-producer eviction (reference: rm_stm producer-id
expiration) + snapshot-format compatibility of the timestamp trailer."""

import struct

import pytest

from redpanda_tpu_torch.cluster.producer_state import (
    DuplicateSequence,
    ProducerStateTable,
)
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


def _observe(t, pid, seq, ts_ms):
    t.observe(pid, 0, seq, seq, kafka_base=seq, ts_ms=ts_ms)


def test_idle_producers_evicted_active_kept():
    t = ProducerStateTable()
    _observe(t, 1, 0, ts_ms=1_000)      # idle
    _observe(t, 2, 0, ts_ms=900_000)    # recent
    _observe(t, 3, 0, ts_ms=1_000)      # idle but in-flight
    evicted = t.expire(1_000_000, retention_ms=500_000, active={3})
    assert evicted == [1]
    # evicted producer is forgotten: same (seq) is accepted anew
    t.check(1, 0, 0, 0)  # no raise
    # survivors still dedupe
    with pytest.raises(DuplicateSequence):
        t.check(2, 0, 0, 0)
    with pytest.raises(DuplicateSequence):
        t.check(3, 0, 0, 0)
    # retention <= 0 disables
    assert t.expire(10**15, retention_ms=0) == []


def test_unknown_timestamps_never_expire():
    t = ProducerStateTable()
    t.observe(9, 0, 0, 0, kafka_base=0)  # no ts (old-format replay)
    assert t.expire(10**15, retention_ms=1) == []


def test_snapshot_trailer_roundtrip_and_back_compat():
    t = ProducerStateTable()
    _observe(t, 5, 3, ts_ms=777)
    blob = t.encode()
    t2 = ProducerStateTable.decode(blob)
    assert t2._pids[5].last_ts_ms == 777
    # old-format blob (no trailer) still decodes; ts unknown
    n = struct.unpack_from("<I", blob, 0)[0]
    assert n == 1
    # strip the trailer: header(4) + producer row (qiqI=24) + 1 batch (24)
    old = blob[: 4 + 24 + 24]
    t3 = ProducerStateTable.decode(old)
    assert t3._pids[5].last_seq == 3
    assert t3._pids[5].last_ts_ms == 0  # unknown -> never expires
    with pytest.raises(DuplicateSequence):
        t3.check(5, 0, 3, 3)
