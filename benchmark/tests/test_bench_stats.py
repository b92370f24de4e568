"""The end-to-end metrics and the roofline byte counts on hand-made
records of a run."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

import run
from harness import cell, stats, trace, traffic

MIX = {"pool_batches": 4, "pool_stride": 3, "record_bytes": 1000, "records_per_batch": 2, "producer_codec": "none"}
POOL = traffic.pool(MIX, 1, wire_batches=False)
BATCH_BYTES = sum(len(k) + len(v) for k, v in POOL[0]["records"])


def _gen(latencies, stall=None):
    """One partition, a batch due every 0.1 s from t=0 (open loop), each
    acked after its latency and received 5 ms later; a stall (k, s)
    holds every reply from batch k on until s seconds past its due
    time. The window is [1, 9)."""
    gen = {"t0": 1.0, "t1": 9.0, "sent": [], "attempts": [], "acks": [], "failed": [], "receipts": []}
    hold = None
    for k, lat in enumerate(latencies):
        due = 0.1 * k
        if stall is not None and k == stall[0]:
            hold = due + stall[1]
        t_ack = max(due + lat, hold or 0.0)
        gen["sent"].append([0, k, k % 4, due, due + 0.001])
        gen["attempts"].append([0, k, due + 0.001, t_ack, 0])
        gen["acks"].append([0, k, k % 4, due, t_ack, 2 * k])
        gen["receipts"].append([0, 2 * k, t_ack + 0.005, 0, 0, 0, 2, 0])
    return gen


def test_rate_is_all_acked_work_over_the_whole_window():
    gen = _gen([0.1] * 100)
    m = stats.end_to_end(gen, POOL)
    acked_in = sum(1 for a in gen["acks"] if 1.0 <= a[4] < 9.0)
    assert m["produce_mb_s"] == pytest.approx(acked_in * BATCH_BYTES / 8.0 / 1e6)
    assert m["attempted"] == sum(1 for s in gen["sent"] if 1.0 <= s[3] < 9.0) and m["failed"] == 0
    assert m["publish_p95_ms"] == pytest.approx(100.0)
    assert m["e2e_p95_ms"] == pytest.approx(105.0)
    assert m["late_ms"] == pytest.approx(1.0)


def test_a_stall_moves_the_rate_and_the_tails():
    calm = stats.end_to_end(_gen([0.1] * 100), POOL)
    stalled = stats.end_to_end(_gen([0.1] * 100, stall=(40, 6.0)), POOL)
    assert stalled["produce_mb_s"] < 0.7 * calm["produce_mb_s"]
    # every batch due during the stall waits for its end: timed from when it was due
    assert stalled["publish_p95_ms"] > 4000.0
    tails = stats.end_to_end(_gen([0.1, 2.0] * 50), POOL)
    assert tails["publish_p95_ms"] == pytest.approx(2000.0)


def test_a_missing_reply_counts_to_the_end_of_the_run():
    gen = _gen([0.1] * 100)
    gen["acks"] = [a for a in gen["acks"] if a[1] != 30]
    gen["receipts"] = gen["receipts"][:50]
    m = stats.end_to_end(gen, POOL)
    assert m["failed"] == 1
    assert m["e2e_p95_ms"] > 1000.0


def test_p95_is_nearest_rank_over_every_sample():
    assert stats.p95(list(range(1, 101))) == 95
    assert stats.p95([5.0]) == 5.0


def test_roofline_byte_counts_on_hand_made_batches():
    # acknowledged inside the window counts, whenever it fell due: the
    # third was due in the warm-up, the fourth is due inside but acked
    # after the close (above capacity the brokers work behind the offer)
    gen = {"t0": 0.0, "t1": 10.0,
           "acks": [[0, 0, 0, 1.0, 1.1, 0], [0, 1, 1, 1.1, 1.2, 2], [0, 2, 3, -1.0, 0.5, 4], [1, 0, 2, 9.5, 11.1, 0]],
           "receipts": [[0, 0, 2.0, 0, 109, 0, 2, 100], [0, 2, 2.0, 0, 59, 0, 2, 50], [1, 0, 12.0, 0, 9, 0, 2, 0]]}
    fields = (0, 3, 1, 0, 0, -1, -1, -1, 2)
    stored = {0: [[(fields, b"a" * 300), (fields, b"b" * 200), (fields, b"d" * 100)]] * 3,
              1: [[(fields, b"c" * 7)]] * 3}
    config = {"topic_configs": {"compression.type": "lz4"}}
    recompress, verify = run.window_work(gen, POOL, stored, MIX, config)
    section = len(POOL[0]["section"]) + len(POOL[1]["section"]) + len(POOL[3]["section"])
    assert recompress == {"codec": 3, "batches": 3, "section_bytes": section, "stored_bytes": 600}
    assert verify == {"batches": 2, "bytes": 150}
    ctx = SimpleNamespace(recompress=recompress, verify=verify, window_s=10.0, busy_s=1.0,
                          kernels={"void fused_kernel<Lz4, 16>(FusedArgs)": 1e-3, "crc32c_kernel<8>": 2e-6,
                                   "tick_fold_kernel": 5.0})
    least = (section + 600 + 12) / 3.35e12
    assert cell.reader("recompress_roofline_pct")(ctx) == pytest.approx(100 * least / 1e-3)
    assert cell.reader("fetch_verify_roofline_pct")(ctx) == pytest.approx(100 * (150 + 8) / 3.35e12 / 2e-6)
    assert cell.reader("device_idle_pct")(ctx) == pytest.approx(90.0)
    # producers that compress as the topic does: nothing recompressed
    assert run.window_work(gen, POOL, stored, {**MIX, "producer_codec": "lz4"}, config)[0]["batches"] == 0
    assert cell.reader("recompress_roofline_pct")(SimpleNamespace(**{**vars(ctx), "kernels": {}})) is None


def test_histogram_deltas_over_the_window():
    h0 = [{"redpanda_tpu_raft_commit_seconds": [({}, 1.0, 10)],
           "redpanda_tpu_kafka_request_stage_seconds": [({"api": "produce", "stage": "done", "path": "python"}, 2.0, 4)]}]
    h1 = [{"redpanda_tpu_raft_commit_seconds": [({}, 3.0, 20)],
           "redpanda_tpu_kafka_request_stage_seconds": [
               ({"api": "produce", "stage": "done", "path": "python"}, 5.0, 6),
               ({"api": "produce", "stage": "done", "path": "native"}, 1.0, 2),
               ({"api": "fetch", "stage": "done", "path": "python"}, 9.0, 9)]}]
    ctx = SimpleNamespace(hist=run.hist_delta(h0 * 2, h1 * 2))
    assert cell.reader("raft_commit_ms")(ctx) == pytest.approx(1e3 * 4.0 / 20)
    assert cell.reader("kafka_produce_ms")(ctx) == pytest.approx(1e3 * 8.0 / 8)
    assert cell.reader("kafka_fetch_ms")(ctx) == pytest.approx(1e3)
    assert cell.reader("flush_wait_ms")(ctx) is None


def test_busy_is_the_union_of_device_intervals():
    ops = [("a", 0.0, 1.0), ("b", 0.5, 1.5), ("c", 3.0, 4.0), ("d", 9.0, 12.0)]
    covered, gaps = trace.busy(ops, 0.0, 10.0)
    assert covered == pytest.approx(1.5 + 1.0 + 1.0)
    assert sorted(g[0] for g in gaps) == pytest.approx([1.5, 5.0])
    assert trace.by_name(ops)["d"] == pytest.approx(3.0)
