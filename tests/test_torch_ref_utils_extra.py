"""tests/test_utils_extra.py run on the port: all 11 cases, with imports
pointed at redpanda_tpu_torch. An autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu", as
in every mirror. Nothing is left out.

hdr_hist / retry_chain / in-tree hashes.

Reference models: src/v/utils/hdr_hist.h, utils/retry_chain_node.h,
src/v/hashing/tests/*.
"""

import asyncio
import random

import pytest

from redpanda_tpu_torch.utils.hash import (
    jump_consistent_hash,
    kafka_partition_for_key,
    murmur2,
    murmur3_32,
    xxh32,
    xxh64,
)
from redpanda_tpu_torch.utils.hdr_hist import HdrHist
from redpanda_tpu_torch.utils.retry_chain import RetryChainAborted, RetryChainNode
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


# ---------------------------------------------------------------- hashes
def test_xxh_differential_vs_system():
    import xxhash  # system binding = ground truth

    rng = random.Random(11)
    for _ in range(100):
        data = bytes(rng.getrandbits(8) for _ in range(rng.randrange(0, 400)))
        seed = rng.getrandbits(31)
        assert xxh64(data, seed) == xxhash.xxh64(data, seed=seed).intdigest()
        assert xxh32(data, seed) == xxhash.xxh32(data, seed=seed).intdigest()


def test_murmur2_kafka_vectors():
    # org.apache.kafka.common.utils.UtilsTest test vectors
    vectors = {
        b"21": -973932308,
        b"foobar": -790332482,
        b"a-little-bit-long-string": -985981536,
        b"a-little-bit-longer-string": -1486304829,
        b"lkjh234lh9fiuh90y23oiuhsafujhadof229phr9h19h89h8": -58897971,
    }
    for k, want in vectors.items():
        got = murmur2(k)
        signed = got - (1 << 32) if got >= (1 << 31) else got
        assert signed == want, k
    # partitioner is stable and in range
    for n in (1, 3, 16):
        p = kafka_partition_for_key(b"user-42", n)
        assert 0 <= p < n
        assert p == kafka_partition_for_key(b"user-42", n)


def test_murmur3_vectors():
    assert murmur3_32(b"") == 0
    assert murmur3_32(b"", 1) == 0x514E28B7
    assert murmur3_32(b"hello") == 0x248BFA47
    assert murmur3_32(b"Hello, world!", 1234) == 0xFAF6CDB3


def test_jump_consistent_hash():
    # minimal-movement property: growing the bucket count only ever
    # moves keys INTO the new bucket
    for k in range(2000):
        b = jump_consistent_hash(k, 10)
        b2 = jump_consistent_hash(k, 11)
        assert 0 <= b < 10
        assert b2 == b or b2 == 10
    # roughly uniform
    counts = [0] * 8
    for k in range(8000):
        counts[jump_consistent_hash(k * 2654435761, 8)] += 1
    assert min(counts) > 700
    with pytest.raises(ValueError):
        jump_consistent_hash(1, 0)


# -------------------------------------------------------------- hdr_hist
def test_hdr_hist_percentiles():
    h = HdrHist(lowest=1, highest=3_600_000_000, sig_figs=3)
    for v in range(1, 10001):
        h.record(v)
    # 3 sig figs -> percentile within 0.1% of exact
    for pct, exact in ((50, 5000), (90, 9000), (99, 9900), (99.9, 9990)):
        got = h.value_at_percentile(pct)
        assert abs(got - exact) <= max(1, exact * 2e-3), (pct, got)
    assert h.total == 10000
    assert h.min_value == 1 and h.max_value == 10000
    assert abs(h.mean() - 5000.5) < 5


def test_hdr_hist_wide_range_and_clamp():
    h = HdrHist(lowest=1, highest=60_000_000)
    h.record(0)  # clamps to lowest
    h.record(10**12)  # clamps to highest
    h.record(1500)
    s = h.snapshot()
    assert s["count"] == 3
    assert s["min"] == 1
    assert 60_000_000 * 0.999 <= s["max"] <= 60_000_000
    # relative error bound at a large value
    h2 = HdrHist(sig_figs=2)
    h2.record(123_456)
    got = h2.value_at_percentile(50)
    assert abs(got - 123_456) / 123_456 < 0.01


def test_hdr_hist_empty():
    h = HdrHist()
    assert h.value_at_percentile(99) == 0
    assert h.mean() == 0.0


# ----------------------------------------------------------- retry_chain
def test_retry_chain_deadline_bounds_children():
    async def run():
        root = RetryChainNode(deadline_s=0.15, base_backoff_s=0.02)
        child = root.child()
        n = 0
        while await child.backoff():
            n += 1
            assert n < 100
        assert n >= 1
        assert not child.may_retry()
        # a new child of an expired root is also out of budget
        assert not root.child().may_retry()

    asyncio.run(run())


def test_retry_chain_abort_propagates():
    async def run():
        root = RetryChainNode(base_backoff_s=0.05)
        child = root.child()
        grandchild = child.child(deadline_s=30.0)

        async def worker():
            while await grandchild.backoff():
                pass

        t = asyncio.ensure_future(worker())
        await asyncio.sleep(0.02)
        root.abort()
        with pytest.raises(RetryChainAborted):
            await t
        with pytest.raises(RetryChainAborted):
            child.check_abort()

    asyncio.run(run())


def test_retry_chain_child_tightens_deadline():
    async def run():
        root = RetryChainNode(deadline_s=100.0)
        child = root.child(deadline_s=0.05)
        assert child.remaining_s() <= 0.05
        await asyncio.sleep(0.06)
        assert not child.may_retry()
        assert root.may_retry()

    asyncio.run(run())


def test_retrying_store_abort():
    from redpanda_tpu_torch.cloud.object_store import (
        MemoryObjectStore,
        RetryingStore,
        StoreError,
    )

    class Flaky(MemoryObjectStore):
        async def get(self, key):
            raise StoreError("down")

    async def run():
        store = RetryingStore(Flaky(), attempts=1000, base_backoff_s=0.02)
        t = asyncio.ensure_future(store.get("k"))
        await asyncio.sleep(0.05)
        store.abort()
        # aborts surface as store unavailability — the error contract
        # existing callers (archiver, remote reads) already handle
        with pytest.raises(StoreError, match="aborted"):
            await asyncio.wait_for(t, timeout=1.0)

    asyncio.run(run())
