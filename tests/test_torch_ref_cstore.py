"""tests/test_cstore.py run on the port: all 3 cases, with imports
pointed at redpanda_tpu_torch. An autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu" (the
kernels' plain versions). Nothing is left out.

Columnar segment-meta store (VERDICT r4 #9).

Reference: src/v/cloud_storage/segment_meta_cstore.h + delta_for.h —
manifest segment metadata in delta-compressed columns. Requirements:
query surface unchanged, wire format unchanged, memory <= 10% of the
naive SegmentMeta-list form at 100k segments.
"""

import random
import tracemalloc

from redpanda_tpu_torch.cloud.cstore import CHUNK, SegmentMetaStore, SegmentView
from redpanda_tpu_torch.cloud.manifest import PartitionManifest, SegmentMeta
import pytest

from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


def mk(i, off, n, hint=""):
    return SegmentMeta(
        base_offset=off,
        last_offset=off + n - 1,
        term=i // 1000,
        size_bytes=(1 << 20) + i,
        base_timestamp=1690000000000 + i * 1000,
        max_timestamp=1690000000000 + i * 1000 + 999,
        delta_offset=i * 2,
        delta_offset_end=i * 2 + 1,
        name_hint=hint,
    )


def build(n, hint_every=500):
    metas, off = [], 0
    for i in range(n):
        ln = 1000 + (i % 700)
        metas.append(
            mk(i, off, ln, hint=f"m-{i}.seg" if i % hint_every == 0 else "")
        )
        off += ln
    return metas, off


def test_sequence_equivalence_fuzz():
    """The store must behave exactly like the list it replaces under a
    random op mix (append/index/slice/replace/delete/iterate)."""
    rng = random.Random(42)
    metas, _ = build(CHUNK * 2 + 137)  # chunks AND a live tail
    store = SegmentMetaStore(metas)
    ref = list(metas)
    for _round in range(60):
        op = rng.choice(("index", "slice", "iter_tail", "find", "eq"))
        if op == "index":
            i = rng.randrange(-len(ref), len(ref))
            assert store[i] == ref[i]
        elif op == "slice":
            a = rng.randrange(0, len(ref))
            b = rng.randrange(a, min(a + 40, len(ref)))
            assert [v.to_meta() for v in store[a:b]] == ref[a:b]
        elif op == "iter_tail":
            got = list(store)[-5:]
            assert [v.base_offset for v in got] == [
                m.base_offset for m in ref[-5:]
            ]
        elif op == "find":
            q = rng.randrange(0, int(ref[-1].last_offset) + 50)
            got = store.find_containing(q)
            want = next(
                (
                    m
                    for m in ref
                    if int(m.base_offset) <= q <= int(m.last_offset)
                ),
                None,
            )
            if want is None:
                assert got is None, q
            else:
                assert got is not None and got == want, q
        elif op == "eq":
            i = rng.randrange(0, len(ref))
            assert store.index(ref[i]) == i

    # structural mutations mirror list semantics
    merged = mk(
        0,
        int(ref[10].base_offset),
        int(ref[12].last_offset) - int(ref[10].base_offset) + 1,
        hint="merged.seg",
    )
    store[10:13] = [merged]
    ref[10:13] = [merged]
    assert len(store) == len(ref) and store[10] == merged
    del store[0]
    del ref[0]
    assert store[0] == ref[0]
    store.append(mk(9999, int(ref[-1].last_offset) + 1, 100))
    ref.append(store[-1].to_meta())
    assert store[-1] == ref[-1]
    # name hints survive mutations
    hints = [
        (i, v.name_hint) for i, v in enumerate(store) if v.name_hint
    ]
    ref_hints = [
        (i, m.name_hint) for i, m in enumerate(ref) if m.name_hint
    ]
    assert hints == ref_hints


def test_wire_format_unchanged():
    """Manifest blobs must be byte-identical whether segments is a
    plain list or the columnar store (decode -> re-encode roundtrip)."""
    metas, _ = build(300, hint_every=37)
    m1 = PartitionManifest(
        ns="kafka", topic="t", partition=3, revision=7, segments=metas
    )
    blob = m1.encode()
    m2 = PartitionManifest.decode(blob)
    assert isinstance(m2.segments, SegmentMetaStore)
    assert m2.encode() == blob
    # queries unchanged across the representation
    probe = int(metas[123].base_offset) + 5
    assert m2.find(probe) == m1.find(probe)
    assert m2.archived_upto == m1.archived_upto
    assert m2.start_offset == m1.start_offset


def test_memory_at_100k_under_10pct():
    def build_naive():
        out, off = [], 0
        for i in range(100_000):
            ln = 1000 + (i % 700)
            out.append(mk(i, off, ln))
            off += ln
        return out

    tracemalloc.start()
    s0 = tracemalloc.take_snapshot()
    naive = build_naive()
    s1 = tracemalloc.take_snapshot()
    naive_bytes = sum(x.size_diff for x in s1.compare_to(s0, "filename"))
    del naive
    s2 = tracemalloc.take_snapshot()
    store = SegmentMetaStore()
    off = 0
    for i in range(100_000):
        ln = 1000 + (i % 700)
        store.append(mk(i, off, ln))
        off += ln
    s3 = tracemalloc.take_snapshot()
    store_bytes = sum(x.size_diff for x in s3.compare_to(s2, "filename"))
    tracemalloc.stop()
    ratio = store_bytes / naive_bytes
    assert ratio <= 0.10, (
        f"store {store_bytes/1e6:.1f} MB vs naive {naive_bytes/1e6:.1f} MB "
        f"= {ratio:.1%} (bar: <=10%)"
    )
    # and the query stays correct at scale
    probe = store[67_890]
    assert store.find_containing(int(probe.base_offset) + 1) == probe
