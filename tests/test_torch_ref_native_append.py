"""tests/test_native_append.py run on the port: all 8 cases, with imports
pointed at redpanda_tpu_torch. Every GroupManager is the port's on the
CPU (`device="cpu"`); the C++ append is the same `native/` library,
loaded through the port's `utils/native.py`. An autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
Nothing is left out.

Differential fuzz for the native hot-loop fast paths.

Two identical follower stacks consume the SAME randomized
AppendEntries stream — one with the C framing fast path enabled
(native/append_frame.cc), one forced down the pure-Python handler —
and every reply must be byte-identical, every intermediate scalar
state equal, and the on-disk segment files byte-for-byte the same at
the end. The stream mixes happy steady-state appends with every punt
condition: corrupt batch CRCs, truncated frames, stale terms, gaps,
prev-term mismatches, duplicate delivery, term bumps (segment rolls),
configuration batches and empty heartbeat-like frames.

Also covers: the Kafka produce frontend decode parity
(native/produce_frame.cc vs the Python decoders), a NemesisNet
corrupt-payload cluster run with native enabled, and the
RP_NATIVE=0 / no-compiler clean fallback.
"""

import asyncio
import contextlib
import os
import random
import struct
import sys

import pytest
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")

sys.path.insert(0, os.path.dirname(__file__))

from redpanda_tpu_torch.models.record import (
    RecordBatch,
    RecordBatchBuilder,
    RecordBatchType,
)
from redpanda_tpu_torch.raft import GroupManager
from redpanda_tpu_torch.raft import types as rt
from redpanda_tpu_torch.raft.configuration import GroupConfiguration
from redpanda_tpu_torch.utils import native as native_mod

GROUP = 1
LEADER_ID = 1
FOLLOWER_ID = 2

needs_native = pytest.mark.skipif(
    native_mod.load() is None, reason="native toolchain unavailable"
)


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


@contextlib.contextmanager
def native_append(enabled: bool):
    """Flip the per-call RP_NATIVE_APPEND escape hatch."""
    old = os.environ.get("RP_NATIVE_APPEND")
    os.environ["RP_NATIVE_APPEND"] = "1" if enabled else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("RP_NATIVE_APPEND", None)
        else:
            os.environ["RP_NATIVE_APPEND"] = old


class FollowerStack:
    """One GroupManager pinned to the follower role (election timer
    far beyond the test horizon) whose raft service we feed raw
    AppendEntries frames, as the RPC layer would."""

    def __init__(self, tmp, name: str):
        self.gm = GroupManager(
            node_id=FOLLOWER_ID,
            data_dir=str(tmp / name),
            send=self._never_send,
            election_timeout_s=3600.0,
            heartbeat_interval_s=3600.0,
            device="cpu",
        )

    async def _never_send(self, dst, method_id, payload, timeout):
        raise AssertionError("follower under test must not send RPCs")

    async def start(self):
        await self.gm.start()
        await self.gm.create_group(GROUP, [1, 2, 3])

    async def stop(self):
        await self.gm.stop()

    @property
    def consensus(self):
        return self.gm.get(GROUP)

    async def apply(self, frame: bytes, native: bool):
        """(reply_bytes | None, repr(exception) | None)."""
        with native_append(native):
            try:
                return await self.gm.service.append_entries(frame), None
            except Exception as e:
                return None, f"{type(e).__name__}: {e}"

    def scalar_state(self):
        c = self.consensus
        return (
            c.term,
            c.dirty_offset(),
            c.flushed_offset(),
            c.commit_index,
            c.leader_id,
        )

    def log_bytes(self):
        """{segment filename: bytes} for the group's log dir."""
        logdir = self.consensus.log.directory
        out = {}
        for name in sorted(os.listdir(logdir)):
            if name.endswith(".log"):
                with open(os.path.join(logdir, name), "rb") as f:
                    out[name] = f.read()
        return out


class LeaderModel:
    """Shadow leader: owns the canonical log the frames describe."""

    def __init__(self, seed: int):
        self.rng = random.Random(seed)
        self.term = 1
        self.dirty = -1
        self.last_term = -1
        self.commit = -1
        self.seq = 0
        self.entry_terms: dict[int, int] = {}  # offset -> term

    def _stamp(self, batch, base: int) -> bytes:
        batch.header.base_offset = base
        batch.header.term = self.term
        batch.header.size_bytes = batch.size_bytes()
        batch.header.header_crc = batch.header.compute_header_crc()
        return batch.serialize()

    def data_batch(self, base: int, nrecs: int) -> bytes:
        b = RecordBatchBuilder(
            batch_type=RecordBatchType.raft_data,
            timestamp_ms=1_700_000_000_000 + base,
        )
        for i in range(nrecs):
            b.add(value=b"v-%d-%d" % (base, i), key=b"k%d" % i)
        return self._stamp(b.build(), base)

    def config_batch(self, base: int) -> bytes:
        cfg = GroupConfiguration(
            voters=[1, 2, 3], learners=[], old_voters=[], revision=base
        )
        b = RecordBatchBuilder(
            batch_type=RecordBatchType.raft_configuration,
            timestamp_ms=1_700_000_000_000 + base,
        )
        b.add(value=cfg.encode())
        return self._stamp(b.build(), base)

    def frame(
        self,
        batches,
        prev_idx=None,
        prev_term=None,
        term=None,
        commit=None,
        flush=True,
    ) -> bytes:
        self.seq += 1
        return rt.AppendEntriesRequest(
            group=GROUP,
            node_id=LEADER_ID,
            target_node_id=FOLLOWER_ID,
            term=self.term if term is None else term,
            prev_log_index=self.dirty if prev_idx is None else prev_idx,
            prev_log_term=self.last_term if prev_term is None else prev_term,
            commit_index=self.commit if commit is None else commit,
            seq=self.seq,
            flush=flush,
            batches=batches,
        ).encode()

    def advance(self, n_batches: int, config: bool = False) -> bytes:
        """A happy-path frame extending the canonical log."""
        batches = []
        prev_idx, prev_term = self.dirty, self.last_term
        for _ in range(n_batches):
            base = self.dirty + 1
            if config:
                raw = self.config_batch(base)
                nrec = 1
            else:
                nrec = self.rng.randint(1, 4)
                raw = self.data_batch(base, nrec)
            batches.append(raw)
            for off in range(base, base + nrec):
                self.entry_terms[off] = self.term
            self.dirty = base + nrec - 1
            self.last_term = self.term
        if self.rng.random() < 0.7:
            self.commit = self.rng.randint(self.commit, self.dirty)
        return self.frame(
            batches, prev_idx=prev_idx, prev_term=prev_term
        )


FUZZ_STEPS = int(os.environ.get("RP_FUZZ_STEPS", "10000"))


@needs_native
def test_differential_fuzz_native_vs_python(tmp_path):
    """Byte parity: replies, scalar raft state, and on-disk segments
    must be identical between the native and Python append paths over
    a randomized stream covering every punt condition."""

    async def main():
        a = FollowerStack(tmp_path, "native")
        b = FollowerStack(tmp_path, "python")
        await a.start()
        await b.start()
        leader = LeaderModel(seed=20260805)
        rng = leader.rng
        last_frame = None
        native_hits = 0
        orig = type(a.consensus).native_append_frame

        def counting(self, payload):
            nonlocal native_hits
            out = orig(self, payload)
            if out is not None:
                native_hits += 1
            return out

        type(a.consensus).native_append_frame = counting
        try:
            for step in range(FUZZ_STEPS):
                roll = rng.random()
                if roll < 0.55 or last_frame is None:
                    frame = leader.advance(rng.randint(1, 3))
                elif roll < 0.61:
                    frame = last_frame  # duplicate delivery
                elif roll < 0.66:
                    frame = leader.frame([], term=leader.term - 1)  # stale
                elif roll < 0.71:  # gap
                    frame = leader.frame(
                        [leader.data_batch(leader.dirty + 5, 1)],
                        prev_idx=leader.dirty + 4,
                        prev_term=leader.last_term,
                    )
                elif roll < 0.76:  # prev-term mismatch
                    frame = leader.frame(
                        [], prev_term=leader.last_term + 7
                    )
                elif roll < 0.81:  # corrupt: flip one byte
                    base = leader.advance(rng.randint(1, 2))
                    buf = bytearray(base)
                    buf[rng.randrange(6, len(buf))] ^= 1 << rng.randrange(8)
                    frame = bytes(buf)
                    # the canonical log advanced; resync both stacks
                    # with the clean frame AFTER the corrupt one
                    last_frame = base
                elif roll < 0.85:  # truncated prefix
                    full = leader.frame([], flush=False)
                    frame = full[: rng.randrange(0, len(full))]
                elif roll < 0.90:  # config batch
                    frame = leader.advance(1, config=True)
                elif roll < 0.95:  # empty heartbeat-like append
                    frame = leader.frame([], flush=rng.random() < 0.5)
                else:  # term bump: next frames roll a new segment
                    leader.term += 1
                    frame = leader.advance(1)

                ra = await a.apply(frame, native=True)
                rb = await b.apply(frame, native=False)
                assert ra == rb, f"step {step}: {ra!r} != {rb!r}"
                if roll >= 0.76 and roll < 0.81:
                    # deliver the clean continuation frame too so both
                    # stacks rejoin the canonical log
                    ra = await a.apply(last_frame, native=True)
                    rb = await b.apply(last_frame, native=False)
                    assert ra == rb, f"step {step} resync: {ra!r} != {rb!r}"
                    # a flip Python appends unverified (it trusts wire
                    # CRCs on the raft path) can silently move the
                    # follower's dirty offset or term away from the
                    # model's bookkeeping; adopt the observed state so
                    # the stream keeps making progress
                    c = b.consensus
                    leader.term = max(leader.term, c.term)
                    leader.dirty = c.dirty_offset()
                    lt = (
                        c.term_at(leader.dirty)
                        if leader.dirty >= 0
                        else -1
                    )
                    leader.last_term = -1 if lt is None else lt
                    leader.commit = min(leader.commit, leader.dirty)
                if step % 100 == 0:
                    assert a.scalar_state() == b.scalar_state(), (
                        f"step {step}"
                    )
                last_frame = frame
            assert a.scalar_state() == b.scalar_state()
            assert a.consensus.dirty_offset() > 100  # stream really ran
            assert native_hits > FUZZ_STEPS // 10, (
                f"native path engaged only {native_hits}x"
            )
            la, lb = a.log_bytes(), b.log_bytes()
            assert la.keys() == lb.keys()
            for name in la:
                assert la[name] == lb[name], f"segment {name} diverged"
        finally:
            type(a.consensus).native_append_frame = orig
            await a.stop()
            await b.stop()

    run(main())


@needs_native
def test_native_reply_bytes_match_serde_encoding(tmp_path):
    """The C-built reply must be byte-identical to
    rt.AppendEntriesReply(...).encode() for the same fields."""

    async def main():
        a = FollowerStack(tmp_path, "native")
        b = FollowerStack(tmp_path, "python")
        await a.start()
        await b.start()
        leader = LeaderModel(seed=7)
        for _ in range(5):
            frame = leader.advance(2)
            ra, ea = await a.apply(frame, native=True)
            rb, eb = await b.apply(frame, native=False)
            assert ea is None and eb is None
            assert ra == rb
            rep = rt.AppendEntriesReply.decode(ra)
            assert rep.encode() == ra  # canonical serde round trip
            assert rep.status == rt.AppendEntriesReply.SUCCESS
            assert rep.last_dirty_log_index == leader.dirty
            assert rep.last_flushed_log_index == leader.dirty
        await a.stop()
        await b.stop()

    run(main())


def test_rp_native_0_clean_fallback(tmp_path):
    """RP_NATIVE=0 (the no-compiler stand-in: load() returns None and
    every wrapper degrades) must leave the whole append path working
    on pure Python."""
    old = os.environ.get("RP_NATIVE")
    os.environ["RP_NATIVE"] = "0"
    try:
        assert native_mod.load() is None
        assert native_mod.append_frame_ready() is False
        assert native_mod.produce_frame_ready() is False
        assert native_mod.crc32c(b"x") is None
        assert native_mod.append_frame(b"", None, None, None) == -1

        async def main():
            a = FollowerStack(tmp_path, "nolib")
            await a.start()
            leader = LeaderModel(seed=3)
            for _ in range(10):
                reply, err = await a.apply(leader.advance(1), native=True)
                assert err is None
                rep = rt.AppendEntriesReply.decode(reply)
                assert rep.status == rt.AppendEntriesReply.SUCCESS
            assert a.consensus.dirty_offset() == leader.dirty
            await a.stop()

        run(main())
    finally:
        if old is None:
            os.environ.pop("RP_NATIVE", None)
        else:
            os.environ["RP_NATIVE"] = old


@needs_native
def test_nemesis_corrupt_payload_with_native_enabled(tmp_path):
    """NemesisNet corrupting/dropping append-entries frames on the
    wire must not change semantics when the native path is live: the
    RPC frame CRC rejects corrupt deliveries before dispatch, retries
    recover, and the replicated data reads back intact."""
    from redpanda_tpu_torch.rpc import NemesisSchedule, NetRule
    from test_torch_ref_raft import RaftCluster, data_batch

    async def main():
        cluster = RaftCluster(tmp_path, n_nodes=3)
        await cluster.start()
        await cluster.create_group()
        leader = await cluster.wait_leader()
        sched = NemesisSchedule(
            rules=[
                NetRule(
                    method=rt.APPEND_ENTRIES, action="corrupt", prob=0.15
                ),
                NetRule(method=rt.APPEND_ENTRIES, action="drop", prob=0.05),
            ],
            seed=20260805,
        )
        cluster.net.install_nemesis(sched)
        last = None
        for i in range(30):
            base, last = await leader.replicate(
                data_batch(b"nemesis-%d" % i, 3), acks=-1
            )
        cluster.net.clear_nemesis()
        await asyncio.sleep(0.5)
        assert sched.injected.get("corrupt", 0) > 0  # faults really fired
        for nid in cluster.nodes:
            c = cluster.consensus(nid)
            assert c.commit_index >= last
            for batch in c.log.read(0, upto=last):
                assert batch.header.header_crc == (
                    batch.header.compute_header_crc()
                )
                assert batch.compute_crc() == batch.header.crc
        await cluster.stop()

    run(main())


# ---------------------------------------------- produce frontend parity


def _produce_frame(version, flexible, topic, index, wire, client_id="cid"):
    from redpanda_tpu_torch.kafka.protocol import produce_fast
    from redpanda_tpu_torch.kafka.protocol.headers import (
        RequestHeader,
        encode_request_header,
    )

    body = produce_fast.encode_request_single(
        version, flexible, None, -1, 30000, topic, index, wire
    )
    hdr = RequestHeader(0, version, 99, client_id)
    return encode_request_header(hdr) + body, hdr


@needs_native
@pytest.mark.parametrize("version,flexible", [(3, False), (7, False), (9, True)])
def test_produce_decode_native_parity(version, flexible):
    from redpanda_tpu_torch.kafka.protocol import produce_fast
    from redpanda_tpu_torch.kafka.protocol.headers import decode_request_header
    from redpanda_tpu_torch.kafka.protocol.wire import Reader

    rng = random.Random(version)
    for trial in range(50):
        b = RecordBatchBuilder(timestamp_ms=1_700_000_000_000)
        for i in range(rng.randint(1, 8)):
            b.add(value=os.urandom(rng.randint(0, 64)), key=b"k%d" % i)
        wire = b.build().to_kafka_wire()
        topic = "topic-%d" % rng.randint(0, 99)
        frame, hdr = _produce_frame(
            version, flexible, topic, rng.randint(0, 1 << 20), wire
        )
        nat = produce_fast.decode_request_native(frame)
        assert nat is not None
        nhdr, nreq = nat
        assert nhdr == hdr
        r = Reader(frame)
        assert decode_request_header(r) == hdr
        preq = produce_fast.decode_request(
            frame[len(frame) - r.remaining :], version, flexible
        )
        assert nreq.acks == preq.acks
        assert nreq.timeout_ms == preq.timeout_ms
        assert nreq.transactional_id is None
        assert nreq.topics[0].name == preq.topics[0].name
        pn = nreq.topics[0].partitions[0]
        pp = preq.topics[0].partitions[0]
        assert pn.index == pp.index
        assert bytes(pn.records) == bytes(pp.records)
        assert pn.get("_crc_ok") is True
        # the batch the dispatch loop would build decodes identically
        # with verification skipped (native already checked the crc)
        ba = RecordBatch.from_kafka_wire(bytes(pn.records), verify=False)
        bb = RecordBatch.from_kafka_wire(bytes(pp.records), verify=True)
        assert ba.header == bb.header
        assert bytes(ba.body) == bytes(bb.body)


@needs_native
def test_produce_decode_native_punts():
    """Every cold-path shape must punt (None) so the Python decoders
    own the semantics; a corrupt batch CRC must punt too (the error
    has to surface in dispatch order, not at decode)."""
    from redpanda_tpu_torch.kafka.protocol import produce_fast

    b = RecordBatchBuilder(timestamp_ms=1_700_000_000_000)
    b.add(value=b"v", key=b"k")
    wire = b.build().to_kafka_wire()
    frame, _ = _produce_frame(7, False, "t", 0, wire)
    assert produce_fast.decode_request_native(frame) is not None

    corrupt = bytearray(frame)
    corrupt[-3] ^= 0xFF
    assert produce_fast.decode_request_native(bytes(corrupt)) is None

    for trunc in (0, 5, len(frame) // 2, len(frame) - 1):
        assert produce_fast.decode_request_native(frame[:trunc]) is None

    # non-produce api key
    other = bytearray(frame)
    other[1] = 1
    assert produce_fast.decode_request_native(bytes(other)) is None

    # version outside the fast range
    from redpanda_tpu_torch.kafka.protocol.headers import (
        RequestHeader,
        encode_request_header,
    )
    from redpanda_tpu_torch.kafka.protocol import produce_fast as pf

    body = pf.encode_request_single(3, False, None, -1, 1000, "t", 0, wire)
    old = encode_request_header(RequestHeader(0, 2, 1, "c")) + body
    assert pf.decode_request_native(old) is None

    # transactional id takes the cold path
    body_t = pf.encode_request_single(7, False, "txn", -1, 1000, "t", 0, wire)
    framed = encode_request_header(RequestHeader(0, 7, 1, "c")) + body_t
    assert pf.decode_request_native(framed) is None
