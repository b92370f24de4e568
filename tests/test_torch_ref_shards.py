"""tests/test_shards.py run on the port: all 16 test functions, with
imports pointed at redpanda_tpu_torch. Every broker is the port's on the
CPU (`BrokerConfig(device="cpu")`), and an autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu". The
raft parity legs' `GroupManager`s take `device="cpu"`; `_echo_child`,
`_retry` and `run` are imported from here by
`test_torch_ref_procnemesis`. The port forks its workers through the
shard runtime's fork server. Nothing is left out.


Shard-per-core runtime tests (ssx/shards.py + the sharded broker).

Covers the invoke_on seam (round-trip, concurrency, error paths),
group→shard assignment stability, crash supervision (detection,
restart policy, clean broker shutdown with a dead peer), the
SO_REUSEPORT listener spread, and a TCP-vs-loopback raft parity leg:
the same quorum-replicate scenario run over real `TcpTransport`
sockets must commit the same records as the loopback run the rest of
the suite is built on.
"""

import asyncio
import os
import signal
import socket

import pytest

from redpanda_tpu_torch.models.record import (
    RecordBatchBuilder,
    RecordBatchType,
)
from redpanda_tpu_torch.raft import GroupManager, Role
from redpanda_tpu_torch.rpc import LoopbackNetwork, LoopbackTransport
from redpanda_tpu_torch.rpc.server import RpcServer
from redpanda_tpu_torch.rpc.transport import TcpTransport
from redpanda_tpu_torch.placement.table import compute_shard
from redpanda_tpu_torch.ssx import (
    InvokeError,
    ShardRuntime,
    bind_reuse_port,
    reserve_reuse_port,
)
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


async def _retry(coro_fn, timeout=15.0):
    """Poll an op until the broker is ready for it (self-registration in
    the members table and raft elections race client calls on startup —
    same shape as the standalone-cluster tests' retry loops)."""
    deadline = asyncio.get_event_loop().time() + timeout
    while True:
        try:
            return await coro_fn()
        except Exception:
            if asyncio.get_event_loop().time() > deadline:
                raise
            await asyncio.sleep(0.2)


# ------------------------------------------------- assignment stability
def test_shard_of_is_stable_and_in_range():
    for n in (2, 3, 4, 8):
        seen = set()
        for g in range(1, 500):
            s = compute_shard(g, n)
            assert 0 <= s < n
            assert s == compute_shard(g, n)  # pure: same inputs, same shard
            seen.add(s)
        # every shard gets work under a dense group-id space
        assert seen == set(range(n))


def test_shard_of_degenerate_inputs_pin_to_shard0():
    # no shards / single shard / controller-style non-positive groups
    assert compute_shard(7, 1) == 0
    assert compute_shard(7, 0) == 0
    assert compute_shard(0, 4) == 0
    assert compute_shard(-3, 4) == 0


def test_shard_of_legacy_name_is_gone():
    """The v1 `shard_of` deprecation shim was retired (PR 17): the
    name no longer resolves anywhere in ssx; placement.table is the
    single authority (rplint RPL017 holds the line)."""
    import pytest

    from redpanda_tpu_torch import ssx
    from redpanda_tpu_torch.ssx import shards as ssx_shards

    for mod in (ssx, ssx_shards):
        with pytest.raises(AttributeError):
            mod.shard_of


# ------------------------------------------------- invoke_on round-trip
async def _echo_child(ctx):
    async def echo(method, payload):
        if method == "twice":
            return payload * 2
        if method == "whoami":
            return b"%d" % ctx.shard_id
        if method == "boom":
            raise ValueError("boom")
        if method == "peer":
            # cross-worker hop: no direct channel to a SPAWNED shard,
            # so this exercises the relay-via-shard-0 fabric leg
            return await ctx.invoke_on(int(payload), "echo", "whoami")
        return payload

    ctx.register("echo", echo)
    return None


def test_invoke_on_roundtrip_and_errors():
    async def main():
        rt = ShardRuntime(3, _echo_child)
        await rt.start()
        try:
            assert await rt.invoke_on(1, "echo", "id", b"hello") == b"hello"
            assert await rt.invoke_on(2, "echo", "twice", b"ab") == b"abab"
            # shard identity survives the hop (we really forked)
            assert await rt.invoke_on(1, "echo", "whoami") == b"1"
            assert await rt.invoke_on(2, "echo", "whoami") == b"2"
            # remote exception surfaces as InvokeError, channel survives
            with pytest.raises(InvokeError):
                await rt.invoke_on(1, "echo", "boom")
            with pytest.raises(InvokeError):
                await rt.invoke_on(1, "no.such.service", "m")
            assert await rt.invoke_on(1, "echo", "id", b"still-up") == b"still-up"
        finally:
            await rt.stop()

    run(main())


def test_invoke_on_concurrent_calls_multiplex_one_channel():
    async def main():
        rt = ShardRuntime(3, _echo_child)
        await rt.start()
        try:
            outs = await asyncio.gather(
                *(
                    rt.invoke_on(1 + (i % 2), "echo", "id", b"%d" % i)
                    for i in range(200)
                )
            )
            assert outs == [b"%d" % i for i in range(200)]
        finally:
            await rt.stop()

    run(main())


# ------------------------------------------------- crash supervision
def test_shard_crash_is_detected_and_stop_is_clean():
    async def main():
        rt = ShardRuntime(2, _echo_child)
        crashes = []
        rt.on_crash = lambda sid, st: crashes.append((sid, st))
        await rt.start()
        os.kill(rt.shard_pids[1], signal.SIGKILL)
        await asyncio.wait_for(rt.failed.wait(), 5.0)
        assert crashes and crashes[0][0] == 1
        assert 1 in rt.crashed
        # invoking a dead shard fails fast instead of hanging
        with pytest.raises(InvokeError):
            await rt.invoke_on(1, "echo", "id", b"x", timeout=2.0)
        await rt.stop()  # must not raise with a dead peer

    run(main())


def test_shard_crash_restart_policy_refills_the_group():
    async def main():
        rt = ShardRuntime(2, _echo_child, restart_limit=1)
        restarted = asyncio.Event()
        rt.on_restart = lambda _rt: restarted.set()
        await rt.start()
        first_pid = rt.shard_pids[1]
        os.kill(first_pid, signal.SIGKILL)
        await asyncio.wait_for(restarted.wait(), 10.0)
        assert not rt.failed.is_set()
        assert rt.shard_pids[1] != first_pid
        assert await rt.invoke_on(1, "echo", "whoami", timeout=5.0) == b"1"
        await rt.stop()

    run(main())


# ------------------------------------------------- elastic lifecycle
def test_spawn_shard_meshes_in_and_relays_peer_invokes():
    async def main():
        rt = ShardRuntime(2, _echo_child)
        await rt.start()
        try:
            sid = await rt.spawn_shard()
            assert sid == 2
            assert rt.n_shards == 3
            # parent reaches the spawned shard directly
            assert await rt.invoke_on(sid, "echo", "whoami") == b"2"
            # worker 1 has NO pre-fork channel to shard 2: the hop
            # relays through shard 0 transparently
            assert await rt.invoke_on(1, "echo", "peer", b"2") == b"2"
            # and the spawned shard can answer back toward worker 1
            assert await rt.invoke_on(sid, "echo", "peer", b"1") == b"1"
            # retire: polite ladder, pid reaped, no orphan
            pid = rt.shard_pids[sid]
            await rt.retire_shard(sid)
            assert sid not in rt.shard_pids
            assert sid in rt.retired
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)
            # the original worker is untouched
            assert await rt.invoke_on(1, "echo", "whoami") == b"1"
        finally:
            await rt.stop()

    run(main())


def test_on_crash_hook_exception_keeps_supervising():
    """Satellite: a throwing sync on_crash hook must not kill the reap
    loop — later crashes are still detected."""

    async def main():
        rt = ShardRuntime(3, _echo_child)  # restart_limit=0: no budget
        seen = []

        def bad_hook(sid, st):
            seen.append(sid)
            raise RuntimeError("hook bug")

        rt.on_crash = bad_hook
        await rt.start()
        try:
            os.kill(rt.shard_pids[1], signal.SIGKILL)
            await asyncio.wait_for(rt.failed.wait(), 5.0)
            assert seen == [1]
            # the reap loop survived the throwing hook: a second crash
            # is still detected and the hook fires again
            os.kill(rt.shard_pids[2], signal.SIGKILL)
            deadline = asyncio.get_event_loop().time() + 5.0
            while 2 not in rt.crashed:
                if asyncio.get_event_loop().time() > deadline:
                    raise TimeoutError("second crash never detected")
                await asyncio.sleep(0.05)
            assert seen == [1, 2]
        finally:
            await rt.stop()

    run(main())


def test_gray_failure_detected_via_heartbeat_deadline():
    """A SIGSTOP'd shard is alive by waitpid but unresponsive: only
    the heartbeat deadline can see it. The supervisor escalates to
    SIGKILL and restarts in place."""

    async def main():
        rt = ShardRuntime(
            2,
            _echo_child,
            restart_limit=2,
            heartbeat_interval=0.1,
            heartbeat_deadline=0.8,
        )
        await rt.start()
        try:
            pid = rt.shard_pids[1]
            os.kill(pid, signal.SIGSTOP)
            deadline = asyncio.get_event_loop().time() + 15.0
            while rt.gray_failures.get(1, 0) == 0 or 1 not in rt.shard_pids \
                    or rt.shard_pids.get(1) == pid:
                if asyncio.get_event_loop().time() > deadline:
                    raise TimeoutError(
                        f"gray failure never handled: {rt.gray_failures}"
                    )
                await asyncio.sleep(0.1)
            assert rt.gray_failures[1] >= 1
            assert rt.shard_restarts.get(1, 0) >= 1
            assert await rt.invoke_on(1, "echo", "whoami", timeout=5.0) == b"1"
        finally:
            await rt.stop()

    run(main())


def test_sharded_broker_restarts_crashed_shard_in_place(tmp_path):
    """Per-shard in-place restart is the DEFAULT crash response now:
    kill the worker, the supervisor re-forks only that shard, the new
    child re-adopts its groups from disk, and every record acked
    before the crash is still fetchable after it. The broker never
    flags failure."""
    from redpanda_tpu_torch.app import BrokerConfig
    from redpanda_tpu_torch.kafka.client import KafkaClient
    from redpanda_tpu_torch.ssx.sharded_broker import ShardedBroker

    async def main():
        cfg = BrokerConfig(
            device="cpu",
            node_id=0,
            data_dir=str(tmp_path / "n0"),
            members=[0],
            election_timeout_s=0.3,
            heartbeat_interval_s=0.05,
            enable_admin=False,
        )
        sb = ShardedBroker(cfg, n_shards=2)
        await sb.start()
        assert sb.active, f"unexpected stand-down: {sb.standdown}"
        c = KafkaClient([("127.0.0.1", sb.kafka_port)])
        try:
            await _retry(
                lambda: c.create_topic("t", partitions=4, replication_factor=1)
            )
            # partitions spread across shards per the controller policy
            # (the backend applies topic deltas asynchronously)
            deadline = asyncio.get_event_loop().time() + 10.0
            while not sb.broker.shard_table.counts().get(1, 0):
                if asyncio.get_event_loop().time() > deadline:
                    raise TimeoutError(
                        f"no partitions routed to shard 1: "
                        f"{sb.broker.shard_table.counts()}"
                    )
                await asyncio.sleep(0.1)
            acked = {}
            for p in range(4):
                acked[p] = await _retry(
                    lambda p=p: c.produce("t", p, [(b"k", b"v%d" % p)])
                )
            stats = await sb.shard_stats()
            assert stats and stats[0].partitions > 0
            assert stats[0].produce_reqs > 0
            # kill the worker shard: in-place restart, NOT broker death
            first_pid = sb.runtime.shard_pids[1]
            os.kill(first_pid, signal.SIGKILL)
            deadline = asyncio.get_event_loop().time() + 15.0
            while (
                sb.runtime.shard_restarts.get(1, 0) == 0
                or not sb.broker.shard_table.is_available(1)
            ):
                if asyncio.get_event_loop().time() > deadline:
                    raise TimeoutError("shard 1 never restarted in place")
                await asyncio.sleep(0.1)
            assert not sb.failed.is_set()
            assert sb.runtime.shard_pids[1] != first_pid
            # zero lost acked records: everything acked pre-crash is
            # fetchable from the re-adopted on-disk state
            for p, off in acked.items():
                rows = await _retry(lambda p=p, off=off: c.fetch("t", p, off))
                assert rows, f"acked record on partition {p} lost"
            # and the reborn shard serves NEW produce
            for p in range(4):
                await _retry(
                    lambda p=p: c.produce("t", p, [(b"k", b"post%d" % p)])
                )
        finally:
            await c.close()
        await sb.stop()

    run(main())


def test_sharded_broker_flags_failure_when_restart_budget_exhausted(
    tmp_path, monkeypatch
):
    """RP_SHARD_RESTARTS=0: the old contract — a dead shard with no
    restart budget flags broker failure, and teardown stays clean."""
    from redpanda_tpu_torch.app import BrokerConfig
    from redpanda_tpu_torch.ssx.sharded_broker import ShardedBroker

    monkeypatch.setenv("RP_SHARD_RESTARTS", "0")

    async def main():
        cfg = BrokerConfig(
            device="cpu",
            node_id=0,
            data_dir=str(tmp_path / "n0"),
            members=[0],
            election_timeout_s=0.3,
            heartbeat_interval_s=0.05,
            enable_admin=False,
        )
        sb = ShardedBroker(cfg, n_shards=2)
        await sb.start()
        assert sb.active, f"unexpected stand-down: {sb.standdown}"
        os.kill(sb.runtime.shard_pids[1], signal.SIGKILL)
        await asyncio.wait_for(sb.failed.wait(), 10.0)
        await sb.stop()

    run(main())


def test_sharded_broker_stands_down_when_disabled(tmp_path, monkeypatch):
    from redpanda_tpu_torch.app import BrokerConfig
    from redpanda_tpu_torch.kafka.client import KafkaClient
    from redpanda_tpu_torch.ssx.sharded_broker import ShardedBroker

    monkeypatch.setenv("RP_SHARDS", "0")

    async def main():
        cfg = BrokerConfig(
            device="cpu",
            node_id=0,
            data_dir=str(tmp_path / "n0"),
            members=[0],
            election_timeout_s=0.3,
            heartbeat_interval_s=0.05,
            enable_admin=False,
        )
        sb = ShardedBroker(cfg, n_shards=2)
        await sb.start()
        try:
            # stand-down: plain single-process broker, no forked shards
            assert not sb.active
            assert sb.standdown is not None
            assert sb.runtime is None
            c = KafkaClient([("127.0.0.1", sb.kafka_port)])
            try:
                await _retry(
                    lambda: c.create_topic("t", partitions=2, replication_factor=1)
                )
                off = await _retry(lambda: c.produce("t", 0, [(b"k", b"v")]))
                rows = await c.fetch("t", 0, off)
                assert len(rows) == 1
            finally:
                await c.close()
        finally:
            await sb.stop()

    run(main())


# ------------------------------------------------- SO_REUSEPORT spread
def test_reuse_port_listeners_share_one_port_and_spread():
    async def main():
        rsock, port = reserve_reuse_port("127.0.0.1")
        hits = [0, 0, 0]
        servers = []

        def make_handler(i):
            async def on_conn(reader, writer):
                hits[i] += 1
                writer.close()

            return on_conn

        try:
            for i in range(3):
                s = bind_reuse_port("127.0.0.1", port)
                servers.append(
                    await asyncio.start_server(make_handler(i), sock=s)
                )
        finally:
            rsock.close()
        try:
            for _ in range(48):
                r, w = await asyncio.open_connection("127.0.0.1", port)
                try:
                    await r.read()  # EOF when the listener closes us
                except (ConnectionError, OSError):
                    pass
                w.close()
            assert sum(hits) == 48, hits
            # kernel hashes the 4-tuple: 48 distinct source ports over 3
            # listeners all landing on one is ~(1/3)^47 — spread means
            # the per-shard frontends genuinely share the accept load
            assert sum(1 for h in hits if h > 0) >= 2, hits
        finally:
            for srv in servers:
                srv.close()
                await srv.wait_closed()

    run(main())


def test_bind_reuse_port_rejects_taken_port_without_reuseport():
    # a plain listener (no SO_REUSEPORT) on the same port must conflict:
    # the sharing is an explicit opt-in, not a hole in port exclusivity
    rsock, port = reserve_reuse_port("127.0.0.1")
    try:
        plain = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        with pytest.raises(OSError):
            plain.bind(("127.0.0.1", port))
        plain.close()
    finally:
        rsock.close()


# ------------------------------------------------- TCP/loopback parity
class _TcpRaftCluster:
    """The tests/test_raft.py fixture shape, but every RPC crosses a
    real socket: one RpcServer per node, senders over TcpTransport
    (cached per src→dst edge, reconnect-on-drop)."""

    def __init__(self, tmp_path, n_nodes=3):
        self.tmp = tmp_path
        self.n = n_nodes
        self.nodes: dict[int, GroupManager] = {}
        self.servers: dict[int, RpcServer] = {}
        self.ports: dict[int, int] = {}
        self._transports: dict[tuple[int, int], TcpTransport] = {}

    async def start(self, election_timeout=0.3, heartbeat=0.05):
        for nid in range(1, self.n + 1):
            gm = GroupManager(
                device="cpu",
                node_id=nid,
                data_dir=str(self.tmp / f"node_{nid}"),
                send=self._sender(nid),
                election_timeout_s=election_timeout,
                heartbeat_interval_s=heartbeat,
            )
            srv = RpcServer()
            srv.register(gm.service)
            await srv.start()
            self.nodes[nid] = gm
            self.servers[nid] = srv
            self.ports[nid] = srv.port
        for gm in self.nodes.values():
            await gm.start()

    def _sender(self, src):
        async def send(dst, method_id, payload, timeout):
            key = (src, dst)
            t = self._transports.get(key)
            if t is None or not t.is_connected():
                t = TcpTransport("127.0.0.1", self.ports[dst])
                await t.connect()
                self._transports[key] = t
            return await t.call(method_id, payload, timeout)

        return send

    async def create_group(self, group_id=1):
        voters = list(self.nodes)
        for gm in self.nodes.values():
            await gm.create_group(group_id, voters)

    async def stop(self):
        for gm in self.nodes.values():
            await gm.stop()
        for t in self._transports.values():
            await t.close()
        for srv in self.servers.values():
            await srv.stop()

    async def wait_leader(self, group_id=1, timeout=10.0):
        deadline = asyncio.get_event_loop().time() + timeout
        while asyncio.get_event_loop().time() < deadline:
            leaders = [
                c
                for nid in self.nodes
                if (c := self.nodes[nid].get(group_id)) is not None
                and c.role == Role.LEADER
            ]
            if leaders:
                return leaders[0]
            await asyncio.sleep(0.02)
        raise TimeoutError("no leader elected over TCP")


class _LoopbackRaftCluster(_TcpRaftCluster):
    """Same scenario driver, loopback edition (the suite's default)."""

    def __init__(self, tmp_path, n_nodes=3):
        super().__init__(tmp_path, n_nodes)
        self.net = LoopbackNetwork()

    async def start(self, election_timeout=0.3, heartbeat=0.05):
        for nid in range(1, self.n + 1):
            gm = GroupManager(
                device="cpu",
                node_id=nid,
                data_dir=str(self.tmp / f"node_{nid}"),
                send=self._sender(nid),
                election_timeout_s=election_timeout,
                heartbeat_interval_s=heartbeat,
            )
            self.net.register(nid, gm.service)
            self.nodes[nid] = gm
            await gm.start()

    def _sender(self, src):
        async def send(dst, method_id, payload, timeout):
            t = LoopbackTransport(self.net, src, dst)
            return await t.call(method_id, payload, timeout)

        return send

    async def stop(self):
        for gm in self.nodes.values():
            await gm.stop()


def _data_batch(values):
    b = RecordBatchBuilder(batch_type=RecordBatchType.raft_data)
    for v in values:
        b.add(value=v, key=b"k")
    return b


async def _replicate_scenario(cluster):
    """Elect, quorum-replicate 5 records, wait for convergence; return
    the committed data-record payloads as seen by EVERY node."""
    values = [b"parity-%d" % i for i in range(5)]
    await cluster.start()
    try:
        await cluster.create_group()
        leader = await cluster.wait_leader()
        base, last = await leader.replicate(_data_batch(values), acks=-1)
        assert leader.commit_index >= last
        deadline = asyncio.get_event_loop().time() + 10.0
        per_node = {}
        for nid in cluster.nodes:
            while True:
                c = cluster.nodes[nid].get(1)
                if c.commit_index >= last and c.dirty_offset() >= last:
                    break
                if asyncio.get_event_loop().time() > deadline:
                    raise TimeoutError(f"node {nid} never converged")
                await asyncio.sleep(0.05)
            batches = c.log.read(base, upto=last)
            per_node[nid] = [
                r.value
                for b in batches
                if b.header.type == RecordBatchType.raft_data
                for r in b.records()
            ]
        assert all(vals == values for vals in per_node.values()), per_node
        return per_node
    finally:
        await cluster.stop()


def test_tcp_transport_raft_parity_with_loopback(tmp_path):
    # the same raft scenario must commit identical records whether RPCs
    # cross LoopbackNetwork (test default) or real TCP sockets (the
    # multi-process bench path) — the transport is not load-bearing
    tcp = run(_replicate_scenario(_TcpRaftCluster(tmp_path / "tcp")))
    loop = run(_replicate_scenario(_LoopbackRaftCluster(tmp_path / "lo")))
    assert tcp == loop
