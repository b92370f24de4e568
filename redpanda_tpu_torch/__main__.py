"""Standalone broker entrypoint (reference: redpanda/main.cc:17 →
application::run).

    python -m redpanda_tpu_torch --node-id 0 --data-dir /var/lib/rp \\
        --seeds host0:33145,host1:33145,host2:33145 \\
        --kafka-port 9092 --rpc-port 33145 --admin-port 9644 \\
        [--device cuda|cpu] [--shards N]

Seeds are ordered: seed i is node id i (the k8s StatefulSet maps pod
ordinals the same way; --node-id-from-hostname derives the id from a
trailing -<ordinal> hostname). Runs until SIGTERM/SIGINT, then stops
the broker cleanly (drain, flush, close).

`--device` (default `cuda`) is where the broker's kernels run: the raft
lanes (`BrokerConfig.device`) and the record, fetch and archive seams
(`ops/default_device.py`). `cpu` runs the kernels' plain
PyTorch versions. `cuda` on a machine without a CUDA device exits
non-zero before serving. The process asks NVML, not the CUDA driver,
whether a card is there, so nothing initialises CUDA before the shard
runtime's fork server exists (ssx/shards.py).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal
import socket
import sys

from .app import Broker, BrokerConfig


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="redpanda_tpu_torch", description=__doc__)
    ap.add_argument("--node-id", type=int, default=None)
    ap.add_argument(
        "--node-id-from-hostname",
        action="store_true",
        help="derive node id from a trailing -<n> in the hostname "
        "(StatefulSet pod ordinal)",
    )
    ap.add_argument("--data-dir", required=True)
    ap.add_argument(
        "--seeds",
        default="",
        help="comma-separated host:rpc_port, ordered by node id",
    )
    ap.add_argument("--kafka-host", default="0.0.0.0")
    ap.add_argument("--kafka-port", type=int, default=9092)
    ap.add_argument("--rpc-port", type=int, default=33145)
    ap.add_argument("--admin-port", type=int, default=9644)
    ap.add_argument("--advertised-host", default=None)
    ap.add_argument("--rack", default=None)
    ap.add_argument("--enable-sasl", action="store_true")
    ap.add_argument("--kafka-tls-cert", default=None)
    ap.add_argument("--kafka-tls-key", default=None)
    ap.add_argument("--kafka-tls-ca", default=None)
    ap.add_argument("--kafka-tls-require-client-auth", action="store_true")
    ap.add_argument(
        "--mtls-principal-rule",
        action="append",
        default=None,
        help="RULE:pattern/replacement/[LU] or DEFAULT (repeatable)",
    )
    ap.add_argument("--superuser", action="append", default=None)
    ap.add_argument("--cloud-storage-dir", default=None)
    ap.add_argument(
        "--cloud-storage-endpoint",
        default=None,
        help="S3-compatible host:port (takes precedence over "
        "--cloud-storage-dir)",
    )
    ap.add_argument("--cloud-storage-bucket", default="redpanda")
    ap.add_argument("--cloud-storage-region", default="us-east-1")
    ap.add_argument("--cloud-storage-access-key", default="")
    ap.add_argument("--cloud-storage-secret-key", default="")
    ap.add_argument("--cloud-storage-tls", action="store_true")
    ap.add_argument("--enable-pandaproxy", action="store_true")
    ap.add_argument("--pandaproxy-port", type=int, default=8082)
    ap.add_argument("--enable-schema-registry", action="store_true")
    ap.add_argument("--schema-registry-port", type=int, default=8081)
    ap.add_argument(
        "--logical-version",
        type=int,
        default=None,
        help="advertise an older feature level (mixed-version testing)",
    )
    ap.add_argument("--log-level", default="INFO")
    ap.add_argument(
        "--device",
        default="cuda",
        help="torch device of the broker's kernels: cuda (the card) or "
        "cpu (their plain PyTorch versions)",
    )
    ap.add_argument(
        "--shards",
        type=int,
        default=int(os.environ.get("RP_SHARDS", "1") or "1"),
        help="worker shards (processes) for the data plane; 1 = "
        "single-process broker (ssx shard-per-core runtime)",
    )
    ap.add_argument(
        "--pin-core",
        type=int,
        default=None,
        help="pin this broker process to one CPU core "
        "(sched_setaffinity; mp bench uses it for honest core counts)",
    )
    return ap.parse_args(argv)


def node_id_from_hostname() -> int:
    host = socket.gethostname()
    tail = host.rsplit("-", 1)[-1]
    if not tail.isdigit():
        raise SystemExit(
            f"--node-id-from-hostname: hostname {host!r} has no trailing "
            f"-<ordinal>"
        )
    return int(tail)


def _stable_node_uuid(data_dir: str) -> str:
    """Node identity that survives restarts (cluster_discovery.cc keeps
    it in the kvstore; a file is equivalent for the pre-start phase)."""
    import secrets

    os.makedirs(data_dir, exist_ok=True)
    path = os.path.join(data_dir, "node_uuid")
    try:
        with open(path) as f:
            got = f.read().strip()
            if got:
                return got
    except OSError:
        pass
    uuid = secrets.token_hex(16)
    with open(path, "w") as f:
        f.write(uuid)
    return uuid


async def _discover_node_id(
    peers: dict[int, tuple[str, int]], data_dir: str
) -> int:
    """Ask the seeds for this node's reserved id (idempotent: keyed by
    the stable node uuid) before the broker is constructed."""
    from .cluster.controller import discover_node_id
    from .rpc.transport import TcpTransport

    transports = {i: TcpTransport(h, p) for i, (h, p) in peers.items()}

    async def send(node, method_id, payload, timeout):
        t = transports[node]
        if not t.is_connected():
            await t.connect()
        return await t.call(method_id, payload, timeout)

    try:
        return await discover_node_id(
            send, list(peers), _stable_node_uuid(data_dir), timeout=60.0
        )
    finally:
        for t in transports.values():
            try:
                await t.close()
            except Exception:
                pass


def build_config(args) -> BrokerConfig:
    node_id = (
        node_id_from_hostname() if args.node_id_from_hostname else args.node_id
    )
    peers: dict[int, tuple[str, int]] = {}
    for i, hp in enumerate(s for s in args.seeds.split(",") if s):
        host, _, port = hp.partition(":")
        peers[i] = (host, int(port or 33145))
    if node_id is None:
        if not peers:
            raise SystemExit(
                "--node-id, --node-id-from-hostname, or --seeds (for "
                "automatic id assignment) required"
            )
        # id-less scale-out node: reserve an id through the seeds
        node_id = asyncio.run(_discover_node_id(peers, args.data_dir))
        print(f"assigned node id {node_id} (reserved via seeds)")
    members = sorted(peers) if peers else [node_id]
    if node_id in peers:
        # this node's own listener binds the configured port; its seed
        # entry tells PEERS where to reach it
        advertised = args.advertised_host or peers[node_id][0]
    else:
        # beyond the seed set (scale-out pod): the node JOINS via the
        # seeds (auto_join), but must advertise a routable address —
        # silently announcing 0.0.0.0 would make it a zombie member
        advertised = args.advertised_host
        if peers and advertised is None:
            raise SystemExit(
                f"node {node_id} is not in the seed list; scale-out "
                f"nodes need --advertised-host (k8s: the pod's stable "
                f"DNS name via $(POD_NAME))"
            )
    return BrokerConfig(
        node_id=node_id,
        data_dir=args.data_dir,
        members=members,
        peer_addresses=peers or None,
        kafka_host=args.kafka_host,
        kafka_port=args.kafka_port,
        rpc_host="0.0.0.0",
        rpc_port=args.rpc_port,
        advertised_host=advertised,
        rack=args.rack,
        enable_sasl=args.enable_sasl,
        logical_version=args.logical_version,
        kafka_tls_cert=args.kafka_tls_cert,
        kafka_tls_key=args.kafka_tls_key,
        kafka_tls_ca=args.kafka_tls_ca,
        kafka_tls_require_client_auth=args.kafka_tls_require_client_auth,
        mtls_principal_rules=args.mtls_principal_rule,
        superusers=args.superuser,
        cloud_storage_dir=args.cloud_storage_dir,
        cloud_storage_endpoint=args.cloud_storage_endpoint,
        cloud_storage_bucket=args.cloud_storage_bucket,
        cloud_storage_region=args.cloud_storage_region,
        cloud_storage_access_key=args.cloud_storage_access_key,
        cloud_storage_secret_key=args.cloud_storage_secret_key,
        cloud_storage_tls=args.cloud_storage_tls,
        admin_host="0.0.0.0",
        admin_port=args.admin_port,
        enable_pandaproxy=args.enable_pandaproxy,
        pandaproxy_port=args.pandaproxy_port,
        enable_schema_registry=args.enable_schema_registry,
        schema_registry_port=args.schema_registry_port,
        device=args.device,
    )


def use_device(device: str) -> None:
    """Point every kernel seam of this process at `device`: the codec
    and CRC entries take no device argument on the record, fetch and
    archive paths, so they run on ops.default_device. A CUDA device
    that is not there raises here, before anything is served."""
    # NVML answers is_available() without initialising CUDA, so a
    # worker shard forked after this check can still use the card
    os.environ.setdefault("PYTORCH_NVML_BASED_CUDA_CHECK", "1")
    from .ops import default_device

    default_device.use(device)


async def run(config: BrokerConfig, shards: int = 1) -> None:
    import os

    from . import syschecks

    os.makedirs(config.data_dir, exist_ok=True)
    # exclusive dir ownership BEFORE touching any on-disk state
    pidlock = syschecks.acquire_pidlock(config.data_dir)
    if shards > 1:
        from .ssx.sharded_broker import ShardedBroker

        owner = ShardedBroker(config, n_shards=shards)
        await owner.start()
        broker = owner.broker
    else:
        owner = None
        broker = Broker(config)
        await broker.start()
    logging.getLogger("main").info(
        "node %d serving: kafka :%d rpc :%d admin :%d",
        config.node_id,
        broker.kafka_server.port,
        config.rpc_port,
        broker.admin.port if broker.admin else -1,
    )
    stop = asyncio.Event()
    loop = asyncio.get_event_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    if owner is not None and owner.active:
        # a dead shard means silently lost partitions: stop the whole
        # broker rather than limp (seastar: an engine abort takes the
        # process down)
        fail_task = asyncio.ensure_future(owner.failed.wait())
        fail_task.add_done_callback(lambda _t: stop.set())
    await stop.wait()
    logging.getLogger("main").info("shutting down")
    if owner is not None:
        await owner.stop()
    else:
        await broker.stop()
    pidlock.release()


def main(argv=None) -> None:
    args = parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        stream=sys.stderr,
    )
    if args.pin_core is not None:
        try:
            os.sched_setaffinity(0, {args.pin_core})
        except OSError:
            logging.getLogger("main").warning(
                "could not pin to core %d", args.pin_core
            )
    use_device(args.device)
    asyncio.run(run(build_config(args), shards=args.shards))


if __name__ == "__main__":
    main()
