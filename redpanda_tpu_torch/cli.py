"""rpk-style operator CLI.

Reference: src/go/rpk (topic/group/cluster/acl/user command families).
Speaks the same two surfaces any external tool would: the Kafka wire
protocol (via the bundled client) and the admin HTTP API — nothing
in-process, so it works against any reachable cluster.

Usage:
    python -m redpanda_tpu_torch.cli --brokers HOST:PORT [--admin URL] CMD ...

Command families:
    topic    create | delete | list | describe | produce | consume |
             alter-config | add-partitions | trim-prefix
    group    list | describe | delete
    cluster  health | info | config-get | config-set | metadata
    acl      create | list | delete
    user     create | delete
    broker   decommission | recommission | maintenance | resume
    partition move | transfer-leader
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import urllib.error
import urllib.request


def _admin(args, method: str, path: str, body: dict | None = None):
    if not args.admin:
        raise SystemExit("this command needs --admin URL")
    req = urllib.request.Request(
        args.admin.rstrip("/") + path,
        method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            raw = resp.read()
            return json.loads(raw) if raw else None
    except urllib.error.HTTPError as e:
        detail = e.read().decode(errors="replace")
        raise SystemExit(f"admin API {e.code}: {detail}") from None


def _parse_brokers(spec: str) -> list[tuple[str, int]]:
    out = []
    for part in spec.split(","):
        host, _, port = part.strip().rpartition(":")
        out.append((host or "127.0.0.1", int(port)))
    return out


def _client(args):
    from .kafka.client import KafkaClient

    sasl = None
    if args.user:
        sasl = (args.user, args.password or "", args.mechanism)
    return KafkaClient(_parse_brokers(args.brokers), sasl=sasl)


def _print(obj) -> None:
    print(json.dumps(obj, indent=2, default=str))


# ---------------------------------------------------------------- topic
async def cmd_topic(args) -> None:
    c = _client(args)
    try:
        if args.action == "create":
            await c.create_topic(
                args.topic,
                partitions=args.partitions,
                replication_factor=args.replicas,
                configs=dict(kv.split("=", 1) for kv in args.config or []),
            )
            print(f"created topic {args.topic}")
        elif args.action == "delete":
            await c.delete_topic(args.topic)
            print(f"deleted topic {args.topic}")
        elif args.action == "list":
            md = await c.metadata()
            _print(sorted(t.name for t in md.topics))
        elif args.action == "describe":
            md = await c.metadata([args.topic])
            t = md.topics[0]
            if t.error_code:
                raise SystemExit(f"error {t.error_code}")
            configs = await c.describe_configs(args.topic)
            _print(
                {
                    "name": t.name,
                    "partitions": [
                        {
                            "partition": p.partition_index,
                            "leader": p.leader_id,
                            "replicas": list(p.replica_nodes),
                        }
                        for p in t.partitions
                    ],
                    "configs": dict(configs),
                }
            )
        elif args.action == "alter-config":
            sets = dict(kv.split("=", 1) for kv in args.set or [])
            await c.alter_topic_configs(
                args.topic, sets, removes=args.remove or []
            )
            print("ok")
        elif args.action == "add-partitions":
            await c.create_partitions(args.topic, args.count)
            print(f"partition count now {args.count}")
        elif args.action == "produce":
            data = args.value
            if data is None:
                data = sys.stdin.read().rstrip("\n")
            off = await c.produce(
                args.topic,
                args.partition,
                [(args.key.encode() if args.key else None, data.encode())],
            )
            print(f"offset {off}")
        elif args.action == "consume":
            pos = args.offset
            remaining = args.num
            while remaining != 0:
                got = await c.fetch(
                    args.topic, args.partition, pos, max_wait_ms=500
                )
                if not got:
                    if not args.follow:
                        break
                    continue
                for off, k, v in got:
                    print(
                        json.dumps(
                            {
                                "offset": off,
                                "key": (k or b"").decode(errors="replace"),
                                "value": (v or b"").decode(errors="replace"),
                            }
                        )
                    )
                    pos = off + 1
                    if remaining > 0:
                        remaining -= 1
                        if remaining == 0:
                            break
        elif args.action == "trim-prefix":
            from .kafka.protocol import Msg
            from .kafka.protocol.admin_apis import DELETE_RECORDS

            conn = await c.leader_conn(args.topic, args.partition)
            resp = await conn.request(
                DELETE_RECORDS,
                Msg(
                    topics=[
                        Msg(
                            name=args.topic,
                            partitions=[
                                Msg(
                                    partition_index=args.partition,
                                    offset=args.offset,
                                )
                            ],
                        )
                    ],
                    timeout_ms=10000,
                ),
                1,
            )
            row = resp.topics[0].partitions[0]
            if row.error_code:
                raise SystemExit(f"error {row.error_code}")
            print(f"low watermark {row.low_watermark}")
    finally:
        await c.close()


# ---------------------------------------------------------------- group
async def cmd_group(args) -> None:
    from .kafka.protocol.group_apis import (
        DELETE_GROUPS,
        DESCRIBE_GROUPS,
        LIST_GROUPS,
    )
    from .kafka.protocol import Msg

    c = _client(args)
    try:
        conn = await c.any_conn()
        if args.action == "list":
            resp = await conn.request(LIST_GROUPS, Msg(), 2)
            _print([g.group_id for g in resp.groups])
        elif args.action == "describe":
            gc = c.group(args.group)
            coord = await gc.coordinator()
            resp = await coord.request(
                DESCRIBE_GROUPS, Msg(groups=[args.group]), 1
            )
            g = resp.groups[0]
            offsets = await gc.fetch_offsets()
            _print(
                {
                    "group": g.group_id,
                    "state": g.group_state,
                    "protocol": g.protocol_data,
                    "members": [m.member_id for m in g.members],
                    "offsets": {
                        f"{t}/{p}": off for (t, p), off in offsets.items()
                    },
                }
            )
        elif args.action == "delete":
            gc = c.group(args.group)
            coord = await gc.coordinator()
            resp = await coord.request(
                DELETE_GROUPS, Msg(groups_names=[args.group]), 1
            )
            code = resp.results[0].error_code
            if code:
                raise SystemExit(f"error {code}")
            print(f"deleted group {args.group}")
    finally:
        await c.close()


# -------------------------------------------------------------- cluster
async def cmd_cluster(args) -> None:
    if args.action == "health":
        _print(_admin(args, "GET", "/v1/cluster/health_overview"))
    elif args.action == "info":
        _print(_admin(args, "GET", "/v1/brokers"))
    elif args.action == "config-get":
        _print(_admin(args, "GET", "/v1/cluster_config"))
    elif args.action == "config-set":
        upserts = dict(kv.split("=", 1) for kv in args.set or [])
        _print(
            _admin(
                args,
                "PUT",
                "/v1/cluster_config",
                {"upsert": upserts, "remove": args.remove or []},
            )
        )
    elif args.action == "metadata":
        c = _client(args)
        try:
            md = await c.metadata()
            _print(
                {
                    "cluster_id": md.cluster_id,
                    "controller": md.controller_id,
                    "brokers": [
                        {"id": b.node_id, "addr": f"{b.host}:{b.port}"}
                        for b in md.brokers
                    ],
                    "topics": sorted(t.name for t in md.topics),
                }
            )
        finally:
            await c.close()


# ------------------------------------------------------------ acl/user
async def cmd_acl(args) -> None:
    from .kafka.protocol import Msg
    from .kafka.protocol.admin_apis import (
        CREATE_ACLS,
        DELETE_ACLS,
        DESCRIBE_ACLS,
    )
    from .security.acl import (
        AclOperation,
        AclPatternType,
        AclPermission,
        AclResourceType,
    )

    c = _client(args)
    try:
        conn = await c.any_conn()
        if args.action == "create":
            resp = await conn.request(
                CREATE_ACLS,
                Msg(
                    creations=[
                        Msg(
                            resource_type=int(
                                AclResourceType[args.resource_type]
                            ),
                            resource_name=args.resource_name,
                            resource_pattern_type=int(
                                AclPatternType[args.pattern]
                            ),
                            principal=args.principal,
                            host="*",
                            operation=int(AclOperation[args.operation]),
                            permission_type=int(AclPermission[args.permission]),
                        )
                    ]
                ),
                1,
            )
            code = resp.results[0].error_code
            if code:
                raise SystemExit(f"error {code}")
            print("acl created")
        elif args.action == "list":
            resp = await conn.request(
                DESCRIBE_ACLS,
                Msg(
                    resource_type_filter=1,
                    resource_name_filter=None,
                    pattern_type_filter=1,
                    principal_filter=None,
                    host_filter=None,
                    operation=1,
                    permission_type=1,
                ),
                1,
            )
            out = []
            for r in resp.resources:
                for a in r.acls:
                    out.append(
                        {
                            "resource": f"{AclResourceType(r.resource_type).name}:"
                            f"{r.resource_name}",
                            "principal": a.principal,
                            "operation": AclOperation(a.operation).name,
                            "permission": AclPermission(a.permission_type).name,
                        }
                    )
            _print(out)
        elif args.action == "delete":
            resp = await conn.request(
                DELETE_ACLS,
                Msg(
                    filters=[
                        Msg(
                            resource_type_filter=int(
                                AclResourceType[args.resource_type]
                            ),
                            resource_name_filter=args.resource_name,
                            pattern_type_filter=1,
                            principal_filter=args.principal,
                            host_filter=None,
                            operation=1,
                            permission_type=1,
                        )
                    ]
                ),
                1,
            )
            fr = resp.filter_results[0]
            if fr.error_code:
                raise SystemExit(f"error {fr.error_code}")
            print(f"deleted {len(fr.matching_acls)} acls")
    finally:
        await c.close()


async def cmd_user(args) -> None:
    if args.action == "create":
        _admin(
            args,
            "PUT",
            "/v1/security/users",
            {
                "username": args.name,
                "password": args.user_password,
                "algorithm": args.mechanism,
            },
        )
        print(f"created user {args.name}")
    elif args.action == "delete":
        _admin(args, "DELETE", f"/v1/security/users/{args.name}")
        print(f"deleted user {args.name}")


# ----------------------------------------------------- broker/partition
async def cmd_broker(args) -> None:
    if args.action == "decommission":
        _admin(args, "POST", f"/v1/brokers/{args.id}/decommission")
        print(f"decommissioning node {args.id}")
    elif args.action == "recommission":
        _admin(args, "POST", f"/v1/brokers/{args.id}/recommission")
        print(f"recommissioned node {args.id}")
    elif args.action == "maintenance":
        _admin(args, "PUT", f"/v1/brokers/{args.id}/maintenance")
        print(f"node {args.id} entering maintenance (leadership drains)")
    elif args.action == "resume":
        _admin(args, "DELETE", f"/v1/brokers/{args.id}/maintenance")
        print(f"node {args.id} leaving maintenance")


async def cmd_partition(args) -> None:
    if args.action == "move":
        _admin(
            args,
            "POST",
            f"/v1/partitions/kafka/{args.topic}/{args.partition}/move_replicas",
            {"replicas": [int(r) for r in args.replicas.split(",")]},
        )
        print("move requested")
    elif args.action == "transfer-leader":
        target = f"?target={args.target}" if args.target is not None else ""
        _admin(
            args,
            "POST",
            f"/v1/partitions/kafka/{args.topic}/{args.partition}"
            f"/transfer_leadership{target}",
        )
        print("leadership transfer requested")


async def cmd_generate(args) -> None:
    """Static deployment manifests (the k8s-operator analog at the
    manifest level: headless Service for seed discovery + StatefulSet
    with stable node ids derived from the pod ordinal — the same shape
    src/go/k8s's controllers reconcile toward)."""
    if args.action == "k8s":
        seeds = ",".join(
            f"{args.name}-{i}.{args.name}.{args.namespace}.svc:33145"
            for i in range(args.replicas)
        )
        print(
            K8S_TEMPLATE.format(
                name=args.name,
                namespace=args.namespace,
                replicas=args.replicas,
                image=args.image,
                storage=args.storage,
                seeds=seeds,
            )
        )
    elif args.action == "crd":
        # CRD + a sample CR for the reconcile controller
        # (redpanda_tpu_torch/operator.py); kubectl apply this, then run the
        # operator pointed at the apiserver
        print(CRD_TEMPLATE)
    elif args.action == "cluster":
        print(
            CLUSTER_CR_TEMPLATE.format(
                name=args.name,
                namespace=args.namespace,
                replicas=args.replicas,
                image=args.image,
                storage=args.storage,
            )
        )


K8S_TEMPLATE = """\
apiVersion: v1
kind: Service
metadata:
  name: {name}
  namespace: {namespace}
  labels: {{app: {name}}}
spec:
  clusterIP: None            # headless: stable per-pod DNS for seeds
  selector: {{app: {name}}}
  ports:
  - {{name: kafka, port: 9092}}
  - {{name: rpc, port: 33145}}
  - {{name: admin, port: 9644}}
---
apiVersion: apps/v1
kind: StatefulSet
metadata:
  name: {name}
  namespace: {namespace}
spec:
  serviceName: {name}
  replicas: {replicas}
  podManagementPolicy: Parallel
  selector:
    matchLabels: {{app: {name}}}
  template:
    metadata:
      labels: {{app: {name}}}
    spec:
      terminationGracePeriodSeconds: 60
      containers:
      - name: broker
        image: {image}
        command: ["python", "-m", "redpanda_tpu_torch"]
        env:
        - name: POD_NAME
          valueFrom: {{fieldRef: {{fieldPath: metadata.name}}}}
        args:
        - --data-dir=/var/lib/redpanda-tpu
        - --node-id-from-hostname    # pod ordinal -> node id
        - --seeds={seeds}
        # stable per-pod DNS: correct even for pods scaled out beyond
        # the seed list (they join via the seeds and advertise this)
        - --advertised-host=$(POD_NAME).{name}.{namespace}.svc
        - --kafka-port=9092
        - --rpc-port=33145
        - --admin-port=9644
        ports:
        - {{containerPort: 9092, name: kafka}}
        - {{containerPort: 33145, name: rpc}}
        - {{containerPort: 9644, name: admin}}
        readinessProbe:
          httpGet: {{path: /v1/status/ready, port: admin}}
          initialDelaySeconds: 5
          periodSeconds: 5
        volumeMounts:
        - {{name: data, mountPath: /var/lib/redpanda-tpu}}
  volumeClaimTemplates:
  - metadata:
      name: data
    spec:
      accessModes: [ReadWriteOnce]
      resources:
        requests: {{storage: {storage}}}
"""


CRD_TEMPLATE = """\
apiVersion: apiextensions.k8s.io/v1
kind: CustomResourceDefinition
metadata:
  name: clusters.redpanda.tpu
spec:
  group: redpanda.tpu
  scope: Namespaced
  names: {plural: clusters, singular: cluster, kind: Cluster}
  versions:
  - name: v1
    served: true
    storage: true
    subresources: {status: {}}
    schema:
      openAPIV3Schema:
        type: object
        properties:
          spec:
            type: object
            required: [replicas]
            properties:
              replicas: {type: integer, minimum: 1}
              image: {type: string}
              storage: {type: string}
              kafkaPort: {type: integer}
              rpcPort: {type: integer}
              adminPort: {type: integer}
              extraArgs: {type: array, items: {type: string}}
          status:
            type: object
            x-kubernetes-preserve-unknown-fields: true
"""

CLUSTER_CR_TEMPLATE = """\
apiVersion: redpanda.tpu/v1
kind: Cluster
metadata:
  name: {name}
  namespace: {namespace}
spec:
  replicas: {replicas}
  image: {image}
  storage: {storage}
"""


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="rpk", description=__doc__)
    ap.add_argument("--brokers", default="127.0.0.1:9092")
    ap.add_argument("--admin", default=None, help="admin API base URL")
    ap.add_argument("--user", default=None, help="SASL username")
    ap.add_argument("--password", default=None, help="SASL password")
    ap.add_argument("--mechanism", default="SCRAM-SHA-256")
    sub = ap.add_subparsers(dest="family", required=True)

    t = sub.add_parser("topic")
    t.add_argument(
        "action",
        choices=[
            "create", "delete", "list", "describe", "produce", "consume",
            "alter-config", "add-partitions", "trim-prefix",
        ],
    )
    t.add_argument("topic", nargs="?")
    t.add_argument("-p", "--partitions", type=int, default=1)
    t.add_argument("-r", "--replicas", type=int, default=1)
    t.add_argument("-c", "--config", action="append")
    t.add_argument("--set", action="append")
    t.add_argument("--remove", action="append")
    t.add_argument("--count", type=int)
    t.add_argument("--partition", type=int, default=0)
    t.add_argument("-k", "--key", default=None)
    t.add_argument("-v", "--value", default=None)
    t.add_argument("-o", "--offset", type=int, default=0)
    t.add_argument("-n", "--num", type=int, default=-1)
    t.add_argument("-f", "--follow", action="store_true")
    t.set_defaults(fn=cmd_topic)

    g = sub.add_parser("group")
    g.add_argument("action", choices=["list", "describe", "delete"])
    g.add_argument("group", nargs="?")
    g.set_defaults(fn=cmd_group)

    cl = sub.add_parser("cluster")
    cl.add_argument(
        "action",
        choices=["health", "info", "config-get", "config-set", "metadata"],
    )
    cl.add_argument("--set", action="append")
    cl.add_argument("--remove", action="append")
    cl.set_defaults(fn=cmd_cluster)

    a = sub.add_parser("acl")
    a.add_argument("action", choices=["create", "list", "delete"])
    a.add_argument("--resource-type", default="topic")
    a.add_argument("--resource-name", default=None)
    a.add_argument("--pattern", default="literal")
    a.add_argument("--principal", default=None)
    a.add_argument("--operation", default="all")
    a.add_argument("--permission", default="allow")
    a.set_defaults(fn=cmd_acl)

    u = sub.add_parser("user")
    u.add_argument("action", choices=["create", "delete"])
    u.add_argument("name")
    u.add_argument("--user-password", default="")
    u.set_defaults(fn=cmd_user)

    b = sub.add_parser("broker")
    b.add_argument(
        "action",
        choices=["decommission", "recommission", "maintenance", "resume"],
    )
    b.add_argument("id", type=int)
    b.set_defaults(fn=cmd_broker)

    p = sub.add_parser("partition")
    p.add_argument("action", choices=["move", "transfer-leader"])
    p.add_argument("topic")
    p.add_argument("partition", type=int)
    p.add_argument("--replicas", default=None)
    p.add_argument("--target", type=int, default=None)
    p.set_defaults(fn=cmd_partition)

    gen = sub.add_parser("generate")
    gen.add_argument("action", choices=["k8s", "crd", "cluster"])
    gen.add_argument("--name", default="redpanda-tpu")
    gen.add_argument("--namespace", default="default")
    gen.add_argument("--replicas", type=int, default=3)
    gen.add_argument("--image", default="redpanda-tpu:latest")
    gen.add_argument("--storage", default="10Gi")
    gen.set_defaults(fn=cmd_generate)

    dbg = sub.add_parser("debug")
    dbg.add_argument("action", choices=["bundle"])
    dbg.add_argument("-o", "--output", default="debug-bundle.json.gz")
    dbg.set_defaults(fn=cmd_debug)

    # `rpk redpanda tune|check` analog (ref src/go/rpk/pkg/cli/cmd/
    # redpanda/tune.go + check.go; tuner inventory tuners/)
    rp = sub.add_parser("redpanda")
    rp.add_argument("action", choices=["check", "tune"])
    rp.add_argument(
        "--apply",
        action="store_true",
        help="apply mutations (default: dry-run report of the plan)",
    )
    rp.set_defaults(fn=cmd_redpanda)

    return ap


async def cmd_redpanda(args) -> None:
    from .tuners import check_all, tune_all

    if args.action == "check":
        results = check_all()
        rows = []
        for r in results:
            rows.append(
                {
                    "tuner": r.tuner,
                    "ok": r.ok,
                    "supported": r.supported,
                    "current": r.current,
                    "required": r.required,
                    "severity": r.severity.value,
                    **({"error": r.error} if r.error else {}),
                }
            )
        _print(rows)
        if any(
            not r.ok and r.severity.value == "fatal" and r.supported
            for r in results
        ):
            raise SystemExit(1)
        return
    results = tune_all(dry_run=not args.apply)
    rows = []
    for r in results:
        rows.append(
            {
                "tuner": r.tuner,
                "changed": r.changed,
                "applied": r.applied,
                "actions": [a.describe() for a in r.actions],
                **({"error": r.error} if r.error else {}),
            }
        )
    _print(rows)


_BUNDLE_ROUTES = [
    ("status", "/v1/status/ready"),
    ("brokers", "/v1/brokers"),
    ("health", "/v1/cluster/health_overview"),
    ("cluster_stats", "/v1/cluster/stats"),
    ("cluster_config", "/v1/cluster_config"),
    ("config_schema", "/v1/cluster_config/schema"),
    ("topics", "/v1/topics"),
    ("features", "/v1/features"),
    ("scheduler", "/v1/debug/scheduler"),
    ("transforms", "/v1/transforms"),
    ("loggers", "/v1/loggers"),
]


async def cmd_debug(args) -> None:
    """`rpk debug bundle` analog: one archive of everything a support
    engineer asks for first — admin-API snapshots + raw /metrics —
    written as gzipped JSON."""
    import gzip
    import time as time_mod

    if not args.admin:
        raise SystemExit("debug bundle needs --admin URL")
    bundle: dict = {
        "generated_at": time_mod.strftime("%Y-%m-%dT%H:%M:%SZ", time_mod.gmtime()),
        "admin": args.admin,
        "sections": {},
        "errors": {},
    }
    for name, path in _BUNDLE_ROUTES:
        try:
            bundle["sections"][name] = _admin(args, "GET", path)
        except (SystemExit, Exception) as e:  # per-section: a dead or
            bundle["errors"][name] = str(e)   # hung route must not
            # sink the whole bundle (timeouts/resets raise URLError,
            # not the SystemExit _admin uses for HTTP errors)
    try:
        req = urllib.request.Request(args.admin.rstrip("/") + "/metrics")
        with urllib.request.urlopen(req, timeout=10) as resp:
            bundle["sections"]["metrics"] = resp.read().decode(errors="replace")
    except Exception as e:
        bundle["errors"]["metrics"] = str(e)
    out = args.output
    data = json.dumps(bundle, indent=1, default=str).encode()
    if out.endswith(".gz"):
        with gzip.open(out, "wb") as f:
            f.write(data)
    else:
        with open(out, "wb") as f:
            f.write(data)
    ok = len(bundle["sections"])
    print(f"wrote {out}: {ok} sections, {len(bundle['errors'])} errors")


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    asyncio.run(args.fn(args))


if __name__ == "__main__":
    main()
