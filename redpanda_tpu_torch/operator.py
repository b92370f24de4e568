"""Kubernetes operator: Cluster CRD reconciliation.

Reference: src/go/k8s — a controller-runtime operator watching a
`Cluster` custom resource and reconciling StatefulSet/Service objects
toward its spec, with the critical ordering rule the reference
enforces around scale (cluster_controller.go / decommission flow):
scale-UP patches the StatefulSet immediately, but scale-DOWN first
decommissions the doomed brokers through the admin API (so raft
replicas and partition placements drain off them) and only then
shrinks the StatefulSet.

This is the same reconcile loop re-built over a minimal REST surface
(`KubeApi`): desired objects are computed from the CR spec, diffed
against the observed cluster, and created/patched idempotently; CR
status (observedGeneration / readyReplicas / conditions) is written
back. Tests drive it against an in-memory fake API server; production
points the same loop at a real apiserver via HttpKubeApi
(cloud/http_client with the service-account bearer token).
"""

from __future__ import annotations

import asyncio
import copy
import dataclasses
import json
import logging
from typing import Callable, Optional

from .utils.tasks import cancel_and_wait

logger = logging.getLogger("rp.operator")

GROUP = "redpanda.tpu"
VERSION = "v1"
CRD_PLURAL = "clusters"


@dataclasses.dataclass(slots=True)
class ClusterSpec:
    """Parsed Cluster CR spec (the operator's Cluster CRD analog)."""

    name: str
    namespace: str
    replicas: int
    image: str = "redpanda-tpu:latest"
    storage: str = "10Gi"
    kafka_port: int = 9092
    rpc_port: int = 33145
    admin_port: int = 9644
    extra_args: tuple[str, ...] = ()

    @staticmethod
    def from_cr(cr: dict) -> "ClusterSpec":
        meta = cr.get("metadata", {})
        spec = cr.get("spec", {})
        if not meta.get("name"):
            raise ValueError("Cluster CR missing metadata.name")
        replicas = int(spec.get("replicas", 1))
        if replicas < 1:
            raise ValueError(f"spec.replicas must be >= 1, got {replicas}")
        return ClusterSpec(
            name=meta["name"],
            namespace=meta.get("namespace", "default"),
            replicas=replicas,
            image=spec.get("image", "redpanda-tpu:latest"),
            storage=spec.get("storage", "10Gi"),
            kafka_port=int(spec.get("kafkaPort", 9092)),
            rpc_port=int(spec.get("rpcPort", 33145)),
            admin_port=int(spec.get("adminPort", 9644)),
            extra_args=tuple(spec.get("extraArgs", ())),
        )

    def seeds(self) -> str:
        return ",".join(
            f"{self.name}-{i}.{self.name}.{self.namespace}.svc:{self.rpc_port}"
            for i in range(self.replicas)
        )


# -- desired-state builders ------------------------------------------


def desired_service(spec: ClusterSpec) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": spec.name,
            "namespace": spec.namespace,
            "labels": {"app": spec.name, "managed-by": "redpanda-tpu-operator"},
        },
        "spec": {
            "clusterIP": "None",  # headless: stable per-pod DNS
            "selector": {"app": spec.name},
            "ports": [
                {"name": "kafka", "port": spec.kafka_port},
                {"name": "rpc", "port": spec.rpc_port},
                {"name": "admin", "port": spec.admin_port},
            ],
        },
    }


def desired_statefulset(spec: ClusterSpec) -> dict:
    pod = {
        "metadata": {"labels": {"app": spec.name}},
        "spec": {
            "terminationGracePeriodSeconds": 60,
            "containers": [
                {
                    "name": "broker",
                    "image": spec.image,
                    "command": ["python", "-m", "redpanda_tpu_torch"],
                    "env": [
                        {
                            "name": "POD_NAME",
                            "valueFrom": {
                                "fieldRef": {"fieldPath": "metadata.name"}
                            },
                        }
                    ],
                    "args": [
                        "--data-dir=/var/lib/redpanda-tpu",
                        "--node-id-from-hostname",
                        f"--seeds={spec.seeds()}",
                        f"--advertised-host=$(POD_NAME).{spec.name}"
                        f".{spec.namespace}.svc",
                        f"--kafka-port={spec.kafka_port}",
                        f"--rpc-port={spec.rpc_port}",
                        f"--admin-port={spec.admin_port}",
                        *spec.extra_args,
                    ],
                    "ports": [
                        {"containerPort": spec.kafka_port, "name": "kafka"},
                        {"containerPort": spec.rpc_port, "name": "rpc"},
                        {"containerPort": spec.admin_port, "name": "admin"},
                    ],
                    "readinessProbe": {
                        "httpGet": {
                            "path": "/v1/status/ready",
                            "port": "admin",
                        },
                        "initialDelaySeconds": 5,
                        "periodSeconds": 5,
                    },
                    "volumeMounts": [
                        {"name": "data", "mountPath": "/var/lib/redpanda-tpu"}
                    ],
                }
            ],
        },
    }
    return {
        "apiVersion": "apps/v1",
        "kind": "StatefulSet",
        "metadata": {
            "name": spec.name,
            "namespace": spec.namespace,
            "labels": {"app": spec.name, "managed-by": "redpanda-tpu-operator"},
        },
        "spec": {
            "serviceName": spec.name,
            "replicas": spec.replicas,
            "podManagementPolicy": "Parallel",
            "selector": {"matchLabels": {"app": spec.name}},
            "template": pod,
            "volumeClaimTemplates": [
                {
                    "metadata": {"name": "data"},
                    "spec": {
                        "accessModes": ["ReadWriteOnce"],
                        "resources": {"requests": {"storage": spec.storage}},
                    },
                }
            ],
        },
    }


# -- kube API surface ------------------------------------------------


class KubeError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"{status}: {message}")
        self.status = status


class KubeApi:
    """The 5 REST verbs the reconciler needs. Paths are
    (api_path, namespace, plural, name)."""

    async def get(self, api: str, ns: str, plural: str, name: str) -> dict:
        raise NotImplementedError

    async def list(self, api: str, ns: str, plural: str) -> list[dict]:
        raise NotImplementedError

    async def create(self, api: str, ns: str, plural: str, obj: dict) -> dict:
        raise NotImplementedError

    async def replace(
        self, api: str, ns: str, plural: str, name: str, obj: dict
    ) -> dict:
        raise NotImplementedError

    async def update_status(
        self, api: str, ns: str, plural: str, name: str, status: dict
    ) -> dict:
        raise NotImplementedError


class FakeKubeApi(KubeApi):
    """In-memory apiserver for tests: object store keyed by
    (api, ns, plural, name) with resourceVersion/generation bumping —
    the contract subset the reconciler relies on."""

    def __init__(self) -> None:
        self.objects: dict[tuple[str, str, str, str], dict] = {}
        self.writes: list[tuple[str, str]] = []  # (verb, name) audit log
        self._rv = 0

    def _bump(self, obj: dict, *, generation: bool) -> None:
        self._rv += 1
        meta = obj.setdefault("metadata", {})
        meta["resourceVersion"] = str(self._rv)
        if generation:
            meta["generation"] = int(meta.get("generation", 0)) + 1

    def seed(self, api: str, plural: str, obj: dict) -> dict:
        """Put an object in as if a user kubectl-applied it."""
        meta = obj.setdefault("metadata", {})
        ns = meta.setdefault("namespace", "default")
        self._bump(obj, generation=True)
        self.objects[(api, ns, plural, meta["name"])] = obj
        return obj

    async def get(self, api, ns, plural, name):
        try:
            return copy.deepcopy(self.objects[(api, ns, plural, name)])
        except KeyError:
            raise KubeError(404, f"{plural}/{name} not found") from None

    async def list(self, api, ns, plural):
        return [
            copy.deepcopy(o)
            for (a, n, p, _), o in sorted(self.objects.items())
            if a == api and n == ns and p == plural
        ]

    async def create(self, api, ns, plural, obj):
        name = obj["metadata"]["name"]
        if (api, ns, plural, name) in self.objects:
            raise KubeError(409, f"{plural}/{name} exists")
        obj = copy.deepcopy(obj)
        obj["metadata"]["namespace"] = ns
        self._bump(obj, generation=True)
        self.objects[(api, ns, plural, name)] = obj
        self.writes.append(("create", name))
        return copy.deepcopy(obj)

    async def replace(self, api, ns, plural, name, obj):
        if (api, ns, plural, name) not in self.objects:
            raise KubeError(404, f"{plural}/{name} not found")
        old = self.objects[(api, ns, plural, name)]
        obj = copy.deepcopy(obj)
        obj["metadata"]["namespace"] = ns
        spec_changed = obj.get("spec") != old.get("spec")
        obj.setdefault("status", old.get("status", {}))
        obj["metadata"]["generation"] = old["metadata"].get("generation", 1)
        self._bump(obj, generation=spec_changed)
        self.objects[(api, ns, plural, name)] = obj
        self.writes.append(("replace", name))
        return copy.deepcopy(obj)

    async def update_status(self, api, ns, plural, name, status):
        if (api, ns, plural, name) not in self.objects:
            raise KubeError(404, f"{plural}/{name} not found")
        obj = self.objects[(api, ns, plural, name)]
        obj["status"] = copy.deepcopy(status)
        self._bump(obj, generation=False)
        self.writes.append(("status", name))
        return copy.deepcopy(obj)


class HttpKubeApi(KubeApi):
    """Real apiserver binding over the pooled HTTP client (in-cluster:
    https://kubernetes.default.svc with the mounted service-account
    token; out-of-cluster: any kubeconfig-resolved endpoint)."""

    def __init__(self, host: str, port: int, token: str, *, tls: bool = True):
        from .cloud.http_client import HttpClient

        self._client = HttpClient(host, port, tls=tls)
        self._headers = {
            "Authorization": f"Bearer {token}",
            "Content-Type": "application/json",
        }

    @staticmethod
    def _path(api: str, ns: str, plural: str, name: str | None = None) -> str:
        base = f"/api/{api}" if api == "v1" else f"/apis/{api}"
        p = f"{base}/namespaces/{ns}/{plural}"
        return f"{p}/{name}" if name else p

    async def _req(self, method: str, path: str, body: dict | None = None):
        payload = json.dumps(body).encode() if body is not None else b""
        resp = await self._client.request(
            method, path, headers=dict(self._headers), body=payload
        )
        if resp.status >= 400:
            raise KubeError(resp.status, resp.body.decode(errors="replace"))
        return json.loads(resp.body) if resp.body else {}

    async def get(self, api, ns, plural, name):
        return await self._req("GET", self._path(api, ns, plural, name))

    async def list(self, api, ns, plural):
        out = await self._req("GET", self._path(api, ns, plural))
        return out.get("items", [])

    async def create(self, api, ns, plural, obj):
        return await self._req("POST", self._path(api, ns, plural), obj)

    async def replace(self, api, ns, plural, name, obj):
        return await self._req("PUT", self._path(api, ns, plural, name), obj)

    async def update_status(self, api, ns, plural, name, status):
        cur = await self.get(api, ns, plural, name)
        cur["status"] = status
        return await self._req(
            "PUT", self._path(api, ns, plural, name) + "/status", cur
        )


# -- reconciler ------------------------------------------------------


def _spec_subset_equal(desired: dict, observed: dict) -> bool:
    """Desired drives only the fields it sets: the diff ignores
    server-populated defaults (the operator's own apply semantics)."""
    if isinstance(desired, dict) and isinstance(observed, dict):
        return all(
            k in observed and _spec_subset_equal(v, observed[k])
            for k, v in desired.items()
        )
    if isinstance(desired, list) and isinstance(observed, list):
        return len(desired) == len(observed) and all(
            _spec_subset_equal(a, b) for a, b in zip(desired, observed)
        )
    return desired == observed


class Reconciler:
    """One reconcile pass per Cluster CR. `decommission` is the hook
    that drains a broker before scale-down (production: admin API
    /v1/brokers/{id}/decommission + poll until drained; tests: a
    recorder)."""

    def __init__(
        self,
        api: KubeApi,
        decommission: Optional[Callable] = None,
    ) -> None:
        self.api = api
        self.decommission = decommission

    async def reconcile_all(self, namespace: str) -> None:
        for cr in await self.api.list(f"{GROUP}/{VERSION}", namespace, CRD_PLURAL):
            try:
                await self.reconcile(cr)
            except Exception:
                logger.exception(
                    "reconcile %s failed", cr.get("metadata", {}).get("name")
                )

    async def reconcile(self, cr: dict) -> dict:
        """Drive observed -> desired for one CR; returns the status
        written back."""
        spec = ClusterSpec.from_cr(cr)
        ns = spec.namespace

        # 1. headless Service
        svc = desired_service(spec)
        await self._apply("v1", ns, "services", svc)

        # 2. StatefulSet, with decommission-before-shrink ordering
        sts = desired_statefulset(spec)
        observed = None
        try:
            observed = await self.api.get("apps/v1", ns, "statefulsets", spec.name)
        except KubeError as e:
            if e.status != 404:
                raise
        if observed is not None:
            observed_replicas = int(observed["spec"].get("replicas", 0))
            if spec.replicas < observed_replicas and self.decommission:
                # drain doomed ordinals highest-first (the StatefulSet
                # deletes from the top); matches the reference
                # operator's decommission flow
                for ordinal in range(observed_replicas - 1, spec.replicas - 1, -1):
                    await self.decommission(spec, ordinal)
        await self._apply("apps/v1", ns, "statefulsets", sts)

        # 3. status write-back
        ready = 0
        if observed is not None:
            ready = int(observed.get("status", {}).get("readyReplicas", 0))
        status = {
            "observedGeneration": cr.get("metadata", {}).get("generation", 0),
            "replicas": spec.replicas,
            "readyReplicas": min(ready, spec.replicas),
            "conditions": [
                {
                    "type": "Reconciled",
                    "status": "True",
                    "message": f"statefulset {spec.name} at {spec.replicas} replicas",
                }
            ],
        }
        if cr.get("status") != status:  # converged clusters write nothing
            await self.api.update_status(
                f"{GROUP}/{VERSION}", ns, CRD_PLURAL, spec.name, status
            )
        return status

    async def _apply(self, api: str, ns: str, plural: str, desired: dict) -> None:
        name = desired["metadata"]["name"]
        try:
            observed = await self.api.get(api, ns, plural, name)
        except KubeError as e:
            if e.status != 404:
                raise
            await self.api.create(api, ns, plural, desired)
            return
        if _spec_subset_equal(desired["spec"], observed.get("spec", {})):
            return  # idempotent: no write when nothing we manage drifted
        merged = copy.deepcopy(observed)
        merged["spec"] = desired["spec"]
        await self.api.replace(api, ns, plural, name, merged)


class Operator:
    """Poll-based control loop (the controller-runtime watch analog;
    a poll interval is the faithful zero-dependency equivalent)."""

    def __init__(
        self,
        api: KubeApi,
        namespace: str = "default",
        interval_s: float = 5.0,
        decommission: Optional[Callable] = None,
    ) -> None:
        self.reconciler = Reconciler(api, decommission=decommission)
        self.namespace = namespace
        self.interval_s = interval_s
        self._task: asyncio.Task | None = None

    async def start(self) -> None:
        self._task = asyncio.create_task(self._loop())

    async def install_webhooks(
        self, service: str = "redpanda-operator"
    ) -> dict:
        """Bootstrap admission webhooks: issue a self-signed CA +
        serving cert, store the pair as a Secret, and apply the
        Mutating/Validating webhook configurations pointing at the
        operator's service (the cert-manager-less path the reference
        operator supports). Returns the PEM map for the server."""
        from .operator_webhook import issue_webhook_certs, webhook_configurations

        pems = issue_webhook_certs(service, self.namespace)
        api = self.reconciler.api
        await api.create(
            "v1",
            self.namespace,
            "secrets",
            {
                "apiVersion": "v1",
                "kind": "Secret",
                "metadata": {
                    "name": f"{service}-webhook-cert",
                    "namespace": self.namespace,
                },
                "type": "kubernetes.io/tls",
                "stringData": {
                    "tls.crt": pems["server_cert"],
                    "tls.key": pems["server_key"],
                    "ca.crt": pems["ca_cert"],
                },
            },
        )
        for cfg in webhook_configurations(
            service, self.namespace, pems["ca_cert"]
        ):
            await api.create(
                "admissionregistration.k8s.io/v1",
                self.namespace,
                cfg["kind"].lower() + "s",
                cfg,
            )
        return pems

    async def stop(self) -> None:
        task, self._task = self._task, None
        await cancel_and_wait(task)

    async def _loop(self) -> None:
        while True:
            try:
                await self.reconciler.reconcile_all(self.namespace)
            except asyncio.CancelledError:
                raise
            except Exception:
                # a transient apiserver failure (list 5xx, connection
                # reset) must not kill the control loop
                logger.exception("reconcile pass failed; retrying next tick")
            await asyncio.sleep(self.interval_s)
