"""Operator admission webhooks + serving-cert issuance.

Reference: src/go/k8s/apis/redpanda/v1alpha1/cluster_webhook.go —
`Default()` (:127) fills best-practice defaults into the Cluster CR
(schema-registry port, cloud cache capacity, replication-factor
additionalConfiguration once replicas >= 3, PDB, listener auth method);
`ValidateCreate`/`ValidateUpdate` (:202,:217) gate malformed specs.
The reference registers these as k8s admission webhooks served over
TLS; cert issuance here is the self-signed bootstrap the operator
performs when cert-manager is absent.

Everything is plain-dict in/out so it unit-tests offline (FakeKubeApi
fixtures) and serves directly as the AdmissionReview handler body.
"""

from __future__ import annotations

import base64
import copy
import json
from typing import Optional

DEFAULT_SCHEMA_REGISTRY_PORT = 8081
DEFAULT_CACHE_CAPACITY = "20G"
MIN_REPLICAS_FOR_RF = 3
DEFAULT_TOPIC_RF_KEY = "redpanda.default_topic_replications"
INTERNAL_TOPIC_RF_KEY = "redpanda.internal_topic_replication_factor"
DEFAULT_LICENSE_SECRET_KEY = "license"


# -- defaulting (mutating webhook; cluster_webhook.go:127) ------------

def default_cluster(cr: dict) -> tuple[dict, list[dict]]:
    """Returns (defaulted CR, RFC-6902 JSON patch that produces it)."""
    out = copy.deepcopy(cr)
    spec = out.setdefault("spec", {})
    patch: list[dict] = []

    def _set(path: str, value) -> None:
        patch.append({"op": "add", "path": path, "value": value})

    sr = spec.get("schemaRegistry")
    if isinstance(sr, dict) and not sr.get("port"):
        sr["port"] = DEFAULT_SCHEMA_REGISTRY_PORT
        _set("/spec/schemaRegistry/port", DEFAULT_SCHEMA_REGISTRY_PORT)

    cloud = spec.get("cloudStorage") or {}
    if cloud.get("enabled") and isinstance(
        cloud.get("cacheStorage"), dict
    ) and not cloud["cacheStorage"].get("capacity"):
        cloud["cacheStorage"]["capacity"] = DEFAULT_CACHE_CAPACITY
        _set(
            "/spec/cloudStorage/cacheStorage/capacity",
            DEFAULT_CACHE_CAPACITY,
        )

    # replication-factor best practices once the cluster can host them
    # (cluster_webhook.go:181 setDefaultAdditionalConfiguration)
    if int(spec.get("replicas", 1)) >= MIN_REPLICAS_FOR_RF:
        addl = spec.get("additionalConfiguration")
        if addl is None:
            addl = spec["additionalConfiguration"] = {}
            _set("/spec/additionalConfiguration", {})
        for key, val in (
            (DEFAULT_TOPIC_RF_KEY, "3"),
            (INTERNAL_TOPIC_RF_KEY, "3"),
        ):
            if key not in addl:
                addl[key] = val
                _set(
                    "/spec/additionalConfiguration/"
                    + key.replace("~", "~0").replace("/", "~1"),
                    val,
                )

    if spec.get("podDisruptionBudget") is None:
        spec["podDisruptionBudget"] = {"enabled": True, "maxUnavailable": 1}
        _set(
            "/spec/podDisruptionBudget",
            {"enabled": True, "maxUnavailable": 1},
        )

    lic = spec.get("licenseRef")
    if isinstance(lic, dict) and not lic.get("key"):
        lic["key"] = DEFAULT_LICENSE_SECRET_KEY
        _set("/spec/licenseRef/key", DEFAULT_LICENSE_SECRET_KEY)

    for i, listener in enumerate(spec.get("kafkaApi", []) or []):
        if not listener.get("authenticationMethod"):
            listener["authenticationMethod"] = "none"
            _set(f"/spec/kafkaApi/{i}/authenticationMethod", "none")

    if spec.get("restartConfig") is None:
        spec["restartConfig"] = {"underReplicatedPartitionThreshold": 0}
        _set(
            "/spec/restartConfig",
            {"underReplicatedPartitionThreshold": 0},
        )
    return out, patch


# -- validation (cluster_webhook.go:202 ValidateCreate / :217 Update) --

def _parse_quantity(q) -> Optional[float]:
    """k8s resource.Quantity subset: plain numbers + Ki/Mi/Gi/K/M/G/T."""
    if q is None:
        return None
    s = str(q)
    mults = {
        "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40,
        "K": 1e3, "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12,
    }
    for suf in sorted(mults, key=len, reverse=True):
        if s.endswith(suf):
            try:
                return float(s[: -len(suf)]) * mults[suf]
            except ValueError:
                return None
    try:
        return float(s)
    except ValueError:
        return None


def validate_cluster(cr: dict, old: Optional[dict] = None) -> list[str]:
    """Field errors, empty = admitted. `old` engages update rules."""
    errs: list[str] = []
    meta = cr.get("metadata", {})
    spec = cr.get("spec", {})
    if not meta.get("name"):
        errs.append("metadata.name: required")
    replicas = spec.get("replicas", 1)
    try:
        replicas = int(replicas)
        if replicas < 1:
            errs.append(f"spec.replicas: must be >= 1, got {replicas}")
    except (TypeError, ValueError):
        errs.append(f"spec.replicas: not an integer: {replicas!r}")

    # listener rules (cluster_webhook.go validateKafkaListeners): at
    # most one external listener; internal must exist if any external;
    # ports unique across all declared APIs
    kafka = spec.get("kafkaApi", []) or []
    external = [l for l in kafka if (l.get("external") or {}).get("enabled")]
    internal = [l for l in kafka if not (l.get("external") or {}).get("enabled")]
    if len(external) > 1:
        errs.append("spec.kafkaApi: at most one external listener")
    if external and not internal:
        errs.append("spec.kafkaApi: external listener requires an internal one")
    ports = [
        l.get("port")
        for group in ("kafkaApi", "adminApi", "pandaproxyApi")
        for l in (spec.get(group, []) or [])
        if l.get("port")
    ]
    if spec.get("schemaRegistry", {}).get("port"):
        ports.append(spec["schemaRegistry"]["port"])
    dupes = {p for p in ports if ports.count(p) > 1}
    if dupes:
        errs.append(f"spec: duplicate listener ports {sorted(dupes)}")

    # cloud storage requirements (validateCloudStorage)
    cloud = spec.get("cloudStorage") or {}
    if cloud.get("enabled"):
        if not cloud.get("bucket"):
            errs.append("spec.cloudStorage.bucket: required when enabled")
        if not cloud.get("region"):
            errs.append("spec.cloudStorage.region: required when enabled")
        has_static = cloud.get("accessKey") and cloud.get("secretKeyRef")
        if not has_static and cloud.get("credentialsSource") in (None, "config_file"):
            errs.append(
                "spec.cloudStorage: accessKey+secretKeyRef or a "
                "credentialsSource required when enabled"
            )

    # resources: limits >= requests (validateRedpandaResources)
    res = spec.get("resources") or {}
    for dim in ("cpu", "memory"):
        req = _parse_quantity((res.get("requests") or {}).get(dim))
        lim = _parse_quantity((res.get("limits") or {}).get(dim))
        if req is not None and lim is not None and lim < req:
            errs.append(
                f"spec.resources.limits.{dim}: below requests.{dim}"
            )

    if old is not None:
        old_spec = old.get("spec", {})
        # storage shrink is destructive (validateStorageCapacity)
        new_cap = _parse_quantity(spec.get("storage"))
        old_cap = _parse_quantity(old_spec.get("storage"))
        if new_cap is not None and old_cap is not None and new_cap < old_cap:
            errs.append("spec.storage: cannot shrink persistent capacity")
        # scaling down more than one at a time fights the decommission
        # reconciler (the reference blocks >1-step downscale)
        try:
            old_r = int(old_spec.get("replicas", 1))
            if replicas < old_r - 1:
                errs.append(
                    f"spec.replicas: scale down one broker at a time "
                    f"({old_r} -> {replicas})"
                )
        except (TypeError, ValueError):
            pass
    return errs


# -- AdmissionReview plumbing ----------------------------------------

def handle_admission_review(body: dict, mutating: bool) -> dict:
    """One AdmissionReview request → response (same envelope the
    reference's webhook server answers). Mutating = defaulting with a
    JSONPatch; validating = allow/deny with field errors."""
    req = body.get("request") or {}
    uid = req.get("uid", "")
    obj = req.get("object") or {}
    resp: dict = {"uid": uid, "allowed": True}
    if mutating:
        _, patch = default_cluster(obj)
        if patch:
            resp["patchType"] = "JSONPatch"
            resp["patch"] = base64.b64encode(
                json.dumps(patch).encode()
            ).decode()
    else:
        old = req.get("oldObject") if req.get("operation") == "UPDATE" else None
        errs = validate_cluster(obj, old)
        if errs:
            resp["allowed"] = False
            resp["status"] = {"code": 422, "message": "; ".join(errs)}
    return {
        "apiVersion": body.get("apiVersion", "admission.k8s.io/v1"),
        "kind": "AdmissionReview",
        "response": resp,
    }


# -- serving-cert issuance (self-signed bootstrap) --------------------

def issue_webhook_certs(
    service: str, namespace: str, days: int = 365
) -> dict:
    """Self-signed CA + serving cert for the webhook service DNS names
    (the operator's bootstrap when cert-manager is absent; the CA PEM
    goes into the webhook configuration's caBundle). Returns PEM map:
    ca_cert, server_cert, server_key."""
    import datetime

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    now = datetime.datetime.now(datetime.timezone.utc)
    ca_key = ec.generate_private_key(ec.SECP256R1())
    ca_name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, "redpanda-operator-ca")]
    )
    ca_cert = (
        x509.CertificateBuilder()
        .subject_name(ca_name)
        .issuer_name(ca_name)
        .public_key(ca_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now)
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(x509.BasicConstraints(ca=True, path_length=0), True)
        .sign(ca_key, hashes.SHA256())
    )
    dns = [
        service,
        f"{service}.{namespace}",
        f"{service}.{namespace}.svc",
        f"{service}.{namespace}.svc.cluster.local",
    ]
    srv_key = ec.generate_private_key(ec.SECP256R1())
    srv_cert = (
        x509.CertificateBuilder()
        .subject_name(
            x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, dns[2])])
        )
        .issuer_name(ca_name)
        .public_key(srv_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now)
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(
            x509.SubjectAlternativeName([x509.DNSName(d) for d in dns]),
            False,
        )
        .add_extension(
            x509.ExtendedKeyUsage(
                [x509.oid.ExtendedKeyUsageOID.SERVER_AUTH]
            ),
            False,
        )
        .sign(ca_key, hashes.SHA256())
    )
    pem = serialization.Encoding.PEM
    return {
        "ca_cert": ca_cert.public_bytes(pem).decode(),
        "server_cert": srv_cert.public_bytes(pem).decode(),
        "server_key": srv_key.private_bytes(
            pem,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption(),
        ).decode(),
    }


def webhook_configurations(
    service: str, namespace: str, ca_bundle_pem: str
) -> list[dict]:
    """The Mutating/ValidatingWebhookConfiguration objects the operator
    applies, pointing at its own service with the issued CA."""
    ca64 = base64.b64encode(ca_bundle_pem.encode()).decode()
    rule = {
        "apiGroups": ["redpanda.vectorized.io"],
        "apiVersions": ["v1alpha1"],
        "operations": ["CREATE", "UPDATE"],
        "resources": ["clusters"],
    }
    def client_config(path: str) -> dict:
        return {
            "service": {
                "name": service,
                "namespace": namespace,
                "path": path,
                "port": 443,
            },
            "caBundle": ca64,
        }
    return [
        {
            "apiVersion": "admissionregistration.k8s.io/v1",
            "kind": "MutatingWebhookConfiguration",
            "metadata": {"name": f"{service}-mutating"},
            "webhooks": [
                {
                    "name": "mcluster.kb.io",
                    "admissionReviewVersions": ["v1", "v1beta1"],
                    "clientConfig": client_config(
                        "/mutate-redpanda-vectorized-io-v1alpha1-cluster"
                    ),
                    "failurePolicy": "Fail",
                    "rules": [rule],
                    "sideEffects": "None",
                }
            ],
        },
        {
            "apiVersion": "admissionregistration.k8s.io/v1",
            "kind": "ValidatingWebhookConfiguration",
            "metadata": {"name": f"{service}-validating"},
            "webhooks": [
                {
                    "name": "vcluster.kb.io",
                    "admissionReviewVersions": ["v1", "v1beta1"],
                    "clientConfig": client_config(
                        "/validate-redpanda-vectorized-io-v1alpha1-cluster"
                    ),
                    "failurePolicy": "Fail",
                    "rules": [rule],
                    "sideEffects": "None",
                }
            ],
        },
    ]
