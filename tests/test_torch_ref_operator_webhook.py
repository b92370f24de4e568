"""tests/test_operator_webhook.py run on the port: all 14 test
functions, with imports pointed at redpanda_tpu_torch. An autouse
fixture sets `ops.default_device` (the codec and CRC entries' device) to
"cpu". Nothing is left out.


Operator admission webhooks: defaulting parity with the reference's
Default() (cluster_webhook.go:127), validation rules, AdmissionReview
envelope handling, and self-signed serving-cert issuance."""

import pytest

import base64
import json
import ssl

from redpanda_tpu_torch.operator_webhook import (
    DEFAULT_CACHE_CAPACITY,
    DEFAULT_SCHEMA_REGISTRY_PORT,
    default_cluster,
    handle_admission_review,
    issue_webhook_certs,
    validate_cluster,
    webhook_configurations,
)
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


def _cr(**spec):
    return {
        "metadata": {"name": "c1", "namespace": "default"},
        "spec": spec,
    }


# -- defaulting -------------------------------------------------------

def test_defaults_fill_reference_fields():
    cr = _cr(
        replicas=3,
        schemaRegistry={},
        cloudStorage={"enabled": True, "cacheStorage": {}},
        kafkaApi=[{"port": 9092}],
    )
    out, patch = default_cluster(cr)
    s = out["spec"]
    assert s["schemaRegistry"]["port"] == DEFAULT_SCHEMA_REGISTRY_PORT
    assert s["cloudStorage"]["cacheStorage"]["capacity"] == DEFAULT_CACHE_CAPACITY
    assert s["additionalConfiguration"]["redpanda.default_topic_replications"] == "3"
    assert s["podDisruptionBudget"] == {"enabled": True, "maxUnavailable": 1}
    assert s["kafkaApi"][0]["authenticationMethod"] == "none"
    assert s["restartConfig"] == {"underReplicatedPartitionThreshold": 0}
    assert patch, "defaulting must emit a JSON patch"
    # original untouched
    assert "podDisruptionBudget" not in cr["spec"]


def test_defaults_respect_existing_values():
    cr = _cr(
        replicas=5,
        additionalConfiguration={"redpanda.default_topic_replications": "5"},
        podDisruptionBudget={"enabled": False},
        kafkaApi=[{"port": 9092, "authenticationMethod": "sasl"}],
        restartConfig={"underReplicatedPartitionThreshold": 7},
    )
    out, _ = default_cluster(cr)
    s = out["spec"]
    assert s["additionalConfiguration"]["redpanda.default_topic_replications"] == "5"
    assert s["podDisruptionBudget"] == {"enabled": False}
    assert s["kafkaApi"][0]["authenticationMethod"] == "sasl"
    assert s["restartConfig"]["underReplicatedPartitionThreshold"] == 7


def test_defaults_skip_rf_below_three_replicas():
    out, _ = default_cluster(_cr(replicas=1))
    assert "additionalConfiguration" not in out["spec"]


# -- validation -------------------------------------------------------

def test_validate_accepts_sane_cluster():
    assert validate_cluster(_cr(replicas=3, kafkaApi=[{"port": 9092}])) == []

def test_validate_rejects_bad_replicas_and_missing_name():
    errs = validate_cluster({"metadata": {}, "spec": {"replicas": 0}})
    assert any("metadata.name" in e for e in errs)
    assert any("replicas" in e for e in errs)


def test_validate_listener_rules():
    errs = validate_cluster(
        _cr(
            replicas=3,
            kafkaApi=[
                {"port": 9092, "external": {"enabled": True}},
                {"port": 9093, "external": {"enabled": True}},
            ],
        )
    )
    assert any("at most one external" in e for e in errs)
    assert any("requires an internal" in e for e in errs)
    errs = validate_cluster(
        _cr(
            replicas=3,
            kafkaApi=[{"port": 9092}],
            adminApi=[{"port": 9092}],
        )
    )
    assert any("duplicate listener ports" in e for e in errs)


def test_validate_cloud_storage_requirements():
    errs = validate_cluster(_cr(replicas=3, cloudStorage={"enabled": True}))
    assert any("bucket" in e for e in errs)
    assert any("region" in e for e in errs)
    assert any("credentialsSource" in e for e in errs)
    ok = validate_cluster(
        _cr(
            replicas=3,
            cloudStorage={
                "enabled": True,
                "bucket": "b",
                "region": "r",
                "accessKey": "k",
                "secretKeyRef": {"name": "s"},
            },
        )
    )
    assert ok == []


def test_validate_resources_limits_vs_requests():
    errs = validate_cluster(
        _cr(
            replicas=3,
            resources={
                "requests": {"cpu": "2", "memory": "4Gi"},
                "limits": {"cpu": "1", "memory": "8Gi"},
            },
        )
    )
    assert errs == ["spec.resources.limits.cpu: below requests.cpu"]


def test_validate_update_rules():
    old = _cr(replicas=5, storage="100Gi")
    errs = validate_cluster(_cr(replicas=5, storage="50Gi"), old)
    assert any("cannot shrink" in e for e in errs)
    errs = validate_cluster(_cr(replicas=3, storage="100Gi"), old)
    assert any("one broker at a time" in e for e in errs)
    assert validate_cluster(_cr(replicas=4, storage="100Gi"), old) == []


# -- AdmissionReview envelope ----------------------------------------

def test_admission_review_mutating_patch():
    body = {
        "apiVersion": "admission.k8s.io/v1",
        "request": {"uid": "u-1", "object": _cr(replicas=3)},
    }
    out = handle_admission_review(body, mutating=True)
    resp = out["response"]
    assert resp["uid"] == "u-1" and resp["allowed"]
    patch = json.loads(base64.b64decode(resp["patch"]))
    assert {"op": "add", "path": "/spec/additionalConfiguration", "value": {}} in patch


def test_admission_review_validating_denies():
    body = {
        "request": {
            "uid": "u-2",
            "operation": "UPDATE",
            "object": _cr(replicas=1, storage="10Gi"),
            "oldObject": _cr(replicas=3, storage="100Gi"),
        }
    }
    out = handle_admission_review(body, mutating=False)
    resp = out["response"]
    assert not resp["allowed"]
    assert resp["status"]["code"] == 422
    assert "shrink" in resp["status"]["message"]


# -- cert issuance ----------------------------------------------------

def test_issued_certs_form_a_valid_tls_chain(tmp_path):
    pems = issue_webhook_certs("rp-operator", "redpanda-system")
    ca = tmp_path / "ca.pem"
    crt = tmp_path / "tls.crt"
    key = tmp_path / "tls.key"
    ca.write_text(pems["ca_cert"])
    crt.write_text(pems["server_cert"])
    key.write_text(pems["server_key"])
    # server context loads the pair; client context trusts the CA —
    # ssl verifies the chain at load/use time
    srv = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    srv.load_cert_chain(str(crt), str(key))
    cli = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    cli.load_verify_locations(str(ca))
    # SAN covers the k8s service DNS shapes
    from cryptography import x509

    cert = x509.load_pem_x509_certificate(pems["server_cert"].encode())
    sans = cert.extensions.get_extension_for_class(
        x509.SubjectAlternativeName
    ).value.get_values_for_type(x509.DNSName)
    assert "rp-operator.redpanda-system.svc" in sans
    assert "rp-operator.redpanda-system.svc.cluster.local" in sans


def test_operator_installs_webhooks_via_fake_kube_api():
    import asyncio

    from redpanda_tpu_torch.operator import FakeKubeApi, Operator

    api = FakeKubeApi()
    op = Operator(api, namespace="ns1")

    async def main():
        return await op.install_webhooks("rp-op")

    pems = asyncio.new_event_loop().run_until_complete(main())
    secret = api.objects[("v1", "ns1", "secrets", "rp-op-webhook-cert")]
    assert secret["stringData"]["tls.crt"] == pems["server_cert"]
    muts = api.objects[
        (
            "admissionregistration.k8s.io/v1",
            "ns1",
            "mutatingwebhookconfigurations",
            "rp-op-mutating",
        )
    ]
    assert muts["webhooks"][0]["clientConfig"]["service"]["name"] == "rp-op"


def test_webhook_configurations_reference_service_and_ca():
    pems = issue_webhook_certs("rp-operator", "ns1")
    cfgs = webhook_configurations("rp-operator", "ns1", pems["ca_cert"])
    kinds = {c["kind"] for c in cfgs}
    assert kinds == {
        "MutatingWebhookConfiguration",
        "ValidatingWebhookConfiguration",
    }
    for c in cfgs:
        wh = c["webhooks"][0]
        assert wh["clientConfig"]["service"]["name"] == "rp-operator"
        assert base64.b64decode(wh["clientConfig"]["caBundle"]).startswith(
            b"-----BEGIN CERTIFICATE-----"
        )
