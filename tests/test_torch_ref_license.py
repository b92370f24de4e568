"""tests/test_license.py run on the port: all 10 cases, with imports
pointed at redpanda_tpu_torch. Brokers run on the CPU
(`BrokerConfig(device="cpu")`). An autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu" (the
kernels' plain versions). The admin API is read with
`test_admin_server`'s `http`, a plain HTTP/1.1 client of no package.
Nothing is left out.

License parse/verify/enforcement tests (reference:
src/v/security/tests/license_test.cc + license.cc semantics)."""

import base64
import json
import os
import time

import pytest

from redpanda_tpu_torch.security.license import (
    ENTERPRISE,
    ENTERPRISE_FEATURES,
    FREE_TRIAL,
    License,
    LicenseInvalid,
    LicenseMalformed,
    LicenseService,
    LicenseVerificationError,
    make_license,
    sign_license,
)

KEY_PATH = os.path.join(
    os.path.dirname(__file__), "data", "license_signing_key.pem"
)
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


def _signing_key() -> bytes:
    with open(KEY_PATH, "rb") as f:
        return f.read()


def _valid(org="redpanda-tpu-tests", days=30, type=ENTERPRISE) -> str:
    return sign_license(
        org, int(time.time()) + days * 86400, _signing_key(), type=type
    )


def test_round_trip_valid_license():
    raw = _valid()
    lic = make_license(raw)
    assert lic.organization == "redpanda-tpu-tests"
    assert lic.type == ENTERPRISE
    assert lic.type_name == "enterprise"
    assert not lic.is_expired()
    assert lic.expires_in() > 0
    assert len(lic.checksum) == 64
    props = lic.properties()
    assert props["org"] == "redpanda-tpu-tests"
    assert props["type"] == "enterprise"


def test_free_trial_type():
    lic = make_license(_valid(type=FREE_TRIAL))
    assert lic.type_name == "free_trial"


def test_missing_dot_is_malformed():
    with pytest.raises(LicenseMalformed):
        make_license("nodotteddata")


def test_bad_signature_rejected():
    raw = _valid()
    data, sig = raw.split(".", 1)
    # flip a bit inside the signed data section
    tampered = base64.b64encode(
        base64.b64decode(data)[:-1] + b"X"
    ).decode()
    with pytest.raises(LicenseVerificationError):
        make_license(tampered + "." + sig)


def test_garbage_signature_rejected():
    raw = _valid()
    data, _ = raw.split(".", 1)
    with pytest.raises((LicenseVerificationError, LicenseMalformed)):
        make_license(data + "." + base64.b64encode(b"junk" * 64).decode())


def test_expired_license_rejected():
    raw = sign_license(
        "org", int(time.time()) - 60, _signing_key()
    )
    with pytest.raises(LicenseInvalid):
        make_license(raw)


def _mint_with_payload(payload: dict) -> str:
    """Sign an arbitrary data section with the test key (schema-violating
    payloads must still pass signature verification to reach the
    schema checks)."""
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import padding

    data_b64 = base64.b64encode(
        json.dumps(payload, separators=(",", ":")).encode()
    ).decode()
    key = serialization.load_pem_private_key(_signing_key(), password=None)
    sig = key.sign(data_b64.encode(), padding.PKCS1v15(), hashes.SHA256())
    return data_b64 + "." + base64.b64encode(sig).decode()


def test_schema_violations():
    future = int(time.time()) + 3600
    # missing field
    with pytest.raises(LicenseMalformed):
        make_license(
            _mint_with_payload({"version": 3, "org": "x", "type": 1})
        )
    # extra field (additionalProperties: false)
    with pytest.raises(LicenseMalformed):
        make_license(
            _mint_with_payload(
                {
                    "version": 3,
                    "org": "x",
                    "type": 1,
                    "expiry": future,
                    "extra": 1,
                }
            )
        )
    # empty org
    with pytest.raises(LicenseInvalid):
        make_license(
            _mint_with_payload(
                {"version": 3, "org": "", "type": 1, "expiry": future}
            )
        )
    # unknown type
    with pytest.raises(LicenseInvalid):
        make_license(
            _mint_with_payload(
                {"version": 3, "org": "x", "type": 9, "expiry": future}
            )
        )
    # negative version
    with pytest.raises(LicenseInvalid):
        make_license(
            _mint_with_payload(
                {"version": -1, "org": "x", "type": 1, "expiry": future}
            )
        )


def test_license_admin_e2e(tmp_path):
    """PUT /v1/features/license validates + replicates; GET reports
    parsed properties on every node (admin_server.cc put_license)."""
    import asyncio

    from redpanda_tpu_torch.app import Broker, BrokerConfig
    from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork

    from test_admin_server import http

    async def raw_put(addr, path, payload: bytes):
        reader, writer = await asyncio.open_connection(*addr)
        req = (
            f"PUT {path} HTTP/1.1\r\nHost: x\r\n"
            f"Content-Length: {len(payload)}\r\n\r\n"
        ).encode() + payload
        writer.write(req)
        await writer.drain()
        status = int((await reader.readline()).split()[1])
        writer.close()
        return status

    async def run():
        net = LoopbackNetwork()
        b = Broker(
            BrokerConfig(
                device="cpu",
                node_id=0,
                data_dir=str(tmp_path / "n0"),
                members=[0],
                election_timeout_s=0.15,
                heartbeat_interval_s=0.03,
            ),
            loopback=net,
        )
        await b.start()
        try:
            await b.wait_controller_leader()
            addr = b.admin.address
            status, body = await http(addr, "GET", "/v1/features/license")
            assert status == 200 and body["loaded"] is False
            # garbage license must be rejected before replication
            status = await raw_put(
                addr, "/v1/features/license", b"not-a-license"
            )
            assert status == 400
            raw = _valid(org="e2e-org")
            status = await raw_put(
                addr, "/v1/features/license", raw.encode()
            )
            assert status < 300
            for _ in range(100):
                status, body = await http(
                    addr, "GET", "/v1/features/license"
                )
                if body.get("loaded"):
                    break
                await asyncio.sleep(0.05)
            assert body["loaded"] is True
            assert body["license"]["org"] == "e2e-org"
            assert body["expired"] is False
            assert body["violations"] == []
        finally:
            await b.stop()

    asyncio.run(run())


def test_expired_license_survives_replay():
    """Config replay (allow_expired) must keep reporting an expired
    license instead of dropping it — restarted nodes answer the admin
    API identically to long-running ones."""
    svc = LicenseService()
    raw = sign_license("org", int(time.time()) - 60, _signing_key())
    with pytest.raises(LicenseInvalid):
        svc.load(raw)  # strict path still rejects
    lic = svc.load(raw, allow_expired=True)
    assert lic.is_expired()
    st = svc.status()
    assert st["loaded"] is True and st["expired"] is True
    assert not svc.has_valid_license()
    assert svc.violations(["tiered_storage"]) == ["tiered_storage"]


def test_license_service_gating():
    svc = LicenseService()
    # unlicensed: enterprise features report violations but free ones pass
    assert svc.check("kafka_api")
    assert not svc.check("tiered_storage")
    assert svc.violations(["tiered_storage", "oidc", "kafka_api"]) == [
        "oidc",
        "tiered_storage",
    ]
    assert svc.status() == {"loaded": False, "license": None}
    # load a valid license: violations clear
    svc.load(_valid())
    assert svc.check("tiered_storage")
    assert svc.violations(list(ENTERPRISE_FEATURES)) == []
    st = svc.status()
    assert st["loaded"] and not st["expired"]
    # expiry flips enforcement back off without unloading
    future_now = time.time() + 365 * 86400
    assert not svc.check("tiered_storage", now=future_now)
    assert svc.violations(["gssapi"], now=future_now) == ["gssapi"]
    # invalid replacement leaves the previous license in place
    with pytest.raises(LicenseMalformed):
        svc.load("garbage")
    assert svc.license is not None
    svc.clear()
    assert not svc.has_valid_license()
