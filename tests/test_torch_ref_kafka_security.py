"""tests/test_kafka_security.py run on the port: all 8 test functions,
with imports pointed at redpanda_tpu_torch. Every broker is the port's
on the CPU (`BrokerConfig(device="cpu")`), and an autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
Nothing is left out.


SASL/SCRAM authentication + ACL authorization end-to-end.

Reference test model: src/v/security/tests/{scram_algorithm_test,
authorizer_test}.cc and rptest/tests/sasl_plain_test.py /
acls_test.py.
"""

import asyncio
import contextlib

import pytest

from redpanda_tpu_torch.app import Broker, BrokerConfig
from redpanda_tpu_torch.kafka.client import KafkaClient, KafkaClientError
from redpanda_tpu_torch.kafka.protocol import ErrorCode
from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork
from redpanda_tpu_torch.security.acl import (
    AclBinding,
    AclOperation,
    AclPatternType,
    AclPermission,
    AclResourceType,
)
from redpanda_tpu_torch.security.scram import (
    CredentialStore,
    ScramServerExchange,
    client_final_message,
    client_first_message,
    encode_credential,
    make_credential,
)
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


# -- scram unit level -------------------------------------------------
def test_scram_exchange_roundtrip():
    store = CredentialStore()
    store.put("alice", make_credential("secret", "SCRAM-SHA-256"))
    ex = ScramServerExchange(store, "SCRAM-SHA-256")
    first, nonce = client_first_message("alice")
    server_first = ex.handle_client_first(first.encode())
    final, expect_sig = client_final_message(
        "secret", "SCRAM-SHA-256", first, server_first, nonce
    )
    server_final = ex.handle_client_final(final.encode())
    import base64

    assert server_final.decode() == f"v={base64.b64encode(expect_sig).decode()}"
    assert ex.done and ex.username == "alice"


def test_scram_wrong_password():
    from redpanda_tpu_torch.security.scram import ScramError

    store = CredentialStore()
    store.put("alice", make_credential("secret", "SCRAM-SHA-512"))
    ex = ScramServerExchange(store, "SCRAM-SHA-512")
    first, nonce = client_first_message("alice")
    server_first = ex.handle_client_first(first.encode())
    final, _ = client_final_message(
        "WRONG", "SCRAM-SHA-512", first, server_first, nonce
    )
    with pytest.raises(ScramError):
        ex.handle_client_final(final.encode())


def test_scram_unknown_user_fails_at_final():
    from redpanda_tpu_torch.security.scram import ScramError

    ex = ScramServerExchange(CredentialStore(), "SCRAM-SHA-256")
    first, nonce = client_first_message("ghost")
    server_first = ex.handle_client_first(first.encode())  # no leak
    final, _ = client_final_message(
        "x", "SCRAM-SHA-256", first, server_first, nonce
    )
    with pytest.raises(ScramError):
        ex.handle_client_final(final.encode())


# -- authorizer unit level --------------------------------------------
def test_authorizer_deny_overrides_allow():
    from redpanda_tpu_torch.security.acl import AclStore, Authorizer

    store = AclStore()
    auth = Authorizer(store)
    allow = AclBinding(
        AclResourceType.topic,
        AclPatternType.literal,
        "t1",
        "User:alice",
        "*",
        AclOperation.all,
        AclPermission.allow,
    )
    deny = AclBinding(
        AclResourceType.topic,
        AclPatternType.literal,
        "t1",
        "User:alice",
        "*",
        AclOperation.write,
        AclPermission.deny,
    )
    store.add([allow])
    assert auth.authorized(AclResourceType.topic, "t1", AclOperation.write, "User:alice")
    store.add([deny])
    assert not auth.authorized(AclResourceType.topic, "t1", AclOperation.write, "User:alice")
    assert auth.authorized(AclResourceType.topic, "t1", AclOperation.read, "User:alice")
    # prefixed + wildcard-principal
    store.add(
        [
            AclBinding(
                AclResourceType.topic,
                AclPatternType.prefixed,
                "logs-",
                "User:*",
                "*",
                AclOperation.read,
                AclPermission.allow,
            )
        ]
    )
    assert auth.authorized(AclResourceType.topic, "logs-web", AclOperation.read, "User:bob")
    assert not auth.authorized(AclResourceType.topic, "metrics", AclOperation.read, "User:bob")


# -- broker e2e -------------------------------------------------------
@contextlib.asynccontextmanager
async def sasl_cluster(tmp_path, superuser="admin"):
    net = LoopbackNetwork()
    b = Broker(
        BrokerConfig(
            device="cpu",
            node_id=0,
            data_dir=str(tmp_path / "n0"),
            members=[0],
            election_timeout_s=0.15,
            heartbeat_interval_s=0.03,
            enable_sasl=True,
            superusers=[superuser],
        ),
        loopback=net,
    )
    await b.start()
    b.config.peer_kafka_addresses = {0: b.kafka_advertised}
    await b.wait_controller_leader()
    # seed credentials straight through the controller (the admin-API
    # bootstrap path)
    await b.controller.create_user(
        "admin", encode_credential(make_credential("admin-pw"))
    )
    await b.controller.create_user(
        "alice", encode_credential(make_credential("alice-pw"))
    )
    try:
        yield b
    finally:
        await b.stop()


async def _sasl_produce_fetch(tmp_path):
    async with sasl_cluster(tmp_path) as b:
        admin = KafkaClient(
            [b.kafka_advertised], sasl=("admin", "admin-pw", "SCRAM-SHA-256")
        )
        await admin.create_topic("t", partitions=1, replication_factor=1)
        await admin.produce("t", 0, [(b"k", b"v")])
        got = await admin.fetch("t", 0, 0)
        assert [(k, v) for _o, k, v in got] == [(b"k", b"v")]
        await admin.close()

        # wrong password is rejected
        bad = KafkaClient(
            [b.kafka_advertised], sasl=("alice", "nope", "SCRAM-SHA-256")
        )
        with pytest.raises(KafkaClientError) as ei:
            await bad.metadata()
        assert ei.value.code == int(ErrorCode.sasl_authentication_failed)
        await bad.close()

        # alice authenticates but has no ACLs: produce denied
        alice = KafkaClient(
            [b.kafka_advertised], sasl=("alice", "alice-pw", "SCRAM-SHA-256")
        )
        with pytest.raises(KafkaClientError) as ei:
            await alice.produce("t", 0, [(b"x", b"y")])
        assert ei.value.code == int(ErrorCode.topic_authorization_failed)

        # grant write via replicated ACL; then produce succeeds
        await b.controller.create_acls(
            [
                AclBinding(
                    AclResourceType.topic,
                    AclPatternType.literal,
                    "t",
                    "User:alice",
                    "*",
                    AclOperation.all,
                    AclPermission.allow,
                )
            ]
        )
        off = await alice.produce("t", 0, [(b"x", b"y")])
        assert off == 1
        got = await alice.fetch("t", 0, 0)
        assert len(got) == 2
        await alice.close()


def test_sasl_acl_e2e(tmp_path):
    asyncio.run(_sasl_produce_fetch(tmp_path))


async def _unauthenticated_closed(tmp_path):
    async with sasl_cluster(tmp_path) as b:
        plain = KafkaClient([b.kafka_advertised])  # no sasl
        with pytest.raises(KafkaClientError):
            await plain.metadata()
        await plain.close()


def test_unauthenticated_connection_closed(tmp_path):
    asyncio.run(_unauthenticated_closed(tmp_path))


async def _acl_admin_apis(tmp_path):
    """Describe/Create/DeleteAcls over the kafka protocol."""
    from redpanda_tpu_torch.kafka.protocol import Msg
    from redpanda_tpu_torch.kafka.protocol.admin_apis import (
        CREATE_ACLS,
        DELETE_ACLS,
        DESCRIBE_ACLS,
    )

    async with sasl_cluster(tmp_path) as b:
        admin = KafkaClient(
            [b.kafka_advertised], sasl=("admin", "admin-pw", "SCRAM-SHA-256")
        )
        conn = await admin.any_conn()
        resp = await conn.request(
            CREATE_ACLS,
            Msg(
                creations=[
                    Msg(
                        resource_type=int(AclResourceType.topic),
                        resource_name="t1",
                        resource_pattern_type=int(AclPatternType.literal),
                        principal="User:alice",
                        host="*",
                        operation=int(AclOperation.read),
                        permission_type=int(AclPermission.allow),
                    )
                ]
            ),
            1,
        )
        assert resp.results[0].error_code == 0
        resp = await conn.request(
            DESCRIBE_ACLS,
            Msg(
                resource_type_filter=1,  # any
                resource_name_filter=None,
                pattern_type_filter=1,
                principal_filter=None,
                host_filter=None,
                operation=1,
                permission_type=1,
            ),
            1,
        )
        assert resp.error_code == 0
        assert len(resp.resources) == 1
        assert resp.resources[0].acls[0].principal == "User:alice"
        resp = await conn.request(
            DELETE_ACLS,
            Msg(
                filters=[
                    Msg(
                        resource_type_filter=int(AclResourceType.topic),
                        resource_name_filter="t1",
                        pattern_type_filter=1,
                        principal_filter=None,
                        host_filter=None,
                        operation=1,
                        permission_type=1,
                    )
                ]
            ),
            1,
        )
        assert resp.filter_results[0].error_code == 0
        assert len(resp.filter_results[0].matching_acls) == 1
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
        assert resp.resources == []
        await admin.close()


def test_acl_admin_apis(tmp_path):
    asyncio.run(_acl_admin_apis(tmp_path))


async def _authz_enforcement_surface(tmp_path):
    """Auth gaps closed in review: metadata filtering, delete_topics,
    group APIs, malformed SASL, invalid ACL enums."""
    from redpanda_tpu_torch.kafka.protocol import Msg
    from redpanda_tpu_torch.kafka.protocol.admin_apis import (
        CREATE_ACLS,
        DESCRIBE_ACLS,
        SASL_AUTHENTICATE,
        SASL_HANDSHAKE,
    )

    async with sasl_cluster(tmp_path) as b:
        admin = KafkaClient(
            [b.kafka_advertised], sasl=("admin", "admin-pw", "SCRAM-SHA-256")
        )
        await admin.create_topic("sec", partitions=1, replication_factor=1)
        await admin.produce("sec", 0, [(b"k", b"v")])

        alice = KafkaClient(
            [b.kafka_advertised], sasl=("alice", "alice-pw", "SCRAM-SHA-256")
        )
        # list-all metadata hides unauthorized topics (no existence leak)
        md = await alice.metadata()
        assert all(t.name != "sec" for t in md.topics)
        # named metadata request returns an auth error, not unknown-topic
        md = await alice.metadata(["sec"])
        assert md.topics[0].error_code == int(
            ErrorCode.topic_authorization_failed
        )
        # destructive APIs are denied without grants
        res = await alice.delete_topics(["sec"])
        assert res[0][1] == int(ErrorCode.topic_authorization_failed)
        # list_offsets requires describe
        with pytest.raises(KafkaClientError) as ei:
            await alice.list_offset("sec", 0, -1)
        assert ei.value.code == int(ErrorCode.topic_authorization_failed)
        # group APIs without a grant: sync/heartbeat/offset_fetch denied
        conn = await alice.any_conn()
        from redpanda_tpu_torch.kafka.protocol.group_apis import (
            HEARTBEAT,
            OFFSET_FETCH,
            SYNC_GROUP,
        )

        r = await conn.request(
            SYNC_GROUP,
            Msg(group_id="g1", generation_id=0, member_id="m", assignments=[]),
            1,
        )
        assert r.error_code == int(ErrorCode.group_authorization_failed)
        r = await conn.request(
            HEARTBEAT, Msg(group_id="g1", generation_id=0, member_id="m"), 1
        )
        assert r.error_code == int(ErrorCode.group_authorization_failed)
        r = await conn.request(
            OFFSET_FETCH, Msg(group_id="g1", topics=None), 2
        )
        assert r.error_code == int(ErrorCode.group_authorization_failed)

        aconn = await admin.any_conn()
        # out-of-range enum in DescribeAcls -> invalid_request, conn alive
        r = await aconn.request(
            DESCRIBE_ACLS,
            Msg(
                resource_type_filter=99,
                resource_name_filter=None,
                pattern_type_filter=1,
                principal_filter=None,
                host_filter=None,
                operation=1,
                permission_type=1,
            ),
            1,
        )
        assert r.error_code == int(ErrorCode.invalid_request)
        # filter-only wildcard enums rejected at ACL creation
        r = await aconn.request(
            CREATE_ACLS,
            Msg(
                creations=[
                    Msg(
                        resource_type=int(AclResourceType.topic),
                        resource_name="x",
                        resource_pattern_type=1,  # ANY: filter-only
                        principal="User:alice",
                        host="*",
                        operation=int(AclOperation.read),
                        permission_type=int(AclPermission.allow),
                    )
                ]
            ),
            1,
        )
        assert r.results[0].error_code == int(ErrorCode.invalid_request)
        # connection still serves requests after the invalid ones
        assert (await admin.metadata()).topics is not None

        # malformed SASL auth bytes fail the exchange, not the socket
        raw = KafkaClient([b.kafka_advertised])
        rconn = await raw.any_conn()
        await rconn.request(SASL_HANDSHAKE, Msg(mechanism="SCRAM-SHA-256"), 1)
        r = await rconn.request(
            SASL_AUTHENTICATE, Msg(auth_bytes=b"\xff\xfe"), 1
        )
        assert r.error_code == int(ErrorCode.sasl_authentication_failed)
        r = await rconn.request(SASL_AUTHENTICATE, Msg(auth_bytes=b"n,"), 1)
        assert r.error_code == int(ErrorCode.sasl_authentication_failed)
        await admin.close()
        await alice.close()
        await raw.close()


def test_authz_enforcement_surface(tmp_path):
    asyncio.run(_authz_enforcement_surface(tmp_path))
