"""tests/test_http_services.py run on the port: all 3 test functions,
with imports pointed at redpanda_tpu_torch. Every broker is the port's
on the CPU (`BrokerConfig(device="cpu")`), and an autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
`http` comes from `test_torch_ref_admin_server`; `proxy_broker` is
imported from here by the two compat files. Nothing is left out.


REST proxy + schema registry over HTTP.

Reference test model: src/v/pandaproxy/rest/test/, schema_registry
sharded_store/compatibility tests, rptest schema-registry suites.
"""

import asyncio
import contextlib
import json

import pytest

from redpanda_tpu_torch.app import Broker, BrokerConfig
from redpanda_tpu_torch.kafka.client import KafkaClient
from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork

from test_torch_ref_admin_server import http  # shared minimal HTTP client
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


@contextlib.asynccontextmanager
async def proxy_broker(tmp_path):
    net = LoopbackNetwork()
    b = Broker(
        BrokerConfig(
            device="cpu",
            node_id=0,
            data_dir=str(tmp_path / "n0"),
            members=[0],
            election_timeout_s=0.15,
            heartbeat_interval_s=0.03,
            enable_pandaproxy=True,
            enable_schema_registry=True,
        ),
        loopback=net,
    )
    await b.start()
    b.config.peer_kafka_addresses = {0: b.kafka_advertised}
    try:
        await b.wait_controller_leader()
        yield b
    finally:
        await b.stop()


async def _rest_proxy(tmp_path):
    async with proxy_broker(tmp_path) as b:
        addr = b.pandaproxy.address
        # topic listing via the proxy
        client = KafkaClient([b.kafka_advertised])
        await client.create_topic("pt", partitions=2, replication_factor=1)
        st, topics = await http(addr, "GET", "/topics")
        assert st == 200 and "pt" in topics
        st, meta = await http(addr, "GET", "/topics/pt")
        assert st == 200 and len(meta["partitions"]) == 2

        # produce json-embedded records over HTTP
        st, body = await http(
            addr,
            "POST",
            "/topics/pt",
            {
                "records": [
                    {"value": {"n": 1}, "partition": 0},
                    {"value": {"n": 2}, "key": "k2", "partition": 1},
                ]
            },
        )
        assert st == 200, body
        assert [o["offset"] for o in body["offsets"]] == [0, 0]

        # consumer-group instance: create, subscribe, poll, commit
        st, c = await http(
            addr, "POST", "/consumers/g1", {"name": "c1", "format": "json"}
        )
        assert st == 200 and c["instance_id"] == "c1"
        st, _ = await http(
            addr,
            "POST",
            "/consumers/g1/instances/c1/subscription",
            {"topics": ["pt"]},
        )
        assert st == 204
        records = []
        deadline = asyncio.get_event_loop().time() + 5
        while len(records) < 2:
            st, got = await http(
                addr, "GET", "/consumers/g1/instances/c1/records"
            )
            assert st == 200
            records.extend(got)
            assert asyncio.get_event_loop().time() < deadline
        vals = sorted(json.dumps(r["value"]) for r in records)
        assert vals == ['{"n": 1}', '{"n": 2}']
        st, _ = await http(
            addr, "POST", "/consumers/g1/instances/c1/offsets", {}
        )
        assert st == 204
        # committed offsets visible through the coordinator
        gc = client.group("g1")
        committed = await gc.fetch_offsets({"pt": [0, 1]})
        assert committed == {("pt", 0): 0, ("pt", 1): 0}
        st, _ = await http(addr, "DELETE", "/consumers/g1/instances/c1")
        assert st == 204
        st, _ = await http(addr, "GET", "/consumers/g1/instances/c1/records")
        assert st == 404
        await client.close()


def test_rest_proxy(tmp_path):
    asyncio.run(_rest_proxy(tmp_path))


AVRO_V1 = {
    "type": "record",
    "name": "User",
    "fields": [{"name": "id", "type": "long"}],
}
# adds an optional field: BACKWARD-compatible
AVRO_V2 = {
    "type": "record",
    "name": "User",
    "fields": [
        {"name": "id", "type": "long"},
        {"name": "email", "type": "string", "default": ""},
    ],
}
# adds a REQUIRED field: BACKWARD-incompatible
AVRO_BAD = {
    "type": "record",
    "name": "User",
    "fields": [
        {"name": "id", "type": "long"},
        {"name": "ssn", "type": "string"},
    ],
}


async def _schema_registry(tmp_path):
    async with proxy_broker(tmp_path) as b:
        addr = b.schema_registry.address
        st, types = await http(addr, "GET", "/schemas/types")
        assert st == 200 and "AVRO" in types

        # register v1
        st, body = await http(
            addr,
            "POST",
            "/subjects/user-value/versions",
            {"schema": json.dumps(AVRO_V1)},
        )
        assert st == 200, body
        id1 = body["id"]
        # re-register identical schema: same id, no new version
        st, body = await http(
            addr,
            "POST",
            "/subjects/user-value/versions",
            {"schema": json.dumps(AVRO_V1)},
        )
        assert body["id"] == id1
        st, versions = await http(addr, "GET", "/subjects/user-value/versions")
        assert versions == [1]

        # compatible evolution registers as v2 with a NEW id
        st, body = await http(
            addr,
            "POST",
            "/subjects/user-value/versions",
            {"schema": json.dumps(AVRO_V2)},
        )
        assert st == 200 and body["id"] != id1
        id2 = body["id"]
        st, versions = await http(addr, "GET", "/subjects/user-value/versions")
        assert versions == [1, 2]

        # incompatible evolution rejected at the default BACKWARD level
        st, body = await http(
            addr,
            "POST",
            "/subjects/user-value/versions",
            {"schema": json.dumps(AVRO_BAD)},
        )
        assert st == 409, body

        # compatibility probe endpoint agrees
        st, body = await http(
            addr,
            "POST",
            "/compatibility/subjects/user-value/versions/latest",
            {"schema": json.dumps(AVRO_BAD)},
        )
        assert st == 200 and body["is_compatible"] is False

        # lookups: by version, latest, id, and schema text
        st, body = await http(
            addr, "GET", "/subjects/user-value/versions/latest"
        )
        assert body["version"] == 2 and body["id"] == id2
        st, body = await http(addr, "GET", f"/schemas/ids/{id1}")
        assert json.loads(body["schema"])["name"] == "User"
        st, body = await http(
            addr,
            "POST",
            "/subjects/user-value",
            {"schema": json.dumps(AVRO_V2)},
        )
        assert body["version"] == 2

        # same schema under ANOTHER subject reuses the global id
        st, body = await http(
            addr,
            "POST",
            "/subjects/other-value/versions",
            {"schema": json.dumps(AVRO_V1)},
        )
        assert body["id"] == id1

        # config: set NONE, the incompatible schema now registers
        st, body = await http(
            addr, "PUT", "/config/user-value", {"compatibility": "NONE"}
        )
        assert st == 200
        st, body = await http(
            addr,
            "POST",
            "/subjects/user-value/versions",
            {"schema": json.dumps(AVRO_BAD)},
        )
        assert st == 200
        st, versions = await http(addr, "GET", "/subjects/user-value/versions")
        assert versions == [1, 2, 3]

        # delete a subject: it vanishes from listings
        st, deleted = await http(addr, "DELETE", "/subjects/other-value")
        assert st == 200 and deleted == [1]
        st, subjects = await http(addr, "GET", "/subjects")
        assert subjects == ["user-value"]


def test_schema_registry(tmp_path):
    asyncio.run(_schema_registry(tmp_path))


async def _registry_state_is_replicated(tmp_path):
    """The registry's state derives from the _schemas topic: a second
    registry instance (fresh boot, same cluster) converges to the same
    subjects/ids without any sidechannel."""
    async with proxy_broker(tmp_path) as b:
        addr = b.schema_registry.address
        st, body = await http(
            addr,
            "POST",
            "/subjects/s1-value/versions",
            {"schema": json.dumps(AVRO_V1)},
        )
        assert st == 200
        sid = body["id"]
        # fresh registry server over the same broker: replays _schemas
        from redpanda_tpu_torch.proxy import SchemaRegistryServer

        reg2 = SchemaRegistryServer(b)
        await reg2.start()
        try:
            deadline = asyncio.get_event_loop().time() + 5
            while reg2.store.applied_offset < 0:
                assert asyncio.get_event_loop().time() < deadline
                await asyncio.sleep(0.05)
            st, body = await http(
                reg2.address, "GET", "/subjects/s1-value/versions/latest"
            )
            assert st == 200 and body["id"] == sid
        finally:
            await reg2.stop()


def test_registry_state_is_replicated(tmp_path):
    asyncio.run(_registry_state_is_replicated(tmp_path))
